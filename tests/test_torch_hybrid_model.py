"""The port's hybrid (zamba2) ``DecoderLM``, and the dense-cache entry points
of the ssm and hybrid families, against the JAX ``DecoderLM`` on the same
weights.

Reduced zamba2-2.7b (4 Mamba2 layers in 2 groups, each led by the one
shared attention + MLP block) and reduced mamba2-1.3b in float32 on the
CPU: the JAX parameters (``model.init(jax.random.key(0))``) carried across
by ``params_from_jax``; state banks, page pools, tables and tokens from
numpy with fixed seeds. Logits, every state leaf and the page pool after
``decode_step_hybrid`` (with idle slots) and ``prefill_chunk_hybrid``
(from position 0, and from a cached prefix with ``valid`` < C), and the
dense cache after ``prefill`` and each ``decode_step``, are held to 1e-4
against the JAX model on its default (XLA reference) paths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.common import flatten_tree  # noqa: E402
from repro_torch.models.ssm import init_mamba_cache  # noqa: E402

TOL = 1e-4
SLOTS, PAGE, NUM_PAGES, MP, C = 4, 8, 12, 4, 16


def _pair(arch):
    jcfg = jreduced(JARCHS[arch])
    cfg = reduced(ARCHS[arch])
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jmodel, jparams, cfg, model


@pytest.fixture(scope="module")
def zamba2():
    return _pair("zamba2-2.7b")


@pytest.fixture(scope="module")
def mamba2():
    return _pair("mamba2-1.3b")


def _bank(cfg, slots, seed):
    """A random (L, S, ...) state bank: numpy leaves for both packages."""
    rng = np.random.default_rng(seed)
    mc = init_mamba_cache(cfg, slots, torch.float32, device="meta")
    return {k: rng.standard_normal((cfg.num_layers,) + tuple(v.shape))
            .astype(np.float32) for k, v in mc.items()}


def _pool(cfg, seed):
    """A random g-layer pool of NUM_PAGES pages (page 0 the null page):
    numpy for JAX, and the port's copy with its zero sink page appended."""
    rng = np.random.default_rng(seed)
    g = cfg.num_layers // cfg.attn_every
    shape = (g, NUM_PAGES, PAGE, cfg.eff_kv_heads, cfg.head_dim)
    pool = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    sink = np.zeros((g, 1) + shape[2:], np.float32)
    port = {k: torch.from_numpy(np.concatenate([v, sink], axis=1))
            for k, v in pool.items()}
    return pool, port


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_params_from_jax_carries_the_hybrid_tree(zamba2):
    """Every ``layers.*`` leaf and the unstacked ``shared`` subtree cross
    over with name, shape and values; ``init`` covers the same names; the
    name and shape checks cover ``shared``."""
    _, _, jparams, cfg, _ = zamba2
    flat = flatten_tree(jax.tree.map(np.asarray, jparams))
    model = build_model(cfg, device="cpu")
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    model.load_state_dict(state)
    assert set(model.state_dict()) == set(flat)
    assert {"layers.ln", "layers.mamba.w_z", "shared.ln1", "shared.attn.wq",
            "shared.attn.wo", "shared.ln2", "shared.mlp.w_down"} <= set(flat)
    assert model.shared.attn.wq.shape == (cfg.d_model, cfg.eff_heads,
                                          cfg.head_dim)
    for name, arr in flat.items():
        np.testing.assert_array_equal(model.state_dict()[name].numpy(), arr)
    fresh = build_model(cfg, device="cpu").init(seed=3)
    assert set(fresh) == set(flat)
    assert all(torch.isfinite(v).all() for v in fresh.values())
    tree = jax.tree.map(np.asarray, jparams)
    del tree["shared"]["ln2"]
    with pytest.raises(ValueError, match="shared.ln2"):
        params_from_jax(cfg, tree)
    tree = jax.tree.map(np.asarray, jparams)
    tree["shared"]["mlp"]["w_up"] = tree["shared"]["mlp"]["w_up"][:, :-1]
    with pytest.raises(ValueError, match="shared.mlp.w_up"):
        params_from_jax(cfg, tree)


def test_decode_step_hybrid_matches_jax(zamba2):
    """Two live slots at different depths (one ending on a page boundary)
    and two idle ones: logits, the bank (idle slots bit for bit
    unchanged), and the pool (idle rows went to the sink) equal JAX's."""
    _, jmodel, jparams, cfg, model = zamba2
    bank = _bank(cfg, SLOTS, seed=1)
    pool, pages = _pool(cfg, seed=2)
    tables = np.zeros((SLOTS, MP), np.int32)
    tables[0, :2] = [3, 7]
    tables[2, :3] = [5, 1, 9]
    lengths = np.array([11, 0, 16, 0], np.int32)
    active = np.array([1, 0, 1, 0], np.int32)
    tokens = np.array([[5], [77], [200], [1]], np.int32)
    jpages, jstate, jlogits = jmodel.decode_step_hybrid(
        jparams, {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(tokens), jnp.asarray(active))
    state = {k: torch.from_numpy(v.copy()) for k, v in bank.items()}
    logits = model.decode_step_hybrid(
        pages, state, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(tokens), torch.from_numpy(active))
    _close(logits, jlogits)
    for k in bank:
        _close(state[k], jstate[k])
        np.testing.assert_array_equal(state[k][:, active == 0].numpy(),
                                      bank[k][:, active == 0])
    for k in pool:
        _close(pages[k][:, :NUM_PAGES], jpages[k])
        # the null page is never written: idle rows scatter to the sink
        np.testing.assert_array_equal(pages[k][:, 0].numpy(), pool[k][:, 0])


@pytest.mark.parametrize("start,valid", [(0, C), (20, 9)],
                         ids=["from0-full", "prefix-partial"])
def test_prefill_chunk_hybrid_matches_jax(zamba2, start, valid):
    """One C-token chunk of one sequence into its pages, from position 0
    (full chunk) and after a 20-token cached prefix (valid 9 < C, the
    chunk straddling a page): logits at ``valid - 1``, the slot's new
    state and the pool equal JAX's; the input state is not modified."""
    _, jmodel, jparams, cfg, model = zamba2
    bank = _bank(cfg, 1, seed=3 + start)
    pool, pages = _pool(cfg, seed=4 + start)
    row = np.array([6, 2, 10, 4], np.int32)
    toks = np.random.default_rng(valid).integers(
        1, cfg.vocab_size, C).astype(np.int32)
    jpages, jstate, jlogits = jmodel.prefill_chunk_hybrid(
        jparams, {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(row),
        jnp.asarray(toks), jnp.int32(start), jnp.int32(valid))
    state = {k: torch.from_numpy(v.copy()) for k, v in bank.items()}
    new, logits = model.prefill_chunk_hybrid(
        pages, state, torch.from_numpy(row), torch.from_numpy(toks), start,
        valid)
    _close(logits, jlogits)
    for k in bank:
        _close(new[k], jstate[k])
        np.testing.assert_array_equal(state[k].numpy(), bank[k])
    for k in pool:
        _close(pages[k][:, :NUM_PAGES], jpages[k])


@pytest.mark.parametrize("arch", ["mamba2", "zamba2"])
def test_dense_cache_prefill_and_decode_match_jax(arch, mamba2, zamba2):
    """``prefill`` of a left-padded batch (the pads run through the
    recurrence, as in the JAX package) and four ``decode_step`` calls:
    logits and every cache leaf (the stacked Mamba tree, the hybrid's
    per-group K/V, ``pos``) equal JAX's after each call."""
    jcfg, jmodel, jparams, cfg, model = mamba2 if arch == "mamba2" else zamba2
    max_len = 24
    rng = np.random.default_rng(7)
    toks = np.zeros((2, 12), np.int32)
    toks[0] = rng.integers(1, cfg.vocab_size, 12)
    toks[1, 5:] = rng.integers(1, cfg.vocab_size, 7)
    jprefill = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len))
    jcache, jlogits = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    cache, logits = model.prefill({"tokens": torch.from_numpy(toks)},
                                  max_len)
    want = {"mamba", "pos"} | ({"shared_k", "shared_v"}
                               if arch == "zamba2" else set())
    assert set(cache) == set(jcache) == want

    def check():
        _close(logits, jlogits)
        jflat = flatten_tree(jax.tree.map(np.asarray, jcache))
        flat = flatten_tree(cache)
        assert set(flat) == set(jflat)
        for name, arr in jflat.items():
            assert flat[name].dtype == getattr(torch, str(arr.dtype)), name
            _close(flat[name], arr)

    check()
    jstep = jax.jit(jmodel.decode_step)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(nxt))
        cache, logits = model.decode_step(cache, torch.from_numpy(nxt))
        check()
