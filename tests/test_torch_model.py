"""The port's model against the JAX ``DecoderLM`` on the same weights.

Reduced smollm-360m in float32 on the CPU: the JAX parameters
(``model.init(jax.random.key(0))``) carried across by ``params_from_jax``;
inputs from numpy with fixed seeds. Logits and page contents after each
paged entry point, and logits and the padded dense cache after
``prefill`` (left-padded batch, with and without ``logits_index``) and
several ``decode_step``s, are held to 1e-4 against the JAX model on its
default (XLA reference) attention path; the numerics helpers to 1e-5; the
sampler's noise to 1e-6 with equal sampled tokens.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.lm import padded_vocab  # noqa: E402

TOL = 1e-4
NUM_PAGES, PAGE, MP = 12, 8, 4


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["smollm-360m"])
    cfg = reduced(ARCHS["smollm-360m"])
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jmodel, jparams, cfg, model


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pools(cfg, rng):
    """Random page contents (so attention reads real history): the JAX
    pool, and the port's with its extra sink page."""
    shape = (cfg.num_layers, NUM_PAGES, PAGE, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jpages = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    sink = np.zeros((cfg.num_layers, 1) + shape[2:], np.float32)
    tpages = {"k": _t(np.concatenate([k, sink], 1)),
              "v": _t(np.concatenate([v, sink], 1))}
    return jpages, tpages


def _check_pages(jpages, tpages):
    for key in ("k", "v"):
        np.testing.assert_allclose(tpages[key][:, :NUM_PAGES].numpy(),
                                   np.asarray(jpages[key]), atol=TOL, rtol=TOL)


def test_numerics_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        common.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-5, rtol=1e-5)
    pos = np.array([[0, 3, 17, 250, 600]] * 2, np.int32)
    cos, sin = common.rope_table(_t(pos), 16, 10000.0)
    jcos, jsin = jcommon.rope_table(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    np.testing.assert_allclose(
        common.apply_rope(_t(x), cos, sin).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jcos, jsin)),
        atol=1e-5, rtol=1e-5)
    xs = rng.standard_normal((2, 3, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 32)).astype(np.float32) for _ in "gu")
    wd = rng.standard_normal((32, 16)).astype(np.float32)
    np.testing.assert_allclose(
        common.swiglu(*map(_t, (xs, wg, wu, wd))).numpy(),
        np.asarray(jcommon.swiglu(*map(jnp.asarray, (xs, wg, wu, wd)))),
        atol=1e-5, rtol=1e-5)


def test_sampler_noise_and_tokens_match_jax():
    seeds = np.array([0, 1, 7, 123456, 2**31 - 1, 42], np.int32)
    idx = np.array([0, 5, 1, 31, 2, 1000], np.int32)
    noise = common.gumbel_noise(_t(seeds), _t(idx), 300).numpy()
    want = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.PRNGKey(s), i), (300,), jnp.float32))
        for s, i in zip(seeds, idx)])
    np.testing.assert_allclose(noise, want, atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 512)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 0.5, 2.0, 1.3], np.float32)
    top_ks = np.array([0, 5, 0, 40, 0, 1], np.int32)
    top_ps = np.array([1.0, 0.9, 0.5, 1.0, 0.95, 1.0], np.float32)
    for step in range(4):
        args = (logits, temps, top_ks, top_ps, seeds, idx + step)
        got = common.sample_tokens(*map(_t, args), 500).numpy()
        exp = np.asarray(jcommon.sample_tokens(*map(jnp.asarray, args), 500))
        np.testing.assert_array_equal(got, exp)


def test_params_from_jax(models):
    jcfg, jmodel, jparams, cfg, model = models
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["layers.attn.wq"].numpy(),
                                  np.asarray(jparams["layers"]["attn"]["wq"]))
    assert state["embed"].shape == (padded_vocab(cfg), cfg.d_model)
    bad = jax.tree.map(np.asarray, jparams)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(cfg, bad)


def test_decode_step_paged_matches_jax(models):
    jcfg, jmodel, jparams, cfg, model = models
    rng = np.random.default_rng(2)
    jpages, tpages = _pools(cfg, rng)
    # slot 1 idle (null table, length 0); others at page boundaries +-1
    bt = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [9, 2, 0, 0], [4, 5, 6, 11]],
                  np.int32)
    lengths = np.array([17, 0, 8, 31], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    jnew, jlogits = jax.jit(jmodel.decode_step_paged)(
        jparams, jpages, jnp.asarray(bt), jnp.asarray(lengths),
        jnp.asarray(tokens))
    logits = model.decode_step_paged(tpages, _t(bt), _t(lengths), _t(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    _check_pages(jnew, tpages)


@pytest.mark.parametrize("start,valid", [(0, 8), (11, 5), (13, 0)])
def test_prefill_chunk_matches_jax(models, start, valid):
    jcfg, jmodel, jparams, cfg, model = models
    rng = np.random.default_rng(3 + start)
    jpages, tpages = _pools(cfg, rng)
    row = np.array([5, 2, 9, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    jnew, jlogits = jax.jit(jmodel.prefill_chunk)(
        jparams, jpages, jnp.asarray(row), jnp.asarray(tokens),
        jnp.int32(start), jnp.int32(valid))
    logits = model.prefill_chunk(tpages, _t(row), _t(tokens),
                                 torch.tensor(start, dtype=torch.int32),
                                 torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    _check_pages(jnew, tpages)


@pytest.mark.parametrize("chunk_valid", [0, 5, 8])
def test_mixed_step_paged_matches_jax(models, chunk_valid):
    jcfg, jmodel, jparams, cfg, model = models
    rng = np.random.default_rng(4 + chunk_valid)
    jpages, tpages = _pools(cfg, rng)
    s, c, start = 3, 8, 9
    dec_bt = np.array([[3, 7, 0, 0], [0, 0, 0, 0], [4, 6, 11, 1]], np.int32)
    crow = np.array([5, 2, 8, 0], np.int32)
    tables = np.concatenate([dec_bt, np.repeat(crow[None], c, axis=0)])
    positions = np.array(
        [12, -1, 24] + [start + i if i < chunk_valid else -1
                        for i in range(c)], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (s + c, 1)).astype(np.int32)
    fn = jax.jit(jmodel.mixed_step_paged, static_argnames=("num_decode",))
    jnew, jlogits = fn(jparams, jpages, jnp.asarray(tables),
                       jnp.asarray(positions), jnp.asarray(tokens),
                       num_decode=s, chunk_valid=jnp.int32(chunk_valid))
    logits = model.mixed_step_paged(
        tpages, _t(tables), _t(positions), _t(tokens), num_decode=s,
        chunk_valid=torch.tensor(chunk_valid, dtype=torch.int32))
    assert logits.shape == (s + 1, padded_vocab(cfg))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    _check_pages(jnew, tpages)


@pytest.mark.parametrize("causal", [True, False])
def test_self_attention_matches_jax(models, causal):
    """The whole-sequence attention block (the flash op's caller) on one
    layer's weights, causal and not."""
    jcfg, jmodel, jparams, cfg, model = models
    x = np.random.default_rng(22).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    want = jattn.self_attention(jp, jnp.asarray(x), jcfg, causal=causal)
    got = tattn.self_attention(model._layers()[0]["attn"], _t(x), cfg,
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _left_padded(cfg, rng, lens):
    """A lockstep batch: prompts left-padded with token 0 to the longest."""
    s = max(lens)
    toks = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        toks[i, s - n:] = rng.integers(1, cfg.vocab_size, n)
    return toks


def _check_cache(jcache, cache):
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   atol=TOL, rtol=TOL)
    assert int(cache["pos"]) == int(jcache["pos"])


@pytest.mark.parametrize("logits_index", [None, 3, -2])
def test_prefill_matches_jax(models, logits_index):
    jcfg, jmodel, jparams, cfg, model = models
    rng = np.random.default_rng(20)
    toks = _left_padded(cfg, rng, [5, 11, 2])
    max_len = 24
    jcache, jlogits = jax.jit(
        lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len,
                                    logits_index=logits_index))(
        jparams, jnp.asarray(toks))
    cache, logits = model.prefill({"tokens": _t(toks)}, max_len,
                                  logits_index=logits_index)
    assert logits.shape == (3, padded_vocab(cfg))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    _check_cache(jcache, cache)
    assert (cache["k"][:, :, toks.shape[1]:] == 0).all()  # padded to max_len


def test_decode_step_matches_jax(models):
    """Several lockstep decode steps after a left-padded prefill: logits
    and the whole cache (written in place in the port) each step, up to
    and past the cache's end."""
    jcfg, jmodel, jparams, cfg, model = models
    rng = np.random.default_rng(21)
    toks = _left_padded(cfg, rng, [7, 3])
    max_len = 12
    jcache, _ = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, max_len))(jparams, jnp.asarray(toks))
    cache, _ = model.prefill({"tokens": _t(toks)}, max_len)
    jstep = jax.jit(jmodel.decode_step)
    # steps 5 and 6 write the cache's last position: the second one at
    # pos = max_len, which dynamic_update_slice (and the port) clamp
    for _ in range(6):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(nxt))
        cache, logits = model.decode_step(cache, _t(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=TOL)
        _check_cache(jcache, cache)


def test_entry_points_refuse_cuda_without_a_card():
    """The model defaults to ``cuda`` for every family (dense, moe, vlm,
    ssm, hybrid) and raises without a card; the hybrid, moe and vlm
    families build on the CPU when asked, with their own parameters
    (``shared``; ``layers.moe`` in place of ``layers.mlp``;
    ``vision_proj``)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for arch in ("smollm-360m", "mamba2-1.3b", "zamba2-2.7b", "dbrx-132b",
                 "internvl2-26b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(reduced(ARCHS[arch]))  # device defaults to cuda
    hybrid = build_model(reduced(ARCHS["zamba2-2.7b"]), device="cpu")
    assert hybrid.cfg.family == "hybrid" and hasattr(hybrid, "shared")
    moe = build_model(reduced(ARCHS["dbrx-132b"]), device="cpu")
    assert hasattr(moe.layers, "moe") and not hasattr(moe.layers, "mlp")
    assert moe.layers.moe.router.shape == (2, 64, 4)
    vlm = build_model(reduced(ARCHS["internvl2-26b"]), device="cpu")
    assert vlm.vision_proj.device.type == "cpu"
