"""The moe family (reduced dbrx-132b, f32, on the CPU) against the JAX
package.

* ``models/moe.py``: ``route`` (gates, indices, aux; ties toward the lower
  expert index) and ``moe_block`` on its three paths (S == 1, the dense
  all-experts combine; the capacity dispatch with drops at
  capacity_factor 1.25; the ``MOE_SEQ_CHUNK`` split, both packages'
  constant set to 16 inside the test) within 1e-5 of JAX's, and the port
  of ``tests/test_models.py::test_moe_capacity_drop_monotone`` for both
  moe configs.
* ``DecoderLM``'s entry points (``prefill``, ``decode_step``, the three
  paged ones, ``verify_step_paged``) within 1e-4 of JAX's on the same
  weights (``params_from_jax``), pages too; ``loss_fn``'s loss and aux
  within 1e-5 and its gradients within 5e-4 (relative) of ``jax.grad``.
* Engine streams byte-equal to the JAX engine's: the paged engine in each
  step mode against JAX's same mode, the lockstep engine, and the paged
  engine with the ngram proposer against JAX's speculating engine. The
  reference's fused and interleaved streams part at capacity_factor 1.25
  (a chunk drops tokens that a one-row fused step runs through every
  expert) and agree at 16, in both packages: pinned here, never compared
  across modes otherwise.
* ``launch.train`` for 3 steps: its losses against JAX's train step from
  the same initial weights on the same batches.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import GenerationEngine as JLockstep  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import flatten_tree, unflatten_tree  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 GenerationEngine, Request, SamplingParams)
from repro_torch.train.step import _loss_and_grads  # noqa: E402

ARCH = "dbrx-132b"
TOL = 1e-4
NUM_PAGES, PAGE, MP = 12, 8, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _block_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.5,
            "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
            "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
            "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / 11}


def _both(p):
    return (jax.tree.map(jnp.asarray, p), {k: _t(v) for k, v in p.items()})


def test_route_matches_jax():
    cfg, jcfg = reduced(ARCHS[ARCH]), jreduced(JARCHS[ARCH])
    jp, tp = _both(_block_params(cfg))
    x = np.random.default_rng(1).standard_normal(
        (3, 10, cfg.d_model)).astype(np.float32)
    jg, ji, ja = jmoe.route(jp, jnp.asarray(x), jcfg)
    tg, ti, ta = tmoe.route(tp, _t(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(ta) - float(ja)) <= 1e-5 * abs(float(ja))
    assert tg.dtype == ta.dtype == torch.float32
    # a zero router: every probability ties, and both pick experts 0..k-1
    jz, tz = _both({**_block_params(cfg),
                    "router": np.zeros((cfg.d_model, cfg.num_experts),
                                       np.float32)})
    _, ji, _ = jmoe.route(jz, jnp.asarray(x), jcfg)
    _, ti, _ = tmoe.route(tz, _t(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == np.arange(cfg.experts_per_token)).all()


@pytest.mark.parametrize("path", ["decode", "capacity", "seq_chunk"])
def test_moe_block_matches_jax(path, monkeypatch):
    """S == 1 (the dense one-hot combine), the capacity dispatch at
    capacity_factor 1.25 with assignments dropped, and the MOE_SEQ_CHUNK
    split (16 in both packages, 3 chunks): y and aux within 1e-5."""
    cfg, jcfg = reduced(ARCHS[ARCH]), jreduced(JARCHS[ARCH])
    jp, tp = _both(_block_params(cfg, seed=2))
    shape = {"decode": (4, 1), "capacity": (2, 24), "seq_chunk": (2, 48)}[path]
    x = np.random.default_rng(3).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    if path == "seq_chunk":
        monkeypatch.setattr(jmoe, "MOE_SEQ_CHUNK", 16)
        monkeypatch.setattr(tmoe, "MOE_SEQ_CHUNK", 16)
    if path == "capacity":  # the reference drops some assignments here
        _, idx, _ = jmoe.route(jp, jnp.asarray(x), jcfg)
        counts = np.stack([np.bincount(np.asarray(idx)[b].ravel(),
                                       minlength=cfg.num_experts)
                           for b in range(shape[0])])
        assert counts.max() > jmoe.capacity(jcfg, shape[1])
    jy, ja = jmoe.moe_block(jp, jnp.asarray(x), jcfg)
    ty, ta = tmoe.moe_block(tp, _t(x), cfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(ta) - float(ja)) <= 1e-5 * abs(float(ja))


@pytest.mark.parametrize("name", ["grok-1-314b", "dbrx-132b"])
def test_moe_capacity_drop_monotone(name):
    """With a large capacity_factor no token drops: the capacity path's
    outputs are finite, equal JAX's on the same parameters, and its first
    position equals the S == 1 path's on that token alone."""
    from repro.models.common import init_params

    cfg = dataclasses.replace(reduced(ARCHS[name]), capacity_factor=8.0)
    jcfg = dataclasses.replace(jreduced(JARCHS[name]), capacity_factor=8.0)
    jp = init_params(jmoe.moe_param_specs(jcfg), jax.random.key(0),
                     "float32")
    tp = {k: _t(v) for k, v in jax.tree.map(np.asarray, jp).items()}
    x = (np.random.default_rng(0).standard_normal((2, 16, cfg.d_model))
         * 0.1).astype(np.float32)
    y, aux = tmoe.moe_block(tp, _t(x), cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    jy, _ = jmoe.moe_block(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    y1, _ = tmoe.moe_block(tp, _t(x[:, :1]), cfg)
    assert torch.isfinite(y1).all()
    np.testing.assert_allclose(y1.numpy(), y[:, :1].numpy(), atol=1e-6,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    return jcfg, jmodel, jparams, cfg, model, state


def test_params_carry_the_moe_tree(models):
    jcfg, jmodel, jparams, cfg, model, state = models
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert {k for k in state if k.startswith("layers.moe.")} == {
        f"layers.moe.{n}" for n in ("router", "w_gate", "w_up", "w_down")}
    assert state["layers.moe.w_gate"].shape == (cfg.num_layers, e, d, f)
    assert not any(k.startswith("layers.mlp.") for k in state)
    np.testing.assert_array_equal(
        state["layers.moe.router"].numpy(),
        np.asarray(jparams["layers"]["moe"]["router"]))


def _pools(cfg, rng):
    shape = (cfg.num_layers, NUM_PAGES, PAGE, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    sink = np.zeros((cfg.num_layers, 1) + shape[2:], np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": _t(np.concatenate([k, sink], 1)),
             "v": _t(np.concatenate([v, sink], 1))})


def _check_pages(jpages, tpages):
    for key in ("k", "v"):
        np.testing.assert_allclose(tpages[key][:, :NUM_PAGES].numpy(),
                                   np.asarray(jpages[key]), atol=TOL, rtol=TOL)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefill_and_decode_match_jax(models):
    """A left-padded lockstep batch (16 tokens: the capacity dispatch),
    then four decode steps (the S == 1 path): logits and the dense cache."""
    jcfg, jmodel, jparams, cfg, model, _ = models
    rng = np.random.default_rng(20)
    toks = rng.integers(1, cfg.vocab_size, (3, 16)).astype(np.int32)
    toks[0, :9] = 0
    max_len = 24
    jcache, jlogits = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, max_len, logits_index=-3))(jparams,
                                                     jnp.asarray(toks))
    cache, logits = model.prefill({"tokens": _t(toks)}, max_len,
                                  logits_index=-3)
    _close(logits, jlogits)
    jstep = jax.jit(jmodel.decode_step)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(nxt))
        cache, logits = model.decode_step(cache, _t(nxt))
        _close(logits, jlogits)
    for key in ("k", "v"):
        _close(cache[key], jcache[key])


def test_paged_entry_points_match_jax(models):
    """``decode_step_paged`` (one idle slot), ``prefill_chunk`` (valid <
    C), ``mixed_step_paged`` (3 decode rows + an 8-row chunk, all S == 1
    rows) and ``verify_step_paged``: logits and pages."""
    jcfg, jmodel, jparams, cfg, model, _ = models
    rng = np.random.default_rng(2)
    bt = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [9, 2, 0, 0]], np.int32)
    lengths = np.array([17, 0, 8], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jpages, tpages = _pools(cfg, rng)
    jnew, jl = jax.jit(jmodel.decode_step_paged)(
        jparams, jpages, jnp.asarray(bt), jnp.asarray(lengths),
        jnp.asarray(tokens))
    _close(model.decode_step_paged(tpages, _t(bt), _t(lengths), _t(tokens)),
           jl)
    _check_pages(jnew, tpages)

    row = np.array([5, 2, 9, 0], np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    for fn in ("prefill_chunk", "verify_step_paged"):
        jpages, tpages = _pools(cfg, rng)
        jnew, jl = jax.jit(getattr(jmodel, fn))(
            jparams, jpages, jnp.asarray(row), jnp.asarray(chunk),
            jnp.int32(11), jnp.int32(5))
        _close(getattr(model, fn)(tpages, _t(row), _t(chunk), i32(11),
                                  i32(5)), jl)
        _check_pages(jnew, tpages)

    jpages, tpages = _pools(cfg, rng)
    s, c, start = 3, 8, 9
    tables = np.concatenate([bt, np.repeat(row[None], c, axis=0)])
    positions = np.array([12, -1, 24] + [start + i if i < 5 else -1
                                         for i in range(c)], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (s + c, 1)).astype(np.int32)
    fn = jax.jit(jmodel.mixed_step_paged, static_argnames=("num_decode",))
    jnew, jl = fn(jparams, jpages, jnp.asarray(tables), jnp.asarray(positions),
                  jnp.asarray(toks), num_decode=s, chunk_valid=jnp.int32(5))
    _close(model.mixed_step_paged(tpages, _t(tables), _t(positions), _t(toks),
                                  num_decode=s, chunk_valid=i32(5)), jl)
    _check_pages(jnew, tpages)


def test_loss_fn_matches_jax(models):
    """``loss = ce + 0.01 * aux``: loss, ce and aux within 1e-5 of JAX's,
    every gradient (the router's included) within 5e-4 and nonzero."""
    jcfg, jmodel, jparams, cfg, model, state = models
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "targets")}
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, m, grads = _loss_and_grads(
        model, unflatten_tree(dict(state)), {k: _t(v) for k, v in batch.items()})
    for got, want in ((loss, jl), (m["ce"], jm["ce"]), (m["aux"], jm["aux"])):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert float(m["aux"]) > 0
    assert abs(float(loss) - float(m["ce"]) - 0.01 * float(m["aux"])) < 1e-6
    want = flatten_tree(jax.tree.map(np.asarray, jg))
    got = flatten_tree(grads)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].abs().sum() > 0, k
        assert rel(got[k].numpy(), want[k]) <= 5e-4, k


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_len=64, max_slots=3, page_size=8, prefill_chunk=8)


def _requests():
    """6 requests of 3-30 tokens, 8 new; greedy and seeded top-k/top-p
    alternating."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        prompt = rng.integers(1, 256, int(rng.integers(3, 31))).tolist()
        kw = dict(max_new_tokens=8, seed=10 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"r{i}", prompt, kw))
    return out


def _serve(engine, req_cls, sp_cls):
    out = engine.generate([req_cls(u, p, sampling=sp_cls(**kw))
                           for u, p, kw in _requests()])
    return [(r.finish_reason.value, list(r.tokens)) for r in out]


def _at(cf, jcfg, cfg, jparams, state):
    if cf is None:
        return jcfg, cfg, jparams, state
    return (dataclasses.replace(jcfg, capacity_factor=cf),
            dataclasses.replace(cfg, capacity_factor=cf), jparams, state)


@pytest.fixture(scope="module")
def streams(models):
    """Paged streams per (package, step mode, capacity_factor)."""
    jcfg0, _, jparams, cfg0, _, state = models
    out = {}
    for cf in (None, 16.0):
        jcfg, cfg, _, _ = _at(cf, jcfg0, cfg0, jparams, state)
        for mode in ("fused", "interleaved"):
            kw = dict(ENGINE_KW, step_mode=mode)
            out["jax", mode, cf] = _serve(JEngine(jcfg, jparams, **kw),
                                          JRequest, JSamplingParams)
            out["port", mode, cf] = _serve(
                ContinuousBatchingEngine(cfg, state, device="cpu", **kw),
                Request, SamplingParams)
    return out


@pytest.mark.parametrize("step_mode", ["fused", "interleaved"])
def test_paged_streams_match_jax_engine(streams, step_mode):
    got = streams["port", step_mode, None]
    assert got == streams["jax", step_mode, None]
    assert all(reason == "length" and len(toks) == 8 for reason, toks in got)


def test_step_modes_part_by_capacity_drops_in_both_packages(streams):
    """At the config's capacity_factor 1.25 the fused and interleaved
    streams part (the chunk path drops tokens the one-row path keeps), in
    JAX and in the port alike; at 16 nothing drops and they agree."""
    for pkg in ("jax", "port"):
        assert streams[pkg, "fused", None] != streams[pkg, "interleaved", None]
        assert streams[pkg, "fused", 16.0] == streams[pkg, "interleaved", 16.0]
    assert streams["port", "fused", 16.0] == streams["jax", "fused", 16.0]


def test_lockstep_streams_match_jax(models):
    jcfg, _, jparams, cfg, _, state = models
    want = _serve(JLockstep(jcfg, jparams, max_len=64, max_batch=4),
                  JRequest, JSamplingParams)
    got = _serve(GenerationEngine(cfg, state, max_len=64, max_batch=4,
                                  device="cpu"), Request, SamplingParams)
    assert got == want


def test_ngram_speculation_matches_jax(models):
    """The ngram proposer on (k 3): verify bundles take the capacity path.
    Streams and speculation counters equal JAX's speculating engine's."""
    jcfg, _, jparams, cfg, _, state = models
    kw = dict(ENGINE_KW, speculative="ngram", spec_k=3)
    jeng = JEngine(jcfg, jparams, **kw)
    eng = ContinuousBatchingEngine(cfg, state, device="cpu", **kw)
    assert _serve(eng, Request, SamplingParams) == _serve(
        jeng, JRequest, JSamplingParams)
    count = lambda e: (e.stats["spec_bundles"],  # noqa: E731
                       e.utilization.spec_proposed, e.utilization.spec_accepted)
    assert count(eng) == count(jeng)
    assert count(eng)[0] > 0


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_launch_train_losses_match_jax(tmp_path):
    """``launch.train --arch dbrx-132b --reduced --device cpu``, 3 steps:
    each loss within 1e-5 (step 1) and 5e-3 (all) of JAX's train step,
    run from the port's initial weights on the driver's batches with the
    driver's AdamW."""
    from repro.train import AdamWConfig as JAdamW
    from repro.train import make_train_step as jmake_step
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch import train as launch
    from repro_torch.models.common import tree_map

    args = launch.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--steps", "3", "--batch", "4", "--seq-len",
                              "32", "--workdir", str(tmp_path)])
    arts, _, _ = launch.run(args)
    cfg = reduced(ARCHS[ARCH])
    params = unflatten_tree(build_model(cfg, device="cpu").init(args.seed))
    jcfg = jreduced(JARCHS[ARCH])
    jmodel = jbuild(jcfg)
    jparams = jax.tree.map(jnp.asarray,
                           tree_map(lambda t: t.numpy(), params))
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jstate = {"params": jparams, "opt": {"m": zeros, "v": zeros},
              "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jmake_step(jmodel, JAdamW(
        lr=args.lr, warmup_steps=10, decay_steps=100, weight_decay=0.0,
        moment_dtype="float32")))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=4,
                                        seed=args.seed, d_model=cfg.d_model))
    want = []
    for i in range(3):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray,
                                               corpus.batch_at(i)))
        want.append(float(m["loss"]))
    got = np.array(arts["losses"])
    gap = np.abs(got - want) / np.abs(want)
    assert gap[0] <= 1e-5 and (gap <= 5e-3).all(), gap
