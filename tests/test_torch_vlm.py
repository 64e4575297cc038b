"""The vlm path (reduced internvl2-26b, f32, on the CPU) against the JAX
package.

* ``vision_proj`` and the vision embeddings: ``prefill`` on non-zero
  ``vision_embeds`` (projected and prepended), the decode steps after it,
  ``decode_step_paged``, and ``loss_fn`` (the vision positions sliced off
  the loss; every gradient, ``vision_proj``'s included) within 1e-4 /
  1e-5 / 5e-4 of JAX's on the same weights (``params_from_jax``).
* The input spec (the training batch the port's pipeline makes, against
  JAX's ``train_input_specs``) and the context length of ``models/api.py``.
* Causal attention past the flash op's 256-position block at a length
  that is not a multiple of it (``causal_flash`` pads, the output is the
  unpadded attention's): the op alone, and ``prefill`` past 256
  positions against a shorter prefill's logits at the same position.
* Engine streams byte-equal to the JAX engines': the paged engine, which
  prefills every vlm prompt whole after zero vision embeddings whatever
  ``prefill_chunk`` says, and the lockstep engine; the paged engine
  refuses speculation for vlm, as JAX's does. Both engines hold a state
  dict already on their device without copying it.
* ``launch.train`` for 3 steps (its losses against JAX's train step from
  the same initial weights on the same batches) and ``launch.serve`` on
  the paged and lockstep engines.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import GenerationEngine as JLockstep  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models.api import cache_len, frontend_len  # noqa: E402
from repro_torch.models.attention import causal_flash  # noqa: E402
from repro_torch.models.common import flatten_tree, unflatten_tree  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 GenerationEngine, Request, SamplingParams)
from repro_torch.train.step import _loss_and_grads  # noqa: E402

ARCH = "internvl2-26b"
TOL = 1e-4


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


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    return jcfg, jmodel, jparams, cfg, model, state


def _vision(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)


def test_specs_and_params(models):
    jcfg, jmodel, jparams, cfg, model, state = models
    from repro.configs.base import ShapeConfig
    from repro.models.api import cache_len as jcache_len
    from repro.models.api import train_input_specs as jspecs

    shape = ShapeConfig("t", 32, 2, "train")
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jspecs(jcfg, shape).items()}
    batch = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
        vision_tokens=frontend_len(cfg), d_model=cfg.d_model,
        dtype=cfg.dtype)).batch_at(0)
    got = {k: (v.shape, str(v.dtype)) for k, v in batch.items()}
    assert got == want
    assert cache_len(cfg, 32) == jcache_len(jcfg, shape) == 32 + 8
    assert state["vision_proj"].shape == (cfg.d_model, cfg.d_model)
    np.testing.assert_array_equal(state["vision_proj"].numpy(),
                                  np.asarray(jparams["vision_proj"]))


def test_causal_flash_past_the_block_is_the_unpadded_attention():
    """S = 300 (past 256, not a multiple): the op alone refuses it, the
    padded call equals softmax attention in f64 within 1e-5."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 300, h, 16)).astype(np.float32)) for h in (6, 2, 2))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.flash_attention(q, k, v, causal=True)
    got = causal_flash(q, k, v, "auto")
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    kd, vd = (t.repeat_interleave(3, dim=1) for t in (kd, vd))
    s = (qd @ kd.transpose(-1, -2)) / 4.0
    s = s.masked_fill(torch.ones(300, 300, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = (s.softmax(-1) @ vd).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_prefill_past_the_flash_block_is_causal(models):
    """A vlm prompt of 292 tokens after 8 vision positions (300: padded
    inside the attention) gives at position 247 the logits of the prefill
    cut there (248 positions: one block, no padding)."""
    *_, cfg, model, _ = models
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, cfg.vocab_size, (1, 292)).astype(np.int32))
    vis = torch.from_numpy(_vision(cfg, 1, 9))
    _, long = model.prefill({"tokens": toks, "vision_embeds": vis}, 300,
                            logits_index=247)
    _, short = model.prefill({"tokens": toks[:, :240], "vision_embeds": vis},
                             248)
    np.testing.assert_allclose(long.numpy(), short.numpy(), atol=TOL,
                               rtol=TOL)


def test_prefill_and_decode_match_jax(models):
    """Non-zero vision embeddings before a left-padded batch, logits at
    the last and at an inner position, then four decode steps."""
    jcfg, jmodel, jparams, cfg, model, _ = models
    rng = np.random.default_rng(20)
    toks = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    toks[1, :5] = 0
    vis = _vision(cfg, 2, 1)
    max_len = 32
    for idx in (None, 10):
        jcache, jlogits = jax.jit(lambda p, t, v: jmodel.prefill(
            p, {"tokens": t, "vision_embeds": v}, max_len,
            logits_index=idx))(jparams, jnp.asarray(toks), jnp.asarray(vis))
        cache, logits = model.prefill(
            {"tokens": _t(toks), "vision_embeds": _t(vis)}, max_len,
            logits_index=idx)
        _close(logits, jlogits)
    assert int(cache["pos"]) == int(jcache["pos"]) == 8 + 12
    jstep = jax.jit(jmodel.decode_step)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(nxt))
        cache, logits = model.decode_step(cache, _t(nxt))
        _close(logits, jlogits)
    for key in ("k", "v"):
        _close(cache[key], jcache[key])


def test_decode_step_paged_matches_jax(models):
    jcfg, jmodel, jparams, cfg, model, _ = models
    rng = np.random.default_rng(2)
    n_pages, page = 12, 8
    shape = (cfg.num_layers, n_pages, page, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    sink = np.zeros((cfg.num_layers, 1) + shape[2:], np.float32)
    tpages = {"k": _t(np.concatenate([k, sink], 1)),
              "v": _t(np.concatenate([v, sink], 1))}
    bt = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [9, 2, 0, 0]], np.int32)
    lengths = np.array([17, 0, 8], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jnew, jl = jax.jit(jmodel.decode_step_paged)(
        jparams, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(bt),
        jnp.asarray(lengths), jnp.asarray(tokens))
    _close(model.decode_step_paged(tpages, _t(bt), _t(lengths), _t(tokens)),
           jl)
    for key in ("k", "v"):
        _close(tpages[key][:, :n_pages], jnew[key])


def test_loss_fn_matches_jax(models):
    """The vision positions are dropped before the CE: loss within 1e-5,
    every gradient within 5e-4 and nonzero, ``vision_proj``'s included."""
    jcfg, jmodel, jparams, cfg, model, state = models
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    batch["vision_embeds"] = _vision(cfg, 2, 6)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, m, grads = _loss_and_grads(
        model, unflatten_tree(dict(state)), {k: _t(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    want = flatten_tree(jax.tree.map(np.asarray, jg))
    got = flatten_tree(grads)
    assert got.keys() == want.keys() and "vision_proj" in got
    for k in want:
        assert got[k].abs().sum() > 0, k
        assert rel(got[k].numpy(), want[k]) <= 5e-4, k


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


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


def test_paged_streams_match_jax_engine(models):
    """``prefill_chunk=8`` is asked for, but a vlm prompt is prefilled
    whole (one ``prefill_whole`` an admission, no prefix sharing), in both
    packages."""
    jcfg, _, jparams, cfg, _, state = models
    kw = dict(max_len=64, max_slots=3, page_size=8, prefill_chunk=8)
    want = _serve(JEngine(jcfg, jparams, **kw), JRequest, JSamplingParams)
    eng = ContinuousBatchingEngine(cfg, state, device="cpu", **kw)
    assert not eng.prefix_sharing and eng.executor.nf == 8
    got = _serve(eng, Request, SamplingParams)
    assert got == want
    assert all(reason == "length" and len(t) == 8 for reason, t in got)
    assert eng.stats["prefill_chunks"] == 0 and eng.stats["prefills"] == 6
    # the context counts the vision positions: 8 + 50 + 8 > 64
    h = eng.submit(Request("long", list(range(1, 51)),
                           sampling=SamplingParams(max_new_tokens=8)))
    assert h.done and "exceeds engine max_len=64" in h.result().error
    with pytest.raises(ValueError, match="family 'vlm' has none"):
        ContinuousBatchingEngine(cfg, state, device="cpu",
                                 speculative="ngram", **kw)


def test_engines_hold_the_state_dict_without_a_copy(models):
    """An engine built on a state dict already on its device in the
    model's dtypes holds those very tensors: its model is registered on
    the meta device first, so building it allocates no second copy (40 GB
    for internvl2-26b). A state dict in another dtype is copied in."""
    _, _, _, cfg, _, state = models
    for eng in (ContinuousBatchingEngine(cfg, state, device="cpu"),
                GenerationEngine(cfg, state, device="cpu")):
        got = eng.model.state_dict()
        assert all(got[k].data_ptr() == v.data_ptr() for k, v in state.items())
        assert eng.model.device == torch.device("cpu")
    f64 = {k: v.to(torch.float64) for k, v in state.items()}
    model = build_model(cfg, params=f64, device="cpu")
    assert model.vision_proj.dtype == torch.float32
    torch.testing.assert_close(model.vision_proj, state["vision_proj"])


def test_lockstep_streams_match_jax(models):
    jcfg, _, jparams, cfg, _, state = models
    want = _serve(JLockstep(jcfg, jparams, max_len=64, max_batch=4),
                  JRequest, JSamplingParams)
    got = _serve(GenerationEngine(cfg, state, max_len=64, max_batch=4,
                                  device="cpu"), Request, SamplingParams)
    assert got == want


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def test_launch_train_losses_match_jax(tmp_path):
    """``launch.train --arch internvl2-26b --reduced --device cpu``, 3
    steps on the pipeline's vision embeddings: each loss within 1e-5
    (step 1) and 5e-3 (all) of JAX's train step from the port's initial
    weights on the same batches with the driver's AdamW."""
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
    jmodel = jbuild(jreduced(JARCHS[ARCH]))
    jparams = jax.tree.map(jnp.asarray,
                           tree_map(lambda t: t.numpy(), params))
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jstate = {"params": jparams, "opt": {"m": zeros, "v": zeros},
              "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jmake_step(jmodel, JAdamW(
        lr=args.lr, warmup_steps=10, decay_steps=100, weight_decay=0.0,
        moment_dtype="float32")))
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
        seed=args.seed, vision_tokens=cfg.num_frontend_tokens,
        d_model=cfg.d_model, dtype=cfg.dtype))
    assert corpus.batch_at(0)["vision_embeds"].shape == (4, 8, cfg.d_model)
    want = []
    for i in range(3):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray,
                                               corpus.batch_at(i)))
        want.append(float(m["loss"]))
    got = np.array(arts["losses"])
    gap = np.abs(got - want) / np.abs(want)
    assert gap[0] <= 1e-5 and (gap <= 5e-3).all(), gap


@pytest.mark.parametrize("arch,extra,engine", [
    (ARCH, (), "paged"),
    (ARCH, ("--engine", "lockstep"), "lockstep"),
    ("dbrx-132b", ("--step-mode", "interleaved", "--layers", "1"), "paged"),
    ("dbrx-132b", ("--engine", "lockstep"), "lockstep"),
])
def test_serve_driver(arch, extra, engine, tmp_path, monkeypatch, capsys):
    """``launch.serve --arch ... --reduced --device cpu`` serves every
    request of both families on the paged and the lockstep engine (dbrx
    once with its depth cut by ``--layers``)."""
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--reduced", "--device", "cpu",
        "--requests", "6", "--max-new", "4", "--workdir", str(tmp_path),
        *extra])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "served 6/6" in out and f"engine={engine}" in out
