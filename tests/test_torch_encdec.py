"""The port's encoder-decoder (``models/encdec.py``, whisper-tiny) against
the JAX package's ``EncDecLM``, on the CPU, and the model ports of
``tests/test_models.py`` for the families this slice trains.

Reduced whisper-tiny in f32, JAX's parameters carried across by
``params_from_jax``; frames and tokens from numpy with fixed seeds, as
JAX's ``make_batch`` makes them.

* ``encode``, ``loss_fn``, ``prefill`` (logits and every cache leaf) and
  ``decode_step`` logits within 1e-4 of JAX's; the loss within 1e-5
  relative and the gradients within 5e-4 relative of JAX's and of an
  all-f64 run of the port; the trainer's step (the driver's AdamW) over
  5 steps of the pipeline's ``frames`` batches: steps 1-2 within 1e-5 of
  JAX, all five within 5e-3 of JAX and of the f64 run (the bounds of
  ``tests/test_torch_train.py``).
* The lockstep ``GenerationEngine``'s greedy and seeded top-p streams
  equal the JAX engine's byte for byte, with the same events in the same
  steps; ``launch.serve --arch whisper-tiny --engine lockstep`` serves and
  the paged default raises ``UnsupportedConfigError``.
* ``tests/test_models.py``'s smoke train step (finite loss, a finite
  gradient for every leaf) and prefill/decode consistency (prefill(T) and
  k decode steps give prefill(T + k)'s last logits within 2e-3), in the
  port, for whisper-tiny, mamba2-1.3b and zamba2-2.7b.
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.common import (all_f64, flatten_tree, tree_map,  # noqa: E402
                                       unflatten_tree)
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.serving import GenerationEngine, Request, SamplingParams  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step  # noqa: E402
from repro_torch.train.step import _loss_and_grads  # noqa: E402

ARCH = "whisper-tiny"
CFG = reduced(ARCHS[ARCH])
TOL = 1e-4
OPT = AdamWConfig(lr=3e-3, warmup_steps=10, decay_steps=100,
                  weight_decay=0.0, moment_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _make_batch(cfg, b, s, seed):
    """JAX's ``make_batch`` in numpy: tokens, targets, and frames for an
    encoder-decoder."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    return batch


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _f64(tree):
    return tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild

    jcfg = jreduced(JARCHS[ARCH])
    jmodel = jbuild(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    state = params_from_jax(CFG, jax.tree.map(np.asarray, jparams))
    model = build_model(CFG, device="cpu")
    model.load_state_dict(state)
    return jcfg, jmodel, jparams, model, state


def test_params_from_jax_carries_the_encdec_tree(pair):
    _, _, jparams, model, state = pair
    names = set(flatten_tree(model.param_specs()))
    assert names == set(state)
    assert {n.split(".")[1] for n in names if n.startswith("decoder.")} == {
        "ln1", "attn", "ln_x", "xattn", "ln2", "mlp"}
    assert {"embed", "unembed", "enc_norm", "final_norm"} <= names
    for k, v in flatten_tree(jax.tree.map(np.asarray, jparams)).items():
        assert np.array_equal(model.get_parameter(k).numpy(), v), k


def test_encode_matches_jax(pair):
    _, jmodel, jparams, model, state = pair
    frames = _make_batch(CFG, 2, 24, seed=3)["frames"]
    want = jax.jit(jmodel.encode)(jparams, jnp.asarray(frames))
    got = model.encode(unflatten_tree(state), torch.from_numpy(frames))
    _close(got, want)


@pytest.fixture(scope="module")
def step1(pair):
    """Step-1 loss and gradients: JAX f32, the port f32, the port f64."""
    _, jmodel, jparams, model, state = pair
    batch = _make_batch(CFG, 2, 32, seed=1)
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, _j(batch))
    params = unflatten_tree(state)
    l32, _, g32 = _loss_and_grads(model, params, _t(batch))
    with all_f64():
        m64 = build_model(dataclasses.replace(CFG, dtype="float64"),
                          device="cpu")
        l64, _, g64 = _loss_and_grads(m64, _f64(params), _t(batch))
    flat = lambda g: {k: np.asarray(v, np.float64)  # noqa: E731
                      for k, v in flatten_tree(g).items()}
    return {"loss": (float(jl), float(l32), float(l64)),
            "jax": flat(jax.tree.map(np.asarray, jg)), "port": flat(g32),
            "f64": flat(g64)}


def test_loss_matches_jax(step1):
    jl, l32, l64 = step1["loss"]
    assert abs(l32 - jl) / abs(jl) <= 1e-5
    assert abs(jl - l64) / abs(l64) <= 1e-5


def test_grads_match_jax(step1):
    assert step1["port"].keys() == step1["jax"].keys() == step1["f64"].keys()
    for k in step1["jax"]:
        assert rel(step1["port"][k], step1["jax"][k]) <= 5e-4, k
        assert rel(step1["port"][k], step1["f64"][k]) <= 5e-4, k
        assert rel(step1["jax"][k], step1["f64"][k]) <= 5e-4, k


def test_five_step_losses_match_jax(pair):
    """The trainer's step from JAX's initial state on 5 of the pipeline's
    batches (tokens, targets and frames), in both packages and in an
    all-f64 port run."""
    from repro.train import AdamWConfig as JAdamW
    from repro.train import init_train_state as jinit
    from repro.train import make_train_step as jmake_step

    jmodel = pair[1]
    jopt = JAdamW(**dataclasses.asdict(OPT))
    jstate0 = jinit(jmodel, jax.random.key(0), jopt)
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=CFG.vocab_size, seq_len=32, global_batch=4, seed=1,
        frames=True, d_model=CFG.d_model, dtype=CFG.dtype))
    jstep = jax.jit(jmake_step(jmodel, jopt))
    jstate, jl = jstate0, []
    for i in range(5):
        jstate, m = jstep(jstate, _j(corpus.batch_at(i)))
        jl.append(float(m["loss"]))

    def port(dtype):
        state = train_state_from_jax(CFG, jax.tree.map(np.asarray, jstate0))
        if dtype == "float64":
            state = _f64(state)
        step = make_train_step(
            build_model(dataclasses.replace(CFG, dtype=dtype), device="cpu"),
            dataclasses.replace(OPT, moment_dtype=dtype))
        out = []
        for i in range(5):
            batch = _t(corpus.batch_at(i))
            batch["frames"] = batch["frames"].to(getattr(torch, dtype))
            state, m = step(state, batch)
            out.append(float(m["loss"]))
        return np.array(out)

    p32 = port("float32")
    with all_f64():
        p64 = port("float64")
    r = lambda a, b: np.abs(np.asarray(a) - b) / np.abs(b)  # noqa: E731
    assert (r(p32, jl)[:2] <= 1e-5).all(), r(p32, jl)
    for gap in (r(p32, jl), r(p32, p64), r(jl, p64)):
        assert (gap <= 5e-3).all(), gap


def test_prefill_and_decode_match_jax(pair):
    """prefill (12 prompt tokens over 12 frames, max_len 24): logits and
    every cache leaf; then 4 decode steps' logits and the self K/V."""
    _, jmodel, jparams, model, _ = pair
    batch = _make_batch(CFG, 2, 16, seed=2)
    sub = {"tokens": batch["tokens"][:, :12], "frames": batch["frames"][:, :12]}
    jcache, jlogits = jax.jit(lambda p, b: jmodel.prefill(p, b, 24))(
        jparams, _j(sub))
    cache, logits = model.prefill(_t(sub), 24)
    _close(logits, jlogits)
    assert set(cache) == set(jcache)
    for k in cache:
        _close(cache[k], jcache[k])
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(12, 16):
        tok = batch["tokens"][:, i:i + 1]
        jcache, jlogits = jdecode(jparams, jcache, jnp.asarray(tok))
        cache, logits = model.decode_step(cache, torch.from_numpy(tok))
        _close(logits, jlogits)
    for k in ("k", "v", "pos"):
        _close(cache[k], jcache[k])


# ---------------------------------------------------------------------------
# tests/test_models.py's two per-architecture checks, in the port
# ---------------------------------------------------------------------------

SMOKE_ARCHS = [ARCH, "mamba2-1.3b", "zamba2-2.7b"]


@pytest.mark.parametrize("name", SMOKE_ARCHS)
def test_arch_smoke_train_step(name):
    cfg = reduced(ARCHS[name])
    model = build_model(cfg, device="cpu")
    params = unflatten_tree(model.init(seed=0))
    loss, metrics, grads = _loss_and_grads(model, params,
                                           _t(_make_batch(cfg, 2, 64, seed=1)))
    assert loss.shape == () and torch.isfinite(loss), (name, loss)
    assert torch.isfinite(metrics["ce"])
    for k, g in flatten_tree(grads).items():
        assert torch.isfinite(g).all(), (name, k)


@pytest.mark.parametrize("name", SMOKE_ARCHS)
def test_arch_prefill_decode_consistency(name):
    cfg = reduced(ARCHS[name])
    model = build_model(cfg, device="cpu")
    model.init(seed=0)
    t, k = 32, 4
    full = _t(_make_batch(cfg, 2, t + k, seed=2))

    def sub_batch(upto):
        b = {"tokens": full["tokens"][:, :upto]}
        if "frames" in full:
            b["frames"] = full["frames"]  # the encoder input stays fixed
        return b

    max_len = t + k + 8
    cache, logits = model.prefill(sub_batch(t), max_len)
    for i in range(k):
        cache, logits = model.decode_step(cache,
                                          full["tokens"][:, t + i:t + i + 1])
    _, want = model.prefill(sub_batch(t + k), max_len)
    _close(logits[:, :cfg.vocab_size], want[:, :cfg.vocab_size], tol=2e-3)


# ---------------------------------------------------------------------------
# the lockstep engine and the serve driver
# ---------------------------------------------------------------------------


def _serve(engine, request_cls, sampling_cls, reqs):
    handles = [engine.submit(request_cls(uid, prompt,
                                         sampling=sampling_cls(**kw)))
               for uid, prompt, kw in reqs]
    steps = []
    while not engine.idle:
        steps.append([(e.uid, e.kind, e.token, e.index)
                      for e in engine.step()])
    return [(h.finish_reason.value, list(h.tokens)) for h in handles], steps


def test_lockstep_streams_match_jax(pair):
    """Two batches of max_batch 3: the first all greedy (the argmax path),
    the second greedy and seeded top-p rows (the sampler)."""
    from repro.serving import GenerationEngine as JLockstep
    from repro.serving import Request as JRequest
    from repro.serving import SamplingParams as JSamplingParams

    jcfg, _, jparams, _, state = pair
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(5):
        kw = dict(max_new_tokens=int(rng.integers(3, 9)), seed=30 + i)
        if i == 4:
            kw.update(temperature=0.8, top_p=0.9)
        reqs.append((f"r{i}", rng.integers(1, 256, int(rng.integers(3, 20)))
                     .tolist(), kw))
    kw = dict(max_len=40, max_batch=3)
    want, jsteps = _serve(JLockstep(jcfg, jparams, **kw), JRequest,
                          JSamplingParams, reqs)
    got, tsteps = _serve(GenerationEngine(CFG, state, device="cpu", **kw),
                         Request, SamplingParams, reqs)
    assert got == want
    assert tsteps == jsteps


@pytest.mark.parametrize("engine", ["lockstep", "paged"])
def test_serve_cli(engine, tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch whisper-tiny --reduced
    --device cpu``: ``--engine lockstep`` serves every request; the paged
    default raises, naming ``--engine lockstep``."""
    from repro_torch.launch import serve
    from repro_torch.serving import UnsupportedConfigError

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--engine", engine, "--requests", "4", "--max-new", "4",
        "--workdir", str(tmp_path / "serve")])
    if engine == "paged":
        with pytest.raises(UnsupportedConfigError, match="--engine lockstep"):
            serve.main()
        return
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "engine=lockstep" in out
