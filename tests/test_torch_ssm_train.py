"""Training the ssm (mamba2) and hybrid (zamba2) families in the port, on
the CPU, against the JAX package.

* ``ops.SSDScanFunction`` (the scan kernel's forward and the plain scan's
  gradient) with the plain forward standing in for the kernel passes
  ``torch.autograd.gradcheck`` in f64: a ragged S (40 at chunk 16), an
  ``init_state``, upstream gradients on y and on the final state; its
  values and gradients equal the plain version's own autograd, a missing
  upstream gradient counting as zeros.
* Both SSD kernel wrappers refuse inputs that require grad.
* ``mamba_block``'s gradients against ``jax.grad`` of JAX's.
* ``loss_fn`` and its gradients, and the per-step losses of the trainer's
  step (``make_train_step`` with the driver's AdamW settings) over 5
  steps, at the reduced f32 configs with JAX's initial parameters carried
  across (``train_state_from_jax``) and the same numpy-seeded batches.
  The bounds are ``tests/test_torch_train.py``'s for the dense family:
  loss 1e-5 relative; gradients 5e-4 relative, each against JAX and
  against an all-f64 run of the port; losses of steps 1-2 within 1e-5 of
  JAX, all five within 5e-3 of JAX and of the f64 run.
* ``launch.train --reduced --device cpu --chaos`` gives the uninterrupted
  run's losses exactly, for both families.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_decode_step_bh, ssd_scan_bshp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import (all_f64, flatten_tree, tree_map,  # noqa: E402
                                       unflatten_tree)
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.models.ssm import mamba_block  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step  # noqa: E402
from repro_torch.train.step import _loss_and_grads  # noqa: E402

ARCH = {"ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b"}
# the driver's AdamW (launch/train.py at its default --lr and 5 steps)
OPT = AdamWConfig(lr=3e-3, warmup_steps=10, decay_steps=100,
                  weight_decay=0.0, moment_dtype="float32")
BATCH, SEQ = 4, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f64(tree):
    return tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)


def _corpus(cfg):
    return SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH, seed=1))


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the SSD scan's autograd Function
# ---------------------------------------------------------------------------


def _plain_forward(x, dt, A, Bm, Cm, init_state, chunk):
    return ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
                        impl="ref")


def _scan_inputs(s, init, seed=3):
    g = torch.Generator().manual_seed(seed)
    b, h, p, n = 1, 2, 3, 4

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, dtype=torch.float64)
                * scale).requires_grad_()

    x = rnd(b, s, h, p)
    dt = (0.1 + torch.rand(b, s, h, generator=g, dtype=torch.float64)
          ).requires_grad_()
    A = (-0.5 - torch.rand(h, generator=g, dtype=torch.float64)
         ).requires_grad_()
    Bm, Cm = rnd(b, s, n, scale=0.5), rnd(b, s, n, scale=0.5)
    h0 = rnd(b, h, p, n) if init else None
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
def test_ssd_function_gradcheck(init):
    """S 40 at chunk 16 (padded to 48 by the plain version), from zero or
    from an ``init_state``: both outputs' upstream gradients reach x, dt,
    A, Bm, Cm (and the state); the values and gradients are the plain
    version's own autograd's."""
    inputs = _scan_inputs(40, init)

    def fn(*args):
        return ops.SSDScanFunction.apply(*args, 16, _plain_forward)

    with all_f64():  # the plain version computes in f32 otherwise
        assert torch.autograd.gradcheck(fn, inputs, fast_mode=True)
        y, fs = fn(*inputs)
        yr, fsr = _plain_forward(*inputs, 16)
        assert torch.equal(y, yr) and torch.equal(fs, fsr)
        wanted = [t for t in inputs if t is not None]
        gy, gs = torch.randn_like(y), torch.randn_like(fs)
        got = torch.autograd.grad((y, fs), wanted, (gy, gs))
        want = torch.autograd.grad((yr, fsr), wanted, (gy, gs))
    assert len(got) == (6 if init else 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.allclose(a, b, rtol=1e-12,
                                                     atol=1e-12)


@pytest.mark.parametrize("out", [0, 1], ids=["y", "final_state"])
def test_ssd_function_counts_a_missing_upstream_gradient_as_zeros(out):
    """A loss of y alone (the training path: the final state is dropped)
    or of the final state alone gives the plain autograd's gradients; the
    inputs that do not require grad get none."""
    x, dt, A, Bm, Cm, h0 = _scan_inputs(24, True, seed=4)
    A = A.detach()
    ins = (x, dt, Bm, Cm, h0)
    with all_f64():
        got_out = ops.SSDScanFunction.apply(x, dt, A, Bm, Cm, h0, 16,
                                            _plain_forward)[out]
        want_out = _plain_forward(x, dt, A, Bm, Cm, h0, 16)[out]
        w = torch.randn_like(got_out)
        # the final state does not depend on Cm: its gradient is zeros
        got, want = (torch.autograd.grad((o * w).sum(), ins,
                                         allow_unused=True,
                                         materialize_grads=True)
                     for o in (got_out, want_out))
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def test_ssd_kernel_wrappers_refuse_inputs_that_require_grad():
    """Both SSD kernels are forwards only: under grad mode their wrappers
    refuse inputs that require grad before any other check; without a
    gradient asked, on to the device check."""
    x, dt, A, Bm, Cm, _ = (t if t is None else t.float()
                           for t in _scan_inputs(8, False))
    state = torch.zeros(1, 2, 3, 4)
    decode_args = (state, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    for call in (lambda: ssd_scan_bshp(x, dt, A, Bm, Cm),
                 lambda: ssd_decode_step_bh(*decode_args)):
        with pytest.raises(RuntimeError, match="gives no gradient"):
            call()
        with torch.no_grad():
            with pytest.raises(ValueError, match="CUDA tensor"):
                call()


# ---------------------------------------------------------------------------
# the Mamba2 block and the two families' losses against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """Per family: the JAX model, config, optimizer and initial state."""
    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    from repro.train import AdamWConfig as JAdamW
    from repro.train import init_train_state as jinit

    out = {}
    for family, arch in ARCH.items():
        jcfg = jreduced(JARCHS[arch])
        jopt = JAdamW(**dataclasses.asdict(OPT))
        model = jbuild(jcfg)
        init = jax.jit(lambda key, m=model, o=jopt: jinit(m, key, o))
        out[family] = {"cfg": jcfg, "opt": jopt, "model": model,
                       "state": init(jax.random.key(0))}
    return out


def _carried(family, jstate):
    return train_state_from_jax(reduced(ARCHS[ARCH[family]]),
                                jax.tree.map(np.asarray, jstate))


def test_mamba_block_grads_match_jax(jax_side):
    """One reduced mamba2 layer on x (2 x 40: a ragged last chunk), a
    loss ``sum(w * out)``: the gradients of x and of every parameter
    within 5e-4 of ``jax.grad`` of JAX's ``mamba_block`` and of the port's
    all-f64 run."""
    from repro.models.ssm import mamba_block as jmamba_block

    side = jax_side["ssm"]
    cfg = reduced(ARCHS[ARCH["ssm"]])
    jp = jax.tree.map(lambda a: a[0], side["state"]["params"]["layers"]["mamba"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)

    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jnp.asarray(w) * jmamba_block(
        p, x, side["cfg"])), argnums=(0, 1)))(jp, jnp.asarray(x))
    want = {**flatten_tree(jax.tree.map(np.asarray, jg[0])),
            "x": np.asarray(jg[1])}

    def port(dtype):
        p = {k: torch.from_numpy(np.array(v)).to(dtype).requires_grad_()
             for k, v in flatten_tree(jax.tree.map(np.asarray, jp)).items()}
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        loss = (torch.from_numpy(w).to(dtype) * mamba_block(p, xt, cfg)).sum()
        grads = torch.autograd.grad(loss, [*p.values(), xt])
        return dict(zip([*p, "x"], (g.numpy() for g in grads)))

    g32 = port(torch.float32)
    with all_f64():
        g64 = port(torch.float64)
    assert g32.keys() == want.keys()
    for k in want:
        assert rel(g32[k], want[k]) <= 5e-4, k
        assert rel(g32[k], g64[k]) <= 5e-4, k
        assert rel(want[k], g64[k]) <= 5e-4, k


@pytest.fixture(scope="module", params=list(ARCH))
def step1(request, jax_side):
    """Step-1 loss and gradients: JAX f32, the port f32, the port f64."""
    family = request.param
    side = jax_side[family]
    cfg = reduced(ARCHS[ARCH[family]])
    batch = _corpus(cfg).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(side["model"].loss_fn,
                                             has_aux=True))(
        side["state"]["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    params = _carried(family, side["state"])["params"]
    l32, _, g32 = _loss_and_grads(build_model(cfg, device="cpu"), params,
                                  _tensors(batch))
    with all_f64():
        m64 = build_model(dataclasses.replace(cfg, dtype="float64"),
                          device="cpu")
        l64, _, g64 = _loss_and_grads(m64, _f64(params), _tensors(batch))
    flat = lambda g: {k: np.asarray(v, np.float64)  # noqa: E731
                      for k, v in flatten_tree(g).items()}
    return {"family": family, "loss": (float(jl), float(l32), float(l64)),
            "jax": flat(jax.tree.map(np.asarray, jg)), "port": flat(g32),
            "f64": flat(g64)}


def test_step1_loss_matches_jax(step1):
    jl, l32, l64 = step1["loss"]
    assert abs(l32 - jl) / abs(jl) <= 1e-5, step1["family"]
    assert abs(jl - l64) / abs(l64) <= 1e-5, step1["family"]


def test_step1_grads_match_jax(step1):
    """Leaf by leaf, every leaf finite: the port within 5e-4 of JAX, and
    each package's f32 gradient within 5e-4 of the all-f64 run."""
    assert step1["port"].keys() == step1["jax"].keys() == step1["f64"].keys()
    for k in step1["jax"]:
        assert np.isfinite(step1["port"][k]).all(), k
        assert rel(step1["port"][k], step1["jax"][k]) <= 5e-4, k
        assert rel(step1["port"][k], step1["f64"][k]) <= 5e-4, k
        assert rel(step1["jax"][k], step1["f64"][k]) <= 5e-4, k


@pytest.mark.parametrize("family", list(ARCH))
def test_five_step_losses_match_jax(jax_side, family):
    """The trainer's step (the driver's AdamW) from JAX's initial state on
    the same 5 batches in both packages, and in an all-f64 port run."""
    from repro.train import make_train_step as jmake_step

    side = jax_side[family]
    cfg = reduced(ARCHS[ARCH[family]])
    corpus = _corpus(cfg)
    jstate = side["state"]
    jstep = jax.jit(jmake_step(side["model"], side["opt"]))
    jl = []
    for i in range(5):
        jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in corpus.batch_at(i).items()})
        jl.append(float(m["loss"]))

    def port(dtype):
        state = _carried(family, side["state"])
        if dtype == "float64":
            state = _f64(state)
        step = make_train_step(
            build_model(dataclasses.replace(cfg, dtype=dtype), device="cpu"),
            dataclasses.replace(OPT, moment_dtype=dtype))
        out = []
        for i in range(5):
            state, m = step(state, _tensors(corpus.batch_at(i)))
            out.append(float(m["loss"]))
        return np.array(out)

    p32 = port("float32")
    with all_f64():
        p64 = port("float64")
    r = lambda a, b: np.abs(np.asarray(a) - b) / np.abs(b)  # noqa: E731
    assert (r(p32, jl)[:2] <= 1e-5).all(), r(p32, jl)
    for gap in (r(p32, jl), r(p32, p64), r(jl, p64)):
        assert (gap <= 5e-3).all(), gap


@pytest.mark.parametrize("family", list(ARCH))
def test_remat_policy_changes_neither_loss_nor_grads(family):
    """The hybrid stack's remat unit is a group; a ``group*`` policy runs
    as ``"nothing"`` there, as in the JAX package."""
    cfg = reduced(ARCHS[ARCH[family]])
    batch = _tensors(_corpus(cfg).batch_at(0))
    model = build_model(cfg, device="cpu")
    params = unflatten_tree(model.init(seed=2))
    base = _loss_and_grads(model, params, batch)
    for policy in ("none", "group2"):
        m = build_model(dataclasses.replace(cfg, remat_policy=policy),
                        device="cpu")
        loss, _, grads = _loss_and_grads(m, params, batch)
        assert torch.equal(loss, base[0]), policy
        for a, b in zip(flatten_tree(grads).values(),
                        flatten_tree(base[2]).values()):
            assert torch.equal(a, b), policy


@pytest.mark.parametrize("family", list(ARCH))
def test_launch_train_chaos_replays_exactly(family, tmp_path):
    """``launch.train --arch ... --reduced --device cpu --chaos``: the
    train pod killed on the driver's wall-clock timer, the later attempts
    restoring from the checkpoints; the losses equal the uninterrupted
    run's, bit for bit, and the loss improves. (Batches that keep each
    attempt past the driver's 1 s kill timer.)"""
    from repro_torch.launch import train as launch

    def run(name, *extra):
        return launch.run(launch.parse_args([
            "--arch", ARCH[family], "--reduced", "--device", "cpu",
            "--steps", "30", "--batch", {"ssm": "4", "hybrid": "2"}[family],
            "--ckpt-every", "5", "--workdir", str(tmp_path / name), *extra]))

    calm, _, _ = run("calm")
    assert calm["report"]["improved"]
    arts, sched, stats = run("chaos", "--chaos")
    kinds = [e["kind"] for e in sched.events.history()]
    assert kinds.count("step_retry_scheduled") >= 1
    assert arts["losses"] == calm["losses"]
    assert arts["report"] == calm["report"]


def test_launch_train_leaves_no_pod_running(monkeypatch, tmp_path):
    """``launch.train.run`` returns once every pod it started has ended:
    the evaluate replica the other one superseded (here the later of the
    two, held back 1 s) stops at its next heartbeat instead of running on
    (and launching kernels, and holding the parameters) after the run."""
    import time

    from repro_torch.launch import train as launch

    real = launch.build_workflow

    def with_a_slow_replica(*args, **kwargs):
        graph = real(*args, **kwargs)
        evaluate, calls = graph.steps["evaluate"].fn, []

        def fn(inputs, ctx):
            calls.append(ctx.pod_name)
            if len(calls) == 2:
                time.sleep(1.0)
            return evaluate(inputs, ctx)

        graph.steps["evaluate"].fn = fn
        return graph

    monkeypatch.setattr(launch, "build_workflow", with_a_slow_replica)
    arts, sched, _ = launch.run(launch.parse_args([
        "--arch", ARCH["ssm"], "--reduced", "--device", "cpu", "--steps",
        "2", "--batch", "2", "--workdir", str(tmp_path)]))
    pods = [p for st in sched._state.values() for p in st.pods]
    assert sum(p.image.step.name == "evaluate" for p in pods) == 2
    assert not any(p.is_alive() for p in pods)
    assert arts["report"]["steps"] == 2


def test_a_long_checkpoint_keeps_its_pod_alive(monkeypatch, tmp_path):
    """A checkpoint save and restore that outlast the scheduler's liveness
    window (here 0.5 s against saves of 1 s): the pod keeps beating from a
    side thread, so no attempt is killed as a zombie and the run needs no
    retry."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ArtifactStore, TopicBus, WorkflowScheduler
    from repro_torch.core.scheduler import RetryPolicy
    from repro_torch.launch import train as launch

    save, restore = CheckpointManager.save, CheckpointManager.restore

    def slow(fn):
        def call(*args, **kwargs):
            time.sleep(1.0)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(CheckpointManager, "save", slow(save))
    monkeypatch.setattr(CheckpointManager, "restore", slow(restore))
    monkeypatch.setattr(launch, "KEEPALIVE_S", 0.1)
    args = launch.parse_args(["--arch", ARCH["ssm"], "--reduced", "--device",
                              "cpu", "--steps", "4", "--batch", "2",
                              "--ckpt-every", "2", "--workdir", str(tmp_path)])
    stats = {}
    graph = launch.build_workflow(args, tmp_path, stats=stats)
    store = ArtifactStore(tmp_path / "store")
    sched = WorkflowScheduler(
        graph, TopicBus(tmp_path / "bus"), store,
        retry=RetryPolicy(max_attempts=2, backoff_s=0.01),
        liveness_window_s=0.5,
        claim_paths={"train": str(store.claim("ckpt").path)}, device="cpu")
    arts = sched.run(timeout_s=120)
    sched.join()
    assert sched.events.history("pod_liveness_kill") == []
    assert sched.events.history("step_retry_scheduled") == []
    assert len(stats["attempts"]) == 1 and len(stats["attempts"][0]["save_s"]) == 2
    assert arts["report"]["steps"] == 4
