"""The port's trainer (``repro_torch.train``, ``checkpoint``, ``data``,
``launch.train`` and the dense ``DecoderLM.loss_fn``), on the CPU.

* Ports of ``tests/test_train.py`` (learning, ga equivalence, exact
  resume, clipping, the AdamW arithmetic, the data pipeline) and of
  ``tests/test_checkpoint.py``, the elastic reshard included
  (``restore(shardings=...)`` onto a host mesh and onto two CPU ranks).
* Cross-package, at ``tests/test_train.py``'s reduced f32 config with
  JAX's initial parameters carried across (``train_state_from_jax``):
  the step-1 loss within 1e-5 relative; the step-1 gradients, leaf by
  leaf; the optimizer's update on identical gradients within 1e-6; the
  per-step losses over 5 steps at ga 1 and 2.
  The gradients and the later losses are held against an all-f64 run of
  the port (``_all_f64``), because f32 rounding alone moves them more
  than 1e-5: both packages' f32 step-1 gradients sit 1.3e-4 to 1.9e-4
  (relative norm) from it, and Adam's sign-like first steps (each
  parameter moves by about ±lr) carry that into the losses of steps 3-5
  at up to 1.6e-3, in either package. So: steps 1 and 2 within 1e-5 of
  JAX; gradients within 5e-4, and losses of steps 3-5 within 5e-3, of
  JAX and of the f64 run, for both packages.
* Checkpoints: the manifest of a train state of the same values equals
  JAX's (keys, shapes, dtypes, sha256 and treedef; bf16 leaves too), a
  JAX checkpoint restores in the port and a port checkpoint in JAX.
* ``launch.train --device cpu --reduced --chaos`` gives the uninterrupted
  run's losses exactly, and so do kills at fixed steps, after which the
  later attempts restore from the checkpoints.
* The flash autograd Function: ``gradcheck`` in f64 (under
  ``_all_f64``) with the plain forward and backward standing in for the
  kernels (gradients within 1e-12 of the plain autograd's); the
  bare kernel wrapper refuses inputs that require grad; ``remat_policy``
  changes neither the loss nor the gradients; the ssm and hybrid
  families train (``tests/test_torch_ssm_train.py`` holds them against
  JAX) and the families whose training waits refuse by ROADMAP item.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import ArtifactStore, TopicBus, WorkflowScheduler  # noqa: E402
from repro_torch.core.scheduler import RetryPolicy  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import all_f64 as _all_f64  # noqa: E402
from repro_torch.models.common import (flatten_tree, tree_leaves, tree_map,  # noqa: E402
                                       unflatten_tree)
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.train import AdamWConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train.optimizer import global_norm, make_optimizer  # noqa: E402
from repro_torch.train.step import _loss_and_grads  # noqa: E402

SHAPE = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             head_dim=32, d_ff=256)
CFG = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **SHAPE)
OPT = AdamWConfig(lr=6e-3, warmup_steps=5, decay_steps=5000,
                  weight_decay=0.0, moment_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small ops, which gain
    nothing from more, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data(batch=16, seq=64, seed=1):
    return SyntheticCorpus(DataConfig(vocab_size=CFG.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=seed))


def tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def fresh_state(seed=0):
    model = build_model(CFG, device="cpu")
    return model, init_train_state(model, seed, OPT)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# tests/test_train.py
# ---------------------------------------------------------------------------


def test_loss_decreases_within_150_steps():
    # no recompute: the loss and gradients do not depend on the policy
    # (test_remat_policy_changes_neither_loss_nor_grads), and it is the
    # slowest test here
    model = build_model(dataclasses.replace(CFG, remat_policy="none"),
                        device="cpu")
    state = init_train_state(model, 0, OPT)
    step = make_train_step(model, OPT, ga=1)
    corpus = data()
    losses = []
    for i in range(150):
        state, m = step(state, tensors(corpus.batch_at(i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_ga_equivalence():
    """ga=2 must produce (nearly) the same update as ga=1 on the same data."""
    model, s1 = fresh_state()
    s2 = tree_map(torch.clone, s1)
    batch = tensors(data(batch=8).batch_at(0))
    st1, _ = make_train_step(model, OPT, ga=1)(s1, batch)
    st2, _ = make_train_step(model, OPT, ga=2)(s2, batch)
    for a, b in zip(tree_leaves(st1["params"]), tree_leaves(st2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=5e-4)


def test_resume_determinism(tmp_path):
    """train(10) == train(5) -> ckpt -> restore -> train(5)."""
    from repro_torch.train.step import abstract_train_state

    model, sA = fresh_state()
    corpus = data(batch=4)
    step = make_train_step(model, OPT, ga=1)
    for i in range(10):
        sA, _ = step(sA, tensors(corpus.batch_at(i)))

    model, sB = fresh_state()
    for i in range(5):
        sB, _ = step(sB, tensors(corpus.batch_at(i)))
    ck = CheckpointManager(tmp_path)
    ck.save(5, sB)
    sB, _ = ck.restore(abstract_train_state(model, OPT))
    for i in range(5, 10):
        sB, _ = step(sB, tensors(corpus.batch_at(i)))

    for a, b in zip(tree_leaves(sA), tree_leaves(sB)):
        assert torch.equal(a, b)


def test_grad_clipping_caps_update():
    opt_init, opt_update = make_optimizer(
        AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0, weight_decay=0.0,
                    moment_dtype="float32"))
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    st = opt_init(params)
    newp, _, metrics = opt_update(grads, st, params, torch.tensor(0))
    assert float(metrics["grad_norm"]) == pytest.approx(400.0)
    assert (newp["w"] - 1.0).abs().max().item() < 1.1  # clipped step


def test_adamw_matches_reference_math():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      warmup_steps=0, decay_steps=10**9, moment_dtype="float32",
                      clip_norm=1e9)
    opt_init, opt_update = make_optimizer(cfg)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    st = opt_init(p)
    newp, newst, _ = opt_update(g, st, p, torch.tensor(0))
    m = 0.1 * np.asarray([0.5, 0.25])
    v = 0.01 * np.asarray([0.25, 0.0625])
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.99)
    want = np.asarray([1.0, -2.0]) - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-5)


def test_prefetch_loader_resumes():
    corpus = data(batch=2, seq=16)
    loader = PrefetchLoader(corpus, start_step=3, depth=2)
    step, batch = next(loader)
    assert step == 3
    np.testing.assert_array_equal(batch["tokens"], corpus.batch_at(3)["tokens"])
    step2, _ = next(loader)
    assert step2 == 4
    loader.close()


def test_data_deterministic_across_instances():
    c1, c2 = data(seed=9), data(seed=9)
    b1, b2 = c1.batch_at(17), c2.batch_at(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = data(seed=10).batch_at(17)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_data_equals_jax_pipeline():
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticCorpus as JCorpus

    dc = dict(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4, seed=3)
    a = SyntheticCorpus(DataConfig(**dc)).batch_at(11)
    b = JCorpus(JDataConfig(**dc)).batch_at(11)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def state_like():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones((4,))},
        "opt": {"m": {"w": torch.zeros((3, 4)), "b": torch.zeros((4,))}},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def abstract(tree):
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


def test_roundtrip(tmp_path):
    ck = CheckpointManager(tmp_path)
    s = state_like()
    ck.save(7, s, meta={"note": "hi"})
    got, meta = ck.restore(abstract(s))
    assert meta["note"] == "hi"
    for a, b in zip(tree_leaves(s), tree_leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_async_save(tmp_path):
    ck = CheckpointManager(tmp_path)
    s = state_like()
    ck.save(1, s, sync=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_sync_and_async_saves_write_the_same_files(tmp_path):
    """A sync save copies each leaf to the host in its writer thread, an
    async one snapshots first: the files and the manifest are the same."""
    s = state_like()
    s["params"]["h"] = torch.randn(5, 3).to(torch.bfloat16)
    sync, later = CheckpointManager(tmp_path / "a"), CheckpointManager(tmp_path / "b")
    sync.save(1, s)
    later.save(1, s, sync=False)
    later.wait()
    mf = [json.loads((ck._step_dir(1) / "MANIFEST.json").read_text())
          for ck in (sync, later)]
    assert mf[0] == mf[1]
    for e in mf[0]["leaves"]:
        assert ((sync._step_dir(1) / e["file"]).read_bytes()
                == (later._step_dir(1) / e["file"]).read_bytes())


@pytest.mark.parametrize("case", ["f32", "fortran", "strided", "scalar",
                                  "int64", "bool", "empty", "bf16"])
def test_npy_file_equals_np_save(case):
    """The header and data a checkpoint streams are the bytes ``np.save``
    writes (bf16: JAX's ``'<V2'`` header over the 16-bit patterns)."""
    import io

    from repro_torch.core.storage import npy_bytes, npy_parts

    rng = np.random.default_rng(3)
    arr = {"f32": rng.standard_normal((3, 4)).astype(np.float32),
           "fortran": np.asfortranarray(rng.standard_normal((3, 5))),
           "strided": rng.standard_normal((2, 3, 4))[:, ::2],
           "scalar": np.asarray(np.float32(2.5)),
           "int64": np.arange(10),
           "bool": np.array([True, False, True]),
           "empty": np.zeros((0, 3), np.float32),
           "bf16": None}[case]
    want = io.BytesIO()
    if arr is None:
        leaf = torch.randn(4, 6).to(torch.bfloat16)
        bits = leaf.view(torch.int16).numpy()
        np.lib.format.write_array_header_1_0(want, {
            "descr": "<V2", "fortran_order": False, "shape": bits.shape})
        want.write(bits.tobytes())
    else:
        leaf = arr
        np.save(want, arr)
    head, data = npy_parts(leaf)
    assert data.flags.c_contiguous
    assert head + data.tobytes() == npy_bytes(leaf) == want.getvalue()


def test_atomic_commit_crash_safety(tmp_path):
    """A .tmp dir from a crashed save must be invisible to restore."""
    ck = CheckpointManager(tmp_path)
    s = state_like()
    ck.save(1, s)
    tmp = tmp_path / "step_00000002.tmp"
    tmp.mkdir()
    (tmp / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 1
    got, _ = ck.restore(abstract(s))
    assert int(tree_leaves(got)[-1]) == 7  # step leaf intact


def test_integrity_detection(tmp_path):
    ck = CheckpointManager(tmp_path)
    s = state_like()
    ck.save(3, s)
    d = ck._step_dir(3)
    leaf = sorted(d.glob("leaf_*.npy"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="integrity"):
        ck.restore(abstract(s))


def test_gc_keeps_latest(tmp_path):
    ck = CheckpointManager(tmp_path, keep=2)
    s = state_like()
    for step in (1, 2, 3, 4):
        ck.save(step, s)
    assert ck.steps() == [3, 4]


def test_shape_mismatch_rejected(tmp_path):
    ck = CheckpointManager(tmp_path)
    s = state_like()
    ck.save(1, s)
    bad = abstract(s)
    bad["params"]["w"] = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="ckpt"):
        ck.restore(bad)


def test_restore_onto_a_mesh_gives_each_rank_its_slice(tmp_path):
    """``restore(shardings=...)`` over a mesh of two CPU ranks, run on
    this process as rank 0: each leaf is rank 0's slice (``ff`` split over
    ``model``), the replicated leaves whole."""
    from repro_torch.core.elastic import RescalePlan
    from repro_torch.launch.mesh import make_serving_mesh

    ck = CheckpointManager(tmp_path)
    s = state_like()
    ck.save(1, s)
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"])
    plan = RescalePlan(ELASTIC_AXES, mesh)
    got, _ = ck.restore(abstract(s), shardings=plan.new_shardings(abstract(s)))
    assert torch.equal(got["params"]["w"], s["params"]["w"][:, :2])
    assert torch.equal(got["opt"]["m"]["w"], s["opt"]["m"]["w"][:, :2])
    assert torch.equal(got["params"]["b"], s["params"]["b"])
    assert torch.equal(got["step"], s["step"])
    assert not mesh.started


ELASTIC_AXES = {
    "params": {"w": ("embed", "ff"), "b": (None,)},
    "opt": {"m": {"w": ("embed", "ff"), "b": (None,)}},
    "step": None,
}


def test_elastic_reshard_mesh_to_mesh(tmp_path):
    """Save, then restore under other meshes — the elastic-rescale
    primitive: a host mesh (one rank: every leaf whole), and two CPU ranks
    (this process and a spawned one), whose slices of ``w`` laid side by
    side are the saved tensor; ``apply`` back onto the host mesh gathers
    them over the two ranks."""
    from repro_torch.core.elastic import RescalePlan, rolling_phases
    from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh

    ck = CheckpointManager(tmp_path)
    s = state_like()
    ck.save(5, s)
    plan = RescalePlan(ELASTIC_AXES, make_host_mesh())
    got, _ = ck.restore(abstract(s), shardings=plan.new_shardings(abstract(s)))
    assert torch.equal(got["params"]["w"], s["params"]["w"])
    with make_serving_mesh(2, devices=["cpu", "cpu"],
                           init_dir=str(tmp_path)) as mesh:
        two = RescalePlan(ELASTIC_AXES, mesh)
        sh = two.new_shardings(abstract(s))
        ranks = mesh.group.spmd(ck.restore, [(abstract(s), None, sh)] * 2)
        w = [r["params"]["w"] for r, _ in ranks]
        assert [tuple(x.shape) for x in w] == [(3, 2), (3, 2)]
        assert torch.equal(torch.cat(w, dim=1), s["params"]["w"])
        assert all(torch.equal(r["step"], s["step"]) for r, _ in ranks)
        back = mesh.group.spmd(plan.apply, [(r, sh) for r, _ in ranks])
        assert all(torch.equal(b["params"]["w"], s["params"]["w"])
                   for b in back)
    # rolling phases follow maxUnavailable
    phases = list(rolling_phases(4, 2, max_unavailable=1))
    assert [p["phase"] for p in phases] == [
        "checkpoint_barrier", "drain", "drain", "reshard", "resume"]


# ---------------------------------------------------------------------------
# cross-package: the same state and data through both trainers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    from repro.train import AdamWConfig as JAdamW
    from repro.train import init_train_state as jinit

    jcfg = dataclasses.replace(jreduced(JARCHS["smollm-360m"]), **SHAPE)
    jopt = JAdamW(**dataclasses.asdict(OPT))
    model = jbuild(jcfg)
    return {"cfg": jcfg, "opt": jopt, "model": model,
            "init": lambda: jinit(model, jax.random.key(0), jopt)}


def carried(jstate):
    return train_state_from_jax(CFG, jax.tree.map(np.asarray, jstate))


def _f64(tree):
    return tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)


@pytest.fixture(scope="module")
def step1(jax_side):
    """Step-1 loss and gradients: JAX f32, the port f32, the port f64."""
    jm, jstate = jax_side["model"], jax_side["init"]()
    batch = data().batch_at(0)
    (jl, _), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    params = carried(jstate)["params"]
    l32, _, g32 = _loss_and_grads(build_model(CFG, device="cpu"), params,
                                  tensors(batch))
    with _all_f64():
        m64 = build_model(dataclasses.replace(CFG, dtype="float64"),
                          device="cpu")
        l64, _, g64 = _loss_and_grads(m64, _f64(params), tensors(batch))
    assert l64.dtype == torch.float64
    flat = lambda g: {k: np.asarray(v, np.float64)  # noqa: E731
                      for k, v in flatten_tree(g).items()}
    return {"loss": (float(jl), float(l32), float(l64)),
            "jax": flat(jax.tree.map(np.asarray, jg)), "port": flat(g32),
            "f64": flat(g64)}


def test_step1_loss_matches_jax(step1):
    jl, l32, l64 = step1["loss"]
    assert abs(l32 - jl) / abs(jl) <= 1e-5
    assert abs(jl - l64) / abs(l64) <= 1e-5


def test_step1_grads_match_jax(step1):
    """Leaf by leaf: the port within 5e-4 of JAX, and each package's f32
    gradient within 5e-4 of the all-f64 run (the f32 rounding level here:
    1.3e-4 to 1.9e-4)."""
    assert step1["port"].keys() == step1["jax"].keys() == step1["f64"].keys()
    for k in step1["jax"]:
        assert rel(step1["port"][k], step1["jax"][k]) <= 5e-4, k
        assert rel(step1["port"][k], step1["f64"][k]) <= 5e-4, k
        assert rel(step1["jax"][k], step1["f64"][k]) <= 5e-4, k


@pytest.mark.parametrize("step,wd", [(0, 0.0), (7, 0.1)])
def test_optimizer_update_matches_jax(jax_side, step1, step, wd):
    """The same gradients (JAX's step-1 ones), moments and parameters
    through both optimizers, clipping active: new parameters within 1e-6,
    moments, grad_norm and lr alike."""
    from repro.train.optimizer import make_optimizer as jmake

    kw = dict(dataclasses.asdict(OPT), weight_decay=wd, clip_norm=0.05)
    jstate = jax_side["init"]()
    grads = jax.tree.map(jnp.asarray, jax.tree.map(
        np.asarray, jax.tree.unflatten(
            jax.tree.structure(jstate["params"]),
            [step1["jax"][k].astype(np.float32) for k in sorted(step1["jax"])])))
    jinit_, jupd = jmake(type(jax_side["opt"])(**kw))
    opt = jinit_(jstate["params"])
    opt = {"m": jax.tree.map(lambda x: x + 0.01, opt["m"]),
           "v": jax.tree.map(lambda x: x + 0.001, opt["v"])}
    jp, jo, jmet = jupd(grads, opt, jstate["params"], jnp.asarray(step))

    st = carried({"params": jstate["params"], "opt": opt, "step": step})
    tg = carried({"params": grads, "opt": opt, "step": 0})["params"]
    _, tupd = make_optimizer(AdamWConfig(**kw))
    tp, to, tmet = tupd(tg, st["opt"], st["params"], st["step"])
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        want = flatten_tree(jax.tree.map(np.asarray, want))
        for k, v in flatten_tree(got).items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-7)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                     rel=1e-6)


@pytest.mark.parametrize("ga", [1, 2])
def test_five_step_losses_match_jax(jax_side, ga):
    from repro.train import make_train_step as jmake_step

    corpus = data()
    jstate = jax_side["init"]()
    jstep = jax.jit(jmake_step(jax_side["model"], jax_side["opt"], ga=ga))
    jl = []
    for i in range(5):
        jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in corpus.batch_at(i).items()})
        jl.append(float(m["loss"]))

    def port(dtype):
        cfg = dataclasses.replace(CFG, dtype=dtype)
        state = carried(jax_side["init"]())
        if dtype == "float64":
            state = _f64(state)
        step = make_train_step(build_model(cfg, device="cpu"),
                               dataclasses.replace(OPT, moment_dtype=dtype),
                               ga=ga)
        out = []
        for i in range(5):
            state, m = step(state, tensors(corpus.batch_at(i)))
            out.append(float(m["loss"]))
        return np.array(out)

    p32 = port("float32")
    with _all_f64():
        p64 = port("float64")
    r = lambda a, b: np.abs(np.asarray(a) - b) / np.abs(b)  # noqa: E731
    assert (r(p32, jl)[:2] <= 1e-5).all(), r(p32, jl)
    for gap in (r(p32, jl), r(p32, p64), r(jl, p64)):
        assert (gap <= 5e-3).all(), gap


def _manifest(ck, step):
    return json.loads((ck._step_dir(step) / "MANIFEST.json").read_text())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_manifest_equals_jax(jax_side, tmp_path, dtype):
    """The same train state saved by both packages: the same manifest
    (keys, files, shapes, dtypes, sha256, treedef, meta), and each
    package restores the other's checkpoint."""
    from repro.checkpoint import CheckpointManager as JCheckpointManager

    jstate = jax_side["init"]()
    if dtype == "bfloat16":
        jstate["params"] = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                        jstate["params"])
    state = carried(jstate)
    jck, ck = JCheckpointManager(tmp_path / "jax"), CheckpointManager(tmp_path / "port")
    jck.save(3, jstate, meta={"losses": [5.5, 5.25]})
    ck.save(3, state, meta={"losses": [5.5, 5.25]})
    assert _manifest(ck, 3) == _manifest(jck, 3)
    for f in sorted(ck._step_dir(3).glob("leaf_*.npy")):
        assert f.read_bytes() == (jck._step_dir(3) / f.name).read_bytes()

    # JAX -> port
    got, meta = CheckpointManager(tmp_path / "jax").restore(abstract(state))
    assert meta == {"losses": [5.5, 5.25]}
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if dtype == "bfloat16":
        return  # JAX's own restore has no V2 -> bfloat16 cast (its limit)
    # port -> JAX
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    jgot, _ = JCheckpointManager(tmp_path / "port").restore(like)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the driver: chaos replay
# ---------------------------------------------------------------------------


def _train_args(workdir, *extra):
    from repro_torch.launch import train as launch

    return launch.parse_args(["--reduced", "--device", "cpu", "--steps", "30",
                              "--workdir", str(workdir), *extra])


@pytest.fixture(scope="module")
def calm_run(tmp_path_factory):
    """``launch.train --reduced --device cpu`` for 30 steps, uninterrupted."""
    from repro_torch.launch import train as launch

    arts, _, _ = launch.run(_train_args(tmp_path_factory.mktemp("calm")))
    assert arts["report"]["improved"]
    return arts


def test_launch_train_chaos_replays_exactly(calm_run, tmp_path):
    """``--chaos`` (the train pod killed on a wall-clock timer, as the
    driver does) changes no loss."""
    from repro_torch.launch import train as launch

    arts, sched, _ = launch.run(_train_args(tmp_path, "--chaos"))
    kinds = [e["kind"] for e in sched.events.history()]
    assert kinds.count("step_retry_scheduled") >= 1
    assert arts["losses"] == calm_run["losses"]
    assert arts["report"] == calm_run["report"]


def test_train_resumes_from_checkpoints_exactly(calm_run, tmp_path):
    """Kills at fixed steps (attempt 1 after step 12, attempt 2 after step
    25): the later attempts restore from steps 10 and 20 and the losses
    equal the uninterrupted run's, bit for bit."""
    from repro_torch.core.executor import PodKilled
    from repro_torch.launch.train import build_workflow

    args = _train_args(tmp_path)
    stats = {}
    graph = build_workflow(args, tmp_path, stats=stats)
    train_fn = graph.steps["train"].fn

    def killed_at_step(inputs, ctx):
        stop = {1: 12, 2: 25}.get(ctx.attempt)
        beat = ctx.beat

        def beat_or_die(progress=0, **info):
            beat(progress=progress, **info)
            if progress == stop:
                raise PodKilled(f"killed after step {stop}")

        ctx.beat = beat_or_die
        return train_fn(inputs, ctx)

    graph.steps["train"].fn = killed_at_step
    store = ArtifactStore(tmp_path / "store")
    sched = WorkflowScheduler(
        graph, TopicBus(tmp_path / "bus"), store,
        retry=RetryPolicy(max_attempts=6, backoff_s=0.01),
        claim_paths={"train": str(store.claim("ckpt").path)}, device="cpu")
    arts = sched.run(timeout_s=600)
    assert [(a["start_step"], len(a["step_s"])) for a in stats["attempts"]] \
        == [(0, 12), (10, 15), (20, 10)]
    assert all(a["restore_bytes"] > 0 for a in stats["attempts"][1:])
    assert arts["losses"] == calm_run["losses"]


# ---------------------------------------------------------------------------
# the flash kernel under autograd, remat, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,causal", [(8, 8, True), (4, 8, True),
                                           (8, 8, False)])
def test_flash_function_gradcheck(sq, skv, causal):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, sq, 4, 4, generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn(1, skv, 2, 4, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    fn = lambda q, k, v: ops.FlashAttentionFunction.apply(  # noqa: E731
        q, k, v, causal, None, *ops.flash_plain(4))
    with _all_f64():  # the plain versions compute in f32 otherwise
        assert torch.autograd.gradcheck(fn, (q, k, v))
        # the plain forward's values, and its autograd's gradients to f64
        # rounding: the backward runs the formulas (P from the saved
        # logsumexp, dS = P (dP - rowsum(dO o))), not the forward's ops
        # differentiated, so the sums are taken in another order
        out = fn(q, k, v)
        want = ref.flash_attention_chunked(q, k, v, causal=causal,
                                           chunk_kv=4)
        assert torch.equal(out, want)
        go = torch.randn_like(out)
        for a, b in zip(torch.autograd.grad(out, (q, k, v), go),
                        torch.autograd.grad(want, (q, k, v), go)):
            assert (a - b).abs().max() <= 1e-12 * b.abs().max()


def test_kernel_wrapper_refuses_inputs_that_require_grad():
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    k = torch.randn(1, 1, 8, 64)
    with pytest.raises(RuntimeError, match="gives no gradient"):
        flash_attention_bhsd(q, k, k)
    with torch.no_grad():  # no gradient asked: on to the device check
        with pytest.raises(ValueError, match="CUDA tensor"):
            flash_attention_bhsd(q, k, k)


def test_remat_policy_changes_neither_loss_nor_grads():
    batch = tensors(data(batch=4, seq=32).batch_at(0))
    model, state = fresh_state()
    base = _loss_and_grads(model, state["params"], batch)
    for policy in ("nothing", "full", "dots", "names", "group2", "group8names"):
        m = build_model(dataclasses.replace(CFG, remat_policy=policy),
                        device="cpu")
        loss, _, grads = _loss_and_grads(m, state["params"], batch)
        assert torch.equal(loss, base[0]), policy
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(grads), tree_leaves(base[2]))), policy
    m = build_model(dataclasses.replace(CFG, remat_policy="sometimes"),
                    device="cpu")
    with pytest.raises(ValueError, match="remat policy"):
        _loss_and_grads(m, state["params"], batch)


def test_train_state_is_the_model():
    model, state = fresh_state()
    assert set(state) == {"params", "opt", "step"}
    assert set(state["opt"]) == {"m", "v"}
    assert state["step"].dtype == torch.int32 and state["step"].item() == 0
    assert (state["params"]["layers"]["attn"]["wq"].data_ptr()
            == model.layers.attn.wq.data_ptr())
    assert global_norm(state["opt"]["m"]).item() == 0.0


@pytest.mark.parametrize("family,item", [("ssm", "A.11"), ("hybrid", "A.11"),
                                         ("moe", "A.7"), ("vlm", "A.7")])
def test_unported_families_refuse_to_train(family, item):
    """ssm and hybrid training (ROADMAP A.11, the SSD scan under autograd)
    and moe and vlm training (A.7) are ported: one step of each trains and
    gives a finite gradient to every leaf (the moe router's and the vlm
    ``vision_proj``'s included); moe reports its router's aux loss."""
    arch = {"ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b", "moe": "dbrx-132b",
            "vlm": "internvl2-26b"}[family]
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg, device="cpu")
    params = unflatten_tree(model.init(seed=0))
    batch = tensors(SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2, seed=1,
        vision_tokens=cfg.num_frontend_tokens, d_model=cfg.d_model,
        dtype=cfg.dtype)).batch_at(0))
    assert ("vision_embeds" in batch) == (family == "vlm")
    loss, metrics, grads = _loss_and_grads(model, params, batch)
    assert torch.isfinite(loss)
    assert (metrics["aux"] > 0) == (family == "moe")
    assert flatten_tree(grads).keys() == flatten_tree(params).keys()
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0
               for g in flatten_tree(grads).values())
