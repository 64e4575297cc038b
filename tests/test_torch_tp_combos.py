"""Tensor-parallel serving combined with the KV tiers, the draft-model
proposer, the supervised fleet, moe and vlm, on the CPU: two CPU ranks
over gloo (this process and one spawned follower, one mesh for the
module). Reduced configs in f32; weights from the JAX package's init
(``params_from_jax``), prompts from numpy seeds.

* the tier mechanism, bit for bit: seeded head slices written into each
  rank's pool spill as their concatenation on the head axis (f32, bf16 as
  16-bit patterns, int8 with its f32 scales) and reload into each rank's
  own heads, also when a copy-on-write copy of the page was queued and not
  yet replayed on the follower; ``spill_bytes`` equals a tp-1 cache's and
  the JAX package's on the same trace;
* token streams at tp 2 against JAX's own 2-device engine (a subprocess
  with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``): the host
  and persisted tiers and a restart on the same store (``persist_hits``
  >= 1; the persisted content keys equal tp 1's and JAX's), the draft
  proposer (streams and spec counters; the streams equal spec off, and no
  collective fires inside a draft forward), reduced dbrx-132b (paged,
  fused) and internvl2-26b (paged, whole-prompt);
* the supervised fleet on the mesh: two workers, one killed, every stream
  the oracle's (``test_torch_fleet.py``'s checks), no executor left on the
  follower; ``launch.serve --mesh 2 --fleet 2`` and the flat pool's
  workers at ``--mesh 2``.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.faults import FaultInjector, WorkerKillRule  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.parallel.collectives import (tensor_parallel,  # noqa: E402
                                              tp_axis)
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 KVTierManager, PagedKVCache, Request,
                                 SamplingParams)
from repro_torch.serving.executor import serving_mesh_scope  # noqa: E402
from test_torch_fleet import (_assert_recovered, _make_sup,  # noqa: E402
                              _oracle)
from test_torch_fleet import _trace as _fleet_trace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# the JAX init seed of each config
SEEDS = {"smollm-360m": 0, "dbrx-132b": 0, "internvl2-26b": 0}
DRAFT_LAYERS = 1
INDEX = "kv_prefix_index.json"


@pytest.fixture(scope="module")
def mesh2(tmp_path_factory):
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"],
                             init_dir=str(tmp_path_factory.mktemp("tp")))
    mesh.group  # spawn the follower once for the module
    yield mesh
    mesh.close()


# ---------------------------------------------------------------------------
# traces and weights
# ---------------------------------------------------------------------------


def _tier_trace(vocab):
    """A shared 24-token prefix (three pages of 8) on half of 6 requests,
    unique tails, greedy and seeded top-p alternating."""
    rng = np.random.default_rng(7)
    shared = [int(t) for t in rng.integers(1, vocab, 24)]
    out = []
    for i in range(6):
        tail = [int(t) for t in rng.integers(1, vocab, rng.integers(4, 12))]
        kw = dict(max_new_tokens=6, seed=20 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"p{i}", (shared if i % 2 == 0 else []) + tail, kw))
    return out


def _spec_trace(vocab):
    """Prompts ending in a repeated motif and prompts that do not; greedy
    and seeded top-k/top-p alternating (``test_torch_speculative.py``'s)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(6):
        motif = rng.integers(1, vocab, int(rng.integers(2, 5))).tolist()
        head = rng.integers(1, vocab, int(rng.integers(2, 12))).tolist()
        prompt = head + motif * 3 if i % 3 else head + motif
        kw = dict(max_new_tokens=int(rng.integers(6, 12)), seed=20 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"r{i}", prompt, kw))
    return out


def _mixed_trace(vocab):
    """6 requests of 3-30 tokens, 8 new; greedy and seeded top-k/top-p."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        prompt = rng.integers(1, vocab, int(rng.integers(3, 31))).tolist()
        kw = dict(max_new_tokens=8, seed=10 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"m{i}", prompt, kw))
    return out


PAGED = dict(max_len=64, max_slots=3, page_size=8, prefill_chunk=8)
# name -> (arch, engine kwargs, trace, extra: "persist" runs twice on one
# store; "draft_layers" drafts with the target's first layers)
SCENARIOS = {
    "tiers": ("smollm-360m", dict(PAGED, num_pages=12, host_pages=4),
              _tier_trace(256), {"persist": True}),
    "draft": ("smollm-360m", dict(PAGED, speculative="draft", spec_k=3),
              _spec_trace(256), {"draft_layers": DRAFT_LAYERS}),
    "moe": ("dbrx-132b", PAGED, _mixed_trace(256), {}),
    "vlm": ("internvl2-26b", dict(PAGED, prefill_chunk=None),
            _mixed_trace(256), {}),
}

# runs in a subprocess: JAX with two forced host devices
_JAX_SCRIPT = r"""
import dataclasses, json, os, sys, tempfile
import jax
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_serving_mesh
from repro.models import build_model
from repro.serving import ContinuousBatchingEngine, Request, SamplingParams
from repro.serving.executor import serving_mesh_scope

job = json.load(sys.stdin)
out = {}
for name, (arch, kw, reqs, extra) in job["runs"].items():
    cfg = reduced(ARCHS[arch])
    params = build_model(cfg).init(jax.random.key(job["seeds"][arch]))
    kw = dict(kw)
    n = extra.get("draft_layers")
    if n:
        kw["draft_config"] = dataclasses.replace(cfg, num_layers=n)
        kw["draft_params"] = dict(params, layers=jax.tree.map(
            lambda a: a[:n], params["layers"]))
    store = tempfile.TemporaryDirectory() if extra.get("persist") else None
    if store is not None:
        kw["persist_dir"] = store.name
    runs = []
    for _ in range(2 if extra.get("persist") else 1):
        with serving_mesh_scope(make_serving_mesh(2)):
            eng = ContinuousBatchingEngine(cfg, params, **kw)
        hs = [eng.submit(Request(u, p, sampling=SamplingParams(**s)))
              for u, p, s in reqs]
        while not eng.idle:
            eng.step()
        u = eng.utilization
        run = {"tp": eng.executor.tp,
               "streams": [list(map(int, h.tokens)) for h in hs],
               "spec": [eng.stats["spec_bundles"], u.spec_proposed,
                        u.spec_accepted, u.spec_rollbacks]}
        if "persist_dir" in kw:
            eng.cache.flush_tiers()
            run["tiers"] = {k: int(v) for k, v in
                            eng.cache.tiers.counters.items()
                            if not k.endswith("_s")}
        runs.append(run)
    keys = None
    if store is not None:
        with open(os.path.join(store.name, "kv_prefix_index.json")) as f:
            keys = sorted(json.load(f))
        store.cleanup()
    out[name] = {"runs": runs, "keys": keys}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_streams():
    """Every scenario through JAX's 2-device engine: two subprocesses
    (smollm's tiers and draft; moe and vlm) started before the module's
    first test, so the port's runs overlap their compiles."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(REPO / "src"))
    procs = []
    for part in (("tiers", "draft"), ("moe", "vlm")):
        with tempfile.TemporaryFile("w+") as job:
            json.dump({"runs": {k: SCENARIOS[k] for k in part},
                       "seeds": SEEDS}, job)
            job.seek(0)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_SCRIPT], env=env, stdin=job,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = {}

    def get():
        for proc in procs if not done else ():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            done.update(json.loads(out.strip().splitlines()[-1]))
        return done

    yield get
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


_TREES: dict = {}


def _jax_tree(arch):
    """The JAX init of ``arch``'s reduced config (the seed of SEEDS), as a
    numpy tree."""
    if arch not in _TREES:
        import jax

        from repro.configs import ARCHS as JARCHS, reduced as jreduced
        from repro.models import build_model as jbuild

        p = jbuild(jreduced(JARCHS[arch])).init(jax.random.key(SEEDS[arch]))
        _TREES[arch] = jax.tree.map(np.asarray, p)
    return _TREES[arch]


def _params(arch, layers=None):
    """The port's state dict of ``_jax_tree(arch)``, cut to its first
    ``layers`` layers when given (the draft)."""
    cfg = reduced(ARCHS[arch])
    tree = _jax_tree(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        tree = dict(tree, layers={k: _cut(v, layers)
                                  for k, v in tree["layers"].items()})
    return cfg, params_from_jax(cfg, tree)


def _cut(tree, n):
    if isinstance(tree, dict):
        return {k: _cut(v, n) for k, v in tree.items()}
    return tree[:n]


def _serve(eng, reqs):
    hs = [eng.submit(Request(u, p, sampling=SamplingParams(**s)))
          for u, p, s in reqs]
    while not eng.idle:
        eng.step()
    return [list(h.tokens) for h in hs]


@contextlib.contextmanager
def _engine(mesh, cfg, params, **kw):
    """An engine on ``mesh`` (None: one CPU rank), closed on the way out
    (its executor dropped on every follower)."""
    scope = mesh if mesh is not None else make_serving_mesh(1,
                                                           devices=["cpu"])
    with serving_mesh_scope(scope):
        eng = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    try:
        yield eng
    finally:
        eng.close()


def test_tensor_parallel_context_is_thread_local(mesh2):
    """A thread never sees another thread's ``tensor_parallel`` context:
    fleet workers on one mesh, and the draft model in the engine's thread,
    stay outside every call's collectives."""
    seen = []
    with tensor_parallel(mesh2.group.comm):
        assert tp_axis() == "model"
        t = threading.Thread(target=lambda: seen.append(tp_axis()))
        t.start()
        t.join()
    assert seen == [None] and tp_axis() is None


# ---------------------------------------------------------------------------
# the tier mechanism: whole pages from the ranks' head slices
# ---------------------------------------------------------------------------

DTYPES = {"f32": ("float32", "none"), "bf16": ("bfloat16", "none"),
          "int8": ("float32", "int8")}


def _tier_engine(mesh, dtype, quant, **kw):
    cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), dtype=dtype)
    return _engine(mesh, cfg, _params("smollm-360m")[1], max_len=64,
                   max_slots=3, page_size=8, num_pages=8, kv_quant=quant,
                   **kw)


def _whole_page(cache, tp, seed):
    """Seeded host blocks of one whole page (every rank's heads on axis 2),
    in the pool's own widths: f32, bf16 as int16 bits, int8 with f32
    scales."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, arr in cache.pages.items():
        shape = list(arr[:, 0].shape)
        shape[2] *= tp
        if arr.dtype == torch.int8:
            out[key] = rng.integers(-127, 128, shape).astype(np.int8)
        elif arr.dtype == torch.bfloat16:
            vals = torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).to(torch.bfloat16)
            out[key] = vals.view(torch.int16).numpy()
        else:
            out[key] = (rng.standard_normal(shape) * 40).astype(np.float32)
    return out


def _heads(block, rank, tp):
    n = block.shape[2] // tp
    return block[:, :, rank * n:(rank + 1) * n]


def _assert_blocks_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_spill_is_the_ranks_heads_and_reload_gives_each_its_own(mesh2, kind):
    """Each rank's pool holds seeded head slices of a prefix page; the
    spill (``reclaim_parked``) puts their concatenation in the host tier,
    bit for bit; a reload into another page gives each rank its own slice
    back. Then the same through a page copied on write whose copy was
    queued, not yet replayed on the follower, when it spilled."""
    dtype, quant = DTYPES[kind]
    with _tier_engine(mesh2, dtype, quant, host_pages=8) as eng:
        cache, ex = eng.cache, eng.executor
        tiers = cache.tiers
        toks = list(range(50, 66))  # two full pages
        slot, _ = cache.admit(len(toks), toks)
        cache.register_prefix(slot, toks, len(toks))
        chain = cache._slot_pages[slot][:2]
        want = {p: _whole_page(cache, 2, seed=i) for i, p in
                enumerate(chain)}
        for p in chain:
            ex.on_every_rank("write_page", p, want[p])
        cache.release(slot)  # both pages park
        assert cache.reclaim_parked(2) == 2
        assert tiers.counters["spilled_pages"] == 2
        spilled = list(tiers.host.values())
        for p, got in zip(chain, spilled):
            _assert_blocks_equal(got, want[p])
        # reload into a fresh page: each rank its own heads
        (q,) = cache.pool.alloc(1)
        cache._upload_page(q, spilled[0])
        for rank, got in enumerate(ex.on_every_rank("read_pages", [q])):
            _assert_blocks_equal(got[0], {k: _heads(v, rank, 2) for k, v in
                                          want[chain[0]].items()})
        cache.pool.free([q])

        # copy-on-write queued and spilled before the next call
        a, _ = cache.admit(5)
        (x,) = cache._slot_pages[a]
        full = _whole_page(cache, 2, seed=9)
        ex.on_every_rank("write_page", x, full)
        b = cache.fork(a)
        cache.ensure_append_capacity(b, 3)  # positions 5..7: copy x -> y
        (y,) = cache._slot_pages[b]
        assert y != x and ex._ops == [("copy_page", x, y)]
        toks8 = list(range(80, 88))
        cache.lengths[b] = 8
        cache.register_prefix(b, toks8, 8)
        cache.release(b)  # y parks
        assert cache.reclaim_parked(1) == 1
        _assert_blocks_equal(next(reversed(tiers.host.values())), full)
        assert not ex._ops  # the read carried the copy to the follower
        cache.release(a)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_spill_bytes_at_tp2_equal_tp1_and_jax(mesh2, kind):
    """``test_torch_kv_tiers.py::test_spill_bytes_equal_jax``'s trace
    through a tp-2 engine's cache, a tp-1 cache of every head and the JAX
    package's: the same bytes spilled, page for page in the same widths."""
    import jax.numpy as jnp

    from repro.serving import KVTierManager as JTierManager
    from repro.serving import PagedKVCache as JPagedKVCache

    dtype, quant = DTYPES[kind]

    def run(cache, tiers):
        toks = list(range(50, 75))
        slot, _ = cache.admit(len(toks), toks)
        cache.register_prefix(slot, toks, len(toks))
        cache.release(slot)
        cache.release(cache.admit(41, list(range(300, 341)))[0])
        assert tiers.counters["spilled_pages"] == 3
        return tiers.counters["spill_bytes"], {
            k: (a.dtype, a.shape) for k, a in next(iter(
                tiers.host.values())).items()}

    with _tier_engine(mesh2, dtype, quant, host_pages=8) as eng:
        got = run(eng.cache, eng.cache.tiers)
    cfg = reduced(ARCHS["smollm-360m"])
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.eff_kv_heads,
              head_dim=cfg.head_dim, max_slots=3, max_context=64,
              page_size=8, num_pages=8, quant=quant)
    t1 = KVTierManager(host_pages=8)
    one = run(PagedKVCache(dtype=getattr(torch, dtype), tiers=t1,
                           device="cpu", **kw), t1)
    tj = JTierManager(host_pages=8)
    jax_ = run(JPagedKVCache(dtype=jnp.dtype(dtype), tiers=tj, **kw), tj)
    assert got == one
    assert got[0] == jax_[0]
    assert {k: s for k, (_, s) in got[1].items()} == \
        {k: s for k, (_, s) in jax_[1].items()}


# ---------------------------------------------------------------------------
# streams against JAX's 2-device engine
# ---------------------------------------------------------------------------


def test_tiers_and_restart_equal_jax(mesh2, jax_streams, tmp_path):
    """Host and persisted tiers at tp 2 under pool pressure, flushed, then a
    restart on the same store: both runs' streams and tier counters equal
    JAX's 2-device engine's, the restart reloads from the store, and the
    persisted content keys equal a tp-1 run's and JAX's."""
    arch, kw, reqs, _ = SCENARIOS["tiers"]
    cfg, params = _params(arch)
    ref = jax_streams()["tiers"]
    keys = {}
    for tp, mesh in ((2, mesh2), (1, None)):
        store = tmp_path / f"tp{tp}"
        for run in ref["runs"]:
            with _engine(mesh, cfg, params, persist_dir=str(store),
                         **kw) as eng:
                assert eng.executor.tp == tp and run["tp"] == 2
                assert _serve(eng, reqs) == run["streams"]
                eng.cache.flush_tiers()
                got = {k: int(v) for k, v in eng.cache.tiers.counters.items()
                       if not k.endswith("_s")}
                assert got == run["tiers"]
        keys[tp] = sorted(json.loads((store / INDEX).read_text()))
    assert ref["runs"][1]["tiers"]["persist_hits"] >= 1
    assert ref["runs"][0]["tiers"]["spilled_pages"] >= 1
    assert keys[2] == keys[1] == ref["keys"] and keys[2]


def test_draft_proposer_equals_jax_and_spec_off(mesh2, jax_streams):
    """The draft model (the target's first layer, whole on rank 0) at tp 2:
    streams and speculation counters equal JAX's 2-device engine with the
    same draft weights; the streams equal tp 2 without speculation; no
    collective runs inside a draft forward."""
    arch, kw, reqs, extra = SCENARIOS["draft"]
    cfg, params = _params(arch)
    dcfg, dparams = _params(arch, extra["draft_layers"])
    ref = jax_streams()["draft"]["runs"][0]
    comm = mesh2.group.comm
    fired = []
    with _engine(mesh2, cfg, params, draft_config=dcfg, draft_params=dparams,
                 **kw) as eng:
        assert eng.executor.tp == 2 and eng.spec.model.device.type == "cpu"
        assert eng.spec.cfg.num_layers == DRAFT_LAYERS
        propose = eng.spec.propose

        def counted(uid, history, k):
            before = comm.stats["collectives"]
            out = propose(uid, history, k)
            fired.append(comm.stats["collectives"] - before)
            return out

        eng.spec.propose = counted
        got = _serve(eng, reqs)
        u = eng.utilization
        counters = [eng.stats["spec_bundles"], u.spec_proposed,
                    u.spec_accepted, u.spec_rollbacks]
    assert fired and not any(fired), fired
    assert got == ref["streams"]
    assert counters == ref["spec"]
    assert counters[0] > 0 and counters[2] > 0
    off = {k: v for k, v in kw.items() if k not in ("speculative", "spec_k")}
    with _engine(mesh2, cfg, params, **off) as eng:
        assert _serve(eng, reqs) == got
    with pytest.raises(ValueError, match="whole"):
        from repro_torch.serving.executor import place_serving_params

        ContinuousBatchingEngine(cfg, params, device="cpu", **dict(
            kw, draft_config=dcfg,
            draft_params=place_serving_params(dcfg, dparams, mesh2)))


@pytest.mark.parametrize("name", ["moe", "vlm"])
def test_moe_and_vlm_at_tp2_equal_jax(mesh2, jax_streams, name):
    """Reduced dbrx-132b through the fused paged engine and reduced
    internvl2-26b prefilled whole (after its zero vision positions): the
    tp-2 streams equal JAX's 2-device engine's."""
    arch, kw, reqs, _ = SCENARIOS[name]
    cfg, params = _params(arch)
    with _engine(mesh2, cfg, params, **kw) as eng:
        assert eng.executor.tp == 2
        assert eng.executor.vocab_sharded == (not cfg.tie_embeddings)
        got = _serve(eng, reqs)
        if name == "vlm":
            assert eng.stats["prefills"] == len(reqs)
            assert eng.stats["prefill_chunks"] == 0
    ref = jax_streams()[name]["runs"][0]
    assert ref["tp"] == 2
    assert got == ref["streams"]


# ---------------------------------------------------------------------------
# the fleet and the serve driver on a mesh
# ---------------------------------------------------------------------------


def test_fleet_on_a_mesh_recovers_and_leaves_no_executor(mesh2, tmp_path):
    """Two fleet workers, threads sharing the mesh; the first to finish an
    engine step dies. Every stream equals the unperturbed oracle's, and
    after shutdown the follower holds no executor of any attempt."""
    cfg = reduced(ARCHS["smollm-360m"])
    params = build_model(cfg, device="cpu").init(seed=0)
    payloads = _fleet_trace(0)
    oracle = _oracle(cfg, params, payloads)  # one rank, unperturbed
    injector = FaultInjector(
        worker_rules=[WorkerKillRule(after_steps=1, times=1)])
    before = mesh2.group.held()
    with serving_mesh_scope(mesh2):
        sup = _make_sup(tmp_path, cfg, params, injector)
        try:
            for p in payloads:
                sup.submit(p)
            assert sup.run(expected=[p["uid"] for p in payloads],
                           timeout_s=180)
        finally:
            sup.shutdown()
    assert injector.kills_armed() == 1
    assert sup.metrics.crashes >= 1 and sup.metrics.resubmitted >= 1
    _assert_recovered(sup, oracle)
    assert mesh2.group.held() == before


def _serve_cli(tmp_path, *argv):
    from repro_torch.launch import serve

    out, saved = io.StringIO(), sys.argv
    sys.argv = ["serve", "--reduced", "--device", "cpu", "--max-new", "4",
                "--workdir", str(tmp_path / "w"), *argv]
    try:
        with contextlib.redirect_stdout(out):
            assert serve.main() == 0
    finally:
        sys.argv = saved
    return out.getvalue()


def test_serve_driver_fleet_and_flat_pool_on_a_mesh(tmp_path):
    """``--mesh 2 --fleet 2`` serves every request on two ranks; the flat
    pool at ``--mesh 2`` runs more than one worker on a trace that lags
    (24 requests against 8 a worker) and serves every request."""
    import multiprocessing

    before = set(multiprocessing.active_children())
    out = _serve_cli(tmp_path / "f", "--mesh", "2", "--fleet", "2",
                     "--requests", "6")
    assert "fleet served 6/6" in out and "mesh=model=2" in out
    out = _serve_cli(tmp_path / "p", "--mesh", "2", "--requests", "24")
    assert "served 24/24" in out and "mesh=model=2" in out
    peak = int(out.split("peak workers=")[1].split()[0])
    assert peak > 1, out
    assert set(multiprocessing.active_children()) == before
