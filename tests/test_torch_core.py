"""The port's notebook→DAG layer (``repro_torch.core``), on the CPU.

* Ports of ``tests/test_core_notebook.py`` (AST dataflow extraction and
  piped-section splitting), ``tests/test_capsule.py`` (capsule ids and
  drift; the platform records torch, its CUDA version, the backend the
  caller resolved and the CUDA device count), ``tests/test_scheduler.py``
  (retries, replicas, liveness, hedging, chaos recovery, the deployer's
  Listing-1 YAML, and the serving ``StepPlan`` over the port's page pool)
  and the notebook→k8s and chaos-training cases of
  ``tests/test_system.py``, run against ``repro_torch``.
* Cross-package: on the same notebooks ``split_pipeline`` gives the JAX
  package's steps, edges and ``to_dot()``, the rendered Deployment and
  PV/PVC YAML is byte-equal, and the scheduled pipeline's ``report``
  equals JAX's.
* ``RescalePlan`` (ROADMAP A.10: its shardings over a host mesh, and
  ``apply`` cutting a state into this rank's slices), and the pod repair
  of ROADMAP C.7: a killed or crashed attempt keeps none of its tensors
  alive once its thread has ended.
"""

import argparse
import dataclasses
import gc
import threading
import time
import weakref

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    ArtifactStore,
    Notebook,
    TopicBus,
    WorkflowScheduler,
    split_pipeline,
)
from repro_torch.core.capsule import Capsule, capture, seal_step  # noqa: E402
from repro_torch.core.dag import Step, StepGraph, build_cell_dag  # noqa: E402
from repro_torch.core.deployer import DynamicPodDeployer, PodManager  # noqa: E402
from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.core.executor import PodKilled, WorkerPod  # noqa: E402
from repro_torch.core.faults import FaultInjector, KillRule  # noqa: E402
from repro_torch.core.notebook import Cell, extract_usage  # noqa: E402
from repro_torch.core.scheduler import RetryPolicy  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small ops, which gain
    nothing from more, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the notebook of tests/test_system.py
SCI_NOTEBOOK = [
    "import math\nraw = [i * 0.5 for i in range(200)]",
    "clean = [v for v in raw if v % 7 != 0]",
    "# %%pipe\nstats = (sum(clean), len(clean))",
    "norm = [v / stats[0] for v in clean]",
    "report = ('mean', stats[0] / stats[1])",
]

# the notebook of examples/notebook_to_pipeline.py
ANALYSIS_NOTEBOOK = [
    "import math\n"
    "samples = [math.sin(i / 7.0) + 0.1 * ((i * 2654435761) % 97 / 97.0)\n"
    "           for i in range(2000)]",
    "cleaned = [s for s in samples if abs(s) < 1.05]",
    "# %%pipe\n"
    "n = len(cleaned)\n"
    "mean = sum(cleaned) / n",
    "var = sum((s - mean) ** 2 for s in cleaned) / n\n"
    "std = math.sqrt(var)",
    "# %%pipe\n"
    "zscores = [(s - mean) / std for s in cleaned]",
    "outliers = [z for z in zscores if abs(z) > 2.0]\n"
    "report = {'n': n, 'mean': round(mean, 4), 'std': round(std, 4),\n"
    "          'outliers': len(outliers)}",
]

FANOUT_NOTEBOOK = [
    "base = list(range(10))",
    "evens = [v for v in base if v % 2 == 0]",
    "odds = [v for v in base if v % 2 == 1]",
    "report = (len(evens), len(odds))",
]

NOTEBOOKS = {"sci": SCI_NOTEBOOK, "analysis": ANALYSIS_NOTEBOOK,
             "fanout": FANOUT_NOTEBOOK}


# ---------------------------------------------------------------------------
# tests/test_core_notebook.py: AST extraction
# ---------------------------------------------------------------------------

CASES = [
    ("x = 1", set(), {"x"}),
    ("y = x + 1", {"x"}, {"y"}),
    ("x += 1", {"x"}, {"x"}),
    ("import numpy as np\nz = np.zeros(3)", set(), {"np", "z"}),
    ("def f(a):\n    return a + b\nc = f(1)", {"b"}, {"f", "c"}),
    ("out = [i * scale for i in data]", {"scale", "data"}, {"out"}),
    ("d = {k: v for k, v in pairs}", {"pairs"}, {"d"}),
    ("g = lambda t: t + offset\nh = g(2)", {"offset"}, {"g", "h"}),
    ("for row in rows:\n    total = total + row", {"rows", "total"}, {"row", "total"}),
    ("class A:\n    pass\na = A()", set(), {"A", "a"}),
    ("with open(p) as fh:\n    text = fh.read()", {"p"}, {"fh", "text"}),
]


@pytest.mark.parametrize("src,reads,writes", CASES)
def test_extract_usage(src, reads, writes):
    r, w = extract_usage(src)
    assert r == reads, (src, r)
    assert w == writes, (src, w)


def test_comprehension_variable_not_leaked():
    r, w = extract_usage("clean = [x for x in raw if x % 7 != 0]")
    assert "x" not in r and "x" not in w
    assert r == {"raw"} and w == {"clean"}


# ---------------------------------------------------------------------------
# tests/test_core_notebook.py: splitting
# ---------------------------------------------------------------------------


def _run_steps(g):
    """Execute the step graph sequentially in topological order."""
    artifacts = {}
    for name in g.topological():
        step = g.steps[name]
        artifacts.update(step.run({k: artifacts[k] for k in step.reads}))
    return artifacts


def test_linear_chain_fuses_to_one_step():
    nb = Notebook.from_sources(["a = 1", "b = a + 1", "c = b * 2"])
    g = split_pipeline(nb)
    assert len(g.steps) == 1, g.steps.keys()


def test_pipe_tag_forces_boundary():
    nb = Notebook.from_sources(["a = 1", "# %%pipe\nb = a + 1"])
    g = split_pipeline(nb)
    assert len(g.steps) == 2
    assert g.edges[("cell0", "cell1")] == {"a"}


def test_fanout_creates_parallel_steps():
    nb = Notebook.from_sources(
        ["base = list(range(10))",
         "evens = [v for v in base if v % 2 == 0]",
         "odds = [v for v in base if v % 2 == 1]",
         "summary = (len(evens), len(odds))"]
    )
    g = split_pipeline(nb)
    assert len(g.steps) >= 3  # fan-out forces separate pods
    order = g.topological()
    assert order.index("cell0") < order.index("cell1")
    assert order.index("cell0") < order.index("cell2")


def test_split_equivalence_to_linear_run():
    srcs = [
        "raw = list(range(50))",
        "clean = [v for v in raw if v % 3]",
        "# %%pipe\ns = sum(clean)",
        "n = len(clean)",
        "mean = s / n",
    ]
    nb = Notebook.from_sources(srcs)
    env = nb.run_linear()
    g = split_pipeline(nb)
    assert _run_steps(g)["mean"] == env["mean"]


def test_cycle_detection():
    steps = {
        "a": Step("a", fn=lambda i: {}, writes={"x"}),
        "b": Step("b", fn=lambda i: {}, reads={"x"}, writes={"y"}),
    }
    g = StepGraph(steps=steps, edges={("a", "b"): {"x"}, ("b", "a"): {"y"}})
    with pytest.raises(ValueError, match="cycle"):
        g.topological()


TEMPLATES = [
    "v{i} = {j} + 1",
    "v{i} = v{j} * 2",
    "# %%pipe\nv{i} = v{j} - 1",
    "v{i} = v{j} + v{k}",
]


def _random_program(templates, seed):
    srcs = ["v0 = 7"]
    for i, t in enumerate(templates, start=1):
        srcs.append(t.format(i=i, j=(seed + i) % i, k=(seed * 3 + i) % i))
    return srcs


# hypothesis: random linear programs — split always preserves semantics
@settings(max_examples=25, deadline=None)
@given(st.lists(st.sampled_from(TEMPLATES), min_size=2, max_size=8),
       st.integers(0, 1000))
def test_split_equivalence_property(templates, seed):
    srcs = _random_program(templates, seed)
    nb = Notebook.from_sources(srcs)
    env = nb.run_linear()
    artifacts = _run_steps(split_pipeline(nb))
    finals = {k: v for k, v in env.items() if k.startswith("v")}
    for k, v in finals.items():
        assert artifacts.get(k, v) == v, (k, srcs)


def test_dag_edges_last_writer_wins():
    cells = [Cell(source="x = 1", name="c0"),
             Cell(source="x = 2", name="c1"),
             Cell(source="y = x", name="c2")]
    edges = build_cell_dag(cells)
    assert (1, 2, {"x"}) in edges and all(e[0] != 0 for e in edges)


# ---------------------------------------------------------------------------
# tests/test_capsule.py
# ---------------------------------------------------------------------------


def make_step():
    def fn(inputs):
        return {"y": inputs.get("x", 0) + 1}

    return Step("s", fn=fn, reads={"x"}, writes={"y"})


def test_capsule_id_stable():
    s = make_step()
    c1 = capture(s, config={"lr": 0.1}, device="cpu")
    c2 = capture(s, config={"lr": 0.1}, device="cpu")
    assert c1.capsule_id == c2.capsule_id


def test_capsule_id_sensitive_to_config():
    s = make_step()
    assert (capture(s, {"lr": 0.1}, device="cpu").capsule_id
            != capture(s, {"lr": 0.2}, device="cpu").capsule_id)


def test_capsule_roundtrip_json():
    c = capture(make_step(), {"a": 1}, seeds={"train": 7}, device="cpu")
    c2 = Capsule.from_json(c.to_json())
    assert c2.capsule_id == c.capsule_id
    assert c2.seeds == {"train": 7}


def test_drift_detection():
    img = seal_step(make_step(), config={}, device="cpu")
    current = capture(make_step(), config={}, device="cpu")
    assert img.verify_against(current) == []  # same env -> no drift
    drifted = dataclasses.replace(current, packages={**current.packages,
                                                     "torch": "9.9.9"})
    report = img.verify_against(drifted)
    assert any("torch" in line for line in report)


def test_capsule_captures_packages_and_platform():
    c = capture(make_step(), device="cpu")
    assert "torch" in c.packages and "numpy" in c.packages
    assert "jax" not in c.packages
    assert c.packages["torch"] == torch.__version__
    assert c.platform["torch_backend"] == "cpu"
    assert c.platform["torch_cuda"] == str(torch.version.cuda)
    assert c.platform["device_count"] == str(torch.cuda.device_count())
    assert make_step().name in c.code


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_cuda_default_raises_without_a_card(tmp_path):
    """Entry points run on the card unless told otherwise: the capsule,
    the scheduler and the deployer raise instead of recording a CPU."""
    g = make_graph({"s": make_step()}, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture(make_step())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkflowScheduler(g, TopicBus(tmp_path / "bus"),
                          ArtifactStore(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynamicPodDeployer(PodManager(g)).deploy_all()


# ---------------------------------------------------------------------------
# tests/test_scheduler.py: the workflow scheduler and the deployer
# ---------------------------------------------------------------------------


def make_graph(steps, edges):
    return StepGraph(steps=steps, edges=edges).validate()


def run(graph, tmp_path, faults=None, retry=None, **kw):
    bus = TopicBus(tmp_path / "bus")
    store = ArtifactStore(tmp_path / "store")
    sched = WorkflowScheduler(
        graph, bus, store,
        retry=retry or RetryPolicy(max_attempts=4, backoff_s=0.01),
        fault_injector=faults, device="cpu", **kw,
    )
    return sched, sched.run(timeout_s=60)


def test_diamond_workflow_runs(tmp_path):
    steps = {
        "src": Step("src", fn=lambda i: {"x": 10}, writes={"x"}, replicas=1),
        "l": Step("l", fn=lambda i: {"a": i["x"] + 1}, reads={"x"}, writes={"a"}, replicas=1),
        "r": Step("r", fn=lambda i: {"b": i["x"] * 2}, reads={"x"}, writes={"b"}, replicas=1),
        "join": Step("join", fn=lambda i: {"y": i["a"] + i["b"]},
                     reads={"a", "b"}, writes={"y"}, replicas=1),
    }
    edges = {("src", "l"): {"x"}, ("src", "r"): {"x"},
             ("l", "join"): {"a"}, ("r", "join"): {"b"}}
    _, arts = run(make_graph(steps, edges), tmp_path)
    assert arts["y"] == 31


def test_retry_after_crash(tmp_path):
    attempts = []

    def flaky(inputs):
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return {"v": 42}

    steps = {"s": Step("s", fn=flaky, writes={"v"}, replicas=1, max_attempts=4)}
    sched, arts = run(make_graph(steps, {}), tmp_path)
    assert arts["v"] == 42 and len(attempts) == 3
    kinds = [e["kind"] for e in sched.events.history()]
    assert kinds.count("step_retry_scheduled") == 2
    assert kinds.count("step_error") == 2
    # the error events keep the formatted trace the pods no longer hold
    assert all("transient" in e["trace"]
               for e in sched.events.history("step_error"))


def test_permanent_failure_raises(tmp_path):
    def broken(inputs):
        raise ValueError("always")

    steps = {"s": Step("s", fn=broken, writes={"v"}, replicas=1)}
    with pytest.raises(RuntimeError, match="failed after"):
        run(make_graph(steps, {}), tmp_path,
            retry=RetryPolicy(max_attempts=2, backoff_s=0.01))


def test_speculative_replicas_first_wins(tmp_path):
    """ReplicaSet analogue: slow replica is superseded by the fast one."""
    def racy(inputs, ctx):
        if ctx.attempt % 2 == 0:  # even attempts are fast
            return {"v": ctx.attempt}
        for _ in range(200):
            time.sleep(0.02)
            ctx.check()  # cancelled when a sibling wins
        return {"v": -1}

    steps = {"s": Step("s", fn=racy, writes={"v"}, replicas=3)}
    sched, arts = run(make_graph(steps, {}), tmp_path)
    assert arts["v"] % 2 == 0
    done = sched.events.history("step_done")
    assert len(done) == 1  # idempotent completion despite 3 replicas


def test_chaos_kill_then_recover(tmp_path):
    calls = []

    def work(inputs, ctx):
        calls.append(ctx.attempt)
        for _ in range(30):
            time.sleep(0.01)
            ctx.beat(progress=len(calls))
        return {"v": "done"}

    faults = FaultInjector([KillRule(step="s", after_s=0.05, times=1)])
    steps = {"s": Step("s", fn=work, writes={"v"}, replicas=1, max_attempts=4)}
    sched, arts = run(make_graph(steps, {}), tmp_path, faults=faults)
    assert arts["v"] == "done"
    assert len(calls) >= 2  # first attempt killed, retry succeeded


def test_long_running_forces_single_replica(tmp_path):
    ran = []

    def trainer(inputs, ctx):
        ran.append(ctx.pod_name)
        return {"v": 1}

    steps = {"s": Step("s", fn=trainer, writes={"v"}, replicas=3, long_running=True)}
    _, arts = run(make_graph(steps, {}), tmp_path)
    assert len(ran) == 1


def test_artifacts_stored_with_refs(tmp_path):
    steps = {"s": Step("s", fn=lambda i: {"v": [1, 2, 3]}, writes={"v"}, replicas=1)}
    sched, arts = run(make_graph(steps, {}), tmp_path)
    done = sched.events.history("step_done")[0]
    ref = done["refs"]["v"]
    assert sched.store.get(ref) == [1, 2, 3]


def test_pod_manager_roles_and_topics():
    steps = {
        "a": Step("a", fn=lambda i: {"x": 1}, writes={"x"}),
        "b": Step("b", fn=lambda i: {"y": 1}, reads={"x"}, writes={"y"}),
        "c": Step("c", fn=lambda i: {}, reads={"y"}),
    }
    g = make_graph(steps, {("a", "b"): {"x"}, ("b", "c"): {"y"}})
    pm = PodManager(g)
    assert pm.role_of("a") == "producer"
    assert pm.role_of("b") == "both"
    assert pm.role_of("c") == "consumer"
    in_t, out_t = pm.topics_of("b")
    assert in_t == ["pipe.a.b"] and out_t == ["pipe.b.c"]


def test_deployer_renders_paper_listing1(tmp_path):
    steps = {"train": Step("train", fn=lambda i: {"m": 1}, writes={"m"})}
    g = make_graph(steps, {})
    dep = DynamicPodDeployer(PodManager(g), out_dir=tmp_path / "k8s",
                             device="cpu")
    specs = dep.deploy_all()
    y = (tmp_path / "k8s" / "train-deployment.yaml").read_text()
    # the paper's Listing 1 structure, faithfully
    for needle in ["apiVersion: apps/v1", "kind: Deployment", "replicas: 3",
                   "RollingUpdate", "maxUnavailable: 1", "maxSurge: 1",
                   "KAFKA_BROKER", "livenessProbe", "readinessProbe",
                   "/healthz", "/readiness", "persistentVolumeClaim",
                   "mountPath: /mnt/efs"]:
        assert needle in y, needle
    pv = (tmp_path / "k8s" / "train-storage.yaml").read_text()
    assert "PersistentVolume" in pv and "PersistentVolumeClaim" in pv
    assert specs[0].replicas == 3  # paper default
    assert dep.load_kube_config() == {"context": "jup2kub-sim",
                                      "devices": torch.cuda.device_count(),
                                      "backend": "cpu"}


def test_straggler_hedging(tmp_path):
    """A slow-but-alive attempt triggers ONE hedged speculative attempt;
    the fast hedge wins and the straggler is cancelled."""
    state = {"n": 0}
    lock = threading.Lock()

    def work(inputs, ctx):
        with lock:
            state["n"] += 1
            first = state["n"] == 1
        if first:  # the straggler: alive (heartbeating) but slow
            for _ in range(500):
                time.sleep(0.02)
                ctx.beat(progress=1)
            return {"v": "slow"}
        return {"v": "fast"}

    steps = {"s": Step("s", fn=work, writes={"v"}, replicas=1, max_attempts=4)}
    sched, arts = run(make_graph(steps, {}), tmp_path, hedge_after_s=0.2)
    assert arts["v"] == "fast"
    kinds = [e["kind"] for e in sched.events.history()]
    assert kinds.count("pod_hedged") == 1
    assert kinds.count("step_done") == 1


# ---------------------------------------------------------------------------
# tests/test_scheduler.py: the serving StepPlan, over the port's page pool
# ---------------------------------------------------------------------------


def _cache(**kw):
    from repro_torch.serving import PagedKVCache

    args = dict(num_layers=1, num_kv_heads=1, head_dim=4, dtype=torch.float32,
                max_slots=3, max_context=64, page_size=8, device="cpu")
    args.update(kw)
    return PagedKVCache(**args)


def _sched(cache, **kw):
    from repro_torch.serving.scheduler import Scheduler

    args = dict(prefill_chunk=8, chunked=True, prefix_sharing=True)
    args.update(kw)
    return Scheduler(cache, **args)


def _req(uid, prompt, **kw):
    from repro_torch.serving import Request, RequestHandle

    r = Request(uid, prompt, **kw)
    return r, RequestHandle(r)


def _start_decode(sched, uid, prompt, first_tok=7):
    """Place + fully prefill one request so its slot is decodable."""
    slot, seq, _ = sched.place(*_req(uid, prompt))
    while True:
        work = sched.next_prefill()
        assert work.slot == slot
        if sched.complete_chunk(work):
            break
    seq.tokens.append(first_tok)
    sched.begin_decode(slot)
    return slot, seq


def test_step_plan_degenerate_shapes():
    """Empty scheduler -> empty plan; prefill-only -> chunk-only plan;
    decode-only -> no chunk; step_tokens accounts both parts."""
    from repro_torch.serving.scheduler import StepPlan

    sched = _sched(_cache())
    plan = sched.build_step_plan()
    assert isinstance(plan, StepPlan)
    assert plan.decode_slots == [] and plan.decode is None
    assert plan.chunk is None and plan.step_tokens == 0

    sched.place(*_req("p", list(range(1, 13))))
    plan = sched.build_step_plan()
    assert plan.decode_slots == [] and plan.decode is None
    assert plan.chunk is not None and plan.chunk.valid == 8
    assert plan.step_tokens == 8

    sched.complete_chunk(sched.next_prefill())
    sched.complete_chunk(sched.next_prefill())
    slot = plan.chunk.slot
    sched.slots[slot].tokens.append(3)
    sched.begin_decode(slot)
    plan = sched.build_step_plan()
    assert plan.decode_slots == [slot] and plan.chunk is None
    assert plan.step_tokens == 1
    assert plan.decode is not None  # composition changed -> batch rebuilt


def test_step_plan_token_budget_accounting():
    """The chunk's live tokens fill budget - decode_rows; a budget already
    spent by decode rows defers the chunk; no decode rows waives the cap."""
    cache = _cache(max_slots=3, num_pages=32)
    sched = _sched(cache, token_budget=6)
    s0, _ = _start_decode(sched, "d0", list(range(1, 7)))
    s1, _ = _start_decode(sched, "d1", list(range(20, 26)))
    sched.place(*_req("p", list(range(40, 52))))  # 12 tokens to prefill

    plan = sched.build_step_plan()
    assert plan.decode_slots == sorted([s0, s1])
    assert plan.chunk is not None
    assert plan.chunk.valid == 4           # 6 budget - 2 decode rows
    assert plan.step_tokens == 6
    assert plan.chunk.tokens.shape == (4,)
    assert plan.chunk.valid == plan.chunk.tokens.shape[0]
    sched.complete_chunk(plan.chunk)

    sched.token_budget = 2
    plan = sched.build_step_plan()
    assert plan.chunk is None
    assert plan.step_tokens == 2

    for s in list(plan.decode_slots):
        sched.release(s)
    plan = sched.build_step_plan()
    assert plan.decode_slots == []
    assert plan.chunk is not None and plan.chunk.valid == 8
    assert plan.step_tokens == 8


def test_step_plan_preemption_mid_chunk():
    """A sequence preempted mid-prefill vanishes from the next plan: its
    chunk is not dispatched and its slot is not harvested."""
    cache = _cache(num_pages=5, max_slots=3)  # 4 usable pages
    sched = _sched(cache, prefix_sharing=False)
    s0, seq0 = _start_decode(sched, "old", list(range(1, 16)))  # 2 pages
    sched.place(*_req("young", [90 + i for i in range(15)]))
    assert sched.next_prefill() is not None
    cache.lengths[s0] = 16  # next decode write needs a 3rd page: none free
    preempted = sched.ensure_decode_capacity()
    assert [s.request.uid for s in preempted] == ["young"]

    plan = sched.build_step_plan()
    assert plan.chunk is None
    assert plan.decode_slots == [s0]
    assert plan.decode is not None
    assert plan.decode.active[s0] == 1


def test_step_plan_static_shapes_and_mirror_reuse():
    """Decode batches keep (max_slots,)-static shapes across steps, clean
    steady-state plans skip the rebuild (decode=None), and append_decoded
    keeps the mirrors current without dirtying."""
    from repro_torch.serving.kv_cache import NULL_PAGE
    from repro_torch.serving.scheduler import Scheduler

    cache = _cache(max_slots=3, num_pages=32)
    sched = _sched(cache)
    s0, seq0 = _start_decode(sched, "a", list(range(1, 7)))
    plan1 = sched.build_step_plan()
    d = plan1.decode
    assert d.tokens.shape == (3, 1) and d.active.shape == (3,)
    assert d.block_tables.shape == cache.block_tables.shape
    assert d.active[s0] == 1 and d.lengths[s0] == cache.lengths[s0]
    idle = [s for s in range(3) if s != s0]
    assert (d.block_tables[idle] == NULL_PAGE).all()
    assert sched.dirty is False

    sched.append_decoded(s0, 42)
    assert sched.dirty is False
    plan2 = sched.build_step_plan()
    assert plan2.decode is None            # zero-transfer steady state
    assert plan2.decode_slots == [s0] and plan2.step_tokens == 1
    assert sched._mir_tokens[s0, 0] == 42
    assert sched._mir_idx[s0] == len(seq0.tokens)
    assert sched._mir_lens[s0] == cache.lengths[s0]

    s1, _ = _start_decode(sched, "b", list(range(30, 37)), first_tok=9)
    plan3 = sched.build_step_plan()
    assert plan3.decode is not None
    fresh = Scheduler(cache, prefill_chunk=8, chunked=True,
                      prefix_sharing=True)
    fresh.slots = sched.slots
    rebuilt = fresh.build_decode_inputs()
    for a, b in zip(
        (plan3.decode.tokens, plan3.decode.active, plan3.decode.lengths,
         plan3.decode.block_tables, plan3.decode.idx),
        (rebuilt.tokens, rebuilt.active, rebuilt.lengths,
         rebuilt.block_tables, rebuilt.idx),
    ):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# tests/test_system.py: the paper's pipeline, end to end
# ---------------------------------------------------------------------------


def test_notebook_to_k8s_end_to_end(tmp_path):
    """Linear notebook in, fault-tolerant distributed execution out, same
    results, k8s manifests rendered."""
    nb = Notebook.from_sources(SCI_NOTEBOOK, name="sci")
    linear = nb.run_linear()
    g = split_pipeline(nb)
    assert len(g.steps) >= 3  # actually distributed

    first = sorted(g.steps)[0]
    faults = FaultInjector([KillRule(step=first, after_s=0.0, times=1)])
    sched, arts = run(g, tmp_path, faults=faults)
    assert arts["report"] == linear["report"]
    assert all(s.image.capsule.platform["torch_backend"] == "cpu"
               for s in sched._state.values())

    dep = DynamicPodDeployer(PodManager(g), out_dir=tmp_path / "k8s",
                             device="cpu")
    specs = dep.deploy_all()
    assert len(list((tmp_path / "k8s").glob("*-deployment.yaml"))) == len(g.steps)
    roles = {s.role for s in specs}
    assert "producer" in roles and "consumer" in roles


def test_fault_tolerant_training_with_chaos(tmp_path):
    """Chaos kills the train pod twice; checkpoint/restart must finish the
    run and the loss must improve (learnable synthetic corpus)."""
    from repro_torch.launch.train import build_workflow

    args = argparse.Namespace(
        arch="smollm-360m", reduced=True, steps=30, batch=8, seq_len=32,
        ga=1, lr=3e-3, seed=0, ckpt_every=6, device="cpu",
    )
    workdir = tmp_path / "run"
    workdir.mkdir()
    stats = {}
    graph = build_workflow(args, workdir, stats=stats)
    bus = TopicBus(tmp_path / "bus")
    store = ArtifactStore(tmp_path / "store")
    claim = store.claim("ckpt")
    faults = FaultInjector([KillRule(step="train", after_s=0.8, times=2)])
    sched = WorkflowScheduler(
        graph, bus, store, workflow="ft-train",
        retry=RetryPolicy(max_attempts=6, backoff_s=0.05),
        liveness_window_s=30.0, fault_injector=faults,
        claim_paths={"train": str(claim.path)}, device="cpu",
    )
    arts = sched.run(timeout_s=600)
    rep = arts["report"]
    assert rep["improved"], rep
    kinds = [e["kind"] for e in sched.events.history()]
    assert kinds.count("step_retry_scheduled") >= 1
    assert any(claim.path.glob("step_*/MANIFEST.json"))
    # each attempt recorded its steps; the last one ran to the end
    assert len(stats["attempts"]) >= 2
    last = stats["attempts"][-1]
    assert last["start_step"] + len(last["step_s"]) == args.steps


# ---------------------------------------------------------------------------
# cross-package: the same notebooks through both packages
# ---------------------------------------------------------------------------


def _graph_view(g):
    return ({n: ([c.source for c in s.cells], s.reads, s.writes)
             for n, s in g.steps.items()},
            g.edges, g.external_inputs, g.topological(), g.to_dot())


@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_split_matches_jax(name):
    from repro.core import Notebook as JNotebook
    from repro.core import split_pipeline as jsplit

    g = split_pipeline(Notebook.from_sources(NOTEBOOKS[name], name=name))
    jg = jsplit(JNotebook.from_sources(NOTEBOOKS[name], name=name))
    assert _graph_view(g) == _graph_view(jg)


@settings(max_examples=15, deadline=None)
@given(st.lists(st.sampled_from(TEMPLATES), min_size=2, max_size=8),
       st.integers(0, 1000))
def test_split_matches_jax_property(templates, seed):
    from repro.core import Notebook as JNotebook
    from repro.core import split_pipeline as jsplit

    srcs = _random_program(templates, seed)
    assert (_graph_view(split_pipeline(Notebook.from_sources(srcs)))
            == _graph_view(jsplit(JNotebook.from_sources(srcs))))


@pytest.mark.parametrize("name", sorted(NOTEBOOKS))
def test_rendered_yaml_equals_jax(name, tmp_path):
    from repro.core import Notebook as JNotebook
    from repro.core import split_pipeline as jsplit
    from repro.core.deployer import DynamicPodDeployer as JDeployer
    from repro.core.deployer import PodManager as JPodManager

    g = split_pipeline(Notebook.from_sources(NOTEBOOKS[name]))
    jg = jsplit(JNotebook.from_sources(NOTEBOOKS[name]))
    DynamicPodDeployer(PodManager(g), out_dir=tmp_path / "port",
                       device="cpu").deploy_all()
    JDeployer(JPodManager(jg), out_dir=tmp_path / "jax").deploy_all()
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == 2 * len(g.steps)
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


@pytest.mark.parametrize("name", ["sci", "analysis"])
def test_pipeline_report_equals_jax(name, tmp_path):
    """Both schedulers, each with a chaos kill of the second step, give the
    linear notebook's report."""
    from repro.core import ArtifactStore as JStore
    from repro.core import Notebook as JNotebook
    from repro.core import TopicBus as JBus
    from repro.core import WorkflowScheduler as JScheduler
    from repro.core import split_pipeline as jsplit
    from repro.core.faults import FaultInjector as JFaults
    from repro.core.faults import KillRule as JKill
    from repro.core.scheduler import RetryPolicy as JRetry

    nb = Notebook.from_sources(NOTEBOOKS[name])
    g = split_pipeline(nb)
    victim = sorted(g.steps)[1]
    _, arts = run(g, tmp_path / "port", faults=FaultInjector(
        [KillRule(step=victim, after_s=0.0, times=1)]))
    jg = jsplit(JNotebook.from_sources(NOTEBOOKS[name]))
    jarts = JScheduler(
        jg, JBus(tmp_path / "jbus"), JStore(tmp_path / "jstore"),
        retry=JRetry(max_attempts=4, backoff_s=0.01),
        fault_injector=JFaults([JKill(step=victim, after_s=0.0, times=1)]),
    ).run(timeout_s=60)
    assert arts["report"] == jarts["report"] == nb.run_linear()["report"]


# ---------------------------------------------------------------------------
# the elastic rescale (ROADMAP A.10) and the pod repair (ROADMAP C.7)
# ---------------------------------------------------------------------------


def test_rescale_plan_reshards_onto_a_mesh():
    """The plan's shardings follow the rules over the mesh's axes (``ff``
    over ``model``, ``embed`` over an absent ``data``: whole); ``apply``
    gives this rank (rank 0) its slice of each leaf, on its device."""
    import torch

    from repro_torch.core.elastic import RescalePlan, rolling_phases
    from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh
    from repro_torch.parallel import PartitionSpec as P

    state = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)}
    axes = {"w": ("embed", "ff"), "b": (None,)}
    plan = RescalePlan(axes, new_mesh=make_serving_mesh(2, devices=["cpu"] * 2))
    sh = plan.new_shardings(state)
    assert sh["w"].spec == P(None, "model") and sh["b"].spec == P(None)
    got = plan.apply(state)  # rank 0 of two: no follower needed to cut
    assert torch.equal(got["w"], state["w"][:, :2])
    assert torch.equal(got["b"], state["b"])
    assert not plan.new_mesh.started
    host = RescalePlan(axes, new_mesh=make_host_mesh()).apply(state)
    assert all(torch.equal(host[k], state[k]) for k in state)
    phases = list(rolling_phases(4, 2, max_unavailable=1))
    assert [p["phase"] for p in phases] == [
        "checkpoint_barrier", "drain", "drain", "reshard", "resume"]
    assert [p["phase"] for p in rolling_phases(1, 4, max_unavailable=2)] == [
        "checkpoint_barrier", "surge", "surge", "reshard", "resume"]


@pytest.mark.parametrize("death", ["killed", "crashed"])
def test_dead_attempt_releases_its_tensors(death, tmp_path):
    """A dead attempt's tensors are freed when its thread ends, with the
    cycle collector off: the pod keeps the exception without its
    traceback (whose frames held the attempt's locals), while the
    scheduler keeps every pod to the end of the run."""
    refs = []
    started = threading.Event()

    def work(inputs, ctx):
        state = {"w": torch.zeros(1 << 16)}
        refs.append(weakref.ref(state["w"]))
        started.set()
        try:
            while True:
                time.sleep(0.002)
                ctx.beat(progress=1)
        except PodKilled:
            if death == "crashed":  # a crash while handling the kill
                raise RuntimeError("crash") from None
            raise

    image = seal_step(Step("train", fn=work, writes={"v"}), device="cpu")
    bus = TopicBus(tmp_path / "bus")
    pod = WorkerPod("train-a1", image, {}, bus, ArtifactStore(tmp_path / "s"),
                    EventLog(bus), attempt=1)
    gc.disable()
    try:
        pod.start()
        assert started.wait(10)
        pod.kill_switch.kill("chaos")
        pod.join(10)
        assert pod.state == "failed"
        assert isinstance(pod.error, PodKilled if death == "killed"
                          else RuntimeError)
        assert refs[0]() is None, "the dead attempt's tensor is still alive"
        assert pod.error.__traceback__ is None
    finally:
        gc.enable()
    if death == "crashed":
        (err,) = EventLog(bus).history("step_error")
        assert "RuntimeError: crash" in err["trace"]
