"""The port's core runtime and supervised serving fleet, on the CPU.

* ``put_tree`` (ROADMAP C.5): for the same values the port's
  ``ArtifactStore`` gives the JAX package's refs, leaves and meta: f32,
  int and bf16 leaves (bf16 as JAX's 16-bit ``V2`` pattern) under
  unsorted dict keys, nested lists and tuples, None, tensors that require
  grad and a transposed tensor; plus the ports of
  ``tests/test_storage.py``'s and ``tests/test_bus_storage.py``'s tree
  round trips.
* ``core/faults.py`` and ``core/probes.py``: the ports of
  ``tests/test_faults.py`` (exactly-once kill accounting under thread
  races, worker-kill rules) and ``tests/test_probes.py`` (the probe state
  machine on an injected clock); the kernel wrappers' launch counts stay
  exact when fleet workers launch from several threads.
* ``serving/fleet.py``: the three crash schedules of
  ``tests/test_fleet_chaos.py`` (mid-prefill, mid-decode, during cancel)
  on a 2-3 worker ``FleetSupervisor`` over the port's paged engine
  (reduced smollm-360m, f32, the port's seeded weights): every request
  terminal, every completed stream byte-identical to a single-engine
  oracle replay, each ``(uid, index)`` once on ``responses`` before its
  finish, no mismatched or gapped delta, replicas within [min, max]; and
  ``--role worker`` serving a work topic another process published.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.storage import ArtifactStore as JArtifactStore  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import ArtifactStore, TopicBus  # noqa: E402
from repro_torch.core.executor import KillSwitch  # noqa: E402
from repro_torch.core.faults import (  # noqa: E402
    FaultInjector,
    KillRule,
    WorkerKillRule,
)
from repro_torch.core.probes import HealthMonitor, HeartbeatWriter  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    FleetConfig,
    FleetSupervisor,
    fleet_seed,
    request_from_message,
)

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# put_tree against the JAX package's (ROADMAP C.5)
# ---------------------------------------------------------------------------


def _trees(seed):
    """The same values as a JAX tree and a torch tree."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((3, 4)).astype(np.float32)
    i = rng.integers(-9, 9, (5,)).astype(np.int32)
    h = rng.standard_normal((2, 3)).astype(np.float32)
    m = rng.standard_normal((4, 2)).astype(np.float32)
    jtree = {"zeta": jnp.asarray(f),
             "beta": {"y": [jnp.asarray(i), (jnp.asarray(h, jnp.bfloat16),
                                             None)],
                      "a": 3, "x": ()},
             "mid": (jnp.asarray(m).T,), "alpha": [jnp.asarray(f[0])]}
    ttree = {"zeta": torch.from_numpy(f.copy()).requires_grad_(True),
             "beta": {"y": [torch.from_numpy(i), (torch.from_numpy(h)
                                                  .bfloat16(), None)],
                      "a": 3, "x": ()},
             "mid": (torch.from_numpy(m).T,),
             "alpha": [torch.from_numpy(f[0].copy())]}
    return jtree, ttree


@pytest.mark.parametrize("seed", [0, 1])
def test_put_tree_refs_equal_jax(tmp_path, seed):
    jtree, ttree = _trees(seed)
    jstore = JArtifactStore(tmp_path / "j")
    tstore = ArtifactStore(tmp_path / "t")
    jref, tref = jstore.put_tree(jtree), tstore.put_tree(ttree)
    assert tref == jref
    jmeta, tmeta = jstore.get(jref), tstore.get(tref)
    assert tmeta == jmeta
    assert tmeta["treedef"] == (
        "PyTreeDef({'alpha': [*], 'beta': {'a': *, 'x': (), 'y': [*, (*, "
        "None)]}, 'mid': (*,), 'zeta': *})")
    for r in tmeta["leaves"]:  # bytes and decoded arrays alike
        got, want = tstore.get(r), jstore.get(r)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    bf16 = tstore.get(tmeta["leaves"][3])
    assert bf16.dtype == np.dtype("V2")  # as the JAX package reads it back


def test_put_tree_leaves_and_scalars(tmp_path):
    """Lone leaves, empty containers and Python scalars flatten as JAX
    flattens them."""
    jstore = JArtifactStore(tmp_path / "j")
    tstore = ArtifactStore(tmp_path / "t")
    for tree in (3.5, None, [], {}, (1,), [[], {"b": 2, "a": 1.0}]):
        assert tstore.put_tree(tree) == jstore.put_tree(tree), tree


def test_put_tree_reconstructs_nested_pytree(tmp_path):
    """``tests/test_storage.py``'s round trip, with torch and numpy
    leaves."""
    store = ArtifactStore(tmp_path)
    tree = {"k": torch.arange(6).reshape(2, 3),
            "nested": [np.ones(3), torch.zeros(2)]}
    meta = store.get(store.put_tree(tree, name="params"))
    assert set(meta) == {"treedef", "leaves"} and len(meta["leaves"]) == 3
    got = [store.get(r) for r in meta["leaves"]]
    np.testing.assert_array_equal(got[0], tree["k"].numpy())
    np.testing.assert_array_equal(got[1], tree["nested"][0])
    np.testing.assert_array_equal(got[2], tree["nested"][1].numpy())


def test_store_tree_roundtrip(tmp_path):
    """``tests/test_bus_storage.py``'s round trip."""
    store = ArtifactStore(tmp_path)
    tree = {"a": np.arange(5), "b": {"c": np.ones((2, 2))}}
    meta = store.get(store.put_tree(tree))
    leaves = [store.get(r) for r in meta["leaves"]]
    np.testing.assert_array_equal(leaves[0], tree["a"])
    np.testing.assert_array_equal(leaves[1], tree["b"]["c"])


def test_concurrent_puts_of_one_object(tmp_path):
    """Engine workers flushing the same prefix page put one object at once:
    every put returns its ref and the object reads back whole."""
    store = ArtifactStore(tmp_path)
    blob = np.arange(4096, dtype=np.float32)
    refs = _race(16, lambda i: store.put(blob, tier="node", name="kv.p"))
    assert len(set(refs)) == 1
    np.testing.assert_array_equal(store.get(refs[0]), blob)
    d = tmp_path / "node" / "node0" / "objects" / refs[0].split("/")[2]
    assert sorted(f.name for f in d.iterdir()) == ["data", "meta.json"]


# ---------------------------------------------------------------------------
# core/faults.py (tests/test_faults.py)
# ---------------------------------------------------------------------------


def _pod(step="s", attempt=0):
    return SimpleNamespace(
        image=SimpleNamespace(step=SimpleNamespace(name=step)),
        attempt=attempt, kill_switch=KillSwitch())


def _race(n, fn):
    barrier = threading.Barrier(n)
    out = [None] * n

    def runner(i):
        barrier.wait()
        out[i] = fn(i)

    threads = [threading.Thread(target=runner, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_on_pod_start_times_respected_under_races():
    inj = FaultInjector(rules=[KillRule(step="s", after_s=60.0, times=1)])
    results = _race(16, lambda i: inj.on_pod_start(_pod()))
    inj.cancel_all()
    assert sum(results) == 1, f"times=1 rule armed {sum(results)} kills"
    assert inj.kills_armed() == 1


def test_check_worker_fires_once_per_rule_budget():
    inj = FaultInjector(worker_rules=[WorkerKillRule(after_steps=3, times=2)])
    assert inj.check_worker("w0", 0, steps=0, tokens=0) is None
    assert inj.check_worker("w0", 0, steps=2, tokens=9) is None
    reason = inj.check_worker("w0", 0, steps=3, tokens=11)
    assert reason == "chaos:w0:a0:steps=3:tokens=11"
    assert inj.check_worker("w0", 0, steps=4, tokens=12) is None
    assert inj.check_worker("w0", 1, steps=3, tokens=0) is not None
    assert inj.check_worker("w1", 0, steps=5, tokens=0) is None  # exhausted
    assert inj.kills_armed() == 2


def test_check_worker_filters_and_conjunction():
    inj = FaultInjector(worker_rules=[
        WorkerKillRule(worker="w1", attempt=1, after_steps=1)])
    assert inj.check_worker("w0", 1, steps=9, tokens=9) is None
    assert inj.check_worker("w1", 0, steps=9, tokens=9) is None
    assert inj.check_worker("w1", 1, steps=0, tokens=0) is None
    assert inj.check_worker("w1", 1, steps=1, tokens=0) is not None
    both = FaultInjector(worker_rules=[
        WorkerKillRule(after_steps=2, after_tokens=5, times=3)])
    assert both.check_worker("a", 0, steps=2, tokens=4) is None
    assert both.check_worker("a", 0, steps=1, tokens=7) is None
    assert both.check_worker("a", 0, steps=2, tokens=5) is not None


def test_check_worker_threaded_exactly_once():
    inj = FaultInjector(worker_rules=[WorkerKillRule(after_steps=1, times=1)])
    out = _race(12, lambda i: inj.check_worker(f"w{i}", 0, steps=1,
                                                tokens=0))
    fired = [r for r in out if r is not None]
    assert len(fired) == 1, f"times=1 worker rule fired {len(fired)} kills"
    assert inj.kills_armed() == 1


def test_launch_counts_exact_across_threads():
    """Fleet workers launch kernels from several threads: the wrappers'
    counts (``build.count_launch``) lose no increment."""
    from repro_torch.kernels import build

    counts, by_path = {"k": 0}, {"a": 0}

    def bump(i):
        for _ in range(20000):
            build.count_launch((counts, "k"), (by_path, "a"))

    _race(8, bump)
    assert counts == {"k": 160000} and by_path == {"a": 160000}


def test_rules_without_thresholds_are_inert():
    inj = FaultInjector(worker_rules=[WorkerKillRule(worker="w0")])
    assert inj.check_worker("w0", 0, steps=100, tokens=100) is None
    assert inj.kills_armed() == 0


# ---------------------------------------------------------------------------
# core/probes.py (tests/test_probes.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def bus(tmp_path):
    return TopicBus(tmp_path / "bus")


def _monitor(bus, now, liveness=10.0, livelock=None):
    return HealthMonitor(bus, liveness_window_s=liveness,
                         livelock_window_s=livelock, clock=lambda: now["t"])


def test_not_ready_to_live_to_dead(bus):
    now = {"t": time.time()}
    mon = _monitor(bus, now)
    hb = HeartbeatWriter(bus, "p0")
    assert mon.status("p0") == "unknown"
    hb.beat(progress=0)
    assert mon.status("p0") == "not_ready"
    hb.ready()
    now["t"] = time.time()
    assert mon.status("p0") == "live"
    now["t"] = time.time() + 5
    assert mon.status("p0") == "live"
    now["t"] = time.time() + 11
    assert mon.status("p0") == "dead"
    assert mon.dead_pods() == ["p0"]
    hb.beat(progress=1)
    now["t"] = time.time()
    assert mon.status("p0") == "live"


def test_livelock_detection(bus):
    now = {"t": time.time()}
    mon = _monitor(bus, now, liveness=100.0, livelock=2.0)
    hb = HeartbeatWriter(bus, "p0")
    hb.ready()
    hb.beat(progress=3, busy=True)
    now["t"] = time.time() + 1
    assert mon.status("p0") == "live"
    now["t"] = time.time() + 5
    assert mon.status("p0") == "livelocked"
    assert ("p0", "livelocked") in mon.unhealthy_pods()
    assert mon.dead_pods() == []
    hb.beat(progress=4, busy=True)
    now["t"] = time.time() + 1
    assert mon.status("p0") == "live"
    hb.beat(progress=4, busy=False)
    now["t"] = time.time() + 5
    assert mon.status("p0") == "live"
    mon2 = _monitor(bus, now, liveness=100.0, livelock=None)
    hb2 = HeartbeatWriter(bus, "p1")
    hb2.ready()
    hb2.beat(progress=1, busy=True)
    now["t"] = time.time() + 50
    assert mon2.status("p1") == "live"


def test_unhealthy_pods_and_forget(bus):
    now = {"t": time.time()}
    mon = _monitor(bus, now, liveness=10.0, livelock=2.0)
    for name in ("dead0", "lock0", "ok0"):
        hb = HeartbeatWriter(bus, name)
        hb.ready()
        hb.beat(progress=1, busy=True)
    HeartbeatWriter(bus, "ok0").beat(progress=2, busy=True)
    mon.refresh()
    mon._state["dead0"].last_ts -= 20
    mon._state["lock0"].progress_ts -= 5
    mon._state["ok0"].progress_ts = now["t"]
    states = dict(mon.unhealthy_pods())
    assert states["dead0"] == "dead"
    assert states["lock0"] == "livelocked"
    assert "ok0" not in states
    assert mon.dead_pods() == ["dead0"]
    mon.forget("dead0")
    assert "dead0" not in dict(mon.unhealthy_pods())
    assert mon.progress("lock0") == 1
    assert set(mon.heartbeat_times()) >= {"lock0", "ok0"}


def test_progress_ts_tracks_advancement_only(bus):
    now = {"t": time.time()}
    mon = _monitor(bus, now, liveness=100.0, livelock=2.0)
    hb = HeartbeatWriter(bus, "p0")
    hb.ready()
    hb.beat(progress=7, busy=True)
    for _ in range(5):
        hb.beat(progress=7, busy=True)
    now["t"] = time.time() + 3
    assert mon.status("p0") == "livelocked"


# ---------------------------------------------------------------------------
# the fleet's crash schedules (tests/test_fleet_chaos.py)
# ---------------------------------------------------------------------------

SEED_BASE = 777
ENGINE_KW = dict(max_len=96, max_slots=3, page_size=8, prefill_chunk=8,
                 prefix_sharing=True, seed=0, device="cpu")
TERMINAL = {"length", "stop", "cancelled", "rejected"}


@pytest.fixture(scope="module")
def smollm():
    cfg = reduced(ARCHS["smollm-360m"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


def _trace(seed: int, n: int = 9) -> list[dict]:
    """Bus payloads: a shared 16-token prefix on half, greedy and seeded
    top-k rows, some with ``seed=None`` (the supervisor stamps those),
    prompts spanning several chunk-8 steps, and one long stream."""
    rng = np.random.default_rng(seed)
    prefix = [int(x) for x in rng.integers(1, 250, 16)]
    payloads = []
    for i in range(n):
        body = [int(x) for x in rng.integers(1, 250, int(rng.integers(18, 30)))]
        payloads.append({
            "uid": f"c{i}",
            "prompt": (prefix if i % 2 == 0 else []) + body,
            "max_new_tokens": int(rng.integers(3, 7)),
            "temperature": 0.7 if i % 3 == 2 else 0.0,
            "top_k": 8 if i % 3 == 2 else 0,
            "seed": 1000 + i if i % 4 else None,
        })
    payloads.append({
        "uid": "long", "prompt": prefix + [7, 8, 9], "max_new_tokens": 18,
        "temperature": 0.7, "top_k": 8, "seed": 4242,
    })
    return payloads


def _oracle(cfg, params, payloads: list[dict]) -> dict[str, list[int]]:
    """Unperturbed single-engine replay of the payloads as the supervisor
    forwards them (unseeded ones stamped in ingress order)."""
    eng = ContinuousBatchingEngine(cfg, params, **ENGINE_KW)
    handles = {}
    for i, p in enumerate(payloads):
        q = dict(p)
        if q.get("seed") is None:
            q["seed"] = fleet_seed(SEED_BASE, i)
        h = eng.submit(request_from_message(q))
        assert not h.done, (q["uid"], h.error)
        handles[q["uid"]] = h
    while not eng.idle:
        eng.step()
    return {u: list(h.tokens) for u, h in handles.items()}


def _make_sup(tmp_path, cfg, params, injector) -> FleetSupervisor:
    fcfg = FleetConfig(workers=2, min_replicas=1, max_replicas=3,
                       target_lag_per_replica=4.0, scale_down_grace_s=0.3,
                       beat_interval_s=0.01, seed_base=SEED_BASE,
                       max_restarts=3)
    return FleetSupervisor(
        TopicBus(tmp_path / "bus"),
        lambda: ContinuousBatchingEngine(cfg, params, **ENGINE_KW), fcfg,
        injector=injector)


def _poll_until(sup, cond, timeout_s: float = 90.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.poll()
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError("condition not reached before timeout")


def _owner_name(sup, uid: str) -> str:
    pod_id = sup.states[uid].owner
    assert pod_id is not None
    return pod_id.rsplit("-a", 1)[0]


def _assert_recovered(sup, oracle, cancelled=frozenset()) -> None:
    """Typed terminals, streams equal to the oracle, each (uid, index)
    once on ``responses`` and before its single finish, no mismatched or
    gapped delta, autoscale decisions inside [1, max]."""
    states = sup.results()
    assert set(states) == set(oracle)
    for uid, st in states.items():
        assert st.finish_reason in TERMINAL, (uid, st.finish_reason)
        if uid in cancelled:
            assert st.finish_reason == "cancelled", uid
            assert st.tokens == oracle[uid][:len(st.tokens)], uid
        else:
            assert st.finish_reason in ("length", "stop"), (uid, st.error)
            assert st.tokens == oracle[uid], uid
    assert sup.metrics.mismatched_deltas == 0
    assert sup.metrics.gapped_deltas == 0
    deltas: dict[str, list] = {}
    finishes: dict[str, tuple] = {}
    for m in sup.bus.read("responses"):
        v = m.value
        if v["event"] == "delta":
            deltas.setdefault(v["uid"], []).append(
                (v["index"], v["token"], m.offset))
        else:
            assert v["uid"] not in finishes, f"{v['uid']}: duplicate finish"
            finishes[v["uid"]] = (v, m.offset)
    for uid, st in states.items():
        got = deltas.get(uid, [])
        assert [i for i, _, _ in got] == list(range(len(st.tokens))), uid
        assert [t for _, t, _ in got] == st.tokens, uid
        v, fin_off = finishes[uid]
        assert v["tokens"] == st.tokens and v["finish_reason"] == st.finish_reason
        if got:
            assert max(o for _, _, o in got) < fin_off, uid
    for e in sup.events.history("autoscale"):
        assert 1 <= e["new"] <= sup.cfg.max_replicas, e
        assert 1 <= e["old"] <= sup.cfg.max_replicas, e


def test_crash_mid_prefill(smollm, tmp_path):
    """The first worker to finish one engine step dies (prompts of 30+
    tokens against a chunk of 8: at most one chunk prefilled, no output):
    its requests replay elsewhere from token 0."""
    cfg, params = smollm
    payloads = _trace(0)
    injector = FaultInjector(
        worker_rules=[WorkerKillRule(after_steps=1, times=1)])
    sup = _make_sup(tmp_path, cfg, params, injector)
    try:
        for p in payloads:
            sup.submit(p)
        assert sup.run(expected=[p["uid"] for p in payloads], timeout_s=180)
    finally:
        sup.shutdown()
    assert injector.kills_armed() == 1
    assert sup.metrics.crashes >= 1 and sup.metrics.resubmitted >= 1
    assert any(st.resubmits > 0 for st in sup.states.values())
    _assert_recovered(sup, _oracle(cfg, params, payloads))


def test_crash_mid_decode(smollm, tmp_path):
    """Kill the long stream's owner once two of its tokens reached the
    client: the replacement resumes at the next undelivered index and the
    supervisor absorbs the regenerated prefix."""
    cfg, params = smollm
    payloads = _trace(1)
    injector = FaultInjector()
    sup = _make_sup(tmp_path, cfg, params, injector)
    try:
        for p in payloads:
            sup.submit(p)
        sup.start()
        _poll_until(sup, lambda: (
            "long" in sup.states
            and sup.states["long"].owner is not None
            and len(sup.states["long"].tokens) >= 2
            and sup.states["long"].finish_reason is None))
        delivered_at_kill = len(sup.states["long"].tokens)
        injector.worker_rules.append(
            WorkerKillRule(worker=_owner_name(sup, "long"), after_steps=0,
                           times=1))
        assert sup.run(expected=[p["uid"] for p in payloads], timeout_s=180)
    finally:
        sup.shutdown()
    assert injector.kills_armed() == 1
    long = sup.states["long"]
    assert long.resubmits >= 1, "owner survived: kill rule never fired"
    assert long.resume_from >= delivered_at_kill >= 2
    assert long.recovery_s is not None and long.recovery_s >= 0.0
    assert sup.metrics.recovery_s
    assert sup.metrics.duplicate_deltas >= delivered_at_kill
    _assert_recovered(sup, _oracle(cfg, params, payloads))


def test_crash_during_cancel(smollm, tmp_path):
    """Cancel the long stream, then kill its owner: it finishes
    ``cancelled`` with an oracle-prefix stream, is never resubmitted and
    never hangs."""
    cfg, params = smollm
    payloads = _trace(2)
    injector = FaultInjector()
    sup = _make_sup(tmp_path, cfg, params, injector)
    try:
        for p in payloads:
            sup.submit(p)
        sup.start()
        _poll_until(sup, lambda: (
            "long" in sup.states
            and sup.states["long"].owner is not None
            and sup.states["long"].finish_reason is None))
        assert sup.cancel("long")
        injector.worker_rules.append(
            WorkerKillRule(worker=_owner_name(sup, "long"), after_steps=0,
                           times=1))
        assert sup.run(expected=[p["uid"] for p in payloads], timeout_s=180)
    finally:
        sup.shutdown()
    assert injector.kills_armed() == 1
    assert sup.states["long"].resubmits == 0, "cancelled request resubmitted"
    _assert_recovered(sup, _oracle(cfg, params, payloads),
                      cancelled={"long"})


def test_role_worker_serves_the_work_topic(smollm, tmp_path):
    """``launch.serve --role worker`` in its own process drains a work
    topic that a supervisor elsewhere published, streaming deltas and
    finishes onto the fleet's events topic."""
    cfg, _ = smollm
    bus = TopicBus(tmp_path / "run" / "bus")
    for i in range(3):
        bus.publish("fleet.work", {"uid": f"w{i}", "prompt": [3, 4, 5 + i],
                                   "max_new_tokens": 3, "seed": i})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--role", "worker", "--worker-name", "wx",
         "--workdir", str(tmp_path / "run")],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "worker wx-a0:" in run.stdout and "clean=True" in run.stdout
    events = [m.value for m in bus.read("fleet.events")]
    finished = {v["uid"] for v in events if v["kind"] == "finish"}
    assert finished == {"w0", "w1", "w2"}
    assert sum(v["kind"] == "delta" for v in events) == 9
