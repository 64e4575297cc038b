"""Serving driver: a continuous-batching engine behind a bus topic,
streaming deltas.

Requests land on the ``requests`` topic (Kafka analogue). Worker threads
each drive one engine — :class:`repro_torch.serving.ContinuousBatchingEngine`
for the dense, moe (dbrx-132b) and vlm (internvl2-26b) families
(``--prefill-chunk 0``: whole-prompt prefill, which vlm always takes),
:class:`repro_torch.serving.SSMEngine` for the ssm (mamba2) and hybrid
(zamba2) families, :class:`repro_torch.serving.GenerationEngine` for
``--engine lockstep`` (every decoder family and the encoder-decoder) —
through the engine protocol: pull up to
``engine.capacity()`` messages,
parse them with the shared boundary parser, ``submit()``, and publish each
:class:`StreamEvent` to ``responses`` as it happens — per-token ``delta``
messages first, then one terminal ``finish`` message. The HPA analogue
watches consumer lag and scales workers in [min, max]. The run prints
p50/p90/p99 time-to-first-token and inter-token latency plus the per-step
occupancy and page-pool gauges.

The model is the config's decoder with seeded random weights on
``--device`` (``cuda`` by default; ``--device cpu`` runs the plain
attention and SSD versions on the CPU, for tests and reduced configs):

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --requests 12 --shared-prefix 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \\
      --reduced --device cpu --step-mode interleaved
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --engine lockstep \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --engine lockstep --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --shared-prefix 32 --kv-quant int8 --host-pages 8 \\
      --persist-dir "$TMPDIR/kv"
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --spec draft --draft-config smollm-360m --spec-k 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --fleet 2

The paged engine's KV cache is tiered: finished prompts' prefix pages park
on the device, spill under pressure to host RAM (``--host-pages N``) and
write through to an artifact store (``--persist-dir PATH``); each worker
flushes its parked pages there when it exits, so a rerun on the same
directory prefetches the prefixes back instead of prefilling them.
``--kv-quant int8`` stores the pages as int8 with f32 scales, dequantized
inside the paged kernels. ``--spec ngram|draft`` turns on speculative
decoding in the paged engine (``--spec-k`` drafts a bundle; ``--spec
draft`` drafts with ``--draft-config``'s model on seeded weights, reduced
with the target under ``--reduced``); streams are those of ``--spec off``.

``--fleet N`` runs the supervised fleet (``serving/fleet.py``) instead of
the flat worker pool: N engine workers, threads of this process that share
the read-only weights and each build their own engine and page pool on
``--device``, with heartbeat probes, crash replay and autoscaling.
``--role worker --worker-name NAME`` runs one fleet worker loop against an
existing ``--workdir`` bus, whose supervisor runs elsewhere.

``--layers N`` cuts the depth at full width (``--arch dbrx-132b --layers
4`` serves a 28.5 GB model on one card). An encoder-decoder config
(whisper-tiny) without ``--engine lockstep``
raises ``UnsupportedConfigError`` (no continuous-batching engine serves
it), as in the JAX driver. The engines' ``max_len`` is the JAX driver's
plus a vlm's ``num_frontend_tokens``, so its requests fit after the
vision positions.

The paged and SSM engines run on a ``("model",)`` mesh of ranks (tensor
parallelism, ``serving/executor.py``): ``--mesh auto`` (default) picks the
largest degree the model's head counts allow over the local cards (1 on
one card, and on ``--device cpu``: nothing is spawned), ``--mesh N``
forces N ranks (on ``--device cpu``, N CPU processes; on ``cuda``, the
first N cards). Rank 0 is this process; the others are spawned once and
serve every worker's steps. The weights are cut into the ranks' slices
once, and every worker's engine shares them. Workers (the flat pool's, up
to 4, and ``--fleet``'s) are threads that share the one mesh: each
engine's executor has its own id on the followers, and the group's lock
takes their calls one at a time. The host and persisted KV tiers live on
rank 0 and hold whole pages (every rank's heads), and ``--spec draft``'s
model runs whole on rank 0. The summary line names the mesh
(``mesh=model=2``); lockstep prints ``mesh=n/a``:

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --mesh 2 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --mesh 2 --fleet 2
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from pathlib import Path

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="a config of repro_torch.configs: dense (e.g. "
                         "smollm-360m), moe (dbrx-132b) or vlm "
                         "(internvl2-26b): paged or lockstep; ssm "
                         "(mamba2-1.3b) or hybrid (zamba2-2.7b): the SSM "
                         "engine, or lockstep")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the model's depth to N layers at full width "
                         "(dbrx-132b fits one card at 4 of its 40); 0 keeps "
                         "the config's")
    ap.add_argument("--device", default="cuda",
                    help="where the model, page pool and steps live "
                         "('cuda' needs a card; 'cpu' runs the plain "
                         "attention versions)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="lockstep micro-batch size / paged slot count")
    ap.add_argument("--engine", choices=["paged", "lockstep"], default="paged")
    ap.add_argument("--admission", choices=["fifo", "priority", "deadline"],
                    default="fifo", help="admission policy for every worker")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prefill chunk size; 0 prefills each prompt whole "
                         "(paged: one flash-kernel prefill per admission, "
                         "no prefix sharing; SSM: one max_len chunk)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable COW prefix-page sharing")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend a common N-token prefix to every request "
                         "(pipeline-rerun workload; exercises prefix sharing)")
    ap.add_argument("--step-mode", default="fused",
                    choices=["fused", "interleaved"],
                    help="'fused' (default) runs every decode slot and the "
                         "step's prefill chunk in ONE mixed dispatch; "
                         "'interleaved' keeps the two-dispatch step — "
                         "streams are byte-identical either way")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="fused mode: cap decode rows + chunk tokens per "
                         "step; 0 disables the cap")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="paged engine: KV page precision; 'int8' stores "
                         "pages as int8 with one f32 scale per (position, kv "
                         "head), dequantized inside the paged kernels")
    ap.add_argument("--host-pages", type=int, default=0, metavar="N",
                    help="paged engine: host-RAM tier capacity in pages for "
                         "reclaimed prefix pages; 0 disables it")
    ap.add_argument("--persist-dir", default=None, metavar="PATH",
                    help="paged engine: ArtifactStore root for write-through "
                         "prefix-page persistence; a rerun on the same PATH "
                         "reloads the prefixes instead of prefilling them")
    ap.add_argument("--attn-impl", default="auto", choices=["auto", "ref"],
                    help="'auto': the CUDA kernels for tensors on the card, "
                         "the plain versions on the CPU; 'ref': the plain "
                         "versions everywhere")
    ap.add_argument("--ssd-impl", default="auto", choices=["auto", "ref"],
                    help="the same choice for the SSD scan and decode step "
                         "(SSM engine and lockstep)")
    ap.add_argument("--spec", default="off",
                    choices=["off", "ngram", "draft"],
                    help="paged engine: speculative decoding proposer; "
                         "'ngram' drafts from the request's own history, "
                         "'draft' runs a draft model (--draft-config) on its "
                         "own page pool; streams equal 'off' either way")
    ap.add_argument("--spec-k", type=int, default=4, metavar="K",
                    help="speculative decoding: drafted tokens per bundle")
    ap.add_argument("--draft-config", default=None, metavar="ARCH",
                    help="--spec draft: the draft model's arch ('-reduced' "
                         "suffix honored, and --reduced reduces it too), on "
                         "seeded weights")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="run the supervised fleet with N initial engine "
                         "workers (heartbeat probes, crash replay, "
                         "autoscaling) instead of the flat worker pool")
    ap.add_argument("--role", choices=["driver", "worker"], default="driver",
                    help="'worker': run ONE fleet worker loop against an "
                         "existing --workdir bus and exit when its work "
                         "topic drains")
    ap.add_argument("--worker-name", default="w0",
                    help="--role worker: this worker's pod name")
    ap.add_argument("--mesh", default="auto",
                    help="paged/SSM engine: tensor-parallel mesh size — "
                         "'auto' picks the largest degree the model's head "
                         "counts allow over the local cards (1 on one card "
                         "or the CPU); N forces N ranks (CPU processes on "
                         "--device cpu, the first N cards on cuda)")
    ap.add_argument("--workdir", default="experiments/serve_run_torch")
    args = ap.parse_args()

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import describe_mesh, make_serving_mesh
    from repro_torch.serving import UnsupportedConfigError
    from repro_torch.serving.executor import (resolve_serving_mesh,
                                              set_default_serving_mesh,
                                              validate_serving_mesh)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    ssm_ok = not cfg.is_encoder_decoder and cfg.family in ("ssm", "hybrid")
    paged_ok = not cfg.is_encoder_decoder and cfg.family in ("dense", "moe",
                                                             "vlm")
    if args.engine == "paged" and not (paged_ok or ssm_ok):
        # no silent lockstep downgrade: the caller asked for continuous
        # batching, and neither the page-pool nor the recurrent-state
        # engine can serve this config
        raise UnsupportedConfigError(
            f"no continuous-batching engine supports {cfg.name} "
            f"(family={cfg.family!r}, encoder_decoder="
            f"{cfg.is_encoder_decoder}); pass --engine lockstep to serve "
            f"it with the micro-batching baseline")
    use_ssm = args.engine == "paged" and ssm_ok
    use_paged = args.engine == "paged" and paged_ok
    # the mesh, validated ONCE here (a bad --mesh N fails fast) and set as
    # the default every engine builds on
    mesh, mesh_desc = None, "n/a"
    if use_paged or use_ssm:
        if args.mesh == "auto":
            mesh, _ = resolve_serving_mesh(cfg, args.device)
        else:
            n = int(args.mesh)
            mesh = make_serving_mesh(
                n, devices=[args.device] * n
                if args.device.startswith("cpu") else None)
        validate_serving_mesh(cfg, mesh)
        mesh_desc = describe_mesh(mesh)
        set_default_serving_mesh(mesh)
    try:
        return _serve(args, cfg, mesh, mesh_desc, use_ssm, use_paged)
    finally:
        if mesh is not None:
            set_default_serving_mesh(None)
            mesh.close()


def _serve(args, cfg, mesh, mesh_desc: str, use_ssm: bool,
           use_paged: bool) -> int:
    from repro_torch.core import TopicBus
    from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
    from repro_torch.core.events import EventLog
    from repro_torch.core.registry import ServiceRegistry
    from repro_torch.models import build_model, frontend_len
    from repro_torch.serving import (
        ContinuousBatchingEngine,
        DeadlineAdmission,
        FIFOAdmission,
        GenerationEngine,
        PriorityAdmission,
        SSMEngine,
        format_latency,
        request_from_message,
    )
    from repro_torch.serving.metrics import UtilizationMetrics

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    bus = TopicBus(workdir / "bus")
    events = EventLog(bus, workflow=f"serve-{cfg.name}")
    registry = ServiceRegistry(bus)

    params = build_model(cfg, device=args.device).init(seed=0)
    if mesh is not None and mesh.size > 1:
        # every rank's slices cut once: the workers' engines share them
        from repro_torch.serving.executor import place_serving_params

        params = place_serving_params(cfg, params, mesh)
    shared = list(range(2, 2 + args.shared_prefix))
    max_len = 64 + args.shared_prefix + args.max_new + frontend_len(cfg)

    # ---- producer: enqueue requests (mixed sampling params, so the full
    # Request surface travels through the bus, not just uid/prompt) ----
    if args.role == "driver":
        for i in range(args.requests):
            bus.publish(
                "requests",
                {"uid": f"r{i}",
                 "prompt": shared + [1 + (i % 30), 2, 3 + (i % 7)],
                 "max_new_tokens": args.max_new,
                 "temperature": 0.7 if i % 4 == 3 else 0.0,
                 "seed": i,
                 "priority": i % 3},
            )

    group = "servers"
    scaler = Autoscaler(
        bus, "requests", group,
        AutoscalerConfig(min_replicas=1, max_replicas=4,
                         target_lag_per_replica=args.max_batch * 2),
        events=events,
    )
    policies = {"fifo": FIFOAdmission, "priority": PriorityAdmission,
                "deadline": DeadlineAdmission}

    # --reduced shrinks the target; a draft arch named on the CLI shrinks
    # with it, or the "small" draft model is full-size
    draft_config = args.draft_config
    if draft_config and args.reduced and not draft_config.endswith("-reduced"):
        draft_config = f"{draft_config}-reduced"

    def make_engine():
        if args.engine == "lockstep":
            return GenerationEngine(
                cfg, params, max_len=max_len, max_batch=args.max_batch,
                admission=policies[args.admission](),
                attn_impl=args.attn_impl, ssd_impl=args.ssd_impl,
                device=args.device,
            )
        if use_ssm:
            return SSMEngine(
                cfg, params, max_len=max_len,
                max_slots=max(args.max_batch, 2),
                prefill_chunk=args.prefill_chunk or None,
                admission=policies[args.admission](),
                attn_impl=args.attn_impl,
                ssd_impl=args.ssd_impl,
                device=args.device,
            )
        return ContinuousBatchingEngine(
            cfg, params, max_len=max_len,
            max_slots=max(args.max_batch, 2),
            prefill_chunk=args.prefill_chunk or None,
            prefix_sharing=not args.no_prefix_sharing,
            admission=policies[args.admission](),
            attn_impl=args.attn_impl,
            step_mode=args.step_mode,
            token_budget=args.token_budget or None,
            kv_quant=args.kv_quant,
            host_pages=args.host_pages,
            persist_dir=args.persist_dir,
            speculative=args.spec,
            spec_k=args.spec_k,
            draft_config=draft_config,
            device=args.device,
        )

    if args.role == "worker":
        return _run_worker(args, bus, make_engine)
    if args.fleet:
        return _run_fleet(args, bus, events, make_engine, mesh_desc)

    done: dict[str, list[int]] = {}
    latencies: list = []  # Results, for TTFT/ITL percentiles
    utilization = UtilizationMetrics()  # merged across workers
    lock = threading.Lock()
    errors: list[BaseException] = []

    def finish(uid: str, result) -> None:
        """Publish one terminal response and record it for the main thread."""
        bus.publish("responses", {
            "uid": uid, "event": "finish",
            "tokens": result.tokens if result else [],
            "finish_reason": result.finish_reason.value if result else "rejected",
            "error": result.error if result else None,
        })
        with lock:
            done[uid] = result.tokens if result else []
            if result is not None:
                latencies.append(result)

    def worker(wid: int, stop: threading.Event):
        """THE worker loop: protocol-driven, streaming. A failure is kept
        for the main thread to raise, never swallowed."""
        try:
            engine = make_engine()
            registry.register("generate", f"pod://server-{wid}",
                              f"server-{wid}")
            try:
                _worker_loop(engine, stop, {})
            finally:
                cache = getattr(engine, "cache", None)
                if cache is not None and cache.tiers is not None:
                    # drain parked prefixes to host/persist so a rerun on
                    # the same --persist-dir revives them across restarts
                    cache.flush_tiers()
                    engine._record_tiers()  # fold the flush into the gauges
                engine.close()
                with lock:
                    utilization.merge(engine.utilization)
        except BaseException as e:  # re-raised by main() below
            with lock:
                errors.append(e)
            stop.set()

    def _worker_loop(engine, stop, handles):
        while not stop.is_set():
            pulled = 0
            for m in bus.consume("requests", group, limit=engine.capacity()):
                try:
                    req = request_from_message(m.value)
                except (ValueError, KeyError, TypeError) as e:
                    v = m.value
                    uid = v.get("uid", "?") if isinstance(v, dict) else "?"
                    bus.publish("responses", {
                        "uid": str(uid), "event": "finish", "tokens": [],
                        "finish_reason": "rejected", "error": str(e),
                    })
                    with lock:
                        done[str(uid)] = []
                else:
                    h = engine.submit(req)
                    if h.done:  # rejected at the API boundary
                        finish(h.uid, h.result())
                    else:
                        handles[h.uid] = h
                        pulled += 1
                bus.commit("requests", group, m.offset + 1)
            if engine.idle:
                if not pulled and bus.lag("requests", group) == 0:
                    return
                time.sleep(0.01)
                continue
            for ev in engine.step():
                if ev.kind == "token":
                    bus.publish("responses", {
                        "uid": ev.uid, "event": "delta",
                        "token": ev.token, "index": ev.index,
                    })
                elif ev.kind == "finish":
                    h = handles.pop(ev.uid, None)
                    finish(ev.uid, h.result() if h else None)

    threads: list[threading.Thread] = []
    stop = threading.Event()
    t0 = time.time()
    while (len(done) < args.requests and time.time() - t0 < 600
           and not errors):
        desired, _ = scaler.observe()
        while len([t for t in threads if t.is_alive()]) < desired:
            t = threading.Thread(target=worker, args=(len(threads), stop),
                                 daemon=True)
            t.start()
            threads.append(t)
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    if errors:
        raise errors[0]

    wall = time.time() - t0
    kind = "paged" if use_paged else "ssm" if use_ssm else "lockstep"
    print(f"served {len(done)}/{args.requests} requests in {wall:.1f}s "
          f"({len(done)*args.max_new/wall:.1f} tok/s), engine={kind}, "
          f"device={args.device}, admission={args.admission}, "
          f"mesh={mesh_desc}, peak workers={len(threads)}")
    summary = format_latency(latencies)
    if summary != "no_latency_data":
        print(summary)
    print("utilization:", utilization.format())
    autoscales = events.history("autoscale")
    print("autoscale events:", [(e["old"], e["new"]) for e in autoscales])
    assert len(done) == args.requests

    # streaming invariant: every served request's first delta is observable
    # on the bus BEFORE its terminal finish message
    first_delta: dict[str, int] = {}
    finish_at: dict[str, int] = {}
    for m in bus.read("responses"):
        uid, event = m.value["uid"], m.value["event"]
        if event == "delta":
            first_delta.setdefault(uid, m.offset)
        elif event == "finish":
            finish_at[uid] = m.offset
    streamed = [u for u, toks in done.items() if toks]
    assert all(first_delta[u] < finish_at[u] for u in streamed), \
        "deltas must precede completion on the bus"
    print(f"streaming: {sum(len(t) for t in done.values())} deltas published "
          f"before {len(finish_at)} completions")
    return 0


def _run_fleet(args, bus, events, make_engine, mesh_desc: str) -> int:
    """Supervised-fleet driver: FleetSupervisor + N engine workers with
    probes, crash-replay recovery and autoscaling (``serving/fleet.py``)."""
    from repro_torch.serving.fleet import FleetConfig, FleetSupervisor

    fcfg = FleetConfig(
        workers=args.fleet,
        min_replicas=1,
        max_replicas=max(args.fleet, 4),
        target_lag_per_replica=args.max_batch * 2,
    )
    sup = FleetSupervisor(bus, make_engine, fcfg, events=events)
    expected = [f"r{i}" for i in range(args.requests)]
    t0 = time.time()
    ok = sup.run(expected=expected, timeout_s=600)
    wall = time.time() - t0
    sup.shutdown()
    states = sup.results()
    n_tokens = sum(len(s.tokens) for s in states.values())
    print(f"fleet served {len(states)}/{args.requests} requests in "
          f"{wall:.1f}s ({n_tokens / wall:.1f} tok/s), "
          f"workers={args.fleet}+auto, mesh={mesh_desc}, "
          f"supervision: {sup.metrics.format()}")
    autoscales = events.history("autoscale")
    print("autoscale events:", [(e["old"], e["new"]) for e in autoscales])
    assert ok, "fleet run timed out with requests still in flight"

    # same streaming invariant as the flat pool: every streamed request's
    # first delta precedes its terminal finish on the responses topic
    first_delta: dict[str, int] = {}
    finish_at: dict[str, int] = {}
    for m in bus.read("responses"):
        uid, event = m.value["uid"], m.value["event"]
        if event == "delta":
            first_delta.setdefault(uid, m.offset)
        elif event == "finish":
            finish_at[uid] = m.offset
    streamed = [u for u, s in states.items() if s.tokens]
    assert all(first_delta[u] < finish_at[u] for u in streamed), \
        "deltas must precede completion on the bus"
    print(f"streaming: {n_tokens} deltas published before "
          f"{len(finish_at)} completions")
    return 0


def _run_worker(args, bus, make_engine) -> int:
    """Standalone fleet worker: the multi-process deployment shape. A
    supervisor in another process (same ``--workdir`` bus) publishes
    ``fleet.work``; this process serves it until the topic drains."""
    from repro_torch.serving.fleet import (
        EngineWorker,
        FleetConfig,
        WORK_TOPIC,
        WORKER_GROUP,
    )

    w = EngineWorker(args.worker_name, 0, bus, make_engine,
                     threading.Lock(), FleetConfig(workers=1, autoscale=False))
    w.start()
    idle_since = None
    while w.thread.is_alive():
        busy = bus.lag(WORK_TOPIC, WORKER_GROUP) > 0 or w.inflight
        idle_since = None if busy else (idle_since or time.time())
        if idle_since is not None and time.time() - idle_since > 2.0:
            w.retire()
            break
        time.sleep(0.05)
    w.thread.join(timeout=30)
    print(f"worker {w.pod_id}: steps={w.steps_run} "
          f"tokens={w.tokens_emitted} clean={w.stopped_cleanly}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
