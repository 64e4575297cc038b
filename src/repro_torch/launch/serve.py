"""Serving driver: a continuous-batching engine behind a bus topic,
streaming deltas.

Requests land on the ``requests`` topic (Kafka analogue). Worker threads
each drive one engine — :class:`repro_torch.serving.ContinuousBatchingEngine`
for the dense family (``--prefill-chunk 0``: whole-prompt prefill),
:class:`repro_torch.serving.SSMEngine` for the ssm (mamba2) and hybrid
(zamba2) families, :class:`repro_torch.serving.GenerationEngine` for
``--engine lockstep`` (dense, ssm and hybrid) —
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
  PYTHONPATH=src python -m repro_torch.launch.serve --engine lockstep \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --shared-prefix 32 --kv-quant int8 --host-pages 8 \\
      --persist-dir "$TMPDIR/kv"

The paged engine's KV cache is tiered: finished prompts' prefix pages park
on the device, spill under pressure to host RAM (``--host-pages N``) and
write through to an artifact store (``--persist-dir PATH``); each worker
flushes its parked pages there when it exits, so a rerun on the same
directory prefetches the prefixes back instead of prefilling them.
``--kv-quant int8`` stores the pages as int8 with f32 scales, dequantized
inside the paged kernels.

Only the driver role of the paged, lockstep and SSM engines is ported:
the moe and vlm families (ROADMAP A.7), encoder-decoder configs (A.11),
``--fleet`` and ``--role worker`` (A.9) raise or exit with a message
naming their ROADMAP item; the JAX package's mesh and speculation flags
have no counterpart yet (ROADMAP A.6, A.10).
"""

from __future__ import annotations

import argparse
import threading
import time
from pathlib import Path

_NOT_PORTED = {
    "fleet": "--fleet: the supervised fleet (ROADMAP A.9)",
    "role": "--role worker: fleet workers (ROADMAP A.9)",
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="a config of repro_torch.configs: dense (e.g. "
                         "smollm-360m: paged or lockstep), ssm (mamba2-1.3b) "
                         "or hybrid (zamba2-2.7b): the SSM engine, or "
                         "lockstep")
    ap.add_argument("--reduced", action="store_true")
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
    ap.add_argument("--fleet", type=int, default=0, metavar="N")
    ap.add_argument("--role", choices=["driver", "worker"], default="driver")
    ap.add_argument("--workdir", default="experiments/serve_run_torch")
    args = ap.parse_args()
    unported = {"fleet": args.fleet > 0, "role": args.role == "worker"}
    for flag, hit in unported.items():
        if hit:
            ap.exit(2, f"{ap.prog}: {_NOT_PORTED[flag]} is not ported yet\n")

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import TopicBus
    from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
    from repro_torch.core.events import EventLog
    from repro_torch.core.registry import ServiceRegistry
    from repro_torch.models import build_model
    from repro_torch.serving import (
        ContinuousBatchingEngine,
        DeadlineAdmission,
        FIFOAdmission,
        GenerationEngine,
        PriorityAdmission,
        SSMEngine,
        UnsupportedConfigError,
        format_latency,
        request_from_message,
    )
    from repro_torch.serving.metrics import UtilizationMetrics

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    ssm_ok = cfg.family in ("ssm", "hybrid")
    if cfg.is_encoder_decoder or not (ssm_ok or cfg.family == "dense"):
        raise UnsupportedConfigError(
            f"{cfg.name} (family={cfg.family!r}): the port serves the dense "
            f"(paged, lockstep), ssm and hybrid (SSM engine, lockstep) "
            f"families; moe/vlm wait for ROADMAP A.7, encoder-decoder for "
            f"A.11")
    use_ssm = args.engine == "paged" and ssm_ok
    use_paged = args.engine == "paged" and not ssm_ok
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    bus = TopicBus(workdir / "bus")
    events = EventLog(bus, workflow=f"serve-{cfg.name}")
    registry = ServiceRegistry(bus)

    params = build_model(cfg, device=args.device).init(seed=0)
    shared = list(range(2, 2 + args.shared_prefix))
    max_len = 64 + args.shared_prefix + args.max_new

    # ---- producer: enqueue requests (mixed sampling params, so the full
    # Request surface travels through the bus, not just uid/prompt) ----
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
            device=args.device,
        )

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
          f"peak workers={len(threads)}")
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


if __name__ == "__main__":
    raise SystemExit(main())
