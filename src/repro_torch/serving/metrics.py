"""Serving metrics: request latency summaries + per-step engine gauges.

Two kinds of measurement live here (single source for the
percentile/format logic used by ``launch/serve.py`` and
``benchmarks/run.py``):

* **Request-level latency** — ``ttft``/``itl`` are stamped per-request by
  the ``RequestHandle`` lifecycle machinery (``serving/api.py``), so every
  protocol engine — paged and lockstep alike — reports them; Results
  lacking latency data are skipped.
* **Per-step engine gauges** (:class:`UtilizationMetrics`) — decode-slot
  occupancy and page-pool utilization, recorded once per decode step by
  both engines. These answer the capacity questions request counters
  can't: is the decode batch actually full (occupancy), and is throughput
  page-bound or slot-bound (page utilization vs occupancy)?
  ``launch/serve.py`` prints both in its stats output.
* **Per-dispatch batch composition** (``record_batch``) — how each device
  dispatch divides its rows between decode, live prefill and padding, and
  what fraction of dispatches were fused (decode + chunk in one call).
  This is the observability knob for the fused mixed step: a low fused
  fraction under mixed load means the scheduler is starving one side;
  high padding means ``max_slots`` is oversized for the offered load.
* **KV tier gauges** (``record_tiers``) — per-step parked/host/persisted
  page counts plus deltas of the :class:`~repro_torch.serving.kv_tiers.
  KVTierManager` counters (tier hits, spill/prefetch bytes and seconds).
  This answers whether prefix reuse is actually landing (device vs host vs
  persisted hits) and what the spill traffic costs.
* **Speculation counters** (``record_spec``) — per-bundle proposed/
  accepted/rolled-back token counts. The acceptance rate is THE health
  metric for speculative decoding: the verify dispatch costs roughly one
  decode step regardless of k, so tokens/step ≈ 1 + accepted/bundle, and
  a rate near zero means speculation is pure overhead for this workload.
"""

from __future__ import annotations

import numpy as np


class UtilizationMetrics:
    """Per-decode-step occupancy/utilization gauges for one engine.

    ``record`` is called by the engine once per decode step with the
    number of actively decoding slots and (paged engine only) the page
    pool's in-use count. ``summary()`` aggregates to mean/peak fractions;
    ``merge`` combines trackers from multiple workers.
    """

    def __init__(self):
        self.slot_samples: list[float] = []   # decoding / total slots
        self.page_samples: list[float] = []   # pages in use / usable pages
        # per-dispatch batch composition (fused mixed step observability)
        self.dispatches = 0
        self.fused_dispatches = 0
        self.decode_rows = 0
        self.prefill_rows = 0
        self.padded_rows = 0
        # KV tier gauges (paged engine with tiers enabled): per-step page
        # counts per tier, plus the latest snapshot of the tier manager's
        # additive counters (one manager per engine, counters start at 0)
        self.parked_samples: list[int] = []
        self.host_samples: list[int] = []
        self.persist_samples: list[int] = []
        self._tier_latest: dict | None = None
        self._tier_merged: dict = {}
        # speculative decoding counters (additive, per verify bundle)
        self.spec_bundles = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0

    def record(self, *, active: int, slots: int,
               pages_used: int | None = None,
               pages_total: int | None = None) -> None:
        self.slot_samples.append(active / max(slots, 1))
        if pages_total:
            self.page_samples.append(pages_used / pages_total)

    def record_batch(self, *, decode_rows: int, prefill_rows: int,
                     padded_rows: int, fused: bool) -> None:
        """Record one device dispatch's row composition. ``fused`` marks a
        mixed dispatch (decode slots + a prefill chunk in one call)."""
        self.dispatches += 1
        self.fused_dispatches += int(fused)
        self.decode_rows += decode_rows
        self.prefill_rows += prefill_rows
        self.padded_rows += padded_rows

    def record_tiers(self, *, parked: int, host: int, persisted: int,
                     counters: dict) -> None:
        """Record one step's KV tier state: page counts per tier (gauges)
        plus a snapshot of the tier manager's additive counters. The tier
        manager is born with the engine and its counters start at zero, so
        the latest snapshot IS this engine's lifetime total — admissions
        that precede the first decode step (prefix queries, prefetches) are
        included, not baselined away."""
        self.parked_samples.append(parked)
        self.host_samples.append(host)
        self.persist_samples.append(persisted)
        self._tier_latest = dict(counters)

    def record_spec(self, *, proposed: int, accepted: int,
                    rollbacks: int) -> None:
        """Record one speculation bundle's outcome: ``proposed`` drafted
        tokens went into the verify dispatch, the leading ``accepted`` of
        them matched what the sampler produced, and the ``rollbacks``
        rejected tail positions were rewound (the bonus/correction token
        on top of ``accepted`` is a plain decode token, not counted
        here)."""
        self.spec_bundles += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.spec_rollbacks += rollbacks

    def _tier_deltas(self) -> dict:
        """This tracker's counter totals plus anything merged in."""
        out = dict(self._tier_merged)
        if self._tier_latest is not None:
            for key, val in self._tier_latest.items():
                out[key] = out.get(key, 0) + val
        return out

    def merge(self, other: "UtilizationMetrics") -> None:
        self.slot_samples.extend(other.slot_samples)
        self.page_samples.extend(other.page_samples)
        self.dispatches += other.dispatches
        self.fused_dispatches += other.fused_dispatches
        self.decode_rows += other.decode_rows
        self.prefill_rows += other.prefill_rows
        self.padded_rows += other.padded_rows
        self.parked_samples.extend(other.parked_samples)
        self.host_samples.extend(other.host_samples)
        self.persist_samples.extend(other.persist_samples)
        for key, val in other._tier_deltas().items():
            self._tier_merged[key] = self._tier_merged.get(key, 0) + val
        self.spec_bundles += other.spec_bundles
        self.spec_proposed += other.spec_proposed
        self.spec_accepted += other.spec_accepted
        self.spec_rollbacks += other.spec_rollbacks

    @property
    def steps(self) -> int:
        return len(self.slot_samples)

    def summary(self) -> dict | None:
        """Mean/peak slot occupancy, page utilization (fractions) and
        dispatch composition, or None when nothing was recorded."""
        if not self.slot_samples and not self.dispatches:
            return None
        out = {"decode_steps": len(self.slot_samples)}
        if self.slot_samples:
            out["slot_occupancy_mean"] = float(np.mean(self.slot_samples))
            out["slot_occupancy_peak"] = float(np.max(self.slot_samples))
        if self.page_samples:
            out["page_util_mean"] = float(np.mean(self.page_samples))
            out["page_util_peak"] = float(np.max(self.page_samples))
        if self.dispatches:
            rows = self.decode_rows + self.prefill_rows + self.padded_rows
            out["dispatches"] = self.dispatches
            out["fused_step_fraction"] = self.fused_dispatches / self.dispatches
            out["decode_rows"] = self.decode_rows
            out["prefill_rows"] = self.prefill_rows
            out["padded_rows"] = self.padded_rows
            out["padded_row_fraction"] = self.padded_rows / max(rows, 1)
        tiers = self._tier_deltas()
        if self.parked_samples or tiers:
            t: dict = {}
            if self.parked_samples:
                t["parked_pages_mean"] = float(np.mean(self.parked_samples))
                t["parked_pages_peak"] = int(np.max(self.parked_samples))
                t["host_pages_peak"] = int(np.max(self.host_samples))
                t["persisted_pages_peak"] = int(np.max(self.persist_samples))
            t.update(tiers)
            q = t.get("prefix_queries", 0)
            if q:
                # hits count PAGES revived, queries count admissions — the
                # quotient is cached pages served per prefix lookup, not a
                # 0..1 rate (a deep cached prefix yields many pages per hit)
                hits = (t.get("device_hits", 0) + t.get("host_hits", 0)
                        + t.get("persist_hits", 0))
                t["tier_hit_pages_per_query"] = hits / q
            out["kv_tiers"] = t
        if self.spec_bundles:
            out["speculation"] = {
                "bundles": self.spec_bundles,
                "tokens_proposed": self.spec_proposed,
                "tokens_accepted": self.spec_accepted,
                "rollbacks": self.spec_rollbacks,
                "acceptance_rate": (self.spec_accepted
                                    / max(self.spec_proposed, 1)),
                # +1: each bundle also emits its bonus/correction token
                "tokens_per_bundle": (self.spec_accepted / self.spec_bundles
                                      + 1.0),
            }
        return out

    def format(self) -> str:
        s = self.summary()
        if s is None:
            return "no_utilization_data"
        txt = "slot_occupancy_mean=n/a"
        if "slot_occupancy_mean" in s:
            txt = (f"slot_occupancy_mean={s['slot_occupancy_mean']:.0%}/"
                   f"peak={s['slot_occupancy_peak']:.0%}")
        if "page_util_mean" in s:
            txt += (f";page_util_mean={s['page_util_mean']:.0%}/"
                    f"peak={s['page_util_peak']:.0%}")
        txt += f";decode_steps={s['decode_steps']}"
        if "dispatches" in s:
            txt += (f";dispatches={s['dispatches']}"
                    f";fused_frac={s['fused_step_fraction']:.0%}"
                    f";rows=d{s['decode_rows']}/p{s['prefill_rows']}"
                    f"/pad{s['padded_rows']}")
        if "kv_tiers" in s:
            t = s["kv_tiers"]
            txt += (f";tiers=parked_peak{t.get('parked_pages_peak', 0)}"
                    f"/host_peak{t.get('host_pages_peak', 0)}"
                    f"/persist_peak{t.get('persisted_pages_peak', 0)}"
                    f";tier_hits=dev{t.get('device_hits', 0)}"
                    f"/host{t.get('host_hits', 0)}"
                    f"/pv{t.get('persist_hits', 0)}"
                    f";spilled={t.get('spilled_pages', 0)}"
                    f";prefetched={t.get('prefetched_pages', 0)}")
        if "speculation" in s:
            sp = s["speculation"]
            txt += (f";spec=bundles{sp['bundles']}"
                    f"/prop{sp['tokens_proposed']}"
                    f"/acc{sp['tokens_accepted']}"
                    f"/rb{sp['rollbacks']}"
                    f";accept_rate={sp['acceptance_rate']:.0%}"
                    f";tok_per_bundle={sp['tokens_per_bundle']:.2f}")
        return txt


class FleetMetrics:
    """Fleet-level supervision counters (``serving/fleet.py``).

    Where :class:`UtilizationMetrics` answers "is one engine full", this
    answers "what did fault tolerance cost": how many workers crashed or
    were restarted, how many in-flight requests were resubmitted, how many
    regenerated tokens the supervisor's index-dedupe suppressed (each one
    a token a client would otherwise have seen twice), and the recovery
    latency distribution (crash detected -> first token delivered past the
    crash boundary). ``mismatched_deltas``/``gapped_deltas`` must stay 0 —
    a nonzero count means a regenerated stream diverged from the original
    or skipped an index, i.e. the replay-identical recovery contract broke.
    """

    def __init__(self):
        self.crashes = 0            # workers that died or livelocked
        self.restarts = 0           # replacement attempts spawned
        self.resubmitted = 0        # in-flight requests replayed elsewhere
        self.duplicate_deltas = 0   # regenerated tokens dropped by dedupe
        self.mismatched_deltas = 0  # dup token != recorded token (MUST be 0)
        self.gapped_deltas = 0      # delta index skipped ahead (MUST be 0)
        self.direct_cancels = 0     # cancelled-during-crash finished by sup
        self.recovery_s: list[float] = []  # crash -> first resumed token

    def record_recovery(self, seconds: float) -> None:
        self.recovery_s.append(seconds)

    def summary(self) -> dict:
        out = {
            "crashes": self.crashes,
            "restarts": self.restarts,
            "resubmitted": self.resubmitted,
            "duplicate_deltas": self.duplicate_deltas,
            "mismatched_deltas": self.mismatched_deltas,
            "gapped_deltas": self.gapped_deltas,
            "direct_cancels": self.direct_cancels,
        }
        if self.recovery_s:
            out["recovery_s_mean"] = float(np.mean(self.recovery_s))
            out["recovery_s_max"] = float(np.max(self.recovery_s))
        return out

    def format(self) -> str:
        s = self.summary()
        txt = (f"crashes={s['crashes']};restarts={s['restarts']};"
               f"resubmitted={s['resubmitted']};"
               f"dedup={s['duplicate_deltas']}")
        if self.recovery_s:
            txt += (f";recovery_s_mean={s['recovery_s_mean']:.3f}"
                    f"/max={s['recovery_s_max']:.3f}")
        return txt


def latency_percentiles(results) -> dict | None:
    """p50/p90/p99 TTFT and inter-token latency (ms) + max ITL (the decode
    stall bound). Returns None when no result carries latency data."""
    ttfts = [r.ttft for r in results if getattr(r, "ttft", None) is not None]
    itls = [g for r in results for g in getattr(r, "itl", [])]
    if not ttfts or not itls:
        return None
    pt = np.percentile(ttfts, [50, 90, 99]) * 1e3
    pi = np.percentile(itls, [50, 90, 99]) * 1e3
    return {
        "ttft_ms": tuple(float(x) for x in pt),
        "itl_ms": tuple(float(x) for x in pi),
        "itl_ms_max": float(max(itls) * 1e3),
    }


def format_latency(results) -> str:
    """Compact ``k=p50/p90/p99``-style summary for bench rows and logs."""
    p = latency_percentiles(results)
    if p is None:
        return "no_latency_data"
    t, i = p["ttft_ms"], p["itl_ms"]
    return (f"ttft_ms_p50={t[0]:.1f}/p90={t[1]:.1f}/p99={t[2]:.1f};"
            f"itl_ms_p50={i[0]:.1f}/p90={i[1]:.1f}/p99={i[2]:.1f};"
            f"itl_ms_max={p['itl_ms_max']:.1f}")
