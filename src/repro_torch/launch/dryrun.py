"""Multi-pod dry run of the port: count every (arch x shape x mesh) cell.

The port of ``repro/launch/dryrun.py``. Per cell it builds the step on
meta tensors (``launch/builders.py``: no allocation, no process started,
no card needed), counts it (``analysis/cost.py``: FLOPs, unfused and
kernelized HBM bytes, peak live bytes), adds the collectives from the
sharding, derives the three roofline terms for the NVIDIA H100
(``analysis/roofline.py``), states each rank's bytes against the card's
memory, and writes one JSON record (the JAX package's keys; ``fits_16gib``
is ``fits_hbm``) under ``experiments/dryrun_torch/``. Each (arch, shape)
is counted once per microbatch size, and the count serves both meshes.
``--all`` sweeps the 40 cells on both meshes (a full-attention arch's
``long_500k`` is recorded as a skip), records a cell's error and goes on,
and exits non-zero if any cell failed. The last lines are a table of the
cells run.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

# (config, shape, ga, rows) -> (StepCost, the arguments it read): one
# count per microbatch size, for every mesh
_COUNTS: dict = {}


def parse_rules(spec: str | None) -> dict:
    """--rules "embed=none,vocab=model" -> {"embed": None, "vocab": "model"}."""
    if not spec:
        return {}
    out = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if v in ("none", "None", ""):
            out[k] = None
        elif "+" in v:
            out[k] = tuple(v.split("+"))
        else:
            out[k] = v
    return out


def _count(plan, rows: int):
    from repro_torch.launch.builders import count_cell, used_arguments

    key = (plan.cfg, plan.shape, plan.meta["ga"], rows)
    if key not in _COUNTS:
        cost = count_cell(plan, rows)
        _COUNTS[key] = cost, used_arguments(plan, cost)
    return _COUNTS[key]


def _write(rec: dict, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"_{rec['tag']}" if rec["tag"] else ""
    fp = out_dir / f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json"
    fp.write_text(json.dumps(rec, indent=1, default=str))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             ga: int | None = None, rules_patch: dict | None = None,
             tag: str = "", pad_heads: str | None = None,
             remat: str | None = None) -> dict:
    import dataclasses

    from repro_torch.analysis.cost import StepCost
    from repro_torch.analysis.roofline import (HW, model_flops_per_chip,
                                               roofline_terms)
    from repro_torch.configs import cell_supported, get_arch, get_shape
    from repro_torch.launch import builders
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import DEFAULT_RULES

    cfg = get_arch(arch)
    if pad_heads:
        hq, _, hkv = pad_heads.partition(",")
        cfg = dataclasses.replace(cfg, num_heads_padded=int(hq),
                                  num_kv_heads_padded=int(hkv or 0))
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    shape = get_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "tag": tag}

    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec["status"] = "skip"
        rec["reason"] = reason
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: {reason}")
        _write(rec, out_dir)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    n = mesh.size
    rules = dict(DEFAULT_RULES)
    if rules_patch:
        rules.update(rules_patch)
    hw = HW()
    try:
        t0 = time.time()
        plan = builders.lower_cell(cfg, shape, mesh, rules=rules, ga=ga)
        t_lower = time.time() - t0
        t0 = time.time()
        ga_ = plan.meta["ga"]
        micro = shape.global_batch // ga_
        rows = builders.rank_batch(plan)
        cost, used = _count(plan, micro)
        peak = _count(plan, rows)[0]
        t_count = time.time() - t0
        arg_b = builders.argument_bytes(plan, used)
        res_b = builders.resident_bytes(plan)

        coll, n_coll = builders.collectives(plan, rows)
        rank = StepCost(flops=cost.flops / n, hbm_bytes=cost.hbm_bytes / n,
                        hbm_bytes_kernelized=cost.hbm_bytes_kernelized / n,
                        collective_bytes=coll, collective_count=n_coll)
        mf = model_flops_per_chip(cfg, shape, n)
        terms = roofline_terms(rank, hw, model_flops_per_chip=mf)
        hbm_need = arg_b + res_b + peak.peak_bytes
        fits = hbm_need <= hw.hbm_per_chip
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} "
              f"(build {t_lower:.1f}s, count {t_count:.1f}s)")
        print(f"  per-rank bytes: args={arg_b / 2**30:.2f}GiB "
              f"resident={res_b / 2**30:.2f}GiB "
              f"peak={peak.peak_bytes / 2**30:.2f}GiB (upper bound: "
              f"{rows} sequences, full width) -> need "
              f"{hbm_need / 2**30:.2f}GiB / "
              f"{hw.hbm_per_chip / 2**30:.2f}GiB "
              f"{'OK' if fits else 'OVER'}")
        print(f"  roofline: compute={terms.compute_s * 1e3:.2f}ms "
              f"memory={terms.memory_s * 1e3:.2f}ms "
              f"(unfused {terms.memory_xla_s * 1e3:.2f}ms) "
              f"collective={terms.collective_s * 1e3:.2f}ms "
              f"dominant={terms.dominant} "
              f"useful={terms.useful_flops_ratio:.2f}")

        rec.update(
            status="ok",
            lower_s=round(t_lower, 2),
            compile_s=round(t_count, 2),
            memory={
                "argument_bytes": arg_b,
                "output_bytes": peak.output_bytes,
                "temp_bytes": peak.peak_bytes - peak.output_bytes,
                "alias_bytes": 0,
                "resident_bytes": res_b,
                "hbm_needed_bytes": hbm_need,
                "fits_hbm": bool(fits),
            },
            # an eager step has no loop body counted once: the unfused
            # counts of the global step, per rank
            xla_cost={
                "flops_body_once": rank.flops,
                "bytes_body_once": rank.hbm_bytes,
            },
            analyzer={
                "flops": rank.flops,
                "hbm_bytes": rank.hbm_bytes,
                "hbm_bytes_kernelized": rank.hbm_bytes_kernelized,
                "collective_bytes": coll,
                "collective_count": n_coll,
                "while_trips": {},
                "kernel_regions": cost.regions,
                "kernel_region_flops": cost.region_flops / n,
            },
            roofline=terms.as_row(),
            meta={**plan.meta,
                  "counted": (f"the step: one microbatch of {micro} "
                              f"sequences x ga {ga_}, the update once, / {n} "
                              f"ranks (ideal split); peak at {rows} "
                              f"sequences a rank, full width (upper bound)"),
                  "micro_rows": micro, "peak_rows": rows},
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-3000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} FAILED: "
              f"{rec['error']}")

    _write(rec, out_dir)
    return rec


def table(recs: list[dict]) -> str:
    """The cells as markdown, one table a mesh, an arch a row and a shape
    a column: each rank's GB (arguments + resident + peak) against the
    card's, then the dominant term and the compute / memory / collective
    terms in ms."""
    from repro_torch.analysis.roofline import HW

    cap = HW().hbm_per_chip / 1e9
    out = []
    for mesh in dict.fromkeys(r["mesh"] for r in recs):
        rows = [r for r in recs if r["mesh"] == mesh]
        shapes = list(dict.fromkeys(r["shape"] for r in rows))
        out += [f"{mesh} (GB a rank of {cap:.1f}; dominant; compute / "
                f"memory / collective ms)", "",
                "| arch | " + " | ".join(shapes) + " |",
                "| --- |" + " --- |" * len(shapes)]
        for arch in dict.fromkeys(r["arch"] for r in rows):
            cells = []
            for shape in shapes:
                r = next(x for x in rows
                         if x["arch"] == arch and x["shape"] == shape)
                if r["status"] == "skip":
                    cells.append("skip")
                    continue
                if r["status"] != "ok":
                    cells.append(r["status"])
                    continue
                m, t = r["memory"], r["roofline"]
                cells.append(
                    f"{m['hbm_needed_bytes'] / 1e9:.1f}"
                    f"{'' if m['fits_hbm'] else ' OVER'}; {t['dominant']}; "
                    f"{t['compute_s'] * 1e3:.1f} / {t['memory_s'] * 1e3:.1f}"
                    f" / {t['collective_s'] * 1e3:.1f}")
            out.append(f"| {arch} | " + " | ".join(cells) + " |")
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ga", type=int, default=None)
    ap.add_argument("--rules", default=None,
                    help='rule patches, e.g. "embed=none" (drop FSDP)')
    ap.add_argument("--pad-heads", default=None,
                    help='pad head counts, e.g. "48,12" (q,kv)')
    ap.add_argument("--remat", default=None,
                    help='override remat policy, e.g. "group8"')
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, SHAPES

    out_dir = Path(args.out)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    n_bad = 0
    recs = []
    t0 = time.time()
    for arch, shape in cells:
        for multi in meshes:
            rec = run_cell(arch, shape, multi, out_dir, ga=args.ga,
                           tag=args.tag, rules_patch=parse_rules(args.rules),
                           pad_heads=args.pad_heads, remat=args.remat)
            recs.append(rec)
            if rec["status"] == "error":
                n_bad += 1
    print(table(recs))
    print(f"[dryrun] done in {time.time() - t0:.0f}s, {n_bad} failures")
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
