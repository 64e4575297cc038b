#!/usr/bin/env python3
"""The flash backward's bf16 kernels on the card: what ptxas made of them,
and where one call's device time goes.

Builds ``csrc/flash_backward.cu`` and prints what ptxas says of each bf16
kernel (registers, spills, wgmma serialisation), the highest register and
the count of wgmma and of their waits in each kernel's machine code (by
``cuobjdump``), and the card's figures for each
(``flash_attention_backward_info``). Then profiles one backward call at
each of ``chip_smoke.py``'s phase 28 shapes (FLASH_TRAIN_SHAPES and
FLASH_BWD_WIDTHS; causal, bf16): device time per kernel (torch.profiler),
and each kernel's share of the card's rate. A tensor-core kernel's share is
the FLOPs of its products on the attended (query, key) pairs (2 D a head a
pair each; the dK/dV kernel's four products S^T, dP^T, dV, dK, the dQ
kernel's three, S, dP, dQ) over its time and the data-sheet bf16 rate; the
di kernel's is the bytes it must move (o and dO read, di written) over the
memory rate. The rates are ``repro_torch.analysis.roofline.HW``'s. The
first line is the card's name and power limit. The gradients themselves
are checked by ``pytest -m cuda tests/test_torch_kernels_cuda.py`` and by
``chip_smoke.py`` phase 28.

With ``--step`` it times, instead of the profile, phase 38's smollm-360m
``train_4k`` step (full width, B 4 x S 4096, built by
``chip_smoke._dryrun_step``): one warm step, then STEPS steps on the host
clock around the step and a synchronise, as phase 38 times them.

    python tools/flash_bwd_probe.py            # from the repository root, on a CUDA machine
    python tools/flash_bwd_probe.py --src build/parent/src   # another checkout's kernels
    python tools/flash_bwd_probe.py --step --src build/parent/src   # its train_4k step
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# --src DIR: the package of another checkout (an earlier commit's, to
# profile its kernels in the same call); its kernels build under that
# checkout. It is imported before chip_smoke, whose own ``src`` then only
# supplies the shapes.
SRC = (Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
       if "--src" in sys.argv else ROOT / "src")
sys.path.insert(0, str(SRC))

from repro_torch.analysis.roofline import HW  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402

sys.path.insert(0, str(ROOT))
from chip_smoke import (D, DRYRUN_CELLS, FLASH_BWD_WIDTHS,  # noqa: E402
                        FLASH_H, FLASH_TRAIN_SHAPES, KVH, _dryrun_step,
                        card_line)

STEPS = 5

# kernel -> the products it runs on the tensor cores
PRODUCTS = {"flash_bwd_dkdv_wgmma_kernel": 4, "flash_bwd_dq_wgmma_kernel": 3}


def report_build() -> None:
    t0 = time.perf_counter()
    build.load("flash_backward")
    log = build.build_log.get("flash_backward", "")
    print(f"build {time.perf_counter() - t0:.1f} s")
    parts = re.split(r"Compiling entry function '(\w+)'", log)
    for name, body in zip(parts[1::2], parts[2::2]):
        if "mma_kernel" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        print(f"ptxas {name}: {regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes spill stores")
    for line in log.splitlines():
        if "arning" in line or "rror" in line or "Potential" in line:
            print("ptxas:", line.strip())
    # the highest register each kernel's machine code names (setmaxnreg
    # lets a consumer warpgroup go past the launch's count)
    try:
        sass = subprocess.run(
            [str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
             str(build.library_path("flash_backward"))],
            capture_output=True, text=True, timeout=120).stdout
        for name, body in zip(*[iter(re.split(
                r"Function : (\S+)", sass)[1:])] * 2):
            if "wgmma" in name:
                regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
                short = re.sub(r".*(flash_bwd_\w+?kernel)ILi(\d+).*",
                               r"\1 D \2", name)
                print(f"sass {short}: highest register R{max(regs)}, "
                      f"{body.count('WARPGROUP.DEPBAR')} wgmma waits, "
                      f"{body.count('HGMMA')} wgmma")
    except (OSError, subprocess.SubprocessError) as e:
        print(f"cuobjdump failed: {e}")
    fn = fk._backward_library().flash_attention_backward_info
    info = (ctypes.c_int * 4)()
    for d in (64, 80, 128):
        for which, kind in enumerate(("dkdv", "dq")):
            err = fn(d, which, info)
            print(f"card D {d} {kind}: " + (f"error {err}" if err else
                  f"{info[0]} registers, {info[1]} local bytes, {info[2]} B "
                  f"shared, {info[3]} blocks/SM"))


def profile(label, b, s, h, kvh, d, calls=4) -> None:
    """Device time per kernel of one causal call (torch.profiler over
    ``calls`` calls after two warm ones) and each kernel's share of the
    card's rate."""
    g = torch.Generator(device="cuda").manual_seed(2)
    q, do = (torch.randn(b, h, s, d, generator=g, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, kvh, s, d, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    with torch.no_grad():
        out, lse = fk.flash_attention_bhsd(q, k, v, causal=True,
                                           return_lse=True)
    for _ in range(2):
        fk.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fk.flash_attention_bwd(q, k, v, out, do, lse)
        torch.cuda.synchronize()
    hw = HW()
    product = 2 * d * h * b * s * (s + 1) // 2   # FLOPs, one product
    di_bytes = 2 * 2 * b * h * s * d + 4 * b * h * s
    parts, total = [], 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if not t or "flash_bwd" not in e.key:
            continue
        ms = t / calls / 1e3
        total += ms
        name = re.sub(r"^.*?(flash_bwd_\w+?kernel).*$", r"\1", e.key)
        n = PRODUCTS.get(name)
        if n:
            flops = n * product
            share = (f"{n} x {product / 1e9:.2f} GFLOP / {ms:.4f} ms = "
                     f"{flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{flops / (ms * 1e-3) / hw.peak_flops:.1%} of "
                     f"{hw.peak_flops / 1e12:.0f}")
        else:
            share = (f"{di_bytes / 1e6:.1f} MB / {ms:.4f} ms, "
                     f"{di_bytes / (ms * 1e-3) / hw.hbm_bw:.1%} of "
                     f"{hw.hbm_bw / 1e12:.2f} TB/s")
        parts.append(f"{name} {ms:.4f} ms ({share})")
    print(f"profile {label} (B {b}, S {s}, H {h}, KVH {kvh}, D {d}): "
          f"{total:.4f} ms: " + "; ".join(parts), flush=True)


def time_step() -> None:
    """Phase 38's smollm-360m ``train_4k`` step: one warm step, then STEPS
    on the host clock around the step and a synchronise."""
    from repro_torch.configs import get_arch, get_shape

    arch, shape_name, batch = DRYRUN_CELLS[0]
    shape = dataclasses.replace(get_shape(shape_name), global_batch=batch)
    step, held = _dryrun_step(torch, get_arch(arch), shape)
    step()
    times = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    print(f"step {arch} {shape_name} B {batch}: median "
          f"{sorted(times)[STEPS // 2]:.1f} ms ("
          + ", ".join(f"{t:.1f}" for t in times) + ")", flush=True)
    del held


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(f"package: {SRC}", flush=True)
    if "--step" in sys.argv:
        time_step()
        return 0
    report_build()
    for label, b, s, _ in FLASH_TRAIN_SHAPES:
        profile(label, b, s, FLASH_H, KVH, D)
    for label, (b, h, kvh, d) in FLASH_BWD_WIDTHS.items():
        profile(label, b, 4096, h, kvh, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
