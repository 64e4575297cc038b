#!/usr/bin/env python3
"""What bounds a checkpoint save, and what a profiler window costs, on
the card's host.

    python3 tools/host_probe.py [--phase36]

Prints the card's name and power limit, then: the rate at which this
host writes 8 GiB to a temporary file and fsyncs it, one thread's sha256
rate, and the device-to-pageable-host copy rate (the three stages of
``CheckpointManager.save``); then a torch.profiler window over 100k small
device ops, recording host and device activities against the device's
alone, twice each: seconds to start, run, stop and read the window, and
the device time each records (what ``chip_smoke.py``'s windows read).
``--phase36`` then runs ``chip_smoke.py``'s phase 36 alone (the kernels
built first): full-width internvl2-26b and dbrx-132b through
``launch.train``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def io_rates(np, torch) -> None:
    buf = np.random.default_rng(0).integers(0, 255, 2 << 30, dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with open(f"{tmp}/x", "wb") as f:
            for _ in range(4):
                f.write(memoryview(buf))
            f.flush()
            os.fsync(f.fileno())
        print(f"host write 8 GiB + fsync: "
              f"{8 / (time.perf_counter() - t0):.3f} GiB/s", flush=True)
    t0 = time.perf_counter()
    hashlib.sha256(memoryview(buf)).hexdigest()
    print(f"sha256 one thread: {2 / (time.perf_counter() - t0):.3f} GiB/s",
          flush=True)
    x = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x.cpu()
    print(f"device to pageable host 4 GiB: "
          f"{4 / (time.perf_counter() - t0):.3f} GiB/s", flush=True)


def profiler_cost(torch, n: int = 25_000) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def work(x):
        for _ in range(n):  # 4 device ops an iteration
            x = (x * 1.0001 + 0.5).clamp_(-4, 4).add_(1e-3)
        torch.cuda.synchronize()

    x = torch.randn(64, 64, device="cuda")
    work(x)
    for _ in range(2):
        for name, acts in (("host + device",
                            [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                           ("device", [ProfilerActivity.CUDA])):
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                t1 = time.perf_counter()
                work(x)
                t2 = time.perf_counter()
            t3 = time.perf_counter()
            ms, ops = 0.0, 0
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == DeviceType.CUDA:
                    ms += e.duration_ns() / 1e6
                    ops += 1
            t4 = time.perf_counter()
            print(f"profiler, {name} activities: start {t1 - t0:.2f} s, "
                  f"window {t2 - t1:.2f} s, stop {t3 - t2:.2f} s, read "
                  f"{t4 - t3:.2f} s; {ops} device ops, {ms:.1f} ms",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase36", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("host_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    io_rates(np, torch)
    profiler_cost(torch)
    if args.phase36:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs

        sys.path.insert(0, str(cs.SRC))
        from repro_torch.configs import get_arch
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fk
        from repro_torch.kernels import paged_attention as pk
        from repro_torch.kernels import ssd_scan as sk

        build.build()
        t0 = time.perf_counter()
        cs.run_moe_vlm_train(torch, np, get_arch, fk, pk, sk,
                             cs.card_line())
        print(f"phase 36: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
