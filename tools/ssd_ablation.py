#!/usr/bin/env python3
"""Where the bf16 SSD scan's time goes, on the card.

Builds variants of the port's ``csrc/ssd_scan.cu`` into
``build/ablation_ssd/`` (git-ignored; one ``nvcc`` per variant, all
started together). A variant is the source as it is or a text patch of it,
and the script fails if a patch no longer applies. Timed, in turns:

* ``kernel``       the tensor-core kernel as the wrapper launches it
                   (``scan_rows``: 32 P rows a block at these shapes);
* ``rows=16/32/64`` the same library launched with 16, 32 or 64 P rows a
                   block (a block per (b, head, slice of P));
* ``cuda-core``    the same library's CUDA-core bf16 instance (the first
                   version of the scan, which other bf16 shapes still take);
* ``no-state-io``  the entering state never read (its copies zero-fill)
                   and the final state never stored (a time, not a
                   result);
* ``no-bc-loads``  B and C never read (their copies zero-fill): what the
                   64 x N tiles every block of a (b, sub-chunk) reads from
                   L2 cost;
* ``no-compute``   launch, loads, the decay scan, the elementwise xw and
                   the stores of y and the state alone: none of the four
                   products runs;
* ``loads-only``   launch and the first loads (sub-chunks 0 and 1 and the
                   entering state), then the block exits;
* ``empty``        the launch alone: every block exits at once;
* ``baseline``     with ``--baseline DIR``: the kernel built from
                   ``DIR/ssd_scan.cu`` (and ``DIR``'s headers), another
                   version with the same C entry, in the same turns.

Shapes (bf16, each cycling over 48 layers' inputs, as the engine's calls
find their state outside L2): the engine's call (B 1, one 64-token chunk
from a carried state, mamba2-1.3b's H 64, P 64, N 128), a whole 512-token
prompt from zero (B 1), and zamba2-2.7b's SSD widths (H 80, P 64, N 64) at
the engine's chunk. Device time per call from CUDA events around 48 calls
queued behind a sleep kernel; each shape times every variant, then every
variant in reverse, and prints the lesser of the two. The first line is
the card's name and power limit; the byte bound of each shape (inputs read
once, outputs written once, at 3.35 TB/s) is printed beside it.

    python tools/ssd_ablation.py [--baseline DIR]  # repo root, CUDA machine
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402

OUT = ROOT / "build" / "ablation_ssd"
LAYERS = 48
P = 64
SLEEP_CYCLES = 200_000_000
HBM_BYTES_PER_S = 3.35e12
# the entering state's copies and the final state's stores
NO_STATE_IO = [
    ("init_rows + (size_t)r * N +\n"
     "                                                    ch * 4, true);",
     "init_rows + (size_t)r * N +\n"
     "                                                    ch * 4, false);"),
    ("        float* d = out_rows",
     "        if (N > 0) continue;\n        float* d = out_rows"),
]
# B and C, which every block of a (b, sub-chunk) reads
NO_BC_LOADS = [
    ("mma::cp_async_16(sb + i * ldn + ch * 8, Bm + src, ok);",
     "mma::cp_async_16(sb + i * ldn + ch * 8, Bm + src, false);"),
    ("mma::cp_async_16(sc + i * ldn + ch * 8, Cm + src, ok);",
     "mma::cp_async_16(sc + i * ldn + ch * 8, Cm + src, false);"),
]
# the four products: G and y_off (the two k loops over N), M x, and the
# state update
NO_COMPUTE = [
    ("for (int kk = 0; kk < n16; ++kk) {",
     "for (int kk = 0; kk < (N < 0 ? n16 : 0); ++kk) {"),
    ("        if (kk <= warp) {", "        if (kk <= warp && N < 0) {"),
    ("          uint32_t af[4], bf[4];\n",
     "          if (N >= 0) continue;\n          uint32_t af[4], bf[4];\n"),
]
FIRST_LOADS = "  __syncthreads();  // sub-chunk 0 has landed\n"
LOADS_ONLY = [(FIRST_LOADS, FIRST_LOADS + "  mma::cp_async_wait<0>();\n"
               "  if (N > 0) return;\n")]
KERNEL_START = ('  static_assert(R == 16 || R == 32 || R == 64, '
                '"16, 32 or 64 rows");\n')
EMPTY = [(KERNEL_START, KERNEL_START + "  if (N > 0) return;\n")]
# library variant -> [(old, new)] text patches of ssd_scan.cu (every
# occurrence of old is replaced)
BUILDS = {"kernel": [], "no-state-io": NO_STATE_IO,
          "no-bc-loads": NO_BC_LOADS, "no-compute": NO_COMPUTE,
          "loads-only": LOADS_ONLY, "empty": EMPTY}
# timed variant -> (library variant, P rows a block; 0 = CUDA-core)
VARIANTS = {"kernel": ("kernel", None), "rows=16": ("kernel", 16),
            "rows=32": ("kernel", 32), "rows=64": ("kernel", 64),
            "cuda-core": ("kernel", 0), "no-state-io": ("no-state-io", None),
            "no-bc-loads": ("no-bc-loads", None),
            "no-compute": ("no-compute", None),
            "loads-only": ("loads-only", None), "empty": ("empty", None)}
PT, IT = ctypes.c_void_p, ctypes.c_int


def _texts(src: Path) -> dict[str, str]:
    return {f.name: f.read_text() for f in src.iterdir()
            if f.suffix in (".cu", ".cuh")}


def make_variants(baseline: Path | None) -> dict[str, ctypes.CDLL]:
    """Patches every variant's source first (raising before any compiler
    starts if a patch no longer applies), then compiles all of them at
    once and waits for every compiler before reporting a failure."""
    builds = {name: (build.CSRC, patches) for name, patches in BUILDS.items()}
    if baseline is not None:
        builds["baseline"] = (baseline, [])
    sources = {}
    for name, (src, patches) in builds.items():
        texts = _texts(src)
        for old, new in patches:
            if old not in texts["ssd_scan.cu"]:
                raise RuntimeError(f"{name}: patch no longer applies: "
                                   f"{old!r}")
            texts["ssd_scan.cu"] = texts["ssd_scan.cu"].replace(old, new)
        sources[name] = texts
    procs = {}
    for name, texts in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        so = d / "ssd_scan.so"
        cmd = [build.nvcc_path(), *build._flags(), "-o", str(so),
               str(d / "ssd_scan.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    logs = {name: proc.communicate()[0] for name, (proc, _) in procs.items()}
    failed = [f"{name}:\n{logs[name]}" for name, (proc, _) in procs.items()
              if proc.returncode]
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    libs = {}
    for name, (_, so) in procs.items():
        lib = ctypes.CDLL(str(so))
        lib.ssd_scan_chunked.argtypes = [PT] * 8 + [IT] * 7 + [PT]
        lib.ssd_scan_chunked.restype = IT
        libs[name] = lib
    return libs


def time_ms(fn, iters=48, warmup=8) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(s, h, n, with_init) -> float:
    """Bytes of one call (bf16 x, y, B, C; f32 dt, A and state) over the
    card's memory rate."""
    state = (2 if with_init else 1) * h * P * n * 4
    nbytes = state + 2 * s * h * P * 2 + s * h * 4 + h * 4 + 2 * s * n * 2
    return nbytes / HBM_BYTES_PER_S * 1e3


def shape_row(libs, variants, label, s, h, n, with_init):
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(LAYERS, 1, s, h, P, generator=g,
                    device="cuda").bfloat16()
    dt = 0.1 + 0.9 * torch.rand(LAYERS, 1, s, h, generator=g, device="cuda")
    A = -torch.rand(h, generator=g, device="cuda") - 0.1
    Bm, Cm = ((torch.randn(LAYERS, 1, s, n, generator=g, device="cuda")
               / n ** 0.5).bfloat16() for _ in range(2))
    init = (torch.randn(LAYERS, 1, h, P, n, generator=g, device="cuda")
            if with_init else None)
    y = torch.empty_like(x[0])
    fs = torch.empty(1, h, P, n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    default_rows = sk.scan_rows(torch.bfloat16, P, n)

    def call(lib, rows):
        def fn(i):
            l = i % LAYERS
            err = lib.ssd_scan_chunked(
                x[l].data_ptr(), dt[l].data_ptr(), A.data_ptr(),
                Bm[l].data_ptr(), Cm[l].data_ptr(),
                None if init is None else init[l].data_ptr(), y.data_ptr(),
                fs.data_ptr(), 1, s, h, P, n, 1, rows, stream)
            if err:
                raise RuntimeError(f"launch error {err}")
        return fn

    calls = {name: call(libs[lib], default_rows if rows is None else rows)
             for name, (lib, rows) in variants.items()}
    times = {}
    for name in list(calls) + list(calls)[::-1]:
        t = time_ms(calls[name])
        times[name] = min(t, times.get(name, t))
    print(f"{label:36s} bound {bound_ms(s, h, n, with_init):.5f} | "
          + " | ".join(f"{k} {v:.4f}" for k, v in times.items()),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory holding another ssd_scan.cu (and its "
                         "headers) to time beside the variants")
    args = ap.parse_args()
    libs = make_variants(args.baseline)
    variants = dict(VARIANTS)
    if args.baseline is not None:
        variants["baseline"] = ("baseline", None)
    for label, s, h, n, with_init in (
            ("engine chunk S 64 from a state [mamba2]", 64, 64, 128, True),
            ("prompt S 512 from zero [mamba2]", 512, 64, 128, False),
            ("engine chunk S 64 from a state [zamba2]", 64, 80, 64, True)):
        shape_row(libs, variants, label, s, h, n, with_init)
    return 0


if __name__ == "__main__":
    sys.exit(main())
