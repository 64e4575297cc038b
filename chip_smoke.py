#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (any failure exits non-zero):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build   — compiles the hand-written CUDA kernels from the sources in this
   checkout (``nvcc``, sm_90a) and prints the build seconds, then the bf16
   tensor-core kernels' and the split decode kernel's registers and spill
   stores from ptxas' report and, from the card, their registers, local
   bytes, dynamic shared memory and blocks per SM at D 64, 80 and 128; the
   same for the SSD scan kernels (``ssd_scan_info``) at the calls phases
   10-12 make.
3. kernels — each paged-attention kernel against its plain PyTorch version
   on the card, at the main path's widths (KVH 5, G 3, D 64, page 16), at
   llama3-8b's (KVH 8, G 4, D 128, page 8) and at zamba2-2.7b's (KVH 32,
   G 1, D 80, page 16), each over a pool of q's dtype and over an int8
   pool with f32 scales (the int8 variant, which reads the pool in int8
   and applies the scales on the card, against ``dequantize_pages`` + the
   plain versions). Decode runs the split decode kernel; the mixed step
   runs as the engine calls it (``num_decode=SLOTS``: with bf16 q the
   decode rows through the split kernel, the chunk rows through the
   tensor-core chunk kernel) and without the hint (every row through the
   split kernel); the chunked prefill runs the tensor-core kernel with
   bf16 q and the CUDA-core one with f32 q: bf16 within
   2e-2 absolute (f32 accumulation, bf16 output: a few bf16 ulps of
   outputs of magnitude ~1), f32 within 1e-3, and dead rows (idle slots,
   padded chunk rows, length 0) bit-exact zeros. Every width runs the
   main path's shapes: MAX_LEN / page table entries over 400 shuffled
   physical pages, lengths 0, 1, page+-1, partial last pages up to 631, a
   chunk straddling a page with valid < C, a full chunk from position 0,
   an all-padding chunk, and a mixed batch with dead rows among live ones.
   Then times each kernel, its plain version and a library yardstick
   (``F.scaled_dot_product_attention`` on the gathered dense K/V, which the
   port never calls) at the shapes of one engine step, cycling over 32
   layers' pools as a step does (the mixed kernel with the engine's hint,
   and also without it); and all three the same way at the llama3-8b and
   zamba2-2.7b widths.
4. engine  — full-width smollm-360m (bf16, seeded random weights) served by
   ``ContinuousBatchingEngine(max_slots=8, page_size=16, prefill_chunk=64)``:
   16 requests of 100-600 prompt tokens (half share a 128-token prefix),
   32 new tokens each, greedy and seeded top-p. Every request must finish
   by length, the prefix index must hit, and each kernel's launch count
   (reset just before this run) must be > 0: the decode-only, chunk-only
   and mixed routes all ran. Prints tok/s, TTFT and ITL, then a
   torch.profiler window over a second run (device busy share, the
   paged-attention kernels' share of it by kernel, the top device ops);
   the window must show the split decode kernel and no instance of the
   CUDA-core prefill template (which serves f32 q only).
5. parity  — the same engine in f32 with TF32 off, once through the kernels
   and once through the plain versions (``attn_impl="ref"``): the greedy
   token streams must be identical. Depth is cut to 2 layers for this
   phase: the random-weight model amplifies f32 rounding differences with
   depth until the argmax flips (the phase prints the one-chunk logit gap
   at 32 and at 2 layers to show it).

6. flash    — the flash-attention kernel against its plain version
   (``ref.flash_attention_chunked``) at smollm widths (H 15, KVH 5, D 64):
   bf16 within 2e-2 and f32 within 1e-3. Fixed cases at B 8: causal with
   Sq = Skv in {1, 64, 100, 256, 300, 512}, causal with Sq 64 < Skv 320,
   non-causal with Sq 37, Skv 300; at B 1 every whole-prompt bucket from
   128 to 1024. Then every (B, S) that phases 7 and 8 gave the kernel, as
   recorded from their prefills, and zamba2's D 80 (32 heads, G 1),
   causal and not, with every (B, S) of phase 15's zamba2 prefills (the
   check runs after phase 15 for that reason). The ragged lengths go to
   the kernel's wrapper directly (the op keeps the reference's
   Skv-multiple-of-256 rule), and llama3-8b's D 128 (32 / 8 heads). bf16
   runs the tensor-core kernel, f32 the CUDA-core one. Before the engines
   it times the kernel, its plain version and
   ``F.scaled_dot_product_attention (..., is_causal=True, enable_gqa=True)``
   (which the port never calls) at the two engine shapes: lockstep (B 8,
   S 256) and whole-prompt (B 1, S 512), cycling over 32 layers' inputs, at
   smollm's widths and at llama3-8b's and zamba2-2.7b's.
7. lockstep — full-width smollm-360m through ``GenerationEngine(max_batch=8,
   max_len=512)``: 16 requests of 64-256 prompt tokens (every batch's
   longest prompt inside the reference's flash contract), 32 new tokens
   each, greedy and seeded top-p alternating. Every request finishes by
   length and the flash launch count (reset just before) is 32 per
   prefilled batch. Prints tok/s, TTFT, ITL and a profiler window.
8. whole-prompt — full-width smollm-360m through
   ``ContinuousBatchingEngine(max_slots=8, page_size=16, prefill_chunk=None,
   max_len=1024)`` (buckets 128-1024, all inside the contract): 8 requests
   of 100-600 prompt tokens, 32 new each. Flash launches = 32 per
   admission, decode-kernel launches > 0. Prints tok/s, TTFT, ITL and a
   profiler window (checked as phase 4's).
9. whole-prompt parity — f32, TF32 off: the one-prefill logit gap of the
   flash kernel to its plain version at 32 and at 2 layers, then at 2
   layers (PARITY_LAYERS, as phase 5) greedy lockstep streams through the
   kernels equal those through the plain versions, and the whole-prompt
   paged engine's streams equal the chunked paged engine's and the
   lockstep engine's (one request at a time) on the same requests.

10. ssd     — both Mamba2 SSD kernels against their plain versions on the
   card at mamba2-1.3b widths (H 64, P 64, N 128) and zamba2-2.7b's
   (H 80, N 64): bf16 within 5e-2 and f32 within 1e-3 (atol and rtol;
   the JAX package's SSD bounds). The check runs after phase 15, to take
   its prompts. Scan cases, at both widths: a 64-token chunk whose tail
   has dt = 0 (valid 41 < C) from a non-zero init_state, a full chunk
   from a non-zero state, and the engines' pattern: 7 chained 64-token
   calls carrying the state against one plain call over 448 tokens; S =
   200 over two sequences (four of the kernel's 64-token sub-chunks,
   ragged end) from zero; a whole 512-token prompt from zero (mamba2);
   and every (B, S) batch of phase 15's lockstep prefills from zero at
   its arch's widths. bf16 scans must all take the tensor-core kernel and
   f32 ones the CUDA-core template (``LAUNCHES_BY_PATH``). Decode, at
   both widths: 8 slots with 3 idle, in place, the idle slots' state bit
   for bit unchanged, and 8 slots ungated (the lockstep engine's call).
   Before the engines it times each kernel and its plain version at one
   engine step's
   shapes (decode: 8 slots, 2 of them idle; scan: one 64-token chunk of
   one sequence), cycling over 48 layers' states, and the scan at S 512
   and at zamba2's widths.
11. mamba2  — full-width mamba2-1.3b (bf16, seeded random weights, 48
   layers) served by ``SSMEngine(max_slots=8, prefill_chunk=64,
   max_len=512)``: 8 requests of 64-400 prompt tokens, 24 new tokens each,
   greedy and seeded top-p alternating. Every request must finish by
   length, both SSD launch counts (reset just before this run) must be
   > 0, and every scan launch must have taken the tensor-core kernel.
   Prints tok/s, TTFT and ITL and a torch.profiler window (device busy
   share, the SSD kernels' share of it, the top device ops), which must
   show the tensor-core scan and no CUDA-core scan instance.
12. mamba2 parity — f32 with TF32 off, at the full 48 layers (the SSD
   kernels keep the one-chunk logit gap to plain far below the argmax
   margin, unlike the smollm phase's attention, so no depth cut): the
   one-chunk logit gap to plain must stay under 1e-3, greedy streams
   through the kernels equal those through the plain versions
   (``ssd_impl="ref"``), and a run with one snapshot preemption and one
   discard preemption gives the same streams as the undisturbed run.
13. zamba2  — full-width zamba2-2.7b (bf16, seeded random weights, all 54
   Mamba2 layers in 9 groups, each led by the one shared attention + MLP
   block, 32 heads of D 80) served by ``SSMEngine(max_slots=8,
   prefill_chunk=64, max_len=512, page_size=16)``: 8 requests of 64-400
   prompt tokens, 24 new each, greedy and seeded top-p alternating; then 8
   more over a pool of Z_TIGHT_PAGES pages, on which decode-time page
   growth preempts (youngest first, at least once). Every request must
   finish by length; the paged decode and chunk kernels and both SSD
   kernels (counts reset before each run) must launch in each run, the
   fused mixed kernel never (the hybrid engine has no mixed step), and
   every scan must take the tensor-core kernel. Prints tok/s, TTFT, ITL
   and a profiler window (device busy share, each kernel's share of it),
   which must show the split decode, tensor-core chunk, tensor-core scan
   and SSD decode kernels and neither CUDA-core template.
14. zamba2 parity — f32, TF32 off, at Z_PARITY_LAYERS (24): the one-chunk
   logit gaps of the kernels to the plain versions and of the plain path
   in f32 to the same path with f64 weights (``_hybrid_chunk_logits``)
   beside the top-2 margin, and the plain engine's greedy streams in f32
   and in f64, which must agree (f32 rounding alone flips no argmax of
   the check; at 54 and 36 layers it does). There, greedy
   ``SSMEngine`` streams through the kernels equal the plain f32 ones
   (``attn_impl``/``ssd_impl="ref"``) and those of a run over
   Z_PARITY_TIGHT_PAGES pages that preempts, and
   ``preempt_youngest(snapshot=True)`` on a hybrid slot raises.
15. lockstep ssm/hybrid — full-width mamba2-1.3b and zamba2-2.7b (bf16)
   through ``GenerationEngine(max_batch=8, max_len=512)``: 8 requests of
   64-256 prompt tokens (the flash contract), 16 new each; every request
   finishes by length, the scan (all on the tensor-core kernel), the SSD
   decode and (zamba2) flash launch counts are > 0. Then, in f32 at the
   parity depths (mamba2 48, zamba2 24), the greedy streams of 5
   equal-length prompts (one left-pad-free batch) through lockstep equal
   those through ``SSMEngine``.
16. ssm serve driver — ``python -m repro_torch.launch.serve --arch
   zamba2-2.7b`` and ``--engine lockstep --arch mamba2-1.3b`` at full
   width: 8/8 served, ``engine=ssm`` and ``engine=lockstep``.

17. int8 timing — the int8 variant of the three paged kernels (checked in
   phase 3), their plain versions and SDPA on K/V dequantized and gathered
   in advance, at phase 3's engine-step shapes and at the llama3-8b and
   zamba2-2.7b widths; the bound counts int8
   K/V plus a 4-byte scale per (position, kv head).
18. int8 engine — phase 4's trace through ``ContinuousBatchingEngine(...,
   kv_quant="int8")`` on full-width smollm-360m, in turns with bf16 pages
   (bf16, int8, int8, bf16): every request finishes by length, the prefix
   index hits and each paged kernel runs (path ``chunked_int8`` in
   ``launches_by_path``, the first int8 turn). Prints tok/s, TTFT, ITL
   per turn and a profiler window of each page type (checked as phase
   4's).
19. tier restart — full-width smollm-360m, once with bf16 pages (path
   ``tiered``) and once with int8 pages (path ``tiered_int8``), a pool of
   128 pages with ``host_pages`` and ``persist_dir`` in a temporary
   directory: phase 4's trace must reclaim and spill parked pages; after
   ``flush_tiers()`` a NEW engine on the same directory reruns the same
   prompts with persisted hits and fewer prefill chunks (the TTFT change
   is printed), and every page it reloaded holds, byte for byte, what the
   store kept under the page's content key, for every pool tensor (int8
   K/V and their f32 scales for int8 pages).
20. tier + int8 parity — f32, TF32 off, PARITY_LAYERS layers: greedy int8
   streams through the kernels equal those through the plain versions;
   the tiered run, its restart from the store and an untiered run give
   the same streams with one slot (f32 pages) and with four slots (f32
   and int8 pages, interleaved steps, a pool on which the tiered run
   reclaims and spills while other slots are live; its dispatches must
   equal the untiered run's one for one, and no run may preempt).
21. serve driver — ``python -m repro_torch.launch.serve --kv-quant int8
   --host-pages 8 --persist-dir DIR`` at full width, twice on one
   directory: 12/12 served each time, persisted hits only on the second.

Kernel and plain times are device time per call: the calls are enqueued
behind a sleep kernel and timed with CUDA events, so the host's per-call
overhead stays out (``_time_ms``). A ``[t s] phase: s`` line after each
phase gives the wall time so far and the phase's own (PERF.md has a
run's).

The line before the last is ``{"kernels": [...]}`` (all six ported
kernels); each kernel's ``launches`` is the sum of ``launches_by_path``,
the counts read after each engine path that ran it (each reset just
before its path). The three paged kernels also carry ``int8``: the int8
variant's max abs error, times and bound; the mixed kernel's ``ms`` is the
hinted call's and ``generic_ms`` the call without the hint. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# kernel -> (its CUDA source, the Pallas function it replaces)
KERNELS = {
    "paged_attention_bkgd": (
        PAGED_SOURCE, "src/repro/kernels/paged_attention.py:141"),
    "paged_prefill_attention_ckgd": (
        PAGED_SOURCE, "src/repro/kernels/paged_attention.py:289"),
    "paged_mixed_attention_rkgd": (
        PAGED_SOURCE, "src/repro/kernels/paged_attention.py:443"),
    "ssd_scan_bshp": (SSD_SOURCE, "src/repro/kernels/ssd_scan.py:89"),
    "ssd_decode_step_bh": (SSD_SOURCE, "src/repro/kernels/ssd_scan.py:146"),
    "flash_attention_bhsd": (
        FLASH_SOURCE, "src/repro/kernels/flash_attention.py:87"),
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores
BF16_TOL, F32_TOL = 2e-2, 1e-3
SLEEP_CYCLES = 200_000_000     # ~0.1 s at the H100's ~1.98 GHz boost clock
KVH, G, D, PAGE, LAYERS = 5, 3, 64, 16, 32
SLOTS, CHUNK, MAX_LEN = 8, 64, 704
PARITY_LAYERS = 2
# mamba2-1.3b: SSD widths, layers, and the engine's shape
SSD_H, SSD_P, SSD_N, M_LAYERS, M_MAX_LEN = 64, 64, 128, 48, 512
SSD_BF16_TOL, SSD_F32_TOL = 5e-2, 1e-3
ZAMBA_SSD = (80, 64)  # zamba2-2.7b's SSD heads and N (P 64 as mamba2's)
# zamba2-2.7b's engine max_len; the page-pressure pools of phase 13's and
# phase 14's traces (each preempts twice); the f32 parity depth: 4 of the
# 9 groups of attn_every 6, the deepest of 54/36/24 at which the plain
# engine's f32 and f64 greedy streams agreed on the H100 (at 54 and 36 f32
# rounding alone flips an argmax)
Z_MAX_LEN, Z_TIGHT_PAGES, Z_PARITY_TIGHT_PAGES = 512, 48, 32
Z_PARITY_LAYERS = 24
# the kernels of the hybrid engine's path (no fused mixed step)
HYBRID_KERNELS = ("paged_attention_bkgd", "paged_prefill_attention_ckgd",
                  "ssd_scan_bshp", "ssd_decode_step_bh")
# (kv heads, group, head_dim, page) of the paged int8 / head-dim checks:
# smollm-360m, llama3-8b (32 / 8 heads, D 128) and zamba2-2.7b (D 80)
PAGED_WIDTHS = {"smollm D64": (KVH, G, D, PAGE),
                "llama3 D128": (8, 4, 128, 8), "zamba2 D80": (32, 1, 80, 16)}
MAIN_WIDTH = "smollm D64"  # the widths the engine phases run
TIER_PAGES, TIER_HOST_PAGES = 128, 64
# the 4-slot tier parity pool: reclaims and spills, preempts nothing
TIER_PARITY_PAGES = 80
# device kernel names the trace windows count as paged / flash attention
PAGED_TRACE_KEYS = ("paged_decode_split_kernel", "paged_decode_merge_kernel",
                    "paged_prefill_mma_kernel", "paged_prefill_f32_kernel")
# (the kernels a bf16 window must show, the CUDA-core templates it must
# not)
PAGED_BF16_CHECK = (("paged_decode_split_kernel",),
                    ("paged_prefill_f32_kernel",))
SSD_TRACE_KEYS = ("ssd_scan_mma_kernel", "ssd_scan_kernel",
                  "ssd_decode_kernel")
SSD_BF16_CHECK = (("ssd_scan_mma_kernel",), ("ssd_scan_kernel",))
# (the kernels a bf16 zamba2 window must show, the CUDA-core templates it
# must not)
ZAMBA_BF16_CHECK = (("paged_decode_split_kernel", "paged_prefill_mma_kernel",
                     "ssd_scan_mma_kernel", "ssd_decode_kernel"),
                    ("ssd_scan_kernel", "paged_prefill_f32_kernel"))
FLASH_TRACE_KEYS = ("flash_attention_kernel", "flash_attention_mma_kernel")
# smollm-360m's whole-prompt paths: q heads, the engines' shapes
FLASH_H, LOCK_BATCH, LOCK_MAX_LEN, WHOLE_MAX_LEN = KVH * G, 8, 512, 1024
# (q heads, kv heads, head_dim) of the flash checks and timings: smollm-360m
# (the engines' widths), llama3-8b and zamba2-2.7b
FLASH_WIDTHS = {"smollm D64": (FLASH_H, KVH, D), "llama3 D128": (32, 8, 128),
                "zamba2 D80": (32, 32, 80)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _pools(torch, n_pages, dtype, layers=1, seed=0, width=None):
    kvh, _, d, page = width or PAGED_WIDTHS[MAIN_WIDTH]
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (layers, n_pages, page, kvh, d)
    k = torch.randn(shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    return k, v


def _tables(torch, rows, mp, n_pages, seed):
    """Rows of distinct physical pages in shuffled order (never the null
    page 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.stack([torch.randperm(n_pages - 1, generator=g,
                                       device="cuda")[:mp] + 1
                        for _ in range(rows)]).int().contiguous()


def check_kernels(torch, ops, ref, wname, quant):
    """Run every paged kernel against its plain version at one of
    PAGED_WIDTHS, over a pool of q's dtype or (``quant``) an int8 pool with
    f32 scales, at the main path's shapes: tables of MAX_LEN / page
    entries over 400 pages, decode lengths up to 631, and chunks from
    position 0, straddling a page and all padding. Returns max abs error
    per kernel over the bf16 cases (the mixed one over the hinted and the
    generic call) and logs the f32 ones."""
    kvh, group, d, page = PAGED_WIDTHS[wname]
    mp, n_pages = -(-MAX_LEN // page), 400
    pool_kind = "int8" if quant else "pool"
    errs = {}

    def compare(name, got, want, dead, tol, label):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} [{label}]: max abs err {err} > {tol}")
        if dead is not None and dead.any() and not (got[dead] == 0).all():
            raise AssertionError(f"{name} [{label}]: dead rows not exact 0")
        return err

    kf, vf = _pools(torch, n_pages, torch.float32, seed=1,
                    width=PAGED_WIDTHS[wname])
    kf, vf = kf[0], vf[0]
    if quant:
        (kq, ks), (vq, vs) = ref.quantize_kv(kf), ref.quantize_kv(vf)
        sc = dict(k_scale=ks, v_scale=vs)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        label = (f"{str(dtype).removeprefix('torch.')} {pool_kind} {wname}")
        if quant:
            kp, vp = kq, vq
        else:
            kp, vp, sc = kf.to(dtype), vf.to(dtype), {}
        g = torch.Generator(device="cuda").manual_seed(2)
        # decode: idle slot, 1, page-1, page, page+1, partial pages
        lengths = torch.tensor([0, 1, page - 1, page, page + 1, 2 * page + 1,
                                250, 631], dtype=torch.int32, device="cuda")
        tables = _tables(torch, SLOTS, mp, n_pages, seed=3)
        q = torch.randn(SLOTS, kvh * group, d, generator=g,
                        device="cuda").to(dtype)
        e_dec = compare(
            "paged_attention_bkgd",
            ops.paged_attention(q, kp, vp, tables, lengths, **sc),
            ops.paged_attention(q, kp, vp, tables, lengths, impl="ref", **sc),
            lengths == 0, tol, label)
        # prefill: a chunk straddling a page with valid < C, a full chunk
        # from position 0, and an all-padding chunk
        qc = torch.randn(CHUNK, kvh * group, d, generator=g,
                         device="cuda").to(dtype)
        e_pre = 0.0
        for start, valid in ((23, 41), (0, CHUNK), (300, 0)):
            st = torch.tensor(start, dtype=torch.int32, device="cuda")
            va = torch.tensor(valid, dtype=torch.int32, device="cuda")
            dead = torch.arange(CHUNK, device="cuda") >= valid
            e_pre = max(e_pre, compare(
                "paged_prefill_attention_ckgd",
                ops.paged_prefill_attention(qc, kp, vp, tables[5], st, va,
                                            **sc),
                ops.paged_prefill_attention(qc, kp, vp, tables[5], st, va,
                                            impl="ref", **sc),
                dead, tol, f"{label} start={start} valid={valid}"))
        # mixed: decode rows (one idle) + a chunk straddling a page with a
        # dead suffix, every row its own table row; with the engine's hint
        # (the chunk's rows share table row 5) and without it
        cpos = torch.arange(CHUNK, dtype=torch.int32, device="cuda")
        last_pos = torch.cat([lengths - 1,
                              torch.where(cpos < 41, 23 + cpos, -1)])
        mtables = torch.cat([tables, tables[5:6].expand(CHUNK, mp)])
        mtables = mtables.contiguous()
        qm = torch.cat([q, qc])
        want = ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                         impl="ref", **sc)
        e_mix = max(compare(
            "paged_mixed_attention_rkgd",
            ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                      num_decode=hint, **sc),
            want, last_pos < 0, tol, f"{label} num_decode={hint}")
            for hint in (SLOTS, None))
        log(f"kernel check {label} (KVH {kvh}, G {group}, D {d}, page {page},"
            f" {mp}-entry tables): decode {e_dec:.3e}, prefill {e_pre:.3e}, "
            f"mixed {e_mix:.3e} (bound {tol})")
        if dtype == torch.bfloat16:
            errs = {"paged_attention_bkgd": e_dec,
                    "paged_prefill_attention_ckgd": e_pre,
                    "paged_mixed_attention_rkgd": e_mix}
    return errs


def _time_ms(torch, fn, iters=64, warmup=8):
    """Device time per call: CUDA events around ``iters`` calls, enqueued
    while the stream is held by a sleep kernel, so the calls run back to
    back and the host's Python and launch overhead (tens of microseconds
    per call, more than some kernels take) stays out of the measurement."""
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


def _bound(n_positions, rows_attended, q_rows, tables_elems, scalars, elt,
           quant=False, width=None):
    """Least time for the function at one of PAGED_WIDTHS (the main one by
    default): every K/V position it must read (each (page, offset) once,
    all kv heads; int8 pages: one byte per element plus a 4-byte f32 scale
    per (position, kv head)), q in, out back, its int32 tables and
    positions; against the operations of QK^T and PV over the attended
    positions. Returns (ms, 'bytes' | 'operations')."""
    kvh, group, d, _ = width or PAGED_WIDTHS[MAIN_WIDTH]
    kv_bytes = 2 * n_positions * kvh * (d + 4 if quant else d * elt)
    qo_bytes = 2 * q_rows * kvh * group * d * elt
    nbytes = kv_bytes + qo_bytes + 4 * (tables_elems + scalars)
    flops = 4 * d * kvh * group * rows_attended
    rate = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_kernels(torch, F, ops, ref, quant=False, wname=MAIN_WIDTH):
    """kernel / plain / library times (ms) and the bound, at the shapes of
    one full-width engine step at one of PAGED_WIDTHS, cycling through 32
    layers' pools so each launch finds its pages outside L2 as in a real
    step. ``quant``: int8 pools with f32 scales (the plain version
    dequantizes them, SDPA reads K/V dequantized to bf16 and gathered in
    advance)."""
    width = PAGED_WIDTHS[wname]
    kvh, group, d, page = width
    mp = -(-MAX_LEN // page)
    n_pages = SLOTS * mp + 1
    dt = torch.bfloat16
    kp, vp = _pools(torch, n_pages, dt, layers=LAYERS, seed=5, width=width)
    sc = [{}] * LAYERS
    if quant:
        (kq, ks), (vq, vs) = ref.quantize_kv(kp), ref.quantize_kv(vp)
        sc = [dict(k_scale=ks[i], v_scale=vs[i]) for i in range(LAYERS)]
        kp = ref.dequantize_pages(kq, ks).to(dt)  # what SDPA reads
        vp = ref.dequantize_pages(vq, vs).to(dt)
    g = torch.Generator(device="cuda").manual_seed(6)
    lengths = torch.randint(100, 632, (SLOTS,), generator=g, device="cuda",
                            dtype=torch.int32)
    tables = _tables(torch, SLOTS, mp, n_pages, seed=7)
    q = torch.randn(SLOTS, kvh * group, d, generator=g, device="cuda").to(dt)
    qc = torch.randn(CHUNK, kvh * group, d, generator=g,
                     device="cuda").to(dt)
    start = torch.tensor(256, dtype=torch.int32, device="cuda")
    valid = torch.tensor(CHUNK, dtype=torch.int32, device="cuda")
    cpos = torch.arange(CHUNK, dtype=torch.int32, device="cuda")
    last_pos = torch.cat([lengths - 1, 256 + cpos])
    mtables = torch.cat([tables, tables[0:1].expand(CHUNK, mp)]).contiguous()
    qm = torch.cat([q, qc])
    scale = d ** -0.5

    def layer(i):
        if quant:
            return kq[i % LAYERS], vq[i % LAYERS]
        return kp[i % LAYERS], vp[i % LAYERS]

    def dense(tbl, n):
        """Gathered dense K/V for SDPA: (rows, H, n, D) over the q heads."""
        def gather(pool):
            x = pool[tbl.long()].reshape(tbl.shape[0], -1, kvh, d)[:, :n]
            return x.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
        return [(gather(kp[i]), gather(vp[i])) for i in range(LAYERS)]

    def decode_row():
        lens = lengths.tolist()
        n_max = max(lens)
        dec_dense = dense(tables, n_max)
        dec_mask = (torch.arange(n_max, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
        return dict(
            kernel=lambda i: ops.paged_attention(
                q, *layer(i), tables, lengths, scale=scale,
                **sc[i % LAYERS]),
            plain=lambda i: ops.paged_attention(
                q, *layer(i), tables, lengths, scale=scale, impl="ref",
                **sc[i % LAYERS]),
            library=lambda i: F.scaled_dot_product_attention(
                q[:, :, None], *dec_dense[i % LAYERS],
                attn_mask=dec_mask),
            bound=_bound(sum(lens), sum(lens), SLOTS, SLOTS * mp, SLOTS, 2,
                         quant, width))

    def prefill_row():
        pre_dense = dense(tables[0:1], 256 + CHUNK)
        kpos = torch.arange(256 + CHUNK, device="cuda")
        pre_mask = (kpos[None, :] <= 256 + cpos[:, None])[None, None]
        return dict(
            kernel=lambda i: ops.paged_prefill_attention(
                qc, *layer(i), tables[0], start, valid, scale=scale,
                **sc[i % LAYERS]),
            plain=lambda i: ops.paged_prefill_attention(
                qc, *layer(i), tables[0], start, valid, scale=scale,
                impl="ref", **sc[i % LAYERS]),
            library=lambda i: F.scaled_dot_product_attention(
                qc.transpose(0, 1)[None], *pre_dense[i % LAYERS],
                attn_mask=pre_mask),
            bound=_bound(256 + CHUNK, sum(257 + c for c in range(CHUNK)),
                         CHUNK, mp, 2, 2, quant, width))

    def mixed_row():
        lens = lengths.tolist()
        mix_n = max(max(lens), 256 + CHUNK)
        mix_dense = dense(mtables, mix_n)
        mix_mask = (torch.arange(mix_n, device="cuda")[None, :]
                    <= last_pos[:, None])[:, None, None, :]
        # as the engine calls it: with the hint (kernel and plain)
        return dict(
            kernel=lambda i: ops.paged_mixed_attention(
                qm, *layer(i), mtables, last_pos, scale=scale,
                num_decode=SLOTS, **sc[i % LAYERS]),
            generic=lambda i: ops.paged_mixed_attention(
                qm, *layer(i), mtables, last_pos, scale=scale,
                **sc[i % LAYERS]),
            plain=lambda i: ops.paged_mixed_attention(
                qm, *layer(i), mtables, last_pos, scale=scale, impl="ref",
                num_decode=SLOTS, **sc[i % LAYERS]),
            library=lambda i: F.scaled_dot_product_attention(
                qm[:, :, None], *mix_dense[i % LAYERS],
                attn_mask=mix_mask),
            # the chunk shares slot 0's table: its positions are slot 0's
            bound=_bound(sum(lens) + max(0, 256 + CHUNK - lens[0]),
                         sum(lens) + sum(257 + c for c in range(CHUNK)),
                         SLOTS + CHUNK, (SLOTS + CHUNK) * mp, SLOTS + CHUNK,
                         2, quant, width))

    makers = {"paged_attention_bkgd": decode_row,
              "paged_prefill_attention_ckgd": prefill_row,
              "paged_mixed_attention_rkgd": mixed_row}
    out = {}
    for name, make in makers.items():
        r = make()  # its gathered K/V for SDPA live for one row
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = _time_ms(torch, r["plain"])
        k1 = _time_ms(torch, r["kernel"])
        k2 = _time_ms(torch, r["kernel"])
        p2 = _time_ms(torch, r["plain"])
        lib = _time_ms(torch, r["library"])
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=lib, bound_ms=r["bound"][0],
                         bound_by=r["bound"][1])
        extra = ""
        if "generic" in r:  # the mixed kernel without the hint
            g1, g2 = (_time_ms(torch, r["generic"]) for _ in range(2))
            out[name]["generic_ms"] = min(g1, g2)
            extra = f" (hinted; without the hint {g1:.4f}/{g2:.4f} ms)"
        log(f"timing {name}{' int8' if quant else ''} [{wname}: KVH {kvh}, "
            f"G {group}, D {d}, page {page}]: kernel {k1:.4f}/{k2:.4f} ms"
            f"{extra}, plain {p1:.4f}/{p2:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")
        del r
    return out


# ---------------------------------------------------------------------------
# phase 10: the SSD kernels against their plain versions
# ---------------------------------------------------------------------------


def _ssd_inputs(torch, g, b, s, dtype, layers=None, h=SSD_H, n=SSD_N):
    """The JAX package's SSD test distribution (tests/test_kernels.py) at
    mamba2 widths (or ``h`` heads of N ``n``): x ~ N(0, 1), dt in [0.1, 1),
    A in (-1.1, -0.1], B/C ~ N(0, 1/N); with ``layers``, a leading layer
    axis on all but A."""
    pre = (layers,) if layers else ()
    x = torch.randn(pre + (b, s, h, SSD_P), generator=g,
                    device="cuda").to(dtype)
    dt = 0.1 + 0.9 * torch.rand(pre + (b, s, h), generator=g, device="cuda")
    A = -torch.rand(h, generator=g, device="cuda") - 0.1
    bc = [(torch.randn(pre + (b, s, n), generator=g, device="cuda")
           / n ** 0.5).to(dtype) for _ in range(2)]
    return x, dt, A, bc[0], bc[1]


def check_ssd_kernels(torch, ops, sk, engine_scans):
    """Both SSD kernels against their plain versions, at mamba2-1.3b's and
    zamba2-2.7b's SSD widths; ``engine_scans`` adds each (B, S, H, N)
    whole-prompt scan from a zero state that the lockstep phases ran.
    Returns the max abs error per kernel over the bf16 cases and logs the
    f32 ones. Every bf16 scan must take the tensor-core kernel, every f32
    one the CUDA-core template (``LAUNCHES_BY_PATH``)."""
    errs = {}
    widths = ((SSD_H, SSD_N), ZAMBA_SSD)

    def compare(name, got, want, tol, label):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        bad = ((got - want).abs() > tol + tol * want.abs()).sum().item()
        if bad or not err == err:
            raise AssertionError(f"{name} [{label}]: {bad} elements outside "
                                 f"atol=rtol={tol} (max abs err {err})")
        return err

    # (B, S, valid, init, H, N): at both widths the engine's chunk (a
    # dt = 0 tail, or full) from a state; S 200 from zero; a whole
    # 512-token prompt; the lockstep phases' prompts
    cases = [(1, CHUNK, valid, True, h, n) for h, n in widths
             for valid in (41, CHUNK)]
    cases += [(2, 200, 200, False, SSD_H, SSD_N),
              (1, 512, 512, False, SSD_H, SSD_N),
              (2, 200, 200, False, *ZAMBA_SSD)]
    cases += [(b, s, s, False, h, n) for b, s, h, n in engine_scans]
    n_scans = len(cases) + 7 * len(widths)
    for dtype, tol in ((torch.bfloat16, SSD_BF16_TOL),
                       (torch.float32, SSD_F32_TOL)):
        label = str(dtype).removeprefix("torch.")
        g = torch.Generator(device="cuda").manual_seed(11)
        e_scan = 0.0
        sk.reset_launches()
        for b, s, valid, with_init, h, n in cases:
            x, dt, A, Bm, Cm = _ssd_inputs(torch, g, b, s, dtype, h=h, n=n)
            dt[:, valid:] = 0.0
            init = (torch.randn(b, h, SSD_P, n, generator=g, device="cuda")
                    if with_init else None)
            y, fs = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init)
            yr, fsr = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init,
                                   impl="ref")
            case = (f"{label} B={b} S={s} valid={valid} init={with_init} "
                    f"H={h} N={n}")
            e_scan = max(e_scan,
                         compare("ssd_scan_bshp y", y, yr, tol, case),
                         compare("ssd_scan_bshp state", fs, fsr, tol, case))
        # the engines' pattern: 7 chained 64-token calls carrying the
        # state against one plain call over the 448 tokens
        for h, n in widths:
            x, dt, A, Bm, Cm = _ssd_inputs(torch, g, 1, 7 * CHUNK, dtype,
                                           h=h, n=n)
            init = torch.randn(1, h, SSD_P, n, generator=g, device="cuda")
            yr, fsr = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init,
                                   impl="ref")
            fs, ys = init, []
            for k in range(7):
                sl = slice(k * CHUNK, (k + 1) * CHUNK)
                y, fs = ops.ssd_scan(x[:, sl], dt[:, sl], A, Bm[:, sl],
                                     Cm[:, sl], init_state=fs, chunk=CHUNK)
                ys.append(y)
            case = f"{label} 7 chained chunks H={h} N={n}"
            e_scan = max(e_scan,
                         compare("ssd_scan_bshp y", torch.cat(ys, 1), yr,
                                 tol, case),
                         compare("ssd_scan_bshp state", fs, fsr, tol, case))
        paths = dict(sk.LAUNCHES_BY_PATH)
        want = "mma" if dtype == torch.bfloat16 else "cuda_core"
        if paths[want] != n_scans or sum(paths.values()) != n_scans:
            raise AssertionError(f"{label} scans took {paths}, expected all "
                                 f"{n_scans} through {want}")
        # the decode step at the engines' SLOTS rows: gated by an active
        # vector with idle rows (the SSM engine), and ungated (lockstep)
        e_dec = 0.0
        for h, n in widths:
            x, dt, A, Bm, Cm = _ssd_inputs(torch, g, SLOTS, 1, dtype, h=h,
                                           n=n)
            step = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
            for active in (torch.tensor([1, 0, 1, 1, 0, 1, 0, 1],
                                        dtype=torch.int32, device="cuda"),
                           None):
                state = torch.randn(SLOTS, h, SSD_P, n, generator=g,
                                    device="cuda")
                yr, sr = ops.ssd_decode_step(state.clone(), *step,
                                             active=active, impl="ref")
                old = state.clone()
                y, s_out = ops.ssd_decode_step(state, *step, active=active)
                case = f"{label} H={h} N={n} active={active is not None}"
                if s_out.data_ptr() != state.data_ptr():
                    raise AssertionError(f"ssd_decode_step_bh [{case}]: made "
                                         f"a copy of the state instead of "
                                         f"advancing it in place")
                if active is not None:
                    idle = active == 0
                    if not torch.equal(state[idle], old[idle]):
                        raise AssertionError(f"ssd_decode_step_bh [{case}]: "
                                             f"an idle slot's state changed")
                e_dec = max(e_dec,
                            compare("ssd_decode_step_bh y", y, yr, tol, case),
                            compare("ssd_decode_step_bh state", state, sr,
                                    tol, case))
        log(f"ssd kernel check {label}: {n_scans} scans (H/N {widths}; "
            f"lockstep (B, S, H, N) {engine_scans}) {e_scan:.3e} (paths "
            f"{paths}), decode at {SLOTS} slots, gated and not, "
            f"{e_dec:.3e} (atol=rtol={tol}); idle slots untouched")
        if dtype == torch.bfloat16:
            errs = {"ssd_scan_bshp": e_scan, "ssd_decode_step_bh": e_dec}
    return errs


def _ssd_bound(b, s, elt, decode, written=None, h=SSD_H, n=SSD_N,
               read_state=True):
    """Least time for one SSD call at mamba2 widths (or ``h`` heads of N
    ``n``): the bytes it must move (inputs read once, outputs written once;
    the f32 state read for all b rows and written for the ``written`` rows,
    all b unless given: the in-place decode step writes only its active
    slots; a scan without an entering state reads none) against its
    operations at the inputs' type's peak. The scan counts the chunked
    algorithm at the kernel's 64-token chunk: causal C B^T, the decay mask,
    the causal (scores)(x dt), C state and the state update.
    Returns (ms, 'bytes' | 'operations')."""
    p = SSD_P
    written = b if written is None else written
    if decode:
        state_bytes = (b + written) * h * p * n * 4
        nbytes = (state_bytes + 2 * b * h * p * elt + b * h * 4 + h * 4
                  + 2 * b * n * elt + b * 4)
        flops = 5 * b * h * p * n + b * h * p
    else:
        state_bytes = (written + (b if read_state else 0)) * h * p * n * 4
        nbytes = (state_bytes + 2 * b * s * h * p * elt + b * s * h * 4
                  + h * 4 + 2 * b * s * n * elt)
        q = min(64, s)
        pairs = q * (q + 1) // 2
        per_chunk = (2 * pairs * n + h * pairs + 2 * h * p * pairs
                     + 4 * h * q * p * n + h * p * n)
        flops = b * (-(-s // q)) * per_chunk
    rate = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ssd_kernels(torch, ops, sk):
    """kernel / plain times (ms) and the bound at the shapes of one
    full-width mamba2 engine step (bf16): decode over 8 slots (2 idle, so
    the bound counts 6 slots' state written back) in place, and one
    64-token prefill chunk of one sequence from a carried state, each
    cycling through 48 layers' states so every launch finds its state
    outside L2, as in a real step. Then the scan alone at a whole
    512-token prompt from zero (B 1) and at zamba2-2.7b's SSD widths (H 80,
    N 64; the engine's chunk from a state), kernel calls only: no engine
    takes those yet. No single PyTorch call computes either function:
    library_ms is null. Logs the scan's LAUNCHES_BY_PATH over the timed
    calls."""
    g = torch.Generator(device="cuda").manual_seed(12)
    dt_ = torch.bfloat16
    bank = torch.randn(M_LAYERS, SLOTS, SSD_H, SSD_P, SSD_N, generator=g,
                       device="cuda")
    dx, ddt, A, dB, dC = _ssd_inputs(torch, g, SLOTS, 1, dt_, M_LAYERS)
    active = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.int32,
                          device="cuda")

    def decode(impl):
        def fn(i):
            l = i % M_LAYERS
            ops.ssd_decode_step(bank[l], dx[l, :, 0], ddt[l, :, 0], A,
                                dB[l, :, 0], dC[l, :, 0], active=active,
                                impl=impl)
        return fn

    def scan_inputs(s, with_init, h=SSD_H, n=SSD_N):
        sx, sdt, sA, sB, sC = _ssd_inputs(torch, g, 1, s, dt_, M_LAYERS,
                                          h=h, n=n)
        init = (torch.randn(M_LAYERS, 1, h, SSD_P, n, generator=g,
                            device="cuda") if with_init else None)

        def scan(impl):
            def fn(i):
                l = i % M_LAYERS
                ops.ssd_scan(sx[l], sdt[l], sA, sB[l], sC[l],
                             init_state=None if init is None else init[l],
                             impl=impl)
            return fn
        return scan

    n_active = int(active.sum().item())
    rows = {"ssd_decode_step_bh": (decode, _ssd_bound(SLOTS, 1, 2, True,
                                                       n_active)),
            "ssd_scan_bshp": (scan_inputs(CHUNK, True),
                              _ssd_bound(1, CHUNK, 2, False))}
    out = {}
    sk.reset_launches()
    for name, (make, bound) in rows.items():
        p1 = _time_ms(torch, make("ref"), iters=96)
        k1 = _time_ms(torch, make("auto"), iters=96)
        k2 = _time_ms(torch, make("auto"), iters=96)
        p2 = _time_ms(torch, make("ref"), iters=96)
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=None, bound_ms=bound[0],
                         bound_by=bound[1])
        log(f"timing {name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, no library call, bound "
            f"{bound[0]:.5f} ms ({bound[1]})")
    del bank
    for label, make, bound in (
            ("S 512 from zero", scan_inputs(512, False),
             _ssd_bound(1, 512, 2, False, written=1, read_state=False)),
            ("zamba2 H 80 N 64", scan_inputs(CHUNK, True, *ZAMBA_SSD),
             _ssd_bound(1, CHUNK, 2, False, h=ZAMBA_SSD[0],
                        n=ZAMBA_SSD[1]))):
        k1 = _time_ms(torch, make("auto"), iters=48)
        p1 = _time_ms(torch, make("ref"), iters=48)
        k2 = _time_ms(torch, make("auto"), iters=48)
        log(f"timing ssd_scan_bshp [{label}]: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})")
    log(f"timing ssd_scan_bshp paths: {dict(sk.LAUNCHES_BY_PATH)}")
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the engine
# ---------------------------------------------------------------------------


def _requests(serving, n, rng, sampled_every):
    shared = rng.integers(1, 49152, 128).tolist()
    reqs = []
    for i in range(n):
        plen = int(rng.integers(100, 601))
        if i % 2 == 0:
            prompt = shared + rng.integers(1, 49152, plen - 128).tolist()
        else:
            prompt = rng.integers(1, 49152, plen).tolist()
        sp = (serving.SamplingParams(temperature=0.8, top_p=0.9,
                                     max_new_tokens=32, seed=1000 + i)
              if sampled_every and i % sampled_every == 1 else
              serving.SamplingParams(max_new_tokens=32, seed=1000 + i))
        reqs.append(serving.Request(f"r{i}", prompt, sampling=sp))
    return reqs


def _drive(torch, engine, reqs):
    handles = [engine.submit(r) for r in reqs]
    steps = 0
    while not engine.idle:
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    return handles, steps


def _random_requests(serving, n, rng, sampled_every, *, lo, hi, max_new,
                     uid, vocab, seed0):
    """n requests of random prompts of lo..hi tokens, max_new new tokens
    each; every ``sampled_every``-th one (from the second) seeded top-p,
    the rest greedy."""
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
        sp = (serving.SamplingParams(temperature=0.8, top_p=0.9,
                                     max_new_tokens=max_new, seed=seed0 + i)
              if sampled_every and i % sampled_every == 1 else
              serving.SamplingParams(max_new_tokens=max_new, seed=seed0 + i))
        reqs.append(serving.Request(f"{uid}{i}", prompt.tolist(),
                                    sampling=sp))
    return reqs


def _check_served(np, cfg, results, max_new):
    bad = [(r.uid, r.finish_reason.value) for r in results
           if r.finish_reason.value != "length" or len(r.tokens) != max_new]
    if bad:
        raise AssertionError(f"requests not finished by length: {bad}")
    for r in results:
        toks = np.asarray(r.tokens)
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{r.uid}: token out of vocab")


def _log_run(name, cfg, card, reqs, results, wall, steps, extra):
    from repro_torch.serving.metrics import latency_percentiles

    lat = latency_percentiles(results)
    n_tok = sum(len(r.tokens) for r in results)
    log(f"{name} {cfg.name} bf16 on {card}: {len(results)}/{len(reqs)} "
        f"requests ({sum(len(r.prompt) for r in reqs)} prompt tokens), "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s;"
        f" TTFT p50 {lat['ttft_ms'][0]:.1f} ms p99 {lat['ttft_ms'][2]:.1f} ms;"
        f" ITL p50 {lat['itl_ms'][0]:.2f} ms p99 {lat['itl_ms'][2]:.2f} ms")
    log(f"{name} steps {steps}: {extra}")


def run_engine(torch, np, cfg, serving, models, pk, card):
    params = models.build_model(cfg, device="cuda").init(seed=0)
    engine_kw = dict(max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
                     prefill_chunk=CHUNK, device="cuda")
    engine = serving.ContinuousBatchingEngine(cfg, params, **engine_kw)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, engine, _requests(serving, 2, rng, sampled_every=2))
    engine = serving.ContinuousBatchingEngine(cfg, params, **engine_kw)
    reqs = _requests(serving, 16, rng, sampled_every=2)
    pk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 32)
    hits = engine.cache.stats["prefix_hits"]
    if hits <= 0:
        raise AssertionError("no prefix hits on the shared-prefix requests")
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"a route never ran its kernel: {launches}")
    st = engine.stats
    _log_run("engine", cfg, card, reqs, results, wall, steps,
             f"decode_steps {st['decode_steps']}, prefill_chunks "
             f"{st['prefill_chunks']}, preemptions {st['preemptions']}, "
             f"prefix hits {hits} "
             f"({engine.cache.stats['prefix_tokens_reused']} tokens "
             f"reused); kernel launches {launches} over {LAYERS} layers per "
             f"dispatch")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch,
           lambda: serving.ContinuousBatchingEngine(cfg, params, **engine_kw),
           _requests(serving, 8, np.random.default_rng(5), sampled_every=0),
           PAGED_TRACE_KEYS, "paged-attention kernels",
           check=PAGED_BF16_CHECK)
    return launches


def _trace(torch, make_engine, reqs, kernel_keys, label, check=None):
    """Where a step's time goes: a torch.profiler window over a fresh
    engine serving ``reqs``. Device busy = the sum of the device activities
    (kernels, copies, fills) the profiler recorded (one stream, so no
    overlap) over the window's wall time; the kernels' share sums the
    activities whose name holds one of ``kernel_keys``, also logged kernel
    by kernel. The raw events are read, not ``key_averages()``, which takes
    minutes over a window's several hundred thousand events.
    ``check``: (the kernels the window must show, the ones it must not),
    for a bf16 engine (PAGED_BF16_CHECK, SSD_BF16_CHECK,
    ZAMBA_BF16_CHECK)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = make_engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, steps = _drive(torch, engine, reqs)
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_name = {}  # device activity name -> [ms, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0:
        log("trace: the profiler recorded no device time (not measured)")
        return
    kern_ms = sum(ms for name, (ms, _) in by_name.items()
                  if any(k in name for k in kernel_keys))
    for key in kernel_keys:
        hits = [(ms, n) for name, (ms, n) in by_name.items() if key in name]
        if hits:
            ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
            log(f"trace kernel: {key} {ms:.2f} ms x{n} "
                f"({1e3 * ms / n:.2f} us each) = "
                f"{100 * ms / busy_ms:.1f}% of busy")
    if check:
        shown, barred = check
        stale = [name for name in by_name if any(b in name for b in barred)]
        missing = [k for k in shown if not any(k in name for name in by_name)]
        if stale or missing:
            raise AssertionError(f"a bf16 window ran a CUDA-core template "
                                 f"or missed {missing}: {stale}")
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    log(f"trace: {steps} steps in {wall_ms:.1f} ms wall "
        f"({wall_ms / steps:.2f} ms/step); device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / wall_ms:.1f}% (idle {100 - 100 * busy_ms / wall_ms:.1f}%);"
        f" {label} {kern_ms:.1f} ms = "
        f"{100 * kern_ms / busy_ms:.1f}% of busy; "
        f"{sum(n for _, n in by_name.values())} device ops")
    for name, (ms, n) in top:
        log(f"trace top: {ms:9.2f} ms x{n:6d}  {name[:90]}")


def _chunk_logits(torch, np, model, impl):
    """Logits of one 64-token prompt chunk into an empty pool."""
    cfg = model.cfg
    model.attn_impl = impl
    shape = (cfg.num_layers, 6, PAGE, KVH, D)  # null page, 4 pages, sink
    pages = {"k": torch.zeros(shape, device="cuda"),
             "v": torch.zeros(shape, device="cuda")}
    row = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, CHUNK).astype(np.int32)).cuda()
    start = torch.tensor(0, dtype=torch.int32, device="cuda")
    valid = torch.tensor(CHUNK, dtype=torch.int32, device="cuda")
    return model.prefill_chunk(pages, row, toks, start, valid)[:cfg.vocab_size]


def run_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off: the engine through the kernels vs through the
    plain versions (``attn_impl="ref"``), greedy streams identical.

    The random-weight model is chaotic in depth: a perturbation of the
    attention output at f32 rounding level (the kernels' online softmax sums
    in another order than the plain versions) grows by orders of magnitude
    per few layers, so at 32 layers the greedy argmax flips on noise while at
    2 layers it cannot. The phase prints the one-chunk logit gap at both
    depths, then asserts stream identity at PARITY_LAYERS (full width, depth
    cut)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"parity: f32, TF32 off (matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32})")
    for layers in (LAYERS, PARITY_LAYERS):
        cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
        model = models.build_model(cfg32, device="cuda")
        model.init(seed=1)
        a = _chunk_logits(torch, np, model, "auto")
        b = _chunk_logits(torch, np, model, "ref")
        gap = (a - b).abs().max().item()
        top2 = b.topk(2).values
        log(f"parity: {layers} layers, one 64-token chunk: max |logit "
            f"kernel - plain| = {gap:.3e}, argmax {a.argmax().item()} vs "
            f"{b.argmax().item()}, plain top-2 margin "
            f"{(top2[0] - top2[1]).item():.3e}")
        if layers == PARITY_LAYERS and not gap < 1e-3:
            raise AssertionError(f"kernel vs plain logits differ by {gap}")
        del model
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)
    streams = {}
    for impl in ("auto", "ref"):
        engine = serving.ContinuousBatchingEngine(
            cfg32, params, max_len=MAX_LEN, max_slots=4, page_size=PAGE,
            prefill_chunk=CHUNK, attn_impl=impl, device="cuda")
        rng = np.random.default_rng(3)
        reqs = [serving.Request(
            f"g{i}", rng.integers(1, 49152, int(rng.integers(70, 200))).tolist(),
            sampling=serving.SamplingParams(max_new_tokens=16))
            for i in range(5)]
        handles, _ = _drive(torch, engine, reqs)
        streams[impl] = [list(h.tokens) for h in handles]
    if streams["auto"] != streams["ref"]:
        raise AssertionError(f"f32 kernel vs plain streams differ: {streams}")
    log(f"parity: {PARITY_LAYERS} layers, full width: "
        f"{len(streams['auto'])} greedy streams of 16 tokens identical "
        f"through kernels and plain versions")


# ---------------------------------------------------------------------------
# phases 18-20: int8 pages and the KV tiers in the engine
# ---------------------------------------------------------------------------


def run_int8_engine(torch, np, cfg, serving, models, pk, card):
    """Phase 4's trace through the chunked engine with int8 pages, in turns
    with bf16 pages (bf16, int8, int8, bf16: one call's host drifts, so the
    two are compared side by side), then a profiler window of each.
    Returns the paged kernels' launch counts over the first int8 run."""
    params = models.build_model(cfg, device="cuda").init(seed=0)

    def make(quant):
        return serving.ContinuousBatchingEngine(
            cfg, params, max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
            prefill_chunk=CHUNK, kv_quant=quant, device="cuda")

    def requests():  # phase 4's: 2 warm-up requests, then 16 measured
        rng = np.random.default_rng(0)
        return (_requests(serving, 2, rng, sampled_every=2),
                _requests(serving, 16, rng, sampled_every=2))

    for quant in ("none", "int8"):
        _drive(torch, make(quant), requests()[0])  # warm-up
    launches = None
    for turn, quant in enumerate(("none", "int8", "int8", "none")):
        engine = make(quant)
        reqs = requests()[1]
        first_int8 = quant == "int8" and launches is None
        if first_int8:
            if engine.cache.pages["k"].dtype != torch.int8:
                raise AssertionError("kv_quant='int8' built a pool of "
                                     f"{engine.cache.pages['k'].dtype}")
            pk.reset_launches()
        t0 = time.perf_counter()
        handles, steps = _drive(torch, engine, reqs)
        wall = time.perf_counter() - t0
        if first_int8:
            launches = dict(pk.LAUNCHES)
            if not all(launches[k] > 0 for k in launches):
                raise AssertionError(f"a route never ran its kernel: "
                                     f"{launches}")
        results = [h.result() for h in handles]
        _check_served(np, cfg, results, 32)
        hits = engine.cache.stats["prefix_hits"]
        if hits <= 0:
            raise AssertionError("no prefix hits on the shared-prefix requests")
        _log_run(f"int8 phase, {quant} pages, turn {turn + 1}", cfg, card,
                 reqs, results, wall, steps,
                 f"{1e3 * wall / steps:.2f} ms/step, prefill_chunks "
                 f"{engine.stats['prefill_chunks']}, prefix hits {hits}; "
                 f"pool {engine.cache.page_nbytes} B per page"
                 + (f"; kernel launches {launches}" if first_int8 else ""))
        del engine
    for quant in ("none", "int8"):
        _trace(torch, lambda quant=quant: make(quant),
               _requests(serving, 8, np.random.default_rng(5),
                         sampled_every=0),
               PAGED_TRACE_KEYS, f"paged-attention kernels "
               f"({quant} pages)", check=PAGED_BF16_CHECK)
    return launches


class _UploadLog:
    """Records (page, content key) for every page a cache uploads from the
    host or persisted tier, to hold the pages against the store later."""

    def __init__(self, cache):
        self.uploads, inner = [], cache._upload_page

        def upload(page, arrays):
            inner(page, arrays)
            self.uploads.append(page)

        cache._upload_page = upload


def _check_reloaded(torch, np, engine, store_root, keys):
    """Every reloaded page still registered under its content key holds,
    byte for byte, what the store kept under that key for each pool tensor
    in ``keys``. Returns how many pages were compared."""
    from repro_torch.core.storage import ArtifactStore

    cache, store = engine.cache, ArtifactStore(store_root)
    index = cache.tiers.persist_index
    torch.cuda.synchronize()
    n = 0
    for page in set(engine._uploads.uploads):
        ck = cache._page_ck.get(page)
        if ck is None or ck.hex() not in index:
            continue  # the page was reclaimed and reused since
        got, refs = cache._read_page(page), index[ck.hex()]
        if set(refs) != keys:
            raise AssertionError(f"page {page} persisted {sorted(refs)}")
        for key, ref_ in refs.items():
            want = store.get(ref_)
            if got[key].dtype != want.dtype or not np.array_equal(got[key],
                                                                  want):
                raise AssertionError(f"reloaded page {page} [{key}] differs "
                                     f"from the persisted bytes")
        n += 1
    if n == 0:
        raise AssertionError("no reloaded page left to compare")
    return n


def run_tier_restart(torch, np, cfg, serving, models, pk, card, quant):
    """Full-width smollm-360m, bf16 or int8 pages (``quant``), a pool small
    enough to reclaim: the run spills parked pages to host RAM and a
    persisted store; a NEW engine on the same store reruns the prompts
    from persisted pages. Returns the paged kernels' launch counts over
    both runs."""
    from repro_torch.serving.metrics import latency_percentiles

    params = models.build_model(cfg, device="cuda").init(seed=0)
    with tempfile.TemporaryDirectory(prefix="kv_tiers_") as tmp:
        kw = dict(max_len=MAX_LEN, max_slots=SLOTS, page_size=PAGE,
                  prefill_chunk=CHUNK, num_pages=TIER_PAGES,
                  host_pages=TIER_HOST_PAGES, persist_dir=tmp,
                  kv_quant=quant, device="cuda")
        pk.reset_launches()
        runs = []
        for label in ("first run", "restart"):
            engine = serving.ContinuousBatchingEngine(cfg, params, **kw)
            want = {"k", "v"} | ({"k_scale", "v_scale"} if quant == "int8"
                                 else set())
            if set(engine.cache.pages) != want:
                raise AssertionError(f"kv_quant={quant!r} built pool tensors "
                                     f"{sorted(engine.cache.pages)}")
            engine._uploads = _UploadLog(engine.cache)
            reqs = _requests(serving, 16, np.random.default_rng(7),
                             sampled_every=2)
            t0 = time.perf_counter()
            handles, steps = _drive(torch, engine, reqs)
            wall = time.perf_counter() - t0
            results = [h.result() for h in handles]
            _check_served(np, cfg, results, 32)
            t = engine.cache.tiers.counters
            lat = latency_percentiles(results)
            _log_run(f"tiers ({quant} pages) {label}", cfg, card, reqs,
                     results, wall, steps,
                     f"prefill_chunks {engine.stats['prefill_chunks']}, "
                     f"preemptions {engine.stats['preemptions']}; tiers "
                     + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                 else f"{k} {v}" for k, v in t.items()))
            if label == "first run":
                if not (t["reclaimed_pages"] > 0 and t["spilled_pages"] > 0):
                    raise AssertionError(f"the pool never reclaimed and "
                                         f"spilled parked pages: {t}")
                flushed = engine.cache.flush_tiers()
                log(f"tiers ({quant} pages): flush_tiers() spilled {flushed} "
                    f"parked pages; {engine.cache.tiers.persisted_count} "
                    f"pages persisted ({engine.cache.page_nbytes} B each)")
            else:
                if not t["persist_hits"] > 0:
                    raise AssertionError(f"the restart found no persisted "
                                         f"page: {t}")
                n = _check_reloaded(torch, np, engine, tmp, want)
                log(f"tiers ({quant} pages): {n} reloaded pages equal the "
                    f"persisted bytes of {sorted(want)} under their content "
                    f"keys")
            runs.append((engine.stats["prefill_chunks"], lat, results))
            del engine
        launches = dict(pk.LAUNCHES)
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"a route never ran its kernel: {launches}")
    (c1, lat1, _), (c2, lat2, _) = runs
    if not c2 < c1:
        raise AssertionError(f"the restart prefilled {c2} chunks, the first "
                             f"run {c1}")
    log(f"tiers ({quant} pages): restart prefill chunks {c2} vs {c1}; TTFT "
        f"p50 {lat1['ttft_ms'][0]:.1f} -> {lat2['ttft_ms'][0]:.1f} ms, p99 "
        f"{lat1['ttft_ms'][2]:.1f} -> {lat2['ttft_ms'][2]:.1f} ms")
    return launches


def _record_dispatches(engine):
    """Record the interleaved engine's dispatches: ("d", uids decoded) for
    each decode over ``max_slots`` rows, ("c", uid, start, valid) for each
    CHUNK-row prefill chunk."""
    ex, sched, log_ = engine.executor, engine.scheduler, []
    decode, chunk = ex.decode, ex.prefill_chunk

    def rec_decode(inputs=None):
        log_.append(("d", tuple(sorted(seq.handle.uid
                                       for _, seq in sched.decoding()))))
        return decode(inputs)

    def rec_chunk(work):
        log_.append(("c", work.seq.handle.uid, work.start, work.valid))
        return chunk(work)

    ex.decode, ex.prefill_chunk = rec_decode, rec_chunk
    return log_


def run_tier_int8_parity(torch, np, cfg, serving, models):
    """f32, TF32 off, PARITY_LAYERS layers: int8 streams through the kernels
    = through the plain versions; the tiered run, its restart from the
    store and an untiered run give the same streams.

    With one slot all three runs step through the same shapes (a reused
    prefix ends on a chunk boundary: 128 = 2 x 64). With four slots, in
    the interleaved step mode, every decode dispatch has ``max_slots`` rows
    and every chunk CHUNK rows, whatever the schedule, so no row's matmul
    shape depends on the schedule (a fused step's are slots + CHUNK rows,
    a decode-only step's slots rows; a fused 4-slot tiered run and an
    untiered run on a pool of another size once differed in one greedy
    token on an H100 80GB HBM3, 700 W). The 4-slot runs share TIER_PARITY_PAGES, a
    pool on which the tiered run reclaims and spills while other slots are
    live and preempts nothing, so its dispatches must equal the untiered
    run's one for one; the restart skips the persisted chunks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)

    def streams(slots=4, **kw):
        engine = serving.ContinuousBatchingEngine(
            cfg32, params, max_len=MAX_LEN, max_slots=slots, page_size=PAGE,
            prefill_chunk=CHUNK, device="cuda", **kw)
        dispatches = (_record_dispatches(engine)
                      if kw.get("step_mode") == "interleaved" else None)
        reqs = _requests(serving, 8, np.random.default_rng(9),
                         sampled_every=0)
        handles, _ = _drive(torch, engine, reqs)
        return [list(h.tokens) for h in handles], engine, dispatches

    runs = {impl: streams(kv_quant="int8", attn_impl=impl)[0]
            for impl in ("auto", "ref")}
    if runs["auto"] != runs["ref"]:
        raise AssertionError(f"f32 int8 kernel vs plain streams differ: {runs}")
    log(f"tier + int8 parity: f32, {PARITY_LAYERS} layers, full width: 8 "
        f"greedy int8 streams of 32 tokens identical through kernels and "
        f"plain versions")
    for slots, quant, pages, mode in (
            (1, "none", TIER_PAGES // 2, "fused"),
            (4, "none", TIER_PARITY_PAGES, "interleaved"),
            (4, "int8", TIER_PARITY_PAGES, "interleaved")):
        kw = dict(slots=slots, num_pages=pages, kv_quant=quant,
                  step_mode=mode)
        with tempfile.TemporaryDirectory(prefix="kv_tiers_") as tmp:
            tier_kw = dict(kw, host_pages=16, persist_dir=tmp)
            tiered, engine, d_tiered = streams(**tier_kw)
            t = dict(engine.cache.tiers.counters)
            pre = [engine.stats["preemptions"]]
            if not (t["spilled_pages"] > 0 and t["reclaimed_pages"] > 0):
                raise AssertionError(f"the parity run never spilled: {t}")
            engine.cache.flush_tiers()
            restart, engine, _ = streams(**tier_kw)
            hits = engine.cache.tiers.counters["persist_hits"]
            pre.append(engine.stats["preemptions"])
            if not hits > 0:
                raise AssertionError("the parity restart found no persisted "
                                     "page")
        untiered, engine, d_untiered = streams(kv_tiers=False, **kw)
        pre.append(engine.stats["preemptions"])
        if slots > 1:
            if any(pre):
                raise AssertionError(f"preemptions {pre} (tiered, restart, "
                                     f"untiered): recomputed rows break the "
                                     f"comparison")
            if d_tiered != d_untiered:
                raise AssertionError("the tiered run dispatched other steps "
                                     "than the untiered run")
        if not tiered == restart == untiered:
            raise AssertionError(
                f"{slots} slot(s), {quant} pages: tiered / restart / untiered"
                f" streams differ: {tiered} / {restart} / {untiered}")
        log(f"tier parity: {slots} slot(s), {quant} pages, {pages} pages, "
            f"{mode} steps: tiered ({t['reclaimed_pages']} reclaimed, "
            f"{t['spilled_pages']} spilled, {t['host_hits']} host hits) = "
            f"restart from the store ({hits} persisted hits) = untiered"
            + (f"; tiered and untiered dispatched the same {len(d_tiered)} "
               f"steps" if slots > 1 else ""))


def run_serve_tiers(card):
    """The serving driver, as a user runs it, on the card at full width:
    ``python -m repro_torch.launch.serve --kv-quant int8 --host-pages 8
    --persist-dir DIR`` twice on one directory. Both serve every request;
    only the second reports persisted hits (``tier_hits=.../pvN``)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory(prefix="serve_tiers_") as tmp:
        for n in (1, 2):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve",
                 "--requests", "12", "--max-new", "8", "--shared-prefix",
                 "32", "--kv-quant", "int8", "--host-pages", "8",
                 "--persist-dir", f"{tmp}/kv", "--workdir", f"{tmp}/run{n}"],
                capture_output=True, text=True, env=env, timeout=300,
                cwd=ROOT)
            if run.returncode != 0:
                raise AssertionError(f"serve run {n} exited {run.returncode}:"
                                     f" {run.stderr[-2000:]}")
            hits = re.search(r"tier_hits=dev\d+/host\d+/pv(\d+);",
                             run.stdout)
            if "served 12/12" not in run.stdout or not hits:
                raise AssertionError(f"serve run {n}: {run.stdout[-2000:]}")
            if (int(hits.group(1)) > 0) != (n == 2):
                raise AssertionError(f"serve run {n}: persisted hits "
                                     f"{hits.group(1)}")
            served = next(line for line in run.stdout.splitlines()
                          if line.startswith("served"))
            log(f"serve driver run {n} on {card} (--kv-quant int8 "
                f"--host-pages 8 --persist-dir, {time.perf_counter() - t0:.1f}"
                f" s with start-up): {served}; tier_hits=...pv{hits.group(1)}")


# ---------------------------------------------------------------------------
# phases 6-9: the flash kernel, the lockstep and whole-prompt engines
# ---------------------------------------------------------------------------


def _flash_plain(ref, q, k, v, causal):
    """The plain version on the kernel's (B, H, S, D) layout: the op's
    chunked reference, one K/V block when Skv is ragged."""
    skv = k.shape[2]
    out = ref.flash_attention_chunked(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, chunk_kv=256 if skv % 256 == 0 else skv)
    return out.transpose(1, 2)


def check_flash(torch, fk, ref, engine_shapes, d80_shapes):
    """The flash kernel against its plain version at smollm widths: fixed
    ragged and contract cases, every whole-prompt bucket, and each
    (B, S) in ``engine_shapes`` (the prefills the engine phases ran); then
    at zamba2's D 80 (32 heads, G 1; with each (B, S) in ``d80_shapes``,
    the lockstep zamba2 prefills) and llama3's D 128 (32 / 8 heads),
    causal and not. Returns the max abs error over the smollm bf16 cases
    and logs the rest."""
    cases = [(LOCK_BATCH, s, s, True) for s in (1, 64, 100, 256, 300, 512)]
    cases += [(LOCK_BATCH, 64, 320, True), (LOCK_BATCH, 37, 300, False)]
    buckets = [1 << i for i in range(7, WHOLE_MAX_LEN.bit_length())]
    shapes = sorted({(1, s) for s in buckets} | set(engine_shapes))
    cases += [(b, s, s, True) for b, s in shapes if (b, s, s, True)
              not in cases]
    d80_cases = [(2, 100, 100, True), (1, 256, 256, True),
                 (2, 37, 300, False), (1, 64, 320, True)]
    d128_cases = d80_cases + [(1, 512, 512, True), (LOCK_BATCH, 256, 256,
                                                     True)]
    d80_cases += [(b, s, s, True) for b, s in sorted(set(d80_shapes))]
    widths = {"smollm": (FLASH_WIDTHS["smollm D64"], cases),
              "D 80": (FLASH_WIDTHS["zamba2 D80"], d80_cases),
              "D 128": (FLASH_WIDTHS["llama3 D128"], d128_cases)}
    err_bf16 = 0.0
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        label = str(dtype).removeprefix("torch.")
        g = torch.Generator(device="cuda").manual_seed(31)
        worst = {}
        for wname, ((h, kvh, d), wcases) in widths.items():
            worst[wname] = 0.0
            for b, sq, skv, causal in wcases:
                q = torch.randn(b, h, sq, d, generator=g,
                                device="cuda").to(dtype)
                k, v = (torch.randn(b, kvh, skv, d, generator=g,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                got = fk.flash_attention_bhsd(q, k, v, causal=causal)
                want = _flash_plain(ref, q, k, v, causal)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not err <= tol:
                    raise AssertionError(
                        f"flash_attention_bhsd [{label} {wname} B={b} Sq={sq}"
                        f" Skv={skv} causal={causal}]: max abs err {err} > "
                        f"{tol}")
                worst[wname] = max(worst[wname], err)
        log(f"flash kernel check {label}: {len(cases)} cases (H {FLASH_H}, "
            f"KVH {KVH}, D {D}; B 8: Sq=Skv 1..512, Sq 64 < Skv 320, "
            f"non-causal 37 x 300; B 1: buckets {buckets}; engine (B, S) "
            f"{sorted(set(engine_shapes))}): max abs err "
            f"{worst['smollm']:.3e} (bound {tol})")
        log(f"flash kernel check {label} D 80 (32 heads, G 1; causal 100, "
            f"256 and 64 < 320, non-causal 37 x 300; lockstep zamba2 (B, S) "
            f"{sorted(set(d80_shapes))}): max abs err {worst['D 80']:.3e} "
            f"(bound {tol})")
        log(f"flash kernel check {label} D 128 (32 / 8 heads; the D 80 cases"
            f", B 1 x 512 and B 8 x 256): max abs err {worst['D 128']:.3e} "
            f"(bound {tol})")
        if dtype == torch.bfloat16:
            err_bf16 = worst["smollm"]
    return {"flash_attention_bhsd": err_bf16}


def _flash_bound(b, sq, skv, causal, elt, width=None):
    """Least time for one flash call at FLASH_WIDTHS[width] (smollm's by
    default): q, k, v read once and out written once, against 4 D H flops
    per attended (query, key) pair at the inputs' type's peak. Returns
    (ms, 'bytes' | 'operations')."""
    h, kvh, d = FLASH_WIDTHS[width or "smollm D64"]
    nbytes = elt * d * b * (2 * h * sq + 2 * kvh * skv)
    off = skv - sq
    pairs = (sum(off + i + 1 for i in range(sq)) if causal else sq * skv) * b
    flops = 4 * d * h * pairs
    rate = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_flash(torch, F, fk, ref):
    """kernel / plain / SDPA times (ms) and the bound at the two engine
    shapes (bf16, causal) at every one of FLASH_WIDTHS, each cycling over
    32 layers' inputs so every launch reads them from HBM. Returns smollm's
    lockstep row (the one the kernels line carries) and logs all."""
    rows = {}
    for wname, (h, kvh, d) in FLASH_WIDTHS.items():
        for label, b, s in (("lockstep", LOCK_BATCH, 256),
                            ("whole-prompt", 1, 512)):
            g = torch.Generator(device="cuda").manual_seed(32)
            qs = torch.randn(LAYERS, b, h, s, d, generator=g,
                             device="cuda").to(torch.bfloat16)
            ks, vs = (torch.randn(LAYERS, b, kvh, s, d, generator=g,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            # the plain version's own (B, S, H, D) layout, made in advance
            qt, kt, vt = (x.transpose(2, 3).contiguous() for x in (qs, ks, vs))

            def kernel(i):
                l = i % LAYERS
                fk.flash_attention_bhsd(qs[l], ks[l], vs[l], causal=True)

            def plain(i):
                l = i % LAYERS
                ref.flash_attention_chunked(qt[l], kt[l], vt[l], causal=True,
                                            chunk_kv=256)

            def library(i):
                l = i % LAYERS
                F.scaled_dot_product_attention(qs[l], ks[l], vs[l],
                                               is_causal=True,
                                               enable_gqa=True)

            p1 = _time_ms(torch, plain, iters=32)
            k1 = _time_ms(torch, kernel)
            k2 = _time_ms(torch, kernel)
            p2 = _time_ms(torch, plain, iters=32)
            lib = _time_ms(torch, library)
            bound = _flash_bound(b, s, s, True, 2, wname)
            rows[wname, label] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                      library_ms=lib, bound_ms=bound[0],
                                      bound_by=bound[1])
            log(f"timing flash_attention_bhsd {label} [{wname}: H {h}, KVH "
                f"{kvh}] (B {b}, S {s}, causal, bf16): kernel "
                f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, sdpa "
                f"{lib:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})")
            del qs, ks, vs, qt, kt, vt
    return {"flash_attention_bhsd": rows["smollm D64", "lockstep"]}


def _record_prefills(model):
    """Record the token shape (B, S) of each of the model's dense prefills
    (one per lockstep batch or whole-prompt admission) by wrapping its
    entry point; the flash kernel sees (B, H, S, D) at each."""
    shapes = []
    inner = model.prefill

    def prefill(batch, *a, **kw):
        shapes.append(tuple(batch["tokens"].shape))
        return inner(batch, *a, **kw)

    model.prefill = prefill
    return shapes


def run_lockstep(torch, np, cfg, serving, models, fk, card):
    """Full-width smollm-360m through the lockstep engine; returns the
    flash kernel's launch count over the measured run and the (B, S) of
    its prefills."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    kw = dict(max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH, device="cuda")
    rng = np.random.default_rng(40)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, serving.GenerationEngine(cfg, params, **kw),
           _random_requests(serving, 2, rng, 2, lo=64, hi=256, max_new=4,
                            uid="l", vocab=49152, seed0=3000))
    engine = serving.GenerationEngine(cfg, params, **kw)
    prefills = _record_prefills(engine.model)
    reqs = _random_requests(serving, 16, rng, 2, lo=64, hi=256, max_new=32,
                            uid="l", vocab=49152, seed0=3000)
    fk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = fk.LAUNCHES["flash_attention_bhsd"]
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 32)
    if not (prefills and launches == LAYERS * len(prefills)):
        raise AssertionError(f"flash launches {launches} != {LAYERS} x "
                             f"{len(prefills)} prefilled batches")
    _log_run("lockstep", cfg, card, reqs, results, wall, steps,
             f"{len(prefills)} prefilled batches (B, S) {prefills}; flash "
             f"launches {launches} = {LAYERS} layers x {len(prefills)}; peak "
             f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
             f" GiB")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch, lambda: serving.GenerationEngine(cfg, params, **kw),
           _random_requests(serving, 8, np.random.default_rng(41), 0, lo=64,
                            hi=256, max_new=32, uid="l", vocab=49152, seed0=3000),
           FLASH_TRACE_KEYS, "flash kernel")
    return launches, prefills


def run_whole_prompt(torch, np, cfg, serving, models, fk, pk, card):
    """Full-width smollm-360m through the paged engine with whole-prompt
    prefill; returns the flash and paged kernels' launch counts over the
    measured run and the (B, S) of its prefills."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    kw = dict(max_len=WHOLE_MAX_LEN, max_slots=SLOTS, page_size=PAGE,
              prefill_chunk=None, device="cuda")
    rng = np.random.default_rng(50)
    _drive(torch, serving.ContinuousBatchingEngine(cfg, params, **kw),
           _random_requests(serving, 2, rng, 2, lo=100, hi=600, max_new=4,
                            uid="w", vocab=49152, seed0=3000))
    engine = serving.ContinuousBatchingEngine(cfg, params, **kw)
    prefills = _record_prefills(engine.model)
    reqs = _random_requests(serving, 8, rng, 2, lo=100, hi=600, max_new=32,
                            uid="w", vocab=49152, seed0=3000)
    fk.reset_launches()
    pk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = fk.LAUNCHES["flash_attention_bhsd"]
    paged = dict(pk.LAUNCHES)
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 32)
    st = engine.stats
    if not (st["prefills"] == len(reqs) and st["preemptions"] == 0
            and len(prefills) == st["prefills"]
            and launches == LAYERS * st["prefills"]):
        raise AssertionError(f"flash launches {launches} != {LAYERS} x "
                             f"{st['prefills']} admissions ({st})")
    if not paged["paged_attention_bkgd"] > 0:
        raise AssertionError(f"the decode kernel never ran: {paged}")
    _log_run("whole-prompt", cfg, card, reqs, results, wall, steps,
             f"{st['prefills']} whole-prompt prefills ((B, S) {sorted(set(prefills))}), "
             f"decode_steps {st['decode_steps']}, prefill_chunks "
             f"{st['prefill_chunks']}; flash launches {launches} = {LAYERS} "
             f"layers x {st['prefills']}; paged launches {paged}")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch, lambda: serving.ContinuousBatchingEngine(cfg, params, **kw),
           _random_requests(serving, 8, np.random.default_rng(51), 0, lo=100,
                            hi=600, max_new=32, uid="w", vocab=49152, seed0=3000),
           PAGED_TRACE_KEYS + FLASH_TRACE_KEYS,
           "flash + paged kernels", check=PAGED_BF16_CHECK)
    return launches, paged, prefills


def run_whole_prompt_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off: the flash kernel's one-prefill logit gap to its
    plain version at 32 and 2 layers; then, at PARITY_LAYERS, greedy
    lockstep streams through kernels = through plain versions, and the
    whole-prompt paged engine = the chunked paged engine = lockstep one
    request at a time, on the same requests."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(6)
    toks = np.zeros((2, 256), np.int32)  # a left-padded lockstep batch
    toks[0] = rng.integers(1, cfg.vocab_size, 256)
    toks[1, 56:] = rng.integers(1, cfg.vocab_size, 200)
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    for layers in (LAYERS, PARITY_LAYERS):
        cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
        model = models.build_model(cfg32, device="cuda")
        model.init(seed=1)
        logits = {}
        for impl in ("auto", "ref"):
            model.attn_impl = impl
            logits[impl] = model.prefill(batch, 256)[1][:, :cfg.vocab_size]
        a, b = logits["auto"], logits["ref"]
        gap = (a - b).abs().max().item()
        top2 = b.topk(2, dim=-1).values
        log(f"whole-prompt parity: {layers} layers, one prefill (B 2, S 256,"
            f" left-padded): max |logit kernel - plain| = {gap:.3e}, argmax "
            f"{a.argmax(-1).tolist()} vs {b.argmax(-1).tolist()}, plain "
            f"top-2 margin {(top2[:, 0] - top2[:, 1]).min().item():.3e}")
        if layers == PARITY_LAYERS and not gap < 1e-3:
            raise AssertionError(f"kernel vs plain logits differ by {gap}")
        del model
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)

    def requests():
        return _random_requests(serving, 5, np.random.default_rng(3), 0,
                                lo=70, hi=200, max_new=16, uid="g",
                                vocab=49152, seed0=3000)

    def streams(engine, one_by_one=False):
        if one_by_one:
            return [list(engine.generate([r])[0].tokens) for r in requests()]
        handles, _ = _drive(torch, engine, requests())
        return [list(h.tokens) for h in handles]

    runs = {}
    for impl in ("auto", "ref"):
        runs[f"lockstep {impl}"] = streams(serving.GenerationEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH,
            attn_impl=impl, device="cuda"))
    if runs["lockstep auto"] != runs["lockstep ref"]:
        raise AssertionError(f"f32 lockstep kernel vs plain streams differ: "
                             f"{runs}")
    runs["lockstep one by one"] = streams(serving.GenerationEngine(
        cfg32, params, max_len=LOCK_MAX_LEN, device="cuda"), one_by_one=True)
    for label, chunk in (("whole-prompt", None), ("chunked", CHUNK)):
        runs[label] = streams(serving.ContinuousBatchingEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_slots=4, page_size=PAGE,
            prefill_chunk=chunk, device="cuda"))
    want = runs["lockstep one by one"]
    if not runs["whole-prompt"] == runs["chunked"] == want:
        raise AssertionError(f"f32 whole-prompt / chunked / lockstep streams "
                             f"differ: {runs}")
    log(f"whole-prompt parity: {PARITY_LAYERS} layers, full width: 5 greedy "
        f"streams of 16 tokens identical through the lockstep engine "
        f"(kernels and plain versions), and whole-prompt paged = chunked "
        f"paged = lockstep one request at a time")


# ---------------------------------------------------------------------------
# phases 11-12: the mamba2 SSM engine
# ---------------------------------------------------------------------------


def run_mamba_engine(torch, np, cfg, serving, models, sk, card):
    """Full-width mamba2-1.3b through the SSM engine; returns the SSD
    kernels' launch counts over the measured run."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    engine_kw = dict(max_len=M_MAX_LEN, max_slots=SLOTS,
                     prefill_chunk=CHUNK, device="cuda")
    rng = np.random.default_rng(20)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, serving.SSMEngine(cfg, params, **engine_kw),
           _random_requests(serving, 2, rng, 2, lo=64, hi=400, max_new=4,
                            uid="m", vocab=50280, seed0=2000))
    engine = serving.SSMEngine(cfg, params, **engine_kw)
    reqs = _random_requests(serving, 8, rng, 2, lo=64, hi=400, max_new=24,
                            uid="m", vocab=50280, seed0=2000)
    sk.reset_launches()
    t0 = time.perf_counter()
    handles, steps = _drive(torch, engine, reqs)
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    paths = dict(sk.LAUNCHES_BY_PATH)
    results = [h.result() for h in handles]
    _check_served(np, cfg, results, 24)
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"an SSD kernel never ran: {launches}")
    if paths != {"mma": launches["ssd_scan_bshp"], "cuda_core": 0}:
        raise AssertionError(f"a bf16 scan left the tensor-core kernel: "
                             f"{paths}")
    st = engine.stats
    _log_run("engine", cfg, card, reqs, results, wall, steps,
             f"decode_steps {st['decode_steps']}, prefill_chunks "
             f"{st['prefill_chunks']}, preemptions {st['preemptions']}; "
             f"kernel launches {launches} (scan paths {paths}) over "
             f"{M_LAYERS} layers per "
             f"dispatch; peak device memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("utilization: " + engine.utilization.format())
    del engine
    _trace(torch, lambda: serving.SSMEngine(cfg, params, **engine_kw),
           _random_requests(serving, 8, np.random.default_rng(21), 0, lo=64,
                            hi=400, max_new=24, uid="m", vocab=50280,
                            seed0=2000),
           SSD_TRACE_KEYS, "SSD kernels", check=SSD_BF16_CHECK)
    return launches


def _drive_preempting(torch, engine, reqs):
    """_drive with one snapshot preemption and then one discard preemption
    of the youngest decoding request, each at the first third step where
    something is decoding."""
    handles = [engine.submit(r) for r in reqs]
    plan, steps = [True, False], 0
    while not engine.idle:
        engine.step()
        steps += 1
        if plan and steps % 3 == 0 and engine.preempt_youngest(
                snapshot=plan[0]) is not None:
            plan.pop(0)
    torch.cuda.synchronize()
    st = engine.stats
    if plan or st["preemptions"] != 2 or st["restores"] != 1:
        raise AssertionError(f"preemptions not taken as planned: {st}")
    return handles


def run_mamba_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off, at the full 48 layers: the one-chunk logit gap of
    the kernels to the plain versions, then the SSM engine through the
    kernels vs through the plain versions (``ssd_impl="ref"``), and under
    preemption; greedy streams identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = models.build_model(cfg32, device="cuda")
    params = model.init(seed=1)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, CHUNK).astype(np.int32)).cuda()
    logits = {}
    for impl in ("auto", "ref"):
        model.ssd_impl = impl
        bank = serving.SlotStateBank(cfg32, 1, torch.float32, device="cuda")
        _, logits[impl] = model.prefill_chunk_ssm(bank.state, toks, 50)
    a, b = logits["auto"][:cfg.vocab_size], logits["ref"][:cfg.vocab_size]
    gap = (a - b).abs().max().item()
    top2 = b.topk(2).values
    log(f"mamba2 parity: f32, TF32 off, {cfg32.num_layers} layers, one "
        f"64-token chunk (valid 50): max |logit kernel - plain| = {gap:.3e}, "
        f"argmax {a.argmax().item()} vs {b.argmax().item()}, plain top-2 "
        f"margin {(top2[0] - top2[1]).item():.3e}")
    if not gap < 1e-3:
        raise AssertionError(f"kernel vs plain logits differ by {gap}")
    del model, bank

    def requests():
        return _random_requests(serving, 5, np.random.default_rng(3), 0,
                                lo=70, hi=200, max_new=16, uid="m",
                                vocab=50280, seed0=2000)

    streams = {}
    for impl in ("auto", "ref"):
        engine = serving.SSMEngine(cfg32, params, max_len=M_MAX_LEN,
                                   max_slots=4, prefill_chunk=CHUNK,
                                   ssd_impl=impl, device="cuda")
        handles, _ = _drive(torch, engine, requests())
        streams[impl] = [list(h.tokens) for h in handles]
        del engine
    if streams["auto"] != streams["ref"]:
        raise AssertionError(f"f32 kernel vs plain streams differ: {streams}")
    engine = serving.SSMEngine(cfg32, params, max_len=M_MAX_LEN, max_slots=4,
                               prefill_chunk=CHUNK, device="cuda")
    handles = _drive_preempting(torch, engine, requests())
    if [list(h.tokens) for h in handles] != streams["auto"]:
        raise AssertionError("streams under snapshot + discard preemption "
                             "differ from the undisturbed run")
    log(f"mamba2 parity: {cfg32.num_layers} layers, full width: "
        f"{len(streams['auto'])} greedy streams of 16 tokens identical "
        f"through kernels and plain versions, and through one snapshot and "
        f"one discard preemption")


# ---------------------------------------------------------------------------
# phases 13-16: the zamba2 hybrid engine, the ssm/hybrid lockstep engine
# ---------------------------------------------------------------------------


def _path_launches(pk, sk, fk=None):
    """The launch counts of every kernel since the last reset."""
    out = {**pk.LAUNCHES, **sk.LAUNCHES}
    if fk is not None:
        out.update(fk.LAUNCHES)
    return out


def _check_scans_mma(sk, what):
    paths = dict(sk.LAUNCHES_BY_PATH)
    if paths != {"mma": sk.LAUNCHES["ssd_scan_bshp"], "cuda_core": 0}:
        raise AssertionError(f"{what}: a bf16 scan left the tensor-core "
                             f"kernel: {paths}")
    return paths


def run_zamba_engine(torch, np, cfg, serving, models, pk, sk, card):
    """Full-width zamba2-2.7b through the hybrid SSM engine, with an ample
    pool and with one that preempts; returns {path: the hybrid path's
    kernels' launch counts} for both runs."""
    params = models.build_model(cfg, device="cuda").init(seed=0)
    kw = dict(max_len=Z_MAX_LEN, max_slots=SLOTS, prefill_chunk=CHUNK,
              page_size=PAGE, device="cuda")
    rng = np.random.default_rng(60)
    # warm-up (cuBLAS handles, allocator, first launches): not measured
    _drive(torch, serving.SSMEngine(cfg, params, **kw),
           _random_requests(serving, 2, rng, 2, lo=64, hi=400, max_new=4,
                            uid="z", vocab=cfg.vocab_size, seed0=4000))
    out = {}
    for path, pages, seed in (("zamba2", None, 61),
                              ("zamba2 page pressure", Z_TIGHT_PAGES, 62)):
        engine = serving.SSMEngine(cfg, params, num_pages=pages, **kw)
        reqs = _random_requests(serving, 8, np.random.default_rng(seed), 2,
                                lo=64, hi=400, max_new=24, uid="z",
                                vocab=cfg.vocab_size, seed0=4000)
        pk.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        handles, steps = _drive(torch, engine, reqs)
        wall = time.perf_counter() - t0
        launches = _path_launches(pk, sk)
        paths = _check_scans_mma(sk, path)
        results = [h.result() for h in handles]
        _check_served(np, cfg, results, 24)
        if not all(launches[k] > 0 for k in HYBRID_KERNELS):
            raise AssertionError(f"{path}: a kernel of the hybrid path never "
                                 f"ran: {launches}")
        if launches["paged_mixed_attention_rkgd"] != 0:
            raise AssertionError(f"{path}: the hybrid engine ran a mixed "
                                 f"step: {launches}")
        st = engine.stats
        if (st["preemptions"] > 0) != (pages is not None):
            raise AssertionError(f"{path}: preemptions {st['preemptions']} "
                                 f"with num_pages {pages}")
        _log_run(path, cfg, card, reqs, results, wall, steps,
                 f"decode_steps {st['decode_steps']}, prefill_chunks "
                 f"{st['prefill_chunks']}, preemptions {st['preemptions']}, "
                 f"pool {engine.cache.num_pages - 1} pages of "
                 f"{engine.cache.page_nbytes} B over "
                 f"{cfg.num_layers // cfg.attn_every} attention layers; "
                 f"kernel launches {launches} (scan paths {paths}); peak "
                 f"device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log("utilization: " + engine.utilization.format())
        out[path] = {k: launches[k] for k in HYBRID_KERNELS}
        del engine
    _trace(torch, lambda: serving.SSMEngine(cfg, params, **kw),
           _random_requests(serving, 8, np.random.default_rng(63), 0, lo=64,
                            hi=400, max_new=24, uid="z", vocab=cfg.vocab_size,
                            seed0=4000),
           PAGED_TRACE_KEYS + SSD_TRACE_KEYS, "paged + SSD kernels",
           check=ZAMBA_BF16_CHECK)
    return out


def _hybrid_chunk_logits(torch, np, model, serving, impl):
    """Logits of one 64-token prompt chunk (valid 50) from a zero state
    into an empty pool, through ``prefill_chunk_hybrid``."""
    cfg = model.cfg
    model.attn_impl = model.ssd_impl = impl
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.num_layers // cfg.attn_every, 6, PAGE, cfg.eff_kv_heads,
             cfg.head_dim)  # null page, 4 pages, sink
    pages = {k: torch.zeros(shape, dtype=dt, device="cuda")
             for k in ("k", "v")}
    bank = serving.SlotStateBank(cfg, 1, dt, device="cuda")
    row = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, CHUNK).astype(np.int32)).cuda()
    _, logits = model.prefill_chunk_hybrid(pages, bank.state, row, toks, 0,
                                           50)
    return logits[:cfg.vocab_size].double()


def _first_diffs(a, b):
    """Per stream, the index of the first token where two runs differ
    (None where equal)."""
    return [next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y),
                 None) for ra, rb in zip(a, b)]


def _plain_f32_streams(torch, np, cfg, serving, models, requests, kw):
    """The plain engine's greedy streams at Z_PARITY_LAYERS in f32, held
    equal to those with f64 weights, activations and matmuls (the plain
    versions' norms, attention and SSD sums stay f32): f32 rounding flips
    no greedy decision of the stream check. Prints the one-chunk gaps
    (kernels - plain, plain f32 - f64) beside the top-2 margin."""
    logits, streams = {}, {}
    for dtype in ("float32", "float64"):
        c = dataclasses.replace(cfg, dtype=dtype, num_layers=Z_PARITY_LAYERS)
        model = models.build_model(c, device="cuda")
        params = model.init(seed=1)
        if dtype == "float32":
            logits["kernel"] = _hybrid_chunk_logits(torch, np, model,
                                                    serving, "auto")
        logits[dtype] = _hybrid_chunk_logits(torch, np, model, serving,
                                             "ref")
        streams[dtype] = _ssm_streams(torch, serving.SSMEngine(
            c, params, attn_impl="ref", ssd_impl="ref", **kw), requests())
        del model, params
    a, b, c = logits["kernel"], logits["float32"], logits["float64"]
    top2 = c.topk(2).values
    log(f"zamba2 parity: f32, TF32 off, {Z_PARITY_LAYERS} layers, one "
        f"64-token chunk (valid 50): max |logit kernel - plain| = "
        f"{(a - b).abs().max().item():.3e}, plain f32 - f64 = "
        f"{(b - c).abs().max().item():.3e}, argmax {a.argmax().item()} / "
        f"{b.argmax().item()} / {c.argmax().item()}, f64 top-2 margin "
        f"{(top2[0] - top2[1]).item():.3e}")
    diffs = _first_diffs(streams["float32"], streams["float64"])
    if any(d is not None for d in diffs):
        raise AssertionError(f"at {Z_PARITY_LAYERS} layers the plain path's "
                             f"f32 and f64 greedy streams differ (first "
                             f"differing token per stream {diffs})")
    return streams["float32"]


def _ssm_streams(torch, engine, reqs):
    handles, _ = _drive(torch, engine, reqs)
    return [list(h.tokens) for h in handles]


def run_zamba_parity(torch, np, cfg, serving, models):
    """f32 with TF32 off, at Z_PARITY_LAYERS: the plain streams agree
    with f64 (``_plain_f32_streams``), the hybrid engine's greedy streams
    through the kernels = through the plain versions = under page-pressure
    preemption, and snapshot preemption of a hybrid slot refused."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_len=Z_MAX_LEN, max_slots=4, prefill_chunk=CHUNK,
              page_size=PAGE, device="cuda")

    def requests():
        return _random_requests(serving, 5, np.random.default_rng(3), 0,
                                lo=70, hi=200, max_new=16, uid="z",
                                vocab=cfg.vocab_size, seed0=4000)

    plain = _plain_f32_streams(torch, np, cfg, serving, models, requests,
                               kw)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=Z_PARITY_LAYERS)
    params = models.build_model(cfg32, device="cuda").init(seed=1)
    streams = _ssm_streams(torch, serving.SSMEngine(cfg32, params, **kw),
                           requests())
    if streams != plain:
        raise AssertionError(f"f32 kernel vs plain streams differ at "
                             f"{_first_diffs(streams, plain)}")
    tight = serving.SSMEngine(cfg32, params, num_pages=Z_PARITY_TIGHT_PAGES,
                              **kw)
    if _ssm_streams(torch, tight, requests()) != streams:
        raise AssertionError("streams under page-pressure preemption differ "
                             "from the undisturbed run")
    if tight.stats["preemptions"] == 0:
        raise AssertionError(f"{Z_PARITY_TIGHT_PAGES} pages never preempted")
    engine = serving.SSMEngine(cfg32, params, **kw)
    engine.submit(requests()[0])
    while not engine._has_decodable():
        engine.step()
    try:
        engine.preempt_youngest(snapshot=True)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("snapshot preemption of a hybrid slot passed")
    engine.abort_all()
    _drive(torch, engine, [])
    log(f"zamba2 parity: {Z_PARITY_LAYERS} layers, full width: "
        f"{len(streams)} greedy streams of 16 tokens identical through "
        f"kernels and plain versions, and through "
        f"{tight.stats['preemptions']} page-pressure "
        f"preemptions ({Z_PARITY_TIGHT_PAGES} pages); snapshot preemption "
        f"refused: {refusal}")


def run_lockstep_ssm(torch, np, cfgs, serving, models, fk, pk, sk, card):
    """Full-width mamba2-1.3b and zamba2-2.7b through the lockstep engine;
    returns {path: kernel launches} (scan, SSD decode, zamba2's flash) and
    {arch: the (B, S) of its prefills}."""
    out, shapes = {}, {}
    kw = dict(max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH, device="cuda")
    for name, cfg in cfgs.items():
        params = models.build_model(cfg, device="cuda").init(seed=0)
        vocab = cfg.vocab_size
        rng = np.random.default_rng(70)
        _drive(torch, serving.GenerationEngine(cfg, params, **kw),
               _random_requests(serving, 2, rng, 2, lo=64, hi=256, max_new=4,
                                uid="s", vocab=vocab, seed0=5000))
        engine = serving.GenerationEngine(cfg, params, **kw)
        prefills = _record_prefills(engine.model)
        reqs = _random_requests(serving, 8, rng, 2, lo=64, hi=256,
                                max_new=16, uid="s", vocab=vocab, seed0=5000)
        for mod in (fk, pk, sk):
            mod.reset_launches()
        t0 = time.perf_counter()
        handles, steps = _drive(torch, engine, reqs)
        wall = time.perf_counter() - t0
        launches = _path_launches(pk, sk, fk)
        paths = _check_scans_mma(sk, f"lockstep {name}")
        results = [h.result() for h in handles]
        _check_served(np, cfg, results, 16)
        want = ["ssd_scan_bshp", "ssd_decode_step_bh"]
        # per prefilled batch: one scan per Mamba layer, one flash call per
        # shared-block occurrence
        exact = {"ssd_scan_bshp": cfg.num_layers * len(prefills)}
        if cfg.family == "hybrid":
            want.append("flash_attention_bhsd")
            exact["flash_attention_bhsd"] = (
                cfg.num_layers // cfg.attn_every * len(prefills))
        if (not all(launches[k] > 0 for k in want)
                or any(launches[k] != n for k, n in exact.items())
                or any(launches[k] for k in pk.LAUNCHES)):
            raise AssertionError(f"lockstep {name}: launches {launches}, "
                                 f"{len(prefills)} prefilled batches")
        _log_run(f"lockstep {name}", cfg, card, reqs, results, wall, steps,
                 f"{len(prefills)} prefilled batches (B, S) {prefills}; "
                 f"kernel launches {launches} (scan paths {paths})")
        out[f"lockstep {name}"] = {k: launches[k] for k in want}
        shapes[name] = prefills
        del engine, params
    return out, shapes


def run_lockstep_ssm_parity(torch, np, cfgs, depths, serving, models):
    """f32, TF32 off, at each arch's parity depth: 5 equal-length prompts
    (one batch with no left padding) give the same greedy streams through
    the lockstep engine as through the SSM engine, as
    ``tests/test_ssm_engine.py:285`` asserts on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, cfg in cfgs.items():
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    num_layers=depths[name])
        params = models.build_model(cfg32, device="cuda").init(seed=1)
        rng = np.random.default_rng(8)
        prompts = [rng.integers(1, cfg.vocab_size, 160).tolist()
                   for _ in range(5)]

        def requests():
            return [serving.Request(f"e{i}", list(p), sampling=serving
                                    .SamplingParams(max_new_tokens=16))
                    for i, p in enumerate(prompts)]

        lock = _ssm_streams(torch, serving.GenerationEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_batch=LOCK_BATCH,
            device="cuda"), requests())
        ssm = _ssm_streams(torch, serving.SSMEngine(
            cfg32, params, max_len=LOCK_MAX_LEN, max_slots=SLOTS,
            prefill_chunk=CHUNK, device="cuda"), requests())
        if lock != ssm:
            raise AssertionError(f"{name}: lockstep vs SSM engine streams "
                                 f"differ at {_first_diffs(lock, ssm)}")
        log(f"lockstep parity: {name}, f32, {depths[name]} layers, full "
            f"width: 5 greedy streams of 16 tokens (prompts of 160) "
            f"identical through the lockstep and SSM engines")
        del params


def run_serve_ssm(card):
    """The serving driver at full width on the recurrent families: zamba2
    through the SSM engine, mamba2 through lockstep."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory(prefix="serve_ssm_") as tmp:
        for args, kind in ((["--arch", "zamba2-2.7b"], "ssm"),
                           (["--engine", "lockstep", "--arch",
                             "mamba2-1.3b"], "lockstep")):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve", *args,
                 "--requests", "8", "--max-new", "8", "--workdir",
                 f"{tmp}/{kind}"],
                capture_output=True, text=True, env=env, timeout=300,
                cwd=ROOT)
            if run.returncode != 0:
                raise AssertionError(f"serve {args} exited "
                                     f"{run.returncode}: {run.stderr[-2000:]}")
            if ("served 8/8" not in run.stdout
                    or f"engine={kind}" not in run.stdout):
                raise AssertionError(f"serve {args}: {run.stdout[-2000:]}")
            served = next(line for line in run.stdout.splitlines()
                          if line.startswith("served"))
            log(f"serve driver {' '.join(args)} on {card} "
                f"({time.perf_counter() - t0:.1f} s with start-up): {served}")


# the bf16 tensor-core kernels: library -> (C info entry, its page kinds)
MMA_KERNELS = {"flash_attention": ("flash_attention_mma_info", (None,)),
               "paged_attention": ("paged_attention_prefill_mma_info",
                                   (0, 1))}


def report_mma_kernels(build):
    """Phase 2's report on the bf16 tensor-core kernels, one instance per
    head dim, page kind and warp-group count: registers and spill stores as
    ptxas gave them in this process's build (none when the libraries were
    already built), then the card's own figures through each library's
    info entry: registers and local (spilled) bytes a thread, dynamic
    shared memory a block, and blocks resident per SM."""
    import ctypes

    entry = re.compile(r"Compiling entry function '(\w+)'")
    for lib, (info_fn, kinds) in MMA_KERNELS.items():
        ptxas = build.build_log.get(lib, "")
        parts = entry.split(ptxas)
        for name, body in zip(parts[1::2], parts[2::2]):
            if "_mma_kernel" not in name:
                continue
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            d, groups = re.findall(r"Li(\d+)E", name)[:2]
            pages = " int8 pages" if "kernelIa" in name else ""
            rows = " mixed chunk rows" if "MixedChunkLimits" in name else ""
            log(f"ptxas {lib} mma D {d}{pages}{rows} groups {groups}: "
                f"{regs.group(1) if regs else '?'} registers, "
                f"{spill.group(1) if spill else '?'} bytes spill stores")
        fn = getattr(build.load(lib), info_fn)
        info = (ctypes.c_int * 4)()
        for d in (64, 80, 128):
            for quant in kinds:
                for groups in (1, 2):
                    args = (d, groups) if quant is None else (d, quant, groups)
                    err = fn(*args, info)
                    if err != 0:
                        raise RuntimeError(f"{info_fn}{args}: error {err}")
                    pages = "" if quant is None else (
                        " int8 pages" if quant else " bf16 pages")
                    log(f"card {lib} mma D {d}{pages} groups {groups}: "
                        f"{info[0]} registers, {info[1]} local bytes a "
                        f"thread, {info[2]} B dynamic shared memory, "
                        f"{info[3]} blocks per SM")


def report_decode_kernel(torch, build, pk):
    """Phase 2's report on the split decode kernel (decode, and mixed rows
    without the hint): registers and spill stores per instance as ptxas
    gave them in this process's build, then the card's figures through
    ``paged_attention_decode_info`` for bf16 q over bf16 and int8 pages at
    each of PAGED_WIDTHS' head dim and group, with the split size the
    decode step of SLOTS rows takes there."""
    import ctypes

    parts = re.compile(r"Compiling entry function '(\w+)'").split(
        build.build_log.get("paged_attention", ""))
    for name, body in zip(parts[1::2], parts[2::2]):
        if "paged_decode_split_kernel" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        d, gm = re.findall(r"Li(\d+)E", name)[:2]
        qt = "bf16" if "kernelI13__nv_bfloat16" in name else "f32"
        pages = "int8" if re.search(r"kernelI(f|13__nv_bfloat16)a", name) \
            else qt
        log(f"ptxas paged_attention split decode D {d} G {gm} q {qt} pages "
            f"{pages}:"
            f" {regs.group(1) if regs else '?'} registers, "
            f"{spill.group(1) if spill else '?'} bytes spill stores")
    fn = build.load("paged_attention").paged_attention_decode_info
    info = (ctypes.c_int * 4)()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for wname, (kvh, group, d, page) in PAGED_WIDTHS.items():
        splits, pps = pk.decode_splits(SLOTS, kvh, -(-MAX_LEN // page), sms)
        for quant in (0, 1):
            err = fn(d, 1, quant, group, pps, info)
            if err != 0:
                raise RuntimeError(f"paged_attention_decode_info({d}, 1, "
                                   f"{quant}, {group}, {pps}): error {err}")
            log(f"card paged_attention split decode [{wname}] D {d} G "
                f"{group} bf16 q, {'int8' if quant else 'bf16'} pages, "
                f"{splits} splits of {pps} pages: "
                f"{info[0]} registers, {info[1]} local bytes a thread, "
                f"{info[2]} B dynamic shared memory, {info[3]} blocks per SM")


def report_ssd_scan(torch, build, sk):
    """Phase 2's report on the scan kernels: registers and spill stores per
    instance as ptxas gave them in this process's build, then the card's
    figures through ``ssd_scan_info`` for the calls the engine and the
    timing phase make: bf16 at the engine's chunk (S 64) and a 512-token
    prompt at mamba2's widths, bf16 at zamba2's N 64, and f32 (the
    CUDA-core template of the parity runs)."""
    parts = re.compile(r"Compiling entry function '(\w+)'").split(
        build.build_log.get("ssd_scan", ""))
    for name, body in zip(parts[1::2], parts[2::2]):
        # the anonymous namespace's mangled name holds the file's name, so
        # match the kernels' own names
        if not re.search(r"ssd_scan_(mma_)?kernel", name):
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        rows = re.search(r"Li(\d+)E", name)
        kind = (f"mma rows {rows.group(1)}" if "mma" in name and rows else
                "cuda-core " + ("bf16" if "bfloat16" in name else "f32"))
        log(f"ptxas ssd_scan {kind}: {regs.group(1) if regs else '?'} "
            f"registers, {spill.group(1) if spill else '?'} bytes spill "
            f"stores")
    for label, dtype, s, n in (
            ("bf16 engine chunk S 64 N 128", torch.bfloat16, CHUNK, SSD_N),
            ("bf16 prompt S 512 N 128", torch.bfloat16, 512, SSD_N),
            ("bf16 zamba2 S 64 N 64", torch.bfloat16, CHUNK, ZAMBA_SSD[1]),
            ("f32 S 64 N 128", torch.float32, CHUNK, SSD_N)):
        i = sk.ssd_scan_info(dtype, s, SSD_P, n)
        log(f"card ssd_scan [{label}]: {i['path']}, {i['rows']} P rows a "
            f"block, {i['registers']} registers, {i['local_bytes']} local "
            f"bytes a thread, {i['smem_bytes']} B dynamic shared memory, "
            f"{i['blocks_per_sm']} blocks per SM")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import models, serving
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ssd_scan as sk

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = last = time.perf_counter()

    def lap(phase):  # wall time per phase, to keep the script in its limit
        nonlocal last
        now = time.perf_counter()
        log(f"[{now - t0:.1f} s] {phase}: {now - last:.1f} s")
        last = now

    build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{n} {s:.1f} s' for n, s in build.build_seconds.items())})")
    for lib, ptxas in build.build_log.items():  # empty when already built
        regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers",
                                                  ptxas)})
        spills = sorted({int(n) for n in re.findall(
            r"(\d+) bytes spill stores", ptxas)})
        log(f"ptxas {lib}: registers per thread {regs}, spill-store bytes "
            f"{spills} over {ptxas.count('Compiling entry function')} "
            f"kernel instances")
    report_mma_kernels(build)
    report_decode_kernel(torch, build, pk)
    report_ssd_scan(torch, build, sk)

    lap("build")
    # kernel -> max abs err over the main width's bf16 cases, per pool kind
    errs, int8_errs = {}, {}
    for wname in PAGED_WIDTHS:
        for quant in (False, True):
            e = check_kernels(torch, ops, ref, wname, quant)
            if wname == MAIN_WIDTH:
                (int8_errs if quant else errs).update(e)
    lap("paged kernel checks")
    times = time_kernels(torch, F, ops, ref)
    for wname in PAGED_WIDTHS:  # the redesigned kernels at the other widths
        if wname != MAIN_WIDTH:
            time_kernels(torch, F, ops, ref, wname=wname)
    lap("paged timing")
    cfg = get_arch("smollm-360m")
    # kernel -> {path: launches read just after that path's run}
    by_path = {name: {} for name in KERNELS}
    for name, n in run_engine(torch, np, cfg, serving, models, pk,
                              card).items():
        by_path[name]["paged chunked"] = n
    lap("engine")
    run_parity(torch, np, cfg, serving, models)
    lap("parity")
    times.update(time_flash(torch, F, fk, ref))
    flash, lock_shapes = run_lockstep(torch, np, cfg, serving, models, fk,
                                      card)
    by_path["flash_attention_bhsd"]["lockstep"] = flash
    flash, paged, whole_shapes = run_whole_prompt(
        torch, np, cfg, serving, models, fk, pk, card)
    by_path["flash_attention_bhsd"]["whole-prompt"] = flash
    for name, n in paged.items():
        by_path[name]["whole-prompt"] = n
    lap("flash timing, lockstep, whole-prompt")
    run_whole_prompt_parity(torch, np, cfg, serving, models)
    lap("whole-prompt parity")
    times.update(time_ssd_kernels(torch, ops, sk))
    lap("ssd timing")
    mcfg = get_arch("mamba2-1.3b")
    for name, n in run_mamba_engine(torch, np, mcfg, serving, models, sk,
                                    card).items():
        by_path[name]["mamba2"] = n
    lap("mamba2 engine")
    run_mamba_parity(torch, np, mcfg, serving, models)
    lap("mamba2 parity")
    zcfg = get_arch("zamba2-2.7b")
    for path, counts in run_zamba_engine(torch, np, zcfg, serving, models,
                                         pk, sk, card).items():
        for name, n in counts.items():
            by_path[name][path] = n
    lap("zamba2 engine")
    run_zamba_parity(torch, np, zcfg, serving, models)
    lap("zamba2 parity")
    ssm_cfgs = {"mamba2": mcfg, "zamba2": zcfg}
    counts_by_path, ssm_shapes = run_lockstep_ssm(
        torch, np, ssm_cfgs, serving, models, fk, pk, sk, card)
    for path, counts in counts_by_path.items():
        for name, n in counts.items():
            by_path[name][path] = n
    run_lockstep_ssm_parity(torch, np, ssm_cfgs, {
        "mamba2": mcfg.num_layers, "zamba2": Z_PARITY_LAYERS}, serving, models)
    lap("lockstep ssm/hybrid")
    # the flash and SSD checks, at every shape the engines gave the kernels
    errs.update(check_flash(torch, fk, ref, lock_shapes + whole_shapes,
                            ssm_shapes["zamba2"]))
    errs.update(check_ssd_kernels(torch, ops, sk, [
        (b, s, c.ssm_heads, c.ssm_state) for name, c in ssm_cfgs.items()
        for b, s in ssm_shapes[name]]))
    lap("flash and ssd checks")
    run_serve_ssm(card)
    lap("ssm serve driver")
    int8_times = time_kernels(torch, F, ops, ref, quant=True)
    for wname in PAGED_WIDTHS:
        if wname != MAIN_WIDTH:
            time_kernels(torch, F, ops, ref, quant=True, wname=wname)
    lap("int8 timing")
    for name, n in run_int8_engine(torch, np, cfg, serving, models, pk,
                                   card).items():
        by_path[name]["chunked_int8"] = n
    lap("int8 engine")
    for quant, path in (("none", "tiered"), ("int8", "tiered_int8")):
        for name, n in run_tier_restart(torch, np, cfg, serving, models, pk,
                                        card, quant).items():
            by_path[name][path] = n
    lap("tier restarts")
    run_tier_int8_parity(torch, np, cfg, serving, models)
    lap("tier + int8 parity")
    run_serve_tiers(card)

    lap("serve driver")
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=errs[name], **times[name])
               for name, (source, replaces) in KERNELS.items()]
    for k in kernels:
        if k["name"] in int8_times:
            k["int8"] = dict(max_abs_err=int8_errs[k["name"]],
                             **int8_times[k["name"]])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
