#!/usr/bin/env python3
"""Where the bf16 attention kernels' time goes, on the card.

Builds variants of the port's ``csrc/flash_attention.cu`` and
``csrc/paged_attention.cu`` into ``build/ablation/`` (git-ignored; one
``nvcc`` per variant and source, all started together). Each variant is a
text patch of the checked-in source, and the script fails if a patch no
longer applies:

* ``kernel``      the source as it is (warp groups chosen by grid size);
* ``groups=1``    every block one warp group (keys not split);
* ``groups=2``    every block two warp groups (keys split two ways);
* ``no-kv-loads`` K/V tiles never copied: the kernel attends whatever
                  shared memory holds (a time, not a result; the split
                  decode kernel also skips its block-table reads);
* ``no-compute``  the tiles copied but never attended;
* ``neither``     launch, q in, out back and the barriers alone (for the
                  split decode kernel also its partials and the merge).

Every variant and ``F.scaled_dot_product_attention`` (the yardstick; the
port never calls it) are timed at the shapes of the engines' calls, bf16,
each cycling over 32 layers' inputs: flash at lockstep (B 8 x S 256) and
whole-prompt (B 1 x S 512), causal, at smollm-360m's, llama3-8b's and
zamba2-2.7b's widths; the chunked prefill (a 64-token chunk at position
256) over bf16 and int8 pages at the same three widths; and the split
decode kernel at the engine's decode step (8 rows of 100-631 cached
positions) over bf16 and int8 pages at the three widths, in the variants
``kernel``, ``1 split`` (the same library launched with one split, each
block walking its row's whole table), ``no-kv-loads`` and ``neither``
(the groups variants do not touch it). Device time per
call from CUDA events around 64 calls queued behind a sleep kernel, the
variants in turns (each shape: every variant, then every variant in
reverse; the lesser of the two is printed). The first line is the card's
name and power limit.

    python tools/attention_ablation.py     # from the repository root, on a CUDA machine
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pk  # noqa: E402

OUT = ROOT / "build" / "ablation"
LAYERS = 32
SLEEP_CYCLES = 200_000_000
GROUPS_LINE = "  return blocks <= sms ? 2 : 1;"
FLASH_LOADS = ("      mma::cp_async_16(kd + j * LD + c * 8, kh + off, ok);\n"
               "      mma::cp_async_16(vd + j * LD + c * 8, vh + off, ok);\n")
PAGED_LOADS = ("        mma::cp_async_16(kraw + dst, k_pages + src, ok);\n"
               "        mma::cp_async_16(vraw + dst, v_pages + src, ok);\n",
               "        mma::cp_async_16(ks + dst, k_pages + src, ok);\n"
               "        mma::cp_async_16(vs + dst, v_pages + src, ok);\n")
DECODE_LOADS = ("    if (t < n_stages) load_stage(t);\n",
                "    if (t + NS - 1 < n_stages) load_stage(t + NS - 1);  "
                "// the slot of t - 1\n")
COMPUTE = "if (lim.live(k0))"
DECODE_STAGE = ("    const unsigned char* st = ring + (t % NS) * "
                "Tile::kStageBytes;\n")
NO_LOADS = [(FLASH_LOADS, ""), *((s, "") for s in PAGED_LOADS + DECODE_LOADS)]
NO_COMPUTE = [(COMPUTE, "if (k0 < 0)"),
              (DECODE_STAGE, DECODE_STAGE + "    if (t >= 0) continue;\n")]
# variant -> [(old, new)] text patches of the sources (header included)
VARIANTS = {
    "kernel": [],
    "groups=1": [(GROUPS_LINE, "  return 1;")],
    "groups=2": [(GROUPS_LINE, "  return 2;")],
    "no-kv-loads": NO_LOADS,
    "no-compute": NO_COMPUTE,
    "neither": NO_LOADS + NO_COMPUTE,
}
SOURCES = ("flash_attention", "paged_attention")
P, I = ctypes.c_void_p, ctypes.c_int


def make_variants() -> dict[tuple[str, str], ctypes.CDLL]:
    texts = {f.name: f.read_text() for f in build.CSRC.iterdir()
             if f.suffix in (".cu", ".cuh")}
    procs = {}
    for name, patches in VARIANTS.items():
        d = OUT / name.replace("=", "")
        d.mkdir(parents=True, exist_ok=True)
        applied = set()
        for fname, text in texts.items():
            for old, new in patches:
                if old in text:
                    text = text.replace(old, new)
                    applied.add(old)
            (d / fname).write_text(text)
        missing = [old for old, _ in patches if old not in applied]
        if missing:
            raise RuntimeError(f"{name}: patch no longer applies: {missing}")
        for src in SOURCES:
            so = d / f"{src}.so"
            cmd = [build.nvcc_path(), *build._flags(), "-o", str(so),
                   str(d / f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        if key[1] == "flash_attention":
            lib.flash_attention_forward.argtypes = (
                [P] * 4 + [I] * 7 + [ctypes.c_float, I, P])
        else:
            lib.paged_attention_prefill.argtypes = (
                [P] * 9 + [I] * 6 + [ctypes.c_float, I, P])
            lib.paged_attention_decode.argtypes = (
                [P] * 9 + [I] * 8 + [ctypes.c_float, I, P])
        libs[key] = lib
    return libs


def time_ms(fn, iters=64, warmup=8) -> float:
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


def in_turns(calls: dict) -> dict:
    """Each variant, then each in reverse: the lesser time of the two."""
    times = {}
    for name in list(calls) + list(calls)[::-1]:
        t = time_ms(calls[name])
        times[name] = min(t, times.get(name, t))
    return times


def report(label, sdpa, times):
    print(f"{label:34s} sdpa {sdpa:.4f} | " + " | ".join(
        f"{n} {t:.4f}" for n, t in times.items()), flush=True)


def flash_rows(libs):
    stream = torch.cuda.current_stream().cuda_stream
    for wname, (h, kvh, d) in {"smollm D64": (15, 5, 64),
                               "llama3 D128": (32, 8, 128),
                               "zamba2 D80": (32, 32, 80)}.items():
        for label, b, s in (("lockstep", 8, 256), ("whole-prompt", 1, 512)):
            g = torch.Generator(device="cuda").manual_seed(32)
            q = torch.randn(LAYERS, b, h, s, d, generator=g,
                            device="cuda").bfloat16()
            k, v = (torch.randn(LAYERS, b, kvh, s, d, generator=g,
                                device="cuda").bfloat16() for _ in range(2))
            out = torch.empty_like(q)

            def call(lib):
                def fn(i):
                    l = i % LAYERS
                    err = lib.flash_attention_forward(
                        q[l].data_ptr(), k[l].data_ptr(), v[l].data_ptr(),
                        out[l].data_ptr(), b, h, kvh, s, s, d, 1, d ** -0.5,
                        1, stream)
                    if err:
                        raise RuntimeError(f"launch error {err}")
                return fn
            times = in_turns({n: call(libs[n, "flash_attention"])
                              for n in VARIANTS})
            sdpa = time_ms(lambda i: F.scaled_dot_product_attention(
                q[i % LAYERS], k[i % LAYERS], v[i % LAYERS], is_causal=True,
                enable_gqa=True))
            report(f"flash {label} [{wname}]", sdpa, times)
            del q, k, v, out


def prefill_rows(libs):
    stream = torch.cuda.current_stream().cuda_stream
    start, chunk = 256, 64
    for wname, (kvh, group, d, page) in {"smollm D64": (5, 3, 64, 16),
                                         "llama3 D128": (8, 4, 128, 8),
                                         "zamba2 D80": (32, 1, 80, 16)}.items():
        mp = -(-704 // page)
        n_pages = 8 * mp + 1
        for quant in (False, True):
            g = torch.Generator(device="cuda").manual_seed(5)
            kp, vp = (torch.randn(LAYERS, n_pages, page, kvh, d, generator=g,
                                  device="cuda").bfloat16() for _ in range(2))
            scales = (None, None)
            if quant:
                (kq, ks), (vq, vs) = ref.quantize_kv(kp), ref.quantize_kv(vp)
                kd, vd = (ref.dequantize_pages(x, sc).bfloat16()
                          for x, sc in ((kq, ks), (vq, vs)))
                kp, vp, scales = kq, vq, (ks, vs)
            else:
                kd, vd = kp, vp
            table = (torch.randperm(n_pages - 1, generator=g,
                                    device="cuda")[:mp] + 1).int()
            q = torch.randn(chunk, kvh, group, d, generator=g,
                            device="cuda").bfloat16()
            out = torch.empty_like(q)
            st = torch.tensor(start, dtype=torch.int32, device="cuda")
            va = torch.tensor(chunk, dtype=torch.int32, device="cuda")

            def call(lib):
                def fn(i):
                    l = i % LAYERS
                    ks_, vs_ = ((scales[0][l].data_ptr(),
                                 scales[1][l].data_ptr()) if quant
                                else (None, None))
                    err = lib.paged_attention_prefill(
                        q.data_ptr(), kp[l].data_ptr(), vp[l].data_ptr(),
                        ks_, vs_, table.data_ptr(), st.data_ptr(),
                        va.data_ptr(), out.data_ptr(), chunk, kvh, group, d,
                        page, mp, d ** -0.5, 1, stream)
                    if err:
                        raise RuntimeError(f"launch error {err}")
                return fn
            times = in_turns({n: call(libs[n, "paged_attention"])
                              for n in VARIANTS})
            n = start + chunk

            def dense(pool, l):
                x = pool[l][table.long()].reshape(-1, kvh, d)[:n]
                return x.transpose(0, 1).repeat_interleave(group, 0)[None]
            kv = [(dense(kd, l), dense(vd, l)) for l in range(LAYERS)]
            kpos = torch.arange(n, device="cuda")
            mask = (kpos[None, :] <= start + torch.arange(
                chunk, device="cuda")[:, None])[None, None]
            qt = q.reshape(chunk, kvh * group, d).transpose(0, 1)[None]
            sdpa = time_ms(lambda i: F.scaled_dot_product_attention(
                qt, *kv[i % LAYERS], attn_mask=mask))
            report(f"prefill {'int8' if quant else 'bf16'} pages "
                   f"[{wname}]", sdpa, times)
            del kp, vp, kd, vd, kv


def decode_rows(libs):
    """The split decode kernel at the engine's decode step: 8 rows of
    100-631 cached positions (chip_smoke.py's timing shapes)."""
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = 8
    for wname, (kvh, group, d, page) in {"smollm D64": (5, 3, 64, 16),
                                         "llama3 D128": (8, 4, 128, 8),
                                         "zamba2 D80": (32, 1, 80, 16)}.items():
        mp = -(-704 // page)
        n_pages = rows * mp + 1
        splits, pps = pk.decode_splits(rows, kvh, mp, sms)
        for quant in (False, True):
            g = torch.Generator(device="cuda").manual_seed(5)
            kp, vp = (torch.randn(LAYERS, n_pages, page, kvh, d, generator=g,
                                  device="cuda").bfloat16() for _ in range(2))
            scales = (None, None)
            if quant:
                (kq, ks), (vq, vs) = ref.quantize_kv(kp), ref.quantize_kv(vp)
                kd, vd = (ref.dequantize_pages(x, sc).bfloat16()
                          for x, sc in ((kq, ks), (vq, vs)))
                kp, vp, scales = kq, vq, (ks, vs)
            else:
                kd, vd = kp, vp
            lengths = torch.randint(100, 632, (rows,), generator=g,
                                    device="cuda", dtype=torch.int32)
            tables = torch.stack([torch.randperm(n_pages - 1, generator=g,
                                                 device="cuda")[:mp] + 1
                                  for _ in range(rows)]).int()
            q = torch.randn(rows, kvh, group, d, generator=g,
                            device="cuda").bfloat16()
            out = torch.empty_like(q)
            partials = torch.empty(rows * kvh * splits * group * (d + 2),
                                   device="cuda")

            def call(lib, n_splits, n_pps):
                def fn(i):
                    l = i % LAYERS
                    ks_, vs_ = ((scales[0][l].data_ptr(),
                                 scales[1][l].data_ptr()) if quant
                                else (None, None))
                    err = lib.paged_attention_decode(
                        q.data_ptr(), kp[l].data_ptr(), vp[l].data_ptr(),
                        ks_, vs_, tables.data_ptr(), lengths.data_ptr(),
                        out.data_ptr(), partials.data_ptr(), rows, kvh, group,
                        d, page, mp, n_splits, n_pps, d ** -0.5, 1, stream)
                    if err:
                        raise RuntimeError(f"launch error {err}")
                return fn
            times = in_turns({
                "kernel": call(libs["kernel", "paged_attention"], splits,
                               pps),
                "1 split": call(libs["kernel", "paged_attention"], 1, mp),
                "no-kv-loads": call(libs["no-kv-loads", "paged_attention"],
                                    splits, pps),
                "neither": call(libs["neither", "paged_attention"], splits,
                                pps)})
            n = int(lengths.max())

            def dense(pool, l):
                x = pool[l][tables.long()].reshape(rows, -1, kvh, d)[:, :n]
                return x.permute(0, 2, 1, 3).repeat_interleave(group, 1)
            kv = [(dense(kd, l), dense(vd, l)) for l in range(LAYERS)]
            mask = (torch.arange(n, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            qt = q.reshape(rows, kvh * group, 1, d)
            sdpa = time_ms(lambda i: F.scaled_dot_product_attention(
                qt, *kv[i % LAYERS], attn_mask=mask))
            report(f"decode {'int8' if quant else 'bf16'} pages [{wname}] "
                   f"{splits}x{pps}", sdpa, times)
            del kp, vp, kd, vd, kv


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    libs = make_variants()
    flash_rows(libs)
    prefill_rows(libs)
    decode_rows(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
