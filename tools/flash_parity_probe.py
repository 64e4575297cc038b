#!/usr/bin/env python3
"""Where the f32 trainer parity gap of ``chip_smoke.py`` (phases 29 and 31)
comes from, on the card.

For zamba2-2.7b and smollm-360m at PARITY_LAYERS in f32 (TF32 off), with
``chip_smoke.TRAIN_RUNS``' parity steps and learning rates, trains through
the kernels, through the kernels with the flash backward swapped for the
plain version's recompute under autograd (the Function's backward before
the backward kernel), through the plain versions, and through the plain
versions in f64; prints each path's largest relative loss gap to the plain
f32 path and to the f64 path, and its mean gap to the f64 path.
``run_train_parity`` holds the first against twice (zamba2) or once
(smollm) the plain path's own gap to f64; the gap to f64 says which path
is the more accurate.

    python3 tools/flash_parity_probe.py     # from the repository root, on a CUDA machine
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402


def recompute_bwd(qt, kt, vt, out, lse, grad_out, causal, scale):
    """The plain version's recompute under autograd, on the saved inputs."""
    q, k, v = (x.transpose(1, 2).detach().requires_grad_()
               for x in (qt, kt, vt))
    with torch.enable_grad():
        o = ref.flash_attention_chunked(
            q, k, v, causal=causal, scale=scale,
            chunk_kv=256 if k.shape[1] % 256 == 0 else k.shape[1])
        return torch.autograd.grad(o, (q, k, v), grad_out)


def main() -> None:
    from repro_torch.launch import train
    from repro_torch.models.common import all_f64

    print(cs.card_line(), flush=True)
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_bwd = ops._flash_kernel_bwd
    for arch, plain in (("zamba2-2.7b", ("--ssd-impl", "ref",
                                         "--attn-impl", "ref")),
                        ("smollm-360m", ("--attn-impl", "ref"))):
        cfg = get_arch(arch)
        run = cs.TRAIN_RUNS[arch]
        steps = str(run["parity"][0])
        cut = dict(num_layers=cs.PARITY_LAYERS, dtype="float32")
        if cfg.attn_every:
            cut["attn_every"] = cs.PARITY_LAYERS
        cfg32 = dataclasses.replace(cfg, **cut)
        losses = {}
        with tempfile.TemporaryDirectory() as tmp:
            def go(name, *extra, c=cfg32):
                a, _, _ = train.run(cs._train_args(
                    train, tmp, name, run, "--steps", steps, "--ckpt-every",
                    steps, *extra), cfg=c)
                losses[name] = np.asarray(a["losses"], np.float64)

            go("kernel")
            ops._flash_kernel_bwd = recompute_bwd
            try:
                go("kernel, recompute backward")
            finally:
                ops._flash_kernel_bwd = kernel_bwd
            go("plain", *plain)
            with all_f64():
                go("plain f64", *plain,
                   c=dataclasses.replace(cfg32, dtype="float64"))
        t, p = losses["plain f64"], losses["plain"]
        for name in ("kernel", "kernel, recompute backward", "plain"):
            x = losses[name]
            vs_p, vs_t = np.abs(x - p) / np.abs(p), np.abs(x - t) / np.abs(t)
            print(f"{arch} {name}: max vs plain {vs_p.max():.3e} (step "
                  f"{vs_p.argmax() + 1}); max vs f64 {vs_t.max():.3e} (step "
                  f"{vs_t.argmax() + 1}); mean vs f64 {vs_t.mean():.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
