#!/usr/bin/env python3
"""How the full-width trainer's loss moves with the learning rate, on the card.

    python3 tools/train_lr_sweep.py [--arch smollm-360m] [--layers N]
        [--batch 16] [--seq-len 64] [--steps 60] [--lr 3e-3 1e-2 3e-2]

Runs ``repro_torch.launch.train`` (``--arch`` at full width, its depth
cut to ``--layers`` where given, as ``chip_smoke.py``'s runs cut it; bf16
parameters, f32 moments, B ``--batch`` x S ``--seq-len``, the driver's
schedule: 10 warm-up steps, cosine over 4x the steps) once per learning
rate, without chaos and with one checkpoint at the end, each in a
temporary directory that is removed after it. Prints the card's name and
power limit, then per rate: the loss every 5 steps, the last loss, the
eval loss, whether the driver's ``improved`` holds, and the median step
seconds. This is what chose ``chip_smoke.py``'s learning rates (the
``lr`` of each full-width run in ``TRAIN_RUNS``): a model with a vocabulary
of 32k-52k tokens starts on the ln(vocab) plateau, and the rate decides
whether it leaves it within the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-3, 1e-2, 3e-2])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.launch import train

    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)

    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for lr in args.lr:
        with tempfile.TemporaryDirectory(prefix="lr_sweep_") as tmp:
            arts, _, stats = train.run(train.parse_args([
                "--arch", args.arch, "--batch", str(args.batch),
                "--seq-len", str(args.seq_len), "--steps", str(args.steps),
                "--ckpt-every", str(args.steps), "--lr", str(lr),
                "--workdir", tmp]), cfg=cfg)
        losses, rep = arts["losses"], arts["report"]
        step_s = sorted(stats["attempts"][-1]["step_s"])
        print(f"{args.arch} ({cfg.num_layers} layers) B {args.batch} x S "
              f"{args.seq_len}, lr {lr:g}: "
              f"loss every 5 steps {[round(x, 3) for x in losses[::5]]}, "
              f"last {losses[-1]:.4f}, eval {rep['eval_loss']:.4f}, improved "
              f"{rep['improved']}; median {step_s[len(step_s) // 2]:.4f} "
              f"s/step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
