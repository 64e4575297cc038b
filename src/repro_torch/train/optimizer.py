"""AdamW with low-precision moments, global-norm clipping, cosine schedule.

Plain functions on tensors with the JAX package's arithmetic
(``repro/train/optimizer.py``), not ``torch.optim.AdamW`` (whose bias
correction and decay order differ): moments are kept in ``moment_dtype``
(bfloat16 by default, which halves optimizer memory against f32), the
update math always runs in f32, weight decay is decoupled and applies to
matrices only (``ndim >= 2``), and the gradients are clipped by their
global norm.

``update`` writes the new parameters and moments into the given tensors
IN PLACE and returns them: the JAX train step donates its state, so the
old values are never read again there either. It walks each leaf in
slices of at most ``UPDATE_SLICE`` elements: the update is elementwise, so
the values are the same, and its f32 temporaries stay a few slices big
instead of several times the largest leaf (dbrx-132b's expert weights are
1.06 B elements a layer: 4.2 GB a temporary).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import tree_leaves, tree_map

UPDATE_SLICE = 1 << 26  # elements of a leaf updated at a time


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "bfloat16"  # "float32" for small/reduced runs


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; f32."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def make_optimizer(cfg: AdamWConfig):
    mdt = getattr(torch, cfg.moment_dtype)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        """Returns (new_params, new_opt_state, metrics); the new values are
        written into ``params`` and ``opt_state``'s tensors in place."""
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = schedule(cfg, step)
        t = (step + 1).float()
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t

        def part(g, m, v, p, decay):
            g = g.float() * scale
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
            mhat = m32 / bc1
            vhat = v32 / bc2
            upd = mhat / (torch.sqrt(vhat) + cfg.eps)
            if decay:
                upd = upd + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
            m.copy_(m32)
            v.copy_(v32)

        def one(g, m, v, p):
            # decoupled weight decay on matrices only (ndim >= 2); view(-1)
            # refuses a state tensor that the slices would not write
            decay = p.dim() >= 2
            for parts in zip(g.reshape(-1).split(UPDATE_SLICE),
                             *(t.view(-1).split(UPDATE_SLICE)
                               for t in (m, v, p))):
                part(*parts, decay)
            return p

        new_p = tree_map(one, grads, opt_state["m"], opt_state["v"], params)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_p, opt_state, metrics

    return init, update
