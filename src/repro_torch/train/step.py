"""Train-step factory: microbatch gradient accumulation, in-place update.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)`` over the JAX package's train-state tree ``{"params", "opt":
{"m", "v"}, "step"}`` (params nested like the JAX parameter tree,
``state["params"]["layers"]["attn"]["wq"]``), with its arithmetic:

  * gradient accumulation over ``ga`` microbatches (bounds activation
    memory at (B/ga) examples regardless of global batch): a Python loop
    where the JAX step runs ``lax.scan``, the same microbatch split (row
    block i of the batch) and order;
  * gradients accumulate in ``accum_dtype`` (f32 default);
  * the state is updated IN PLACE and returned, as the JAX step donates it.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import (flatten_tree, tree_leaves, tree_map,
                                       unflatten_tree)
from repro_torch.train.optimizer import AdamWConfig, make_optimizer


def init_train_state(model, seed: int, opt_cfg: AdamWConfig) -> dict:
    """Seeded random parameters (``model.init(seed)``) as the train state.
    The state's parameters ARE the model's (no copy), so training moves
    the model's weights."""
    params = unflatten_tree({k: v.detach() for k, v in
                             model.init(seed).items()})
    opt_init, _ = make_optimizer(opt_cfg)
    return {
        "params": params,
        "opt": opt_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


def abstract_train_state(model, opt_cfg: AdamWConfig) -> dict:
    """The train state's tree with ``meta``-device leaves of its shapes
    and dtypes (no allocation): the ``like`` of a checkpoint restore."""
    specs = flatten_tree(model.param_specs())

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    params = unflatten_tree({k: meta(s.shape, getattr(torch, s.dtype or
                                                      model.cfg.dtype))
                             for k, s in specs.items()})
    mdt = getattr(torch, opt_cfg.moment_dtype)
    mom = lambda: tree_map(lambda p: meta(p.shape, mdt), params)  # noqa: E731
    return {"params": params, "opt": {"m": mom(), "v": mom()},
            "step": meta((), torch.int32)}


def _loss_and_grads(model, params, batch):
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``: the
    gradient of every leaf, in the tree's layout."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat)
    by_id = {id(p): g for p, g in zip(flat, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_id[id(p)], leaves))


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    *,
    ga: int = 1,
    accum_dtype: str = "float32",
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""
    _, opt_update = make_optimizer(opt_cfg)
    adt = getattr(torch, accum_dtype)

    def train_step(state, batch):
        params = state["params"]

        if ga == 1:
            loss, metrics, grads = _loss_and_grads(model, params, batch)
        else:
            def split(x, i):
                b = x.shape[0]
                assert b % ga == 0, (b, ga)
                return x[i * (b // ga):(i + 1) * (b // ga)]

            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state["step"].device)
            for i in range(ga):
                mb = {k: split(v, i) for k, v in batch.items()}
                loss, _, g = _loss_and_grads(model, params, mb)
                grads = tree_map(lambda a, gi: a + gi.to(adt), grads, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / ga, grads)
            loss = loss_sum / ga
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}

        _, _, opt_metrics = opt_update(grads, state["opt"], params,
                                       state["step"])
        state["step"] += 1
        out_metrics = {"loss": loss, **{k: metrics[k] for k in ("ce", "aux")
                                        if k in metrics}, **opt_metrics}
        return state, out_metrics

    return train_step


def make_eval_step(model) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
