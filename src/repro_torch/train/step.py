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

from repro_torch.models.common import (tree_leaves, tree_map,
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
    params = model.abstract()
    mdt = getattr(torch, opt_cfg.moment_dtype)
    mom = lambda: tree_map(  # noqa: E731
        lambda p: torch.empty(p.shape, dtype=mdt, device="meta"), params)
    return {"params": params, "opt": {"m": mom(), "v": mom()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def train_state_axes(model) -> dict:
    """The train state's logical axes (the JAX package's)."""
    paxes = model.axes()
    return {"params": paxes, "opt": {"m": paxes, "v": paxes}, "step": None}


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


def make_train_parts(
    model,
    opt_cfg: AdamWConfig,
    *,
    ga: int = 1,
    accum_dtype: str = "float32",
) -> tuple[Callable, Callable, Callable]:
    """The three parts of :func:`make_train_step`'s step, which the dry
    run counts apart (the microbatch ``ga`` times, the rest once):

    * ``init(params) -> acc``: the accumulators (None at ``ga`` 1);
    * ``micro(params, mb, acc) -> acc``: one microbatch's loss, metrics and
      gradients; at ``ga`` > 1 added into ``acc`` (gradients in
      ``accum_dtype``);
    * ``update(state, acc) -> (state, metrics)``: the microbatches' mean,
      the optimizer update and the step count.
    """
    _, opt_update = make_optimizer(opt_cfg)
    adt = getattr(torch, accum_dtype)

    def init(params):
        if ga == 1:
            return None
        zero = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        return ({"loss": zero, "ce": zero, "aux": zero},
                tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                               device=p.device), params))

    def micro(params, mb, acc):
        loss, m, g = _loss_and_grads(model, params, mb)
        if ga == 1:
            return loss, m, g
        sums, grads = acc
        grads = tree_map(lambda a, gi: a + gi.to(adt), grads, g)
        sums = {k: v + (loss if k == "loss" else m[k])
                for k, v in sums.items()}
        return sums, grads

    def update(state, acc):
        if ga == 1:
            loss, metrics, grads = acc
        else:
            sums, grads = acc
            grads = tree_map(lambda g: g / ga, grads)
            loss = sums["loss"] / ga
            # the microbatches' mean ce and aux (the moe router's loss)
            metrics = {k: sums[k] / ga for k in ("ce", "aux")}
        _, _, opt_metrics = opt_update(grads, state["opt"], state["params"],
                                       state["step"])
        state["step"] += 1
        out_metrics = {"loss": loss, **{k: metrics[k] for k in ("ce", "aux")
                                        if k in metrics}, **opt_metrics}
        return state, out_metrics

    return init, micro, update


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    *,
    ga: int = 1,
    accum_dtype: str = "float32",
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""
    init, micro, update = make_train_parts(model, opt_cfg, ga=ga,
                                           accum_dtype=accum_dtype)

    def train_step(state, batch):
        params = state["params"]
        acc = init(params)
        for i in range(ga):
            def split(x):
                b = x.shape[0]
                assert b % ga == 0, (b, ga)
                return x[i * (b // ga):(i + 1) * (b // ga)]

            acc = micro(params, {k: split(v) for k, v in batch.items()}, acc)
        return update(state, acc)

    return train_step


def make_eval_step(model) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
