"""train_step factory: fwd + bwd + global-norm clip + AdamW. The port of
`repro.train.train_step`.

The returned step takes (params, opt_state, batch) and returns (params,
opt_state, metrics). Gradients come from autograd; params and moments are
updated in place (`optim.adamw`). The reference pins accumulated gradients
to the parameter shardings; at world size 1 there is nothing to pin. Under
executing sharding rules (`model.rules.comm`) the step is one rank's: its
param and moment blocks, its rows of the batch; each weight's gradient was
reduce-scattered over its FSDP axes in the backward, each microbatch's
gradients are then all-reduced over the axes their leaves are replicated
on (`ShardingRules.sync_grads`, once a microbatch, as the reference pins
each microbatch's), and the clip takes the norm over every rank
(`ShardingRules.global_norm`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.analysis import trace
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.tree import tree_leaves, tree_map


def value_and_grad(model: Model, params, batch) -> Tuple[Tuple[Any, Dict], Any]:
    """((loss, aux), grads) of `model.loss_fn` with respect to every leaf of
    `params`; the loss and aux come back detached."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = model.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
            tree_map(lambda _: next(it), params))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_compression=None) -> Callable:
    """fwd+bwd+clip+AdamW. If cfg.train_microbatch is set, the global batch
    is split and gradients accumulate over the microbatches in
    `opt_state_dtype` (activation memory scales with the microbatch, not
    the global batch). `grad_compression(grads) -> grads` runs on the
    accumulated gradients before the clip; under executing rules on a
    rank's synced blocks (`compression.compress_grads(..., rules=)`)."""
    micro = model.cfg.train_microbatch
    tp = model.tp

    def grads_of(params, batch):
        out, g = value_and_grad(model, params, batch)
        return out, (g if tp is None else tp.sync_grads(g))

    def train_step(params, opt_state, batch):
        gb = tree_leaves(batch)[0].shape[0]
        if micro and micro < gb:
            if gb % micro:
                raise ValueError(f"batch {gb} is not a multiple of "
                                 f"train_microbatch {micro}")
            n = gb // micro
            acc_dt = getattr(torch, model.cfg.opt_state_dtype)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            loss = 0.0
            aux = dict.fromkeys(("xent", "moe_lb_loss", "moe_z_loss"), 0.0)
            # one microbatch counted n times under the dry run's trace
            for i in trace.steps(n):
                mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
                (mb_loss, mb_aux), g = grads_of(params, mb)
                # cast before scaling, as the reference does
                grads = tree_map(lambda a, b: a + b.to(acc_dt) / n, grads, g)
                loss = loss + mb_loss / n
                aux = {k: aux[k] + mb_aux[k] / n for k in aux}
            grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        else:
            (loss, aux), grads = grads_of(params, batch)
        if grad_compression is not None:
            grads = grad_compression(grads)
        lr_scale = cosine_schedule(opt_state["step"])
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params, lr_scale,
            None if tp is None else tp.global_norm(grads))
        metrics = {"loss": loss, "xent": aux.get("xent", loss),
                   "moe_lb_loss": aux.get("moe_lb_loss", torch.zeros(())),
                   "moe_z_loss": aux.get("moe_z_loss", torch.zeros(())),
                   **opt_metrics}
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, aux = model.loss_fn(params, batch)
        return {"loss": loss, "xent": aux.get("xent", loss)}
    return eval_step
