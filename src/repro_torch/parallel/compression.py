"""Gradient compression: int8 quantization with error feedback. The port of
`repro.parallel.compression`.

Each gradient leaf is quantized to int8 with one per-tensor scale before the
reduction, and a float32 residual ("error feedback", 1-bit-Adam-style) is
kept so that the quantization error is re-injected on the next step and
convergence is preserved. In the reference the quantize/dequantize pair
lets XLA carry the int8 form through a cross-pod all-reduce; at world size
1 there is no reduction, and the step computes the same numbers.

Plain tensor code, as the reference's is jnp: `torch.round` rounds half to
even as `jnp.round` does, so fp32 results equal JAX's bit for bit.

Under executing sharding rules (`rules=`, a model's `tp`) each rank
compresses its blocks of the synced gradients (`ShardingRules.sync_grads`)
as the reference compresses the whole leaves its step holds: a leaf's
scale is max|g + e| over the whole leaf, all-reduced (`op="max"`) over the
axes its spec shards; the size threshold counts the whole leaf's elements;
the residual is kept in fp32 blocks under the params' specs
(`init_error_feedback` of a rank's blocks makes them). AdamW then clips by
the global norm of the compressed blocks (`ShardingRules.global_norm`).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.parallel.sharding import _flat_axes, leaf_specs
from repro_torch.tree import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor, top: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and their scale max|x| / 127; `top` is max|x| where
    `x` is a block of the leaf the scale is taken over."""
    xf = x.float()
    top = xf.abs().max() if top is None else top
    scale = torch.clamp_min(top, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress(g: torch.Tensor, e: torch.Tensor, rules=None, spec=()):
    """(the leaf through int8 in its dtype, the new residual); with
    `rules`, `g` and `e` are a rank's blocks of a leaf under `spec`, its
    scale the whole leaf's."""
    gf = g.float() + e
    top = None
    if rules is not None:
        top = rules.comm.all_reduce(gf.abs().max(), _split_over(rules, spec),
                                    op="max")
    deq = dequantize_int8(*quantize_int8(gf, top))
    return deq.to(g.dtype), gf - deq


def _split_over(rules, spec) -> Tuple[str, ...]:
    """The mesh axes `spec` splits its leaf over, in the mesh's order."""
    used = {a for axes in spec for a in _flat_axes(axes)}
    return tuple(a for a in rules.mesh.axis_names if a in used)


def _map_pairs(fn, grads: Any, error_fb: Any, rules=None
               ) -> Tuple[Any, Any]:
    """`fn(grad, residual, spec) -> (grad, residual)` leaf by leaf (`spec`
    the leaf's under `rules`, else ()); two trees with the grads'
    nesting."""
    if rules is None:
        specs = [()] * len(tree_leaves(grads))
    else:
        specs = [s for _, s in leaf_specs(grads, rules.param_specs())]
    pairs = [fn(g, e, s) for g, e, s in zip(tree_leaves(grads),
                                            tree_leaves(error_fb), specs)]
    new_g, new_e = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(new_g), grads),
            tree_map(lambda _: next(new_e), grads))


def compress_grads(grads: Any, error_fb: Any, rules=None
                   ) -> Tuple[Any, Any]:
    """Returns (compressed-then-decompressed grads, new error feedback).
    With executing `rules`, `grads` and `error_fb` are a rank's blocks and
    each scale is its whole leaf's: `make_train_step(model, opt,
    grad_compression=lambda g: compress_grads(g, e, rules=model.tp)[0])`
    compresses a rank's synced blocks as the reference's hook compresses
    the whole gradients."""
    return _map_pairs(lambda g, e, s: _compress(g, e, rules, s), grads,
                      error_fb, rules)


def make_compressing_train_step(model, opt_cfg, threshold_elems: int = 4096):
    """train_step variant whose gradients pass through int8 + error feedback
    (leaves smaller than `threshold_elems` stay exact). The step takes
    (params, opt_state, error_fb, batch) and returns (params, opt_state,
    error_fb, metrics); params, moments and the residual are updated in
    place, as `make_train_step`'s params and moments are. Under executing
    rules (`model.tp`) the step is
    a rank's: its blocks' gradients synced over the ranks first, each leaf
    compressed with its whole leaf's scale if the whole leaf has
    `threshold_elems` elements, the clip's norm over every rank."""
    from repro_torch.optim.adamw import adamw_update, cosine_schedule
    from repro_torch.train.train_step import value_and_grad
    tp = model.tp

    def one(g, e, spec):
        n = g.numel()
        if tp is not None:
            n *= tp.comm.size(_split_over(tp, spec))
        if n < threshold_elems:
            return g, e
        return _compress(g, e, tp, spec)

    def train_step(params, opt_state, error_fb, batch):
        (loss, _), grads = value_and_grad(model, params, batch)
        if tp is not None:
            grads = tp.sync_grads(grads)
        grads, new_e = _map_pairs(one, grads, error_fb, tp)
        with torch.no_grad():
            for e, n in zip(tree_leaves(error_fb), tree_leaves(new_e)):
                if n is not e:
                    e.copy_(n)
        lr_scale = cosine_schedule(opt_state["step"])
        params, opt_state, om = adamw_update(
            opt_cfg, grads, opt_state, params, lr_scale,
            None if tp is None else tp.global_norm(grads))
        return params, opt_state, error_fb, {"loss": loss, **om}

    return train_step
