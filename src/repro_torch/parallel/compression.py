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
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress(g: torch.Tensor, e: torch.Tensor):
    """(the leaf through int8 in its dtype, the new residual)."""
    gf = g.float() + e
    deq = dequantize_int8(*quantize_int8(gf))
    return deq.to(g.dtype), gf - deq


def _map_pairs(fn, grads: Any, error_fb: Any) -> Tuple[Any, Any]:
    """`fn(grad, residual) -> (grad, residual)` leaf by leaf; two trees
    with the grads' nesting."""
    pairs = [fn(g, e) for g, e in zip(tree_leaves(grads),
                                      tree_leaves(error_fb))]
    new_g, new_e = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(new_g), grads),
            tree_map(lambda _: next(new_e), grads))


def compress_grads(grads: Any, error_fb: Any) -> Tuple[Any, Any]:
    """Returns (compressed-then-decompressed grads, new error feedback)."""
    return _map_pairs(_compress, grads, error_fb)


def make_compressing_train_step(model, opt_cfg, threshold_elems: int = 4096):
    """train_step variant whose gradients pass through int8 + error feedback
    (leaves smaller than `threshold_elems` stay exact). The step takes
    (params, opt_state, error_fb, batch) and returns (params, opt_state,
    error_fb, metrics); params and moments are updated in place, as
    `make_train_step`'s are."""
    from repro_torch.optim.adamw import adamw_update, cosine_schedule
    from repro_torch.train.train_step import value_and_grad
    if model.tp is not None:       # a rank's step under executing rules
        from repro_torch.parallel.sharding import (COMPRESSION_ITEM,
                                                   _unsupported)
        raise NotImplementedError(_unsupported(model.cfg, model.tp.mesh,
                                               COMPRESSION_ITEM))

    def one(g, e):
        if g.numel() < threshold_elems:
            return g, e
        return _compress(g, e)

    def train_step(params, opt_state, error_fb, batch):
        (loss, _), grads = value_and_grad(model, params, batch)
        grads, error_fb = _map_pairs(one, grads, error_fb)
        lr_scale = cosine_schedule(opt_state["step"])
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                             params, lr_scale)
        return params, opt_state, error_fb, {"loss": loss, **om}

    return train_step
