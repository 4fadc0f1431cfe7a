"""AdamW with global-norm clipping: the port of `repro.optim.adamw`.

Moments are kept in `state_dtype`; the update math always runs in fp32,
with bias correction and the decoupled decay `lr * wd * p` inside the step.
Unlike the reference, whose arrays are immutable, `adamw_update` writes the
new params and moments into the given tensors in place, under
`torch.no_grad()`, and returns the same trees: no second copy of the model
and its optimizer state is held during the step. It clips and updates each
leaf `CHUNK` elements at a time, so its fp32 temporaries stay small beside
the state (a whole expert stack of mixtral-8x22b would take 3.2 GB each).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.analysis import trace
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def adamw_init(params, state_dtype: str = "float32") -> Dict[str, Any]:
    dt = getattr(torch, state_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


# Elements of a leaf that the update and the norm take at a time.
CHUNK = 1 << 26


def _chunks(*tensors):
    """Flat views of tensors of one shape, CHUNK elements at a time (the
    tensors whole where one of them is not contiguous). Under the dry run's
    trace the equal chunks before the last are folded: one runs, counted
    as many times as there are (`analysis.trace.steps`)."""
    if all(t.is_contiguous() for t in tensors):
        chunks = list(zip(*(t.view(-1).split(CHUNK) for t in tensors)))
    else:
        chunks = [tensors]
    for i in trace.steps(len(chunks) - 1):
        yield chunks[i]
    yield chunks[-1]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(c.float()))
                          for x in tree_leaves(tree) for (c,) in _chunks(x)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params, lr_scale=1.0,
                 grad_norm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step. Updates `params` and the moments of `opt_state` in place;
    returns (params, opt_state, {"grad_norm"}). The grads are clipped as
    the reference's `clip_by_global_norm` clips them, a chunk at a time,
    by `grad_norm` where it is given (a sharded step's norm over every
    rank), else by `global_norm(grads)`."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = opt_state["step"] + 1
    sf = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, sf)
    bc2 = 1.0 - torch.pow(cfg.b2, sf)
    lr = cfg.lr * lr_scale
    sd = getattr(torch, cfg.state_dtype)
    with trace.not_a_use():   # reading a param here gathers nothing
        for leaf in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                        tree_leaves(opt_state["v"]), tree_leaves(params)):
            for g, m, v, p in _chunks(*leaf):
                # the clipped grad in the grad's dtype, as the reference
                # clips
                gf = (g.float() * scale).to(g.dtype).float()
                mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
                vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
                mh = mf / bc1
                vh = vf / bc2
                pf = p.float()
                pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                + cfg.weight_decay * pf)
                p.copy_(pf)
                m.copy_(mf.to(sd))
                v.copy_(vf.to(sd))
    return params, dict(opt_state, step=step), {"grad_norm": gnorm}


def cosine_schedule(step, *, peak_lr_scale=1.0, warmup=100, total=10_000,
                    min_frac=0.1):
    sf = step.float()
    warm = sf / max(warmup, 1)
    prog = torch.clamp((sf - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr_scale * torch.where(sf < warmup, warm, cos)
