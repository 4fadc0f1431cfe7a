"""Common layers: norms, RoPE, SwiGLU, embeddings, the cross-entropy. The
port of `repro.models.layers`.

Params are plain nested dicts of tensors. Initializers take a
`torch.Generator` and return the param subtree; `lead` prepends stacking
axes (the model keeps each pattern group's layers stacked along a leading
`num_groups` axis, as the reference does). Compute follows the reference's
mixed-precision recipe: matmuls in the param dtype, fp32 normalization
statistics and activations.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """`ModelConfig.param_dtype` string -> torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               lead: Tuple[int, ...] = ()):
    """normal * 1/sqrt(in_dim), drawn in fp32 (scaled in place: one fp32
    copy at a time), stored in `dtype`."""
    w = torch.randn(*lead, in_dim, out_dim, generator=gen,
                    device=gen.device, dtype=torch.float32)
    return w.div_(math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype):
    """normal * 0.02 (GPT-style)."""
    w = torch.randn(vocab, dim, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------- norms

def rmsnorm_init(dim: int, dtype, device, lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(*lead, dim, dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance in fp32, value path in x.dtype (as the reference)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps) * params["scale"].float()
    return x * inv.to(x.dtype)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free RMS normalization (qk-norm without learned scale)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_frequencies(head_dim: int, theta: float,
                     rotary_dim: Optional[int] = None,
                     device=None) -> torch.Tensor:
    rotary_dim = rotary_dim or head_dim
    if rotary_dim % 2:
        raise ValueError(f"rotary_dim {rotary_dim} must be even")
    exponents = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                             device=device) / rotary_dim
    return 1.0 / (theta ** exponents)  # (rotary_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates the
    first `int(hd * rotary_fraction)` (rounded down to even) channels in
    fp32 and passes the rest through."""
    hd = x.shape[-1]
    rot = int(hd * rotary_fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    inv_freq = rope_frequencies(hd, theta, rot, device=x.device)
    angles = positions[..., :, None].float() * inv_freq     # (..., S, rot/2)
    sin = torch.sin(angles)[..., :, None, :]                # (..., S, 1, rot/2)
    cos = torch.cos(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


# ---------------------------------------------------------------- MLPs

def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                lead: Tuple[int, ...] = ()) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_up": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, lead),
    }


def no_move(x: torch.Tensor, name: str) -> torch.Tensor:
    """The identity `shard_fn` of a layer on one device: a plan hook that
    records a tensor's layout change, where there is none to record."""
    return x


class Local:
    """The tensor-parallel hooks of a layer that holds all its heads and
    columns, as executing `ShardingRules` (`parallel.sharding`) give a
    rank's layer its part: the residual stream in (`enter`) and the sums
    out (`exit`) as they are, a product with the whole weight (`linear`),
    its output already whole (`cols`), the queries', keys' or values'
    columns as their heads (`q_heads`, `kv_heads`), every head's output
    column its own (`head_cols`)."""
    tp_size = 1

    def __init__(self, head_dim: int = 0):
        self.head_dim = head_dim

    @staticmethod
    def enter(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def exit(y: torch.Tensor) -> torch.Tensor:
        return y

    @staticmethod
    def linear(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
        return x @ w

    @staticmethod
    def cols(y: torch.Tensor) -> torch.Tensor:
        return y

    def q_heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], -1, self.head_dim)

    def kv_heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], -1, self.head_dim)

    @staticmethod
    def head_cols(y: torch.Tensor) -> torch.Tensor:
        return y


LOCAL = Local()


def swiglu(params: Params, x: torch.Tensor, tp=LOCAL) -> torch.Tensor:
    """silu in fp32, cast back before the up-product. `tp` places it:
    whole (`Local`), or a rank's part under executing `ShardingRules`: the
    residual stream in, the rank's `d_ff` columns of the gate and up
    products and rows of the down product, its partial sums out."""
    x = tp.enter(x)
    g = tp.linear(x, params["w_gate"], "w_gate")
    u = tp.linear(x, params["w_up"], "w_up")
    h = F.silu(g.float()).to(x.dtype) * u
    return tp.exit(tp.linear(h, params["w_down"], "w_down"))


# ---------------------------------------------------------------- embeddings

def embedding_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> Params:
    return {"table": embed_init(gen, vocab, dim, dtype)}


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor, tied: bool,
            head: Optional[torch.Tensor] = None) -> torch.Tensor:
    if tied:
        return x @ params["table"].T
    return x @ head


# ---------------------------------------------------------------- loss

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 logit_softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32. logits (B,S,V), labels (B,S)."""
    lf = logits.float()
    if logit_softcap:
        lf = torch.tanh(lf / logit_softcap) * logit_softcap
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
