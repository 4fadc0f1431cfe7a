"""Mamba selective-SSM mixer [arXiv:2312.00752]: the port of
`repro.models.ssm`.

`mamba_mix` (training and prefill) and `mamba_decode` both go through the
`kernels.ssm_scan` wrapper with the state in and out: on the card the
Hopper kernel, on the CPU its plain version. Prefill is one call over the
whole sequence, so any S >= 1 works and the reference's chunking (its
`lax.scan` over `scan_chunk` rows, which bounds the (B,C,di,ds) decay and
drive it materializes) has nothing left to bound: neither the kernel nor
the plain version materializes them. Decode is the same wrapper with S = 1
and the cache's state, after the conv window.

Under executing sharding rules (`mamba_mix(..., tp=)`, a rank of the
sharded train step; jamba runs without sequence parallelism) the mixer
runs the rank's block of `d_inner` channels, and the kernel scans only
those. The reference's specs do not line up with such a block, so the
rank makes its inputs from the blocks they store, with the fewest
collectives: `in_proj`'s column block (which mixes x and z: at model 2,
rank 0 holds all of x) is all-gathered over `model` and the rank takes its
x and z channels; `x_proj` (columns over `model`, cutting across
[dt_low | B | C]) and `dt_proj` (dt_rank over `model`) are gathered whole,
each small beside the activations, and the rank takes its rows or
columns; its channels' share of `x_proj`'s product is all-reduced over
`model` (and so is its gradient, since each rank reads the whole sum for
its own channels); `conv_w`, `conv_b`, `D`, `dt_bias`, `A_log` and `out_proj`'s
rows are the rank's own; the output's partial sums leave through
`tp.exit`.

Params are plain dicts of tensors with the reference's keys; `dt_proj`,
`dt_bias`, `A_log` and `D` are fp32 whatever `param_dtype` is. Initializers
take a `torch.Generator` and `lead` stacking axes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.layers import dense_init, no_move, torch_dtype
from repro_torch.models.xlstm import _causal_conv, _normal
from repro_torch.parallel import collectives as c

Params = Dict[str, Any]


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_inner, dt_rank


def mamba_init(gen: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()) -> Params:
    mc, di, dtr = _dims(cfg)
    d, ds = cfg.d_model, mc.d_state
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    f32 = torch.float32
    # dt bias init so softplus(dt_bias) spans [1e-3, 1e-1] (mamba default)
    u = torch.rand(*lead, di, generator=gen, device=dev, dtype=f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.arange(1, ds + 1, dtype=f32, device=dev))
    return {
        "in_proj": dense_init(gen, d, 2 * di, dt, lead),
        "conv_w": _normal(gen, (*lead, mc.d_conv, di),
                          1.0 / math.sqrt(mc.d_conv), dt),
        "conv_b": torch.zeros(*lead, di, dtype=dt, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * ds, dt, lead),
        # dense_init's 1/sqrt(in_dim) is the reference's dt_rank ** -0.5
        "dt_proj": dense_init(gen, dtr, di, f32, lead),
        "dt_bias": torch.log(torch.expm1(dt_init)),   # inverse softplus
        "A_log": a_log.expand(*lead, di, ds).contiguous(),
        "D": torch.ones(*lead, di, dtype=f32, device=dev),
        "out_proj": dense_init(gen, di, d, dt, lead),
    }


def _ssm_inputs(params, cfg, x_conv, sf=None):
    """x_conv: (B,S,di) post-conv activations -> dt (B,S,di), B_t, C_t
    (B,S,ds) fp32, A (di,ds) fp32. x_proj's output splits as [dt_low, B,
    C]; B and C stay column views of it where it is already fp32. `sf`:
    `mamba_mix`'s `shard_fn`."""
    mc, _, dtr = _dims(cfg)
    x_db = x_conv @ params["x_proj"]
    if sf is not None:
        x_db = sf(x_db, "mamba_xdb")
    dt_low, b_t, c_t = x_db.split([dtr, mc.d_state, mc.d_state], dim=-1)
    dt = F.softplus(dt_low.float() @ params["dt_proj"] + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    return dt, b_t.float(), c_t.float(), a


def mamba_mix_rank(params: Params, cfg: ModelConfig, x, tp):
    """`mamba_mix`'s output as a rank of the sharded step computes it
    (module docstring): x (B,S,d), the residual stream whole along the
    sequence -> its output there."""
    mc, di, dtr = _dims(cfg)
    c0, c1 = tp.tp_block(di)
    xz = c.all_gather(tp.comm, tp.linear(tp.enter(x), params["in_proj"],
                                         "in_proj"), 2, tp.tp)
    x_in, z = xz[..., c0:c1], xz[..., di + c0:di + c1]
    x_conv = _causal_conv(x_in, params["conv_w"], params["conv_b"])
    x_conv = F.silu(x_conv.float()).to(x.dtype)
    # every rank reads the whole sum for its own channels: its gradient
    # is all-reduced in the backward too
    x_db = c.all_reduce_backward(tp.comm, c.all_reduce(
        tp.comm, x_conv @ tp.whole(params["x_proj"], "x_proj")[c0:c1],
        tp.tp), tp.tp)
    dt_low, b_t, c_t = x_db.split([dtr, mc.d_state, mc.d_state], dim=-1)
    dt = F.softplus(dt_low.float() @ tp.whole(params["dt_proj"],
                                              "dt_proj")[:, c0:c1]
                    + params["dt_bias"])
    y, _ = ssm_scan(x_conv, dt, b_t.float(), c_t.float(),
                    -torch.exp(params["A_log"]), params["D"])
    y = y * F.silu(z.float()).to(x.dtype)
    return tp.exit(tp.linear(y, params["out_proj"], "out_proj"))


def mamba_mix(params: Params, cfg: ModelConfig, x, h0=None, conv0=None,
              chunk: int = 0, shard_fn=None):
    """x: (B,S,d). Returns (y, (h_last, conv_tail)) for cache handoff. One
    kernel call over the whole sequence; `chunk` is kept for the
    reference's signature and does not change the math. `shard_fn(x,
    name)` marks where `mamba_mix_rank` moves its tensors (the dry run's
    plan of them: "mamba_xz", "mamba_xdb")."""
    sf = shard_fn or no_move
    x_in, z = sf(x @ params["in_proj"], "mamba_xz").chunk(2, dim=-1)
    if conv0 is not None:
        ext = torch.cat([conv0, x_in], dim=1)
        x_conv = _causal_conv(ext, params["conv_w"],
                              params["conv_b"])[:, conv0.shape[1]:]
    else:
        x_conv = _causal_conv(x_in, params["conv_w"], params["conv_b"])
    x_conv = F.silu(x_conv.float()).to(x.dtype)
    dt, b_t, c_t, a = _ssm_inputs(params, cfg, x_conv, sf)
    y, h_last = ssm_scan(x_conv, dt, b_t, c_t, a, params["D"], h0)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ params["out_proj"]
    kk = cfg.mamba.d_conv - 1
    conv_tail = (torch.cat([conv0, x_in], dim=1)[:, -kk:]
                 if conv0 is not None else x_in[:, -kk:])
    return out, (h_last, conv_tail)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None, device=None,
                     lead: Tuple[int, ...] = ()) -> Params:
    """The state h is fp32 whatever `dtype` is; the conv window is in
    `dtype`."""
    mc, di, _ = _dims(cfg)
    dt = dtype or torch_dtype(cfg.param_dtype)
    return {
        "h": torch.zeros(*lead, batch, di, mc.d_state, dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(*lead, batch, mc.d_conv - 1, di, dtype=dt,
                            device=device),
    }


def mamba_decode(params: Params, cfg: ModelConfig, x, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,d). One O(1) step: the conv window, then the kernel wrapper
    with S = 1 and the cache's state. Returns (out, new cache entries)."""
    x_in, z = (x @ params["in_proj"]).chunk(2, dim=-1)             # (B,1,di)
    window = torch.cat([cache["conv"], x_in], dim=1)               # (B,K,di)
    x_conv = (torch.einsum("bkd,kd->bd", window, params["conv_w"])
              + params["conv_b"])[:, None]
    # on the card the einsum may hand back a (d, b)-major layout; the kernel
    # reads x with a contiguous di axis
    x_conv = F.silu(x_conv.float()).to(x.dtype).contiguous()
    dt, b_t, c_t, a = _ssm_inputs(params, cfg, x_conv)
    y, h = ssm_scan(x_conv, dt, b_t, c_t, a, params["D"], cache["h"])
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ params["out_proj"]
    return out, {"h": h, "conv": window[:, 1:]}
