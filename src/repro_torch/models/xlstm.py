"""xLSTM mixers [arXiv:2405.04517]: the port of `repro.models.xlstm`.

mLSTM (matrix memory) trains in the stabilized chunkwise form: in-chunk
quadratic decay-matrix attention plus a matrix state (C, n, m) carried from
chunk to chunk. `mlstm_mix` and `mlstm_decode` go through the
`kernels.mlstm_scan` wrapper over the whole sequence with the state in and
out: on the card the Hopper kernel, on the CPU its plain version, whose
chunk is `_mlstm_chunk`. Decode is the same wrapper with S = 1.

sLSTM (scalar memory, block-diagonal recurrence) is sequential: an eager
Python loop over time with the input GEMM hoisted out of it. It has no TPU
kernel. Its stabilizer m starts at -1e30, mLSTM's at 0.

Params are plain dicts of tensors with the reference's keys; initializers
take a `torch.Generator` and `lead` stacking axes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mlstm_scan import mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import mlstm_chunk as _mlstm_chunk  # noqa: F401
from repro_torch.models.layers import dense_init, torch_dtype

Params = Dict[str, Any]
NEG = -1e30


def _mlstm_dims(cfg: ModelConfig):
    xc = cfg.xlstm
    di = int(xc.proj_factor_mlstm * cfg.d_model)
    h = cfg.num_heads
    return xc, di, h, di // h


def _normal(gen: torch.Generator, shape, std: float, dtype):
    w = torch.randn(*shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def _norm_heads(y: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Per-head RMS norm in fp32: y (B,S,H,hd) -> (B,S,H*hd) in `dtype`."""
    b, s = y.shape[:2]
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    return (yf.reshape(b, s, -1) * scale.float()).to(dtype)


# ============================================================== mLSTM cell

def mlstm_init(gen: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()) -> Params:
    xc, di, h, hd = _mlstm_dims(cfg)
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    kk = xc.conv1d_kernel
    return {
        "up": dense_init(gen, d, 2 * di, dt, lead),
        "conv_w": _normal(gen, (*lead, kk, di), 1.0 / math.sqrt(kk), dt),
        "conv_b": torch.zeros(*lead, di, dtype=dt, device=dev),
        "w_q": dense_init(gen, di, di, dt, lead),
        "w_k": dense_init(gen, di, di, dt, lead),
        "w_v": dense_init(gen, di, di, dt, lead),
        "w_if": dense_init(gen, di, 2 * h, torch.float32, lead),
        "b_if": torch.cat([torch.zeros(*lead, h, device=dev),
                           torch.full((*lead, h), 3.0, device=dev)], dim=-1),
        "norm_scale": torch.ones(*lead, di, dtype=dt, device=dev),
        "down": dense_init(gen, di, d, dt, lead),
    }


def _causal_conv(x, w, b):
    """A sum of shifted products, as the reference (no `conv1d`, which goes
    through cuDNN and its TF32 default on the card)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def _mlstm_qkvgates(params, cfg, x_m, conv0=None):
    """x_m: (B,S,di) up-projected input -> q,k,v (B,S,H,hd), log_i/log_f
    (B,S,H) fp32."""
    xc, di, h, hd = _mlstm_dims(cfg)
    b, s, _ = x_m.shape
    if conv0 is not None:
        ext = torch.cat([conv0, x_m], dim=1)
        c = _causal_conv(ext, params["conv_w"], params["conv_b"])[:, conv0.shape[1]:]
    else:
        c = _causal_conv(x_m, params["conv_w"], params["conv_b"])
    c = F.silu(c.float()).to(x_m.dtype)
    q = (c @ params["w_q"]).reshape(b, s, h, hd)
    k = (c @ params["w_k"]).reshape(b, s, h, hd)
    v = (x_m @ params["w_v"]).reshape(b, s, h, hd)
    gates = c.float() @ params["w_if"] + params["b_if"]
    log_i = gates[..., :h]                       # exponential input gate (log)
    log_f = F.logsigmoid(gates[..., h:])         # sigmoid forget gate (log)
    return q, k, v, log_i, log_f


def _scan(q, k, v, log_i, log_f, state, chunk):
    """The kernel wrapper on (B,S,H,...) tensors -> y (B,S,H,hd), state."""
    y, state = mlstm_scan(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), log_i.transpose(1, 2),
                          log_f.transpose(1, 2), state, bc=chunk)
    return y.transpose(1, 2), state


def mlstm_mix(params: Params, cfg: ModelConfig, x, state=None, conv0=None,
              chunk: int = 256):
    """x: (B,S,d) -> (out, (state, conv_tail)). Any S >= 1: the kernel and
    its plain version take a ragged last chunk."""
    xc, di, h, hd = _mlstm_dims(cfg)
    b, s, _ = x.shape
    x_m, z = (x @ params["up"]).chunk(2, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkvgates(params, cfg, x_m, conv0)
    y, state = _scan(q, k, v, log_i, log_f, state, chunk)
    # per-head group norm then output gating
    y = _norm_heads(y.to(x.dtype), params["norm_scale"], x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ params["down"]
    kk = xc.conv1d_kernel - 1
    conv_tail = (torch.cat([conv0, x_m], dim=1)[:, -kk:]
                 if conv0 is not None else x_m[:, -kk:])
    return out, (state, conv_tail)


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype=None, device=None,
                     lead: Tuple[int, ...] = ()) -> Params:
    xc, di, h, hd = _mlstm_dims(cfg)
    dt = dtype or torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    return {
        "C": torch.zeros(*lead, batch, h, hd, hd, dtype=f32, device=device),
        "n": torch.zeros(*lead, batch, h, hd, dtype=f32, device=device),
        "m": torch.zeros(*lead, batch, h, dtype=f32, device=device),
        "conv": torch.zeros(*lead, batch, xc.conv1d_kernel - 1, di, dtype=dt,
                            device=device),
    }


def mlstm_decode(params: Params, cfg: ModelConfig, x, cache: Params):
    """x: (B,1,d). One O(1) step: the kernel wrapper with S = 1 and the
    cache's state. Returns (out, new cache entries)."""
    x_m, z = (x @ params["up"]).chunk(2, dim=-1)
    window = torch.cat([cache["conv"], x_m], dim=1)
    q, k, v, log_i, log_f = _mlstm_qkvgates(params, cfg, x_m,
                                            conv0=cache["conv"])
    y, (c_new, n_new, m_new) = _scan(q, k, v, log_i, log_f,
                                     (cache["C"], cache["n"], cache["m"]), 1)
    y = _norm_heads(y, params["norm_scale"], x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ params["down"]
    return out, {"C": c_new, "n": n_new, "m": m_new, "conv": window[:, 1:]}


# ============================================================== sLSTM cell

def _slstm_dims(cfg: ModelConfig):
    xc = cfg.xlstm
    h = xc.num_heads_slstm
    return xc, h, cfg.d_model // h


def slstm_init(gen: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()) -> Params:
    xc, h, hd = _slstm_dims(cfg)
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    f = int(xc.proj_factor_slstm * d)
    kk = xc.conv1d_kernel
    return {
        "conv_w": _normal(gen, (*lead, kk, d), 1.0 / math.sqrt(kk), dt),
        "conv_b": torch.zeros(*lead, d, dtype=dt, device=dev),
        "w_in": dense_init(gen, d, 4 * d, torch.float32, lead),
        "r_rec": _normal(gen, (*lead, h, hd, 4 * hd), 1.0 / math.sqrt(hd),
                         torch.float32),
        "b": torch.cat([torch.zeros(*lead, d, device=dev),
                        torch.full((*lead, d), 3.0, device=dev),
                        torch.zeros(*lead, 2 * d, device=dev)], dim=-1),
        "norm_scale": torch.ones(*lead, d, dtype=dt, device=dev),
        "up": dense_init(gen, d, 2 * f, dt, lead),
        "down": dense_init(gen, f, d, dt, lead),
    }


def _slstm_step(params, h_cfg, carry, pre, conv_t):
    """carry: (c, n, m, h_prev) each (B,H,hd); pre (B,4d) = x_t @ W + b,
    computed for the whole sequence outside the loop; conv_t (B,d)."""
    h, hd = h_cfg
    c_st, n_st, m_st, h_prev = carry
    b = pre.shape[0]
    rec = torch.einsum("bhx,hxe->bhe", h_prev, params["r_rec"])    # (B,H,4hd)
    pre = pre.reshape(b, 4, h, hd) + rec.reshape(b, h, 4, hd).transpose(1, 2)
    i_pre, f_pre, z_pre, o_pre = pre.unbind(1)
    # conv branch modulates the i gate (xLSTM feeds conv activations to i/f)
    i_pre = i_pre + conv_t.float().reshape(b, h, hd)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m_st, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m_st - m_new)
    c_new = f_g * c_st + i_g * torch.tanh(z_pre)
    n_new = f_g * n_st + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, m_new, h_new)


def _slstm_out(params, y, dtype):
    """Head norm of h (B,S,H,hd), then the post up/down GLU."""
    y = _norm_heads(y, params["norm_scale"], dtype)
    g, u = (y @ params["up"]).chunk(2, dim=-1)
    y = F.gelu(g.float(), approximate="tanh").to(dtype) * u
    return y @ params["down"]


def slstm_mix(params: Params, cfg: ModelConfig, x, state=None, conv0=None):
    """x: (B,S,d). An eager loop over time (the memory mixing is
    recurrent; `analysis.trace.scan`). Returns (out, (state, conv_tail))."""
    xc, h, hd = _slstm_dims(cfg)
    b, s, d = x.shape
    if conv0 is not None:
        ext = torch.cat([conv0, x], dim=1)
        conv = _causal_conv(ext, params["conv_w"], params["conv_b"])[:, conv0.shape[1]:]
    else:
        conv = _causal_conv(x, params["conv_w"], params["conv_b"])
    conv = F.silu(conv.float()).to(x.dtype)
    if state is None:
        z = torch.zeros(b, h, hd, dtype=torch.float32, device=x.device)
        state = (z, z, torch.full_like(z, NEG), z)

    # the input projection hoisted out of the loop: one (B*S,d)x(d,4d) GEMM
    pre_all = x.float() @ params["w_in"] + params["b"]
    def step(carry, pre_t, conv_t, r_rec):
        carry = _slstm_step({"r_rec": r_rec}, (h, hd), carry, pre_t, conv_t)
        return carry, carry[3]

    # a Python loop over time; the dry run's trace folds it (one step
    # counted s times)
    state, hs = trace.scan(step, state, ((pre_all, 1), (conv, 1)), s,
                           consts=(params["r_rec"],))
    out = _slstm_out(params, hs, x.dtype)
    kk = xc.conv1d_kernel - 1
    conv_tail = (torch.cat([conv0, x], dim=1)[:, -kk:]
                 if conv0 is not None else x[:, -kk:])
    return out, (state, conv_tail)


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype=None, device=None,
                     lead: Tuple[int, ...] = ()) -> Params:
    xc, h, hd = _slstm_dims(cfg)
    dt = dtype or torch_dtype(cfg.param_dtype)

    def z():
        return torch.zeros(*lead, batch, h, hd, dtype=torch.float32,
                           device=device)

    return {"c": z(), "n": z(),
            "m": torch.full((*lead, batch, h, hd), NEG, dtype=torch.float32,
                            device=device),
            "h": z(),
            "conv": torch.zeros(*lead, batch, xc.conv1d_kernel - 1,
                                cfg.d_model, dtype=dt, device=device)}


def slstm_decode(params: Params, cfg: ModelConfig, x, cache: Params):
    """x: (B,1,d). One step. Returns (out, new cache entries)."""
    xc, h, hd = _slstm_dims(cfg)
    b, _, d = x.shape
    window = torch.cat([cache["conv"], x], dim=1)
    conv = (torch.einsum("bkd,kd->bd", window, params["conv_w"])
            + params["conv_b"])
    conv = F.silu(conv.float()).to(x.dtype)
    carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    pre = x[:, 0].float() @ params["w_in"] + params["b"]
    c_new, n_new, m_new, h_new = _slstm_step(params, (h, hd), carry, pre, conv)
    out = _slstm_out(params, h_new.reshape(b, 1, h, hd), x.dtype)
    return out, {"c": c_new, "n": n_new, "m": m_new, "h": h_new,
                 "conv": window[:, 1:]}
