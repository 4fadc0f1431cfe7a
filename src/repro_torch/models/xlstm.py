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

Under executing sharding rules (`mlstm_mix_rank`, `slstm_mix_rank`: a rank
of the sharded train step; xlstm runs without sequence parallelism) a cell
runs the rank's block of heads, and mlstm_scan and the sLSTM loop take only
those. The reference's specs cut across what a head needs, so the rank
makes its inputs from the blocks they store:
  * mLSTM: `up`'s column block (which mixes x_m and z: at model 2, rank 0
    holds all of x_m) is all-gathered over `model`; the rank takes whole
    x_m (for `w_v`, which contracts all of it) and its heads' z channels;
    its `conv_w`/`conv_b` block convolves its channels, and the conv
    output is all-gathered whole (`w_q` and `w_k` contract all of it);
    `w_q`, `w_k`, `w_v` are column blocks of its heads as they are;
    `w_if` (columns [i gates | f gates]) is gathered whole (`whole`) and
    the rank takes its heads' two columns each;
  * sLSTM: its `conv_w`/`conv_b` block is its heads' channels; `w_in`'s
    column block (gate-major: one gate for every head) is all-gathered and
    the rank takes its heads' four gates; after the recurrence and the
    head norm its channels are all-gathered whole for `up`, whose column
    block (mixing [g | u]) is all-gathered again for its own `f` block of
    the GLU and `down`'s rows;
  * a model axis that is a multiple of a cell's heads (xlstm-125m's 4 on
    16 ranks) cuts each head over several ranks: each of them computes
    the whole head (`_RankHeads`; mLSTM: q, k, v gathered whole over
    `model` and its head taken; sLSTM: the conv output likewise) and keeps
    its block of the channels after the head norm;
  * the replicated leaves a rank reads only its heads' slices of (`r_rec`,
    `b`, `b_if`, both cells' `norm_scale`) take a part of their gradient on
    each rank, all-reduced over `model` (`sharding.partial_over_model`);
  * the output's partial sums leave through `tp.exit`.
`shard_fn(x, name)` marks where the world-size-1 cells' tensors are moved
so (the dry run's plan of them: "mlstm_xz", "mlstm_conv", "mlstm_qkv",
"slstm_conv", "slstm_pre", "slstm_y", "slstm_up").

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
from repro_torch.models.layers import dense_init, no_move, torch_dtype

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


def _mlstm_qkvgates(params, cfg, x_m, conv0=None, sf=no_move):
    """x_m: (B,S,di) up-projected input -> q,k,v (B,S,H,hd), log_i/log_f
    (B,S,H) fp32."""
    xc, di, h, hd = _mlstm_dims(cfg)
    b, s, _ = x_m.shape
    if conv0 is not None:
        ext = torch.cat([conv0, x_m], dim=1)
        cv = _causal_conv(ext, params["conv_w"],
                          params["conv_b"])[:, conv0.shape[1]:]
    else:
        cv = _causal_conv(x_m, params["conv_w"], params["conv_b"])
    cv = sf(F.silu(cv.float()).to(x_m.dtype), "mlstm_conv")
    q = sf(cv @ params["w_q"], "mlstm_qkv").reshape(b, s, h, hd)
    k = sf(cv @ params["w_k"], "mlstm_qkv").reshape(b, s, h, hd)
    v = sf(x_m @ params["w_v"], "mlstm_qkv").reshape(b, s, h, hd)
    gates = cv.float() @ params["w_if"] + params["b_if"]
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
              chunk: int = 256, shard_fn=None):
    """x: (B,S,d) -> (out, (state, conv_tail)). Any S >= 1: the kernel and
    its plain version take a ragged last chunk. `shard_fn`: the module
    docstring's."""
    xc, di, h, hd = _mlstm_dims(cfg)
    b, s, _ = x.shape
    sf = shard_fn or no_move
    x_m, z = sf(x @ params["up"], "mlstm_xz").chunk(2, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkvgates(params, cfg, x_m, conv0, sf)
    y, state = _scan(q, k, v, log_i, log_f, state, chunk)
    # per-head group norm then output gating
    y = _norm_heads(y.to(x.dtype), params["norm_scale"], x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ params["down"]
    kk = xc.conv1d_kernel - 1
    conv_tail = (torch.cat([conv0, x_m], dim=1)[:, -kk:]
                 if conv0 is not None else x_m[:, -kk:])
    return out, (state, conv_tail)


class _RankHeads:
    """The heads a rank of the model axis computes in a cell of `heads`
    heads of `hd` channels, for its block [c0, c1) of the channels: its own
    heads where the axis divides them; else (the axis a multiple of them)
    the one head its block lies in, which each rank of that head computes
    whole (`cut`), keeping its block of the output."""

    def __init__(self, tp, heads: int, hd: int):
        self.c0, self.c1 = tp.tp_block(heads * hd)
        self.h0 = self.c0 // hd
        self.n = -(-self.c1 // hd) - self.h0
        self.hd, self.tp = hd, tp
        self.cut = self.c1 - self.c0 != self.n * hd

    @property
    def channels(self) -> slice:
        """The computed heads' channels."""
        return slice(self.h0 * self.hd, (self.h0 + self.n) * self.hd)

    def own(self, t):
        """The rank's block [c0, c1) of a tensor over the computed heads'
        channels (its last dimension)."""
        a = self.c0 - self.h0 * self.hd
        return t[..., a:a + self.c1 - self.c0]

    def of(self, t):
        """The computed heads' channels of a tensor the rank holds its
        block of along the last dimension: the block itself, or where the
        heads are cut, all-gathered over `model` and sliced."""
        return self.tp.cols(t)[..., self.channels] if self.cut else t


def mlstm_mix_rank(params: Params, cfg: ModelConfig, x, tp,
                   chunk: int = 256):
    """`mlstm_mix`'s output as a rank of the sharded step computes it
    (module docstring): x (B,S,d), the residual stream whole along the
    sequence -> its output there."""
    xc, di, h, hd = _mlstm_dims(cfg)
    b, s, _ = x.shape
    rh = _RankHeads(tp, h, hd)
    h0, hl = rh.h0, rh.n
    xz = tp.cols(tp.linear(tp.enter(x), params["up"], "up"))
    x_m, z = xz[..., :di], xz[..., di + rh.c0:di + rh.c1]
    cv = _causal_conv(x_m[..., rh.c0:rh.c1], params["conv_w"],
                      params["conv_b"])
    cv = tp.cols(F.silu(cv.float()).to(x.dtype))

    def heads(t, name):
        return rh.of(tp.linear(t, params[name], name)).reshape(b, s, hl, hd)
    q, k, v = heads(cv, "w_q"), heads(cv, "w_k"), heads(x_m, "w_v")
    w_if, b_if = tp.whole(params["w_if"], "w_if"), params["b_if"]
    gates = (cv.float() @ torch.cat([w_if[:, h0:h0 + hl],
                                     w_if[:, h + h0:h + h0 + hl]], dim=1)
             + torch.cat([b_if[h0:h0 + hl], b_if[h + h0:h + h0 + hl]]))
    y, _ = _scan(q, k, v, gates[..., :hl], F.logsigmoid(gates[..., hl:]),
                 None, chunk)
    y = rh.own(_norm_heads(y.to(x.dtype), params["norm_scale"][rh.channels],
                           x.dtype))
    y = y * F.silu(z.float()).to(x.dtype)
    return tp.exit(tp.linear(y, params["down"], "down"))


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


def _slstm_out(params, y, dtype, sf=no_move):
    """Head norm of h (B,S,H,hd), then the post up/down GLU."""
    y = sf(_norm_heads(y, params["norm_scale"], dtype), "slstm_y")
    g, u = sf(y @ params["up"], "slstm_up").chunk(2, dim=-1)
    y = F.gelu(g.float(), approximate="tanh").to(dtype) * u
    return y @ params["down"]


def _slstm_loop(r_rec, pre_all, conv, heads: int, hd: int, state=None):
    """The recurrence over time on `heads` heads (an eager loop; the dry
    run's trace folds it: `analysis.trace.scan`): (state, h (B,S,H,hd))."""
    b, s = pre_all.shape[:2]
    if state is None:
        z = torch.zeros(b, heads, hd, dtype=torch.float32,
                        device=pre_all.device)
        state = (z, z, torch.full_like(z, NEG), z)

    def step(carry, pre_t, conv_t, r_rec):
        carry = _slstm_step({"r_rec": r_rec}, (heads, hd), carry, pre_t,
                            conv_t)
        return carry, carry[3]
    return trace.scan(step, state, ((pre_all, 1), (conv, 1)), s,
                      consts=(r_rec,))


def slstm_mix(params: Params, cfg: ModelConfig, x, state=None, conv0=None,
              shard_fn=None):
    """x: (B,S,d). An eager loop over time (the memory mixing is
    recurrent; `analysis.trace.scan`). Returns (out, (state, conv_tail)).
    `shard_fn`: the module docstring's."""
    xc, h, hd = _slstm_dims(cfg)
    b, s, d = x.shape
    sf = shard_fn or no_move
    if conv0 is not None:
        ext = torch.cat([conv0, x], dim=1)
        conv = _causal_conv(ext, params["conv_w"], params["conv_b"])[:, conv0.shape[1]:]
    else:
        conv = _causal_conv(x, params["conv_w"], params["conv_b"])
    conv = sf(F.silu(conv.float()).to(x.dtype), "slstm_conv")
    # the input projection hoisted out of the loop: one (B*S,d)x(d,4d) GEMM
    pre_all = sf(x.float() @ params["w_in"], "slstm_pre") + params["b"]
    state, hs = _slstm_loop(params["r_rec"], pre_all, conv, h, hd, state)
    out = _slstm_out(params, hs, x.dtype, sf)
    kk = xc.conv1d_kernel - 1
    conv_tail = (torch.cat([conv0, x], dim=1)[:, -kk:]
                 if conv0 is not None else x[:, -kk:])
    return out, (state, conv_tail)


def slstm_mix_rank(params: Params, cfg: ModelConfig, x, tp):
    """`slstm_mix`'s output as a rank of the sharded step computes it
    (module docstring): x (B,S,d), the residual stream whole along the
    sequence -> its output there."""
    xc, h, hd = _slstm_dims(cfg)
    b, s, d = x.shape
    rh = _RankHeads(tp, h, hd)
    h0, h1 = rh.h0, rh.h0 + rh.n
    f = int(xc.proj_factor_slstm * d)
    f0, f1 = tp.tp_block(f)
    x = tp.enter(x)
    conv = _causal_conv(x[..., rh.c0:rh.c1], params["conv_w"],
                        params["conv_b"])
    conv = rh.of(F.silu(conv.float()).to(x.dtype))
    pre = tp.cols(tp.linear(x.float(), params["w_in"], "w_in"))
    pre_all = (pre.reshape(b, s, 4, h, hd)[:, :, :, h0:h1]
               + params["b"].reshape(4, h, hd)[:, h0:h1]).reshape(
                   b, s, 4 * rh.n * hd)
    _, hs = _slstm_loop(params["r_rec"][h0:h1], pre_all, conv, rh.n, hd)
    y = tp.cols(rh.own(_norm_heads(hs, params["norm_scale"][rh.channels],
                                   x.dtype)))
    gu = tp.cols(tp.linear(y, params["up"], "up"))
    y = F.gelu(gu[..., f0:f1].float(), approximate="tanh").to(x.dtype) \
        * gu[..., f + f0:f + f1]
    return tp.exit(tp.linear(y, params["down"], "down"))


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
