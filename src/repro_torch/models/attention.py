"""Attention mixers: GQA (global / sliding-window), MLA, cross-attention.
The port of `repro.models.attention`.

Entry points, as in the reference:
  attention_forward / mla_forward        full-sequence (train and prefill)
  attention_prefill / mla_prefill        full-sequence + the decode cache
  attention_decode / mla_decode          single-token step against the cache
  cross_attention_forward                decoder rows over encoder keys
  cross_attention_decode                 one row over the cross cache
  encode_cross_kv                        the encoder's keys and values

Full-sequence attention goes through `kernels.flash_attention`: on the card
the Hopper kernel, on the CPU its plain version. That covers encoder
self-attention and cross-attention (`causal=False`, S decoder rows over T
encoder rows) and MLA's prefill, whose values are zero-padded to the
192-wide head of its queries and keys. Decode attention over a cache has no
Pallas counterpart and stays plain torch, as the reference computes it
outside its kernel: `naive_sdpa` over the GQA and cross caches, MLA's
absorbed einsums over the latent cache. Caches for sliding-window layers
are ring buffers of size `window` with per-slot absolute positions;
`slot_pos == -1` marks a free slot. The reference's `blockwise_sdpa` is the
kernel pair's counterpart: its forward the flash forward with lse, its
custom VJP the flash backward (`ref.attention_bwd_ref` in plain torch). Under
executing sharding rules (`attention_forward(..., tp=)`, `mla_forward(...,
tp=)`, `cross_attention_forward(..., tp=)` with `encode_cross_kv(...,
tp=)`) the same body computes a rank's own heads, and flash runs on
those.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (LOCAL, Local, apply_rope,
                                       dense_init, l2norm, no_move,
                                       rmsnorm, torch_dtype)

Params = Dict[str, Any]
NEG_INF = -1e30


# =============================================================== GQA params

def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   lead: Tuple[int, ...] = ()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg.param_dtype)
    return {
        "w_q": dense_init(gen, d, h * hd, dt, lead),
        "w_k": dense_init(gen, d, kv * hd, dt, lead),
        "w_v": dense_init(gen, d, kv * hd, dt, lead),
        "w_o": dense_init(gen, h * hd, d, dt, lead),
    }


def cross_attention_init(gen: torch.Generator, cfg: ModelConfig,
                         lead: Tuple[int, ...] = ()) -> Params:
    return attention_init(gen, cfg, lead)


# ========================================================== core softmax op

def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
               causal: bool) -> torch.Tensor:
    """Additive bias (Sq, Tk) from absolute positions. kv_pos < 0 = invalid."""
    valid = kv_pos[None, :] >= 0
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & ((q_pos[:, None] - kv_pos[None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, NEG_INF)


def naive_sdpa(q, k, v, q_pos, kv_pos, *, window: int = 0, causal: bool = True,
               softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,Kv,G,hd); k,v: (B,T,Kv,hd). Returns (B,S,Kv,G,hd).
    Scores in fp32 (exact products of the inputs), softmax in fp32, the
    weights cast to q.dtype before the value product."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = s + _mask_bias(q_pos, kv_pos, window, causal)[None, None, None]
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v)


def sdpa(q, k, v, q_pos, kv_pos, *, window: int = 0, causal: bool = True,
         softcap: float = 0.0) -> torch.Tensor:
    """Attention of (B,S,Kv,G,hd) queries over (B,T,Kv,hd) keys with
    absolute positions. The reference switches to its blockwise form above
    S=2048; here full-sequence attention takes the flash kernels instead
    (`_self_attention`), whose backward is that form's, and this plain one
    serves the rest."""
    return naive_sdpa(q, k, v, q_pos, kv_pos, window=window, causal=causal,
                      softcap=softcap)


def _self_attention(cfg: ModelConfig, q, k, v, *, window: int,
                    causal: bool) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,Kv,hd) at positions 0..S-1 -> (B,S,H*hd)
    (Kv = H where `_group_for_tp` expanded the KV heads; H and Kv a rank's
    under executing sharding rules).
    Goes through the flash attention wrapper, with the config's logit
    softcap: the Hopper kernels on the card, their plain version on the
    CPU."""
    B, S, H = q.shape[:3]
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          softcap=cfg.attn_logit_softcap)
    return out.transpose(1, 2).reshape(B, S, H * cfg.head_dim)


# ============================================================ GQA forward

def _qkv(params: Params, cfg: ModelConfig, x, positions, tp=None):
    """q, k, v as heads, normed and rotated; `tp` (`Local` by default)
    gives a rank its query heads (`q_heads`: whole heads, also where
    `model` cuts through them) and the KV heads they read."""
    tp = Local(cfg.head_dim) if tp is None else tp
    q = tp.q_heads(tp.linear(x, params["w_q"], "w_q"))
    k = tp.kv_heads(tp.linear(x, params["w_k"], "w_k"))
    v = tp.kv_heads(tp.linear(x, params["w_v"], "w_v"))
    if cfg.qk_norm:
        q, k = l2norm(q), l2norm(k)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    return q, k, v


def _group_for_tp(q, k, v, cfg: ModelConfig, expand_kv: bool, shard_fn):
    """Arrange heads for the sharded attention core. When the TP width
    divides H but not Kv (e.g. Mistral-Large: 96 q heads, 8 kv heads,
    16-way TP), the (Kv, G) grouping leaves nothing to shard; expanding KV
    to full heads (G = 1) restores clean head sharding, and the kernel is
    called with H key heads. Without `expand_kv` q, k, v come back as they
    are."""
    if expand_kv and cfg.q_per_kv > 1:
        if shard_fn is not None:   # every KV head on each rank first
            k, v = shard_fn(k, "kv"), shard_fn(v, "kv")
        k = k.repeat_interleave(cfg.q_per_kv, dim=2)
        v = v.repeat_interleave(cfg.q_per_kv, dim=2)
        if shard_fn is not None:
            q, k, v = (shard_fn(a, "bshd") for a in (q, k, v))
    return q, k, v


def attention_forward(params: Params, cfg: ModelConfig, x, *, window: int = 0,
                      causal: bool = True, expand_kv: bool = False,
                      shard_fn=None, tp=None) -> torch.Tensor:
    """Self-attention over the whole sequence. `tp` places it: all heads
    (`Local`, the default), or under executing `ShardingRules` a rank's:
    the residual stream in (`tp.enter`), the rank's columns of w_q, w_k,
    w_v (each gathered over its FSDP axes), its query heads (where the
    model axis cuts through them, every head its columns reach into,
    `tp.q_heads`), its KV heads or, where the model axis does not divide
    them, those its query heads read (`tp.kv_heads`), flash on the local
    heads, the rank's own columns of their output (`tp.head_cols`) into
    its rows of w_o, the partial sums out (`tp.exit`). `expand_kv` and
    `shard_fn` are the dry run's plan of the same (`_group_for_tp`)."""
    tp = Local(cfg.head_dim) if tp is None else tp
    x = tp.enter(x)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions, tp)
    q, k, v = _group_for_tp(q, k, v, cfg, expand_kv, shard_fn)
    out = tp.head_cols(_self_attention(cfg, q, k, v, window=window,
                                       causal=causal))
    return tp.exit(tp.linear(out, params["w_o"], "w_o"))


# ============================================================ decode caches

def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                    window: int = 0, dtype=None, device=None,
                    lead: Tuple[int, ...] = ()) -> Params:
    cap = min(window, max_seq) if window > 0 else max_seq
    dt = dtype or torch_dtype(cfg.param_dtype)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((*lead, batch, cap, kv, hd), dtype=dt, device=device),
        "v": torch.zeros((*lead, batch, cap, kv, hd), dtype=dt, device=device),
        "slot_pos": torch.full((*lead, cap), -1, dtype=torch.int32,
                               device=device),
    }


def attention_prefill(params: Params, cfg: ModelConfig, x, *, window: int = 0,
                      max_seq: int = 0, expand_kv: bool = False,
                      shard_fn=None) -> Tuple[torch.Tensor, Params]:
    """Full-sequence attention + build the decode cache (of the Kv heads,
    whatever `expand_kv` gives the kernel)."""
    B, S, _ = x.shape
    max_seq = max_seq or S
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    qe, ke, ve = _group_for_tp(q, k, v, cfg, expand_kv, shard_fn)
    out = _self_attention(cfg, qe, ke, ve, window=window, causal=True)
    out = out @ params["w_o"]

    cap = min(window, max_seq) if window > 0 else max_seq
    cache = init_attn_cache(cfg, B, max_seq, window=window, dtype=k.dtype,
                            device=x.device)
    take = min(S, cap)
    idx = torch.arange(S - take, S, device=x.device)
    slots = idx % cap
    cache["k"][:, slots] = k[:, idx]
    cache["v"][:, slots] = v[:, idx]
    cache["slot_pos"][slots] = idx.to(torch.int32)
    return out, cache


def attention_decode(params: Params, cfg: ModelConfig, x, cache: Params,
                     pos: Union[int, torch.Tensor], *, window: int = 0
                     ) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,d); pos: position of the new token. Unlike the reference,
    which returns new arrays, this writes the new token's k, v and position
    into `cache` in place (no copy of the cache per token) and returns it."""
    B = x.shape[0]
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    pos = int(pos)
    # a fill on the device: torch.tensor([pos], device=...) would copy from
    # pageable host memory and synchronize the stream once per layer
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["slot_pos"][slot] = pos
    qg = q.reshape(B, 1, kv, cfg.q_per_kv, hd)
    out = naive_sdpa(qg, cache["k"], cache["v"], positions, cache["slot_pos"],
                     window=window, causal=True,
                     softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ params["w_o"], cache


# ========================================================== cross-attention

def cross_attention_forward(params: Params, cfg: ModelConfig, x,
                            enc_kv: Params, tp=None) -> torch.Tensor:
    """x: (B,S,d) decoder states; enc_kv: dict(k, v) of (B,T,kv,hd). Every
    row sees every key (the reference's `causal=False` with no window), so
    this is the flash kernel non-causal, S rows over T keys. `tp` places
    it as `attention_forward`'s: all heads (`Local`), or under executing
    `ShardingRules` a rank's: q from the decoder stream entered
    (`tp.enter`) on the rank's columns of w_q, k and v the rank's KV heads
    over the whole encoder sequence (`encode_cross_kv` with the same
    `tp`), the rank's rows of w_o, the partial sums out (`tp.exit`)."""
    tp = Local(cfg.head_dim) if tp is None else tp
    x = tp.enter(x)
    B, S, _ = x.shape
    q = tp.q_heads(tp.linear(x, params["w_q"], "w_q"))
    out = flash_attention(q.transpose(1, 2), enc_kv["k"].transpose(1, 2),
                          enc_kv["v"].transpose(1, 2), causal=False)
    out = tp.head_cols(out.transpose(1, 2).reshape(B, S, -1))
    return tp.exit(tp.linear(out, params["w_o"], "w_o"))


def cross_attention_decode(params: Params, cfg: ModelConfig, x,
                           enc_kv: Params) -> torch.Tensor:
    """One decoder row over the cross cache (B,max_seq,kv,hd), plain torch
    as the reference's decode computes it: every slot is attended,
    including the zero keys and values that pad an encoder shorter than
    `max_seq` (the reference's `kv_pos = arange(T)`, `causal=False`)."""
    B, S, _ = x.shape
    q = (x @ params["w_q"]).reshape(B, S, cfg.num_kv_heads, cfg.q_per_kv,
                                    cfg.head_dim)
    T = enc_kv["k"].shape[1]
    kv_pos = torch.arange(T, device=x.device)
    out = naive_sdpa(q, enc_kv["k"], enc_kv["v"],
                     torch.full((S,), T - 1, device=x.device), kv_pos,
                     causal=False)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["w_o"]


def encode_cross_kv(params: Params, cfg: ModelConfig, enc_out,
                    tp=None) -> Params:
    """The cross keys and values (B,T,kv,hd) of the encoder output: every
    KV head (`Local`), or under executing `ShardingRules` those of the
    rank's query heads (`tp.kv_heads`), from the encoder output whole
    along its sequence."""
    tp = Local(cfg.head_dim) if tp is None else tp
    return {name: tp.kv_heads(tp.linear(enc_out, params[w], w))
            for name, w in (("k", "w_k"), ("v", "w_v"))}


# ===================================================================== MLA

def _latent_init(gen: torch.Generator, r: int, h: int, e: int, dtype,
                 lead: Tuple[int, ...]) -> torch.Tensor:
    """(r, h, e) normal * 1/sqrt(r), drawn in fp32: `w_uk` and `w_uv`, kept
    3-D so the decode path can absorb them per head."""
    w = torch.randn(*lead, r, h, e, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w / math.sqrt(r)).to(dtype)


def mla_init(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = ()) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dt = torch_dtype(cfg.param_dtype)
    qk_dim = m.nope_head_dim + m.rope_head_dim
    dev = gen.device
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dt, lead),
        "q_norm": {"scale": torch.ones(*lead, m.q_lora_rank, dtype=dt,
                                       device=dev)},
        "w_uq": dense_init(gen, m.q_lora_rank, h * qk_dim, dt, lead),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, dt, lead),
        "kv_norm": {"scale": torch.ones(*lead, m.kv_lora_rank, dtype=dt,
                                        device=dev)},
        "w_kr": dense_init(gen, d, m.rope_head_dim, dt, lead),
        "w_uk": _latent_init(gen, m.kv_lora_rank, h, m.nope_head_dim, dt,
                             lead),
        "w_uv": _latent_init(gen, m.kv_lora_rank, h, m.v_head_dim, dt, lead),
        "w_o": dense_init(gen, h * m.v_head_dim, d, dt, lead),
    }


def _mla_latent(params: Params, x, name: str, tp, sf):
    """`x @ params[name]`, whole on every rank: a rank's column block of
    the latent all-gathered over `model` (`tp.cols`); `sf` marks the same
    for the dry run's plan ("mla_latent")."""
    return sf(tp.cols(tp.linear(x, params[name], name)), "mla_latent")


def _mla_q(params: Params, cfg: ModelConfig, x, positions, tp=LOCAL,
           sf=no_move):
    """q's nope and rope parts (B,S,h,*) of the heads whose `w_uq` columns
    `params` holds (all of them, or under executing rules a rank's)."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rmsnorm(params["q_norm"], _mla_latent(params, x, "w_dq", tp, sf))
    q = tp.linear(cq, params["w_uq"], "w_uq").reshape(
        B, S, -1, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params: Params, cfg: ModelConfig, x, positions, tp=LOCAL,
             sf=no_move):
    c_kv = rmsnorm(params["kv_norm"],
                   _mla_latent(params, x, "w_dkv", tp, sf))
    k_rope = _mla_latent(params, x, "w_kr", tp, sf)[:, :, None, :]
    return c_kv, apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]


def mla_forward(params: Params, cfg: ModelConfig, x, *, shard_fn=None,
                tp=None) -> torch.Tensor:
    """Unabsorbed (train/prefill) MLA: K and V expanded per head (no KV
    grouping), causal attention through the flash wrapper at head_dim
    nope + rope. V's v_head_dim columns are zero-padded to that width for
    the kernel, which takes one head_dim for q, k and v, and the output's
    first v_head_dim columns kept: exact, since the padded columns weigh
    nothing and the scale is 1/sqrt(nope + rope) either way.

    `tp` places it: all heads (`Local`, the default), or under executing
    `ShardingRules` a rank's: the residual stream in (`tp.enter`); the
    latents `w_dq`, `w_dkv` and `w_kr` column-parallel, each all-gathered
    whole over `model` (`q_norm` and `kv_norm` normalise the whole latent,
    every head reads the one `k_rope`), their gradients' parts summed by
    the reduce-scatter back and the norms' scales by `sync_grads`; the
    rank's heads of `w_uq`'s columns, `w_uk` and `w_uv` as they are; flash
    on those heads; the rank's rows of `w_o`, the partial sums out
    (`tp.exit`). `shard_fn` marks the latents' gathers for the dry run's
    plan of the same."""
    m = cfg.mla
    tp = LOCAL if tp is None else tp
    sf = shard_fn or no_move
    x = tp.enter(x)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions, tp, sf)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions, tp, sf)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uv"])
    h = v.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)                  # (B,S,h,qk)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, h, m.rope_head_dim)], dim=-1)
    qk_dim = q.shape[-1]
    v = F.pad(v, (0, qk_dim - m.v_head_dim))
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True)
    out = out.transpose(1, 2)[..., :m.v_head_dim]
    return tp.exit(tp.linear(out.reshape(B, S, h * m.v_head_dim),
                             params["w_o"], "w_o"))


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                   device=None, lead: Tuple[int, ...] = ()) -> Params:
    m = cfg.mla
    dt = dtype or torch_dtype(cfg.param_dtype)
    return {
        "c_kv": torch.zeros((*lead, batch, max_seq, m.kv_lora_rank), dtype=dt,
                            device=device),
        "k_rope": torch.zeros((*lead, batch, max_seq, m.rope_head_dim),
                              dtype=dt, device=device),
        "slot_pos": torch.full((*lead, max_seq), -1, dtype=torch.int32,
                               device=device),
    }


def mla_prefill(params: Params, cfg: ModelConfig, x, *, max_seq: int = 0
                ) -> Tuple[torch.Tensor, Params]:
    B, S, _ = x.shape
    max_seq = max_seq or S
    out = mla_forward(params, cfg, x)
    positions = torch.arange(S, device=x.device)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    cache = init_mla_cache(cfg, B, max_seq, dtype=c_kv.dtype, device=x.device)
    cache["c_kv"][:, :S] = c_kv
    cache["k_rope"][:, :S] = k_rope
    cache["slot_pos"][:S] = positions.to(torch.int32)
    return out, cache


def mla_decode(params: Params, cfg: ModelConfig, x, cache: Params,
               pos: Union[int, torch.Tensor]) -> Tuple[torch.Tensor, Params]:
    """One token against the latent cache, which is written in place.
    Absorbed (`cfg.mla.absorb_decode`): attention runs in the latent space,
    q absorbed through W_UK and the context expanded through W_UV after, so
    a token's cache traffic is kv_lora + rope. Unabsorbed: K and V expanded
    per head from the cache, then `naive_sdpa`."""
    m = cfg.mla
    B = x.shape[0]
    h = cfg.num_heads
    pos = int(pos)
    pos1 = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, pos1)               # (B,1,h,*)
    c_kv_new, k_rope_new = _mla_ckv(params, cfg, x, pos1)
    cache["c_kv"][:, pos] = c_kv_new[:, 0]
    cache["k_rope"][:, pos] = k_rope_new[:, 0]
    cache["slot_pos"][pos] = pos
    c_kv, k_rope, slot_pos = cache["c_kv"], cache["k_rope"], cache["slot_pos"]

    if m.absorb_decode:
        q_c = torch.einsum("bqhe,rhe->bqhr", q_nope, params["w_uk"])
        s = (torch.einsum("bqhr,btr->bhqt", q_c.float(), c_kv.float())
             + torch.einsum("bqhe,bte->bhqt", q_rope.float(), k_rope.float()))
        s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
        s = s + _mask_bias(pos1, slot_pos, 0, True)[None, None]
        w = torch.softmax(s, dim=-1).to(x.dtype)
        ctx_c = torch.einsum("bhqt,btr->bqhr", w, c_kv)          # latent ctx
        out = torch.einsum("bqhr,rhe->bqhe", ctx_c, params["w_uv"])
    else:
        k_nope = torch.einsum("btr,rhe->bthe", c_kv, params["w_uk"])
        v = torch.einsum("btr,rhe->bthe", c_kv, params["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], m.rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = naive_sdpa(q[:, :, :, None, :], k, v, pos1, slot_pos,
                         causal=True)
    out = out.reshape(B, 1, h * m.v_head_dim)
    return out @ params["w_o"], cache
