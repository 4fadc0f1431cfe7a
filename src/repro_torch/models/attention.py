"""GQA attention: the port of the GQA path of `repro.models.attention`.

Entry points, as in the reference:
  attention_forward   full-sequence (train and prefill)
  attention_prefill   full-sequence + builds the decode cache
  attention_decode    single-token step against the cache

Full-sequence attention goes through `kernels.flash_attention`: on the card
the Hopper kernel, on the CPU its plain version. Decode attention over the
cache has no Pallas counterpart and stays plain torch (`naive_sdpa`).
Caches for sliding-window layers are ring buffers of size `window` with
per-slot absolute positions; `slot_pos == -1` marks a free slot.
`blockwise_sdpa`, MLA and cross-attention wait for later slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, l2norm, torch_dtype

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
    S=2048; the port has one plain form here, and full-sequence attention
    takes the kernel instead (`_self_attention`)."""
    return naive_sdpa(q, k, v, q_pos, kv_pos, window=window, causal=causal,
                      softcap=softcap)


def _self_attention(cfg: ModelConfig, q, k, v, *, window: int,
                    causal: bool) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,Kv,hd) at positions 0..S-1 -> (B,S,H*hd).
    Goes through the flash attention wrapper: the Hopper kernel on the
    card, its plain version on the CPU."""
    B, S = q.shape[:2]
    if cfg.attn_logit_softcap:
        if q.is_cuda:
            raise NotImplementedError(
                "attn_logit_softcap != 0 has no Hopper kernel yet "
                "(gemma3's slice)")
        pos = torch.arange(S, device=q.device)
        qg = q.reshape(B, S, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim)
        out = sdpa(qg, k, v, pos, pos, window=window, causal=causal,
                   softcap=cfg.attn_logit_softcap)
        return out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)


# ============================================================ GQA forward

def _qkv(params: Params, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["w_q"]).reshape(B, S, h, hd)
    k = (x @ params["w_k"]).reshape(B, S, kv, hd)
    v = (x @ params["w_v"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q, k = l2norm(q), l2norm(k)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    return q, k, v


def attention_forward(params: Params, cfg: ModelConfig, x, *, window: int = 0,
                      causal: bool = True) -> torch.Tensor:
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    out = _self_attention(cfg, q, k, v, window=window, causal=causal)
    return out @ params["w_o"]


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
                      max_seq: int = 0) -> Tuple[torch.Tensor, Params]:
    """Full-sequence attention + build the decode cache."""
    B, S, _ = x.shape
    max_seq = max_seq or S
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    out = _self_attention(cfg, q, k, v, window=window, causal=True)
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
