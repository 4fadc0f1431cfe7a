"""The plain PyTorch version of the flash attention kernel: the port of
`repro.kernels.flash_attention.ref.attention_ref`. The tests hold it against
the JAX oracle, the wrapper runs it for CPU tensors, and `chip_smoke.py`
holds the Hopper kernel against it on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _attend(q, k, v, qi, kj, causal: bool, window: int) -> torch.Tensor:
    """fp32 attention of q (B,Hkv,G,S,hd) at positions qi (S,) over k, v
    (B,Hkv,T,hd) at positions kj (T,)."""
    scores = torch.einsum("bkgsh,bkth->bkgst", q, k) / math.sqrt(q.shape[-1])
    valid = torch.ones((qi.shape[0], kj.shape[0]), dtype=torch.bool,
                       device=q.device)
    if causal:
        valid &= kj[None, :] <= qi[:, None]
    if window > 0:
        valid &= (qi[:, None] - kj[None, :]) < window
    scores = scores.masked_fill(~valid, NEG_INF)
    return torch.einsum("bkgst,bkth->bkgsh", torch.softmax(scores, dim=-1), v)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  row_chunk: int = 0) -> torch.Tensor:
    """q: (B,H,S,hd); k,v: (B,Hkv,T,hd); GQA via H % Hkv == 0.
    fp32 softmax with masked scores at -1e30; returns (B,H,S,hd) in
    q.dtype.

    `row_chunk` > 0 computes `row_chunk` query rows at a time, causal ones
    against only the keys their mask can reach: the same result without the
    whole (S,T) fp32 score matrix (12.9 GB at 48 heads and S = T = 8192)."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, s, hd)
    kf, vf = k.float(), v.float()
    qi = torch.arange(s, device=q.device)
    kj = torch.arange(t, device=q.device)
    if not 0 < row_chunk < s:
        out = _attend(qf, kf, vf, qi, kj, causal, window)
        return out.reshape(b, h, s, hd).to(q.dtype)
    chunks = []
    for a in range(0, s, row_chunk):
        e = min(s, a + row_chunk)
        lo, hi = 0, t
        if causal:
            hi = min(t, e)
            if window > 0:
                lo = min(max(0, a - window + 1), hi - 1)
        chunks.append(_attend(qf[:, :, :, a:e], kf[:, :, lo:hi],
                              vf[:, :, lo:hi], qi[a:e], kj[lo:hi], causal,
                              window).to(q.dtype))
    return torch.cat(chunks, dim=3).reshape(b, h, s, hd)
