"""The plain PyTorch version of the flash attention kernel: the port of
`repro.kernels.flash_attention.ref.attention_ref`. The tests hold it against
the JAX oracle, the wrapper runs it for CPU tensors, and `chip_smoke.py`
holds the Hopper kernel against it on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,S,hd); k,v: (B,Hkv,T,hd); GQA via H % Hkv == 0.
    fp32 softmax with masked scores at -1e30; returns (B,H,S,hd) in
    q.dtype."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, s, hd)
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bkgsh,bkth->bkgst", qf, kf) / math.sqrt(hd)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    valid = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kj <= qi
    if window > 0:
        valid &= (qi - kj) < window
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bkth->bkgsh", w, vf)
    return out.reshape(b, h, s, hd).to(q.dtype)
