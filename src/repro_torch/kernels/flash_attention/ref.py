"""The plain PyTorch versions of the flash attention kernels: the port of
`repro.kernels.flash_attention.ref.attention_ref` (with the reference
model's logit softcapping and log-sum-exp) and of the backward of
`repro.models.attention.blockwise_sdpa` (`_blockwise_bwd`). The tests hold
them against the JAX oracle, the wrapper runs the forward for CPU tensors,
and `chip_smoke.py` holds the Hopper kernels against them on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _valid(qi, kj, causal: bool, window: int) -> torch.Tensor:
    """(S, T) keys row i may see: j <= i if causal, i - j < window if
    window > 0."""
    valid = torch.ones((qi.shape[0], kj.shape[0]), dtype=torch.bool,
                       device=qi.device)
    if causal:
        valid &= kj[None, :] <= qi[:, None]
    if window > 0:
        valid &= (qi[:, None] - kj[None, :]) < window
    return valid


def _scores(q, k, qi, kj, causal: bool, window: int, softcap: float):
    """fp32 scores of q (B,Hkv,G,S,hd) over k (B,Hkv,T,hd): scaled,
    softcapped (c tanh(s / c)), masked at -1e30. Also tanh(s / c) under
    softcap (else None), for the backward's chain factor."""
    s = torch.einsum("bkgsh,bkth->bkgst", q, k) / math.sqrt(q.shape[-1])
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = th * softcap
    return s.masked_fill(~_valid(qi, kj, causal, window), NEG_INF), th


def _attend(q, k, v, qi, kj, causal: bool, window: int, softcap: float,
            want_lse: bool):
    """fp32 attention of q (B,Hkv,G,S,hd) at positions qi (S,) over k, v
    (B,Hkv,T,hd) at positions kj (T,): the output and, if wanted, each
    row's lse (else None)."""
    scores, _ = _scores(q, k, qi, kj, causal, window, softcap)
    out = torch.einsum("bkgst,bkth->bkgsh", torch.softmax(scores, dim=-1), v)
    return out, torch.logsumexp(scores, dim=-1) if want_lse else None


def _reach(a: int, e: int, t: int, causal: bool, window: int):
    """The keys [lo, hi) that query rows [a, e) can see (causal rows only
    keys up to their own; a window only its last keys)."""
    lo, hi = 0, t
    if causal:
        hi = min(t, e)
        if window > 0:
            lo = min(max(0, a - window + 1), hi - 1)
    return lo, hi


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  row_chunk: int = 0, return_lse: bool = False):
    """q: (B,H,S,hd); k,v: (B,Hkv,T,hd); GQA via H % Hkv == 0.
    fp32 softmax with masked scores at -1e30, the scaled scores capped to
    c tanh(s / c) first where `softcap` c > 0 (the reference model's
    `attn_logit_softcap`); returns (B,H,S,hd) in q.dtype, and with
    `return_lse` also each row's log-sum-exp (B,H,S) in fp32, which the
    backward recomputes P from.

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
        out, lse = _attend(qf, kf, vf, qi, kj, causal, window, softcap,
                           return_lse)
        out = out.reshape(b, h, s, hd).to(q.dtype)
    else:
        outs, lses = [], []
        for a in range(0, s, row_chunk):
            e = min(s, a + row_chunk)
            lo, hi = _reach(a, e, t, causal, window)
            o, l = _attend(qf[:, :, :, a:e], kf[:, :, lo:hi], vf[:, :, lo:hi],
                           qi[a:e], kj[lo:hi], causal, window, softcap,
                           return_lse)
            outs.append(o.to(q.dtype))
            lses.append(l)
        out = torch.cat(outs, dim=3).reshape(b, h, s, hd)
        lse = torch.cat(lses, dim=3) if return_lse else None
    if return_lse:
        return out, lse.reshape(b, h, s)
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """dq, dk, dv of `attention_ref` from its output and lse: the port of
    the reference's `_blockwise_bwd` in the (B,H,S,hd) layout. q (B,H,S,hd),
    k (B,Hkv,T,hd), v (B,Hkv,T,hd_v), out and dout (B,H,S,hd_v), lse (B,H,S)
    fp32. For each (kv chunk, q chunk) block it recomputes P = exp(z - lse)
    from the scores and takes delta = rowsum(dout o out):
    dV += P^T dO, dS = P o (dP - delta) (times 1 - tanh^2 under softcap),
    dQ += dS K / sqrt(hd), dK += dS^T Q / sqrt(hd), all in fp32; only
    (q_chunk, kv_chunk) temporaries. Blocks the mask empties are skipped
    (their P is exactly 0). Returns the grads in the inputs' dtypes."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, hkv, g, s, hd)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, hkv, g, s, -1)
    lsef = lse.float().reshape(b, hkv, g, s)
    delta = (dout.float() * out.float()).sum(-1).reshape(b, hkv, g, s)
    qi = torch.arange(s, device=q.device)
    kj = torch.arange(t, device=q.device)
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, t, kv_chunk):
        k1 = min(t, k0 + kv_chunk)
        k_j, v_j = kf[:, :, k0:k1], vf[:, :, k0:k1]
        for q0 in range(0, s, q_chunk):
            q1 = min(s, q0 + q_chunk)
            lo, hi = _reach(q0, q1, t, causal, window)
            if k0 >= hi or k1 <= lo:
                continue
            if window > 0 and not causal and q0 - (k1 - 1) >= window:
                continue
            q_i, do_i = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
            sc, th = _scores(q_i, k_j, qi[q0:q1], kj[k0:k1], causal, window,
                             softcap)
            p = torch.exp(sc - lsef[:, :, :, q0:q1, None])
            dv[:, :, k0:k1] += torch.einsum("bkgct,bkgch->bkth", p, do_i)
            dp = torch.einsum("bkgch,bkth->bkgct", do_i, v_j)
            ds = p * (dp - delta[:, :, :, q0:q1, None])
            if softcap:
                ds = ds * (1.0 - th ** 2)
            dq[:, :, :, q0:q1] += torch.einsum("bkgct,bkth->bkgch", ds,
                                               k_j) * scale
            dk[:, :, k0:k1] += torch.einsum("bkgct,bkgch->bkth", ds,
                                            q_i) * scale
    return (dq.reshape(b, h, s, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
