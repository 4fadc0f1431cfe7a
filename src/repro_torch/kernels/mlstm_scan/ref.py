"""Plain PyTorch versions of the chunkwise mLSTM kernel.

`mlstm_chunk` is the port of `repro.models.xlstm._mlstm_chunk`: one chunk of
the stabilized chunkwise mLSTM in the model's layout. `mlstm_scan_ref` runs
it chunk after chunk over (B,H,S,hd) inputs with the state in and out: what
the Hopper kernels compute. `mlstm_scan_two_pass_ref` computes the same in
the two passes of the bf16 tensor-core kernel, rounding to bf16 where that
kernel rounds. `mlstm_ref` is the port of the reference's sequential oracle
(`repro.kernels.mlstm_scan.ref.mlstm_ref`).

The stabilizers use `amax` and `torch.maximum`, which split the gradient
between tied entries as JAX's `max` and `maximum` do.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG = -1e30
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_chunk(q, k, v, log_i, log_f, state: State, scale: float):
    """One chunk. q,k,v: (B,C,H,hd); log_i/log_f: (B,C,H) fp32; state =
    (C (B,H,hd_k,hd_v), n (B,H,hd), m (B,H)) fp32. Returns (y fp32
    (B,C,H,hd), new state)."""
    c_mat, n_vec, m_run = state
    c = q.shape[1]
    bcum = torch.cumsum(log_f, dim=1)                              # (B,C,H)
    # intra-chunk log decay matrix: b_i - b_j + log_i_j for j <= i
    logd = (bcum[:, :, None, :] - bcum[:, None, :, :]
            + log_i[:, None, :, :])                                # (B,i,j,H)
    tri = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    logd = torch.where(tri[None, :, :, None], logd, NEG)
    m_intra = logd.amax(dim=2)                                     # (B,C,H)
    m_new = torch.maximum(m_intra, bcum + m_run[:, None, :])
    w_intra = torch.exp(logd - m_new[:, :, None, :])
    w_state = torch.exp(bcum + m_run[:, None, :] - m_new)

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bihd,bjhd->bijh", qf, kf) * w_intra
    num = (torch.einsum("bijh,bjhd->bihd", scores, vf)
           + w_state[..., None] * torch.einsum("bihd,bhde->bihe", qf, c_mat))
    den_raw = (scores.sum(dim=2)
               + w_state * torch.einsum("bihd,bhd->bih", qf, n_vec))
    den = torch.maximum(den_raw.abs(), torch.exp(-m_new))
    y = num / den[..., None]

    # carry the state to the end of the chunk
    btot = bcum[:, -1, :]                                          # (B,H)
    m_next = torch.maximum(btot + m_run,
                           (btot[:, None] - bcum + log_i).amax(dim=1))
    w_upd = torch.exp(btot[:, None] - bcum + log_i - m_next[:, None])
    decay = torch.exp(btot + m_run - m_next)
    c_next = (decay[:, :, None, None] * c_mat
              + torch.einsum("bch,bchd,bche->bhde", w_upd, kf, vf))
    n_next = (decay[:, :, None] * n_vec
              + torch.einsum("bch,bchd->bhd", w_upd, kf))
    return y, (c_next, n_next, m_next)


def zero_state(b: int, h: int, hd: int, device) -> State:
    """C = n = 0 and m = 0 (`xlstm.py:140-142`; not -1e30)."""
    f32 = torch.float32
    return (torch.zeros(b, h, hd, hd, dtype=f32, device=device),
            torch.zeros(b, h, hd, dtype=f32, device=device),
            torch.zeros(b, h, dtype=f32, device=device))


def mlstm_scan_ref(q, k, v, log_i, log_f, state: Optional[State] = None, *,
                   bc: int = 256):
    """q,k,v: (B,H,S,hd); log_i/log_f: (B,H,S) fp32 -> (y (B,H,S,hd) in
    q.dtype, (C, n, m)). Chunks of `bc` rows, the last one ragged."""
    b, h, s, hd = q.shape
    if state is None:
        state = zero_state(b, h, hd, q.device)
    scale = 1.0 / math.sqrt(hd)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))   # (B,S,H,hd)
    lis, lfs = log_i.transpose(1, 2), log_f.transpose(1, 2)
    ys = []
    for t0 in range(0, s, bc):
        sl = slice(t0, t0 + bc)
        y, state = mlstm_chunk(qs[:, sl], ks[:, sl], vs[:, sl], lis[:, sl],
                               lfs[:, sl], state, scale)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(q.dtype).transpose(1, 2)
    return y, state


# log2(e) as the kernels' fp32 constant kLog2e
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _bf16(x):
    """x rounded to bf16 (nearest even), kept in fp32."""
    return x.to(torch.bfloat16).float()


def split_bf16(x):
    """x as two bf16 values kept in fp32, hi = x rounded and lo = x - hi
    rounded: hi + lo equals x to about 2^-16 of x (the kernel's P v
    operands)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def mlstm_scan_two_pass_ref(q, k, v, log_i, log_f,
                            state: Optional[State] = None, *,
                            chunk: int = 64):
    """What the bf16 tensor-core kernel computes, in its two passes, with
    its roundings. Same arguments and results as `mlstm_scan_ref`.

    Pass (a), the recurrence: chunk after chunk of `chunk` rows it keeps
    the state (C, n, m) in fp32 and records it at each chunk's start. The
    C update's weighted keys a = w_upd k are split into three bf16 parts,
    hi + mid + lo = a to about 2^-24 of a (two parts leave 2^-16, which
    costs C up to 3e-5 of its 1e-4 tolerance at S = 200), whose products
    with v the kernel sums in fp32 on the tensor cores; n sums a in fp32.
    Pass (b), every chunk at once from its recorded start, in the
    kernel's order and base: the scores q k^T in fp32 from the inputs,
    times the fp32 scale 1/sqrt(hd) after the product; the decay weights
    as 2^(fma(logd, log2 e, -m log2 e)), one rounding of the exponent, as
    the kernel's ex2 takes them (P = (S scale) 2^(...)); q C from the
    chunk-start C rounded to bf16, times (scale w_state); q n in fp32; the
    weighted scores P summed in fp32 for the denominator and split into
    two bf16 parts for P v (`split_bf16`). Rows past S (the ragged last
    chunk) are zero with log_i = -inf and log_f = 0, so they add nothing.
    What it cannot copy: the order of the fp32 sums inside the kernel's mma
    tiles, the order of its gates' cumulative sum, and ex2's approximation
    (2 ulp). These move P by about 1e-6 of itself. Rounded once to bf16, P
    would take them to the neighbouring bf16 value now and then, 2^-8 of a
    P v term, which moves y past 1e-2 + 1e-2 |y| where the denominator
    nearly cancels; as hi + lo they move y by about 1e-6. A chunk-start C
    entry may still tip, which moves y by 2^-8 of one q C term."""
    b, h, s, hd = q.shape
    if state is None:
        state = zero_state(b, h, hd, q.device)
    # the kernel's 1.0f / sqrtf(float(HD)): fp32, each step rounded once
    scale = torch.tensor(float(hd), device=q.device).sqrt().reciprocal()
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def rows(x, fill=0.0):
        x = x.float()
        if pad:
            x = torch.cat([x, x.new_full((*x.shape[:2], pad, *x.shape[3:]),
                                         fill)], dim=2)
        return x.unflatten(2, (nc, chunk))
    qf, kf, vf = rows(q), rows(k), rows(v)            # (B,H,nc,L,hd)
    li = rows(log_i, -math.inf)                         # (B,H,nc,L)
    bcum = torch.cumsum(rows(log_f), dim=-1)
    btot = bcum[..., -1]                                # (B,H,nc)

    # (a) the recurrence over chunks
    c_mat, n_vec, m_run = (t.float() for t in state)
    starts = []
    for c in range(nc):
        starts.append((c_mat, n_vec, m_run))
        g = btot[:, :, c, None] - bcum[:, :, c] + li[:, :, c]   # (B,H,L)
        m_next = torch.maximum(btot[:, :, c] + m_run, g.amax(dim=-1))
        w_upd = torch.exp(g - m_next[..., None])
        decay = torch.exp(btot[:, :, c] + m_run - m_next)
        a = w_upd[..., None] * kf[:, :, c]                       # (B,H,L,hd)
        hi = _bf16(a)
        mid = _bf16(a - hi)
        lo = _bf16(a - hi - mid)
        c_mat = decay[..., None, None] * c_mat
        for part in (hi, mid, lo):
            c_mat = c_mat + torch.einsum("bhjd,bhje->bhde", part, vf[:, :, c])
        n_vec = decay[..., None] * n_vec + a.sum(dim=-2)
        m_run = m_next
    c0 = torch.stack([st[0] for st in starts], dim=2)   # (B,H,nc,hd,hd)
    n0 = torch.stack([st[1] for st in starts], dim=2)   # (B,H,nc,hd)
    m0 = torch.stack([st[2] for st in starts], dim=2)   # (B,H,nc)

    # (b) every chunk's rows from its start
    sc = torch.einsum("bhcid,bhcjd->bhcij", qf, kf) * scale
    qc = torch.einsum("bhcid,bhcde->bhcie", qf, _bf16(c0))
    qn = torch.einsum("bhcid,bhcd->bhci", qf, n0) * scale
    logd = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    logd = torch.where(tri, logd, -math.inf)
    m_row = torch.maximum(logd.amax(dim=-1), bcum + m0[..., None])
    # fmaf(logd, log2e, -m log2e) in fp32: the product of two fp32 numbers
    # is exact in fp64, so one rounding to fp32 after the sum
    ml2 = m_row * LOG2E
    expo = (logd.double() * LOG2E.double() - ml2.double()[..., None]).float()
    p = sc * torch.exp2(expo)
    w_state = torch.exp(bcum + m0[..., None] - m_row)
    den = torch.maximum((p.sum(dim=-1) + w_state * qn).abs(),
                        torch.exp(-m_row))
    num = (sum(torch.einsum("bhcij,bhcje->bhcie", part, vf)
               for part in split_bf16(p))
           + qc * (scale * w_state)[..., None])
    y = (num / den[..., None]).flatten(2, 3)[:, :, :s]
    return y.to(q.dtype), (c_mat, n_vec, m_run)


def mlstm_ref(q, k, v, log_i, log_f):
    """q,k,v: (B,H,S,hd); log_i/log_f: (B,H,S) -> (B,H,S,hd).

    C_t = f'_t C_{t-1} + i'_t v_t k_t^T ;  n_t = f'_t n_{t-1} + i'_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))  with the max-stabilizer
    m_t = max(log f_t + m_{t-1}, log i_t). One step at a time; C is kept
    [v, k] here, as in the reference oracle (the cache layout is [k, v])."""
    b, h, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    li = log_i.float()
    lf = log_f.float()
    c_mat = torch.zeros(b, h, hd, hd, dtype=torch.float32, device=q.device)
    n_vec = torch.zeros(b, h, hd, dtype=torch.float32, device=q.device)
    m = torch.zeros(b, h, dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        m_new = torch.maximum(lf[:, :, t] + m, li[:, :, t])
        i_g = torch.exp(li[:, :, t] - m_new)
        f_g = torch.exp(lf[:, :, t] + m - m_new)
        c_mat = (f_g[..., None, None] * c_mat
                 + i_g[..., None, None]
                 * vf[:, :, t, :, None] * kf[:, :, t, None, :])
        n_vec = f_g[..., None] * n_vec + i_g[..., None] * kf[:, :, t]
        num = torch.einsum("bhvk,bhk->bhv", c_mat, qf[:, :, t])
        den = torch.maximum(
            torch.einsum("bhk,bhk->bh", n_vec, qf[:, :, t]).abs(),
            torch.exp(-m_new))
        m = m_new
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=2).to(q.dtype)
