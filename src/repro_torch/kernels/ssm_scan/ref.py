"""Plain PyTorch version of the Mamba selective-scan kernel.

`ssm_scan_ref` is the port of the reference's sequential oracle
(`repro.kernels.ssm_scan.ref.ssm_scan_ref`), extended with the state in and
out that the model's prefill hands to decode (`repro.models.ssm.mamba_mix`
returns `h_last` for the cache). It is what the Hopper kernel computes, the
CPU path of the wrapper, and the kernel's reference on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis import trace


def ssm_scan_ref(x, dt, b_t, c_t, a, d, h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential over time, fp32 math, S >= 1.
    x, dt: (B,S,di); b_t, c_t: (B,S,ds); a: (di,ds) fp32; d: (di,) fp32;
    h0: (B,di,ds) fp32 or None (zeros) -> (y (B,S,di) in x.dtype,
    h_last (B,di,ds) fp32).
        h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t . h_t + D x_t
    """
    bsz, s, di = x.shape
    ds = a.shape[1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b_t, c_t))
    af, df = a.float(), d.float()
    h = (torch.zeros(bsz, di, ds, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())

    def step(carry, dt_t, b_t_, x_t, c_t_, af, df):
        decay = torch.exp(dt_t[:, :, None] * af)                    # (B,di,ds)
        drive = dt_t[:, :, None] * b_t_[:, None, :] * x_t[:, :, None]
        h = decay * carry[0] + drive
        return (h,), torch.einsum("bds,bs->bd", h, c_t_) + df * x_t

    # a Python loop over time; the dry run's trace folds it (one step
    # counted s times)
    (h,), ys = trace.scan(step, (h,), ((dtf, 1), (bf, 1), (xf, 1), (cf, 1)),
                          s, consts=(af, df))
    return ys.to(x.dtype), h
