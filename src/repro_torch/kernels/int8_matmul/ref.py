"""Plain PyTorch versions of the weight-only int8 GEMM.

`quantize_weights` and `int8_matmul_ref` are the ports of the reference's
oracle (`repro.kernels.int8_matmul.ref`). `int8_matmul_ref` is what the
Hopper kernel computes, the CPU path of the wrapper, and the kernel's
reference on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: (K,N) float -> (wq int8 (K,N), scales (N,) fp32), per output
    channel: scale = max(max |w[:, n]|, 1e-12) / 127, wq = round(w / scale)
    clipped to [-127, 127] (round half to even, as jnp.round)."""
    wf = w.float()
    scales = torch.clamp_min(wf.abs().amax(dim=0), 1e-12) / 127.0
    wq = torch.clamp(torch.round(wf / scales[None, :]), -127, 127)
    return wq.to(torch.int8), scales


def int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """x: (M,K); wq: (K,N) int8; scales: (N,) -> (M,N) in x.dtype, the
    product and the scale in fp32."""
    acc = torch.einsum("mk,kn->mn", x.float(), wq.float())
    return (acc * scales.float()[None, :]).to(x.dtype)
