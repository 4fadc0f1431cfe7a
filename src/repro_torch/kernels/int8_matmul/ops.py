"""Public wrapper of the weight-only int8 GEMM kernel.

A CPU tensor goes to the plain version (`ref.int8_matmul_ref`). A CUDA
tensor launches the Hopper kernel (`csrc/int8_matmul.cu`) or raises: there
is no fallback on the card. `int8_matmul.launches` counts kernel launches.
The kernel has no backward: the reference's serves inference only.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("int8_matmul")
    fn = lib.repro_int8_matmul
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [i32] + [ptr] * 4 + [i32] * 3 + [i64, ptr]
    fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(x, wq, scales):
    if len({x.device, wq.device, scales.device}) != 1:
        raise ValueError(f"inputs on different devices: {x.device}, "
                         f"{wq.device}, {scales.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x; got "
                        f"{x.dtype}")
    if wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8; got {wq.dtype}")
    if not scales.is_floating_point():
        raise TypeError(f"scales must be floating point; got {scales.dtype}")
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"want x (M,K) and wq (K,N); got {tuple(x.shape)}, "
                         f"{tuple(wq.shape)}")
    if tuple(scales.shape) != (wq.shape[1],):
        raise ValueError(f"scales must be ({wq.shape[1]},); got "
                         f"{tuple(scales.shape)}")
    m, k = x.shape
    if min(m, k, wq.shape[1]) == 0:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}")
    if max(m, k, wq.shape[1]) >= 2 ** 31 or (m + 63) // 64 > 65535:
        raise ValueError(f"shape x {tuple(x.shape)}, wq {tuple(wq.shape)} "
                         "beyond the launch grid")


def _launch(x, wq, scales):
    m, k = x.shape
    n = wq.shape[1]
    if x.stride(1) != 1:
        x = x.contiguous()
    wq = wq.contiguous()
    scales = scales.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn, err_str = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[x.dtype], x.data_ptr(), wq.data_ptr(),
                 scales.data_ptr(), out.data_ptr(), m, n, k, x.stride(0),
                 stream)
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    with _LAUNCHES_LOCK:   # device lanes and callers may launch at once
        int8_matmul.launches += 1
    return out


def int8_matmul(x, wq, scales):
    """x: (M,K) fp32 or bf16; wq: (K,N) int8; scales: (N,) -> (M,N) in
    x.dtype: ((x.f32 @ wq.f32) * scales.f32).astype(x.dtype). Any M, N, K."""
    _check(x, wq, scales)
    if x.device.type == "cpu":
        return int8_matmul_ref(x, wq, scales)
    return _launch(x, wq, scales)


int8_matmul.launches = 0
