"""Public wrapper of the weight-only int8 GEMM kernel.

A CPU tensor goes to the plain version (`ref.int8_matmul_ref`). A CUDA
tensor launches the Hopper kernel (`csrc/int8_matmul.cu`) or raises: there
is no fallback on the card. `_plan` picks one of the kernel's three paths
from (M, dtype): M <= 16 the split-K GEMV, bf16 above the tensor-core GEMM,
fp32 above the fp32 CUDA-core tiles. `int8_matmul.launches` counts
launches.
The kernel has no backward: the reference's serves inference only.

A `meta` tensor under the dry run's cost trace is a third device: the card's
checks, an empty output of the kernel's shape and dtype, and one call with
its `cost` recorded in the active trace (`analysis.trace`); no launch.
Outside a trace a meta tensor is one more tensor off the CPU and goes to
the launch, as the tests that stand it in for the card rely on.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.analysis import trace
from repro_torch.kernels import _build
from repro_torch.kernels.cost import KernelCost
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES_LOCK = threading.Lock()
# GEMV scratch by (device, stream): fp32 partials and the column slabs'
# counters (zero between calls). Kernels on one stream run in order, so a
# call may reuse the scratch of the call before it.
_WORKSPACES: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_WORKSPACES_LOCK = threading.Lock()

SMS = 132            # the H100's streaming multiprocessors
GEMV_MAX_M = 16
# GEMV: rows padded to MT -> weight bytes a thread reads (MT x CPT <= 64
# fp32 accumulators a thread); a block of 8 warps covers 32 x CPT columns.
GEMV_CPT = {1: 16, 2: 16, 4: 16, 8: 8, 16: 4}
GEMV_WARPS = 8
# x's K slice is staged as MT x kps fp32 in at most 32 KB of shared memory
GEMV_SLICE_FLOATS = 8192
MMA_TILE_M, MMA_TILE_N = 128, 128   # bf16 tensor-core GEMM output tiles
FP32_TILE = 64       # fp32 CUDA-core GEMM: 64 x 64 output tiles
# the three paths, as logs and chip_smoke.py name them
GEMV, MMA, TILES = "split-K GEMV", "mma.sync bf16", "cuda-core fp32 tiles"


class Plan(NamedTuple):
    """One path of the kernel and its launch parameters. For the GEMV, split
    s covers K rows [s * kps, min(K, (s + 1) * kps)) and `workspace` is the
    (splits, M, N) fp32 scratch of the splits' partials."""
    path: str                 # GEMV, MMA or TILES
    grid: Tuple[int, int]     # (blocks along N, blocks along M or splits)
    mt: int = 0
    cpt: int = 0
    kps: int = 0
    splits: int = 0
    workspace: Optional[Tuple[int, int, int]] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def _plan(m: int, n: int, k: int, dtype: torch.dtype) -> Plan:
    """The path for x (m, k) of `dtype` times wq (k, n): m <= 16 the GEMV,
    split along K so that at least 2 blocks land on each SM; else bf16 the
    tensor-core GEMM, fp32 the fp32 tiles."""
    if m <= GEMV_MAX_M:
        mt = next(v for v in sorted(GEMV_CPT) if v >= m)
        cpt = GEMV_CPT[mt]
        slabs = _cdiv(n, 32 * cpt)
        kps = _cdiv(k, _cdiv(2 * SMS, slabs))
        kps = min(_cdiv(kps, GEMV_WARPS) * GEMV_WARPS,
                  GEMV_SLICE_FLOATS // mt)
        splits = _cdiv(k, kps)
        return Plan(GEMV, (slabs, splits), mt, cpt, kps, splits,
                    (splits, m, n))
    if dtype == torch.bfloat16:
        return Plan(MMA, (_cdiv(n, MMA_TILE_N), _cdiv(m, MMA_TILE_M)))
    return Plan(TILES, (_cdiv(n, FP32_TILE), _cdiv(m, FP32_TILE)))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("int8_matmul")
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    tiles = lib.repro_int8_matmul
    tiles.argtypes = [i32] + [ptr] * 4 + [i32] * 3 + [i64, ptr]
    mma = lib.repro_int8_matmul_mma
    mma.argtypes = [ptr] * 4 + [i32] * 3 + [i64, i32, i32, ptr]
    gemv = lib.repro_int8_gemv
    gemv.argtypes = [i32] + [ptr] * 6 + [i32] * 3 + [i64] + [i32] * 5 + [ptr]
    for fn in (tiles, mma, gemv):
        fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return {TILES: tiles, MMA: mma, GEMV: gemv}, lib.repro_cuda_error_string


def _check(x, wq, scales):
    # each tensor attribute is read once: on the decode path this check is
    # a visible share of the call
    dev, xs, wqs, ss = x.device, x.shape, wq.shape, scales.shape
    if wq.device != dev or scales.device != dev:
        raise ValueError(f"inputs on different devices: {dev}, "
                         f"{wq.device}, {scales.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x; got "
                        f"{x.dtype}")
    if wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8; got {wq.dtype}")
    if not scales.is_floating_point():
        raise TypeError(f"scales must be floating point; got {scales.dtype}")
    if len(xs) != 2 or len(wqs) != 2 or xs[1] != wqs[0]:
        raise ValueError(f"want x (M,K) and wq (K,N); got {tuple(xs)}, "
                         f"{tuple(wqs)}")
    m, k = xs
    n = wqs[1]
    if len(ss) != 1 or ss[0] != n:
        raise ValueError(f"scales must be ({n},); got {tuple(ss)}")
    if min(m, k, n) == 0:
        raise ValueError(f"empty operand: x {tuple(xs)}, wq {tuple(wqs)}")
    if max(m, k, n) >= 2 ** 31 or _plan(m, n, k, x.dtype).grid[1] > 65535:
        raise ValueError(f"shape x {tuple(xs)}, wq {tuple(wqs)} beyond the "
                         "launch grid")


def _workspace(device: torch.device, stream: int, numel: int,
               slabs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """At least `numel` fp32 of partials and `slabs` zeroed int32 counters
    for `stream`, allocated the first time (or when a call needs more)."""
    key = (device.index, stream)
    with _WORKSPACES_LOCK:
        ws, counters = _WORKSPACES.get(key, (None, None))
        if ws is None or ws.numel() < numel:
            ws = torch.empty(numel, dtype=torch.float32, device=device)
        if counters is None or counters.numel() < slabs:
            counters = torch.zeros(slabs, dtype=torch.int32, device=device)
        _WORKSPACES[key] = (ws, counters)
        return ws, counters


def _launch(x, wq, scales):
    m, k = x.shape
    n = wq.shape[1]
    if x.stride(1) != 1:
        x = x.contiguous()
    wq = wq.contiguous()
    scales = scales.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    plan = _plan(m, n, k, x.dtype)
    fns, err_str = _entry()
    w_aligned = wq.data_ptr() % 16 == 0
    # entering the device costs more than a decode-sized GEMV: only switch
    # when x is not on the current one
    dev = x.device
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.path == GEMV:
            splits, _, _ = plan.workspace
            ws, counters = _workspace(dev, stream, splits * m * n,
                                      plan.grid[0])
            err = fns[GEMV](_DTYPES[x.dtype], x.data_ptr(), wq.data_ptr(),
                              scales.data_ptr(), ws.data_ptr(),
                              counters.data_ptr(), out.data_ptr(), m, n, k, x.stride(0), plan.mt,
                              plan.cpt, plan.kps, plan.splits,
                              int(w_aligned and n % plan.cpt == 0), stream)
        elif plan.path == MMA:
            vec_x = (x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
                     and k % 8 == 0)
            err = fns[MMA](x.data_ptr(), wq.data_ptr(), scales.data_ptr(),
                             out.data_ptr(), m, n, k, x.stride(0),
                             int(vec_x), int(w_aligned and n % 16 == 0),
                             stream)
        else:
            err = fns[TILES](_DTYPES[x.dtype], x.data_ptr(),
                                    wq.data_ptr(), scales.data_ptr(),
                                    out.data_ptr(), m, n, k, x.stride(0),
                                    stream)
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed ({plan.path}): "
                           f"{err_str(err).decode()} (cudaError {err})")
    with _LAUNCHES_LOCK:   # device lanes and callers may launch at once
        int8_matmul.launches += 1
    return out


def cost(x, wq) -> KernelCost:
    """One call's work: 2 M K N flop; x, wq and the fp32 scales read once,
    the output written once."""
    m, k = x.shape
    n = wq.shape[1]
    nbytes = (x.numel() * x.element_size() + wq.numel() + 4 * n
              + m * n * x.element_size())
    return KernelCost(2 * m * k * n, nbytes)


def int8_matmul(x, wq, scales):
    """x: (M,K) fp32 or bf16; wq: (K,N) int8; scales: (N,) -> (M,N) in
    x.dtype: ((x.f32 @ wq.f32) * scales.f32).astype(x.dtype). Any M, N, K."""
    _check(x, wq, scales)
    if x.device.type == "cpu":
        return int8_matmul_ref(x, wq, scales)
    if x.device.type == "meta" and trace.active() is not None:
        trace.record_kernel("int8_matmul", cost(x, wq))
        return torch.empty((x.shape[0], wq.shape[1]), dtype=x.dtype,
                           device=x.device)
    return _launch(x, wq, scales)


int8_matmul.launches = 0
