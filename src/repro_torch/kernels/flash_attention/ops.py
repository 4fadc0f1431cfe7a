"""Public wrapper of the flash attention kernels.

A CPU tensor goes to the plain version (`ref.attention_ref`, under
autograd where a gradient is wanted). A CUDA tensor launches the Hopper
kernels or raises: there is no fallback on the card. The forward's design
is fixed by dtype and head_dim (`fwd_path`): bf16 at head_dim 64, 128, 192
(MLA's queries and keys) and 256 (gemma3) runs the wgmma + TMA kernel
(`csrc/flash_attention_fwd_sm90.cu`: a producer warp, two consumer
warpgroups, FlashAttention-3's shape); bf16 at 32 runs `mma.sync` and fp32
the CUDA cores (`csrc/flash_attention.cu`, every row start 16-byte aligned
for its `cp.async` copies). A smaller head_dim between these (deepseek's
smoke MLA, 48) is zero-padded on the card to the next one, q scaled to keep
the softmax scale 1/sqrt(head_dim), and the output cropped back
(`_padded`); one above 256 raises. q, k and v share one head_dim: MLA pads
its values to it.
`softcap` > 0 caps the scaled scores, c tanh(s / c), before the mask.
`flash_attention.launches` counts forward launches,
`flash_attention.launches_by_design` the same by `fwd_path`,
`flash_attention.bwd_launches` backward ones.

Where autograd needs a gradient on the card, `_FlashAttention` runs the
forward kernel with its log-sum-exp (lse) and saves (q, k, v, out, lse); its
backward launches the backward kernels, the reference's blockwise backward
(`repro.models.attention._blockwise_bwd`) for the card, in one of two
designs fixed by dtype and head_dim (`bwd_path`): bf16 at head_dim 64 and
128 the single-pass wgmma + TMA kernel (`csrc/flash_attention_bwd_sm90.cu`:
row stats and a zeroed fp32 dQ accumulator, dK/dV/dQ, dQ cast), everything
else the two-kernel design of `csrc/flash_attention_bwd.cu` (delta, dK/dV,
dQ).
Without a gradient the forward writes no lse. The plain versions of the
pair are `ref.attention_ref(..., return_lse=True)` and
`ref.attention_bwd_ref`.

A `meta` tensor under the dry run's cost trace is a third device: the
wrapper runs the card's checks (so the trace refuses what the card would),
returns empty outputs of the kernels' shapes and dtypes, and records each
call with its cost in the active trace (`analysis.trace`): the forward as
"flash_attention" (`cost`), the backward as "flash_attention_bwd"
(`bwd_cost`). It launches nothing and counts no launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.analysis import trace
from repro_torch.kernels import _build
from repro_torch.kernels.cost import KernelCost, valid_pairs
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)
# The designs of `csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`
# by dtype (chip_smoke.py names them); each takes every head dim of
# HEAD_DIMS but where `fwd_path` or `bwd_path` names the wgmma design.
PATHS = {torch.float32: "cuda-core fp32", torch.bfloat16: "mma.sync bf16"}
# The forward's design by dtype and head_dim, fixed (no switch at run time):
# bf16 at these head dims runs the wgmma + TMA kernel
# (`csrc/flash_attention_fwd_sm90.cu`); bf16 at 32 (a 64-byte row, half a
# 128-byte swizzled box) and fp32 (full fp32 products) PATHS' kernels.
FWD_SM90_HEAD_DIMS = (64, 128, 192, 256)
# The backward's design by dtype and head_dim, fixed (no switch at run time):
# bf16 at these head dims runs the wgmma + TMA kernel, one pass for dK, dV
# and dQ (`csrc/flash_attention_bwd_sm90.cu`); the rest PATHS' kernels of
# `csrc/flash_attention_bwd.cu`.
BWD_SM90_HEAD_DIMS = (64, 128)
SM90_PATH = "wgmma+TMA bf16"
# q rows a tile of the wgmma backward: its row stats and dQ accumulator are
# padded to a multiple of it
SM90_BQ = 64
# rows a block for the grid check below: the bf16 kernels' tiles of 64 or
# 128 q rows (and the backward's 64 keys) are their grids' z axis, at most
# 65535, and 64 keeps the check on the safe side (the fp32 kernels' tiles
# are their grids' x axis, unbounded here)
BQ = 64

_LAUNCHES_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = ([i32] + [ptr] * 5 + [i32] * 6 + [i64] * 12
                   + [i32, i32, ctypes.c_float, ptr])
    fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


@functools.lru_cache(maxsize=None)
def _fwd_sm90_entry():
    """The wgmma + TMA forward's C entry point and its last tensor-map
    encoding's CUresult."""
    lib = _build.load("flash_attention_fwd_sm90")
    fn = lib.repro_flash_attention_fwd_sm90
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [ptr] * 5 + [i32] * 6 + [ptr, i32, i32, ctypes.c_float, ptr]
    fn.restype = i32
    cu = lib.repro_flash_attention_fwd_sm90_cu_result
    cu.restype = i32
    return fn, cu


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    """The backward's C entry point (its own source, built with the rest)."""
    fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = ([i32] + [ptr] * 10 + [i32] * 6 + [i64] * 24
                   + [i32, i32, ctypes.c_float, ptr])
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=None)
def _sm90_entry():
    """The wgmma + TMA backward's C entry point and its last tensor-map
    encoding's CUresult."""
    lib = _build.load("flash_attention_bwd_sm90")
    fn = lib.repro_flash_attention_bwd_sm90
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = ([ptr] * 11 + [i32] * 6 + [ptr] * 2
                   + [i32, i32, ctypes.c_float, ptr])
    fn.restype = i32
    cu = lib.repro_flash_attention_bwd_sm90_cu_result
    cu.restype = i32
    return fn, cu


def fwd_path(dtype: torch.dtype, hd: int) -> str:
    """The design that computes the forward at `dtype` and `hd` on the
    card."""
    if dtype == torch.bfloat16 and hd in FWD_SM90_HEAD_DIMS:
        return SM90_PATH
    return PATHS[dtype]


def bwd_path(dtype: torch.dtype, hd: int) -> str:
    """The design that computes the backward at `dtype` and `hd` on the
    card."""
    if dtype == torch.bfloat16 and hd in BWD_SM90_HEAD_DIMS:
        return SM90_PATH
    return PATHS[dtype]


def _row_problem(name: str, x: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot read `x` by its strides, or None: the head_dim
    axis must be contiguous and, for bf16 (cp.async copies 16 bytes from
    each row start), the data pointer and every batch, head and sequence
    stride 16-byte aligned."""
    if x.stride(-1) != 1:
        return (f"{name} needs a contiguous head_dim axis; strides "
                f"{x.stride()}")
    if x.dtype == torch.bfloat16:
        step = 16 // x.element_size()
        strides = [st for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1]
        if x.data_ptr() % 16 or any(st % step for st in strides):
            return (f"{name} breaks the bf16 kernel's 16-byte alignment: "
                    f"data_ptr % 16 = {x.data_ptr() % 16}, strides "
                    f"{x.stride()} (batch, head and sequence strides must "
                    f"be multiples of {step} elements)")
    return None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           softcap: float = 0.0):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,S,hd), k = v (B,Hkv,T,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    _, hkv, t, hdk = k.shape
    if k.shape[0] != b or hdk != hd or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head_dim, H % Hkv == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if s == 0 or t == 0:
        raise ValueError(f"empty sequence: S={s}, T={t}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if not softcap >= 0 or math.isinf(softcap):
        raise ValueError(f"softcap {softcap}: want a finite value >= 0")
    if window > 0 and s >= t + window:
        raise ValueError(f"S={s} >= T+window={t + window}: the last query "
                         "rows would see no key")
    if max(b, h, s, t) >= 2 ** 31 or \
            max(b, h, -(-s // BQ), -(-t // BQ)) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} beyond the launch grid")
    for name, x in (("q", q), ("k", k), ("v", v)):
        problem = _row_problem(name, x)
        if problem:
            raise ValueError(problem)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int, softcap: float = 0.0,
            with_lse: bool = False):
    """One launch of the forward kernel of the design `fwd_path` names, on
    checked inputs: out, or (out, lse) with `with_lse`."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    mask = {"causal": causal, "window": window, "softcap": softcap}
    fn, err_str = _entry()
    path = fwd_path(q.dtype, hd)
    sm90 = path == SM90_PATH
    if sm90:
        q, k, v = (_tma_ready(x) for x in (q, k, v))
        fn, cu_result = _fwd_sm90_entry()
        args = _fwd_sm90_args(q, k, v, out, lse, **mask)
    else:
        args = (_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                b, h, hkv, s, t, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(causal), int(window), float(softcap))
    with torch.cuda.device(q.device):
        err = fn(*args, _stream(q.device))
    if err:
        detail = f", tensor-map CUresult {cu_result()}" if sm90 else ""
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err}"
                           f"{detail})")
    with _LAUNCHES_LOCK:   # device lanes and callers may launch at once
        flash_attention.launches += 1
        flash_attention.launches_by_design[path] += 1
    return (out, lse) if with_lse else out


def _bwd_buffers(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """dq, dk, dv as (B,H|Hkv,S|T,hd) views of (B,S|T,H|Hkv,hd) tensors (the
    layout of the inputs the model hands the kernel), and the backward's
    fp32 scratch: for the wgmma + TMA design (`bwd_path`) the row stats
    (2,B,H,Sp) (lse log2(e), delta) and the dQ accumulator (B,H,Sp,hd), Sp
    = S rounded up to 64; for the others delta (B,H,S)."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    dq = torch.empty((b, s, h, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk, dv = (torch.empty((b, t, hkv, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2) for _ in range(2))
    f32 = {"dtype": torch.float32, "device": q.device}
    if bwd_path(q.dtype, hd) == SM90_PATH:
        sp = -(-s // SM90_BQ) * SM90_BQ
        scratch = (torch.empty((2, b, h, sp), **f32),
                   torch.empty((b, h, sp, hd), **f32))
    else:
        scratch = (torch.empty((b, h, s), **f32),)
    return dq, dk, dv, scratch


def _tma_geometry(x: torch.Tensor) -> tuple:
    """The wgmma kernels' TMA descriptor of a (B,H|Hkv,S|T,hd) bf16 view:
    its dims innermost first (hd, rows, heads, batch) and the byte strides
    of rows, heads and batch. An axis of length 1 is never stepped along,
    so its stride is given as the byte span of the whole tensor (a multiple
    of 16 that the encoder accepts whatever the view's own stride)."""
    b, h, s, hd = x.shape
    sb, sh, ss, _ = x.stride()
    es = x.element_size()
    span = -(-(b * h * s * hd * es) // 16) * 16
    return (hd, s, h, b, ss * es if s > 1 else span,
            sh * es if h > 1 else span, sb * es if b > 1 else span)


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """`x`, or a contiguous copy where an axis longer than 1 has stride 0
    (a broadcast view, which a TMA descriptor cannot describe)."""
    strides = x.stride()
    if 0 in strides and any(st == 0 and n > 1
                            for st, n in zip(strides, x.shape)):
        return x.contiguous()
    return x


def _fwd_sm90_args(q, k, v, out, lse, *, causal: bool, window: int,
                   softcap: float) -> tuple:
    """The wgmma + TMA forward's arguments but the stream: pointers (lse's
    None where it is not written), shapes, and the four TMA geometries (q,
    k, v, out) as an int64 array."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    tma = (ctypes.c_int64 * 28)(*_tma_geometry(q), *_tma_geometry(k),
                                *_tma_geometry(v), *_tma_geometry(out))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, hkv, s, t, hd,
            tma, int(causal), int(window), float(softcap))


def _sm90_args(q, k, v, out, lse, dout, dq, dk, dv, scratch, *, causal: bool,
               window: int, softcap: float) -> tuple:
    """The wgmma + TMA entry point's arguments but the stream: pointers,
    shapes, the four TMA geometries (q, k, v, dout) and the element strides
    of out, dout, dq, dk and dv as int64 arrays."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rows, acc = scratch
    tma = (ctypes.c_int64 * 28)(*_tma_geometry(q), *_tma_geometry(k),
                                *_tma_geometry(v), *_tma_geometry(dout))
    strides = (ctypes.c_int64 * 15)(*out.stride()[:3], *dout.stride()[:3],
                                    *dq.stride()[:3], *dk.stride()[:3],
                                    *dv.stride()[:3])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), rows.data_ptr(), acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, t, hd,
            tma, strides, int(causal), int(window), float(softcap))


def _mma_args(q, k, v, out, lse, dout, dq, dk, dv, delta, *, causal: bool,
              window: int, softcap: float) -> tuple:
    """`csrc/flash_attention_bwd.cu`'s entry point's arguments but the
    stream."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    return (_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, t, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *dout.stride()[:3], *dq.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], int(causal), int(window),
            float(softcap))


def _launch_bwd(q, k, v, out, lse, dout, *, causal: bool, window: int,
                softcap: float = 0.0):
    """The backward kernels (one call of the C entry point of the design
    `bwd_path` names, three launches) on the forward's checked inputs, its
    out and lse: (dq, dk, dv). A `dout` the kernels cannot read by its
    strides is copied first."""
    if _row_problem("dout", dout):
        dout = dout.contiguous()
    mask = {"causal": causal, "window": window, "softcap": softcap}
    dq, dk, dv, scratch = _bwd_buffers(q, k, v)
    _, err_str = _entry()
    sm90 = bwd_path(q.dtype, q.shape[-1]) == SM90_PATH
    if sm90:
        q, k, v, dout = (_tma_ready(x) for x in (q, k, v, dout))
        fn, cu_result = _sm90_entry()
        args = _sm90_args(q, k, v, out, lse, dout, dq, dk, dv, scratch,
                          **mask)
    else:
        fn = _bwd_entry()
        args = _mma_args(q, k, v, out, lse, dout, dq, dk, dv, *scratch,
                         **mask)
    with torch.cuda.device(q.device):
        err = fn(*args, _stream(q.device))
    if err:
        detail = f", tensor-map CUresult {cu_result()}" if sm90 else ""
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"{err_str(err).decode()} (cudaError {err}"
                           f"{detail})")
    with _LAUNCHES_LOCK:
        flash_attention.bwd_launches += 1
    return dq, dk, dv


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: int = 0, v_head_dim: int = 0,
         softcap: float = 0.0) -> KernelCost:
    """One call's useful work: q.k and P.v over the (query, key) pairs the
    mask lets through (2 flop a product each), q, k, v read and the output
    written once; under softcap one tanh a valid score, in `exps`.
    `v_head_dim` > 0 counts only that many of v's columns (MLA's values,
    zero-padded to the head_dim of q and k)."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    v_hd = v_head_dim or v.shape[-1]
    pairs = valid_pairs(s, t, causal, window)
    nbytes = q.element_size() * (q.numel() + k.numel() + b * hkv * t * v_hd
                                 + b * h * s * v_hd)
    return KernelCost(2 * b * h * (hd + v_hd) * pairs, nbytes,
                      b * h * pairs if softcap else 0)


def bwd_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: int = 0, v_head_dim: int = 0,
             softcap: float = 0.0) -> KernelCost:
    """One backward call's useful work over the valid pairs: q.k, dO.v,
    P^T dO, dS^T q and dS k, 2 flop a product each, 2 (3 hd + 2 hd_v) a
    pair; q, k, v, out, dout, lse and delta read once, dq, dk, dv written
    once; under softcap one tanh a valid score, in `exps`."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    v_hd = v_head_dim or v.shape[-1]
    pairs = valid_pairs(s, t, causal, window)
    elems = (2 * (b * h * s * hd + b * hkv * t * hd)   # q, k; dq, dk
             + 2 * b * hkv * t * v_hd                  # v, dv
             + 2 * b * h * s * v_hd)                   # out, dout
    nbytes = q.element_size() * elems + 4 * 2 * b * h * s   # lse, delta
    return KernelCost(2 * b * h * (3 * hd + 2 * v_hd) * pairs, nbytes,
                      b * h * pairs if softcap else 0)


def _traced(t: torch.Tensor) -> bool:
    """A `meta` tensor under the dry run's trace: the third device. Outside
    a trace a meta tensor is one more tensor off the CPU (the tests stand
    it in for the card) and goes to the launch."""
    return t.device.type == "meta" and trace.active() is not None


def _meta_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int, softcap: float = 0.0,
                 with_lse: bool = False):
    """The forward's outputs on `meta`, its call recorded in the trace."""
    b, h, s, hd = q.shape
    trace.record_kernel("flash_attention", cost(
        q, k, v, causal=causal, window=window, softcap=softcap))
    out = torch.empty((b, s, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if not with_lse:
        return out
    return out, torch.empty((b, h, s), dtype=torch.float32, device=q.device)


def _meta_launch_bwd(q, k, v, out, lse, dout, *, causal: bool, window: int,
                     softcap: float = 0.0):
    """The backward's gradients on `meta` (and its scratch, as the card
    allocates it), its call recorded in the trace."""
    trace.record_kernel("flash_attention_bwd", bwd_cost(
        q, k, v, causal=causal, window=window, softcap=softcap))
    dq, dk, dv, _ = _bwd_buffers(q, k, v)   # the scratch too, as the card
    return dq, dk, dv


def _card_fwd(q, k, v, **mask):
    return _launch(q, k, v, with_lse=True, **mask)


def _meta_fwd(q, k, v, **mask):
    return _meta_launch(q, k, v, with_lse=True, **mask)


def plain_fwd(q, k, v, **mask):
    """The plain version of the forward `_FlashAttention` saves from:
    (out, lse)."""
    return attention_ref(q, k, v, return_lse=True, **mask)


class _FlashAttention(torch.autograd.Function):
    """`fwd` (q, k, v -> out, lse) forward and `bwd` (q, k, v, out, lse,
    dout -> dq, dk, dv) backward: the kernels on the card, their `meta`
    stand-ins under the trace, or their plain versions (`plain_fwd`,
    `ref.attention_bwd_ref`), under one mask (causal, window, softcap)."""

    @staticmethod
    def forward(ctx, fwd, bwd, causal, window, softcap, q, k, v):
        out, lse = fwd(q, k, v, causal=causal, window=window,
                       softcap=softcap)
        ctx.bwd = bwd
        ctx.mask = {"causal": causal, "window": window, "softcap": softcap}
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = ctx.bwd(*ctx.saved_tensors, dout, **ctx.mask)
        return (None,) * 5 + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[5:]))


def _padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int, softcap: float = 0.0) -> torch.Tensor:
    """`flash_attention` at a head_dim between the kernel's: q, k and v
    zero-padded to the next of HEAD_DIMS, q scaled by sqrt(padded /
    head_dim) so that the kernel's 1/sqrt(padded) makes 1/sqrt(head_dim)
    (the scaled score, and so its softcap, unchanged); the padded columns
    add 0 to q.k and give 0 columns of the output, which are cropped.
    Exact but for the scaling's rounding of q."""
    hd = q.shape[-1]
    wide = next(d for d in HEAD_DIMS if d > hd)
    q = F.pad(q * math.sqrt(wide / hd), (0, wide - hd))
    k, v = (F.pad(t, (0, wide - hd)) for t in (k, v))
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)[..., :hd]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B,H,S,hd); k,v: (B,Hkv,T,hd) -> (B,H,S,hd) in q.dtype.

    Inputs are read by strides, so (B,S,H,hd) activations can be passed as
    `.transpose(1, 2)` views without a copy. On the card the output is a
    (B,H,S,hd) view of a (B,S,H,hd)-contiguous tensor, so
    `out.transpose(1, 2)` is contiguous again, and so are the gradients.
    Differentiable in q, k and v."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    hd = q.shape[-1]
    if hd not in HEAD_DIMS and hd < HEAD_DIMS[-1] and q.dim() == 4 \
            and k.shape[-1] == v.shape[-1] == hd:
        return _padded(q, k, v, causal=causal, window=window,
                       softcap=softcap)
    _check(q, k, v, window, softcap)
    traced = _traced(q)
    mask = {"causal": causal, "window": window, "softcap": softcap}
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if traced:
            return _FlashAttention.apply(_meta_fwd, _meta_launch_bwd,
                                         causal, window, softcap, q, k, v)
        return _FlashAttention.apply(_card_fwd, _launch_bwd, causal, window,
                                     softcap, q, k, v)
    return (_meta_launch if traced else _launch)(q, k, v, **mask)


flash_attention.launches = 0
flash_attention.launches_by_design = dict.fromkeys(
    (SM90_PATH, *PATHS.values()), 0)
flash_attention.bwd_launches = 0
