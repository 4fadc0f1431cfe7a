"""Public wrapper of the chunkwise mLSTM kernel.

A CPU tensor goes to the plain version (`ref.mlstm_scan_ref`). A CUDA tensor
launches the Hopper kernel (`csrc/mlstm_scan.cu`) or raises: there is no
fallback on the card. `mlstm_scan.launches` counts kernel launches.

The gradient. The reference has no backward Pallas kernel: JAX
differentiates the jnp chunkwise form (`jax.grad` through `_mlstm_chunk`).
The port does the same on the card: `_MLSTMScan`'s forward launches the
kernel and saves its inputs; its backward recomputes the chunkwise form
(`ref.mlstm_scan_ref`) under autograd and takes `torch.autograd.grad`. A
backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_scan.ref import State, mlstm_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 256, 384)

_LAUNCHES_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("mlstm_scan")
    fn = lib.repro_mlstm_scan_fwd
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [i32] + [ptr] * 12 + [i32] * 4 + [i64] * 18 + [ptr]
    fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(q, k, v, log_i, log_f, state: Optional[State]):
    tensors = [q, k, v, log_i, log_f, *(state or ())]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mlstm_scan takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q = k = v (B,H,S,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    for name, g in (("log_i", log_i), ("log_f", log_f)):
        if g.dtype != torch.float32 or g.shape != (b, h, s):
            raise ValueError(f"{name} must be float32 (B,H,S) = {(b, h, s)}; "
                             f"got {g.dtype} {tuple(g.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if s == 0:
        raise ValueError("empty sequence")
    if state is not None:
        if len(state) != 3:
            raise ValueError("state is (C, n, m)")
        for name, t, shape in zip(("C", "n", "m"), state,
                                  ((b, h, hd, hd), (b, h, hd), (b, h))):
            if t.dtype != torch.float32 or tuple(t.shape) != shape:
                raise ValueError(f"state {name} must be float32 {shape}; got "
                                 f"{t.dtype} {tuple(t.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous head_dim axis; "
                             f"strides {x.stride()}")
    if s >= 2 ** 31 or max(b, h) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} beyond the launch grid")


def _launch(q, k, v, log_i, log_f, state: Optional[State], bc: int):
    """One kernel launch. The kernel tiles by its own chunk of 32 rows;
    `bc` is the plain version's chunk, and the chunk does not change the
    math (the tests hold chunk invariance)."""
    b, h, s, hd = q.shape
    dev = q.device
    y = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    c1 = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    n1 = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    m1 = torch.empty((b, h), dtype=torch.float32, device=dev)
    if state is None:
        c0 = n0 = m0 = None
        ptrs = (None, None, None)
    else:
        c0, n0, m0 = (t.contiguous() for t in state)
        ptrs = (c0.data_ptr(), n0.data_ptr(), m0.data_ptr())
    fn, err_str = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 log_i.data_ptr(), log_f.data_ptr(), *ptrs,
                 y.data_ptr(), c1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
                 b, h, s, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *log_i.stride(), *log_f.stride(), *y.stride()[:3], stream)
    if err:
        raise RuntimeError(f"mlstm_scan kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    with _LAUNCHES_LOCK:   # device lanes and callers may launch at once
        mlstm_scan.launches += 1
    return y, (c1, n1, m1)


class _MLSTMScan(torch.autograd.Function):
    """Forward by `forward_fn` (the kernel launch on the card); backward by
    recomputing the plain chunkwise form under autograd."""

    @staticmethod
    def forward(ctx, forward_fn, bc, q, k, v, log_i, log_f, c0, n0, m0):
        state = None if c0 is None else (c0, n0, m0)
        y, (c1, n1, m1) = forward_fn(q, k, v, log_i, log_f, state, bc)
        ctx.bc = bc
        ctx.save_for_backward(q, k, v, log_i, log_f, *(state or ()))
        ctx.set_materialize_grads(False)
        return y, c1, n1, m1

    @staticmethod
    def backward(ctx, dy, dc, dn, dm):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:2 + len(saved)]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, needs)]
        with torch.enable_grad():
            y, (c1, n1, m1) = mlstm_scan_ref(
                *inputs[:5], tuple(inputs[5:]) or None, bc=ctx.bc)
        pairs = [(o, g) for o, g in zip((y, c1, n1, m1), (dy, dc, dn, dm))
                 if g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
        out = [next(grads) if t.requires_grad else None for t in inputs]
        return (None, None, *out) + (None,) * (8 - len(out))


def mlstm_scan(q, k, v, log_i, log_f, state: Optional[State] = None, *,
               bc: int = 256):
    """q,k,v: (B,H,S,hd) fp32 or bf16; log_i/log_f: (B,H,S) fp32; state =
    (C (B,H,hd_k,hd_v), n (B,H,hd), m (B,H)) fp32 or None (zeros, m = 0).
    Returns (y (B,H,S,hd) in q.dtype, (C, n, m)).

    Inputs are read by strides, so (B,S,H,hd) and (B,S,H) tensors can be
    passed as `.transpose(1, 2)` views. On the card y is a view of a
    (B,S,H,hd)-contiguous tensor. Differentiable in every tensor input."""
    tensors = (q, k, v, log_i, log_f, *(state or ()))
    if all(t.device.type == "cpu" for t in tensors):
        return mlstm_scan_ref(q, k, v, log_i, log_f, state, bc=bc)
    _check(q, k, v, log_i, log_f, state)
    y, c1, n1, m1 = _MLSTMScan.apply(_launch, bc, q, k, v, log_i, log_f,
                                     *(state or (None, None, None)))
    return y, (c1, n1, m1)


mlstm_scan.launches = 0
