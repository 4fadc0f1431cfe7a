"""Public wrapper of the chunkwise mLSTM kernel.

A CPU tensor goes to the plain version (`ref.mlstm_scan_ref`). A CUDA tensor
launches the Hopper kernels (`csrc/mlstm_scan.cu`) or raises: there is no
fallback on the card. bf16 runs on the tensor cores in two launches (the
recurrence over chunks, then every chunk's output; every row start of q, k
and v 16-byte aligned for their `cp.async` copies), fp32 on the CUDA cores
in one. `mlstm_scan.launches` counts calls that launched, one a call.

The gradient. The reference has no backward Pallas kernel: JAX
differentiates the jnp chunkwise form (`jax.grad` through `_mlstm_chunk`).
The port does the same on the card: `_MLSTMScan`'s forward launches the
kernel and saves its inputs; its backward recomputes the chunkwise form
(`ref.mlstm_scan_ref`) under autograd and takes `torch.autograd.grad`. A
backward kernel is later work.

A `meta` tensor under the dry run's cost trace is a third device: the card's
checks, empty outputs of the kernel's shapes and dtypes, and one call with
its `cost` recorded in the active trace (`analysis.trace`); no launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.analysis import trace
from repro_torch.kernels import _build
from repro_torch.kernels.cost import KernelCost
from repro_torch.kernels.mlstm_scan.ref import State, mlstm_scan_ref

HEAD_DIMS = (32, 64, 256, 384)
# The path each dtype takes on the card (chip_smoke.py names them).
PATHS = {torch.float32: "cuda-core fp32, chunkwise",
         torch.bfloat16: "mma.sync bf16, two-pass chunkwise"}
# rows a chunk of the bf16 kernels
CHUNK = 64

_LAUNCHES_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("mlstm_scan")
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fp32 = lib.repro_mlstm_scan_fwd
    fp32.argtypes = [i32] + [ptr] * 12 + [i32] * 4 + [i64] * 18 + [ptr]
    fp32.restype = i32
    bf16 = lib.repro_mlstm_scan_fwd_bf16
    bf16.argtypes = [ptr] * 15 + [i32] * 4 + [i64] * 18 + [ptr]
    bf16.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return {torch.float32: fp32, torch.bfloat16: bf16}, \
        lib.repro_cuda_error_string


def _check(q, k, v, log_i, log_f, state: Optional[State]):
    tensors = [q, k, v, log_i, log_f, *(state or ())]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in PATHS or not (q.dtype == k.dtype == v.dtype):
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
    if s >= 2 ** 31 or max(b, h, b * h) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} beyond the launch grid")
    if q.dtype == torch.bfloat16:
        # cp.async copies 16 bytes from each row start
        for name, x in (("q", q), ("k", k), ("v", v)):
            strides = [st for st, n in zip(x.stride()[:3], x.shape[:3])
                       if n > 1]
            if x.data_ptr() % 16 or any(st % 8 for st in strides):
                raise ValueError(f"bf16 {name} needs 16-byte aligned row "
                                 f"starts; data_ptr {x.data_ptr()}, "
                                 f"strides {x.stride()}")


def _launch(q, k, v, log_i, log_f, state: Optional[State], bc: int):
    """One call: the bf16 kernels (chunks of CHUNK rows) or the fp32 kernel
    (chunks of 32 rows). `bc` is the plain version's chunk; the chunk does
    not change the math (the tests hold chunk invariance)."""
    b, h, s, hd = q.shape
    dev = q.device
    y = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    c1 = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    n1 = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    m1 = torch.empty((b, h), dtype=torch.float32, device=dev)
    if state is None:
        ptrs = (None, None, None)
    else:
        c0, n0, m0 = (t.contiguous() for t in state)
        ptrs = (c0.data_ptr(), n0.data_ptr(), m0.data_ptr())
    outs = (y.data_ptr(), c1.data_ptr(), n1.data_ptr(), m1.data_ptr())
    dims = (b, h, s, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *log_i.stride(), *log_f.stride(), *y.stride()[:3])
    fns, err_str = _entry()
    # the device guard costs host time a call: switch only when needed
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream().cuda_stream
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
               log_f.data_ptr(), *ptrs)
        if q.dtype == torch.bfloat16:
            # the state at each chunk's start, written by the first launch
            # and read by the second
            nc = -(-s // CHUNK)
            cst = torch.empty((b * h, nc, hd, hd), dtype=torch.bfloat16,
                              device=dev)
            nst = torch.empty((b * h, nc, hd), dtype=torch.float32,
                              device=dev)
            mst = torch.empty((b * h, nc), dtype=torch.float32, device=dev)
            err = fns[q.dtype](*ins, *outs, cst.data_ptr(), nst.data_ptr(),
                               mst.data_ptr(), *dims, stream)
        else:
            err = fns[q.dtype](0, *ins, *outs, *dims, stream)
    if err:
        raise RuntimeError(f"mlstm_scan kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    with _LAUNCHES_LOCK:   # device lanes and callers may launch at once
        mlstm_scan.launches += 1
    return y, (c1, n1, m1)


def cost(q: torch.Tensor, state: Optional[State] = None) -> KernelCost:
    """One call's useful work, by the chunk of the bf16 kernels (CHUNK
    rows): per (b, h) the in-chunk causal scores and their weighted sum (2
    flop a product each over hd), plus q.C and the C update at 2 S hd^2
    each. The kernels do more than this (every v-tile block recomputes its
    chunk's scores, the scores' upper triangle is computed and masked, the
    C update runs three bf16 parts), which is why it is the useful work.
    Bytes: q, k, v and y, the gates, the state out and, if given, the
    state in, each once."""
    b, h, s, hd = q.shape
    pairs = sum(n * (n + 1) // 2 for n in
                [CHUNK] * (s // CHUNK) + ([s % CHUNK] if s % CHUNK else []))
    flops = b * h * (4 * hd * pairs + 4 * s * hd * hd)
    state_bytes = 4 * b * h * (hd * hd + hd + 1)
    nbytes = (4 * q.numel() * q.element_size() + 2 * 4 * b * h * s
              + state_bytes * (2 if state is not None else 1))
    return KernelCost(flops, nbytes)


def _traced(t: torch.Tensor) -> bool:
    """A `meta` tensor under the dry run's trace: the third device. Outside
    a trace a meta tensor is one more tensor off the CPU (the tests stand
    it in for the card) and goes to the launch."""
    return t.device.type == "meta" and trace.active() is not None


def _meta_launch(q, k, v, log_i, log_f, state: Optional[State], bc: int):
    """The kernels' outputs on `meta`, the call recorded in the trace."""
    b, h, s, hd = q.shape
    trace.record_kernel("mlstm_scan", cost(q, state))
    dev, f32 = q.device, torch.float32
    y = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    return y, (torch.empty((b, h, hd, hd), dtype=f32, device=dev),
               torch.empty((b, h, hd), dtype=f32, device=dev),
               torch.empty((b, h), dtype=f32, device=dev))


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
    launch = _meta_launch if _traced(q) else _launch
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return launch(q, k, v, log_i, log_f, state, bc)
    y, c1, n1, m1 = _MLSTMScan.apply(launch, bc, q, k, v, log_i, log_f,
                                     *(state or (None, None, None)))
    return y, (c1, n1, m1)


mlstm_scan.launches = 0
