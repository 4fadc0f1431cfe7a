"""Public wrapper of the Mamba selective-scan kernel.

A CPU tensor goes to the plain version (`ref.ssm_scan_ref`). A CUDA tensor
launches the Hopper kernel (`csrc/ssm_scan.cu`) or raises: there is no
fallback on the card. `ssm_scan.launches` counts kernel launches.

On the card a call that needs a gradient goes through `_SSMScan`: the
kernel launch is its forward, and its backward recomputes the plain version
under autograd (a backward kernel is ROADMAP B4-bwd). A call that needs no
gradient (serving, decode) launches bare.

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
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (8, 16)

_LAUNCHES_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("ssm_scan")
    fn = lib.repro_ssm_scan_fwd
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [i32] * 3 + [ptr] * 9 + [i32] * 3 + [i64] * 10 + [ptr]
    fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(x, dt, b_t, c_t, a, d, h0: Optional[torch.Tensor]):
    tensors = [x, dt, b_t, c_t, a, d] + ([h0] if h0 is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan takes float32 or bfloat16 x; got {x.dtype}")
    if dt.dtype not in _DTYPES or not (dt.dtype == b_t.dtype == c_t.dtype):
        raise TypeError(f"ssm_scan takes float32 or bfloat16 dt, B, C of one "
                        f"dtype; got {dt.dtype}, {b_t.dtype}, {c_t.dtype}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"want x = dt (B,S,di); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}")
    bsz, s, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"A must be (di, ds) with di = {di}; got "
                         f"{tuple(a.shape)}")
    ds = a.shape[1]
    for name, t, shape in (("B", b_t, (bsz, s, ds)), ("C", c_t, (bsz, s, ds)),
                           ("A", a, (di, ds)), ("D", d, (di,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    for name, t in (("A", a), ("D", d)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (bsz, di, ds)):
        raise ValueError(f"h0 must be float32 {(bsz, di, ds)}; got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if ds not in STATE_DIMS:
        raise ValueError(f"d_state {ds} not in the kernel's {STATE_DIMS}")
    if s == 0:
        raise ValueError("empty sequence")
    for name, t in (("x", x), ("dt", dt), ("B", b_t), ("C", c_t)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis; strides "
                             f"{t.stride()}")
    if max(s, di) >= 2 ** 31 or bsz > 65535:
        raise ValueError(f"shape {tuple(x.shape)} beyond the launch grid")
    # the kernel reads each lane's states of A and h0 as 16-byte vectors
    for name, t in (("A", a), ("h0", h0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} needs a 16-byte aligned start; "
                             f"data_ptr {t.data_ptr()}")


def _launch(x, dt, b_t, c_t, a, d, h0: Optional[torch.Tensor]):
    bsz, s, di = x.shape
    ds = a.shape[1]
    dev = x.device
    y = torch.empty((bsz, s, di), dtype=x.dtype, device=dev)
    h1 = torch.empty((bsz, di, ds), dtype=torch.float32, device=dev)
    a, d = a.contiguous(), d.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    fn, err_str = _entry()
    # the device guard costs host time a call: switch only when needed
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[x.dtype], _DTYPES[dt.dtype], ds,
                 x.data_ptr(), dt.data_ptr(), b_t.data_ptr(), c_t.data_ptr(),
                 a.data_ptr(), d.data_ptr(),
                 None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h1.data_ptr(), bsz, s, di,
                 *x.stride()[:2], *dt.stride()[:2], *b_t.stride()[:2],
                 *c_t.stride()[:2], *y.stride()[:2], stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    with _LAUNCHES_LOCK:   # device lanes and callers may launch at once
        ssm_scan.launches += 1
    return y, h1


def cost(x, dt, b_t, c_t, a, d, h0: Optional[torch.Tensor] = None
         ) -> KernelCost:
    """One call's work: per state update dt*A, dt*B*x (2), the fma into h
    (2) and the fma of C.h (2); per channel and step D*x and its add; one
    exp an update (on the special function units). Bytes: every input and
    y once, the state out and, if given, the state in."""
    bsz, s, di = x.shape
    ds = a.shape[1]
    updates = bsz * s * di * ds
    state_bytes = 4 * bsz * di * ds * (2 if h0 is not None else 1)
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (x, dt, b_t, c_t, a, d))
              + x.numel() * x.element_size() + state_bytes)
    return KernelCost(6 * updates + 2 * bsz * s * di, nbytes, updates)


def _traced(t: torch.Tensor) -> bool:
    """A `meta` tensor under the dry run's trace: the third device. Outside
    a trace a meta tensor is one more tensor off the CPU (the tests stand
    it in for the card) and goes to the launch."""
    return t.device.type == "meta" and trace.active() is not None


def _meta_launch(x, dt, b_t, c_t, a, d, h0: Optional[torch.Tensor]):
    """The kernel's outputs on `meta`, the call recorded in the trace."""
    bsz, s, di = x.shape
    trace.record_kernel("ssm_scan", cost(x, dt, b_t, c_t, a, d, h0))
    return (torch.empty((bsz, s, di), dtype=x.dtype, device=x.device),
            torch.empty((bsz, di, a.shape[1]), dtype=torch.float32,
                        device=x.device))


class _SSMScan(torch.autograd.Function):
    """Forward by `forward_fn` (the kernel launch on the card); backward by
    recomputing `ssm_scan_ref` under autograd, for every input that needs a
    gradient. h_last takes a cotangent where one is given (training gives
    none)."""

    @staticmethod
    def forward(ctx, forward_fn, x, dt, b_t, c_t, a, d, h0):
        y, h1 = forward_fn(x, dt, b_t, c_t, a, d, h0)
        ctx.save_for_backward(x, dt, b_t, c_t, a, d, h0)
        ctx.set_materialize_grads(False)
        return y, h1

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, needs)]
        with torch.enable_grad():
            y, h1 = ssm_scan_ref(*inputs)
        pairs = [(o, g) for o, g in ((y, dy), (h1, dh)) if g is not None]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
        return (None, *(next(grads) if t is not None and t.requires_grad
                         else None for t in inputs))


def ssm_scan(x, dt, b_t, c_t, a, d, h0: Optional[torch.Tensor] = None):
    """x, dt: (B,S,di); b_t, c_t: (B,S,ds); a: (di,ds) fp32; d: (di,) fp32;
    h0: (B,di,ds) fp32 or None (zeros). x fp32 or bf16; dt, B, C fp32 or
    bf16, one type for the three. Returns (y (B,S,di) in x.dtype, h_last
    (B,di,ds) fp32). Differentiable in every tensor input.

    x, dt, B and C are read by strides, so column slices of a wider
    activation (the B and C of `x_proj`'s output) need no copy."""
    tensors = [x, dt, b_t, c_t, a, d] + ([h0] if h0 is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return ssm_scan_ref(x, dt, b_t, c_t, a, d, h0)
    _check(x, dt, b_t, c_t, a, d, h0)
    launch = _meta_launch if _traced(x) else _launch
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return launch(x, dt, b_t, c_t, a, d, h0)
    return _SSMScan.apply(launch, x, dt, b_t, c_t, a, d, h0)


ssm_scan.launches = 0
