"""Public wrapper of the flash attention kernel.

A CPU tensor goes to the plain version (`ref.attention_ref`). A CUDA tensor
launches the Hopper kernel (`csrc/flash_attention.cu`) or raises: there is
no fallback on the card. bf16 runs on the tensor cores (`mma.sync`, every
row start 16-byte aligned for its `cp.async` copies), fp32 on the CUDA
cores, each at head_dim 32, 64, 128, 192 (MLA's queries and keys) and 256
(gemma3). A smaller head_dim between these (deepseek's smoke MLA, 48) is
zero-padded on the card to the next one, q scaled to keep the softmax
scale 1/sqrt(head_dim), and the output cropped back (`_padded`); one above
256 raises. q, k and v share one head_dim: MLA pads its values to it.
`flash_attention.launches` counts kernel launches.

A `meta` tensor under the dry run's cost trace is a third device: the
wrapper runs the card's checks (so the trace refuses what the card would),
returns an empty output of the kernel's shape and dtype, and records one
call with its `cost` in the active trace (`analysis.trace`). It launches
nothing and counts no launch.

The kernel is a forward only, as the Pallas kernel is. Where autograd needs
a gradient on the card, `_FlashAttention` runs the kernel forward and gets
dq, dk, dv by recomputing `attention_ref` under autograd in its backward.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.analysis import trace
from repro_torch.kernels import _build
from repro_torch.kernels.cost import KernelCost, valid_pairs
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)
# The paths each dtype takes on the card (chip_smoke.py names them); each
# takes every head dim of HEAD_DIMS.
PATHS = {torch.float32: "cuda-core fp32", torch.bfloat16: "mma.sync bf16"}
# q rows a block for the grid check below: the bf16 kernel's q-tiles of 128
# rows are its grid's z axis, at most 65535, and 64 keeps the check on the
# safe side (the fp32 kernel's tiles, 64 rows or 32 above hd 128, are its
# grid's x axis, unbounded here)
BQ = 64

_LAUNCHES_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = ([i32, ptr, ptr, ptr, ptr] + [i32] * 6 + [i64] * 12
                   + [i32, i32, ptr])
    fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int):
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
    if window > 0 and s >= t + window:
        raise ValueError(f"S={s} >= T+window={t + window}: the last query "
                         "rows would see no key")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous head_dim axis; "
                             f"strides {x.stride()}")
    if max(b, h, s, t) >= 2 ** 31 or max(b, h, -(-s // BQ)) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} beyond the launch grid")
    if q.dtype == torch.bfloat16:
        # cp.async copies 16 bytes from each row start
        for name, x in (("q", q), ("k", k), ("v", v)):
            step = 16 // x.element_size()
            strides = [st for st, n in zip(x.stride()[:3], x.shape[:3])
                       if n > 1]
            if x.data_ptr() % 16 or any(st % step for st in strides):
                raise ValueError(
                    f"{name} breaks the bf16 kernel's 16-byte alignment: "
                    f"data_ptr % 16 = {x.data_ptr() % 16}, strides "
                    f"{x.stride()} (batch, head and sequence strides must "
                    f"be multiples of {step} elements)")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """One launch of the Hopper kernel on checked inputs."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    fn, err_str = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, h, hkv, s, t, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], int(causal), int(window), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    with _LAUNCHES_LOCK:   # device lanes and callers may launch at once
        flash_attention.launches += 1
    return out


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: int = 0,
         v_head_dim: int = 0) -> KernelCost:
    """One call's useful work: q.k and P.v over the (query, key) pairs the
    mask lets through (2 flop a product each), q, k, v read and the output
    written once. `v_head_dim` > 0 counts only that many of v's columns
    (MLA's values, zero-padded to the head_dim of q and k)."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    v_hd = v_head_dim or v.shape[-1]
    pairs = valid_pairs(s, t, causal, window)
    nbytes = q.element_size() * (q.numel() + k.numel() + b * hkv * t * v_hd
                                 + b * h * s * v_hd)
    return KernelCost(2 * b * h * (hd + v_hd) * pairs, nbytes)


def _traced(t: torch.Tensor) -> bool:
    """A `meta` tensor under the dry run's trace: the third device. Outside
    a trace a meta tensor is one more tensor off the CPU (the tests stand
    it in for the card) and goes to the launch."""
    return t.device.type == "meta" and trace.active() is not None


def _meta_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int) -> torch.Tensor:
    """The kernel's output on `meta`, its call recorded in the trace."""
    b, h, s, hd = q.shape
    trace.record_kernel("flash_attention",
                        cost(q, k, v, causal=causal, window=window))
    return torch.empty((b, s, h, hd), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Forward by `forward_fn` (the kernel launch on the card); backward by
    recomputing `attention_ref` under autograd, as the reference
    differentiates a jnp form and not its Pallas kernel."""

    @staticmethod
    def forward(ctx, forward_fn, causal, window, q, k, v):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        return forward_fn(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        needs = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = attention_ref(*inputs, causal=ctx.causal,
                                window=ctx.window)
        grads = iter(torch.autograd.grad(out, wanted, dout))
        return (None, None, None,
                *(next(grads) if t.requires_grad else None for t in inputs))


def _padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """`flash_attention` at a head_dim between the kernel's: q, k and v
    zero-padded to the next of HEAD_DIMS, q scaled by sqrt(padded /
    head_dim) so that the kernel's 1/sqrt(padded) makes 1/sqrt(head_dim);
    the padded columns add 0 to q.k and give 0 columns of the output, which
    are cropped. Exact but for the scaling's rounding of q."""
    hd = q.shape[-1]
    wide = next(d for d in HEAD_DIMS if d > hd)
    q = F.pad(q * math.sqrt(wide / hd), (0, wide - hd))
    k, v = (F.pad(t, (0, wide - hd)) for t in (k, v))
    return flash_attention(q, k, v, causal=causal, window=window)[..., :hd]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,S,hd); k,v: (B,Hkv,T,hd) -> (B,H,S,hd) in q.dtype.

    Inputs are read by strides, so (B,S,H,hd) activations can be passed as
    `.transpose(1, 2)` views without a copy. On the card the output is a
    (B,H,S,hd) view of a (B,S,H,hd)-contiguous tensor, so
    `out.transpose(1, 2)` is contiguous again. Differentiable in q, k and
    v."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    hd = q.shape[-1]
    if hd not in HEAD_DIMS and hd < HEAD_DIMS[-1] and q.dim() == 4 \
            and k.shape[-1] == v.shape[-1] == hd:
        return _padded(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    launch = _meta_launch if _traced(q) else _launch
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(launch, causal, window, q, k, v)
    return launch(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
