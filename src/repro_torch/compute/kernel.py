"""Kernel tasks: PyTorch callables as device-typed tasks.

`kernel_task` turns a compute function into a `RemoteFunction` whose
resource request defaults to one device unit, so the scheduler places it
only on nodes declaring that capacity and the node's dedicated device
lane executes it. The wrapper:

- calls the function as it is: PyTorch runs eagerly and has no
  counterpart of the reference's `jax.jit`, so ``jit=`` and
  ``static_argnames=`` are accepted for the reference's signature and
  have no effect. The kernels' wrappers in `repro_torch.kernels` run
  their plain versions on CPU tensors themselves, so the same task runs
  in the tests;
- optionally warms at *registration* time (``warmup_args=``): one call
  on the calling thread, synchronised, which builds the CUDA kernels and
  initialises the CUDA libraries at first use, so the first cluster
  dispatch measures dispatch, not set-up;
- waits until the card has actually finished (`torch.cuda.synchronize`
  on every device that holds a CUDA tensor of the result) and logs a
  "kernel" event carrying the milliseconds, which `profiler.summarize`
  folds into ``kernel_tasks`` / ``kernel_time_ms_mean``.

The lane thread starts with PyTorch's thread-local defaults (grad mode
on, the default stream), not its caller's. Thread backend only for the
lane pinning, and for CUDA tensors at all: under the process backend a
CUDA tensor would be pickled into a child and initialise CUDA there.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.api import RemoteFunction
from repro_torch.core.worker import current_node, current_task
from repro_torch.tree import tree_leaves


def _block(out: Any) -> Any:
    """Wait for the card so the measured window covers the kernels, not
    just their launch. No-op for results without CUDA tensors."""
    for dev in {t.device for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def _instrument(fn, kernel_name: str):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        ms = (time.perf_counter() - t0) * 1e3
        node = current_node()
        spec = current_task()
        if node is not None and spec is not None:
            node.gcs.log_event("kernel", spec.task_id,
                               f"node{node.node_id}", ms=ms,
                               kernel=kernel_name)
        return out
    return run


class KernelFunction(RemoteFunction):
    """A `RemoteFunction` whose payload runs device kernels.

    `warm(*args)` runs the function once on the calling thread and waits
    for the card: the kernels' build and the CUDA libraries are
    per-process, so warming on the driver covers every thread-backend
    worker.
    """

    def __init__(self, fn, *, resources: Optional[Dict[str, float]] = None,
                 num_returns: int = 1, jit: bool = True,
                 static_argnames: Optional[Tuple[str, ...]] = None,
                 max_retries: int = -1, retry_exceptions=None,
                 backoff: float = 0.0, deadline: float = 0.0):
        self.kernel_fn = fn   # eager: `jit`/`static_argnames` have no effect
        super().__init__(_instrument(fn, getattr(fn, "__name__",
                                                 repr(fn))),
                         num_returns=num_returns,
                         resources=({"gpu": 1.0} if resources is None
                                    else resources),
                         max_retries=max_retries,
                         retry_exceptions=retry_exceptions,
                         backoff=backoff, deadline=deadline)

    def warm(self, *args, **kwargs) -> "KernelFunction":
        _block(self.kernel_fn(*args, **kwargs))
        return self


def kernel_task(fn=None, *, resources: Optional[Dict[str, float]] = None,
                num_returns: int = 1, jit: bool = True,
                static_argnames: Optional[Tuple[str, ...]] = None,
                warmup_args: Optional[tuple] = None,
                max_retries: int = -1, retry_exceptions=None,
                backoff: float = 0.0,
                deadline: float = 0.0):
    """Decorator/factory: ``@kernel_task`` or
    ``kernel_task(fn, resources={"gpu": 1}, warmup_args=(x, y))``."""
    def wrap(f) -> KernelFunction:
        kf = KernelFunction(f, resources=resources,
                            num_returns=num_returns, jit=jit,
                            static_argnames=static_argnames,
                            max_retries=max_retries,
                            retry_exceptions=retry_exceptions,
                            backoff=backoff, deadline=deadline)
        if warmup_args is not None:
            kf.warm(*warmup_args)
        return kf
    if fn is None:
        return wrap
    return wrap(fn)
