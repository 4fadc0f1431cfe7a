"""Device-typed compute plane (the paper's R5), the port of
`repro.compute`: PyTorch callables, the Hopper kernels' wrappers among
them, as first-class heterogeneous tasks over sharded parameters.

Three pieces on top of the port's runtime (`repro_torch.core`):

- device placement (`repro_torch.core.devices`): typed device resource
  keys ("gpu"/"tpu"/"accel") are hard capacity constraints in the
  scheduler, each device-holding node runs kernel tasks on a dedicated
  executor lane, and a request no declared node can ever satisfy seals
  promptly with `UnschedulableTaskError` under an explicit
  `node_resources=` topology;
- kernel tasks (`kernel.py`): `kernel_task` wraps a torch callable into a
  `@remote`-style function that can warm at registration, runs on the
  device lane, waits until the card has finished, and surfaces on-device
  milliseconds as profiler "kernel" events (on CPU tensors the kernels'
  wrappers run their plain versions, so everything runs in the tests);
- sharded parameters (`params.py`): `ParamSet` packs a pytree of tensors
  (or numpy arrays) into contiguous per-shard host buffers living in the
  object store (refcounted, evictable, zero-copy readable), published as
  versioned handles in the control plane so consumers hot-swap weights.
"""
from repro_torch.core.devices import (DEVICE_RESOURCE_KEYS,  # noqa: F401
                                      device_keys, device_subset)
from repro_torch.core.worker import UnschedulableTaskError  # noqa: F401
from repro_torch.compute.kernel import KernelFunction, kernel_task  # noqa: F401
from repro_torch.compute.params import ParamSet  # noqa: F401
from repro_torch.kernels.int8_matmul.ops import int8_matmul  # noqa: F401
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_ref,  # noqa: F401
                                                 quantize_weights)
