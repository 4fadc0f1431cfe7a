"""repro_torch: the PyTorch/CUDA port of `repro`, for one NVIDIA H100.

The JAX package `repro` is the reference this package is held against; this
package imports `torch`, never `jax`, and nothing of `repro`. It keeps the
reference's module names and public function names (`repro_torch.models.
model.Model.prefill` is the counterpart of `repro.models.model.Model.
prefill`), with PyTorch idiom inside: functions on tensors, an explicit
`device` and an explicit `torch.Generator`.

Entry points run on the card unless the caller passes `device="cpu"`
(`repro_torch.device.resolve_device`). Every Pallas kernel of the reference
becomes a kernel written by hand for Hopper under `repro_torch.kernels`; on
a CPU tensor its wrapper runs the kernel's plain PyTorch version instead.
"""

__version__ = "0.1.0"
