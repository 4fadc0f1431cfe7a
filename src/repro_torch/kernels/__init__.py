"""Kernels written by hand for Hopper, one package per Pallas kernel of the
reference: `<name>/ref.py` the plain PyTorch version, `<name>/csrc/*.cu`
the CUDA C++ source, `<name>/ops.py` the wrapper. `_build` compiles the
sources with nvcc at first use."""
