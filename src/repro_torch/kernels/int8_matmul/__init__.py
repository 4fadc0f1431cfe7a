from repro_torch.kernels.int8_matmul.ops import int8_matmul  # noqa: F401
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_ref,  # noqa: F401
                                                 quantize_weights)
