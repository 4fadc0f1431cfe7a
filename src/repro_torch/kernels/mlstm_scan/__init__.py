from repro_torch.kernels.mlstm_scan.ops import mlstm_scan  # noqa: F401
from repro_torch.kernels.mlstm_scan.ref import (mlstm_chunk, mlstm_ref,  # noqa: F401
                                                mlstm_scan_ref,
                                                mlstm_scan_two_pass_ref)
