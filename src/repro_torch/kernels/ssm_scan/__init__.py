from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: F401
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: F401
