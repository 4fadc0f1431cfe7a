"""Where the port runs: the card by default, the CPU only when asked."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means `cuda`. Asking for `cuda`, explicitly or by default,
    on a host without a usable card raises `RuntimeError`: the port never
    drops to the CPU on its own. The CPU is used only when the caller
    passes `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port's plain CPU path")
    return dev
