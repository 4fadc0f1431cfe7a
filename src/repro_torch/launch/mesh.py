"""Meshes of the port's launchers, and the card's constants for a roofline.
The port of `repro.launch.mesh`.

The reference builds a `jax` mesh over a TPU slice (16x16 chips a pod, a
`pod` axis over DCN for two pods). The port runs on one card: the host
mesh is world size 1 over the axes ("data", "model"), and nothing of
`torch.distributed` is started. A mesh over many cards is ROADMAP A18.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Mesh:
    """A plain description of the devices a launcher runs on."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    raise NotImplementedError(
        f"the {'multi' if multi_pod else 'single'}-pod production mesh spans "
        "many devices; the port runs on one card (ROADMAP A18)")


def make_host_mesh(model: int = 1) -> Mesh:
    """The one device this process drives: world size 1."""
    if model != 1:
        raise ValueError(f"a model axis of {model} needs {model} devices; "
                         "the host mesh has one (ROADMAP A18)")
    return Mesh((1, 1), ("data", "model"))


# NVIDIA H100 SXM constants for the roofline (per card), under the
# reference's names for TPU v5e's; chip_smoke.py's bounds read them
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, H100 SXM bf16 dense tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, H100 SXM fp32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, H100 SXM HBM3
ICI_BW = 25e9                 # bytes/s a direction per NVLink 4 link (18 a card)
DCN_BW = 50e9                 # bytes/s, one 400 Gb/s NDR InfiniBand port a card
