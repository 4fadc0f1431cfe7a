"""Meshes of the port's launchers, and the card's constants for a roofline.
The port of `repro.launch.mesh`.

A mesh here is axis names and sizes, no devices. The reference's
production meshes (a pod of 16 x 16 chips, and two pods with a `pod` axis
outside) are plans of the same shape, which `launch.dryrun` traces the
port's programs under without starting anything of `torch.distributed`.
A mesh whose size is the process group's world size executes: the
launcher lays the ranks out on it (`parallel.collectives.Comm`, rank
numbers row-major over its axes). The host mesh is the reference's "mesh
over whatever devices exist": (world // model, model) over the ranks of
the process group, (1, 1) without one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Mesh:
    """A plain description of the devices a program is planned for: the
    sizes of its axes in order (`devices`) and by name (`shape`, as a
    `jax.sharding.Mesh` gives them)."""
    devices: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices))

    @property
    def size(self) -> int:
        return math.prod(self.devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production plan: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def world_size() -> int:
    """The ranks of the process group; 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_host_mesh(model: int = 1) -> Mesh:
    """(world // model, model) over ("data", "model"): every rank of the
    process group, or this one process without one."""
    n = world_size()
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide a world "
                         f"of {n} rank{'s' if n > 1 else ''}")
    return Mesh((n // model, model), ("data", "model"))


# NVIDIA H100 SXM constants for the roofline (per card), under the
# reference's names for TPU v5e's; chip_smoke.py's bounds and the dry run
# read them
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, H100 SXM bf16 dense tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, H100 SXM fp32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, H100 SXM HBM3
HBM_BYTES = 80 * 2**30        # bytes of HBM3 on an H100 80GB card
ICI_BW = 25e9                 # bytes/s a direction per NVLink 4 link (18 a card)
DCN_BW = 50e9                 # bytes/s, one 400 Gb/s NDR InfiniBand port a card
# An HGX H100 node joins 8 cards all to all through NVSwitch; a group of
# more cards than this (the reference's 16-wide `model` axis) leaves the
# node over InfiniBand.
NVLINK_DOMAIN = 8
