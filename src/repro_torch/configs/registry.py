"""Architecture registry of the port: only the arches that are ported."""
from __future__ import annotations

from repro_torch.configs import (jamba_1_5_large_398b, mixtral_8x22b,
                                  stablelm_1_6b, xlstm_125m)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "stablelm-1.6b": stablelm_1_6b,
    "xlstm-125m": xlstm_125m,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "mixtral-8x22b": mixtral_8x22b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(_MODULES)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
