"""Architecture registry of the port: the reference's ten arches, in its
order, each from the port's own copy of its config."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, gemma3_12b, internvl2_2b,
                                  jamba_1_5_large_398b, mistral_large_123b,
                                  mixtral_8x22b, phi3_medium_14b,
                                  seamless_m4t_medium, stablelm_1_6b,
                                  xlstm_125m)
from repro_torch.configs.base import ModelConfig, shapes_for

_MODULES = {
    "xlstm-125m": xlstm_125m,
    "phi3-medium-14b": phi3_medium_14b,
    "mistral-large-123b": mistral_large_123b,
    "gemma3-12b": gemma3_12b,
    "stablelm-1.6b": stablelm_1_6b,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "internvl2-2b": internvl2_2b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def all_cells():
    """Yield every (arch, shape) cell (34 in all; long_500k only for
    sub-quadratic archs), in the reference's order."""
    for arch in ARCH_IDS:
        for shape in shapes_for(get_config(arch)):
            yield arch, shape
