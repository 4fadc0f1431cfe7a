"""Builds the port's CUDA C++ kernels and loads them with ctypes.

Every `<kernel>/csrc/*.cu` under this package is compiled at first use, one
`nvcc` process per source, all started together, each into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch_kernels/lib<name>-<hash>.so <src>

The library name carries a hash of the source, the headers beside it and
the flags, so an unchanged tree does not rebuild. Only sources in the
repository are compiled; a failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
# A device lane and the threads beside it may reach a kernel's first launch
# at once: one build, one load.
_lock = threading.Lock()


def sources() -> Dict[str, Path]:
    """Kernel name (the source's stem) -> its `.cu` file."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(f"nvcc not found on PATH or in {cuda_home}/bin; "
                           "the kernels are built where the card is")
    return nvcc


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; all nvcc processes
    run at once. Returns kernel name -> library path."""
    srcs = sources()
    pending = {}
    for name, src in srcs.items():
        out = library_path(src)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        pending[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp, out)
    errors = []
    for name, (proc, tmp, out) in pending.items():
        _, stderr = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed on {srcs[name]} "
                          f"(exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(src) for name, src in srcs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        if name not in _loaded:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no CUDA source for kernel {name!r}; "
                               f"have {sorted(paths)}")
            _loaded[name] = ctypes.CDLL(str(paths[name]))
        return _loaded[name]
