"""Builds the port's CUDA C++ kernels and loads them with ctypes.

Every `<kernel>/csrc/*.cu` under this package is compiled at first use, one
`nvcc` process per source, all started together, each into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I kernels/include \
         -o build/repro_torch_kernels/lib<name>-<hash>.so <src>

The library name carries a hash of the source, the headers beside it, the
headers the kernels share (`include/*.cuh`) and the flags, so an unchanged
tree does not rebuild. ptxas's report of each kernel (registers, shared
memory, spills, and any note that it serialized the kernel's wgmma) is
kept beside its library (`ptxas_report`). Only sources
in the repository are compiled; a failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"   # headers shared by the kernels
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for dep in [src, *sorted(src.parent.glob("*.cuh")),
                *sorted(INCLUDE_DIR.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


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
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(src)]
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
            _report_path(out).write_text(stderr)   # ptxas -v writes stderr
            os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(src) for name, src in srcs.items()}


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
# ptxas's note that it serialized a function's wgmma (C7515, C7520, ...)
_SERIAL = re.compile(r"\((C\d+)\) Potential Performance Loss: "
                     r"wgmma\.mma_async instructions are serialized.*"
                     r"in the function '(\w+)")


def parse_ptxas(text: str) -> List[Dict]:
    """Each entry function in nvcc's `-Xptxas -v` output: {"kernel"
    (mangled name), "registers", "smem_bytes" (static; dynamic shared
    memory is set at launch), "spill_stores", "spill_loads",
    "wgmma_serialized" (the codes of ptxas's notes that it serialized the
    function's wgmma, in order; [] for none)}."""
    kernels: List[Dict] = []
    props = None   # the function whose properties the next line gives
    serialized: Dict[str, List[str]] = {}
    for line in text.splitlines():
        if m := _SERIAL.search(line):
            serialized.setdefault(m.group(2), []).append(m.group(1))
        elif m := _ENTRY.search(line):
            kernels.append({"kernel": m.group(1), "registers": None,
                            "smem_bytes": 0, "spill_stores": None,
                            "spill_loads": None})
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif not kernels:
            continue
        elif m := _STACK.search(line):
            if props == kernels[-1]["kernel"]:
                kernels[-1]["spill_stores"] = int(m.group(2))
                kernels[-1]["spill_loads"] = int(m.group(3))
        else:
            if m := _USED.search(line):
                kernels[-1]["registers"] = int(m.group(1))
            if m := _SMEM.search(line):
                kernels[-1]["smem_bytes"] = int(m.group(1))
    for k in kernels:
        k["wgmma_serialized"] = serialized.get(k["kernel"], [])
    return kernels


def ptxas_report(name: str) -> List[Dict]:
    """ptxas's report of each kernel of source `name` (`parse_ptxas`), as
    kept by the build that made its library; [] if there is none."""
    path = _report_path(library_path(sources()[name]))
    return parse_ptxas(path.read_text()) if path.exists() else []


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
