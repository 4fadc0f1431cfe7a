"""Checkpointing with atomic commits and async save: the port of
`repro.checkpoint.checkpointer`, on the same files.

Layout:  <dir>/step_<N>/
           manifest.json        — step, leaf paths, shapes, dtypes
           arrays.npz           — flat {path: array}
         <dir>/step_<N>.tmp/    — staging; os.replace() commits atomically

Leaf paths are the reference's: the keys on the way to the leaf joined by
"/", dict keys in sorted order and tuple or list indices as numbers
(`params/groups/0/mixer/w_q`, `opt/step`). So a checkpoint that the JAX
package wrote restores here, and the reverse.

bf16 leaves cross without `ml_dtypes`: the reference's `np.savez` of a JAX
bf16 array writes its 2-byte values under the descriptor `<V2` (the
manifest says "bfloat16"), and `np.load` gives them back as `|V2`. The port
writes the same bytes under the same descriptor and restores each leaf in
the dtype its manifest names.

The saved arrays are whole host arrays. At world size 1 there is no
sharding to restore under: `restore(..., device=)` places every leaf on one
device, and `restore_into` copies into existing tensors, so a trainer does
not hold its state twice. A sharded run (`Checkpointer(..., comm=)`, every
rank calling `save` with the tree's partition specs) gathers each leaf
from the ranks' blocks in turn to rank 0 (`parallel.sharding.gather_leaf`),
which writes the same files as a run at world size 1; restoring into shards is
not done yet (ROADMAP A18). Async mode snapshots to host in `save` (the
caller may update the tensors in place once it returns) and writes in a
background thread. `timings` records each save's bytes, snapshot and write
seconds and each restore's bytes and seconds.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"
# The descriptor JAX's bf16 arrays are saved under (`ml_dtypes`' dtype.str).
_BF16_DESCR = "<V2"


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _snapshot(leaf) -> Tuple[np.ndarray, str]:
    """A C-ordered host copy of one leaf, as JAX's arrays are, and its
    manifest dtype; bf16 as uint16 bits."""
    t = torch.as_tensor(leaf).detach().to(
        "cpu", memory_format=torch.contiguous_format, copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_npz(path: Path, flat: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """`np.savez`'s file (stored zip of .npy members, zip64), with bf16
    members under the `<V2` descriptor, as the reference's save writes."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype != BF16:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": arr.shape})
                fid.write(memoryview(arr).cast("B"))


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded array as a tensor in the manifest's dtype."""
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _Sharded:
    """A rank's block of a leaf and the leaf's partition spec."""

    def __init__(self, block, spec):
        self.block, self.spec = block, spec


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, comm=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.comm = comm      # a `parallel.collectives.Comm`: a sharded run
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.timings: List[Dict[str, Any]] = []

    # ---------------------------------------------------------------- save

    def save(self, step: int, tree: Any, blocking: bool = True,
             specs: Any = None) -> None:
        """Snapshot `tree` to the host and write it (in a background
        thread unless `blocking`). In a sharded run every rank calls it
        with `specs`, the partition specs of `tree`'s leaves; rank 0
        writes."""
        self.wait()  # one in-flight save at a time
        # host snapshot (the device->host copy happens here)
        t0 = time.perf_counter()
        if self.comm is None:
            flat = {k: _snapshot(v) for k, v in _flatten(tree)}
        else:
            from repro_torch.parallel.sharding import gather_leaf
            from repro_torch.tree import tree_map
            flat = {}
            for k, leaf in _flatten(tree_map(_Sharded, tree, specs)):
                whole = gather_leaf(leaf.block, leaf.spec, self.comm, dst=0)
                if whole is not None:
                    flat[k] = _snapshot(whole)
            if self.comm.rank != 0:
                return
        snapshot_s = time.perf_counter() - t0

        def _write():
            try:
                t_write = time.perf_counter()
                tmp = self.dir / f"step_{step}.tmp"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                _write_npz(tmp / "arrays.npz", flat)
                manifest = {
                    "step": step,
                    "leaves": {k: {"shape": list(arr.shape), "dtype": dtype}
                               for k, (arr, dtype) in flat.items()},
                }
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)          # atomic commit
                self.timings.append({
                    "op": "save", "step": step, "snapshot_s": snapshot_s,
                    "write_s": time.perf_counter() - t_write,
                    "bytes": sum(a.nbytes for a, _ in flat.values())})
                self._gc()
            except BaseException as e:  # noqa: BLE001 — raised by wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------- restore

    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _load(self, step: Optional[int]):
        """(arrays, manifest dtypes, step) of `step`, default the latest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        dtypes = {k: v["dtype"] for k, v in manifest["leaves"].items()}
        return _Arrays(d / "arrays.npz"), dtypes, step

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into the structure of `tree_like` (leaves need only a
        `.shape`): tensors in their saved dtypes, on `device` (default the
        CPU)."""
        t0 = time.perf_counter()
        arrays, dtypes, step = self._load(step)
        with arrays:
            tree = _map_paths(
                lambda key, ref: _read(arrays, dtypes, key, ref).to(device),
                tree_like)
        self._timed_restore(step, tree, t0)
        return tree

    @torch.no_grad()
    def restore_into(self, tree: Any, step: Optional[int] = None) -> Any:
        """Copy the saved leaves into the tensors of `tree`, one leaf on the
        host at a time; a leaf whose shape or dtype differs raises. Returns
        `tree`."""
        t0 = time.perf_counter()
        arrays, dtypes, step = self._load(step)

        def copy(key, dst):
            src = _read(arrays, dtypes, key, dst)
            if src.dtype != dst.dtype:
                raise ValueError(f"{key}: saved {src.dtype}, tensor "
                                 f"{dst.dtype}")
            return dst.copy_(src)

        with arrays:
            tree = _map_paths(copy, tree)
        self._timed_restore(step, tree, t0)
        return tree

    def _timed_restore(self, step, tree, t0: float) -> None:
        if any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in _flat_leaves(tree)):
            torch.cuda.synchronize()
        self.timings.append({
            "op": "restore", "step": step,
            "read_s": time.perf_counter() - t0,
            "bytes": sum(x.numel() * x.element_size()
                         for x in _flat_leaves(tree))})


class _Arrays:
    """The .npy members of an npz by key, as `np.load` gives them, each read
    straight from its offset in the file: `np.load` reads a member through
    `zipfile` in 256 KiB pieces, some 500 MB/s on the H100's host
    (PERF.md). Both packages' saves store their members uncompressed."""

    _READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}

    def __init__(self, path: Path):
        self.path = path
        self._file = open(path, "rb")
        self._zip = zipfile.ZipFile(self._file)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()
        self._file.close()

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{self.path}: member {key} is compressed; "
                             "checkpoints store their arrays as np.savez does")
        f = self._file
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<26xHH", f.read(30))
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        if version not in self._READERS:
            raise ValueError(f"{self.path}: member {key} has .npy format "
                             f"{version}")
        shape, fortran, dtype = self._READERS[version](f)
        arr = np.fromfile(f, dtype=dtype, count=math.prod(shape))
        return arr.reshape(shape, order="F" if fortran else "C")


def _flat_leaves(tree):
    return [leaf for _, leaf in _flatten(tree)]


def _map_paths(fn, tree, prefix: str = ""):
    """`fn(path, leaf)` over `tree`, keeping its nesting."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _read(arrays, dtypes: Dict[str, str], key: str, ref) -> torch.Tensor:
    """Leaf `key` as a host tensor, checked against `ref`'s shape."""
    arr = arrays[key]
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{key}: saved shape {arr.shape}, want "
                         f"{tuple(ref.shape)}")
    return _tensor(arr, dtypes[key])
