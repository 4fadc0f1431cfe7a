"""Sharded model parameters as first-class, versioned objects: the port
of `repro.compute.params`.

`ParamSet.publish` flattens a parameter pytree (nested dicts, tuples and
lists of tensors or numpy arrays), copies each leaf to the host (a CUDA
tensor through `bridge.leaf_to_numpy`; bf16 as `ml_dtypes.bfloat16`, so
the leaves are the ones the reference's fetch gives for the same
weights, bit for bit), packs them into `num_shards` contiguous byte
buffers, and `put`s each buffer into the object store — one multi-ref object per shard,
refcounted and evictable like any other object, spread across nodes by
the driver-put round-robin. Contiguity is what makes the read path
zero-copy: a shard is a single ND payload, so `SharedMemoryStore.get`
hands back a read-only view of the segment and every leaf is a
dtype-cast slice of that view — no pickle, no concatenation, no copy.
A shard buffer is made read-only before it is stored, so under the
thread backend too a fetched leaf is a read-only view. A consumer that
wants tensors back copies the views (`bridge.params_from_numpy`).

The *handle* (shard ids + per-leaf layout + version) lives in the
control plane under ``paramset:{name}``. Publishing again bumps the
version atomically and drops the previous version's owning refs, so old
shards hit refcount zero and the MemoryManager reclaims them —
consumers hot-swap by re-reading `ParamSet.latest(name)` between steps
and fetch whichever version they already hold until then.

Ownership: the *publisher's cluster* owns shard objects (a module
registry holds the owning refs, keyed by cluster epoch). `latest()` and
`fetch()` hand out borrows; a consumer that must outlive the publisher's
next publish should copy, not borrow.

Hot-swap safety: `fetch()` *pins* its shards in the MemoryManager for
the duration of the read, then verifies the version is still live
(refcount > 0, not freed) before touching data — so a republish that
drops the old version's owning refs mid-read defers reclamation until
the reader unpins, and a reader that lost the race outright gets a
typed `ParamVersionRetiredError` instead of `ObjectReclaimedError`
halfway through a multi-shard reassembly. `fetch(version=n)` resolves a
specific version through the bounded per-version handle history
(``paramset:{name}@v{n}``, last `KEEP_VERSION_HANDLES` publishes);
`fetch_latest(name)` is the swap loop: retry on retired versions until
a live one is read. Leaves returned by a completed fetch stay valid
after the unpin — they are views over Python-held buffers (or
zombie-parked shm segments), so a serving replica can keep using a
superseded version until its next between-wave swap.

`rules=` (a `parallel.sharding.ShardingRules`) records each leaf's
partition-spec string in its layout entry, as the reference does; without
rules the slot is None.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.bridge import leaf_to_numpy
from repro_torch.core.api import ObjectRef, _cluster, get as _get, put as _put
from repro_torch.core.memory import ObjectReclaimedError


class ParamVersionRetiredError(RuntimeError):
    """The requested ParamSet version was superseded and its shards
    already reclaimed — re-fetch `latest()` (or use `fetch_latest`)."""


#: per-version handle records kept in the control plane (the shard data
#: itself lives exactly as long as its owning refs — this bounds only
#: the version *metadata* history used by `fetch(version=...)`)
KEEP_VERSION_HANDLES = 8

#: unique pin keys for concurrent pinned fetches
_PIN_SEQ = itertools.count()


def _flatten(params: Any, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """Deterministic (sorted-key) flatten of nested dict/list/tuple
    pytrees to ("a/b/w", array) leaves. Sequence positions get marked
    keys ("#0" tuple / "~0" list) so `_unflatten` restores the exact
    container types — model pytrees stack per-group layers in tuples."""
    if isinstance(params, dict):
        out: List[Tuple[str, np.ndarray]] = []
        for k in sorted(params, key=str):
            path = f"{prefix}/{k}" if prefix else str(k)
            out.extend(_flatten(params[k], path))
        return out
    if isinstance(params, (list, tuple)):
        mark = "#" if isinstance(params, tuple) else "~"
        out = []
        for i, v in enumerate(params):
            key = f"{mark}{i}"
            path = f"{prefix}/{key}" if prefix else key
            out.extend(_flatten(v, path))
        return out
    if isinstance(params, torch.Tensor):
        return [(prefix, leaf_to_numpy(params))]
    return [(prefix, np.asarray(params))]


def _np_dtype(name: str) -> np.dtype:
    """numpy knows "bfloat16" only once `ml_dtypes` is imported."""
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _unflatten(leaves: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for path, leaf in leaves.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf

    def rebuild(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k[:1] in "#~" for k in keys):
            seq = [rebuild(node[k])
                   for k in sorted(keys, key=lambda s: int(s[1:]))]
            return tuple(seq) if keys[0][0] == "#" else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


# owning refs for the latest published version, per (cluster epoch,
# name): replacing an entry drops the previous version's last owning
# handles, which is exactly what lets the GC reclaim the old shards
_OWNED: Dict[Tuple[int, str], List[ObjectRef]] = {}


@dataclass
class ParamSet:
    """Versioned handle over one published parameter set."""
    name: str
    version: int
    shard_ids: Tuple[str, ...]
    # per-leaf layout: (path, shape, dtype, shard index, byte offset,
    # nbytes, partition-spec string or None)
    layout: Tuple[Tuple, ...]
    total_bytes: int
    #: publisher-supplied metadata (the streaming learner records the
    #: stream step/time the weights were trained through — what
    #: seconds-behind-stream staleness is measured against)
    meta: Dict[str, Any] = field(default_factory=dict)
    _cache: Dict[int, np.ndarray] = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------ publish

    @staticmethod
    def publish(name: str, params: Any, num_shards: int = 1,
                rules: Any = None, meta: Optional[Dict] = None
                ) -> "ParamSet":
        cluster = _cluster()
        leaves = _flatten(params)
        total = sum(leaf.nbytes for _, leaf in leaves)
        num_shards = max(1, min(num_shards, len(leaves) or 1))
        # greedy contiguous split on leaf boundaries, balanced by bytes
        target = total / num_shards
        layout: List[Tuple] = []
        shard_parts: List[List[np.ndarray]] = [[] for _ in range(num_shards)]
        shard_fill = [0] * num_shards
        s = 0
        for path, leaf in leaves:
            if shard_fill[s] >= target and s < num_shards - 1:
                s += 1
            pspec = None
            if rules is not None:
                try:
                    pspec = str(rules._param_spec(path, leaf.shape))
                except Exception:
                    pspec = None
            flat = np.ascontiguousarray(leaf).view(np.uint8).reshape(-1)
            layout.append((path, tuple(leaf.shape), str(leaf.dtype), s,
                           shard_fill[s], leaf.nbytes, pspec))
            shard_parts[s].append(flat)
            shard_fill[s] += leaf.nbytes
        bufs = [np.concatenate(parts) if parts else np.zeros(0, np.uint8)
                for parts in shard_parts]
        for buf in bufs:
            buf.flags.writeable = False
        refs = [_put(buf) for buf in bufs]
        version = cluster.gcs.update(f"paramset_ver:{name}",
                                     lambda v: (v or 0) + 1, default=0)
        ps = ParamSet(name=name, version=version,
                      shard_ids=tuple(r.id for r in refs),
                      layout=tuple(layout), total_bytes=total,
                      meta=dict(meta or {}))
        record = {"version": version, "shards": ps.shard_ids,
                  "layout": ps.layout, "bytes": total, "meta": ps.meta}
        cluster.gcs.put(f"paramset:{name}", record)
        # bounded per-version handle history: lets fetch(version=...)
        # resolve a pinned read of a specific recent version
        cluster.gcs.put(f"paramset:{name}@v{version}", record)
        if version > KEEP_VERSION_HANDLES:
            cluster.gcs.put(
                f"paramset:{name}@v{version - KEEP_VERSION_HANDLES}", None)
        # install the new owning refs last: dropping the old version's
        # handles may reclaim its shards immediately, and a concurrent
        # latest() must already see the new handle by then
        key = (cluster.epoch, name)
        _OWNED.pop(key, None)
        _OWNED[key] = refs
        for k in [k for k in _OWNED if k[0] != cluster.epoch]:
            del _OWNED[k]            # stale clusters: refs are inert
        cluster.gcs.log_event("param_publish", f"{name}@v{version}",
                              "driver", bytes=total, shards=len(refs))
        return ps

    @staticmethod
    def _from_record(name: str, h: Dict) -> "ParamSet":
        return ParamSet(name=name, version=h["version"],
                        shard_ids=tuple(h["shards"]),
                        layout=tuple(h["layout"]),
                        total_bytes=h["bytes"],
                        meta=dict(h.get("meta") or {}))

    @staticmethod
    def latest(name: str) -> Optional["ParamSet"]:
        cluster = _cluster()
        h = cluster.gcs.get(f"paramset:{name}")
        if h is None:
            return None
        return ParamSet._from_record(name, h)

    @staticmethod
    def at(name: str, version: int) -> Optional["ParamSet"]:
        """Handle for a specific recent version, or None if its handle
        record aged out of the bounded history (see
        `KEEP_VERSION_HANDLES`) — the shards themselves may be gone
        regardless; `fetch` detects that with a typed error."""
        cluster = _cluster()
        h = cluster.gcs.get(f"paramset:{name}@v{version}")
        if h is None:
            return None
        return ParamSet._from_record(name, h)

    @staticmethod
    def drop(name: str) -> None:
        """Release the publisher's owning refs (shards reclaim once no
        borrower pins them) and retract the handle."""
        cluster = _cluster()
        _OWNED.pop((cluster.epoch, name), None)
        cluster.gcs.put(f"paramset:{name}", None)

    # -------------------------------------------------------------- fetch

    def shard_ref(self, i: int) -> ObjectRef:
        """Borrowed ref for one shard — legal as a task argument."""
        return ObjectRef(self.shard_ids[i])

    def _shard(self, i: int, timeout: float) -> np.ndarray:
        buf = self._cache.get(i)
        if buf is None:
            buf = _get(ObjectRef(self.shard_ids[i]), timeout=timeout)
            self._cache[i] = buf
        return buf

    def _pinned_read(self, timeout: float) -> None:
        """Materialize every not-yet-cached shard buffer under an
        explicit MemoryManager pin. Pin-then-verify closes the republish
        race: once the pin is in place AND the refcount is still
        positive, any later drop-to-zero defers to the pin; a version
        whose reclaim already started (count <= 0 or freed) is reported
        as retired *before* any shard is read."""
        missing = [i for i in range(len(self.shard_ids))
                   if i not in self._cache]
        if not missing:
            return
        cluster = _cluster()
        mm, gcs = cluster.memory, cluster.gcs
        ids = [self.shard_ids[i] for i in missing]
        key = f"pspin:{self.name}:v{self.version}:{next(_PIN_SEQ)}"
        mm.pin_ids(key, ids)
        try:
            for sid in ids:
                if gcs.is_freed(sid) or gcs.refcount(sid) <= 0:
                    raise ParamVersionRetiredError(
                        f"paramset {self.name} v{self.version}: shard "
                        f"{sid} superseded and reclaimed — re-fetch "
                        f"latest()")
                if not gcs.locations(sid):
                    # shards are driver/actor puts — no lineage, so a
                    # location-less shard was wiped by node death and
                    # can never be read again: report it retired (typed,
                    # immediately) instead of blocking a full get
                    # timeout on data that cannot come back. The
                    # publisher's next publish supersedes it.
                    raise ParamVersionRetiredError(
                        f"paramset {self.name} v{self.version}: shard "
                        f"{sid} has no live copy (publisher node lost) "
                        f"— await the next publish")
            try:
                for i in missing:
                    self._shard(i, timeout)
            except ObjectReclaimedError as err:  # pragma: no cover
                # belt-and-braces: the verify above makes this a
                # can't-happen, but map it to the typed retirement error
                # so swap loops have one exception to retry on
                raise ParamVersionRetiredError(str(err)) from err
        finally:
            mm.unpin(key)

    def fetch(self, timeout: float = 60.0,
              version: Optional[int] = None) -> Any:
        """Reassemble the full pytree. Each leaf is a zero-copy view of
        its shard buffer (read-only when the buffer came out of a
        shared-memory segment) — mutate via `apply`-style functional
        updates and republish, never in place.

        The read is *version-pinned*: shards are pinned against GC for
        the duration, so a concurrent republish can never reclaim them
        mid-read; if this version was already reclaimed the fetch raises
        `ParamVersionRetiredError` before reading anything. Pass
        ``version=n`` to fetch a specific recent version through the
        bounded handle history instead of this handle's own."""
        if version is not None and version != self.version:
            h = ParamSet.at(self.name, version)
            if h is None:
                raise ParamVersionRetiredError(
                    f"paramset {self.name} v{version}: handle record "
                    f"aged out (keep={KEEP_VERSION_HANDLES})")
            return h.fetch(timeout=timeout)
        self._pinned_read(timeout)
        leaves: Dict[str, np.ndarray] = {}
        for path, shape, dtype, s, off, nbytes, _ in self.layout:
            buf = self._shard(s, timeout)
            leaves[path] = buf[off:off + nbytes].view(
                _np_dtype(dtype)).reshape(shape)
        return _unflatten(leaves)

    @staticmethod
    def fetch_latest(name: str, timeout: float = 60.0,
                     max_attempts: int = 32
                     ) -> Optional[Tuple["ParamSet", Any]]:
        """The hot-swap read loop: fetch the newest live version,
        retrying when a republish retires the version under the reader.
        Returns ``(handle, pytree)`` or None when nothing is published.
        Under continuous publishing each retry observes a strictly newer
        version, so the loop terminates unless the publisher outruns the
        reader `max_attempts` times in a row."""
        last: Optional[ParamVersionRetiredError] = None
        for _ in range(max_attempts):
            ps = ParamSet.latest(name)
            if ps is None:
                return None
            try:
                return ps, ps.fetch(timeout=timeout)
            except ParamVersionRetiredError as err:
                last = err
        raise ParamVersionRetiredError(
            f"paramset {name}: {max_attempts} consecutive fetches lost "
            f"the republish race") from last
