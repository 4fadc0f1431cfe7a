"""Per-node object store (the paper's shared-memory store).

Buffer-first: every stored value is classified once into a ``Payload``
(header + contiguous buffer — see ``serialization.py``), so the store
accounts *exact* buffer bytes for array-likes and serialized values,
and inter-node transfer moves bytes, not live Python objects. Two
variants:

  * ``ObjectStore`` — the in-process (thread backend) store. The live
    object rides along in the payload, so intra-node reads stay
    zero-cost and identity-preserving, and unpicklable values are legal
    (held by reference; they never cross a process boundary).
  * ``SharedMemoryStore`` — the process-backend store. Buffers at or
    above ``SEGMENT_THRESHOLD`` live in ``multiprocessing.shared_memory``
    segments that worker processes attach to directly: a ``get()`` of a
    large array is a zero-copy, read-only ``np.frombuffer`` view on both
    sides of the process boundary. Small buffers stay inline (a segment
    per tiny object would exhaust fds for nothing).

Memory governance is unchanged from PR 4: the store is a *bounded,
accounted LRU cache*. Every put records the payload's byte footprint;
when `capacity_bytes` is set and an insert would exceed it,
least-recently-used objects are evicted in priority order (dead →
secondary replica → reconstructible last copy — the MemoryManager
classifies; pinned in-flight arguments and referenced last copies with
no lineage are never evicted, so capacity is a soft cap under
pure-protected contents). An evicted last copy of a referenced object is
repaired transparently by lineage replay on the next fetch.

A wiped store (node death) refuses all further puts — a transfer racing
the wipe must not resurrect data or locations on a dead node.
"""
from __future__ import annotations

import atexit
import itertools
import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.serialization import (BYTES, ND, PKL, RAW, Payload,
                                      SpawnSafetyError)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.memory import MemoryManager


class _Missing:
    __slots__ = ()

    def __repr__(self):  # pragma: no cover
        return "<MISSING>"


#: Sentinel returned by `get_if_present` when the object is not resident.
MISSING = _Missing()

# Bounds the classification scan one eviction performs (each candidate
# costs a few control-plane reads); past this window the put proceeds
# over capacity rather than stalling the hot path on a full-store scan.
_MAX_EVICT_SCAN = 256

#: Buffers at/above this land in their own shared-memory segment; below
#: it they ride inline (in the payload / the instruction ring record).
SEGMENT_THRESHOLD = 64 * 1024


class ObjectStore:
    def __init__(self, node_id: int, gcs: ControlPlane,
                 transfer_latency_s: float = 0.0,
                 capacity_bytes: Optional[int] = None,
                 memory: Optional["MemoryManager"] = None):
        self.node_id = node_id
        self.gcs = gcs
        self.transfer_latency_s = transfer_latency_s
        self.capacity_bytes = capacity_bytes
        self.memory = memory
        self._lock = threading.Lock()
        # insertion/touch order IS the LRU order: oldest first
        self._data: "OrderedDict[str, Payload]" = OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._used = 0
        self._wiped = False
        self.evictions = 0

    # ------------------------------------------------------------ accounting

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def free_bytes(self) -> float:
        """Bytes until capacity; unbounded stores report +inf."""
        if self.capacity_bytes is None:
            return float("inf")
        with self._lock:
            return max(0.0, float(self.capacity_bytes - self._used))

    def free_fraction(self) -> float:
        """Free-capacity fraction in [0, 1]; 1.0 when unbounded — the
        placement score term for memory-pressure-aware scheduling."""
        if not self.capacity_bytes:
            return 1.0
        with self._lock:
            used = self._used
        return max(0.0, (self.capacity_bytes - used) / self.capacity_bytes)

    def bytes_of(self, obj_id: str) -> int:
        """Recorded footprint of a resident object; 0 when absent. Reads
        the size table, not the value — a stored ``None`` (a nonzero
        pickled footprint) is never conflated with a missing object."""
        with self._lock:
            return self._sizes.get(obj_id, 0)

    # ------------------------------------------------------------------- put

    def put(self, obj_id: str, value: Any) -> bool:
        """Store one object, evicting LRU residents if needed to respect
        `capacity_bytes`. Returns False (and stores nothing) on a wiped
        store — a transfer that raced node death must not resurrect
        data there."""
        return self.put_payload(obj_id, self._encode(value))

    def _encode(self, value: Any) -> Payload:
        """Classify a value (exact buffer bytes for array-likes, no
        serialization work on the hot path — the thread store keeps the
        live object and serializes lazily if a transfer needs bytes)."""
        return Payload.wrap(value)

    def put_payload(self, obj_id: str, payload: Payload) -> bool:
        size = payload.nbytes
        with self._lock:
            if self._wiped:
                self._release_payload_now(payload)
                return False
            old = self._sizes.pop(obj_id, None)
            if old is not None:
                self._release_payload(self._data.pop(obj_id))
                self._used -= old
            evicted: List[Tuple[str, Payload, bool]] = []
            if (self.capacity_bytes is not None
                    and self._used + size > self.capacity_bytes):
                evicted = self._evict_locked(
                    self._used + size - self.capacity_bytes)
            self._data[obj_id] = payload
            self._sizes[obj_id] = size
            self._used += size
        for oid, pl, dead in evicted:
            self._deregister_evicted(oid, pl, dead)
        self.gcs.add_location(obj_id, self.node_id)
        return True

    def _evict_locked(self, need: int) -> List[Tuple[str, Payload, bool]]:
        """Pick >= `need` bytes of LRU victims, classified by the memory
        manager: dead objects first, then secondary replicas, then
        reconstructible last copies. Pops them from the table; the
        caller deregisters outside the lock. Best-effort: if the scanned
        window holds only protected objects, the put proceeds over
        capacity (soft cap) rather than dropping data."""
        mm = self.memory
        dead: List[str] = []
        secondary: List[str] = []
        recon: List[str] = []
        for i, oid in enumerate(self._data):
            if i >= _MAX_EVICT_SCAN:
                break
            cls = mm.evict_class(oid, self.node_id) if mm is not None \
                else "dead"
            if cls == "dead":
                dead.append(oid)
            elif cls == "replicated":
                secondary.append(oid)
            elif cls == "reconstructible":
                recon.append(oid)
        victims: List[Tuple[str, Payload, bool]] = []
        freed = 0
        for oid in itertools.chain(dead, secondary, recon):
            if freed >= need:
                break
            sz = self._sizes.pop(oid)
            payload = self._data.pop(oid)
            self._used -= sz
            freed += sz
            victims.append((oid, payload, oid in dead))
        return victims

    def _deregister_evicted(self, oid: str, payload: Payload,
                            dead: bool) -> None:
        size = payload.nbytes
        self._release_payload(payload)
        self.gcs.remove_locations(oid, [self.node_id])
        self.evictions += 1
        if self.memory is not None:
            self.memory.note_evicted(oid)
            if dead and not self.gcs.locations(oid):
                # last copy of an unreferenced object: nothing will ever
                # legitimately fetch it again — mark freed so a stray
                # borrowed-id fetch errors promptly instead of hanging
                self.gcs.mark_freed(oid)
        self.gcs.log_event("evict", oid, f"node{self.node_id}",
                           bytes=size, dead=dead)

    # ------------------------------------------------------------------ read

    def contains(self, obj_id: str) -> bool:
        with self._lock:
            return obj_id in self._data

    def payload_of(self, obj_id: str) -> Payload:
        """The resident payload (LRU touch); KeyError when absent —
        transfer and dispatch paths move payloads, not live values."""
        with self._lock:
            payload = self._data[obj_id]
            self._data.move_to_end(obj_id)
            return payload

    def get_local(self, obj_id: str) -> Any:
        return self.payload_of(obj_id).value()

    def get_if_present(self, obj_id: str, default: Any = MISSING) -> Any:
        """Single-lock conditional read — the node-local fast path.
        Returns `default` when the object is not resident (values may be
        None, so callers should compare against the MISSING sentinel)."""
        with self._lock:
            payload = self._data.get(obj_id)
            if payload is None:
                return default
            self._data.move_to_end(obj_id)  # LRU touch
        return payload.value()

    # -------------------------------------------------------------- transfer

    def fetch_from(self, other: "ObjectStore", obj_id: str) -> Any:
        """Inter-node transfer: copies the payload into this store
        (unless this store was wiped concurrently — the value is still
        returned to the caller, but a dead store caches nothing)."""
        payload = other.payload_of(obj_id)   # KeyError when absent
        if self.transfer_latency_s:
            time.sleep(self.transfer_latency_s)
        self.put_payload(obj_id, self._import_payload(payload))
        return payload.value()

    def _import_payload(self, payload: Payload) -> Payload:
        """How a transferred payload lands here. The in-process store
        shares it outright (same interpreter — this is the pre-existing
        by-reference transfer semantics); the shared-memory subclass
        copies the bytes into its own segment."""
        return payload

    def prefetch_from(self, other: "ObjectStore", obj_id: str) -> bool:
        """Best-effort transfer for eager argument push at placement
        time: like `fetch_from` but returns False instead of raising when
        the source replica vanished (the worker's resolve() falls back to
        a normal fetch in that case)."""
        try:
            self.fetch_from(other, obj_id)
            return True
        except KeyError:
            return False

    # ------------------------------------------------------------------ drop

    def discard(self, obj_id: str) -> None:
        """Drop one object and deregister its location (used to undo a
        transfer that raced a node kill — a wiped store must stay
        empty — and by the GC's cluster-wide reclaim)."""
        with self._lock:
            payload = self._data.pop(obj_id, None)
            if payload is not None:
                self._used -= self._sizes.pop(obj_id, 0)
                self._release_payload(payload)
        if payload is not None:
            self.gcs.remove_locations(obj_id, [self.node_id])

    def wipe(self) -> int:
        """Simulate node loss: drop everything, deregister locations,
        and refuse all future puts (a transfer completing after the wipe
        must not resurrect objects or locations on a dead node)."""
        with self._lock:
            self._wiped = True
            ids = list(self._data)
            for payload in self._data.values():
                self._release_payload(payload)
            self._data.clear()
            self._sizes.clear()
            self._used = 0
        for oid in ids:
            self.gcs.remove_locations(oid, [self.node_id])
        return len(ids)

    def close(self) -> None:
        """Release backing resources at node shutdown (no-op for the
        in-process store; the shared-memory store unlinks segments)."""

    # ------------------------------------------------- payload lifecycle

    def _release_payload(self, payload: Payload) -> None:
        """Called (under the store lock) whenever a payload leaves the
        table. The base store holds no external resources."""

    def _release_payload_now(self, payload: Payload) -> None:
        """Release a payload that never entered the table (a put that
        lost the race with wipe)."""
        self._release_payload(payload)


class SharedMemoryStore(ObjectStore):
    """Object store whose large buffers live in named
    ``multiprocessing.shared_memory`` segments, attachable by worker
    processes: ``get()`` of a large array — in the driver process or in
    a worker — is a zero-copy, read-only view over the segment.

    Lifetime: this store (the node, i.e. the parent process) owns every
    segment it created or adopted, and unlinks it when the object is
    evicted/discarded/wiped or the store closes — exactly once, by
    exactly one owner (see ``create_segment`` for the resource-tracker
    policy); an atexit sweep covers clusters that were never shut
    down. A view handed out by ``get()``
    keeps its mapping alive even after the unlink (POSIX semantics), but
    a segment whose exported views are still referenced at release time
    is parked on a zombie list and retried at close.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._zombies: List[Any] = []
        self._closed = False
        atexit.register(self.close)

    # ------------------------------------------------------------ encoding

    def _encode(self, value: Any) -> Payload:
        """Serialize eagerly and move the buffer into a segment (>=
        SEGMENT_THRESHOLD) or an inline bytes copy. Unpicklable values
        stay by-reference (parent-process-only — the dispatch path
        rejects them with a SpawnSafetyError if a worker process would
        need them)."""
        payload = Payload.wrap(value)
        return self._materialize(payload)

    def _materialize(self, payload: Payload) -> Payload:
        buf = payload.ensure_buffer(strict=False)
        if buf is None:            # RAW: by-reference, parent-only
            return payload
        if payload.nbytes >= SEGMENT_THRESHOLD:
            shm = create_segment(payload.nbytes)
            shm.buf[:payload.nbytes] = buf
            out = Payload.from_buffer(payload.kind, payload.meta,
                                      shm.buf[:payload.nbytes],
                                      segment=shm.name, shm=shm)
        else:
            out = Payload.from_buffer(payload.kind, payload.meta,
                                      bytes(buf))
        return out

    def _import_payload(self, payload: Payload) -> Payload:
        # inter-node transfer: copy the bytes into a segment/inline copy
        # of our own — segments are per-node-owned, a shared segment
        # would outlive its owner's wipe
        return self._materialize(payload)

    # ---------------------------------------------------------- descriptors

    def descriptor(self, obj_id: str) -> Tuple:
        """Compact cross-process reference for the instruction ring:
        ``("seg", kind, meta, name, nbytes)`` for segment-backed
        payloads, ``("inl", kind, meta, bytes)`` for inline ones.
        Raises SpawnSafetyError for by-reference payloads and KeyError
        when absent."""
        payload = self.payload_of(obj_id)
        if payload.kind == RAW:
            payload.ensure_buffer(strict=True)  # raises SpawnSafetyError
        if payload.segment is not None:
            return ("seg", payload.kind, payload.meta, payload.segment,
                    payload.nbytes)
        return ("inl", payload.kind, payload.meta,
                bytes(payload.ensure_buffer(strict=True)))

    def adopt_result(self, obj_id: str, desc: Tuple) -> bool:
        """Adopt a worker-produced result descriptor: attach (and take
        ownership of) the child-created segment, or wrap the inline
        bytes. The child never unlinks — the store owns every adopted
        segment exactly like one it created."""
        if desc[0] == "seg":
            _tag, kind, meta, name, nbytes = desc
            shm = attach_segment(name)
            payload = Payload.from_buffer(kind, meta, shm.buf[:nbytes],
                                          segment=name, shm=shm)
        else:
            _tag, kind, meta, raw = desc
            payload = Payload.from_buffer(kind, meta, raw)
        return self.put_payload(obj_id, payload)

    # ------------------------------------------------------------ lifecycle

    def _release_payload(self, payload: Payload) -> None:
        shm = payload._shm
        if shm is None:
            return
        payload._shm = None
        payload._buffer = None
        try:
            shm.close()
        except BufferError:
            # a read-only view handed out by get() is still alive: the
            # mapping must outlive it. Unlink the name now (no new
            # attaches) and retry the close at store close.
            self._zombies.append(shm)
            try:
                shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass
            return
        try:
            shm.unlink()
        except FileNotFoundError:  # pragma: no cover - already gone
            pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            self._wiped = True
            for payload in self._data.values():
                self._release_payload(payload)
            self._data.clear()
            self._sizes.clear()
            self._used = 0
            zombies, self._zombies = self._zombies, []
        for shm in zombies:
            try:
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass
            except BufferError:
                # a user still holds a view: the mapping must live until
                # process exit. Park the handle so its __del__ (which
                # would retry the close and print an ignored-exception
                # traceback at shutdown) never runs.
                _UNDEAD.append(shm)


# --------------------------------------------------------- segment helpers

#: Segment handles whose mapping cannot be closed because exported
#: views are still referenced (zero-copy get() results held by the
#: user). Keeping the handle referenced suppresses the noisy
#: ``__del__``-time close retry; the OS reclaims the mapping at exit.
_UNDEAD: List[Any] = []


def create_segment(nbytes: int):
    """Create a shared-memory segment. Lifetime policy: the resource
    tracker's registry is a *set* shared by the parent and its spawned
    workers, and ``unlink()`` unregisters — so as long as exactly one
    owner unlinks each segment exactly once (this store does, at
    evict/discard/wipe/close), attach-side auto-registrations are
    absorbed and the tracker never double-unlinks nor warns. Nobody
    calls ``resource_tracker.unregister`` by hand."""
    from multiprocessing import shared_memory
    return shared_memory.SharedMemory(create=True, size=max(1, nbytes))


def attach_segment(name: str):
    """Attach to an existing segment (see ``create_segment`` for the
    ownership/unlink policy)."""
    from multiprocessing import shared_memory
    return shared_memory.SharedMemory(name=name)


__all__ = ["MISSING", "ObjectStore", "SharedMemoryStore",
           "SEGMENT_THRESHOLD", "create_segment", "attach_segment",
           "SpawnSafetyError", "Payload", "ND", "BYTES", "PKL", "RAW"]
