"""Memory-governed data plane: sizeof accounting, distributed reference
counting, and garbage collection for the per-node object stores.

The paper's architecture keeps every task output in a per-node
shared-memory store; without a memory subsystem those stores are
unbounded append-only dicts, so any long-running feedback loop (serving,
RL) leaks without bound. This module makes the stores *accounted* and
*collected*:

  * ``sizeof`` gives every stored value a byte footprint (array
    ``nbytes`` when available, a recursive container estimate
    otherwise). ``None`` has a nonzero footprint — a stored ``None`` is
    an object, not an absence.
  * ``MemoryManager`` implements distributed reference counting over
    the control plane's object table (``refcnt:{oid}`` keys — the count
    is control-plane state like everything else, so a restarted
    component re-reads it). Ownership rules:
      - handles returned by ``submit()``/``put()`` *own* one count
        (adopted at creation; ``__del__`` releases it);
      - refs passed as task arguments are *borrows* — the task spec in
        the task table holds non-owning copies, and the pending task
        pins the object via the manager's pin table until it completes;
      - ``api.free`` drops the count to zero explicitly.
    When the count reaches zero and no pending/parked task pins the
    object, it is reclaimed on every node that holds a copy.
  * Releases are *deferred* to a dedicated reclaimer thread:
    ``ObjectRef.__del__`` may fire on any thread while arbitrary locks
    are held, so it only enqueues; the reclaimer performs the
    control-plane decrement and the cross-node discard.
  * Reclaimed (and dead-evicted) objects are marked in a ``freed``
    table; a fetch that finds no live copy *and* no lineage to replay
    raises ``ObjectReclaimedError`` promptly instead of hanging to its
    timeout. Objects with lineage stay transparently reconstructible:
    eviction of the last copy of a still-referenced task output is
    repaired by ``Cluster.maybe_reconstruct`` on the next fetch.

Eviction policy (``ObjectStore`` consults ``evict_class``): LRU order
within three priority classes — (1) *dead* objects (no refs, no pins),
(2) *secondary replicas* (another live node holds a copy), (3)
*reconstructible* last copies (non-actor lineage). In-flight task
arguments (pinned) and last copies of referenced objects with no
lineage (driver ``put``s, actor method results) are never evicted.
"""
from __future__ import annotations

import collections
import sys
import threading
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.control_plane import TASK_PENDING, TASK_RUNNING
from repro_torch.core.scheduler import _ref_ids

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.runtime import Cluster


class ObjectReclaimedError(RuntimeError):
    """The object's memory was reclaimed (refcount hit zero, or
    ``api.free`` was called) and no lineage exists to recompute it."""


def _interpreter_finalizing() -> bool:
    """True once the interpreter is tearing down (or `sys` itself has
    been cleared from module globals). Split out so ``release`` has one
    guard point and tests can exercise the finalization path without
    mutating the process-wide ``sys`` module."""
    return sys is None or sys.is_finalizing()


#: Fixed footprint charged for primitives / interpreter overhead. Chosen
#: so a stored ``None`` is visibly nonzero (the old ``bytes_of`` returned
#: 0 for a real ``None`` value, conflating it with a missing object).
_PRIMITIVE_BYTES = 32
_CONTAINER_BYTES = 64
_MAX_SIZEOF_DEPTH = 4


def sizeof(value) -> int:
    """Byte footprint of a stored value: exactly ``nbytes`` for
    array-likes (matching the serialized buffer length the store
    actually holds — see ``serialization.Payload``, which reports the
    same number, so pin accounting and store accounting agree to the
    byte), a bounded recursive estimate for containers,
    ``sys.getsizeof`` as the fallback. Deliberately cheap and
    deterministic — accounting, not forensics."""
    return _sizeof(value, 0)


def _sizeof(value, depth: int) -> int:
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):  # pragma: no cover - exotic .nbytes
            pass
    if value is None or isinstance(value, (bool, int, float, complex)):
        return _PRIMITIVE_BYTES
    if isinstance(value, (bytes, bytearray)):
        # exact: the stored buffer IS the value (serialization.Payload
        # BYTES kind) — pin accounting must match store accounting
        return len(value)
    if isinstance(value, str):
        return _PRIMITIVE_BYTES + len(value)
    if isinstance(value, (list, tuple, set, frozenset)):
        if depth >= _MAX_SIZEOF_DEPTH:
            return _CONTAINER_BYTES * max(len(value), 1)
        return _CONTAINER_BYTES + sum(_sizeof(v, depth + 1) for v in value)
    if isinstance(value, dict):
        if depth >= _MAX_SIZEOF_DEPTH:
            return _CONTAINER_BYTES * max(len(value), 1)
        return _CONTAINER_BYTES + sum(
            _sizeof(k, depth + 1) + _sizeof(v, depth + 1)
            for k, v in value.items())
    try:
        return max(int(sys.getsizeof(value)), _PRIMITIVE_BYTES)
    except TypeError:  # pragma: no cover - getsizeof not supported
        return 4 * _CONTAINER_BYTES


class MemoryManager:
    """Cluster-wide GC authority: reference counts + task pins + the
    deferred reclaimer. One per cluster; stores and schedulers hold a
    reference and consult it for eviction/placement decisions."""

    def __init__(self, cluster: "Cluster"):
        self._cluster = cluster
        self.gcs = cluster.gcs
        # pin table: task/actor key -> tuple(oids); oid -> pin count.
        # A pinned object is an argument of a task that has not reached
        # DONE (or an actor's ctor args, pinned for the actor's life).
        self._pins_lock = threading.Lock()
        self._pin_counts: Dict[str, int] = {}
        self._pins_by_task: Dict[str, Tuple[str, ...]] = {}
        # ids whose last copy was dropped by eviction — lets lineage
        # replay tag its reconstructs as evict-repairs for the profiler
        self._evicted_lock = threading.Lock()
        self._evicted: set = set()
        # fire-and-forget outputs: the handle was dropped before the
        # producing task finished, so the reclaimer deferred collection;
        # the DONE path re-enqueues exactly these (a set membership test,
        # never a control-plane read on the worker's critical path)
        self._deferred: set = set()
        # deferred-release queue. __del__ may run on any thread while it
        # holds store or control-plane shard locks, so release() only
        # appends here; the reclaimer thread does the lock-taking work.
        self._reclaim_cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._busy = False
        self.reclaim_count = 0
        self._closed = False
        self._thread = threading.Thread(target=self._reclaim_loop,
                                        name="mm-reclaimer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ ownership

    def adopt(self, ref) -> None:
        """Make `ref` an owning handle: +1 on the control-plane count,
        and stamp the manager on the handle so its ``__del__`` releases
        against the right cluster (ids are only unique per control
        plane). Synchronous — the count must be up before the caller
        could possibly drop the handle."""
        self.gcs.incr_ref(ref.id)
        object.__setattr__(ref, "_owner", self)

    def adopt_all(self, refs) -> None:
        """Batched adopt for a compiled invocation's sink handles: all
        counts land with one lock pass per shard before any handle can
        be dropped."""
        self.gcs.incr_refs([r.id for r in refs])
        for ref in refs:
            object.__setattr__(ref, "_owner", self)

    def release(self, oid: str) -> None:
        """Owning handle dropped. Deferred: just enqueue — never touch a
        lock hierarchy from ``__del__``. One notify per empty→nonempty
        transition: the reclaimer drains in batches, so waking it per
        object would just burn context switches on the task hot path.

        Callable from ``__del__`` at any point in the process lifetime:
        after shutdown (or during interpreter finalization, when the
        reclaimer thread and the condition variable may already be torn
        down) it is a silent no-op — a dying process reclaims nothing,
        and a spurious "Exception ignored in __del__" would be the only
        possible effect of trying."""
        if self._closed or _interpreter_finalizing():
            return
        # no blanket except here: the guards above cover both teardown
        # cases, ObjectRef.__del__ already swallows exceptions, and a
        # silent enqueue failure would be an undiagnosable store leak
        with self._reclaim_cv:
            self._queue.append(("rel", oid))
            if len(self._queue) == 1:
                self._reclaim_cv.notify()

    def free(self, oids: Iterable[str]) -> None:
        """Explicit eager reclamation (``api.free``): zero the count,
        mark the objects freed, and discard whatever copies are not
        pinned by a pending task (a pinned object is reclaimed when its
        last dependent completes)."""
        for oid in oids:
            self.gcs.update(f"refcnt:{oid}", lambda _v: 0)
            self.gcs.mark_freed(oid)
            self._maybe_reclaim(oid)
            self._wake_blocked(oid)

    # ----------------------------------------------------------------- pins

    def pin_task(self, key: str, spec) -> None:
        """Pin a task's (or actor ctor's) ObjectRef arguments until the
        task completes. Idempotent per key — resubmits re-pin only after
        the DONE-path unpinned."""
        ids = _ref_ids(spec)
        if not ids:
            return
        with self._pins_lock:
            self._pin_locked(key, ids)

    def pin_tasks_with_ids(self, pairs) -> None:
        """Pin a whole compiled-graph invocation's argument sets under
        one lock acquisition (execute()-time batching: N pin_task calls
        would pay N lock round trips on the dispatch hot path). `pairs`
        is an iterable of (task_key, ref_id_list) — the caller already
        knows each task's refs, so no argument re-scan happens here."""
        pairs = [(k, ids) for k, ids in pairs if ids]
        if not pairs:
            return
        with self._pins_lock:
            for key, ids in pairs:
                self._pin_locked(key, ids)

    def _pin_locked(self, key: str, ids) -> None:
        if key in self._pins_by_task:
            return
        self._pins_by_task[key] = tuple(ids)
        for oid in ids:
            self._pin_counts[oid] = self._pin_counts.get(oid, 0) + 1

    def pins(self, oid: str) -> int:
        with self._pins_lock:
            return self._pin_counts.get(oid, 0)

    def pin_ids(self, key: str, ids: Iterable[str]) -> None:
        """Explicit reader pin, no task attached: hold `ids` against
        refcount-zero reclaim until ``unpin(key)``. This is what makes a
        version-pinned `ParamSet.fetch` safe against a concurrent
        republish dropping the version's last owning refs mid-read — the
        reclaimer defers any object with a live pin and re-checks it
        when the pin drops."""
        ids = tuple(ids)
        if not ids:
            return
        with self._pins_lock:
            self._pin_locked(key, ids)

    def unpin(self, key: str) -> None:
        """Release an explicit ``pin_ids`` pin: mirror of the DONE-path
        unpin — ids whose pin count hits zero are handed to the
        reclaimer as check candidates (their refcount may have reached
        zero while pinned)."""
        check: List[str] = []
        with self._pins_lock:
            pinned = self._pins_by_task.pop(key, ())
            for oid in pinned:
                c = self._pin_counts.get(oid, 0) - 1
                if c <= 0:
                    self._pin_counts.pop(oid, None)
                    check.append(oid)
                else:
                    self._pin_counts[oid] = c
        if check:
            with self._reclaim_cv:
                was_empty = not self._queue
                self._queue.extend(("chk", oid) for oid in check)
                if was_empty:
                    self._reclaim_cv.notify()

    def on_task_done(self, spec) -> None:
        """A task reached DONE: unpin its arguments, and hand candidates
        to the reclaimer. Runs on the worker's critical path, so it does
        NO control-plane reads: unpinned args are enqueued unchecked
        (the reclaimer reads their counts off-path), and outputs are
        enqueued only when the reclaimer previously deferred them (the
        fire-and-forget case — a set membership test)."""
        check: List[str] = []
        with self._pins_lock:
            pinned = self._pins_by_task.pop(spec.task_id, ())
            for oid in pinned:
                c = self._pin_counts.get(oid, 0) - 1
                if c <= 0:
                    self._pin_counts.pop(oid, None)
                    check.append(oid)
                else:
                    self._pin_counts[oid] = c
            if self._deferred:
                for rid in spec.return_ids:
                    if rid in self._deferred:
                        self._deferred.discard(rid)
                        check.append(rid)
        if check:
            with self._reclaim_cv:
                was_empty = not self._queue
                self._queue.extend(("chk", oid) for oid in check)
                if was_empty:
                    self._reclaim_cv.notify()

    # ------------------------------------------------------------- eviction

    def evict_class(self, oid: str, node_id: int) -> Optional[str]:
        """Classify one store-resident object for eviction:
        ``"dead"`` (no refs, no pins), ``"replicated"`` (another live
        node holds a copy), ``"reconstructible"`` (last copy, but
        non-actor lineage can recompute it), or ``None`` — protected
        (in-flight argument with no other copy, or a referenced last
        copy nothing can recompute).

        For objects lineage can NOT recompute, the replica check is
        asymmetric — only a node holding a *lower*-id live replica may
        treat its own copy as secondary. Two nodes evicting
        concurrently would otherwise each classify the other's copy as
        the survivor and destroy both, with nothing left to repair the
        loss."""
        if self.pins(oid) > 0:
            if not self._has_other_replica(oid, node_id):
                return None
            return "replicated" if self.replayable(oid) \
                or self._has_lower_replica(oid, node_id) else None
        if self.gcs.refcount(oid) <= 0:
            return "dead"
        if self.replayable(oid):
            return "replicated" if self._has_other_replica(oid, node_id) \
                else "reconstructible"
        return "replicated" if self._has_lower_replica(oid, node_id) \
            else None

    def _has_other_replica(self, oid: str, node_id: int) -> bool:
        nodes = self._cluster.nodes
        return any(n != node_id and n < len(nodes) and nodes[n].alive
                   for n in self.gcs.locations(oid))

    def _has_lower_replica(self, oid: str, node_id: int) -> bool:
        """A live replica on a lower-numbered node: the deterministic
        survivor under concurrent eviction of an unreconstructable
        object (the lowest-id holder never yields its copy)."""
        nodes = self._cluster.nodes
        return any(n < node_id and n < len(nodes) and nodes[n].alive
                   for n in self.gcs.locations(oid))

    def replayable(self, oid: str) -> bool:
        """Whether lineage can recompute the object: a producing task
        exists, it is not an actor method (actor results depend on
        actor state — only a node-death replay regenerates those), its
        replay budget is not already exhausted (a sealed task's error
        object must be treated as non-reconstructible — evicting it and
        replaying would spin on the same failure), and none of its
        inputs is a *dead* actor output: a replay needing an
        actor-produced argument whose refcount already hit zero would
        park forever — the argument has no lineage and nothing will
        ever regenerate it."""
        tid = self.gcs.producing_task(oid)
        if tid is None:
            return False
        spec = self.gcs.task_spec(tid)
        if spec is None or spec.actor_id is not None:
            return False
        if self.gcs.replay_count(tid) > self._cluster.retry_budget(spec):
            return False
        from repro_torch.core.scheduler import _ref_ids
        for arg_id in _ref_ids(spec):
            ptid = self.gcs.producing_task(arg_id)
            if ptid is None:
                continue
            pspec = self.gcs.task_spec(ptid)
            if (pspec is not None and pspec.actor_id is not None
                    and self.gcs.refcount(arg_id) <= 0):
                return False
        return True

    def unfetchable(self, oid: str) -> bool:
        """A fetch should fail promptly: the object was freed/reclaimed
        and no lineage exists to bring it back."""
        return self.gcs.is_freed(oid) and not self.replayable(oid)

    def note_evicted(self, oid: str) -> None:
        with self._evicted_lock:
            # best-effort profiler tag, not correctness state: bound it
            # so eternal churn cannot grow it without limit
            if len(self._evicted) >= 65536:
                self._evicted.clear()
            self._evicted.add(oid)

    def was_evicted_any(self, oids: Iterable[str]) -> bool:
        with self._evicted_lock:
            return any(oid in self._evicted for oid in oids)

    # ------------------------------------------------------------ reclaimer

    #: Accumulation window after the first release of a batch: trades a
    #: few milliseconds of reclaim latency for an order of magnitude
    #: fewer reclaimer wakeups/GIL switches on the task hot path (on the
    #: 2-vCPU CI box every extra wakeup lands in the middle of a
    #: worker→waiter handoff). Must exceed a typical task round trip so
    #: steady-state drops coalesce ~10 per wakeup.
    _BATCH_WINDOW_S = 0.005

    def _reclaim_loop(self) -> None:
        import time
        while True:
            with self._reclaim_cv:
                while not self._queue and not self._closed:
                    self._reclaim_cv.wait()
                if self._closed and not self._queue:
                    return
            # let the burst land before taking any locks (a single
            # bounded sleep per batch, not a poll loop)
            time.sleep(self._BATCH_WINDOW_S)
            with self._reclaim_cv:
                batch = list(self._queue)
                self._queue.clear()
                self._busy = True
            try:
                # drain in bounded chunks with a yield between them: a
                # huge backlog (a driver dropping thousands of refs at
                # once) must not monopolize the GIL against the task
                # hot path for tens of milliseconds
                for i in range(0, len(batch), 64):
                    for op, oid in batch[i:i + 64]:
                        try:
                            if op == "rel":
                                # a release landing after free()/reclaim
                                # must not resurrect the pruned refcnt
                                # key at -1 (a "chk" for a freed-but-
                                # pinned object still has to reclaim)
                                if self.gcs.is_freed(oid):
                                    continue
                                if self.gcs.decr_ref(oid) <= 0:
                                    self._maybe_reclaim(oid)
                            elif self.gcs.refcount(oid) <= 0:
                                self._maybe_reclaim(oid)
                        except Exception:  # noqa: BLE001 - best-effort
                            pass
                    if i + 64 < len(batch):
                        time.sleep(0.0002)
            finally:
                with self._reclaim_cv:
                    self._busy = False
                    self._reclaim_cv.notify_all()

    def _maybe_reclaim(self, oid: str) -> None:
        """Reclaim `oid` cluster-wide if nothing can still need it:
        count at zero, no task pins, and the producing task is not
        mid-flight (a fire-and-forget output lands *after* this check —
        ``on_task_done`` re-enqueues it)."""
        if self.pins(oid) > 0 or self.gcs.refcount(oid) > 0:
            return
        tid = self.gcs.producing_task(oid)
        if tid is not None and self.gcs.task_state(tid) in (TASK_PENDING,
                                                           TASK_RUNNING):
            # fire-and-forget: the output hasn't landed yet — defer, and
            # let the DONE path's set probe re-enqueue it
            with self._pins_lock:
                self._deferred.add(oid)
            # re-check: if the task completed between the state read and
            # the insert, its DONE probe may have missed the entry —
            # claim it back and reclaim here (double reclaim is
            # idempotent if the probe DID see it)
            if self.gcs.task_state(tid) in (TASK_PENDING, TASK_RUNNING):
                return
            with self._pins_lock:
                if oid not in self._deferred:
                    return          # the DONE path claimed and enqueued it
                self._deferred.discard(oid)
        freed_bytes = 0
        nodes = self._cluster.nodes
        for n in list(self.gcs.locations(oid)):
            if n < len(nodes) and nodes[n].alive:
                freed_bytes += nodes[n].store.bytes_of(oid)
                nodes[n].store.discard(oid)
        self.gcs.mark_freed(oid)
        self.gcs.drop_ref_key(oid)   # the count can never rise again
        self.gcs.log_event("reclaim", oid, "memory", bytes=freed_bytes)
        self._wake_blocked(oid)
        with self._reclaim_cv:
            self.reclaim_count += 1
            self._reclaim_cv.notify_all()

    def _wake_blocked(self, oid: str) -> None:
        """Freed state never produces an add_location, so push the news
        to anyone already parked: one completion notify (a blocked
        wait() counts the freed future as done) and one obj-table touch
        (a blocked fetch wakes, re-checks, and raises the prompt
        ObjectReclaimedError instead of sleeping to its timeout)."""
        self.gcs.notify_completion(oid)
        self.gcs.notify_lost(oid)

    # ---------------------------------------------------------- test hooks

    def wait_reclaimed(self, oid: str, timeout: float = 1.0) -> bool:
        """Block until `oid` is marked freed (reclaimed) — event-driven
        on the reclaimer's condition, used by the churn benchmark and
        tests to measure GC reclaim latency."""
        import time
        deadline = time.perf_counter() + timeout
        with self._reclaim_cv:
            while not self.gcs.is_freed(oid):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self._reclaim_cv.wait(remaining)
        return True

    def quiesce(self, timeout: float = 5.0) -> bool:
        """Block until the deferred-release queue has fully drained."""
        import time
        deadline = time.perf_counter() + timeout
        with self._reclaim_cv:
            while self._queue or self._busy:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self._reclaim_cv.wait(remaining)
        return True

    def shutdown(self) -> None:
        with self._reclaim_cv:
            self._closed = True
            self._reclaim_cv.notify_all()
        self._thread.join(timeout=2.0)
