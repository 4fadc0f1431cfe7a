"""Hybrid bottom-up scheduling (the paper's §3.2.2).

Workers submit tasks to their node's LOCAL scheduler. The local scheduler
dispatches to a local worker whenever (a) the task's dataflow dependencies
are satisfied and (b) node resources are available; otherwise, once its
backlog exceeds a spill threshold, it "spills over" to a GLOBAL scheduler.
Global schedulers place tasks across nodes using global information:
object locality (bytes of arguments already resident per node) minus a
load penalty (queue depth). This is exactly the two-level design that lets
locally-born work stay off the global scheduler's critical path (R1/R2).

Dataflow gating: a task is *schedulable* iff all its ObjectRef arguments
are available somewhere in the cluster (the paper's execution model). The
scheduler subscribes to the control plane's object table for missing
arguments and re-enqueues the task when the last one lands.

Hop-free spillover (R1/R2): the global scheduler is not a thread. A
spilling thread calls `place()` synchronously — the spilled task reaches
the target node's run queue before the submitting call returns, so a
remote placement costs a placement decision, not a queue handoff plus a
thread wakeup. Placement decisions serialize only within a task-id shard,
so concurrent spillers in different shards place in parallel. The target's
dispatch also skips the redundant second dataflow-gate pass (the spiller
already verified the deps) and the task's argument objects are eagerly
pushed to the chosen node so the worker's resolve() hits the local-read
fast path instead of a fetch round trip.

Actors: stateful `@remote` classes bypass all of the above on the method
path. Actor *placement* reuses the global scheduler's locality/load
scoring once, at creation; every subsequent method call routes straight
to the owning node's per-actor `ActorMailbox` — a FIFO lane that releases
calls in the control plane's sequence order, never spills, and never
re-places. That is what preserves method ordering under concurrent
callers while keeping the call path as short as a local task dispatch.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import TYPE_CHECKING, List, Optional

from repro_torch.core.control_plane import ControlPlane, TaskSpec
from repro_torch.core.devices import device_keys

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.runtime import Cluster, Node


_ObjectRef = None


def _ref_ids(spec) -> List[str]:
    """ObjectRef dependencies of a task (or actor ctor) spec. Scans the
    top-level arguments plus one level inside plain list/tuple arguments
    — a ref nested deeper than that is rejected at submit time (api
    `_check_no_deep_refs`) rather than silently passed through."""
    if not spec.args and not spec.kwargs:
        return []
    global _ObjectRef
    if _ObjectRef is None:  # lazy: scheduler<->api import cycle
        from repro_torch.core.api import ObjectRef
        _ObjectRef = ObjectRef
    ids: List[str] = []
    for a in itertools.chain(spec.args, spec.kwargs.values()):
        if isinstance(a, _ObjectRef):
            ids.append(a.id)
        elif type(a) in (list, tuple):
            ids.extend(e.id for e in a if isinstance(e, _ObjectRef))
    return ids


class ActorMailbox:
    """Per-actor FIFO lane (the actor counterpart of the local run queue).

    Method calls carry control-plane-issued sequence numbers; the mailbox
    buffers out-of-order arrivals from concurrent callers and releases
    specs strictly in sequence order through `pop_next`. Keyed by seq, so
    a restart's log replay and a late direct delivery of the same call
    dedup naturally, and seqs below the cursor (already executed before a
    checkpoint) are dropped. Closing the mailbox (node death) discards
    pending work — every call was logged in the control plane before it
    was routed here, so the restarted incarnation replays it."""

    __slots__ = ("actor_id", "cond", "closed", "_pending", "_cursor")

    def __init__(self, actor_id: str, start_seq: int = 0):
        self.actor_id = actor_id
        self.cond = threading.Condition()
        self.closed = False
        self._pending: dict = {}
        self._cursor = start_seq

    def submit(self, spec: TaskSpec) -> bool:
        """Deliver one method call; returns False when closed (the caller
        drops it — the restart replay owns it)."""
        with self.cond:
            if self.closed:
                return False
            if spec.actor_seq >= self._cursor:
                self._pending[spec.actor_seq] = spec
                self.cond.notify_all()
            return True

    def pop_next(self) -> Optional[TaskSpec]:
        """Non-blocking in-order release; None when the next seq has not
        arrived yet or the mailbox is closed."""
        with self.cond:
            if self.closed:
                return None
            spec = self._pending.pop(self._cursor, None)
            if spec is not None:
                self._cursor += 1
            return spec

    def wait_ready(self) -> bool:
        """Block until the next in-order call is deliverable (True) or the
        mailbox is closed (False). Event-driven: woken by submit/close."""
        with self.cond:
            while not self.closed and self._cursor not in self._pending:
                self.cond.wait()
            return not self.closed

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self._pending.clear()
            self.cond.notify_all()


class UnschedulableActorError(RuntimeError):
    """No live node satisfies an actor's resource footprint."""


class LocalScheduler:
    def __init__(self, node: "Node", spill_threshold: int = 4):
        self.node = node
        self.gcs: ControlPlane = node.gcs
        self.spill_threshold = spill_threshold
        self._lock = threading.Lock()
        self._backlog: List[TaskSpec] = []

    # ------------------------------------------------------------- submit

    def submit(self, spec: TaskSpec, force_local: bool = False) -> None:
        """Entry point for locally-created work (and global placements).
        Dependencies already resident in this node's store are recognized
        with a single local read — no object-table lookup."""
        store = self.node.store
        missing = [oid for oid in _ref_ids(spec)
                   if not (store.contains(oid) or self.gcs.locations(oid))]
        if missing:
            self._defer_until_ready(spec, missing, force_local)
            return
        self._schedule_ready(spec, force_local)

    def _defer_until_ready(self, spec: TaskSpec, missing: List[str],
                           force_local: bool) -> None:
        """Dataflow gate: park the task on pub-sub subscriptions for its
        missing arguments; the write that lands the last one schedules the
        task (push-driven, no polling). Each argument is counted at most
        once even if its object table entry is rewritten (transfers,
        loss notifications)."""
        state = {"pending": set(missing), "done": False}
        subs: List = []
        lock = threading.Lock()

        def on_ready(key, locs):
            if not locs:
                return
            with lock:
                state["pending"].discard(key[4:])  # strip "obj:"
                if state["pending"] or state["done"]:
                    return
                state["done"] = True
                held = list(subs)
            for s in held:
                self.gcs.unsubscribe(s)
            self._schedule_ready(spec, force_local)

        for oid in missing:
            sub = self.gcs.subscribe(f"obj:{oid}", on_ready)
            with lock:
                if state["done"]:
                    # the gate fired during this subscribe call (the
                    # object was already present); drop the handle that
                    # the unsubscribe sweep could not have seen yet
                    self.gcs.unsubscribe(sub)
                    return
                subs.append(sub)

    def submit_ready(self, spec: TaskSpec) -> None:
        """Placement entry for the global scheduler: the spiller already
        ran the dataflow gate before spilling, so skip the redundant
        dependency re-check and go straight to dispatch. Force-local: a
        global placement must not re-spill. (If a dep is lost between the
        spiller's check and execution, the worker's resolve()/fetch
        triggers lineage replay — the gate is an optimization, not a
        correctness barrier.)"""
        self._schedule_ready(spec, force_local=True)

    def submit_ready_batch(self, specs: List[TaskSpec]) -> None:
        """Grouped handoff for a compiled graph's co-planned ready
        nodes: one lock acquisition admits the whole group (acquire +
        dispatch, or backlog), instead of one `_schedule_ready` pass
        per task. The compile-time plan can be stale — an actor
        reservation landed after compile may cover this node's capacity
        permanently — so specs that no longer fit *steady-state*
        capacity go back to the global scheduler for a fresh placement
        instead of starving in the backlog. Dead node: the whole group
        re-places."""
        node = self.node
        if not node.alive:
            for spec in specs:
                node.cluster.global_scheduler.submit(spec)
            return
        dispatch: List[TaskSpec] = []
        replace: List[TaskSpec] = []
        with self._lock:
            for spec in specs:
                if node.try_acquire(spec.resources):
                    dispatch.append(spec)
                elif node.satisfies_steady(spec.resources):
                    self._backlog.append(spec)
                else:
                    replace.append(spec)
        for spec in dispatch:
            self.gcs.log_event("sched_local", spec.task_id,
                               f"node{node.node_id}")
            node.dispatch(spec)
        for spec in replace:
            self.gcs.log_event("spill", spec.task_id,
                               f"node{node.node_id}", stale_plan=True)
            node.cluster.global_scheduler.submit(spec)

    def _schedule_ready(self, spec: TaskSpec, force_local: bool) -> None:
        node = self.node
        if (spec.deadline_s and time.perf_counter() - spec.created_ts
                > spec.deadline_s):
            # already past its deadline (e.g. parked behind a dataflow
            # gate): resolve promptly instead of burning a dispatch —
            # one falsy attribute check for every other task
            node.cluster.expire_deadline(
                spec, f"node{node.node_id}/sched")
            return
        if not node.alive or not node.satisfies(spec.resources):
            # dead node, or a resource kind this node will never have (R4)
            node.cluster.global_scheduler.submit(spec)
            return
        if (not force_local and spec.mem_bytes
                and node.store.free_bytes() < spec.mem_bytes):
            # memory-pressure spill: the declared output footprint does
            # not fit this store's free bytes — let the global scheduler
            # steer the task toward a node with room (a forced global
            # placement stays: the placer already weighed memory)
            self.gcs.log_event("spill", spec.task_id,
                               f"node{node.node_id}", mem_pressure=True)
            node.cluster.global_scheduler.submit(spec)
            return
        with self._lock:
            if node.try_acquire(spec.resources):
                self.gcs.log_event("sched_local", spec.task_id,
                                   f"node{node.node_id}")
                node.dispatch(spec)
                return
            if device_keys(spec.resources):
                # every device unit is busy: the task waits for a grant
                # release, which the profiler surfaces as a device stall
                self.gcs.log_event("device_wait", spec.task_id,
                                   f"node{node.node_id}")
            # backlog only work this node can eventually run: capacity
            # held by standing actor grants never frees, so a task that
            # exceeds steady-state capacity would starve here (a forced
            # global placement stays — the placer already chose the best
            # available node, and re-spilling it would loop)
            if force_local or (len(self._backlog) < self.spill_threshold
                               and node.satisfies_steady(spec.resources)):
                self._backlog.append(spec)
                return
        # overloaded: spill to the global scheduler (paper's "spillover")
        self.gcs.log_event("spill", spec.task_id, f"node{node.node_id}")
        node.cluster.global_scheduler.submit(spec)

    # ---------------------------------------------------------- completion

    def on_worker_free(self) -> None:
        """Called when resources free up; pull from the backlog."""
        node = self.node
        while True:
            with self._lock:
                nxt = None
                for i, spec in enumerate(self._backlog):
                    if node.try_acquire(spec.resources):
                        nxt = self._backlog.pop(i)
                        break
                if nxt is None:
                    return
            self.gcs.log_event("sched_local", nxt.task_id,
                               f"node{node.node_id}")
            node.dispatch(nxt)

    def respill_unsatisfiable(self) -> None:
        """Called when a standing actor reservation lands: tasks already
        backlogged that no longer fit steady-state capacity would starve,
        so hand them back to the global scheduler."""
        node = self.node
        with self._lock:
            stuck = [s for s in self._backlog
                     if not node.satisfies_steady(s.resources)]
            if not stuck:
                return
            self._backlog = [s for s in self._backlog if s not in stuck]
        for spec in stuck:
            self.gcs.log_event("spill", spec.task_id,
                               f"node{node.node_id}", actor_reserved=True)
            node.cluster.global_scheduler.submit(spec)

    def drain(self) -> List[TaskSpec]:
        with self._lock:
            items, self._backlog = self._backlog, []
        return items

    def backlog_len(self) -> int:
        """Locked backlog-depth accessor (used for load accounting; never
        read `_backlog` without the lock)."""
        with self._lock:
            return len(self._backlog)


class GlobalScheduler:
    """Places spilled tasks by locality + load, synchronously on the
    spilling thread — no inbox queue, no scheduler thread, no handoff.
    Decisions serialize per task-id shard only (concurrent spillers in
    different shards place in parallel). Stateless: control state lives
    in the GCS, so 'restarting' a global scheduler is a no-op."""

    def __init__(self, cluster: "Cluster", num_shards: int = 1):
        self.cluster = cluster
        self.gcs = cluster.gcs
        self._locks = [threading.Lock() for _ in range(max(1, num_shards))]

    def submit(self, spec: TaskSpec) -> None:
        try:
            self.place(spec)
        except Exception as e:  # pragma: no cover
            self.gcs.log_event("sched_error", spec.task_id, "global",
                               error=repr(e))

    def _locality_bytes(self, spec: TaskSpec, node: "Node") -> int:
        total = 0
        for oid in _ref_ids(spec):
            if node.store.contains(oid):
                total += node.store.bytes_of(oid)
        return total

    def _select_node(self, spec, extra_score=None,
                     allow_unsteady: bool = False) -> Optional["Node"]:
        """Shared placement policy: among live nodes whose *steady-state*
        capacity (total minus standing actor grants) satisfies the
        request, pick the best locality-minus-load score
        (bytes-equivalent penalty), plus an optional caller-specific
        term. None when no such node exists — a task queued where actor
        grants permanently cover its request would starve, so callers
        park instead (an actor death or topology change retries it).
        `allow_unsteady` falls back to raw-capacity nodes (actor
        placement: the new actor would rather queue than park)."""
        nodes = [n for n in self.cluster.nodes if n.alive
                 and n.satisfies(spec.resources)]
        if not nodes:
            return None
        steady = [n for n in nodes if n.satisfies_steady(spec.resources)]
        if not steady and not allow_unsteady:
            return None
        mem_need = getattr(spec, "mem_bytes", 0)
        best, best_score = None, None
        for n in steady or nodes:
            score = self._locality_bytes(spec, n) - 4096.0 * n.load()
            # memory-pressure term: free store fraction, scaled to one
            # load-penalty unit — breaks ties toward nodes with room
            # without swamping data locality
            score += 4096.0 * n.store.free_fraction()
            # a declared output footprint ("mem" resource hint) that
            # doesn't fit the node's free bytes would force evictions
            # there the moment the task stores its result
            if mem_need and n.store.free_bytes() < mem_need:
                score -= float(1 << 19)
            if extra_score is not None:
                score += extra_score(n)
            if best_score is None or score > best_score:
                best, best_score = n, score
        return best

    def _never_satisfiable(self, spec: TaskSpec) -> bool:
        """Under an explicitly declared topology (``node_resources=``),
        a request that no node's *raw* capacity covers — live or dead,
        since a dead node restarts with its declared capacity — can
        never be placed; parking it would hang every getter forever.
        Elastic clusters (the default) keep parking: add_node drains."""
        if not getattr(self.cluster, "strict_placement", False):
            return False
        return not any(n.satisfies(spec.resources)
                       for n in self.cluster.nodes)

    def place(self, spec: TaskSpec) -> None:
        with self._locks[hash(spec.task_id) % len(self._locks)]:
            best = self._select_node(spec)
            if best is None and not self._never_satisfiable(spec):
                # no node can run this *now* (dead holders, or standing
                # actor grants cover it everywhere): park until topology
                # changes or a reservation releases
                self.cluster.park_unschedulable(spec)
                return
        if best is None:
            # outside the shard lock: sealing stores errors and may
            # release graph dependents
            self.cluster.seal_unschedulable(spec)
            return
        # outside the shard lock: transfer + dispatch don't need to
        # serialize with other placement decisions
        self.gcs.log_event("sched_global", spec.task_id,
                           f"node{best.node_id}")
        best.prefetch_args(spec)
        best.local_scheduler.submit_ready(spec)

    def plan_node(self, spec: TaskSpec,
                  affinity: Optional[dict] = None) -> Optional[int]:
        """Compile-time placement for one compiled-graph node: the same
        `_select_node` scoring a spilled task gets (locality + load +
        memory pressure), plus a graph-affinity bonus toward the nodes
        its dependencies were planned on — chains co-reside so the
        worker's inline chaining applies. Returns a node_id (the static
        plan), or None when no live node currently satisfies the
        request (execute falls back to normal global placement, which
        parks if still unschedulable)."""
        extra = None
        if affinity:
            extra = lambda n: affinity.get(n.node_id, 0.0)  # noqa: E731
        with self._locks[hash(spec.task_id) % len(self._locks)]:
            best = self._select_node(spec, extra)
        if best is not None:
            self.gcs.log_event("graph_plan", spec.task_id,
                               f"node{best.node_id}")
            return best.node_id
        return None

    def place_actor(self, aspec) -> "Node":
        """Choose the node an actor lives on: the shared placement policy
        (ctor ObjectRef args count toward locality), plus a bonus for
        nodes that can grant the actor's standing footprint right now and
        a spread penalty on nodes already carrying actor grants (replica
        pools rely on this). Raises UnschedulableActorError when no live
        node can ever satisfy the footprint — callers park-and-retry."""
        def actor_score(n):
            score = -4096.0 * n.standing_reservation()
            if n.can_grant_now(aspec.resources):
                score += 1 << 20   # fits without waiting
            return score

        with self._locks[hash(aspec.actor_id) % len(self._locks)]:
            best = self._select_node(aspec, actor_score,
                                     allow_unsteady=True)
            if best is None:
                raise UnschedulableActorError(
                    f"no live node satisfies actor resources "
                    f"{aspec.resources!r} for {aspec.class_name}")
        # reserve at placement time, not when the actor thread spins up:
        # concurrent placements must see each other's standing grants or
        # they pile onto one node (the context releases the reservation
        # when the actor dies). Outside the shard lock — the reservation
        # respills now-unsatisfiable backlog through this scheduler.
        best.reserve_for_actor(aspec.resources)
        self.gcs.log_event("actor_place", aspec.actor_id,
                           f"node{best.node_id}")
        return best

    def shutdown(self) -> None:
        """Kept for interface compatibility; there is nothing to stop."""
