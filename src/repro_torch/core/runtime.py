"""Cluster runtime: nodes, fault injection, lineage reconstruction,
elastic scaling.

A Node bundles workers + a local scheduler + an object store + a resource
ledger; the Cluster wires nodes to one or more global schedulers and the
control plane. Everything except the control plane is stateless (R6): a
killed node's objects are reconstructed by replaying lineage from the task
table, and pending/running tasks on the dead node are resubmitted.
"""
from __future__ import annotations

import atexit
import heapq
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.control_plane import (TASK_DONE, TASK_LOST, TASK_PENDING,
                                      TASK_RUNNING, ActorSpec, ControlPlane,
                                      TaskSpec)
from repro_torch.core.backends import (ExecutionBackend, ProcessBackend,
                                 ThreadBackend)
from repro_torch.core.memory import MemoryManager, ObjectReclaimedError
from repro_torch.core.object_store import (MISSING, ObjectStore,
                                     SharedMemoryStore)
from repro_torch.core.devices import device_keys
from repro_torch.core.scheduler import (GlobalScheduler, LocalScheduler,
                                  UnschedulableActorError, _ref_ids)
from repro_torch.core.worker import (ActorContext, GetTimeoutError,
                               TaskDeadlineError, TaskUnrecoverableError,
                               UnschedulableTaskError, Worker, execute_task)

# Bounds inline work-stealing recursion (a steal can fetch its own lost
# args, which may steal again); past this depth fetch parks on the event.
_MAX_STEAL_DEPTH = 16
# Bounds the per-node run-queue scan a steal probe performs under the
# queue mutex: with deep backlogs the workers are saturated anyway and an
# unbounded scan would contend with every dequeue on exactly the path
# this fast path is meant to shorten.
_MAX_STEAL_SCAN = 64
_steal_ctx = threading.local()


class DeviceLane:
    """Dedicated executor lane for one device key on one node.

    The resource ledger already guarantees at most ``capacity[key]``
    device tasks hold a grant concurrently; the lane additionally pins
    their *execution* to one dedicated thread per device key, so a
    kernel task never time-slices against ordinary cpu tasks in the
    shared worker pool and two kernel tasks never contend for the same
    device context. Thread backend only — under the process backend the
    ledger's capacity accounting is the sole (and sufficient) guard.
    """

    def __init__(self, node: "Node", key: str):
        self.node = node
        self.key = key
        self.queue: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"lane-{key}-n{node.node_id}")
        self._thread.start()
        # a daemon lane thread reaped mid-launch at interpreter exit
        # can abort the process in the CUDA runtime's teardown; drain it
        # even when the driver errors out before cluster.shutdown()
        atexit.register(self.stop)

    def submit(self, spec: TaskSpec) -> None:
        self.queue.put(spec)

    def stop(self) -> None:
        self.queue.put(None)
        # join: a daemon lane thread killed mid-launch at interpreter
        # exit can abort the process in the CUDA runtime's teardown
        self._thread.join(timeout=10.0)

    def drain_pending(self) -> List[TaskSpec]:
        items: List[TaskSpec] = []
        while True:
            try:
                s = self.queue.get_nowait()
            except queue.Empty:
                break
            if s is not None:
                items.append(s)
        return items

    def _run(self) -> None:
        while True:
            spec = self.queue.get()
            if spec is None:
                return
            if not self.node.alive:
                # raced a kill: the drain owns requeueing; a spec that
                # slipped past it is LOST and lineage replay covers it
                continue
            execute_task(self.node, spec, f"lane-{self.key}")


class Node:
    def __init__(self, cluster: "Cluster", node_id: int,
                 resources: Dict[str, float], num_workers: int,
                 spill_threshold: int = 4,
                 transfer_latency_s: float = 0.0,
                 store_capacity_bytes: Optional[int] = None,
                 backend: str = "thread"):
        self.cluster = cluster
        self.node_id = node_id
        self.gcs = cluster.gcs
        self.alive = True
        self.capacity = dict(resources)
        self._avail = dict(resources)
        self._res_lock = threading.Lock()
        self._res_cond = threading.Condition(self._res_lock)
        # standing actor grants: capacity that never returns to the pool
        # while the actor lives — scheduling must not queue tasks behind it
        self._actor_reserved: Dict[str, float] = {}
        # the process backend needs segment-backed buffers (worker
        # processes attach to them); the thread backend keeps the
        # zero-cost in-process store
        store_cls = SharedMemoryStore if backend == "process" \
            else ObjectStore
        self.store = store_cls(node_id, cluster.gcs, transfer_latency_s,
                               capacity_bytes=store_capacity_bytes,
                               memory=cluster.memory)
        self.run_queue: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self.local_scheduler = LocalScheduler(self, spill_threshold)
        self._actors: Dict[str, ActorContext] = {}
        self._actors_lock = threading.Lock()
        # task_id -> start timestamp for everything currently executing
        # here (workers + actor contexts). Plain dict, GIL-atomic writes:
        # the hung-task watchdog and get()-timeout diagnostics read it
        # from the monitor/error paths only.
        self.inflight: Dict[str, float] = {}
        # liveness beats: published by a dedicated beater thread when the
        # failure detector is on; `hb_suspended` lets the chaos harness
        # simulate a hung-but-not-crashed node (beats stop, threads run)
        self.hb_suspended = False
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # execution backend: how dispatched specs turn into running
        # code. The run_queue/workers attributes always exist (the
        # work-stealing get() path scans run_queue directly; under the
        # process backend both simply stay empty).
        self.backend_name = backend
        self.workers: List[Worker] = []
        self._max_workers = max(64, 8 * num_workers)
        if backend == "process":
            self.backend: "ExecutionBackend" = ProcessBackend(
                self, num_workers)
        else:
            self.backend = ThreadBackend(self, num_workers)
        self.backend.start()
        # one dedicated executor lane per declared device key (thread
        # backend): kernel tasks bypass the shared worker pool so they
        # never time-slice against cpu tasks or each other on one device
        self.device_lanes: Dict[str, DeviceLane] = {}
        if backend != "process":
            for key in device_keys(self.capacity):
                self.device_lanes[key] = DeviceLane(self, key)

    # ----------------------------------------------------------- heartbeats

    def start_heartbeat(self, interval_s: float) -> None:
        """Publish liveness beats into the control plane's heartbeat
        table — one batched beat per node covering all its workers and
        actors, entirely off the task hot path."""
        if self._hb_thread is not None:
            return
        self.gcs.beat(self.node_id, time.perf_counter())

        def loop() -> None:
            while not self._hb_stop.wait(interval_s):
                if not self.alive:
                    return
                if not self.backend.healthy():
                    # a worker process died: stop beating so the failure
                    # detector fail-stops this node exactly like a dead
                    # machine (drain + lineage replay elsewhere)
                    return
                if not self.hb_suspended:
                    self.gcs.beat(self.node_id, time.perf_counter())

        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name=f"heartbeat-n{self.node_id}")
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()

    # ------------------------------------------------------------ resources

    def satisfies(self, req: Dict[str, float]) -> bool:
        return all(self.capacity.get(k, 0.0) >= v for k, v in req.items())

    def satisfies_steady(self, req: Dict[str, float]) -> bool:
        """Whether the request fits the node's *steady-state* capacity —
        total capacity minus standing actor reservations. A task that
        fails this can never run here no matter how long it queues, so
        the local scheduler spills it instead of backlogging it."""
        with self._res_lock:
            return all(
                self.capacity.get(k, 0.0) - self._actor_reserved.get(k, 0.0)
                >= v for k, v in req.items())

    def reserve_for_actor(self, req: Dict[str, float]) -> None:
        with self._res_lock:
            for k, v in req.items():
                self._actor_reserved[k] = self._actor_reserved.get(k, 0.0) + v
        # tasks backlogged before the reservation may now be unsatisfiable
        # in steady state — push them back out to the global scheduler
        self.local_scheduler.respill_unsatisfiable()

    def unreserve_for_actor(self, req: Dict[str, float]) -> None:
        with self._res_lock:
            for k, v in req.items():
                self._actor_reserved[k] = max(
                    0.0, self._actor_reserved.get(k, 0.0) - v)
        # steady-state capacity just grew: tasks parked because actor
        # grants covered them everywhere may be placeable now (outside
        # the lock — the retry re-enters placement, which reads it)
        self.cluster.drain_unschedulable()

    def standing_reservation(self) -> float:
        """Locked snapshot of the total standing actor grant (placement
        reads this concurrently with ActorContext threads reserving)."""
        with self._res_lock:
            return sum(self._actor_reserved.values())

    def can_grant_now(self, req: Dict[str, float]) -> bool:
        with self._res_lock:
            return all(self._avail.get(k, 0.0) >= v for k, v in req.items())

    def _acquire_locked(self, req: Dict[str, float]) -> bool:
        if all(self._avail.get(k, 0.0) >= v for k, v in req.items()):
            for k, v in req.items():
                self._avail[k] -= v
            return True
        return False

    def try_acquire(self, req: Dict[str, float]) -> bool:
        with self._res_lock:
            return self._acquire_locked(req)

    def acquire_blocking(self, req: Dict[str, float],
                         timeout: float) -> bool:
        """Block until the resources can be acquired — woken by `release`
        via a condition variable, never by a polling sleep."""
        deadline = time.perf_counter() + timeout
        with self._res_cond:
            while not self._acquire_locked(req):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:  # pragma: no cover
                    return False
                self._res_cond.wait(remaining)
        return True

    def release(self, req: Dict[str, float]) -> None:
        with self._res_cond:
            for k, v in req.items():
                self._avail[k] = min(self.capacity.get(k, 0.0),
                                     self._avail.get(k, 0.0) + v)
            self._res_cond.notify_all()

    def load(self) -> float:
        return float(self.backend.queued()
                     + self.local_scheduler.backlog_len())

    # --------------------------------------------------- blocked workers
    # A worker blocking in get()/wait() releases its task's resources and
    # (if needed) a spare worker thread is spawned, so nested tasks cannot
    # deadlock the pool (same policy as Ray's blocked-worker handling).

    def enter_blocked(self, spec: Optional[TaskSpec]) -> None:
        if spec is not None:
            self.release(spec.resources)
        self.backend.maybe_spawn_spare()
        self.local_scheduler.on_worker_free()

    def exit_blocked(self, spec: Optional[TaskSpec],
                     timeout: float = 60.0) -> None:
        if spec is None:
            return
        self.acquire_blocking(spec.resources, timeout)

    # ------------------------------------------------------------- dataflow

    def dispatch(self, spec: TaskSpec) -> None:
        if self.device_lanes:
            for key in device_keys(spec.resources):
                lane = self.device_lanes.get(key)
                if lane is not None:
                    lane.submit(spec)
                    return
        self.backend.submit(spec)

    def prefetch_args(self, spec: TaskSpec) -> None:
        """Eager argument push for cross-node placement: pull the task's
        ObjectRef arguments into this node's store at dispatch time so
        the worker's resolve() hits the single-read local fast path
        instead of paying a fetch round trip per argument. Best-effort —
        a replica vanishing mid-transfer just leaves the normal fetch
        path to reconstruct it. With a modeled transfer latency the push
        runs on a background thread so the (now synchronous) placement
        path cannot block task submission (R3); resolve() racing the
        push simply falls back to a normal fetch."""
        if self.store.transfer_latency_s:
            threading.Thread(target=self._prefetch_now, args=(spec,),
                             daemon=True,
                             name=f"prefetch-n{self.node_id}").start()
        else:
            self._prefetch_now(spec)

    def _prefetch_now(self, spec: TaskSpec) -> None:
        for oid in _ref_ids(spec):
            if not self.alive:
                return
            if self.store.contains(oid):
                continue
            locs = self.gcs.locations(oid)
            # memory-pressure-aware push: don't evict residents to cache
            # an argument speculatively — if it doesn't fit the current
            # free bytes, let the worker's resolve() fetch it (or read
            # it remotely) when the task actually runs
            if self.store.capacity_bytes is not None:
                src_bytes = max(
                    (self.cluster.nodes[n].store.bytes_of(oid)
                     for n in locs if n < len(self.cluster.nodes)),
                    default=0)
                if src_bytes > self.store.free_bytes():
                    self.gcs.log_event("prefetch_skip", oid,
                                       f"node{self.node_id}",
                                       bytes=src_bytes)
                    continue
            for n in locs:
                if (n == self.node_id or n >= len(self.cluster.nodes)
                        or not self.cluster.nodes[n].alive):
                    continue
                src = self.cluster.nodes[n]
                if self.store.prefetch_from(src.store, oid):
                    if not self.alive:
                        # raced a kill: the wipe may have run before our
                        # put landed, and a wiped store must stay empty —
                        # a stale location here would block lineage
                        # replay after a restart
                        self.store.discard(oid)
                        return
                    self.gcs.log_event(
                        "prefetch", oid, f"node{n}->node{self.node_id}")
                    break

    def resolve(self, arg: Any) -> Any:
        from repro_torch.core.api import ObjectRef
        if isinstance(arg, ObjectRef):
            # node-local fast path: a single store read, no control-plane
            # round trip and no pub-sub churn
            val = self.store.get_if_present(arg.id)
            if val is not MISSING:
                return val
            return self.cluster.fetch(arg.id, prefer_node=self.node_id)
        # refs one level inside plain list/tuple args resolve too (the
        # dependency scan counts them, so they are guaranteed available);
        # subclasses (e.g. namedtuples) pass through untouched
        if type(arg) in (list, tuple) and any(
                isinstance(e, ObjectRef) for e in arg):
            return type(arg)(self.resolve(e) for e in arg)
        return arg

    # -------------------------------------------------------------- actors

    def start_actor(self, aspec: ActorSpec, start_seq: int = 0,
                    checkpoint: Any = None) -> ActorContext:
        """Install the actor's execution context + mailbox, then publish
        this node as the owner. Publish-last matters: a method call that
        reads the new location always finds a live mailbox."""
        ctx = ActorContext(self, aspec, start_seq, checkpoint)
        with self._actors_lock:
            self._actors[aspec.actor_id] = ctx
        self.gcs.set_actor_node(aspec.actor_id, self.node_id)
        return ctx

    def actor_context(self, actor_id: str) -> Optional[ActorContext]:
        with self._actors_lock:
            return self._actors.get(actor_id)

    def drain_actors(self) -> List[ActorContext]:
        """Fail-stop the node's actors: close every mailbox (pending calls
        are discarded — the replay log owns them) and hand the contexts to
        the cluster for relocation."""
        with self._actors_lock:
            ctxs, self._actors = list(self._actors.values()), {}
        for ctx in ctxs:
            ctx.mailbox.close()
        return ctxs

    def shutdown(self) -> None:
        self.stop_heartbeat()
        self.drain_actors()   # closes every actor mailbox
        for lane in self.device_lanes.values():
            lane.stop()
        self.backend.shutdown()
        self.store.close()


_cluster_epochs = itertools.count(1)


class FailureDetector:
    """Heartbeat failure detection + hung-task watchdog + deadline
    monitor — one thread per cluster, nothing on the task hot path.

    Nodes publish batched liveness beats into the control plane's
    heartbeat table (`ControlPlane.beat`); the monitor thread scans them
    every `interval_s` and declares a node dead after `miss` consecutive
    missed beats, driving the existing `kill_node` + lineage-replay
    path automatically (the paper's R6 without a hand-written
    `kill_node()` call). A missed beat is an on-time scan (within two
    intervals of the scan before) that found no new beat, and the beat
    must also be `miss * interval_s` old: a stall of the whole
    interpreter (a long garbage-collection pass, a C call holding the
    GIL) delays the beaters and the scan alike, and a late scan is no
    evidence. (The reference judges wall time alone, so such a stall of
    150 ms fail-stops live nodes.) The hung-task watchdog reads the per-node
    in-flight start-timestamp registries the workers maintain (two
    GIL-atomic dict ops per task) and kills a node holding any task past
    `hung_task_timeout_s` — a slow-but-alive node keeps beating and is
    never a false positive unless it actually exceeds the watchdog
    bound. Deadline tracking is always available (the thread lazily
    starts on the first `deadline=` task) even when heartbeats are off.
    """

    def __init__(self, cluster: "Cluster", interval_s: float = 0.05,
                 miss: int = 3, hung_task_timeout_s: Optional[float] = None,
                 enabled: bool = False):
        self.cluster = cluster
        self.interval = interval_s
        self.miss = miss
        self.hung_task_timeout_s = hung_task_timeout_s
        self.enabled = enabled          # heartbeat publication + scanning
        self._deadlines: List[Tuple[float, str, TaskSpec]] = []  # heap
        self._dl_lock = threading.Lock()
        self._start_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the monitor's own state: per node the last beat it saw and the
        # scans since that beat that found no newer one; its last scan
        self._seen: Dict[Node, Tuple[float, int]] = {}
        self._last_scan: Optional[float] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Turn on heartbeat publication for every current node and the
        monitor thread (idempotent)."""
        self.enabled = True
        for node in self.cluster.nodes:
            node.start_heartbeat(self.interval)
        self.ensure_started()

    def ensure_started(self) -> None:
        with self._start_lock:
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="failure-detector")
                self._thread.start()

    def watch_node(self, node: Node) -> None:
        """A node joined (or was restarted): start its beater if
        heartbeat detection is on."""
        if self.enabled:
            node.start_heartbeat(self.interval)

    def shutdown(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    # ------------------------------------------------------------ deadlines

    def track_deadline(self, spec: TaskSpec) -> None:
        """Register a `deadline=` task for prompt expiry (submit-time,
        off the common path — only tasks WITH a deadline ever land
        here). The task_id is the heap tiebreak: specs don't compare."""
        with self._dl_lock:
            heapq.heappush(self._deadlines,
                           (spec.created_ts + spec.deadline_s,
                            spec.task_id, spec))
        self.ensure_started()

    def _expire_deadlines(self, now: float) -> None:
        expired: List[TaskSpec] = []
        with self._dl_lock:
            while self._deadlines and self._deadlines[0][0] <= now:
                expired.append(heapq.heappop(self._deadlines)[2])
        for spec in expired:
            self.cluster.expire_deadline(spec, "detector")

    # ------------------------------------------------------------- monitor

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._tick(time.perf_counter())

    def _tick(self, now: float) -> None:
        """One scan at `now`: heartbeats, hung tasks, deadlines. A scan
        that finds no newer beat is a miss only if this scan is on time,
        within 2 x `interval` of the one before: a detector that was
        itself held up (the GIL taken by a long C call, the process not
        scheduled) has no evidence that the beaters were not held up as
        well, even where it got the interpreter back before them."""
        c = self.cluster
        on_time = (self._last_scan is None
                   or now - self._last_scan <= 2 * self.interval)
        self._last_scan = now
        if self.enabled:
            horizon = self.miss * self.interval
            seen = self._seen
            for node in list(c.nodes):
                if not node.alive:
                    seen.pop(node, None)
                    continue
                last = c.gcs.heartbeat(node.node_id)
                if last is None:
                    continue
                prev, missed = seen.get(node, (None, 0))
                if last != prev:
                    missed = 0
                elif on_time:
                    missed += 1
                seen[node] = (last, missed)
                if missed < self.miss or now - last <= horizon:
                    continue
                # re-check identity: a concurrent restart_node may
                # have installed a fresh node under this id — its
                # first beat lands at construction, never kill it
                # for the old incarnation's staleness
                if c.nodes[node.node_id] is not node or not node.alive:
                    continue
                c.gcs.log_event("detector_kill", f"node{node.node_id}",
                                "detector", missed_s=now - last)
                c.kill_node(node.node_id)
        if self.hung_task_timeout_s:
            for node in list(c.nodes):
                if not node.alive:
                    continue
                hung = [tid for tid, t0 in list(node.inflight.items())
                        if now - t0 > self.hung_task_timeout_s]
                if not hung:
                    continue
                if c.nodes[node.node_id] is not node or not node.alive:
                    continue
                c.gcs.log_event("watchdog_kill", f"node{node.node_id}",
                                "detector", tasks=hung)
                c.kill_node(node.node_id)
        self._expire_deadlines(now)


class Cluster:
    def __init__(self, num_nodes: int = 2, workers_per_node: int = 2,
                 resources_per_node: Optional[Dict[str, float]] = None,
                 gcs_shards: int = 8, num_global_schedulers: int = 1,
                 spill_threshold: int = 4, transfer_latency_s: float = 0.0,
                 store_capacity_bytes: Optional[int] = None,
                 default_max_retries: int = 8,
                 failure_detection: bool = False,
                 heartbeat_interval_s: float = 0.05,
                 heartbeat_miss: int = 3,
                 hung_task_timeout_s: Optional[float] = None,
                 backend: str = "thread",
                 node_resources: Optional[List[Dict[str, float]]] = None):
        if backend not in ("thread", "process"):
            raise ValueError(
                f"unknown execution backend {backend!r}: expected "
                f"'thread' or 'process'")
        # monotonic process-wide token: never reused across clusters (an
        # id() would be, after teardown), so per-cluster registration
        # guards compare against this
        self.epoch = next(_cluster_epochs)
        self.gcs = ControlPlane(gcs_shards)
        # the GC authority must exist before the first node: every
        # ObjectStore consults it for eviction classification
        self.memory = MemoryManager(self)
        # num_global_schedulers now counts placement shards, not threads
        self.global_scheduler = GlobalScheduler(self, num_global_schedulers)
        self._unschedulable: List[TaskSpec] = []
        self._unschedulable_actors: List[Tuple[ActorSpec, int]] = []
        self._unsched_lock = threading.Lock()
        # live compiled-graph invocations: inv_id -> _GraphInvocation
        # (dag.py). Holds each invocation's dependency counters until
        # its last node completes; workers consult it to release
        # plan-order dependents without a dataflow-gate pass.
        self._graph_invs: Dict[str, Any] = {}
        self._graph_lock = threading.Lock()
        # failure-replay budget for tasks with max_retries=-1 (the
        # fn.options default): a deterministic failure seals with
        # TaskUnrecoverableError after this many attempts
        self.default_max_retries = default_max_retries
        # created before the first node so add_node can register beaters;
        # the monitor thread only starts when detection is requested (or
        # lazily, on the first deadline= task)
        self.detector = FailureDetector(
            self, heartbeat_interval_s, heartbeat_miss,
            hung_task_timeout_s, enabled=False)
        self.nodes: List[Node] = []
        # node-death listeners: callbacks fired (with the node id) at the
        # end of kill_node, after the node's objects are wiped, tasks
        # requeued, and actors handed to relocation. Control loops above
        # the runtime (the serving front door's hot-spare autoscaler)
        # subscribe here instead of polling liveness.
        self._death_listeners: List[Callable[[int], None]] = []
        res = resources_per_node or {"cpu": float(workers_per_node)}
        self.backend_name = backend
        self._node_defaults = (workers_per_node, spill_threshold,
                               transfer_latency_s, store_capacity_bytes,
                               backend)
        # an explicitly declared heterogeneous topology (one capacity
        # dict per node) is a contract: a task requesting resources no
        # declared node can ever hold seals promptly with
        # UnschedulableTaskError instead of parking for elastic
        # scale-up that was never promised
        self.strict_placement = node_resources is not None
        if node_resources is not None:
            for node_res in node_resources:
                self.add_node(node_res)
        else:
            for _ in range(num_nodes):
                self.add_node(res)
        if failure_detection:
            self.detector.start()
        elif hung_task_timeout_s:
            self.detector.ensure_started()

    # --------------------------------------------------------------- nodes

    def add_node(self, resources: Optional[Dict[str, float]] = None) -> Node:
        """Elastic scale-up: new nodes join by registering with the GCS."""
        w, spill, lat, cap, backend = self._node_defaults
        res = dict(resources or {"cpu": float(w)})
        node = Node(self, len(self.nodes), res, w, spill, lat, cap,
                    backend=backend)
        self.nodes.append(node)
        self.detector.watch_node(node)
        self.drain_unschedulable()
        self._retry_parked_actors()
        return node

    def park_unschedulable(self, spec: TaskSpec) -> None:
        with self._unsched_lock:
            self._unschedulable.append(spec)

    def seal_unschedulable(self, spec: TaskSpec) -> None:
        """Resolve a never-satisfiable task promptly: store a typed
        UnschedulableTaskError on its return ids and release graph
        dependents (they receive the error — same propagation rule as a
        raising task). Mirrors `expire_deadline`: the DONE transition is
        atomic, so a racing completion wins and this is a no-op."""
        won: List[int] = []

        def trans(s):
            if s in (TASK_PENDING, TASK_RUNNING, TASK_LOST):
                won.append(1)
                return TASK_DONE
            return s

        self.gcs.update(f"task_state:{spec.task_id}", trans)
        if not won:
            return
        err = UnschedulableTaskError(
            f"task {spec.task_id} ({spec.func_name}) requests "
            f"{spec.resources!r}, which no declared node can ever "
            f"satisfy")
        live = self.live_nodes()
        for rid in spec.return_ids:
            if live and not self._live_locs(rid):
                live[0].store.put(rid, err)
        self.memory.on_task_done(spec)
        self.gcs.log_event("task_unschedulable", spec.task_id, "global")
        if spec.graph_inv is not None:
            for dep in self.graph_ready_after(spec):
                self.graph_dispatch(dep)

    def drain_unschedulable(self) -> None:
        """Re-place parked tasks — fired whenever schedulable capacity
        can have grown (node joined/restarted, actor grant released)."""
        with self._unsched_lock:
            parked, self._unschedulable = self._unschedulable, []
        for spec in parked:
            self.global_scheduler.submit(spec)

    def live_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.alive]

    # -------------------------------------------------------------- actors

    def create_actor(self, aspec: ActorSpec) -> None:
        """Register the actor in the control plane, place it with the
        global scheduler's locality/load scoring, and start its execution
        context on the chosen node. An actor no live node can host parks
        — like an unschedulable task — and is placed when capacity joins
        (method calls submitted meanwhile are logged and replayed)."""
        # ctor args stay pinned for the actor's life: a restart replays
        # the constructor, which must still be able to resolve them
        # (pin before the actor becomes visible — same borrow/pin
        # ordering rule as submit)
        self.memory.pin_task(aspec.actor_id, aspec)
        self.gcs.register_actor(aspec)
        try:
            node = self.global_scheduler.place_actor(aspec)
        except UnschedulableActorError:
            self.gcs.log_event("actor_unschedulable", aspec.actor_id,
                               "cluster")
            with self._unsched_lock:
                self._unschedulable_actors.append(
                    (aspec, aspec.submitter_node))
            return
        node.start_actor(aspec)

    def submit_actor_task(self, spec: TaskSpec) -> None:
        """Route one method call straight to the owning node's mailbox —
        no spillover, no placement. A call that lands on a closed mailbox
        (the actor's node died concurrently) is simply dropped: the caller
        logged it in the control plane before routing, and the restart's
        log replay delivers it to the new incarnation."""
        nid = self.gcs.actor_node(spec.actor_id)
        if nid is None or nid >= len(self.nodes):
            return
        node = self.nodes[nid]
        ctx = node.actor_context(spec.actor_id)
        if ctx is None or not node.alive:
            return
        # submit's condition notify wakes the actor thread; a dropped call
        # (closed mailbox) is covered by the restart's log replay
        ctx.mailbox.submit(spec)

    def _try_actor_inline(self, spec: TaskSpec) -> bool:
        """Work-stealing for actor lanes: a getter blocked on a method
        result drains the owning actor's ready, in-order calls on its own
        thread (run_ready serializes against the actor thread). Returns
        True if any method ran."""
        nid = self.gcs.actor_node(spec.actor_id)
        if nid is None or nid >= len(self.nodes):
            return False
        node = self.nodes[nid]
        if not node.alive:
            return False
        ctx = node.actor_context(spec.actor_id)
        if ctx is None:
            return False
        return ctx.run_ready("steal") > 0

    def _restart_actors(self, ctxs: List["ActorContext"],
                        from_node_id: int) -> None:
        """Relocate actors drained off a fail-stopped node: re-place via
        the global scheduler, restore the latest `__getstate__`
        checkpoint if one exists (else re-run the constructor), and replay
        the logged method sequence past the checkpoint — the actor-state
        analogue of task lineage reconstruction. Replayed calls re-store
        their results, waking any fetcher blocked on a wiped object."""
        for old_ctx in ctxs:
            self._relocate_actor(old_ctx.aspec, from_node_id)

    def _relocate_actor(self, aspec: ActorSpec, from_node_id: int) -> None:
        # a retired actor (planned scale-down) is never resurrected: its
        # retirement was deliberate, so replay would silently undo an
        # autoscaler decision and leak a standing reservation
        if self.gcs.actor_retired(aspec.actor_id):
            return
        # actor replay rides the same bounded-retry policy as task
        # lineage: an actor whose node keeps dying is re-placed and
        # replayed at most default_max_retries times, then abandoned
        # with typed errors on its unresolved method results
        attempts = self.gcs.count_replay(aspec.actor_id)
        if attempts > self.default_max_retries:
            self._seal_actor_unrecoverable(aspec, attempts - 1)
            return
        try:
            target = self.global_scheduler.place_actor(aspec)
        except UnschedulableActorError:
            # no live node can host it right now: park — add_node /
            # restart_node retries (method calls submitted meanwhile are
            # logged and dropped, so the eventual replay delivers them)
            self.gcs.log_event("actor_unschedulable", aspec.actor_id,
                               "cluster")
            with self._unsched_lock:
                self._unschedulable_actors.append((aspec, from_node_id))
            return
        ckpt = self.gcs.actor_checkpoint(aspec.actor_id)
        start_seq, state = ckpt if ckpt is not None else (0, None)
        new_ctx = target.start_actor(aspec, start_seq, state)
        self.gcs.log_event(
            "actor_restart", aspec.actor_id,
            f"node{from_node_id}->node{target.node_id}",
            replay_from=start_seq)
        for seq, tid in self.gcs.actor_log(aspec.actor_id):
            if seq < start_seq:
                continue
            mspec = self.gcs.task_spec(tid)
            if mspec is not None:
                new_ctx.mailbox.submit(mspec)

    def _seal_actor_unrecoverable(self, aspec: ActorSpec,
                                  attempts: int) -> None:
        """An actor that died faster than it could be replayed is
        abandoned: every logged-but-unresolved method result gets a
        TaskUnrecoverableError so blocked callers fail promptly instead
        of waiting for an incarnation that will never come."""
        err = TaskUnrecoverableError(
            f"actor {aspec.actor_id} ({aspec.class_name}) exhausted its "
            f"restart budget ({attempts} restarts, max "
            f"{self.default_max_retries})")
        self.gcs.log_event("actor_unrecoverable", aspec.actor_id,
                           "cluster", attempts=attempts)
        live = self.live_nodes()
        for _seq, tid in self.gcs.actor_log(aspec.actor_id):
            spec = self.gcs.task_spec(tid)
            if spec is None:
                continue
            for rid in spec.return_ids:
                if live and not self._live_locs(rid):
                    live[0].store.put(rid, err)
            self.gcs.set_task_state(tid, TASK_DONE)
            self.memory.on_task_done(spec)

    def _retry_parked_actors(self) -> None:
        with self._unsched_lock:
            parked, self._unschedulable_actors = (
                self._unschedulable_actors, [])
        for aspec, from_nid in parked:
            self._relocate_actor(aspec, from_nid)

    def retire_actor(self, actor_id: str) -> None:
        """Planned actor scale-down (the serving front door's autoscaler
        rides this): mark the actor retired in the control plane, drop it
        from its node's actor map, and close its mailbox — the context
        thread exits and releases the actor's standing reservation.
        Unlike kill_node's drain, retirement is permanent: relocation
        skips retired actors, so a later failure of the same node never
        resurrects one via restart-with-replay. Callers are expected to
        have drained their in-flight calls first (pending mailbox work is
        discarded, exactly like a node death — but nothing will replay
        it)."""
        self.gcs.retire_actor(actor_id)
        nid = self.gcs.actor_node(actor_id)
        self.gcs.log_event("actor_retired", actor_id,
                           f"node{nid}" if nid is not None else "parked")
        # also purge a parked incarnation waiting for capacity
        with self._unsched_lock:
            self._unschedulable_actors = [
                (a, f) for a, f in self._unschedulable_actors
                if a.actor_id != actor_id]
        if nid is None or nid >= len(self.nodes):
            return
        node = self.nodes[nid]
        with node._actors_lock:
            ctx = node._actors.pop(actor_id, None)
        if ctx is not None:
            ctx.mailbox.close()
        # the released standing grant is capacity: parked work may now fit
        self.drain_unschedulable()
        self._retry_parked_actors()

    # ------------------------------------------------------ death listeners

    def add_death_listener(self, cb: Callable[[int], None]) -> None:
        """Subscribe to node fail-stops: `cb(node_id)` fires at the end of
        every effective kill_node (post drain/relocation), on the killing
        thread — detector, chaos harness, or driver. Callbacks must be
        quick and non-blocking; exceptions are swallowed so one listener
        cannot break failure handling."""
        self._death_listeners.append(cb)

    def remove_death_listener(self, cb: Callable[[int], None]) -> None:
        try:
            self._death_listeners.remove(cb)
        except ValueError:
            pass

    def _notify_death(self, node_id: int) -> None:
        for cb in list(self._death_listeners):
            try:
                cb(node_id)
            except Exception:
                pass

    # ------------------------------------------------------ compiled graphs

    def graph_register_invocation(self, inv) -> None:
        with self._graph_lock:
            self._graph_invs[inv.inv_id] = inv

    def _graph_inv(self, inv_id: Optional[str]):
        if inv_id is None:
            return None
        with self._graph_lock:
            return self._graph_invs.get(inv_id)

    def graph_planned(self, spec: TaskSpec) -> Optional[int]:
        inv = self._graph_inv(spec.graph_inv)
        if inv is None or spec.graph_idx < 0:
            return None
        return inv.planned[spec.graph_idx]

    def _available_for_dispatch(self, node: Node, oid: str) -> bool:
        """The dataflow-availability rule graph dispatch applies before
        skipping the gate: resident in the target's store, or located
        somewhere the worker's resolve() can fetch it from. One
        definition for chainability, per-node dispatch, and grouped
        root dispatch."""
        return node.store.contains(oid) or bool(self.gcs.locations(oid))

    def graph_chainable(self, spec: TaskSpec, node: "Node") -> bool:
        """Whether a ready dependent may run inline on `node`'s current
        worker thread: planned here AND no still-unavailable external
        dependency — inlining past a pending external would park the
        worker in a blocking fetch (the same rule graph_dispatch
        enforces via the gated submit)."""
        if not node.backend.supports_inline_chain:
            # cross-process handoff: the dependent rides the instruction
            # ring like any other dispatch
            return False
        inv = self._graph_inv(spec.graph_inv)
        if inv is None or spec.graph_idx < 0:
            return False
        if inv.planned[spec.graph_idx] != node.node_id:
            return False
        ext = inv.externals[spec.graph_idx]
        return not ext or all(self._available_for_dispatch(node, oid)
                              for oid in ext)

    def graph_ready_after(self, spec: TaskSpec) -> Tuple[TaskSpec, ...]:
        """A compiled-graph node reached DONE: decrement its dependents'
        pending-edge counters and return the specs whose last edge this
        completion satisfied — the caller dispatches (or inline-chains)
        them. Idempotent per node (lineage replay can complete a node
        twice), and the invocation's bookkeeping is dropped when its
        final node completes."""
        inv = self._graph_inv(spec.graph_inv)
        if inv is None:
            return ()
        with inv.lock:
            if spec.graph_idx in inv.done:
                return ()
            inv.done.add(spec.graph_idx)
            inv.remaining -= 1
            finished = inv.remaining == 0
            ready = []
            for d in inv.dependents[spec.graph_idx]:
                inv.pending[d] -= 1
                if inv.pending[d] == 0:
                    ready.append(inv.specs[d])
        if finished:
            with self._graph_lock:
                self._graph_invs.pop(inv.inv_id, None)
            self.gcs.log_event("graph_done", inv.inv_id, "cluster")
        return tuple(ready)

    def graph_dispatch(self, spec: TaskSpec) -> None:
        """Route one ready compiled-graph node: straight to its planned
        node's `submit_ready` (plan order already satisfied its
        intra-graph edges — no second dataflow pass), with an eager
        cross-node argument push; a dead/unavailable planned node falls
        back to a gated entry on a live node. Nodes that also depend on
        *external* futures (eager refs bound into the graph) take the
        gated `submit` when any is still unavailable — a worker must
        not park in a blocking fetch for an edge the plan never
        covered. (Ready deps are always plain tasks: actor calls are
        mailbox-delivered up front at execute() and never re-dispatch
        here.)"""
        inv = self._graph_inv(spec.graph_inv)   # one lock pass: planned
        planned = (inv.planned[spec.graph_idx]  # + externals both come
                   if inv is not None and spec.graph_idx >= 0 else None)
        if (planned is not None and planned < len(self.nodes)
                and self.nodes[planned].alive):
            node = self.nodes[planned]
            ext = inv.externals[spec.graph_idx]
            if not node.satisfies_steady(spec.resources):
                # stale plan: a standing actor grant placed after
                # compile covers this node's capacity for good — a
                # force-local backlog would starve, so re-enter through
                # a gated live-node submit (which spills onward)
                self._graph_fallback_submit(spec)
                return
            if ext and any(not self._available_for_dispatch(node, oid)
                           for oid in ext):
                node.local_scheduler.submit(spec, force_local=True)
                return
            node.prefetch_args(spec)
            node.local_scheduler.submit_ready(spec)
        else:
            self._graph_fallback_submit(spec)

    def _graph_fallback_submit(self, spec: TaskSpec) -> None:
        """Planned node dead (or the compile-time plan found none):
        enter through a live node's *gated* submit, never straight into
        global placement — `place()` hands specs to `submit_ready`,
        which assumes the dataflow gate already ran, and this spec's
        external deps may still be pending. The local scheduler spills
        onward (gate satisfied) if the entry node can't host it."""
        live = self.live_nodes()
        if live:
            live[spec.graph_idx % len(live)].local_scheduler.submit(spec)
        else:
            self.global_scheduler.submit(spec)  # parks: no live nodes

    def graph_dispatch_roots(self, planned: Optional[int],
                             specs: List[TaskSpec]) -> None:
        """Grouped per-planned-node handoff for an invocation's root
        nodes (one scheduler-lock pass admits the group). A root whose
        *external* dependencies (eager futures passed into bind/execute)
        are not yet available goes through the normal gated `submit`
        instead — intra-graph edges never need the gate, external ones
        still might."""
        if (planned is None or planned >= len(self.nodes)
                or not self.nodes[planned].alive):
            for spec in specs:
                self._graph_fallback_submit(spec)
            return
        node = self.nodes[planned]
        batch: List[TaskSpec] = []
        for spec in specs:
            deps = _ref_ids(spec)
            if deps and any(not self._available_for_dispatch(node, oid)
                            for oid in deps):
                node.local_scheduler.submit(spec, force_local=True)
            else:
                batch.append(spec)
                if deps:
                    node.prefetch_args(spec)
        if batch:
            node.local_scheduler.submit_ready_batch(batch)

    def graph_on_lost(self, spec: TaskSpec) -> None:
        """A compiled-graph task died with its node (LOST): replay it
        via lineage immediately. Eager tasks recover lazily when a
        blocked fetcher notices; a graph intermediate may have no
        fetcher at all — its dependents are gated on the invocation's
        counters, not on pub-sub — so the loss must trigger the
        resubmit itself. The LOST→PENDING transition is atomic; only
        the winner replays (mirrors maybe_reconstruct)."""
        won: List[int] = []

        def trans(s):
            if s == TASK_LOST:
                won.append(1)
                return TASK_PENDING
            return s

        self.gcs.update(f"task_state:{spec.task_id}", trans)
        if won:
            attempts = self._count_replay(spec, "compiled-graph node lost")
            if not attempts:
                return  # sealed with TaskUnrecoverableError
            self.gcs.log_event("graph_replay", spec.task_id, "lineage")
            self._resubmit_backoff(spec, attempts)

    # ------------------------------------------------------------ fetching

    def fetch(self, obj_id: str, prefer_node: Optional[int] = None,
              timeout: float = 30.0) -> Any:
        """Return the value of obj_id, transferring/reconstructing as
        needed. Purely event-driven: the available case is served with at
        most one object-table read (and zero pub-sub churn); the blocked
        case parks on an Event that every object-table write for this key
        sets — including the push-based loss notifications a dying node's
        tasks emit — so there is no polling wakeup anywhere.

        `timeout` bounds the time spent *waiting*: when the producing
        task is stolen and run inline (work-stealing fast path), the
        getter has become the worker and the task runs to completion even
        if that exceeds the timeout — the standard inline-join semantics
        of work-stealing futures."""
        # fast path: object resident on the preferred (local) node —
        # a single store read, no control-plane round trip
        if prefer_node is not None and self.nodes[prefer_node].alive:
            val = self.nodes[prefer_node].store.get_if_present(obj_id)
            if val is not MISSING:
                return val
        val = self._try_fetch(obj_id, prefer_node)
        if val is not MISSING:
            return val
        # zero-round-trip fast path: if the producing task is still queued
        # on some live node, steal it and run it inline on this thread —
        # no subscription, no wakeup handoff at all
        if self._try_steal_execute(obj_id):
            val = self._try_fetch(obj_id, prefer_node)
            if val is not MISSING:
                return val
        # slow path: subscribe, then re-check so nothing lands in the gap
        deadline = time.perf_counter() + timeout
        ev = threading.Event()
        sub = self.gcs.subscribe(f"obj:{obj_id}",
                                 lambda _k, _locs: ev.set())
        try:
            while True:
                ev.clear()
                val = self._try_fetch(obj_id, prefer_node)
                if val is not MISSING:
                    return val
                if self._try_steal_execute(obj_id):
                    continue  # produced inline; re-check immediately
                # object lost or not yet produced: trigger lineage replay
                # if its producing task already finished (R6)
                self.maybe_reconstruct(obj_id)
                if self.memory.unfetchable(obj_id):
                    # reclaimed (refcount zero / api.free / dead-evicted)
                    # with no lineage to recompute it: fail promptly
                    # instead of parking until the timeout
                    raise ObjectReclaimedError(
                        f"object {obj_id} was reclaimed and has no "
                        f"lineage to reconstruct it")
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise self._get_timeout(obj_id, timeout)
                ev.wait(timeout=remaining)
        finally:
            self.gcs.unsubscribe(sub)

    def _get_timeout(self, obj_id: str, timeout: float) -> GetTimeoutError:
        """Build the typed, diagnosable timeout: the producing task, its
        control-plane state, and (when it is mid-run) the node executing
        it — read off the error path only."""
        task_id = self.gcs.producing_task(obj_id)
        state = self.gcs.task_state(task_id) if task_id else None
        node_id = None
        if task_id is not None:
            node_id = next((n.node_id for n in self.nodes
                            if task_id in n.inflight), None)
        where = f" on node {node_id}" if node_id is not None else ""
        return GetTimeoutError(
            f"fetch({obj_id}) timed out after {timeout}s: producing task "
            f"{task_id} is {state}{where}",
            obj_id=obj_id, task_id=task_id, task_state=state,
            node_id=node_id)

    def _try_steal_execute(self, obj_id: str) -> bool:
        """Work-stealing get: if obj_id's producing task is PENDING in a
        live node's run queue (resources already granted by that node's
        local scheduler), pull it and execute it inline on the calling
        thread under that node's identity. Returns True if a task ran."""
        depth = getattr(_steal_ctx, "depth", 0)
        if depth >= _MAX_STEAL_DEPTH:
            return False
        task_id = self.gcs.producing_task(obj_id)
        if task_id is None:
            return False
        if self.gcs.task_state(task_id) != TASK_PENDING:
            return False
        spec = self.gcs.task_spec(task_id)
        if spec is not None and spec.actor_id is not None:
            # actor lane: drain ready in-order calls inline instead of
            # scanning run queues (actor methods never sit in them)
            _steal_ctx.depth = depth + 1
            try:
                return self._try_actor_inline(spec)
            finally:
                _steal_ctx.depth = depth
        # compiled-graph tasks: the target may be undispatched (held by
        # the invocation's dependency counters) while an *ancestor* from
        # the same invocation sits in a run queue — stealing any queued
        # task of the invocation advances the chain toward the target,
        # and inline chaining in execute_task usually runs the whole
        # remainder on this thread (zero handoffs for the graph case,
        # like the single-task steal)
        graph_inv = spec.graph_inv if spec is not None else None
        for node in self.nodes:
            if not node.alive:
                continue
            q = node.run_queue
            spec = None
            with q.mutex:
                for i, s in enumerate(q.queue):
                    if i >= _MAX_STEAL_SCAN:
                        break
                    if s is not None and (
                            s.task_id == task_id
                            or (graph_inv is not None
                                and s.graph_inv == graph_inv)):
                        spec = s
                        break
                if spec is not None:
                    q.queue.remove(spec)
            if spec is None:
                continue
            # log the spec actually pulled from the queue — for a graph
            # steal it may be an ancestor of the get() target, and the
            # timeline must attribute the inline run to the task that ran
            self.gcs.log_event("steal", spec.task_id,
                               f"node{node.node_id}")
            _steal_ctx.depth = depth + 1
            try:
                execute_task(node, spec, "steal")
            finally:
                _steal_ctx.depth = depth
            return True
        return False

    def _try_fetch(self, obj_id: str, prefer_node: Optional[int]) -> Any:
        """One attempt to serve obj_id from some live replica; returns the
        MISSING sentinel when no live copy exists. A replica vanishing
        between the location read and the store read (node killed/wiped
        concurrently) is reported as a miss so the caller's retry loop
        handles it, never as a KeyError."""
        locs = self.gcs.locations(obj_id)
        live = [n for n in locs
                if n < len(self.nodes) and self.nodes[n].alive]
        if not live:
            return MISSING
        try:
            if prefer_node in live:
                return self.nodes[prefer_node].store.get_if_present(obj_id)
            src = self.nodes[live[0]]
            if prefer_node is not None and self.nodes[prefer_node].alive:
                self.gcs.log_event("transfer", obj_id,
                                   f"node{live[0]}->node{prefer_node}")
                return self.nodes[prefer_node].store.fetch_from(
                    src.store, obj_id)
            return src.store.get_if_present(obj_id)
        except KeyError:  # replica wiped mid-transfer
            return MISSING

    # ---------------------------------------------------- fault tolerance

    def maybe_reconstruct(self, obj_id: str) -> None:
        """Lineage replay: if obj was produced by a finished task but all
        its copies are gone, resubmit that task (recursing through lost
        arguments happens naturally via the dataflow gate + fetch)."""
        task_id = self.gcs.producing_task(obj_id)
        if task_id is None:
            return
        state = self.gcs.task_state(task_id)
        if state not in (TASK_DONE, TASK_LOST):
            return  # still pending/running somewhere
        spec = self.gcs.task_spec(task_id)
        if spec.actor_id is not None:
            # actor-method results are not individually replayable (they
            # depend on actor state); kill/restart replays the logged
            # sequence, which re-stores this object and wakes the blocked
            # fetcher via add_location. The exception: a result produced
            # before a `__getstate__` checkpoint is outside every future
            # replay — store a clear error so fetchers fail fast instead
            # of hanging to their timeout.
            ckpt = self.gcs.actor_checkpoint(spec.actor_id)
            if (ckpt is not None and 0 <= spec.actor_seq < ckpt[0]
                    and not any(self._live_locs(rid)
                                for rid in spec.return_ids)):
                live = self.live_nodes()
                if live:
                    from repro_torch.core.worker import TaskError
                    err = TaskError(
                        f"actor method result {spec.task_id} "
                        f"({spec.func_name}, seq {spec.actor_seq}) was "
                        f"lost and predates the actor's checkpoint "
                        f"(seq {ckpt[0]}); it cannot be replayed")
                    self.gcs.log_event("actor_result_unrecoverable",
                                       spec.task_id, "lineage")
                    for rid in spec.return_ids:
                        if not self._live_locs(rid):
                            live[0].store.put(rid, err)
            return
        # all returns must be missing-or-lost to warrant replay
        if any(self._live_locs(rid) for rid in spec.return_ids):
            return
        # atomically transition DONE/LOST -> PENDING; only the winner replays
        won: List[int] = []

        def trans(s):
            if s in (TASK_DONE, TASK_LOST):
                won.append(1)
                return TASK_PENDING
            return s

        self.gcs.update(f"task_state:{task_id}", trans)
        if not won:
            return  # someone else is already replaying
        after_evict = self.memory.was_evicted_any(spec.return_ids)
        if after_evict:
            # evict-and-reconstruct repairs a *successful* task whose
            # output the store chose to drop — not a failure; it never
            # counts against the replay budget (a bounded store would
            # otherwise exhaust any budget under routine churn)
            self.gcs.log_event("reconstruct", task_id, "lineage",
                               after_evict=True)
            self.resubmit(spec)
            return
        attempts = self._count_replay(spec, "output lost before fetch")
        if not attempts:
            return  # sealed with TaskUnrecoverableError
        self.gcs.log_event("reconstruct", task_id, "lineage",
                           after_evict=False)
        self._resubmit_backoff(spec, attempts)

    def _live_locs(self, obj_id: str):
        return [n for n in self.gcs.locations(obj_id)
                if n < len(self.nodes) and self.nodes[n].alive]

    # --------------------------------------------- bounded retry policy

    def retry_budget(self, spec: TaskSpec) -> int:
        return (spec.max_retries if spec.max_retries >= 0
                else self.default_max_retries)

    def _count_replay(self, spec: TaskSpec, why: str) -> int:
        """Count one failure-replay attempt against the task's budget.
        Returns the attempt number (>= 1) while budget remains; on
        exhaustion seals the task with a TaskUnrecoverableError and
        returns 0 — the caller must not resubmit."""
        attempts = self.gcs.count_replay(spec.task_id)
        if attempts <= self.retry_budget(spec):
            return attempts
        self._seal_unrecoverable(spec, attempts - 1, why)
        return 0

    def _seal_unrecoverable(self, spec: TaskSpec, attempts: int,
                            why: str) -> None:
        """Replay budget spent: resolve the task *permanently* with a
        typed error instead of spinning. Mirrors the worker's error
        path — return ids get the error on a live node (waking blocked
        fetchers via add_location), graph dependents are released so
        they observe it, and the pins drop."""
        err = TaskUnrecoverableError(
            f"task {spec.task_id} ({spec.func_name}) exhausted its "
            f"replay budget ({attempts} attempts, max_retries="
            f"{self.retry_budget(spec)}): {why}")
        self.gcs.set_task_state(spec.task_id, TASK_DONE)
        live = self.live_nodes()
        for rid in spec.return_ids:
            if live and not self._live_locs(rid):
                live[0].store.put(rid, err)
        self.memory.on_task_done(spec)
        self.gcs.log_event("task_unrecoverable", spec.task_id, "lineage",
                           attempts=attempts)
        if spec.graph_inv is not None:
            for dep in self.graph_ready_after(spec):
                self.graph_dispatch(dep)

    def _resubmit_backoff(self, spec: TaskSpec, attempt: int) -> None:
        """Resubmit, delayed exponentially when the task carries a
        `backoff=` policy: attempt k waits backoff_s * 2**(k-1) (capped
        at 5s) on a timer thread — never on the caller's thread, which
        may be a blocked fetcher or the detector."""
        delay = (spec.backoff_s * (2 ** (attempt - 1))
                 if spec.backoff_s > 0 else 0.0)
        if delay <= 0:
            self.resubmit(spec)
            return
        t = threading.Timer(min(delay, 5.0), self.resubmit, args=(spec,))
        t.daemon = True
        t.start()

    def maybe_retry_exception(self, spec: TaskSpec, exc: BaseException,
                              where: str) -> bool:
        """Application-level bounded retry (`retry_exceptions`): when the
        raised exception matches the task's policy and budget remains,
        reset the task to PENDING and resubmit with backoff instead of
        storing a TaskError. Returns True when a retry was scheduled;
        False hands the caller back the store-an-error path (which uses
        TaskUnrecoverableError if the policy matched but the budget is
        spent)."""
        if not spec.retry_exceptions or not isinstance(
                exc, spec.retry_exceptions):
            return False
        attempts = self.gcs.count_replay(spec.task_id)
        if attempts > self.retry_budget(spec):
            return False
        self.gcs.set_task_state(spec.task_id, TASK_PENDING)
        self.gcs.log_event("retry", spec.task_id, where,
                           attempt=attempts, exc=type(exc).__name__)
        self._resubmit_backoff(spec, attempts)
        return True

    # ------------------------------------------------------- deadlines

    def expire_deadline(self, spec: TaskSpec, where: str) -> None:
        """Resolve a deadline-expired task promptly: atomically move any
        non-DONE state to DONE, store TaskDeadlineError on return ids
        with no live copy, and release graph dependents (they receive
        the error — same propagation rule as a raising task). A task
        that completed just in time wins the race: the transition is a
        no-op on DONE."""
        won: List[int] = []

        def trans(s):
            if s in (TASK_PENDING, TASK_RUNNING, TASK_LOST):
                won.append(1)
                return TASK_DONE
            return s

        self.gcs.update(f"task_state:{spec.task_id}", trans)
        if not won:
            return
        err = TaskDeadlineError(
            f"task {spec.task_id} ({spec.func_name}) missed its "
            f"{spec.deadline_s}s deadline")
        live = self.live_nodes()
        for rid in spec.return_ids:
            if live and not self._live_locs(rid):
                live[0].store.put(rid, err)
        self.memory.on_task_done(spec)
        self.gcs.log_event("task_deadline", spec.task_id, where)
        if spec.graph_inv is not None:
            for dep in self.graph_ready_after(spec):
                self.graph_dispatch(dep)

    def resubmit(self, spec: TaskSpec) -> None:
        # re-pin the task's arguments: the DONE path unpinned them, and
        # a replay must hold them resident again until it completes
        self.memory.pin_task(spec.task_id, spec)
        # lost args must be reconstructed before the dataflow gate sees
        # them — scan with _ref_ids so container-nested refs (which the
        # gate counts as dependencies) are reconstructed too
        dead = frozenset(n for n, node in enumerate(self.nodes)
                         if not node.alive)
        for oid in _ref_ids(spec):
            if not self._live_locs(oid):
                # subtract only dead nodes' locations: a concurrent
                # producer may have registered a fresh live copy between
                # the check above and this update, and clobbering the set
                # to empty would orphan it
                self.gcs.update(f"obj:{oid}",
                                lambda s: (s or frozenset()) - dead)
                self.maybe_reconstruct(oid)
        if (spec.submitter_node < len(self.nodes)
                and self.nodes[spec.submitter_node].alive):
            target = self.nodes[spec.submitter_node]
        else:
            live = self.live_nodes()
            if not live:
                # whole cluster down: park instead of crashing — the
                # task is already PENDING, so without this it would
                # hang unqueued forever (graph dependents gate on
                # invocation counters, not pub-sub, and would never
                # notice). add_node/restart_node drains the park.
                self.park_unschedulable(spec)
                return
            target = live[0]
        target.local_scheduler.submit(spec)

    def _drain_dead_node(self, node: Node) -> List[TaskSpec]:
        """Collect the tasks queued on a fail-stopped node (scheduler
        backlog + run queue) for resubmission."""
        requeue = node.local_scheduler.drain()
        requeue.extend(node.backend.drain_pending())
        for lane in node.device_lanes.values():
            requeue.extend(lane.drain_pending())
        return requeue

    def _resubmit_drained(self, specs: List[TaskSpec]) -> None:
        for spec in specs:
            if not self._count_replay(spec, "drained off a failed node"):
                continue  # sealed with TaskUnrecoverableError
            self.gcs.set_task_state(spec.task_id, TASK_PENDING)
            self.resubmit(spec)

    def kill_node(self, node_id: int) -> None:
        """Fail-stop a node: discard its objects and requeue its tasks.
        Idempotent: the detector, the chaos harness, and a driver may
        race to kill the same node — only the first does the work."""
        node = self.nodes[node_id]
        if not node.alive:
            return
        node.alive = False
        self.gcs.log_event("node_failure", f"node{node_id}", "cluster")
        lost = node.store.wipe()
        requeue = self._drain_dead_node(node)
        self._resubmit_drained(requeue)
        self._restart_actors(node.drain_actors(), node_id)
        self.gcs.log_event("node_drained", f"node{node_id}", "cluster",
                           lost_objects=lost, requeued=len(requeue))
        self._notify_death(node_id)

    def restart_node(self, node_id: int) -> None:
        """Stateless component restart (R6): fresh node under the same
        id. Fail-stop semantics whether or not the old node was already
        killed: in-flight results are discarded (lineage replay covers
        them), its store is wiped so no location points at the discarded
        store, its backlog/run-queue tasks are requeued, and its worker
        threads are shut down (they would otherwise linger on the dead
        run queue forever). Mirroring `add_node`, tasks parked for a
        resource this node provides are then replayed."""
        w, spill, lat, cap, backend = self._node_defaults
        old = self.nodes[node_id]
        was_alive = old.alive
        old.alive = False  # in-flight tasks on the old node become LOST
        old.store.wipe()   # no-op when kill_node already wiped
        requeue = self._drain_dead_node(old)
        dead_actors = old.drain_actors()  # before shutdown clears them
        old.shutdown()
        node = Node(self, node_id, dict(old.capacity), w, spill, lat, cap,
                    backend=backend)
        self.nodes[node_id] = node  # installed before resubmits target it
        self.detector.watch_node(node)
        self.gcs.log_event("node_restart", f"node{node_id}", "cluster",
                           requeued=len(requeue))
        self._resubmit_drained(requeue)
        # actors drained off the old node — plus any parked as
        # unschedulable by an earlier kill — may place onto the fresh one
        self._restart_actors(dead_actors, node_id)
        self._retry_parked_actors()
        self.drain_unschedulable()
        if was_alive:
            # a restart of a live node is a fail-stop the listeners did
            # not already see via kill_node
            self._notify_death(node_id)

    def shutdown(self) -> None:
        self.detector.shutdown()
        self.global_scheduler.shutdown()
        self.memory.shutdown()
        for n in self.nodes:
            n.shutdown()
