"""The paper's programming model (§3.1), extended with stateful actors:

  1. Task creation is non-blocking; a *future* (ObjectRef) returns
     immediately.
  2. Any function can be a remote task (`@remote`); futures as arguments
     create dataflow dependencies (R4/R5).
  3. Tasks can create tasks without blocking (R3).
  4. `get(ref)` blocks for the value.
  5. `wait(refs, num_returns, timeout)` returns (done, pending) — the
     straggler-mitigation primitive (R1/R4).
  6. `@remote` on a **class** yields an `ActorClass`: `.submit(*ctor)`
     places a long-lived stateful actor on a node (global scheduler's
     locality/load scoring) and returns an `ActorHandle`;
     `handle.method.submit(*args)` returns ObjectRefs exactly like task
     futures — composable with get/wait and usable as dependencies of
     downstream tasks. Method calls execute one at a time in a single
     total order (control-plane sequence numbers + a per-actor FIFO
     mailbox), even under concurrent callers. Actor state survives node
     failure by replaying the logged method sequence (or restoring an
     opt-in `__getstate__` checkpoint and replaying the tail) — the
     stateful analogue of lineage reconstruction (R6).
  7. Compiled graphs — the eager ``submit()`` path pays one
     control-plane registration + scheduling pass per task, every time.
     Workloads that re-run the same graph shape at high rate (serving
     pipelines, RL feedback loops) can compile the orchestration once
     and replay it:

         node = fn.bind(x)          # lazy GraphNode, nothing submitted
         cg = dag.compile(sink)     # topo order + placement + actor seq
         ref = cg.execute(inputs)   # ONE batched registration, grouped
                                    # per-node dispatch, inline chaining

     ``bind`` mirrors ``submit``'s argument rules (GraphNodes,
     ``dag.input(i)`` placeholders, ObjectRefs, plain values — top
     level or one level inside a plain list/tuple). ``execute`` returns
     ordinary ObjectRefs: they compose with get/wait/free, actor
     ordering, and lineage replay exactly like eager futures, and each
     invocation is epoch-tagged so one plan serves a whole loop. Prefer
     ``bind`` over ``submit`` when a multi-node graph is re-executed
     often enough to amortize one compile; stay eager for one-off or
     shape-changing task patterns. Failure semantics match the eager
     path: a killed node's compiled tasks replay via lineage, and a
     raising node stores a TaskError that propagates to the sink refs.
  8. Memory & GC — object stores are bounded, accounted LRU caches
     governed by distributed reference counting. Ownership rules:
       * a handle returned by ``submit()`` / ``put()`` **owns** one
         reference; dropping it (``del`` / scope exit) releases the
         count, and when the count hits zero with no pending task
         depending on the object it is reclaimed on every node;
       * refs passed as task arguments are **borrows** — the task table
         holds non-owning copies, and the object is pinned only until
         the consuming task completes;
       * a manually rebuilt ``ObjectRef(id)`` is a borrow: it neither
         counts nor keeps the object alive;
       * ``free(refs)`` reclaims eagerly without waiting for GC.
     Under memory pressure stores evict least-recently-used objects
     (preferring secondary replicas; in-flight task arguments are
     pinned); an evicted task output is transparently recomputed via
     lineage on the next fetch, while a reclaimed object with no
     lineage surfaces as a prompt ``ObjectReclaimedError``. Tasks can
     hint their output footprint with ``resources={"mem": nbytes}`` so
     placement steers big outputs toward nodes with free store bytes.
  9. Fault tolerance — failure handling is automatic and *bounded*.
     Detection: ``init(failure_detection=True)`` starts per-node
     heartbeat beaters and a cluster monitor thread; a node missing
     ``heartbeat_miss`` consecutive beats (interval
     ``heartbeat_interval_s``) — or, with ``hung_task_timeout_s`` set,
     holding any task past that bound — is declared dead and driven
     through the same ``kill_node`` + lineage-replay path a test invokes
     by hand. Retry/deadline policy, per function::

         fn.options(max_retries=3,              # replay budget
                    retry_exceptions=(IOError,),# app-level retry set
                    backoff=0.01,               # base for 2**k backoff
                    deadline=0.5)               # seconds from submit

     * ``max_retries`` bounds *failure replays*: lineage replays of a
       lost output, resubmits off a killed node, compiled-graph replay
       (``graph_on_lost``), actor replay, and ``retry_exceptions``
       retries all draw from one per-task attempt counter in the
       control plane (-1 = the cluster's ``default_max_retries``).
       Evict-and-reconstruct of a *successful* task's output never
       counts — eviction is the store's choice, not a failure.
     * ``retry_exceptions`` (True, a type, or a sequence of types)
       makes the worker re-run a task whose function raised a matching
       exception instead of storing the error, with exponential
       backoff ``backoff * 2**(attempt-1)`` seconds between attempts.
     * ``deadline`` (seconds from submit) resolves the task's futures
       promptly with ``TaskDeadlineError`` when it expires — whether
       the task is queued, running long, or lost.

     Error taxonomy — every failure surfaces as a typed exception, all
     raised by ``get``:
       * ``TaskError`` — the task's function raised; the traceback is
         stored as the result and re-raised at every getter.
       * ``TaskUnrecoverableError(TaskError)`` — the replay budget is
         exhausted; the runtime permanently resolved the task with this
         error instead of retrying forever.
       * ``TaskDeadlineError(TaskError)`` — the ``deadline=`` expired
         before a result was produced.
       * ``GetTimeoutError(TimeoutError)`` — ``get(ref, timeout=)``
         expired; carries ``task_id``/``task_state``/``node_id`` for
         the producing task so a hang is diagnosable.
       * ``ObjectReclaimedError`` — the object was freed/evicted and
         has no lineage to reconstruct it (see point 8).
     The seeded chaos harness (``repro_torch.core.chaos.FaultInjector``)
     exercises all of the above against a live cluster with
     deterministic kill/restart/delay/drop schedules.
  10. Process model — execution backends are pluggable per cluster:

          init(..., backend="thread")   # default: in-process workers
          init(..., backend="process")  # spawned worker processes over
                                        # a shared-memory object store

      The thread backend runs tasks on threads in the driver process —
      zero serialization, every Python object legal, but all task CPU
      shares one GIL. The process backend spawns real worker processes
      (spawn context) fed through per-worker shared-memory instruction
      rings; large values (>= 64 KiB) live in named shared-memory
      segments, and ``get()`` of a stored array returns a **read-only,
      zero-copy numpy view** over the segment — mutating it raises;
      copy (``arr.copy()``) or ``put()`` a new object instead. Choose
      the process backend for CPU-bound tasks over large arrays (true
      parallelism, no 64 MiB pickles); stay on threads for small/latency
      -sensitive tasks, closures, or unpicklable values.

      Spawn-safety contract (process backend): scripts must guard
      cluster creation with ``if __name__ == "__main__":`` (standard
      spawn rule — the child re-imports the main module, and an
      unguarded ``init`` would recursively spawn there); remote
      functions must be
      module-level (shipped by name or by pickle — ``<locals>`` closures
      are rejected with a ``SpawnSafetyError`` naming the function);
      task arguments and results must pickle (unpicklable values are
      rejected at dispatch, again by name). Actors run parent-side in
      both backends (their state never crosses the boundary), and
      nested ``submit()``/``get()`` inside a process-backend task is
      unsupported. A worker process dying mid-task is handled like a
      node failure: its in-flight tasks are replayed via lineage, and
      with ``failure_detection=True`` a node whose children all died
      stops heartbeating and is fail-stopped by the monitor.
  11. Serving — ``repro_torch.serving.FrontDoor`` is the open-loop
      request tier over actor-backed engine replicas: ``submit_request``
      either admits a request (bounded queue; past the bound it raises
      ``AdmissionError``) and returns a ``ServeTicket`` future, or the
      EDF deadline queue sheds it before dispatch (the ticket raises
      ``DeadlineShedError``; an admitted request is *never* dispatched
      past its deadline). Waves are length-aligned and sized by a
      Clipper-style AIMD controller probing each replica's measured
      latency against ``target_wave_s``; queue pressure autoscales
      replicas between ``min_replicas``/``max_replicas`` on the live
      cluster (planned scale-down retires actors via
      ``Cluster.retire_actor`` — released, not failed), and a replica
      lost to node death is replaced plus covered by a hot spare.
      ``FrontDoor.stats()``/``repro_torch.serving.slo.SLOTracker`` expose
      the disposition ledger (admitted = ok + late + shed + failed),
      sliding latency percentiles, and goodput — requests completed
      within deadline per second. Each replica's ``ServingEngine`` runs
      on the card on its own CUDA stream; ``repro_torch.serving.serve_llm``
      is the entry point, and seeded open-loop load shapes live in
      ``repro_torch.serving.load`` (Poisson / burst / diurnal traces;
      ``replay`` submits on the trace clock and never waits on
      completions).
  12. Devices & kernels — nodes declare *typed device capacity* and the
      scheduler treats it as a hard constraint (the paper's R5)::

          init(node_resources=[{"cpu": 8.0, "gpu": 1.0},   # gpu node
                               {"cpu": 8.0}])              # cpu node
          cluster.add_node({"cpu": 8.0, "tpu": 4.0})       # elastic join

      * Device keys ("gpu"/"tpu"/"accel", see ``repro_torch.core.devices``)
        are capacity like any other resource — but each device-holding
        node additionally runs its device tasks on a dedicated
        *executor lane* (one pinned thread per device key), so a kernel
        never time-slices against the cpu worker pool and two kernel
        tasks never contend for one device context.
      * Passing ``node_resources=`` declares the topology *explicitly*,
        which flips placement to **strict**: a task whose request no
        declared node (live or dead — dead nodes restart with their
        declared capacity) can ever satisfy is promptly sealed with
        ``UnschedulableTaskError`` instead of parking forever. Without
        ``node_resources=`` the cluster stays *elastic*: impossible
        requests park and drain when a capable node joins.
      * ``repro_torch.compute.kernel_task`` wraps a PyTorch callable
        (a wrapper of a hand-written CUDA kernel, or any torch code)
        into a device-typed remote function. PyTorch runs eagerly, so
        the payload is called as it is (``warmup_args=`` runs it once
        at registration, which builds the CUDA kernels and libraries
        at first use); after it returns, the task synchronises the
        card when any leaf of the result is a CUDA tensor, so
        completion means the device finished, and it is timed as a
        profiler "kernel" event (``profiler.summarize`` ->
        ``kernel_tasks`` / ``kernel_time_ms_mean`` /
        ``device_waits``). The lane thread starts with PyTorch's
        thread-local defaults (grad mode on, the default stream), not
        the caller's. On CPU tensors the kernels' wrappers run their
        plain versions, so kernel tasks run everywhere the tests do.
      * ``repro_torch.compute.ParamSet`` publishes a parameter pytree as
        sharded, versioned objects: leaves pack into contiguous
        per-shard byte buffers in the object store (refcounted,
        evictable, zero-copy readable — a fetch leaf is a dtype-cast
        slice view of its shard), with the handle in the control plane
        under ``paramset:{name}``. ``publish`` again bumps the version
        and drops the old shards' owning refs (GC reclaims them);
        consumers hot-swap via ``ParamSet.latest(name)``. The
        publisher's cluster owns the shards — borrowers that must
        outlive the next publish should copy.
  13. Streaming online learning — the reference's train-while-serve
      plane is not in this package yet. ``ParamSet.fetch(version=...)``
      is version-pinned all the same: shards are pinned before the
      read and verified live, so a concurrent republish surfaces as
      typed ``ParamVersionRetiredError`` (re-fetch latest), never a
      torn read; the last ``KEEP_VERSION_HANDLES`` version handles
      stay queryable.

Usage:
    cluster = init(num_nodes=4, workers_per_node=2)

    @remote
    def sim(policy, seed): ...

    @remote
    class Learner:
        def __init__(self): self.w = init_weights()
        def update(self, batch): self.w = step(self.w, batch)
        def weights(self): return self.w

    learner = Learner.submit()
    w_ref = learner.weights.submit()          # ordered method future
    refs = [sim.submit(w_ref, i) for i in range(100)]
    done, pending = wait(refs, num_returns=80, timeout=0.05)
    learner.update.submit(tuple(get(done)))
"""
from __future__ import annotations

import functools
import itertools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.runtime import Cluster
from repro_torch.core.worker import current_node, current_task

_global: Dict[str, Optional[Cluster]] = {"cluster": None}


def init(num_nodes: int = 2, workers_per_node: int = 2, **kw) -> Cluster:
    if _global["cluster"] is not None:
        shutdown()
    _global["cluster"] = Cluster(num_nodes, workers_per_node, **kw)
    return _global["cluster"]


def attach(cluster: Cluster) -> None:
    _global["cluster"] = cluster


def shutdown() -> None:
    if _global["cluster"] is not None:
        _global["cluster"].shutdown()
        _global["cluster"] = None


def _cluster() -> Cluster:
    c = _global["cluster"]
    if c is None:
        raise RuntimeError("repro_torch.core not initialized; call init()")
    return c


@dataclass(frozen=True)
class ObjectRef:
    """Future handle. Instances returned by ``submit()``/``put()`` are
    *owning* (the MemoryManager stamped itself on them at adoption);
    everything else — manual ``ObjectRef(id)`` construction, copies,
    refs embedded in task specs — is a borrow that neither counts nor
    keeps the object alive."""
    id: str

    def __repr__(self):
        return f"ObjectRef({self.id})"

    def __del__(self):
        # owning handles release their count; deferred via the manager's
        # reclaim queue because __del__ can fire on any thread while
        # arbitrary locks are held. Borrows have no _owner stamp.
        # `release` itself is a silent no-op after shutdown and during
        # interpreter finalization (when the reclaim queue and threading
        # may already be torn down), so a lingering handle dropped at
        # teardown never surfaces an "Exception ignored in __del__".
        try:
            owner = self.__dict__.get("_owner")
            if owner is not None:
                owner.release(self.id)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __copy__(self):
        return ObjectRef(self.id)       # copies are borrows

    def __deepcopy__(self, _memo):
        return ObjectRef(self.id)       # copies are borrows


def _borrow(arg):
    """Non-owning copy of an ObjectRef argument (refs one level inside
    plain list/tuple included). Task specs live in the task table for
    the cluster's lifetime, so an owning handle captured there would pin
    the object's refcount above zero forever."""
    if isinstance(arg, ObjectRef):
        return ObjectRef(arg.id)
    if type(arg) in (list, tuple) and any(
            isinstance(e, ObjectRef) for e in arg):
        return type(arg)(ObjectRef(e.id) if isinstance(e, ObjectRef) else e
                         for e in arg)
    return arg


def _borrowed_args(args, kwargs):
    if not args and not kwargs:      # argless submit: zero allocations
        return args, kwargs
    return (tuple(_borrow(a) for a in args),
            {k: _borrow(v) for k, v in kwargs.items()})


def _check_no_deep_refs(args, kwargs) -> None:
    """The dependency scanner and worker resolve() see top-level ObjectRef
    arguments and refs one level inside *plain* list/tuple arguments. A
    ref anywhere else (nested deeper, in a dict/set, in a tuple subclass
    like a namedtuple) would silently arrive as an unresolved ObjectRef
    object, so reject it loudly at submit time."""
    for a in itertools.chain(args, kwargs.values()):
        if isinstance(a, ObjectRef):
            continue                        # resolved
        if type(a) in (list, tuple):
            for e in a:
                if isinstance(e, ObjectRef):
                    continue                # resolved (one level deep)
                if _holds_ref(e):
                    raise TypeError(
                        "ObjectRef nested more than one container level "
                        "deep in task arguments is not resolved; pass it "
                        "at the top level or one level inside a plain "
                        "list/tuple")
        elif _holds_ref(a):
            raise TypeError(
                f"ObjectRef inside a {type(a).__name__} argument is not "
                "resolved; pass it at the top level or one level inside "
                "a plain list/tuple")


def _holds_ref(obj) -> bool:
    if isinstance(obj, ObjectRef):
        return True
    if isinstance(obj, dict):
        return any(_holds_ref(k) or _holds_ref(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return any(_holds_ref(e) for e in obj)
    return False


def _holds_graph_node(obj) -> bool:
    """Deep probe for graph placeholders in bound arguments (the graph
    analogue of ``_holds_ref`` — dag.py rejects placeholders nested
    deeper than the substitution pass reaches)."""
    from repro_torch.core.dag import _GRAPHY
    if isinstance(obj, _GRAPHY):
        return True
    if isinstance(obj, dict):
        return any(_holds_graph_node(k) or _holds_graph_node(v)
                   for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return any(_holds_graph_node(e) for e in obj)
    return False


def _normalize_retry_exceptions(value) -> Optional[Tuple[type, ...]]:
    """`retry_exceptions=True` retries any Exception; a type or sequence
    of types retries exactly those; None/False disables app-level
    retry. Normalized to a tuple so isinstance() takes it directly."""
    if value is None or value is False:
        return None
    if value is True:
        return (Exception,)
    if isinstance(value, type):
        return (value,)
    return tuple(value)


class RemoteFunction:
    def __init__(self, fn, num_returns: int = 1,
                 resources: Optional[Dict[str, float]] = None,
                 max_retries: int = -1, retry_exceptions=None,
                 backoff: float = 0.0, deadline: float = 0.0):
        self._fn = fn
        self.name = f"{fn.__module__}.{fn.__qualname__}"
        self.num_returns = num_returns
        self.resources = {"cpu": 1.0} if resources is None else dict(resources)
        # "mem" is a placement hint (expected output bytes scored
        # against store free space), not a capacity resource — split it
        # out so satisfies()/try_acquire() never see it
        self.mem_bytes = int(self.resources.pop("mem", 0))
        # bounded retry / deadline policy (see the "Fault tolerance"
        # section of the module docstring): threaded into every TaskSpec
        # this function submits (eagerly or via bind/compile)
        self.max_retries = max_retries
        self.retry_exceptions = _normalize_retry_exceptions(retry_exceptions)
        self.backoff = backoff
        self.deadline = deadline
        self._registered_on: Optional[int] = None
        functools.update_wrapper(self, fn)

    def options(self, *, num_returns: Optional[int] = None,
                resources: Optional[Dict[str, float]] = None,
                max_retries: Optional[int] = None,
                retry_exceptions=None,
                backoff: Optional[float] = None,
                deadline: Optional[float] = None
                ) -> "RemoteFunction":
        # explicit `is None` merge: a falsy override (resources={},
        # retry_exceptions=False, backoff=0) must take effect, not be
        # silently replaced by the old value
        rf = RemoteFunction(
            self._fn,
            self.num_returns if num_returns is None else num_returns,
            self.resources if resources is None else resources,
            self.max_retries if max_retries is None else max_retries,
            (self.retry_exceptions if retry_exceptions is None
             else retry_exceptions),
            self.backoff if backoff is None else backoff,
            self.deadline if deadline is None else deadline)
        if resources is None:  # inherited resources keep their mem hint
            rf.mem_bytes = self.mem_bytes
        return rf

    def submit(self, *args, **kwargs):
        """Non-blocking task creation; returns future(s) immediately."""
        _check_no_deep_refs(args, kwargs)
        cluster = _cluster()
        gcs = cluster.gcs
        # register once per cluster, keyed by the cluster's monotonic
        # epoch token (an `is id(cluster)` check compared a fresh int by
        # identity — always true, re-registering on every submit — and
        # id() reuse after teardown could falsely skip registration)
        if self._registered_on != cluster.epoch:
            gcs.register_function(self.name, self._fn)
            self._registered_on = cluster.epoch
        task_id = gcs.next_id("t")
        ret_ids = tuple(f"{task_id}.r{i}" for i in range(self.num_returns))
        node = current_node()
        submitter = node.node_id if node is not None else 0
        from repro_torch.core.control_plane import TaskSpec
        if node is None:
            # driver-submitted work round-robins across live nodes (worker
            # submissions always enter through their own local scheduler)
            live = cluster.live_nodes()
            entry = live[int(task_id[1:]) % len(live)]
            submitter = entry.node_id
        else:
            entry = node
        # adopt the returned handles BEFORE the task can run: a worker
        # finishing first would otherwise see refcount 0 and hand the
        # fresh output straight to the reclaimer
        refs = tuple(ObjectRef(r) for r in ret_ids)
        mm = cluster.memory
        for r in refs:
            mm.adopt(r)
        bargs, bkwargs = _borrowed_args(args, kwargs)
        spec = TaskSpec(task_id=task_id, func_name=self.name, args=bargs,
                        kwargs=bkwargs, return_ids=ret_ids,
                        resources=self.resources, submitter_node=submitter,
                        mem_bytes=self.mem_bytes,
                        max_retries=self.max_retries,
                        retry_exceptions=self.retry_exceptions,
                        backoff_s=self.backoff,
                        deadline_s=self.deadline)
        # pin BEFORE the task becomes visible: with registration first,
        # another thread dropping the last owning handle of an argument
        # in the gap let the reclaimer collect it out from under the
        # not-yet-pinned task (a spurious ObjectReclaimedError for
        # lineage-less objects)
        mm.pin_task(task_id, spec)  # args stay resident until DONE
        gcs.register_task(spec)
        if spec.deadline_s:
            # only deadline-carrying tasks ever touch the detector
            cluster.detector.track_deadline(spec)
        gcs.log_event("submit", task_id, f"node{submitter}")
        entry.local_scheduler.submit(spec)
        return refs[0] if self.num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Lazy graph construction: returns a GraphNode for use with
        ``dag.compile`` — nothing is registered or scheduled. Argument
        rules mirror ``submit``, plus GraphNodes and ``dag.input(i)``
        placeholders are legal wherever an ObjectRef is."""
        from repro_torch.core.dag import GraphNode
        return GraphNode(func_name=self.name, fn=self._fn,
                         num_returns=self.num_returns,
                         resources=self.resources,
                         mem_bytes=self.mem_bytes,
                         max_retries=self.max_retries,
                         retry_exceptions=self.retry_exceptions,
                         backoff_s=self.backoff,
                         deadline_s=self.deadline,
                         args=args, kwargs=kwargs)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


class ActorClass:
    """`@remote` applied to a class. `.submit(*ctor_args)` creates one
    actor instance somewhere in the cluster and returns an ActorHandle;
    calling the ActorClass itself instantiates locally (mirroring
    RemoteFunction.__call__)."""

    def __init__(self, cls, resources: Optional[Dict[str, float]] = None,
                 checkpoint_interval: int = 0):
        self._cls = cls
        self.name = f"{cls.__module__}.{cls.__qualname__}"
        self.resources = {"cpu": 1.0} if resources is None else dict(resources)
        self.checkpoint_interval = checkpoint_interval
        self._registered_on: Optional[int] = None
        functools.update_wrapper(self, cls, updated=())

    def options(self, *, resources: Optional[Dict[str, float]] = None,
                checkpoint_interval: Optional[int] = None) -> "ActorClass":
        return ActorClass(
            self._cls,
            self.resources if resources is None else resources,
            self.checkpoint_interval if checkpoint_interval is None
            else checkpoint_interval)

    def submit(self, *args, **kwargs) -> "ActorHandle":
        """Create the actor: placement via the global scheduler's
        resource/locality scoring, construction on the chosen node's
        dedicated actor thread. Non-blocking — the handle returns
        immediately; a constructor failure surfaces as a TaskError on the
        first method result, and an actor no live node can host parks
        until capacity joins (calls meanwhile are logged and replayed)."""
        _check_no_deep_refs(args, kwargs)
        cluster = _cluster()
        gcs = cluster.gcs
        if self._registered_on != cluster.epoch:
            gcs.register_function(self.name, self._cls)
            self._registered_on = cluster.epoch
        actor_id = gcs.next_id("a")
        node = current_node()
        submitter = node.node_id if node is not None else 0
        from repro_torch.core.control_plane import ActorSpec
        args, kwargs = _borrowed_args(args, kwargs)
        aspec = ActorSpec(actor_id=actor_id, class_name=self.name,
                          args=args, kwargs=kwargs,
                          resources=self.resources,
                          submitter_node=submitter,
                          checkpoint_interval=self.checkpoint_interval)
        cluster.create_actor(aspec)
        return ActorHandle(actor_id, self.name, self._cls)

    def __call__(self, *args, **kwargs):
        return self._cls(*args, **kwargs)


class ActorMethod:
    """One bound remote method; `.submit()` returns an ObjectRef exactly
    like a task future."""

    __slots__ = ("_handle", "_name")

    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def submit(self, *args, **kwargs) -> "ObjectRef":
        """Non-blocking ordered method call. The control plane issues the
        actor-wide sequence number (total order across concurrent
        callers) and logs the call for replay *before* it is routed to
        the owning node's FIFO mailbox — so a call racing a node failure
        is never lost, only replayed."""
        _check_no_deep_refs(args, kwargs)
        cluster = _cluster()
        gcs = cluster.gcs
        h = self._handle
        task_id = gcs.next_id("t")
        ret_id = f"{task_id}.r0"
        node = current_node()
        submitter = node.node_id if node is not None else 0
        seq = gcs.next_actor_seq(h.actor_id)
        ref = ObjectRef(ret_id)
        cluster.memory.adopt(ref)   # before the method can complete
        bargs, bkwargs = _borrowed_args(args, kwargs)
        from repro_torch.core.control_plane import TaskSpec
        spec = TaskSpec(task_id=task_id,
                        func_name=f"{h.class_name}.{self._name}",
                        args=bargs, kwargs=bkwargs, return_ids=(ret_id,),
                        resources={},  # rides the actor's standing grant
                        submitter_node=submitter,
                        actor_id=h.actor_id, actor_method=self._name,
                        actor_seq=seq)
        # pin before the call becomes visible (same ordering rule as
        # RemoteFunction.submit: a concurrent handle drop must find the
        # argument pinned)
        cluster.memory.pin_task(task_id, spec)
        gcs.register_task(spec)
        gcs.log_actor_call(h.actor_id, seq, task_id)
        gcs.log_event("submit_actor", task_id, f"node{submitter}",
                      actor=h.actor_id, seq=seq)
        cluster.submit_actor_task(spec)
        return ref

    def bind(self, *args, **kwargs):
        """Lazy actor-method graph node for ``dag.compile``. The call's
        sequence number is reserved per invocation at ``execute()`` (a
        contiguous block per actor, assigned in plan order), so compiled
        calls interleave with eager ``submit`` calls in one total
        order."""
        from repro_torch.core.dag import GraphNode
        h = self._handle
        return GraphNode(func_name=f"{h.class_name}.{self._name}",
                         actor_handle=h, actor_method=self._name,
                         args=args, kwargs=kwargs)


class ActorHandle:
    """Reference to a live actor. Attribute access yields ActorMethods:
    `handle.incr.submit(1)`."""

    def __init__(self, actor_id: str, class_name: str, cls=None):
        self.actor_id = actor_id
        self.class_name = class_name
        self._cls = cls

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if self._cls is not None and not callable(
                getattr(self._cls, name, None)):
            raise AttributeError(
                f"{self.class_name} has no method {name!r}")
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self.actor_id}, {self.class_name})"


def remote(fn=None, *, num_returns: int = 1,
           resources: Optional[Dict[str, float]] = None,
           checkpoint_interval: int = 0, max_retries: int = -1,
           retry_exceptions=None, backoff: float = 0.0,
           deadline: float = 0.0):
    """Decorator designating a function as a remote task (R4), or a class
    as an actor (stateful task sequence). `checkpoint_interval` applies to
    classes only: every K completed method calls the actor's
    `__getstate__` is checkpointed to the control plane, bounding the
    replay a restart performs. `max_retries`/`retry_exceptions`/
    `backoff`/`deadline` apply to functions only — see the "Fault
    tolerance" section above."""
    def wrap(f):
        if isinstance(f, type):
            return ActorClass(f, resources, checkpoint_interval)
        return RemoteFunction(f, num_returns, resources, max_retries,
                              retry_exceptions, backoff, deadline)
    if fn is None:
        return wrap
    return wrap(fn)


def put(value: Any) -> ObjectRef:
    """Store a value and return its future. Worker puts stay node-local;
    driver puts round-robin across live nodes (mirroring driver submit)
    instead of pinning every object on the first node."""
    cluster = _cluster()
    oid = cluster.gcs.next_id("o")
    node = current_node()
    if node is None:
        live = cluster.live_nodes()
        node = live[int(oid[1:]) % len(live)]
    ref = ObjectRef(oid)
    cluster.memory.adopt(ref)   # the returned handle owns the object
    if not node.store.put(oid, value):
        # the chosen store was wiped by a concurrent node kill (put on a
        # wiped store refuses, so the data never landed): place the
        # object on any surviving node rather than returning a handle
        # nothing can ever fetch
        if not any(n.store.put(oid, value) for n in cluster.live_nodes()):
            raise RuntimeError(
                "put() failed: no live node accepted the object")
    return ref


def free(refs) -> None:
    """Eagerly reclaim objects without waiting for handle GC: drops the
    reference count to zero, marks the ids freed, and discards every
    unpinned copy cluster-wide (a copy pinned by a still-pending task is
    reclaimed when that task completes). A later `get` on a freed object
    with no lineage raises ObjectReclaimedError promptly; `wait` counts
    freed futures as done. Accepts one ref or a sequence."""
    cluster = _cluster()
    if isinstance(refs, ObjectRef):
        refs = [refs]
    cluster.memory.free([r.id for r in refs])


def get(ref, timeout: float = 60.0):
    """Blocking retrieval of a future's value (§3.1 point 4). A worker
    blocking here releases its resources + hands its core to a spare
    worker, so nested get() cannot deadlock the pool. Node-local objects
    are served with a single store read — no control-plane round trip, no
    pub-sub churn."""
    cluster = _cluster()
    if isinstance(ref, (list, tuple)):
        # one shared deadline across the whole batch — not a fresh full
        # timeout per element (which made the worst case N x timeout)
        deadline = time.perf_counter() + timeout
        return type(ref)(
            get(r, max(0.0, deadline - time.perf_counter())) for r in ref)
    from repro_torch.core.object_store import MISSING
    from repro_torch.core.worker import TaskError
    node = current_node()
    if node is not None:
        val = node.store.get_if_present(ref.id)
        if val is not MISSING:
            if isinstance(val, TaskError):
                raise val
            return val
        spec = current_task()
        node.enter_blocked(spec)
        try:
            val = cluster.fetch(ref.id, prefer_node=node.node_id,
                                timeout=timeout)
        finally:
            node.exit_blocked(spec)
    else:
        val = cluster.fetch(ref.id, timeout=timeout)
    if isinstance(val, TaskError):
        raise val
    return val


def wait(refs: Sequence[ObjectRef], num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """Block until `num_returns` futures are complete or `timeout` elapses;
    returns (done, pending). Straggler-aware dynamic control flow (§3.1.5).

    Event-driven via the control plane's completion-notify channel: each
    completion wakes this call with one targeted notify — no per-ref
    callback closures, no object-shard subscriber churn, no broadcast
    notify_all. Futures already complete on entry are counted with one
    object-table read each, and if they alone satisfy `num_returns` no
    waiter is ever registered. `num_returns` counts *unique* futures, so
    duplicate refs in the input cannot make the call unreachable; the
    returned partition stays aligned with the input list (a duplicated
    done ref appears twice in `done`)."""
    cluster = _cluster()
    gcs = cluster.gcs
    unique_ids = {r.id for r in refs}
    num_returns = min(num_returns, len(unique_ids))
    # freed (explicitly reclaimed) futures count as done: nothing will
    # ever add a location for them, and a waiter must not hang on a
    # future its own pipeline already consumed and freed
    done_set = {i for i in unique_ids
                if gcs.locations(i) or gcs.is_freed(i)}

    def partition(snapshot):
        # partition against a frozen snapshot: a completion landing
        # mid-partition must not leave a ref in neither list
        done = [r for r in refs if r.id in snapshot]
        pending = [r for r in refs if r.id not in snapshot]
        return done, pending

    if len(done_set) >= num_returns or (timeout is not None and timeout <= 0):
        return partition(set(done_set))

    from repro_torch.core.control_plane import CompletionWaiter
    pending_ids = [i for i in unique_ids if i not in done_set]
    waiter = CompletionWaiter()
    gcs.add_waiters(waiter, pending_ids)
    try:
        # re-check after registering: a completion that landed in the gap
        # fired no notify, so fold it in by hand
        for oid in pending_ids:
            if gcs.locations(oid) or gcs.is_freed(oid):
                waiter.complete(oid)
        deadline = None if timeout is None else time.perf_counter() + timeout
        with waiter.cond:
            while len(done_set) + len(waiter.done) < num_returns:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    break
                waiter.cond.wait(timeout=remaining)
            snapshot = done_set | waiter.done
    finally:
        gcs.remove_waiters(waiter, pending_ids)
    return partition(snapshot)
