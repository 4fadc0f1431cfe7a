"""Worker processes (threads here): execute tasks, create new tasks.

A worker resolves the task's ObjectRef arguments from the object store
(dependencies are guaranteed available by the dataflow gate in the local
scheduler — possibly on another node, triggering a transfer), runs the
function, stores the returns, and flips the task state in the control
plane. Workers carry a thread-local "current node" so that tasks creating
tasks (R3) submit through their node's local scheduler, bottom-up.

Actors get a dedicated execution context (`ActorContext`): one thread per
actor that constructs the instance (or restores it from a checkpoint) and
executes mailbox-released method calls strictly in sequence order.
Execution is mutex-guarded rather than thread-pinned, so a getter blocked
on a method result can inline-drain ready calls (the same work-stealing
trick the task path uses) — ordering is preserved because only the mutex
holder pops from the mailbox, and the mailbox releases in seq order.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
import traceback
from typing import TYPE_CHECKING, Any, Optional

from repro_torch.core.control_plane import (TASK_DONE, TASK_LOST, TASK_RUNNING,
                                      ActorSpec, TaskSpec)
from repro_torch.core.scheduler import ActorMailbox

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.runtime import Node

_worker_ctx = threading.local()


def current_node() -> Optional["Node"]:
    return getattr(_worker_ctx, "node", None)


def current_task() -> Optional[TaskSpec]:
    return getattr(_worker_ctx, "spec", None)


class TaskError(Exception):
    pass


class TaskUnrecoverableError(TaskError):
    """The task exhausted its replay budget (``max_retries``): the
    runtime will not attempt it again. Stored on the task's return ids
    like any task failure, so every current and future fetcher fails
    promptly instead of re-triggering lineage replay forever."""


class TaskDeadlineError(TaskError):
    """The task's ``deadline=`` expired before it produced a result.
    The failure detector (or the dequeueing worker) resolves the return
    ids with this error, so getters unblock promptly instead of riding
    their own timeout."""


class UnschedulableTaskError(TaskError):
    """No node in the cluster — live or dead — declares enough capacity
    for the task's resource request, and the cluster topology was
    declared explicitly (``node_resources=``), so waiting for elastic
    scale-up is not the contract. Sealed on the return ids promptly at
    placement time instead of parking the task forever."""


class GetTimeoutError(TimeoutError):
    """``get(ref, timeout=)`` expired. Subclasses TimeoutError (existing
    callers keep working) and carries the producing task's control-plane
    state — PENDING/RUNNING/LOST plus the node currently running it —
    so a hang under failure is diagnosable from the exception alone."""

    def __init__(self, msg: str, obj_id: Optional[str] = None,
                 task_id: Optional[str] = None,
                 task_state: Optional[str] = None,
                 node_id: Optional[int] = None):
        super().__init__(msg)
        self.obj_id = obj_id
        self.task_id = task_id
        self.task_state = task_state
        self.node_id = node_id


def finish_success(node: "Node", spec: TaskSpec, where: str) -> tuple:
    """DONE bookkeeping once a task's results are stored on its return
    ids: flip the control-plane state, run the GC hook, release
    compiled-graph dependents. Shared by the in-thread execution path
    and the process backend's completion-drain threads. Returns the
    graph dependents whose last dependency edge this completion
    satisfied."""
    gcs = node.gcs
    gcs.set_task_state(spec.task_id, TASK_DONE)
    # GC hook: unpin args, collect fire-and-forget outputs whose
    # handles were already dropped (LOST paths keep their pins —
    # the resubmit still depends on the args)
    node.cluster.memory.on_task_done(spec)
    ready: tuple = ()
    if spec.graph_inv is not None:
        ready = node.cluster.graph_ready_after(spec)
    gcs.log_event("finish", spec.task_id, where)
    return ready


def finish_lost(node: "Node", spec: TaskSpec, where: str,
                error: bool = False) -> None:
    """A task finished (or failed) on a dead node, or its worker process
    died under it: the result is discarded, the task is LOST. Push-based
    loss notification wakes any fetcher blocked on the outputs so it can
    trigger lineage replay immediately (no polling fallback exists);
    graph intermediates may have no fetcher, so the loss itself
    resubmits them."""
    gcs = node.gcs
    gcs.set_task_state(spec.task_id, TASK_LOST)
    if error:
        gcs.log_event("error", spec.task_id, where, lost=True)
    for rid in spec.return_ids:
        gcs.notify_lost(rid)
    if spec.graph_inv is not None:
        node.cluster.graph_on_lost(spec)


def fail_task(node: "Node", spec: TaskSpec, exc: Exception, where: str,
              tb: Optional[str] = None) -> tuple:
    """A task raised on a live node. First offer the exception to the
    bounded application-level retry machinery (`retry_exceptions`); if
    the task was resubmitted, store nothing and keep the arg pins.
    Otherwise store a TaskError (or TaskUnrecoverableError when the
    retry budget is exhausted) on every return id — error propagation
    matches eager: dependents run and receive the stored error as their
    argument value. Returns ``(retried, ready_graph_dependents)``."""
    gcs = node.gcs
    cluster = node.cluster
    if cluster.maybe_retry_exception(spec, exc, where):
        return True, ()
    if tb is None:
        tb = traceback.format_exc()
    if spec.retry_exceptions and isinstance(exc, spec.retry_exceptions):
        err: TaskError = TaskUnrecoverableError(
            f"task {spec.task_id} ({spec.func_name}) exhausted "
            f"its retry budget:\n" + tb)
    else:
        err = TaskError(
            f"task {spec.task_id} ({spec.func_name}) failed:\n" + tb)
    for rid in spec.return_ids:
        node.store.put(rid, err)
    gcs.set_task_state(spec.task_id, TASK_DONE)
    cluster.memory.on_task_done(spec)
    ready: tuple = ()
    if spec.graph_inv is not None:
        ready = cluster.graph_ready_after(spec)
    gcs.log_event("error", spec.task_id, where)
    return False, ready


def execute_task(node: "Node", spec: TaskSpec, who: str) -> None:
    """Run one dispatched task to completion on the calling thread —
    shared by worker threads and the work-stealing get() fast path. The
    caller must own the task's resource grant (the local scheduler
    acquired it before enqueue); this function releases it.

    Compiled-graph inline chaining: when the finished task's completion
    satisfies the last dependency edge of a node planned on this same
    node, the dependent runs immediately on this thread — no run-queue
    round trip, no scheduler pass, no worker wakeup. Cross-node (or
    resource-contended) dependents are routed through the plan's
    `submit_ready` path instead."""
    nxt = _execute_one(node, spec, who)
    while nxt is not None:
        node.gcs.log_event("graph_chain", nxt.task_id,
                           f"node{node.node_id}/{who}")
        nxt = _execute_one(node, nxt, who)


def _execute_one(node: "Node", spec: TaskSpec,
                 who: str) -> Optional[TaskSpec]:
    """One task, start to finish; returns a same-node compiled-graph
    dependent to chain into (resources already acquired), or None. The
    worker context is saved/restored so a thief thread keeps its own
    identity afterwards."""
    gcs = node.gcs
    cluster = node.cluster
    where = f"node{node.node_id}/{who}"
    prev_node = getattr(_worker_ctx, "node", None)
    prev_spec = getattr(_worker_ctx, "spec", None)
    _worker_ctx.node = node
    _worker_ctx.spec = spec
    ready = ()
    nxt: Optional[TaskSpec] = None
    try:
        if (spec.deadline_s
                and time.perf_counter() - spec.created_ts > spec.deadline_s):
            # expired before it ever ran: resolve with TaskDeadlineError
            # instead of burning a worker on a result nobody can use
            # (graph dependents are dispatched by expire_deadline, never
            # chained — the deadline path is cold)
            cluster.expire_deadline(spec, where)
            return None
        gcs.set_task_state(spec.task_id, TASK_RUNNING)
        # hung-task watchdog bookkeeping: one GIL-atomic dict write here,
        # one pop in the finally — the detector's monitor thread does all
        # the scanning
        node.inflight[spec.task_id] = time.perf_counter()
        gcs.log_event("start", spec.task_id, where)
        fn = gcs.function(spec.func_name)
        args = [node.resolve(a) for a in spec.args]
        kwargs = {k: node.resolve(v) for k, v in spec.kwargs.items()}
        out = fn(*args, **kwargs)
        if node.alive:  # a dead node's results are discarded
            rets = (out,) if len(spec.return_ids) == 1 else tuple(out)
            for rid, val in zip(spec.return_ids, rets):
                node.store.put(rid, val)
            ready = finish_success(node, spec, where)
        else:
            finish_lost(node, spec, where)
    except Exception as exc:  # noqa: BLE001
        if node.alive:  # mirror the success path's liveness check
            retried, ready = fail_task(node, spec, exc, where)
            if retried:
                # bounded application-level retry (`retry_exceptions`):
                # the task went back to PENDING and was resubmitted
                # (after backoff) — store nothing, keep the arg pins
                return None
        else:
            # a killed node's failing task is LOST, not DONE: discard the
            # error, wake blocked fetchers so lineage replay reruns the
            # task on a live node
            finish_lost(node, spec, where, error=True)
    finally:
        _worker_ctx.node = prev_node
        _worker_ctx.spec = prev_spec
        node.inflight.pop(spec.task_id, None)
        node.release(spec.resources)
        # pick at most one same-node dependent to chain into (acquire
        # its grant before the backlog can claim the freed resources);
        # everything else — including deps with a still-pending
        # external future, which must take the gated dispatch — goes
        # through the plan's dispatch path
        for dep in ready:
            if (nxt is None and node.alive and dep.actor_id is None
                    and cluster.graph_chainable(dep, node)
                    and node.try_acquire(dep.resources)):
                nxt = dep
            else:
                cluster.graph_dispatch(dep)
        node.local_scheduler.on_worker_free()
    return nxt


class ActorContext(threading.Thread):
    """Dedicated per-actor execution context.

    Owns the live instance and a seq-ordered `ActorMailbox`. The thread
    acquires the actor's standing resource grant, constructs the instance
    (ctor args resolve like task args; or restores `__setstate__` from a
    checkpoint), then executes released calls. `run_ready` is the single
    execution entry — actor thread and inline-stealing getters both go
    through it, serialized by `_exec_lock`, so the instance only ever sees
    one method at a time, in sequence order. A method that raises stores a
    TaskError on its return id but does NOT kill the actor."""

    def __init__(self, node: "Node", aspec: ActorSpec, start_seq: int = 0,
                 checkpoint: Any = None):
        super().__init__(name=f"actor-{aspec.actor_id}-n{node.node_id}",
                         daemon=True)
        self.node = node
        self.aspec = aspec
        self.mailbox = ActorMailbox(aspec.actor_id, start_seq)
        self.instance: Any = None
        self.ctor_error: Optional[TaskError] = None
        self.ready = threading.Event()
        self._exec_lock = threading.Lock()
        self._checkpoint = checkpoint   # __getstate__ payload, or None
        self._granted = False
        self.start()

    # ------------------------------------------------------------ lifecycle

    def run(self) -> None:
        node = self.node
        # The standing *reservation* was taken by place_actor (so that
        # concurrent placements see each other); here we take the grant
        # out of the avail pool, waiting briefly for transient tasks to
        # finish. The grant is advisory: a placement race can leave the
        # node oversubscribed, in which case the actor runs ungranted
        # rather than stalling its mailbox behind capacity that will
        # never free (methods ride this grant — their TaskSpecs carry
        # empty resources).
        self._granted = (node.try_acquire(self.aspec.resources)
                         or node.acquire_blocking(self.aspec.resources,
                                                  timeout=10.0))
        if not self._granted:  # pragma: no cover - advisory, logged
            node.gcs.log_event("actor_res_timeout", self.aspec.actor_id,
                               f"node{node.node_id}")
        try:
            self._construct()
        finally:
            self.ready.set()
        while self.mailbox.wait_ready():
            # blocking acquire: if a stealing getter is mid-drain, sleep
            # on the mutex instead of spinning against it
            self.run_ready("actor", block=True)
        node.unreserve_for_actor(self.aspec.resources)  # pairs place_actor
        if self._granted:
            node.release(self.aspec.resources)

    def _construct(self) -> None:
        node, aspec, gcs = self.node, self.aspec, self.node.gcs
        prev_node = getattr(_worker_ctx, "node", None)
        _worker_ctx.node = node
        try:
            cls = gcs.function(aspec.class_name)
            if self._checkpoint is not None:
                inst = cls.__new__(cls)
                inst.__setstate__(copy.deepcopy(self._checkpoint))
                gcs.log_event("actor_restore", aspec.actor_id,
                              f"node{node.node_id}")
            else:
                args = [node.resolve(a) for a in aspec.args]
                kwargs = {k: node.resolve(v)
                          for k, v in aspec.kwargs.items()}
                inst = cls(*args, **kwargs)
            self.instance = inst
            gcs.log_event("actor_ready", aspec.actor_id,
                          f"node{node.node_id}")
        except Exception:  # noqa: BLE001
            self.ctor_error = TaskError(
                f"actor {aspec.actor_id} ({aspec.class_name}) "
                f"constructor failed:\n" + traceback.format_exc())
            gcs.log_event("actor_error", aspec.actor_id,
                          f"node{node.node_id}", ctor=True)
        finally:
            _worker_ctx.node = prev_node

    # ------------------------------------------------------------ execution

    def run_ready(self, who: str, block: bool = False) -> int:
        """Execute every in-order, already-delivered method call; returns
        how many ran. Stealers use the non-blocking form: if another
        thread holds the execution mutex they back off (woken by the
        completion notify like any other waiter); the actor thread blocks
        on the mutex so it never spins against an inline drain."""
        if not self.ready.is_set():
            return 0
        if not self._exec_lock.acquire(blocking=block):
            return 0
        try:
            n = 0
            while True:
                spec = self.mailbox.pop_next()
                if spec is None:
                    return n
                self._execute(spec, who)
                n += 1
        finally:
            self._exec_lock.release()

    def _execute(self, spec: TaskSpec, who: str) -> None:
        node, gcs = self.node, self.node.gcs
        prev_node = getattr(_worker_ctx, "node", None)
        prev_spec = getattr(_worker_ctx, "spec", None)
        _worker_ctx.node = node
        _worker_ctx.spec = spec
        try:
            gcs.set_task_state(spec.task_id, TASK_RUNNING)
            node.inflight[spec.task_id] = time.perf_counter()
            gcs.log_event("actor_start", spec.task_id,
                          f"node{node.node_id}/{who}")
            if self.ctor_error is not None:
                raise self.ctor_error
            method = getattr(self.instance, spec.actor_method)
            args = [node.resolve(a) for a in spec.args]
            kwargs = {k: node.resolve(v) for k, v in spec.kwargs.items()}
            out = method(*args, **kwargs)
            if node.alive:
                rets = (out,) if len(spec.return_ids) == 1 else tuple(out)
                for rid, val in zip(spec.return_ids, rets):
                    node.store.put(rid, val)
                gcs.set_task_state(spec.task_id, TASK_DONE)
                node.cluster.memory.on_task_done(spec)
                self._graph_release(spec)
                gcs.log_event("actor_finish", spec.task_id,
                              f"node{node.node_id}/{who}")
                self._maybe_checkpoint(spec.actor_seq + 1)
            else:
                gcs.set_task_state(spec.task_id, TASK_LOST)
                for rid in spec.return_ids:
                    gcs.notify_lost(rid)
        except Exception:  # noqa: BLE001
            if node.alive:
                err = TaskError(
                    f"actor method {spec.task_id} ({spec.func_name}) "
                    f"failed:\n" + traceback.format_exc())
                for rid in spec.return_ids:
                    node.store.put(rid, err)
                gcs.set_task_state(spec.task_id, TASK_DONE)
                node.cluster.memory.on_task_done(spec)
                self._graph_release(spec)
                gcs.log_event("actor_method_error", spec.task_id,
                              f"node{node.node_id}/{who}")
            else:
                gcs.set_task_state(spec.task_id, TASK_LOST)
                gcs.log_event("actor_method_error", spec.task_id,
                              f"node{node.node_id}/{who}", lost=True)
                for rid in spec.return_ids:
                    gcs.notify_lost(rid)
        finally:
            _worker_ctx.node = prev_node
            _worker_ctx.spec = prev_spec
            node.inflight.pop(spec.task_id, None)

    def _graph_release(self, spec: TaskSpec) -> None:
        """A compiled-graph actor call completed: release its plain-task
        dependents through the plan's dispatch path. Never inline on the
        actor's execution mutex — a chained task here would stall every
        later method call behind it."""
        if spec.graph_inv is None:
            return
        cluster = self.node.cluster
        for dep in cluster.graph_ready_after(spec):
            cluster.graph_dispatch(dep)

    def _maybe_checkpoint(self, next_seq: int) -> None:
        """Persist `__getstate__` to the control plane every
        `checkpoint_interval` completed calls, bounding restart replay to
        the log tail. Opt-in: interval 0 (the default) disables it."""
        k = self.aspec.checkpoint_interval
        if not k or next_seq % k or self.instance is None:
            return
        getstate = getattr(type(self.instance), "__getstate__", None)
        if getstate is None or getstate is getattr(object, "__getstate__",
                                                   None):
            return
        try:
            state = copy.deepcopy(self.instance.__getstate__())
        except Exception:  # noqa: BLE001 - checkpoint is best-effort
            self.node.gcs.log_event("actor_ckpt_error", self.aspec.actor_id,
                                    f"node{self.node.node_id}")
            return
        self.node.gcs.set_actor_checkpoint(self.aspec.actor_id,
                                           next_seq, state)
        self.node.gcs.log_event("actor_ckpt", self.aspec.actor_id,
                                f"node{self.node.node_id}", seq=next_seq)


class Worker(threading.Thread):
    """Pulls from the node's shared run queue (resources were acquired by
    the local scheduler before enqueue)."""

    def __init__(self, node: "Node", worker_id: int):
        super().__init__(name=f"worker-n{node.node_id}w{worker_id}",
                         daemon=True)
        self.node = node
        self.worker_id = worker_id
        self.start()

    def run(self) -> None:
        while True:
            spec = self.node.run_queue.get()
            if spec is None:
                return
            execute_task(self.node, spec, f"w{self.worker_id}")

    def shutdown(self) -> None:
        self.node.run_queue.put(None)
