"""Pluggable execution backends: how a node turns dispatched TaskSpecs
into running code.

Two implementations of one small interface (`ExecutionBackend`):

  * ``ThreadBackend`` — the historical behavior, and still the default:
    a shared run queue drained by daemon worker threads in the driver
    process. Zero serialization on the hot path (the store hands out
    live objects by reference), unpicklable values are legal, and
    work-stealing ``get()`` / inline graph chaining run the dependent on
    the calling thread.

  * ``ProcessBackend`` — real OS processes. Workers are spawned once at
    cluster start; each has a pair of shared-memory instruction rings
    (parent→child carries task ids + object descriptors, child→parent
    carries completions). Arguments and results never travel through the
    rings by value when they are large: the node's
    ``SharedMemoryStore`` keeps big buffers in named shared-memory
    segments, the ring carries the segment *name*, and the child maps it
    read-only — a zero-copy handoff in both directions. Functions cross
    the boundary once per worker (pickled, usually by reference) and are
    cached child-side. A worker process dying is detected by its
    completion-drain thread: in-flight tasks are marked LOST (lineage
    replay reruns them), and the backend reports unhealthy so the node's
    heartbeat stops and the PR 6 failure detector fail-stops the node
    exactly like a dead machine.

The scheduler/runtime layers are backend-agnostic: they call
``node.dispatch`` (→ ``backend.submit``) with resources already
acquired, and completions flow through the same ``finish_success`` /
``finish_lost`` / ``fail_task`` bookkeeping the thread path uses
(worker.py) — DONE/LOST states, GC unpins, graph-dependent release and
retry budgets behave identically under both backends.
"""
from __future__ import annotations

import atexit
import pickle
import queue
import struct
import threading
import time
import traceback
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from repro_torch.core.control_plane import TASK_RUNNING, TaskSpec
from repro_torch.core.object_store import attach_segment, create_segment
from repro_torch.core.serialization import PICKLE_PROTO, SpawnSafetyError
from repro_torch.core.worker import (TaskError, Worker, fail_task, finish_lost,
                               finish_success)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.runtime import Node

#: Per-ring shared-memory capacity. Records are small (descriptors and
#: ids — big payloads ride in their own store segments), so 4 MiB of
#: ring absorbs deep bursts without ever blocking the producer.
RING_BYTES = 4 * 1024 * 1024

#: How many times the dispatcher re-resolves a spec whose argument was
#: evicted between the residency check and descriptor creation.
_MAX_DISPATCH_ATTEMPTS = 5


class RingClosedError(RuntimeError):
    """Push/pop on a ring whose peer is gone and buffer is full."""


class ShmRing:
    """Byte-record ring over one shared-memory segment, for
    parent↔child instruction traffic.

    Layout: ``head`` (u64, consumer cursor) at offset 0, ``tail`` (u64,
    producer cursor) at offset 8, then ``capacity`` data bytes. Cursors
    only ever grow; ``pos % capacity`` locates the byte, and records
    wrap around the end of the data area. Each record is a u32 length
    prefix + payload.

    Single-consumer by construction (one drain loop per ring).
    Multi-producer pushes are serialized by a *process-local* lock —
    the parent is the only pusher on an instruction ring and the child
    the only pusher on a completion ring, so cross-process push races
    cannot happen. Record availability is signaled through a
    multiprocessing semaphore (no busy-wait consumer); space is
    reclaimed by the consumer advancing ``head``, which the producer
    polls briefly only when the ring is full (cold path).

    Picklable only while spawning a worker process (the semaphore's own
    rule); the child attaches to the same segment by name.
    """

    _HDR = 16

    def __init__(self, capacity: int = RING_BYTES):
        import multiprocessing as mp
        self.capacity = capacity
        self._shm = create_segment(self._HDR + capacity)
        struct.pack_into("<QQ", self._shm.buf, 0, 0, 0)
        self._owner = True
        self._items = mp.get_context("spawn").Semaphore(0)
        self._plock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------- spawn transfer

    def __getstate__(self):
        return {"name": self._shm.name, "capacity": self.capacity,
                "items": self._items}

    def __setstate__(self, state):
        self.capacity = state["capacity"]
        self._shm = attach_segment(state["name"])
        self._owner = False
        self._items = state["items"]
        self._plock = threading.Lock()
        self._closed = False

    # ---------------------------------------------------------------- wire

    def _copy_in(self, pos: int, data: bytes) -> None:
        off = pos % self.capacity
        end = off + len(data)
        base = self._HDR
        if end <= self.capacity:
            self._shm.buf[base + off:base + end] = data
        else:  # wrap
            first = self.capacity - off
            self._shm.buf[base + off:base + self.capacity] = data[:first]
            self._shm.buf[base:base + end - self.capacity] = data[first:]

    def _copy_out(self, pos: int, n: int) -> bytes:
        off = pos % self.capacity
        end = off + n
        base = self._HDR
        if end <= self.capacity:
            return bytes(self._shm.buf[base + off:base + end])
        first = self.capacity - off
        return (bytes(self._shm.buf[base + off:base + self.capacity])
                + bytes(self._shm.buf[base:base + end - self.capacity]))

    def push(self, data: bytes, timeout: Optional[float] = None) -> None:
        """Append one record; blocks (briefly polling head) while the
        ring is full. ``timeout`` bounds that wait — a full ring whose
        consumer died raises RingClosedError instead of hanging the
        dispatcher forever."""
        rec = 4 + len(data)
        if rec > self.capacity:
            raise ValueError(
                f"record of {len(data)} bytes exceeds ring capacity "
                f"{self.capacity} — large values must travel through "
                f"the shared-memory store, not the instruction ring")
        deadline = (time.perf_counter() + timeout) if timeout else None
        with self._plock:
            buf = self._shm.buf
            while True:
                if self._closed:
                    raise RingClosedError("ring closed")
                head, tail = struct.unpack_from("<QQ", buf, 0)
                if tail - head + rec <= self.capacity:
                    break
                if deadline and time.perf_counter() > deadline:
                    raise RingClosedError("ring full (consumer gone?)")
                time.sleep(0.0002)
            self._copy_in(tail, struct.pack("<I", len(data)))
            self._copy_in(tail + 4, data)
            # tail store is the publish: the consumer never reads past it
            struct.pack_into("<Q", buf, 8, tail + rec)
        self._items.release()

    def pop(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Remove and return the oldest record, or None on timeout."""
        if not self._items.acquire(timeout=timeout):
            return None
        buf = self._shm.buf
        head = struct.unpack_from("<Q", buf, 0)[0]
        (n,) = struct.unpack("<I", self._copy_out(head, 4))
        data = self._copy_out(head + 4, n)
        # head store is the release: space becomes reusable here
        struct.pack_into("<Q", buf, 0, head + 4 + n)
        return data

    def close(self) -> None:
        """Owner side: unlink the segment (children just close their
        attach on exit; the tracker policy is create_segment's)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.close()
        except BufferError:
            from repro_torch.core.object_store import _UNDEAD
            _UNDEAD.append(self._shm)
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


# --------------------------------------------------------------------------


class ExecutionBackend:
    """How a node executes dispatched tasks. The scheduler acquires
    resources and calls ``submit``; the backend owns everything from
    there to the DONE/LOST bookkeeping."""

    name = "base"
    #: Whether a compiled-graph dependent may run inline on the thread
    #: that completed its producer (same-interpreter execution only).
    supports_inline_chain = False

    def __init__(self, node: "Node"):
        self.node = node

    def start(self) -> None:
        """Bring up execution contexts (threads or processes)."""

    def submit(self, spec: TaskSpec) -> None:
        raise NotImplementedError

    def queued(self) -> int:
        """Dispatched-but-not-started task count (node load signal)."""
        return 0

    def healthy(self) -> bool:
        """False once an execution context died — the node's heartbeat
        loop stops beating so the failure detector fail-stops the node."""
        return True

    def maybe_spawn_spare(self) -> None:
        """A worker blocked in get()/wait(): give the backend a chance
        to add capacity so nested tasks cannot deadlock the pool."""

    def drain_pending(self) -> List[TaskSpec]:
        """Node fail-stop: hand back every dispatched-but-unfinished
        spec for resubmission elsewhere."""
        return []

    def shutdown(self) -> None:
        """Tear down execution contexts. Idempotent."""


class ThreadBackend(ExecutionBackend):
    """Daemon worker threads draining the node's shared run queue —
    the historical (and default) execution model. The run queue stays
    an attribute of the node because the work-stealing ``get()`` path
    scans it directly."""

    name = "thread"
    supports_inline_chain = True

    def __init__(self, node: "Node", num_workers: int):
        super().__init__(node)
        self.num_workers = num_workers

    def start(self) -> None:
        node = self.node
        node.workers = [Worker(node, i) for i in range(self.num_workers)]

    def submit(self, spec: TaskSpec) -> None:
        self.node.run_queue.put(spec)

    def queued(self) -> int:
        return self.node.run_queue.qsize()

    def maybe_spawn_spare(self) -> None:
        node = self.node
        if (len(node.workers) < node._max_workers
                and (node.run_queue.qsize() > 0
                     or node.local_scheduler.backlog_len() > 0)):
            node.workers.append(Worker(node, len(node.workers)))

    def drain_pending(self) -> List[TaskSpec]:
        specs: List[TaskSpec] = []
        while True:
            try:
                spec = self.node.run_queue.get_nowait()
            except queue.Empty:
                break
            if spec is not None:
                specs.append(spec)
        return specs

    def shutdown(self) -> None:
        for w in self.node.workers:
            w.shutdown()


# --------------------------------------------------------------------------


def _ref_ids(spec: TaskSpec) -> List[str]:
    from repro_torch.core.api import ObjectRef
    ids: List[str] = []
    for arg in list(spec.args) + list(spec.kwargs.values()):
        if isinstance(arg, ObjectRef):
            ids.append(arg.id)
        elif type(arg) in (list, tuple):
            ids.extend(e.id for e in arg if isinstance(e, ObjectRef))
    return ids


class _ByName:
    """Cross-process function reference for callables that don't pickle
    directly — typically because ``@remote`` left the *wrapper* bound to
    the module attribute, so the raw function fails pickle's identity
    check. The child re-imports the module and unwraps ``__wrapped__``
    back to the raw callable."""

    def __init__(self, module: str, qualname: str):
        self.module = module
        self.qualname = qualname

    def load(self):
        import importlib
        obj: Any = importlib.import_module(self.module)
        for part in self.qualname.split("."):
            obj = getattr(obj, part)
        while hasattr(obj, "__wrapped__"):
            obj = obj.__wrapped__
        return obj


def dump_function(fn: Any) -> bytes:
    """Pickle a task function for the instruction ring: directly when
    possible, by importable name as the fallback. Raises
    SpawnSafetyError (naming the function) for closures and other
    non-importable callables."""
    try:
        return pickle.dumps(fn, protocol=PICKLE_PROTO)
    except Exception as exc:
        mod = getattr(fn, "__module__", None)
        qual = getattr(fn, "__qualname__", None)
        if mod and qual and "<locals>" not in qual:
            try:
                return pickle.dumps(_ByName(mod, qual),
                                    protocol=PICKLE_PROTO)
            except Exception:  # pragma: no cover - _ByName always pickles
                pass
        name = f"{mod}.{qual}" if qual else repr(fn)
        raise SpawnSafetyError(
            f"task function {name} cannot be shipped to a worker "
            f"process: {exc}. Define it at module level (not inside "
            f"another function) so the worker can import it, or use "
            f"the thread backend.") from exc


class ProcessBackend(ExecutionBackend):
    """Multi-process execution over the node's SharedMemoryStore.

    One dispatcher thread resolves each submitted spec into a compact
    instruction — function name, argument *descriptors* (segment names
    or inline bytes, never large values), return ids — and pushes it
    onto the least-loaded live worker's instruction ring. One drain
    thread per worker turns completion records back into the standard
    DONE/LOST/error bookkeeping (worker.py helpers), adopting
    child-created result segments into the store zero-copy.

    Scope: plain tasks and compiled-graph tasks execute in worker
    processes. Actors keep their dedicated parent-side execution
    contexts (mailbox ordering and checkpoint/replay are
    single-interpreter machinery); task code running *inside* a worker
    process cannot itself submit tasks or block in get() — nested
    submission stays a driver/thread-backend feature.
    """

    name = "process"
    supports_inline_chain = False

    def __init__(self, node: "Node", num_workers: int):
        super().__init__(node)
        self.num_workers = max(1, num_workers)
        self._procs: List[Any] = []
        self._instr: List[ShmRing] = []
        self._comp: List[ShmRing] = []
        self._winflight: List[Dict[str, TaskSpec]] = []
        self._drainers: List[threading.Thread] = []
        self._fn_sent: List[set] = []
        self._fn_bytes: Dict[str, bytes] = {}
        self._dispatch_q: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self._stranded: List[TaskSpec] = []
        self._dead: set = set()
        self._stop = threading.Event()
        self._started = False
        self._shut = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        import multiprocessing as mp
        from repro_torch.core.proc_worker import worker_main
        ctx = mp.get_context("spawn")
        node = self.node
        for i in range(self.num_workers):
            instr, comp = ShmRing(), ShmRing()
            proc = ctx.Process(
                target=worker_main, args=(instr, comp, node.node_id, i),
                daemon=True, name=f"procworker-n{node.node_id}w{i}")
            proc.start()
            self._procs.append(proc)
            self._instr.append(instr)
            self._comp.append(comp)
            self._winflight.append({})
            self._fn_sent.append(set())
        self._started = True
        threading.Thread(target=self._dispatch_loop, daemon=True,
                         name=f"pdispatch-n{node.node_id}").start()
        for i in range(self.num_workers):
            t = threading.Thread(target=self._drain_loop, args=(i,),
                                 daemon=True,
                                 name=f"pdrain-n{node.node_id}w{i}")
            t.start()
            self._drainers.append(t)
        atexit.register(self.shutdown)

    def healthy(self) -> bool:
        return self._started and not self._dead

    def queued(self) -> int:
        return (self._dispatch_q.qsize()
                + sum(len(m) for m in self._winflight))

    def shutdown(self) -> None:
        with self._lock:
            if self._shut:
                return
            self._shut = True
        self._stop.set()
        self._dispatch_q.put(None)
        for i, proc in enumerate(self._procs):
            try:
                self._instr[i].push(
                    pickle.dumps(("stop",), protocol=PICKLE_PROTO),
                    timeout=0.5)
            except (RingClosedError, ValueError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=1.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=1.0)
        for ring in self._instr + self._comp:
            ring.close()

    def drain_pending(self) -> List[TaskSpec]:
        """Fail-stop drain: every submitted-but-unfinished spec. The
        caller (kill/restart) resubmits them elsewhere; the children are
        torn down — a dead node's results would be discarded anyway."""
        specs: List[TaskSpec] = []
        while True:
            try:
                s = self._dispatch_q.get_nowait()
            except queue.Empty:
                break
            if s is not None:
                specs.append(s)
        with self._lock:
            specs.extend(self._stranded)
            self._stranded = []
        for m in self._winflight:
            for tid in list(m):
                spec = m.pop(tid, None)  # races drain thread: pop wins
                if spec is not None:
                    self.node.inflight.pop(tid, None)
                    specs.append(spec)
        self.shutdown()
        return specs

    # ------------------------------------------------------------- dispatch

    def submit(self, spec: TaskSpec) -> None:
        self._dispatch_q.put(spec)

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            spec = self._dispatch_q.get()
            if spec is None:
                return
            try:
                self._dispatch(spec)
            except Exception as exc:  # noqa: BLE001 - keep the loop alive
                self._fail_dispatch(spec, exc)

    def _dispatch(self, spec: TaskSpec, attempt: int = 0) -> None:
        node = self.node
        where = f"node{node.node_id}/pdisp"
        if self._stop.is_set() or not node.alive:
            if not node.alive:
                finish_lost(node, spec, where)
            return
        if (spec.deadline_s
                and time.perf_counter() - spec.created_ts > spec.deadline_s):
            node.cluster.expire_deadline(spec, where)
            node.release(spec.resources)
            node.local_scheduler.on_worker_free()
            return
        # resolve missing arguments off the dispatcher thread: fetch may
        # block on a transfer or even lineage reconstruction, and one
        # slow argument must not head-of-line-block every other task
        missing = [oid for oid in _ref_ids(spec)
                   if not node.store.contains(oid)]
        if missing and attempt < _MAX_DISPATCH_ATTEMPTS:
            threading.Thread(
                target=self._fetch_then_dispatch,
                args=(spec, missing, attempt), daemon=True,
                name=f"pfetch-n{node.node_id}").start()
            return
        try:
            fn_bytes = self._function_bytes(spec.func_name)
            args_d = [self._arg_desc(a) for a in spec.args]
            kwargs_d = {k: self._arg_desc(v)
                        for k, v in spec.kwargs.items()}
        except KeyError:
            # an argument was evicted between the residency check and
            # descriptor creation — refetch and retry (bounded)
            if attempt < _MAX_DISPATCH_ATTEMPTS:
                self._dispatch(spec, attempt + 1)
            else:
                self._fail_dispatch(spec, TaskError(
                    f"task {spec.task_id}: argument unavailable after "
                    f"{attempt} fetch attempts"))
            return
        except SpawnSafetyError as exc:
            self._fail_dispatch(spec, exc)
            return
        widx = self._pick_worker()
        if widx is None:
            # every worker process is dead: hold the spec for the
            # fail-stop drain (the unhealthy backend has already stopped
            # the node's heartbeat — the detector will kill + resubmit)
            with self._lock:
                self._stranded.append(spec)
            return
        gcs = node.gcs
        gcs.set_task_state(spec.task_id, TASK_RUNNING)
        node.inflight[spec.task_id] = time.perf_counter()
        gcs.log_event("start", spec.task_id,
                      f"node{node.node_id}/pw{widx}")
        self._winflight[widx][spec.task_id] = spec
        try:
            if spec.func_name not in self._fn_sent[widx]:
                self._instr[widx].push(pickle.dumps(
                    ("fn", spec.func_name, fn_bytes),
                    protocol=PICKLE_PROTO), timeout=10.0)
                self._fn_sent[widx].add(spec.func_name)
            self._instr[widx].push(pickle.dumps(
                ("task", spec.task_id, spec.func_name, args_d, kwargs_d,
                 list(spec.return_ids)), protocol=PICKLE_PROTO),
                timeout=10.0)
        except (RingClosedError, ValueError) as exc:
            self._winflight[widx].pop(spec.task_id, None)
            node.inflight.pop(spec.task_id, None)
            self._fail_dispatch(spec, exc)

    def _fetch_then_dispatch(self, spec: TaskSpec, missing: List[str],
                             attempt: int) -> None:
        node = self.node
        try:
            for oid in missing:
                node.cluster.fetch(oid, prefer_node=node.node_id)
        except Exception as exc:  # noqa: BLE001
            self._fail_dispatch(spec, exc)
            return
        try:
            self._dispatch(spec, attempt + 1)
        except Exception as exc:  # noqa: BLE001
            self._fail_dispatch(spec, exc)

    def _function_bytes(self, func_name: str) -> bytes:
        b = self._fn_bytes.get(func_name)
        if b is None:
            fn = self.node.gcs.function(func_name)
            b = dump_function(fn)
            self._fn_bytes[func_name] = b
        return b

    def _arg_desc(self, arg: Any) -> Tuple:
        from repro_torch.core.api import ObjectRef
        store = self.node.store
        if isinstance(arg, ObjectRef):
            return ("obj", store.descriptor(arg.id))
        if type(arg) in (list, tuple) and any(
                isinstance(e, ObjectRef) for e in arg):
            return ("seq", "list" if type(arg) is list else "tuple",
                    [self._arg_desc(e) for e in arg])
        try:
            return ("lit", pickle.dumps(arg, protocol=PICKLE_PROTO))
        except Exception as exc:
            raise SpawnSafetyError(
                f"task argument {arg!r} cannot be pickled for a worker "
                f"process: {exc}. Pass it through put() as plain data, "
                f"or use the thread backend.") from exc

    def _pick_worker(self) -> Optional[int]:
        best, best_load = None, None
        for i in range(self.num_workers):
            if i in self._dead or not self._procs[i].is_alive():
                continue
            load = len(self._winflight[i])
            if best_load is None or load < best_load:
                best, best_load = i, load
        return best

    def _fail_dispatch(self, spec: TaskSpec, exc: Exception) -> None:
        """A spec never reached (or never returns from) a worker: run
        the standard failure bookkeeping on the dispatcher's behalf."""
        node = self.node
        where = f"node{node.node_id}/pdisp"
        tb = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
        ready: tuple = ()
        try:
            if node.alive:
                _, ready = fail_task(node, spec, exc, where, tb=tb)
            else:
                finish_lost(node, spec, where, error=True)
        finally:
            node.inflight.pop(spec.task_id, None)
            node.release(spec.resources)
            for dep in ready:
                node.cluster.graph_dispatch(dep)
            node.local_scheduler.on_worker_free()

    # ---------------------------------------------------------- completions

    def _drain_loop(self, widx: int) -> None:
        ring, proc = self._comp[widx], self._procs[widx]
        while not self._stop.is_set():
            rec = ring.pop(timeout=0.1)
            if rec is None:
                if not proc.is_alive():
                    self._on_child_death(widx)
                    return
                continue
            try:
                self._complete(widx, pickle.loads(rec))
            except Exception:  # noqa: BLE001 - keep draining
                self.node.gcs.log_event(
                    "proc_complete_error", f"pw{widx}",
                    f"node{self.node.node_id}", tb=traceback.format_exc())

    def _complete(self, widx: int, msg: Tuple) -> None:
        node = self.node
        spec = self._winflight[widx].pop(msg[1], None)
        if spec is None:  # already drained by a fail-stop
            self._discard_result_segments(msg)
            return
        where = f"node{node.node_id}/pw{widx}"
        ready: tuple = ()
        try:
            if msg[0] == "done":
                if node.alive:
                    try:
                        for rid, desc in zip(spec.return_ids, msg[2]):
                            node.store.adopt_result(rid, desc)
                    except Exception as exc:  # noqa: BLE001
                        _, ready = fail_task(node, spec, exc, where)
                    else:
                        ready = finish_success(node, spec, where)
                else:
                    finish_lost(node, spec, where)
                    self._discard_result_segments(msg)
            else:  # ("err", task_id, exc_bytes, repr, tb)
                exc = _rebuild_exception(msg[2], msg[3])
                if node.alive:
                    _, ready = fail_task(node, spec, exc, where, tb=msg[4])
                else:
                    finish_lost(node, spec, where, error=True)
        finally:
            node.inflight.pop(spec.task_id, None)
            node.release(spec.resources)
            for dep in ready:
                node.cluster.graph_dispatch(dep)
            node.local_scheduler.on_worker_free()

    def _discard_result_segments(self, msg: Tuple) -> None:
        """Nobody adopted these child-created result segments (node
        dead, or the spec was drained): unlink them so they don't leak
        until process exit."""
        if msg[0] != "done":
            return
        for desc in msg[2]:
            if desc[0] == "seg":
                try:
                    shm = attach_segment(desc[3])
                    shm.close()
                    shm.unlink()
                except (FileNotFoundError, OSError):  # pragma: no cover
                    pass

    def _on_child_death(self, widx: int) -> None:
        """A worker process died. Its in-flight tasks are LOST (lineage
        replay reruns them — promptly, because fetchers are notified);
        the backend goes unhealthy, which stops the node's heartbeat so
        the failure detector fail-stops the whole node exactly like a
        machine failure."""
        node = self.node
        self._dead.add(widx)
        stranded = self._winflight[widx]
        self._winflight[widx] = {}
        node.gcs.log_event("worker_proc_dead", f"pw{widx}",
                           f"node{node.node_id}",
                           inflight=len(stranded))
        for tid in list(stranded):
            spec = stranded.pop(tid, None)
            if spec is None:
                continue
            node.inflight.pop(tid, None)
            if node.alive:
                finish_lost(node, spec, f"node{node.node_id}/pw{widx}",
                            error=True)
                node.release(spec.resources)
                node.local_scheduler.on_worker_free()


def _rebuild_exception(exc_bytes: Optional[bytes], exc_repr: str):
    if exc_bytes is not None:
        try:
            return pickle.loads(exc_bytes)
        except Exception:  # noqa: BLE001 - fall through to the repr
            pass
    return TaskError(f"worker process task failed: {exc_repr}")


__all__ = ["ExecutionBackend", "ThreadBackend", "ProcessBackend",
           "ShmRing", "RingClosedError", "dump_function", "RING_BYTES"]
