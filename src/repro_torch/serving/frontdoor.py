"""Serving front door: open-loop intake, admission control, EDF
queueing, adaptive batching, and replica autoscaling. The port of
``repro.serving.frontdoor`` onto ``repro_torch.core``: the same policies,
public names and events, over `ServingReplica` actors whose engines run
the port's `ServingEngine` (on the card, each on its own CUDA stream).

The paper's motivating deployments *serve* — predictions leave the
system under millisecond deadlines while requests arrive on their own
clock (R1/R2). `ReplicaPool.serve` is closed-loop: it takes a
pre-collected list and blocks until it drains. The `FrontDoor` is the
open-loop tier above the same replicas:

  * **Admission control** — a bounded queue; a request that would push
    queued + in-flight past `max_queue` is refused with a typed
    `AdmissionError` at submit time (fail fast beats queueing collapse).
  * **Deadline-aware queueing** — per-prompt-length EDF heaps (length
    buckets keep waves SPMD-alignable; earliest deadline first within
    and across buckets). A request whose deadline passes while queued is
    *shed* with a typed `DeadlineShedError` — it is never dispatched, so
    replica capacity only ever runs work that can still meet its SLO.
    Within a quantized deadline bucket (``priority_quantum_s``),
    requests order by a small `priority` tenancy class — the streaming
    pipeline's learner-feedback traffic outranks bulk without ever
    overriding an earlier deadline bucket.
  * **Adaptive batching** — per-replica AIMD controllers (Clipper-style)
    grow the wave size additively while observed wave latency sits under
    `target_wave_s` and halve it when a wave overshoots: throughput of
    large batches when the engine keeps up, small-batch latency the
    moment it stops.
  * **Autoscaling** — sustained queue depth (or shedding) spawns
    `ServingReplica` actors through the global scheduler's memory-aware
    placement + standing reservations; sustained idleness retires them
    through `Cluster.retire_actor` (which releases the standing grant
    and bars restart-with-replay resurrection). A detector-reported node
    death that takes a replica with it triggers an immediate hot spare
    (`serve_spare`) while the old incarnation replays elsewhere —
    scale-down reclaims the surplus once the burst passes.

Every disposition is observable: `serve_admit` / `serve_reject` /
`serve_shed` / `serve_wave` / `serve_retry` / `serve_scale_up` /
`serve_scale_down` / `serve_spare` events land in the control-plane log
(surfaced by `profiler.summarize`), and an `SLOTracker` keeps sliding
p50/p99 and goodput. Beside them the port logs `serve_reap` (a reaped
wave's dispatch-to-reap ms), which with the replica's `serve_engine`
(the engine's own ms) gives the runtime's cost a wave. Nothing here
touches the task hot path: the front door is a control loop *above*
submit/get/wait, one thread ("frontdoor-ctl"), no runtime internals on
the dispatch route — waves ride the same compiled per-replica graphs
ReplicaPool uses.

Load shapes: repro_torch.serving.load; metrics: repro_torch.serving.slo.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import Request, ServingReplica
from repro_torch.serving.slo import SLOTracker


class AdmissionError(RuntimeError):
    """Refused at the door: the bounded queue is full (overload)."""


class DeadlineShedError(RuntimeError):
    """Shed before dispatch: the deadline passed (or the front door
    closed) while the request was still queued."""


class ServeTicket:
    """The caller's handle for one admitted request: resolves to the
    engine `Response` or raises the typed error that disposed of it."""

    __slots__ = ("request_id", "deadline", "_event", "_value", "_error")

    def __init__(self, request_id: int, deadline: float):
        self.request_id = request_id
        self.deadline = deadline          # absolute perf_counter time
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} unresolved after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} unresolved after {timeout}s")
        return self._error

    def _fulfill(self, value: Any) -> None:
        if not self._event.is_set():
            self._value = value
            self._event.set()

    def _fail(self, err: BaseException) -> None:
        if not self._event.is_set():
            self._error = err
            self._event.set()


class BatchController:
    """AIMD wave-size controller (Clipper's additive-increase /
    multiplicative-decrease): grow by one while observed wave latency
    holds under target, back off by 10% on overshoot (Clipper's gentle
    multiplicative step — a half-on-overshoot rule oscillates far below
    the stall point and forfeits most of the batching win). Convergence
    target: the largest batch whose service time still fits the latency
    budget — found by probing, not configured.

    Increase is gated on *full* waves: a wave smaller than the current
    limit says nothing about how a larger batch would behave (light
    traffic and small length buckets produce fast small waves
    constantly — letting those grow the limit inflates it to max and
    the next burst lands on an untested batch size). Overshoot always
    decreases: if even an undersized wave blew the budget, larger ones
    certainly would."""

    __slots__ = ("target_wave_s", "max_batch", "_size")

    #: multiplicative backoff factor applied on latency overshoot
    DECREASE = 0.9

    def __init__(self, target_wave_s: float, max_batch: int = 16,
                 initial: int = 1):
        self.target_wave_s = target_wave_s
        self.max_batch = max_batch
        self._size = float(max(1, initial))

    @property
    def size(self) -> int:
        return int(self._size)

    def observe(self, wave_latency_s: float,
                wave_size: int = None) -> None:
        if wave_latency_s <= self.target_wave_s:
            if wave_size is None or wave_size >= self.size:
                self._size = min(float(self.max_batch), self._size + 1.0)
        else:
            self._size = max(1.0, self._size * self.DECREASE)


class FixedBatchController(BatchController):
    """Pinned wave size — the fixed-batch baseline policy the serve
    bench A/Bs the AIMD controller against (observations are ignored)."""

    def __init__(self, size: int):
        super().__init__(target_wave_s=float("inf"), max_batch=size,
                         initial=size)

    def observe(self, wave_latency_s: float,
                wave_size: int = None) -> None:
        pass


class _Replica:
    """One serving actor + its compiled wave graph + AIMD controller."""

    __slots__ = ("handle", "graph", "inflight", "controller", "node_id")

    def __init__(self, handle, graph, controller: BatchController,
                 node_id: Optional[int]):
        self.handle = handle
        self.graph = graph
        self.inflight: List[Any] = []     # outstanding wave ObjectRefs
        self.controller = controller
        self.node_id = node_id


# one queued request: EDF heap entry, plus its per-request retry count.
# Order: quantized deadline first (earliest bucket wins — still EDF),
# then priority class within a bucket (higher first — tenancy: the
# streaming pipeline's learner-feedback traffic outranks bulk), then
# seq (FIFO among equals). The *exact* deadline stays authoritative for
# shedding and the never-dispatch-late invariant; only the ordering is
# quantized, so priority has a window to matter in.
class _Entry:
    __slots__ = ("deadline", "seq", "request", "ticket", "attempt",
                 "priority", "_key")

    def __init__(self, deadline, seq, request, ticket, attempt=0,
                 priority=0, quantum=0.0):
        self.deadline = deadline
        self.seq = seq
        self.request = request
        self.ticket = ticket
        self.attempt = attempt
        self.priority = priority
        bucket = round(deadline / quantum) if quantum > 0 else deadline
        self._key = (bucket, -priority, seq)

    def __lt__(self, other):
        return self._key < other._key


class FrontDoor:
    """Open-loop serving tier over `ServingReplica` actors. See module
    docstring for the policy stack; construction spawns the initial
    replica set and one control thread, `submit` is the only hot entry
    point, `close` drains and joins."""

    #: a wave whose replica failed re-enqueues its still-feasible
    #: requests at most this many times each before failing their tickets
    MAX_RETRIES = 2

    def __init__(self, engine_factory: Callable[[], Any],
                 num_replicas: int = 1,
                 *,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 max_queue: int = 256,
                 default_deadline_s: float = 0.5,
                 target_wave_s: float = 0.05,
                 max_batch: int = 16,
                 scale_up_queue_depth: int = 8,
                 scale_up_cooldown_s: float = 1.0,
                 scale_down_idle_s: float = 3.0,
                 max_inflight_per_replica: int = 1,
                 grow_cluster: bool = False,
                 resources: Optional[Dict[str, float]] = None,
                 slo_window_s: float = 30.0,
                 priority_quantum_s: float = 0.01,
                 controller_factory: Optional[
                     Callable[[], BatchController]] = None,
                 cluster=None):
        from repro_torch import core, dag
        from repro_torch.core import api as core_api
        self._core = core
        self._dag = dag
        self._cluster = cluster if cluster is not None else core_api._cluster()
        self._gcs = self._cluster.gcs
        self._engine_factory = engine_factory
        actor_cls = core.remote(ServingReplica)
        if resources is not None:
            actor_cls = actor_cls.options(resources=resources)
        self._actor_cls = actor_cls
        self.min_replicas = max(1, min_replicas)
        self.max_replicas = max(self.min_replicas, max_replicas)
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.target_wave_s = target_wave_s
        self.max_batch = max_batch
        self.scale_up_queue_depth = scale_up_queue_depth
        self.scale_up_cooldown_s = scale_up_cooldown_s
        self.scale_down_idle_s = scale_down_idle_s
        # bound on outstanding waves per replica. 1 (the default,
        # Clipper's shape) keeps the backlog in the EDF queue — where
        # deadline shedding still applies and the AIMD controller
        # observes true service latency; deeper pipelining moves queueing
        # into the actor mailbox, where a request can neither be shed nor
        # reordered by deadline
        self.max_inflight_per_replica = max(1, max_inflight_per_replica)
        self.grow_cluster = grow_cluster
        # deadline quantization for priority ordering (see _Entry): 0
        # restores pure (deadline, seq) EDF with priority inert
        self.priority_quantum_s = max(0.0, priority_quantum_s)
        # one controller per replica (spawned replicas included): AIMD
        # by default, or a caller-supplied policy (the serve bench pins
        # FixedBatchController for its baseline arms)
        self._controller_factory = controller_factory or (
            lambda: BatchController(self.target_wave_s, self.max_batch))
        self.slo = SLOTracker(window_s=slo_window_s)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._buckets: Dict[int, List[_Entry]] = {}
        self._queued = 0
        self._seq = itertools.count()
        self._req_ids = itertools.count()
        self._wave_meta: Dict[str, Tuple[_Replica, List[_Entry], float]] = {}
        self._replicas: List[_Replica] = []
        self._closing = False
        self._close_deadline: Optional[float] = None
        self._spare_wanted = False
        self._last_scale_t = time.perf_counter()
        # last control tick that saw queueing pressure: scale-down fires
        # when this goes stale for scale_down_idle_s — replicas are
        # reclaimed once the backlog stays drained, even while light
        # traffic keeps flowing (a burst that passed, not a dead system)
        self._last_pressure_t = time.perf_counter()

        for _ in range(max(self.min_replicas, num_replicas)):
            self._spawn_replica("initial")
        self._cluster.add_death_listener(self._on_node_death)
        self._thread = threading.Thread(target=self._run,
                                        name="frontdoor-ctl", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- intake

    def submit(self, prompt, max_new_tokens: int = 4,
               deadline_s: Optional[float] = None,
               priority: int = 0) -> ServeTicket:
        req = Request(next(self._req_ids),
                      np.asarray(prompt, np.int32), max_new_tokens,
                      priority=priority)
        return self.submit_request(req, deadline_s)

    def submit_request(self, request: Request,
                       deadline_s: Optional[float] = None) -> ServeTicket:
        """Admit one pre-built request (open-loop entry point). Raises
        `AdmissionError` when the bounded queue is full; the returned
        ticket resolves to a `Response` or a typed error.

        The request's clock is re-stamped to *admission* time: deadlines
        and reported latencies measure queueing-plus-service from when
        the request entered the system, not from when a load generator
        happened to construct the object (a pre-materialized trace would
        otherwise arrive pre-expired)."""
        request.created = time.perf_counter()
        deadline = request.created + (deadline_s if deadline_s is not None
                                      else self.default_deadline_s)
        ticket = ServeTicket(request.request_id, deadline)
        with self._cond:
            if self._closing:
                raise AdmissionError("front door is closed")
            inflight = sum(len(meta[1]) for meta in self._wave_meta.values())
            if self._queued + inflight >= self.max_queue:
                self.slo.record_reject()
                self._gcs.log_event("serve_reject",
                                    f"req{request.request_id}", "frontdoor",
                                    queued=self._queued, inflight=inflight)
                raise AdmissionError(
                    f"queue full: {self._queued} queued + {inflight} "
                    f"in-flight >= max_queue={self.max_queue}")
            entry = _Entry(deadline, next(self._seq), request, ticket,
                           priority=getattr(request, "priority", 0),
                           quantum=self.priority_quantum_s)
            heapq.heappush(
                self._buckets.setdefault(len(request.prompt), []), entry)
            self._queued += 1
            self.slo.record_admit()
            self._gcs.log_event("serve_admit", f"req{request.request_id}",
                                "frontdoor", length=len(request.prompt))
            self._cond.notify_all()
        return ticket

    # ----------------------------------------------------------- replicas

    def _spawn_replica(self, why: str) -> _Replica:
        handle = self._actor_cls.submit(self._engine_factory)
        node_id = self._gcs.actor_node(handle.actor_id)
        if node_id is None and self.grow_cluster:
            # parked unschedulable: no live node can grant the standing
            # reservation — grow the cluster, which retries parked actors
            self._cluster.add_node()
            node_id = self._gcs.actor_node(handle.actor_id)
        graph = self._dag.compile(handle.serve_wave.bind(self._dag.input(0)))
        replica = _Replica(handle, graph, self._controller_factory(),
                           node_id)
        self._gcs.log_event("serve_replica_spawn", handle.actor_id,
                            "frontdoor", why=why, node=node_id)
        with self._lock:
            self._replicas.append(replica)
        return replica

    def _retire_replica(self, replica: _Replica, why: str) -> None:
        with self._lock:
            if replica in self._replicas:
                self._replicas.remove(replica)
        self._cluster.retire_actor(replica.handle.actor_id)
        self._gcs.log_event("serve_scale_down", replica.handle.actor_id,
                            "frontdoor", why=why)

    def _on_node_death(self, node_id: int) -> None:
        """Death-listener callback (runs on the killing thread — record
        only; the control thread does the spawning). The lost replica
        itself relocates via restart-with-replay; the hot spare covers
        the rebuild window."""
        with self._cond:
            if any(r.node_id == node_id for r in self._replicas):
                self._spare_wanted = True
                self._cond.notify_all()

    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    # ------------------------------------------------------- control loop

    def _run(self) -> None:
        while True:
            progressed = self._shed_expired()
            progressed |= self._reap()
            progressed |= self._dispatch()
            self._autoscale()
            with self._cond:
                outstanding = bool(self._wave_meta)
                if self._closing:
                    if not outstanding:
                        break
                    if (self._close_deadline is not None
                            and time.perf_counter() > self._close_deadline):
                        self._abandon_outstanding()
                        break
                elif not progressed and not self._queued and not outstanding:
                    self._cond.wait(timeout=0.005)

    def _shed_expired(self) -> bool:
        """Drop every queued request whose deadline already passed — the
        'never dispatched' guarantee. Heap order makes this a head scan
        per length bucket."""
        now = time.perf_counter()
        shed: List[_Entry] = []
        with self._lock:
            for length in list(self._buckets):
                heap = self._buckets[length]
                while heap and heap[0].deadline <= now:
                    shed.append(heapq.heappop(heap))
                    self._queued -= 1
                if not heap:
                    del self._buckets[length]
        self._shed(shed, now)
        return bool(shed)

    def _shed(self, entries: List[_Entry], now: float,
              at_dispatch: bool = False) -> None:
        for e in entries:
            late_ms = (now - e.deadline) * 1e3
            self.slo.record_shed(late_ms if at_dispatch else None)
            self._gcs.log_event("serve_shed", f"req{e.request.request_id}",
                                "frontdoor", late_by_ms=late_ms,
                                at_dispatch=at_dispatch)
            e.ticket._fail(DeadlineShedError(
                f"request {e.request.request_id} shed: deadline passed "
                f"{late_ms:.1f}ms ago while "
                + ("its wave was dispatched" if at_dispatch else "queued")))

    def _dispatch(self) -> bool:
        """Form and dispatch EDF waves while queue and replicas allow."""
        progressed = False
        while True:
            with self._lock:
                if self._closing and not self._queued:
                    return progressed
                replica = self._pick_replica_locked()
                if replica is None or not self._queued:
                    return progressed
                entries = self._form_wave_locked(replica.controller.size)
                if not entries:
                    return progressed
            # formation popped only unexpired heads, but this thread may
            # have stalled since (another thread holding the GIL): a head
            # that expired meanwhile is shed here, where the reference
            # dispatches it late, and the SLO ledger counts it apart
            # (shed_at_dispatch, with how late the worst one was)
            now = time.perf_counter()
            late = [e for e in entries if e.deadline <= now]
            if late:
                self._shed(late, now, at_dispatch=True)
                entries = [e for e in entries if e.deadline > now]
                progressed = True
                if not entries:
                    continue
            requests = tuple(e.request for e in entries)
            # the never-dispatch-late invariant, on the clock read at the
            # dispatch itself — the SLO gate counts any violation
            now = time.perf_counter()
            for e in entries:
                if e.deadline <= now:
                    self.slo.record_late_dispatch()
            ref = replica.graph.execute(requests)
            with self._lock:
                replica.inflight.append(ref)
                self._wave_meta[ref.id] = (replica, entries, now, ref)
            self._gcs.log_event("serve_wave", ref.id, "frontdoor",
                                size=len(entries),
                                replica=replica.handle.actor_id,
                                batch_limit=replica.controller.size)
            progressed = True

    def _pick_replica_locked(self) -> Optional[_Replica]:
        ready = [r for r in self._replicas
                 if len(r.inflight) < self.max_inflight_per_replica]
        if not ready:
            return None
        return min(ready, key=lambda r: len(r.inflight))

    def _form_wave_locked(self, limit: int) -> List[_Entry]:
        """EDF across buckets, length-aligned within: take the bucket
        whose head deadline is globally earliest, pop up to `limit`."""
        best_len, best = None, None
        for length, heap in self._buckets.items():
            if heap and (best is None or heap[0] < best):
                best, best_len = heap[0], length
        if best_len is None:
            return []
        heap = self._buckets[best_len]
        out: List[_Entry] = []
        now = time.perf_counter()
        while heap and len(out) < max(1, limit):
            if heap[0].deadline <= now:
                break                      # expired head: shed pass owns it
            out.append(heapq.heappop(heap))
        if not heap:
            del self._buckets[best_len]
        self._queued -= len(out)
        return out

    def _reap(self) -> bool:
        """Resolve completed waves: fulfill tickets, feed the AIMD
        controller and SLO window, free the wave output."""
        refs = self._all_outstanding()
        if not refs:
            return False
        done, _ = self._core.wait(refs, num_returns=1, timeout=0.003)
        if not done:
            return False
        progressed = False
        for ref in done:
            with self._lock:
                meta = self._wave_meta.pop(ref.id, None)
            if meta is None:
                continue
            replica, entries, dispatch_t, _ = meta
            with self._lock:
                if ref in replica.inflight:
                    replica.inflight.remove(ref)
            try:
                # short timeout: a wave that completed just before its
                # node died reports done but its result was wiped — a
                # long get here would stall the whole control loop (and
                # shed everything queued) while replay rebuilds it
                responses = self._core.get(ref, timeout=0.05)
            except self._core.GetTimeoutError:
                # raced an eviction/wipe between wait and get: re-track,
                # lineage/replay will deliver it on a later pass
                with self._lock:
                    replica.inflight.append(ref)
                    self._wave_meta[ref.id] = (replica, entries,
                                               dispatch_t, ref)
                continue
            except Exception as err:
                self._on_wave_failure(replica, entries, err)
                progressed = True
                continue
            now = time.perf_counter()
            by_id = {resp.request_id: resp for resp in responses}
            for e in entries:
                resp = by_id.get(e.request.request_id)
                if resp is None:
                    e.ticket._fail(RuntimeError(
                        f"wave completed without a response for request "
                        f"{e.request.request_id}"))
                    self.slo.record_failure()
                    continue
                met = now <= e.deadline
                self.slo.record_completion(resp.latency_s, met, now=now)
                e.ticket._fulfill(resp)
            replica.controller.observe(now - dispatch_t,
                                       wave_size=len(entries))
            self._gcs.log_event("serve_reap", ref.id, "frontdoor",
                                wave_ms=(now - dispatch_t) * 1e3)
            self._core.free([ref])
            progressed = True
        return progressed

    def _all_outstanding(self) -> List[Any]:
        # _wave_meta is the single source of truth for outstanding waves:
        # it keeps refs from replicas already replaced after a failure,
        # which must still resolve (no hung tickets)
        with self._lock:
            return [meta[3] for meta in self._wave_meta.values()]

    def _on_wave_failure(self, replica: _Replica, entries: List[_Entry],
                         err: Exception) -> None:
        """A wave resolved to a typed error (replica sealed, method
        raised). Re-enqueue still-feasible requests (bounded per-request
        retries), shed/fail the rest, and replace the replica."""
        now = time.perf_counter()
        requeue: List[_Entry] = []
        for e in entries:
            e.attempt += 1
            if e.deadline <= now:
                self.slo.record_shed()
                self._gcs.log_event(
                    "serve_shed", f"req{e.request.request_id}", "frontdoor",
                    after_failure=True)
                e.ticket._fail(DeadlineShedError(
                    f"request {e.request.request_id} shed after replica "
                    f"failure: deadline passed ({err!r})"))
            elif e.attempt > self.MAX_RETRIES:
                self.slo.record_failure()
                e.ticket._fail(err)
            else:
                requeue.append(e)
        with self._cond:
            for e in requeue:
                heapq.heappush(
                    self._buckets.setdefault(len(e.request.prompt), []), e)
                self._queued += 1
            if requeue:
                self._cond.notify_all()
        for e in requeue:
            self.slo.record_retry()
            self._gcs.log_event("serve_retry", f"req{e.request.request_id}",
                                "frontdoor", attempt=e.attempt)
        # replace the suspect replica unless it already left the set
        with self._lock:
            present = replica in self._replicas
        if present:
            self._retire_replica(replica, "wave_failure")
            if not self._closing:
                self._spawn_replica("replace_failed")

    # ---------------------------------------------------------- autoscale

    def _autoscale(self) -> None:
        if self._closing:
            return
        now = time.perf_counter()
        with self._lock:
            n = len(self._replicas)
            queued = self._queued
            if queued > 0:
                self._last_pressure_t = now
            spare = self._spare_wanted
            self._spare_wanted = False
            idle_replica = None
            if (now - self._last_pressure_t > self.scale_down_idle_s
                    and n > self.min_replicas):
                for r in reversed(self._replicas):
                    if not r.inflight:
                        idle_replica = r
                        break
        if spare and n < self.max_replicas:
            # hot spare: cover the dead replica's replay/rebuild window
            self._spawn_replica("hot_spare")
            self._gcs.log_event("serve_spare", "frontdoor", "frontdoor")
            self._last_scale_t = now
            return
        if (queued > self.scale_up_queue_depth
                and n < self.max_replicas
                and now - self._last_scale_t > self.scale_up_cooldown_s):
            self._spawn_replica("queue_depth")
            self._gcs.log_event("serve_scale_up", "frontdoor", "frontdoor",
                                queued=queued, replicas=n + 1)
            self._last_scale_t = now
            return
        if idle_replica is not None \
                and now - self._last_scale_t > self.scale_up_cooldown_s:
            self._retire_replica(idle_replica, "idle")
            self._last_scale_t = now

    # ------------------------------------------------------------- close

    def _abandon_outstanding(self) -> None:
        """Close-deadline expiry: fail every unresolved ticket promptly
        (typed error — no hung futures) and free the abandoned waves."""
        with self._lock:
            metas = list(self._wave_meta.values())
            self._wave_meta.clear()
            refs = [meta[3] for meta in metas]
            for r in self._replicas:
                r.inflight = []
        if refs:
            self._core.free(refs)
        for _, entries, _, _ in metas:
            for e in entries:
                self.slo.record_failure()
                e.ticket._fail(TimeoutError(
                    f"request {e.request.request_id} abandoned: front door "
                    f"closed before its wave resolved"))

    def close(self, timeout: float = 30.0) -> None:
        """Stop intake, shed the queue, drain in-flight waves (bounded by
        `timeout`), and join the control thread. Idempotent."""
        with self._cond:
            if self._closing and not self._thread.is_alive():
                return
            self._closing = True
            self._close_deadline = time.perf_counter() + timeout
            drained: List[_Entry] = []
            for heap in self._buckets.values():
                drained.extend(heap)
            self._buckets.clear()
            self._queued = 0
            self._cond.notify_all()
        for e in drained:
            self.slo.record_shed()
            e.ticket._fail(DeadlineShedError(
                f"request {e.request.request_id} shed: front door closed"))
        self._thread.join(timeout + 5.0)
        self._cluster.remove_death_listener(self._on_node_death)

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        snap = self.slo.snapshot()
        with self._lock:
            snap["replicas"] = len(self._replicas)
            snap["queued"] = self._queued
            snap["inflight_waves"] = len(self._wave_meta)
            snap["batch_limits"] = [r.controller.size
                                    for r in self._replicas]
        return snap
