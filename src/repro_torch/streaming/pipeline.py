"""StreamingPipeline: sources → learner → FrontDoor, train-while-serve.
The port of `repro.streaming.pipeline` onto `repro_torch.core` and the
port's FrontDoor; the scoring stays numpy on the host, as in the
reference.

This is the paper's headline loop run end-to-end on the runtime: a
producer actor emits the stream, a `StreamLearner` actor consumes it
through a compiled per-step graph and publishes versioned weights, and
the `FrontDoor` serves predictions on the *same* stream's feature
rows — its replicas hot-swapping to the newest `ParamSet` version
strictly *between* waves (the engine checks for a newer version at wave
start, so a wave in flight never changes weights under itself, and the
version-pinned fetch guarantees a swap can never observe a mid-reclaim
version).

Weight staleness is a first-class SLO next to latency: every completed
request records how many versions behind the newest publish its serving
weights were and how many stream-seconds of data those weights had not
trained through; the front door's extended `SLOTracker` carries the
lag/seconds-behind aggregates next to p50/p99 goodput.

Traffic classes: each mini-batch contributes ``serve_per_batch``
requests; a ``feedback_fraction`` of them is submitted at priority 1
(learner-feedback tenancy — outranks bulk within a deadline bucket, see
repro_torch.serving.frontdoor).

Thread-backend plane: the engine factory closes over live objects (the
SLO tracker), which the in-process actor model makes legal; the process
backend would need a handle-passing variant.

Two changes from the reference. `run` pumps no more batches than the run
still needs (`num_batches` less those consumed and those already in the
source's buffer). The reference pumps `pump_chunk` on every pass; when
back-pressure cut an earlier pump short, its last passes leave batches
in the source's buffer past `num_batches`, which its drain then takes and
acks, so the source produced and acked more than the run asked for.
And `run` starts with a full collection (`gc.collect`): the interpreter
collects its oldest generation once the objects promoted into it since
the last such collection reach a quarter of those it holds, and that
collection walks every tracked object (170,000-290,000 in a process that
has imported torch) with every thread stopped. On an H100 host one took
55-937 ms; fired inside a run, it stalled every replica's waves and the
requests queued behind them (tail latency 2-3x). From a collected heap
a run meets one only once its own promotions reach that quarter, which
runs of a few hundred batches (the stream benchmark's) do not.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import Request
from repro_torch.serving.frontdoor import (AdmissionError,
                                           DeadlineShedError, FrontDoor)
from repro_torch.serving.slo import SLOTracker
from repro_torch.streaming.learner import StreamLearner
from repro_torch.streaming.sources import (StreamConfig, StreamSource,
                                           _log_event)


@dataclass
class StreamResponse:
    """Per-request serving result: the prediction plus the weight
    version that produced it (what staleness accounting keys on).
    Duck-type compatible with the front door's reaper (request_id,
    latency_s)."""
    request_id: int
    pred: int
    proba: float
    version: int
    latency_s: float


class OnlineServingEngine:
    """Engine body for `ServingReplica` in the streaming plane: logistic
    scoring with hot-swappable weights. `serve` is one wave; the swap
    check runs at wave start only — between waves by construction."""

    def __init__(self, name: str, dim: int, swap: bool = True,
                 tracker: Optional[SLOTracker] = None,
                 base_s: float = 0.002, per_req_s: float = 0.0002):
        self.name = name
        self.dim = dim
        self.swap = swap
        self.tracker = tracker
        self.base_s = base_s
        self.per_req_s = per_req_s
        self.version = 0
        self.meta: Dict[str, Any] = {}
        self._w = np.zeros(dim, np.float64)
        self._b = 0.0
        self.swaps = 0

    def maybe_swap(self) -> bool:
        """Hot-swap to the newest published version if one exists. The
        version-pinned `fetch_latest` retries through republish races,
        so this can never surface `ObjectReclaimedError` mid-wave. A
        swap that fails for any other reason (publisher node died with
        its shards, fetch timed out) keeps the current weights — a
        swap must never take a wave down with it."""
        from repro_torch.compute.params import ParamSet
        h = ParamSet.latest(self.name)
        if h is None or h.version <= self.version:
            return False
        try:
            got = ParamSet.fetch_latest(self.name, timeout=2.0)
        except Exception:
            return False
        if got is None:
            return False
        ps, tree = got
        if ps.version <= self.version:
            return False
        lag = ps.version - self.version
        self._w = np.asarray(tree["w"], np.float64).reshape(-1)
        self._b = float(np.asarray(tree["b"]))
        self.version = ps.version
        self.meta = dict(ps.meta)
        self.swaps += 1
        if self.tracker is not None:
            self.tracker.record_swap(ps.version)
        _log_event("weight_swap", f"{self.name}@v{ps.version}", lag=lag)
        return True

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        z = np.clip(x @ self._w + self._b, -30.0, 30.0)
        return 1.0 / (1.0 + np.exp(-z))

    def serve(self, requests, max_wave: int = 8) -> List[StreamResponse]:
        if self.swap:
            self.maybe_swap()
        n = len(requests)
        x = np.stack([np.asarray(r.prompt, np.float64) for r in requests])
        p = self.predict_proba(x)
        if self.base_s or self.per_req_s:
            time.sleep(self.base_s + self.per_req_s * n)
        now = time.perf_counter()
        return [StreamResponse(r.request_id, int(pi > 0.5), float(pi),
                               self.version, now - r.created)
                for r, pi in zip(requests, p)]


class StreamingPipeline:
    """Wires one `StreamSource`, one `StreamLearner` (checkpointed
    actor, compiled per-step graph), and one `FrontDoor` over
    `OnlineServingEngine` replicas into a train-while-serve loop.

    `run(num_batches)` drives the whole loop from the caller's thread:
    pump/take mini-batches, execute learner steps, submit a slice of
    every batch's rows as serving requests (bulk + feedback tenancy),
    resolve tickets with staleness accounting, and ack consumed batches
    so the GC reclaims them. Returns the measurement record the stream
    bench gates on."""

    def __init__(self, cfg: StreamConfig, *,
                 name: str = "stream",
                 lr: float = 0.8,
                 publish_every: int = 8,
                 on_drift: str = "reset",
                 checkpoint_interval: int = 16,
                 max_ahead: int = 8,
                 source_policy: str = "block",
                 swap: bool = True,
                 num_replicas: int = 1,
                 max_replicas: int = 2,
                 deadline_s: float = 0.25,
                 target_wave_s: float = 0.02,
                 max_batch: int = 16,
                 max_queue: int = 512,
                 serve_per_batch: int = 8,
                 feedback_fraction: float = 0.25,
                 engine_base_s: float = 0.002,
                 engine_per_req_s: float = 0.0002,
                 resources: Optional[Dict[str, float]] = None,
                 cluster=None):
        from repro_torch import core, dag
        from repro_torch.core import api as core_api
        self._core = core
        self._dag = dag
        self.cfg = cfg
        self.name = name
        self.deadline_s = deadline_s
        self.serve_per_batch = serve_per_batch
        self.feedback_fraction = feedback_fraction
        self.cluster = cluster if cluster is not None \
            else core_api._cluster()

        res = resources if resources is not None else {"cpu": 0.25}
        src_cls = core.remote(StreamSource).options(resources=res)
        lrn_cls = core.remote(StreamLearner).options(
            resources=res, checkpoint_interval=checkpoint_interval)
        self.source = src_cls.submit(cfg, max_ahead=max_ahead,
                                     policy=source_policy)
        self.learner = lrn_cls.submit(name, cfg.dim, lr=lr,
                                      publish_every=publish_every,
                                      on_drift=on_drift)
        # compiled per-step graph: one plan, executed once per mini-batch
        self._step_graph = dag.compile(
            self.learner.step.bind(dag.input(0)))

        self.frontdoor = FrontDoor(
            lambda: OnlineServingEngine(
                name, cfg.dim, swap=swap, tracker=None,
                base_s=engine_base_s, per_req_s=engine_per_req_s),
            num_replicas=num_replicas, min_replicas=num_replicas,
            max_replicas=max_replicas, max_queue=max_queue,
            default_deadline_s=deadline_s, target_wave_s=target_wave_s,
            max_batch=max_batch, resources=res, cluster=self.cluster)
        # the tracker exists only after FrontDoor construction: rebind
        # the engine factory so replicas carry it, and rebuild the
        # initial replica set with the tracker-carrying factory
        tracker = self.frontdoor.slo
        self.frontdoor._engine_factory = lambda: OnlineServingEngine(
            name, cfg.dim, swap=swap, tracker=tracker,
            base_s=engine_base_s, per_req_s=engine_per_req_s)
        for replica in list(self.frontdoor._replicas):
            self.frontdoor._retire_replica(replica, "streaming_rebind")
        for _ in range(self.frontdoor.min_replicas):
            self.frontdoor._spawn_replica("streaming_rebind")

        self._version_t: Dict[int, float] = {}   # version -> stream t
        self.metrics: List[Dict[str, Any]] = []
        # per served request: (step, online_correct, frozen_correct,
        # version) — the bench's accuracy series
        self.samples: List[Tuple[int, int, int, int]] = []
        self.lost_steps = 0
        self.unresolved = 0
        self.rejected = 0
        self._frozen: Optional[Tuple[np.ndarray, float]] = None

    # ---------------------------------------------------------- internals

    def _maybe_capture_frozen(self) -> None:
        """Freeze the earliest observable published version as the
        baseline arm: the model a deployment that never retrains would
        serve for the rest of the run."""
        if self._frozen is not None:
            return
        from repro_torch.compute.params import ParamSet
        try:
            got = ParamSet.fetch_latest(self.name, timeout=5.0)
        except Exception:  # pragma: no cover - racy / publisher died
            return
        if got is None:
            return
        ps, tree = got
        self._frozen = (
            np.asarray(tree["w"], np.float64).reshape(-1).copy(),
            float(np.asarray(tree["b"])))
        self._version_t.setdefault(
            ps.version, float(ps.meta.get("stream_t", 0.0)))

    def _trained_through_t(self, version: int) -> float:
        """Stream time the given weight version had trained through
        (from publish meta; cached, falls back to 0 for aged-out
        handles)."""
        t = self._version_t.get(version)
        if t is not None:
            return t
        from repro_torch.compute.params import ParamSet
        h = ParamSet.at(self.name, version)
        t = float(h.meta.get("stream_t", 0.0)) if h is not None else 0.0
        self._version_t[version] = t
        return t

    def _submit_serving(self, batch, tickets: List) -> None:
        n = min(self.serve_per_batch, len(batch.y))
        n_feedback = int(round(n * self.feedback_fraction))
        for j in range(n):
            pri = 1 if j < n_feedback else 0
            req = Request(next(self.frontdoor._req_ids),
                          batch.x[j].astype(np.float32),
                          max_new_tokens=1, priority=pri)
            try:
                t = self.frontdoor.submit_request(
                    req, deadline_s=self.deadline_s)
            except AdmissionError:
                self.rejected += 1
                continue
            tickets.append((t, batch.x[j].astype(np.float64),
                            float(batch.y[j]), batch.step, batch.t))

    def _frozen_pred(self, x: np.ndarray) -> int:
        if self._frozen is None:
            return 0
        w, b = self._frozen
        return int(float(x @ w + b) > 0.0)

    def _resolve_tickets(self, tickets: List, stream_head_t: float,
                         block: bool) -> List:
        slo = self.frontdoor.slo
        still: List = []
        for item in tickets:
            ticket, x, y, step, t = item
            if not block and not ticket.done():
                still.append(item)
                continue
            try:
                resp = ticket.result(timeout=30.0 if block else 0.0)
            except TimeoutError:
                if ticket.done():
                    continue    # disposed *with* TimeoutError (abandoned)
                if block:
                    # the door may dispose it microseconds after our
                    # wait expired — grant one grace period before
                    # declaring it hung
                    time.sleep(0.25)
                    if ticket.done():
                        continue
                self.unresolved += 1     # genuinely hung — the gate's foe
                continue
            except (DeadlineShedError, RuntimeError,
                    self._core.TaskError):
                continue                 # typed disposition — counted
            lag = max(0, slo.published_version - resp.version)
            behind = max(0.0, stream_head_t
                         - self._trained_through_t(resp.version))
            slo.record_staleness(lag, behind)
            online = int(resp.pred == int(y > 0.5))
            frozen = int(self._frozen_pred(x) == int(y > 0.5))
            self.samples.append((step, online, frozen, resp.version))
        return still

    def _reap_steps(self, pending: List, block: bool
                    ) -> Tuple[List, List[str]]:
        """Collect finished learner-step refs: fold metrics, free the
        outputs, return the consumed batch oids to ack."""
        if not pending:
            return pending, []
        refs = [p[0] for p in pending]
        if block:
            done_refs = []
            for r in refs:
                try:
                    self._core.wait([r], num_returns=1, timeout=20.0)
                except Exception:  # noqa: BLE001
                    pass
                done_refs.append(r)
            done = set(ref.id for ref in done_refs)
        else:
            d, _ = self._core.wait(refs, num_returns=len(refs), timeout=0)
            done = set(ref.id for ref in d)
        slo = self.frontdoor.slo
        still, acked = [], []
        for item in pending:
            ref, oid = item
            if ref.id not in done:
                still.append(item)
                continue
            try:
                m = self._core.get(ref, timeout=10.0)
                self.metrics.append(m)
                if m.get("version"):
                    slo.record_publish(m["version"])
                    self._version_t[m["version"]] = m["t"]
            except Exception:  # noqa: BLE001 - killed-node step lost
                self.lost_steps += 1
            acked.append(oid)
            try:
                self._core.free([ref])
            except Exception:  # noqa: BLE001
                pass
        return still, acked

    # -------------------------------------------------------------- run

    def run(self, num_batches: int, pump_chunk: int = 4,
            mid_run=None) -> Dict[str, Any]:
        """Drive the loop until `num_batches` mini-batches have been
        taken from the source. `mid_run(consumed)` fires once per loop
        pass (fault-injection hook for the bench's learner-kill
        scenario). The run starts with a full collection, so that the
        next collection of the oldest generation waits for the run's own
        promotions."""
        gc.collect()
        core = self._core
        pending: List[Tuple[Any, str]] = []       # (step ref, batch oid)
        tickets: List = []
        consumed = 0
        buffered = 0          # made by the source, not yet taken
        stream_head_t = 0.0
        deadline = time.perf_counter() + max(60.0, num_batches * 2.0)
        while consumed < num_batches:
            if time.perf_counter() > deadline:   # pragma: no cover
                break
            if mid_run is not None:
                mid_run(consumed)
            # pump/take tolerate transient actor-recovery errors (node
            # kill mid-run): a failed round is a stall, not a crash.
            # Pump only what the run still needs beyond the buffer.
            need = num_batches - consumed - buffered
            try:
                st = core.get(self.source.pump.submit(
                    max(0, min(pump_chunk, need))), timeout=30.0)
                buffered = st["buffered"]
                want = min(pump_chunk, num_batches - consumed)
                taken = core.get(self.source.take.submit(want),
                                 timeout=30.0)
                buffered -= len(taken)
            except Exception:  # noqa: BLE001 - source replaying
                taken = []
            for oid, step, t in taken:
                stream_head_t = max(stream_head_t, t)
                try:
                    batch = core.get(core.ObjectRef(oid), timeout=10.0)
                except Exception:  # noqa: BLE001 - source died mid-take
                    self.lost_steps += 1
                    consumed += 1
                    continue
                ref = self._step_graph.execute(core.ObjectRef(oid))
                pending.append((ref, oid))
                self._submit_serving(batch, tickets)
                consumed += 1
            self._maybe_capture_frozen()
            pending, acked = self._reap_steps(pending, block=False)
            if acked:
                try:
                    core.get(self.source.ack.submit(acked), timeout=30.0)
                except Exception:  # noqa: BLE001 - source replaying
                    pass
            tickets = self._resolve_tickets(tickets, stream_head_t,
                                            block=False)
            if not taken:
                time.sleep(0.002)        # back-pressured: learner lags
        # drain: every step resolved, every ticket disposed
        pending, acked = self._reap_steps(pending, block=True)
        if acked:
            try:
                core.get(self.source.ack.submit(acked), timeout=30.0)
            except Exception:  # noqa: BLE001
                pass
        for item in pending:             # steps that never resolved
            self.lost_steps += 1
            try:
                core.free([item[0]])
            except Exception:  # noqa: BLE001
                pass
        # `run` pumps no more than it needs, but a pump or take round
        # lost to a node kill may leave batches in the buffer — take and
        # ack the leftovers so the source holds no batch refs after the run
        try:
            left = core.get(self.source.take.submit(pump_chunk * 2),
                            timeout=10.0)
            if left:
                core.get(self.source.ack.submit([o for o, _, _ in left]),
                         timeout=10.0)
        except Exception:  # noqa: BLE001 - source already gone
            pass
        tickets = self._resolve_tickets(tickets, stream_head_t,
                                        block=True)
        self.unresolved += len(tickets)
        return self.report(stream_head_t)

    # ----------------------------------------------------------- report

    def rolling_accuracy(self, window: int = 200
                         ) -> List[Tuple[int, float, float]]:
        """(step, online_acc, frozen_acc) rolling over the last `window`
        served samples, ordered by stream step."""
        samples = sorted(self.samples)
        out = []
        for i in range(len(samples)):
            lo = max(0, i - window + 1)
            chunk = samples[lo:i + 1]
            out.append((samples[i][0],
                        sum(c[1] for c in chunk) / len(chunk),
                        sum(c[2] for c in chunk) / len(chunk)))
        return out

    def accuracy_after(self, step: int) -> Tuple[float, float, int]:
        """(online, frozen, n) accuracy over samples at/after `step`."""
        post = [s for s in self.samples if s[0] >= step]
        if not post:
            return 0.0, 0.0, 0
        return (sum(s[1] for s in post) / len(post),
                sum(s[2] for s in post) / len(post), len(post))

    def report(self, stream_head_t: float) -> Dict[str, Any]:
        snap = self.frontdoor.stats()
        learner_stats: Dict[str, Any] = {}
        source_stats: Dict[str, Any] = {}
        try:
            learner_stats = self._core.get(
                self.learner.stats.submit(), timeout=20.0)
        except Exception:  # noqa: BLE001 - learner unrecoverable
            pass
        try:
            source_stats = self._core.get(
                self.source.stats.submit(), timeout=20.0)
        except Exception:  # noqa: BLE001
            pass
        return {
            "slo": snap,
            "learner": learner_stats,
            "source": source_stats,
            "served_samples": len(self.samples),
            "learner_steps_folded": len(self.metrics),
            "lost_steps": self.lost_steps,
            "unresolved": self.unresolved,
            "rejected_at_door": self.rejected,
            "stream_head_t": stream_head_t,
        }

    def close(self, timeout: float = 30.0) -> None:
        self.frontdoor.close(timeout=timeout)
