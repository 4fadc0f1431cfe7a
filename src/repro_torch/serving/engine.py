"""Serving engine: batched prefill + iteration-batched greedy decode. The
port of `repro.serving.engine` (Request, Response, length_aligned_waves,
ServingEngine, ServingReplica, ReplicaPool).

Requests are grouped into *waves* of equal prompt length. A wave's prompts
share one batched prefill, then all lanes decode in lock-step with one
`decode_step` per token (one shared position clock, so the KV-cache write
slot is uniform across lanes). Lanes that reach their token budget are
masked out but keep riding the batch until the wave drains.

The engine runs on the card unless `device="cpu"` is passed. On the card,
prefill's attention is the Hopper flash attention kernel, and a Mamba
layer's scan (jamba) is the Hopper ssm_scan kernel in prefill and decode;
an mLSTM layer runs the mlstm_scan kernel likewise. Each engine on the
card runs its waves on a CUDA stream of its own and waits for that stream
alone, so engines that share one card (replica actors, each on its own
thread) do not wait for each other's waves. The weights are read-only and
may be shared by every engine on the card.

Scale-out: `ReplicaPool` runs N `ServingReplica` *actors* (stateful
`@remote` classes) on the port's runtime (`repro_torch.core`) — each
replica holds its own engine (model state never round-trips through the
object store), waves dispatch to the replica with the fewest outstanding
waves, and a replica lost to node failure is restarted and its in-flight
waves replayed by the actor runtime. The open-loop tier above the
replicas (admission control, deadline queueing, adaptive batching,
autoscaling) lives in `repro_torch.serving.frontdoor`.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.bridge import params_to
from repro_torch.core.worker import current_node, current_task
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    created: float = field(default_factory=time.perf_counter)
    # tenancy class: orders requests *within a deadline bucket* in the
    # front door's EDF queue (higher first) — deadlines still dominate
    # across buckets. 0 = bulk.
    priority: int = 0


@dataclass
class Response:
    request_id: int
    tokens: List[int]
    latency_s: float


def length_aligned_waves(requests: List[Request], max_wave: int
                         ) -> List[List[Request]]:
    """Group requests by prompt length and chunk into waves of at most
    `max_wave` (equal lengths per wave keep prefill and decode one batch)."""
    by_len: Dict[int, List[Request]] = defaultdict(list)
    for r in requests:
        by_len[len(r.prompt)].append(r)
    waves = []
    for _, group in sorted(by_len.items()):
        for i in range(0, len(group), max_wave):
            waves.append(group[i:i + max_wave])
    return waves


class ServingEngine:
    def __init__(self, model: Model, params, max_seq: int = 512,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to(params, self.device)
        self.max_seq = max_seq
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the weights may still be in flight on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    @torch.inference_mode()
    def _run_wave(self, wave: List[Request]) -> List[Response]:
        prompts = np.stack([r.prompt for r in wave])        # equal lengths
        b, s = prompts.shape
        budgets = np.array([r.max_new_tokens for r in wave])
        outs: List[List[int]] = [[] for _ in wave]
        # on the card the whole wave runs on this engine's stream, and only
        # that stream is waited for (a no-op context on the CPU)
        with torch.cuda.stream(self._stream):
            tokens = torch.from_numpy(prompts.astype(np.int64)).to(
                self.device)
            logits, cache = self.model.prefill(
                self.params, {"tokens": tokens}, max_seq=self.max_seq)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            for step in range(int(budgets.max())):
                alive = step < budgets
                host_tok = tok[:, 0].cpu().numpy()
                for i in range(b):
                    if alive[i]:
                        outs[i].append(int(host_tok[i]))
                if step == budgets.max() - 1 or s + step >= self.max_seq - 1:
                    break
                logits, cache = self.model.decode_step(self.params, cache,
                                                       tok, s + step)
                tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            if self._stream is not None:
                self._stream.synchronize()
        now = time.perf_counter()
        return [Response(r.request_id, o, now - r.created)
                for r, o in zip(wave, outs)]

    def serve(self, requests: List[Request], max_wave: int = 8
              ) -> List[Response]:
        """Run length-aligned waves sequentially on this engine."""
        responses: List[Response] = []
        for wave in length_aligned_waves(requests, max_wave):
            responses.extend(self._run_wave(wave))
        return responses

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 16
                 ) -> List[int]:
        r = Request(0, np.asarray(prompt, np.int32), max_new_tokens)
        return self._run_wave([r])[0].tokens


class ServingReplica:
    """Actor body: one engine replica. The factory runs inside the actor's
    constructor, so the engine lives on the owning node and a restarted
    incarnation rebuilds it from scratch (engine state is derivable;
    request state is replayed by the actor runtime). A factory that closes
    over weights already on the card builds the engine without a copy."""

    def __init__(self, engine_factory: Callable[[], "ServingEngine"]):
        self.engine = engine_factory()
        self.waves_served = 0
        self.requests_served = 0

    def serve_wave(self, requests) -> List[Response]:
        """Run one pre-chunked, length-aligned wave as a single batch —
        the pool already applied its max_wave, so don't re-chunk at the
        engine's default. Logs the engine's own time as a `serve_engine`
        event of this task."""
        self.waves_served += 1
        self.requests_served += len(requests)
        t0 = time.perf_counter()
        responses = self.engine.serve(list(requests),
                                      max_wave=max(len(requests), 1))
        node, spec = current_node(), current_task()
        if node is not None and spec is not None:
            node.gcs.log_event("serve_engine", spec.task_id,
                               f"node{node.node_id}",
                               ms=(time.perf_counter() - t0) * 1e3)
        return responses

    def stats(self) -> Dict[str, int]:
        return {"waves_served": self.waves_served,
                "requests_served": self.requests_served}


class ReplicaPool:
    """Actor-backed serving tier: N `ServingReplica` actors placed by the
    global scheduler (spread across nodes by the standing-reservation
    penalty), with wait-based straggler routing — each wave goes to the
    replica with the fewest unfinished waves, measured by reaping
    completed futures with a zero-timeout `wait` at dispatch time. Wave
    futures are ordinary ObjectRefs: compose with get/wait downstream.

    Waves are dispatched as *compiled graphs*: one
    `serve_wave.bind(dag.input(0))` plan per replica is compiled at pool
    construction, and every wave replays it — the per-request
    orchestration is amortized across the pool's whole serving life."""

    #: bounded per-wave redispatch: a wave that errors (replica sealed
    #: unrecoverable) is re-run on a respawned replica at most this many
    #: times before the error propagates to the caller
    MAX_REDISPATCH = 2

    def __init__(self, engine_factory: Callable[[], "ServingEngine"],
                 num_replicas: int = 2,
                 resources: Dict[str, float] = None):
        from repro_torch import core, dag
        self._core = core
        self._dag = dag
        self._engine_factory = engine_factory
        actor_cls = core.remote(ServingReplica)
        if resources is not None:
            actor_cls = actor_cls.options(resources=resources)
        self._actor_cls = actor_cls
        self.replicas = [actor_cls.submit(engine_factory)
                         for _ in range(num_replicas)]
        self._wave_graphs = [
            dag.compile(r.serve_wave.bind(dag.input(0)))
            for r in self.replicas]
        self._inflight: Dict[int, List] = {
            i: [] for i in range(num_replicas)}
        # ref.id -> (replica idx, requests, redispatch attempt): names
        # replica assignments in timeout errors and carries what a
        # failed wave needs to re-run on a respawned replica
        self._wave_meta: Dict[str, tuple] = {}

    def submit_wave(self, requests: List[Request], _attempt: int = 0):
        """Dispatch one wave (a compiled-graph invocation on the least
        loaded replica); returns the ObjectRef of its responses."""
        core = self._core
        for i, refs in self._inflight.items():
            if refs:
                _, pending = core.wait(refs, num_returns=len(refs),
                                       timeout=0)
                for r in refs:
                    if r not in pending:
                        self._wave_meta.pop(r.id, None)
                self._inflight[i] = pending
        idx = min(self._inflight, key=lambda i: len(self._inflight[i]))
        ref = self._wave_graphs[idx].execute(tuple(requests))
        self._inflight[idx].append(ref)
        self._wave_meta[ref.id] = (idx, tuple(requests), _attempt)
        return ref

    def respawn_replica(self, idx: int) -> None:
        """Replace a dead replica with a fresh actor (new engine built
        by the stored factory) and recompile its wave plan. The old
        incarnation's in-flight refs stay tracked by their waiters —
        they resolve via actor replay or surface typed errors."""
        self.replicas[idx] = self._actor_cls.submit(self._engine_factory)
        self._wave_graphs[idx] = self._dag.compile(
            self.replicas[idx].serve_wave.bind(self._dag.input(0)))
        self._inflight[idx] = []

    def serve(self, requests: List[Request], max_wave: int = 8,
              timeout: float = 300.0) -> List[Response]:
        """Group by prompt length, fan waves across the replica set, and
        collect responses in completion order (stragglers never gate the
        batch). Raises TimeoutError if the whole batch has not drained
        within `timeout` — a permanently lost wave must surface, not
        spin.

        Consumed wave outputs are freed as soon as their responses are
        extracted: under sustained request churn the replicas' object
        stores hold only in-flight waves (bounded cache), instead of
        accreting every response batch ever served."""
        from repro_torch.core import TaskError
        wave_refs = [self.submit_wave(wave)
                     for wave in length_aligned_waves(requests, max_wave)]
        responses: List[Response] = []
        pending = wave_refs
        deadline = time.perf_counter() + timeout
        while pending:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                where = ", ".join(
                    f"{r.id}->replica"
                    f"{self._wave_meta.get(r.id, ('?',))[0]}"
                    for r in pending)
                elapsed = time.perf_counter() - (deadline - timeout)
                queue_depth = sum(
                    len(self._wave_meta.get(r.id, (0, ()))[1])
                    for r in pending)
                # free before raising: an abandoned wave must not pin
                # store memory for the life of the pool
                self._core.free(pending)
                for r in pending:
                    self._wave_meta.pop(r.id, None)
                raise TimeoutError(
                    f"{len(pending)} serving wave(s) ({queue_depth} "
                    f"request(s)) incomplete after {elapsed:.1f}s elapsed "
                    f"vs {timeout}s deadline (pending refs freed): {where}")
            done, pending = self._core.wait(
                pending, num_returns=1, timeout=min(remaining, 30.0))
            for ref in done:
                meta = self._wave_meta.pop(ref.id, None)
                try:
                    responses.extend(self._core.get(ref))
                except TaskError:
                    # replica sealed/unrecoverable: respawn it and
                    # re-run the wave, bounded per wave so a wave that
                    # fails deterministically still surfaces
                    if meta is None or meta[2] >= self.MAX_REDISPATCH:
                        raise
                    idx, reqs, attempt = meta
                    self.respawn_replica(idx)
                    pending.append(
                        self.submit_wave(list(reqs), attempt + 1))
            if done:
                # eager reclaim: the wait() reaping in submit_wave
                # counts freed futures as done, so in-flight accounting
                # stays correct
                self._core.free(done)
        return responses

    def stats(self) -> List[Dict[str, int]]:
        # submit all first so the N round trips overlap
        refs = [r.stats.submit() for r in self.replicas]
        return [self._core.get(ref) for ref in refs]
