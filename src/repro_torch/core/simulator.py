"""Deterministic discrete-event simulator of the hybrid-scheduler cluster:
the port of `repro.core.simulator`, plain Python on the host. Its
scenarios return the reference's dicts for the same arguments
(tests/test_torch_simulator.py).

The thread-based runtime validates the architecture at ~10 nodes; this DES
runs the SAME policies (local-first dispatch, spillover threshold, global
locality/load placement, lineage-replay on failure) at 1,000-4,096 nodes to
validate the paper's R1/R2 claims at scale without hardware:

  * task throughput vs node count (aggregate millions of tasks/s),
  * scheduling latency distribution (local vs spilled vs actor lanes),
  * straggler mitigation via wait-style completion-order consumption,
  * elastic scale-up/down and node failure with task re-execution,
  * stateful actors: FIFO method lanes pinned to owning nodes, with
    relocation + call replay on node death (cost `actor_call_s`,
    calibrated from the runtime's measured method round trip),
  * bounded object stores: per-node occupancy charged by task
    `output_bytes`, oldest-first eviction past `store_capacity_bytes`
    (cost `evict_s`, calibrated from the churn benchmark's measured GC
    reclaim latency), and free-store-aware global placement.

Time is virtual; costs are parameters measured from the real runtime's
microbenchmarks (benchmarks/microbench.py writes them to JSON). Those
files are the reference's records, taken on a CPU host: `from_microbench`
reads them as the reference does, and no default of the port takes them
for the card's. A run that models the card passes a measured
`SimCosts(kernel_step_s=...)` (chip_smoke.py phase 8d).
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class SimCosts:
    local_sched_s: float = 10e-6     # local scheduler decision
    global_sched_s: float = 50e-6    # spill + global decision + rpc
    worker_overhead_s: float = 15e-6 # dequeue/arg-resolve/result-store
    gcs_op_s: float = 3e-6           # control-plane write
    actor_call_s: float = 20e-6      # seq issue + log + mailbox dispatch
    evict_s: float = 5e-6            # LRU eviction / GC reclaim per object
    graph_dispatch_s: float = 30e-6  # compiled-graph invocation: one
                                     # batched registration + grouped
                                     # root handoff (charged once per
                                     # execute; chained nodes then run
                                     # with no per-task scheduling cost)
    kernel_step_s: float = 500e-6    # one device kernel step end to end
                                     # (dispatch + on-device time),
                                     # calibrated from BENCH_compute.json
                                     # kernel_task_e2e when present

    @classmethod
    def from_microbench(cls, path: str = "BENCH_core.json",
                        run: Optional[str] = None,
                        compute_path: str = "BENCH_compute.json"
                        ) -> "SimCosts":
        """Calibrate the cost model from measured runtime latencies
        (benchmarks/microbench.py writes BENCH_core.json at the repo
        root). Mapping: submit p50 -> local scheduling cost; gcs_put p50
        -> control-plane op; e2e_local p50 minus submit and get costs ->
        worker overhead; global scheduling is modeled as a local decision
        plus two extra control-plane hops. Falls back to the defaults
        when the file or run is absent."""
        import json
        import pathlib
        # device kernel step: the compute bench's measured kernel-task
        # round trip (BENCH_compute.json, written by compute_bench.py).
        # Calibrated independently of the core file so a compute-only
        # record still takes effect.
        kernel_step = cls.kernel_step_s
        cp = pathlib.Path(compute_path)
        if cp.exists():
            try:
                cdoc = json.loads(cp.read_text())
                cruns = cdoc.get("runs", {})
                cdata = (cruns.get(run) if run else None) \
                    or (cruns.get(cdoc.get("speedup_run"))
                        if cdoc.get("speedup_run") else None) \
                    or (next(iter(cruns.values())) if cruns else None)
                if cdata and "kernel_task_e2e" in cdata:
                    kernel_step = max(
                        cdata["kernel_task_e2e"]["p50_us"] * 1e-6, 1e-6)
            except (OSError, json.JSONDecodeError, KeyError,
                    TypeError):  # pragma: no cover
                pass
        p = pathlib.Path(path)
        if not p.exists():
            return cls(kernel_step_s=kernel_step)
        try:
            doc = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):  # pragma: no cover
            return cls(kernel_step_s=kernel_step)
        runs = doc.get("runs", {})
        data = runs.get(run) if run else None
        if data is None:
            # default to the most recently recorded run (microbench
            # stamps it in "speedup_run"), then older fallbacks
            latest = doc.get("speedup_run")
            data = (runs.get(latest) if latest else None) \
                or runs.get("pr2") or runs.get("pr1") or runs.get("seed")
        if not data:
            return cls(kernel_step_s=kernel_step)
        try:
            us = 1e-6
            submit = data["submit"]["p50_us"] * us
            gcs_op = data["gcs_put"]["p50_us"] * us
            get_done = data["get_done"]["p50_us"] * us
            e2e = data["e2e_local"]["p50_us"] * us
        except (KeyError, TypeError):  # pragma: no cover
            return cls(kernel_step_s=kernel_step)
        worker = max(e2e - submit - get_done, 1e-6)
        # actor dispatch overhead: measured method round trip minus the
        # submit and get legs (mirrors the worker-overhead derivation);
        # absent from pre-actor runs, fall back to the default
        actor = cls.actor_call_s
        if "actor_call" in data:
            try:
                actor = max(
                    data["actor_call"]["p50_us"] * us - submit - get_done,
                    1e-6)
            except (KeyError, TypeError):  # pragma: no cover
                pass
        # eviction/reclaim cost: the churn benchmark's measured GC
        # reclaim latency (absent from pre-memory-governance runs)
        evict = cls.evict_s
        churn = data.get("churn")
        if isinstance(churn, dict):
            try:
                evict = max(churn["reclaim_us"]["p50_us"] * us, 1e-7)
            except (KeyError, TypeError):  # pragma: no cover
                pass
        # compiled-graph dispatch: the graph_step A/B measures a 3-node
        # compiled chain end to end — the per-invocation batched
        # dispatch overhead is what it costs beyond one plain local
        # round trip (absent from pre-dag runs)
        graph_dispatch = cls.graph_dispatch_s
        gstep = data.get("graph_step")
        if isinstance(gstep, dict):
            try:
                graph_dispatch = max(
                    gstep["compiled"]["p50_us"] * us - e2e, 1e-6)
            except (KeyError, TypeError):  # pragma: no cover
                pass
        return cls(local_sched_s=max(submit, 1e-7),
                   global_sched_s=max(submit + 2 * gcs_op, 2e-7),
                   worker_overhead_s=worker,
                   gcs_op_s=max(gcs_op, 1e-8),
                   actor_call_s=actor,
                   evict_s=evict,
                   graph_dispatch_s=graph_dispatch,
                   kernel_step_s=kernel_step)


@dataclass
class SimTask:
    task_id: int
    duration_s: float
    submit_node: int
    resources: Dict[str, float] = field(default_factory=lambda: {"cpu": 1.0})
    submit_t: float = 0.0
    start_t: float = 0.0
    finish_t: float = 0.0
    node: int = -1
    spilled: bool = False
    attempts: int = 0
    actor_id: int = -1               # >= 0: a method call on that actor
    output_bytes: int = 0            # store occupancy charged at finish
    chain: Optional["SimTask"] = None  # compiled-graph successor: runs
                                       # inline on the finishing node
                                       # (no scheduling event)


class SimActor:
    """One stateful actor in the DES: a FIFO lane pinned to its owning
    node — method calls bypass placement, queue behind each other, and
    replay onto a relocated incarnation when the node dies (mirroring the
    runtime's mailbox + log-replay design)."""
    __slots__ = ("actor_id", "node_id", "queue", "running", "calls_done")

    def __init__(self, actor_id: int, node_id: int):
        self.actor_id = actor_id
        self.node_id = node_id
        self.queue: List[SimTask] = []
        self.running: Optional[SimTask] = None
        self.calls_done = 0


class SimNode:
    def __init__(self, node_id: int, num_workers: int,
                 resources: Optional[Dict[str, float]] = None,
                 store_capacity_bytes: Optional[int] = None):
        self.node_id = node_id
        self.capacity = dict(resources or {"cpu": float(num_workers)})
        self.avail = dict(self.capacity)
        self.backlog: List[SimTask] = []
        self.running: Dict[int, SimTask] = {}
        self.alive = True
        # bounded-store model: FIFO of finished outputs, evicted oldest
        # first when occupancy exceeds capacity (mirrors the runtime's
        # LRU under a steady produce-consume stream)
        self.store_capacity_bytes = store_capacity_bytes
        self.store_used = 0
        self.store_q: List[Tuple[int, int]] = []   # (task_id, bytes)
        self.evictions = 0

    def store_put(self, task: SimTask, evict_cost_s: float
                  ) -> Tuple[int, float]:
        """Charge one finished output to the store; returns (evictions,
        modeled eviction delay) incurred to make room."""
        if not task.output_bytes:
            return 0, 0.0
        self.store_used += task.output_bytes
        self.store_q.append((task.task_id, task.output_bytes))
        n = 0
        while (self.store_capacity_bytes is not None
               and self.store_used > self.store_capacity_bytes
               and self.store_q):
            _, b = self.store_q.pop(0)
            self.store_used -= b
            self.evictions += 1
            n += 1
        return n, n * evict_cost_s

    def store_free(self) -> float:
        if self.store_capacity_bytes is None:
            return float("inf")
        return float(self.store_capacity_bytes - self.store_used)

    def can_run(self, t: SimTask) -> bool:
        return all(self.avail.get(k, 0.0) >= v
                   for k, v in t.resources.items())

    def satisfies(self, t: SimTask) -> bool:
        return all(self.capacity.get(k, 0.0) >= v
                   for k, v in t.resources.items())

    def acquire(self, t: SimTask):
        for k, v in t.resources.items():
            self.avail[k] -= v

    def release(self, t: SimTask):
        for k, v in t.resources.items():
            self.avail[k] = min(self.capacity.get(k, 0.0),
                                self.avail[k] + v)

    def load(self) -> int:
        return len(self.backlog) + len(self.running)


class ClusterSim:
    """Event-driven simulation. Events: (time, seq, kind, payload)."""

    def __init__(self, num_nodes: int, workers_per_node: int = 8,
                 costs: SimCosts = SimCosts(), spill_threshold: int = 4,
                 seed: int = 0, store_capacity_bytes: Optional[int] = None,
                 max_task_attempts: Optional[int] = None,
                 node_resources: Optional[List[Dict[str, float]]] = None):
        self.costs = costs
        self.spill_threshold = spill_threshold
        self.store_capacity_bytes = store_capacity_bytes
        if node_resources is not None:
            # explicit heterogeneous topology, mirroring the runtime's
            # Cluster(node_resources=[...]) — one capacity dict per node
            self.nodes = [SimNode(i, workers_per_node, resources=res,
                                  store_capacity_bytes=store_capacity_bytes)
                          for i, res in enumerate(node_resources)]
        else:
            self.nodes = [SimNode(i, workers_per_node,
                                  store_capacity_bytes=store_capacity_bytes)
                          for i in range(num_nodes)]
        self.now = 0.0
        self._eq: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self.rng = random.Random(seed)
        self.finished: List[SimTask] = []
        self.sched_latencies: List[Tuple[str, float]] = []
        self.failures_replayed = 0
        self.actors: List[SimActor] = []
        # bounded replay budget (mirrors the runtime's retry policy):
        # a task already started this many times is not replayed again
        # on node death — it lands in `failed_permanently`, the DES
        # analogue of sealing a TaskUnrecoverableError
        self.max_task_attempts = max_task_attempts
        self.failed_permanently: List[SimTask] = []

    @property
    def evictions(self) -> int:
        return sum(n.evictions for n in self.nodes)

    # ------------------------------------------------------------- events

    def _push(self, dt: float, kind: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self._eq, (self.now + dt, self._seq, kind, payload))

    def submit(self, task: SimTask, at: float = 0.0) -> None:
        task.submit_t = at
        self._seq += 1
        heapq.heappush(self._eq, (at, self._seq, "submit", task))

    def submit_chain(self, tasks: List[SimTask], at: float = 0.0) -> None:
        """Compiled-graph invocation: the whole chain is dispatched in
        one batched round (a single `graph_dispatch_s` charge on the
        head) and successors run inline on the finishing node with no
        per-task scheduling event — the DES model of `execute()` +
        worker inline chaining."""
        head, rest = tasks[0], tasks[1:]
        prev = head
        for t in rest:
            t.submit_node = head.submit_node
            t.submit_t = at
            prev.chain = t
            prev = t
        head.submit_t = at
        self._seq += 1
        heapq.heappush(self._eq, (at + self.costs.graph_dispatch_s,
                                  self._seq, "submit", head))

    # ------------------------------------------------------------- actors

    def create_actor(self, node_id: Optional[int] = None) -> int:
        """Place one actor (least-loaded live node when unspecified) and
        return its id; calls route to it via `submit_actor_call`."""
        if node_id is None:
            live = [n for n in self.nodes if n.alive]
            node_id = min(live, key=lambda n: n.load()).node_id
        actor = SimActor(len(self.actors), node_id)
        self.actors.append(actor)
        return actor.actor_id

    def submit_actor_call(self, actor_id: int, duration_s: float,
                          at: float = 0.0) -> SimTask:
        self._seq += 1
        task = SimTask(task_id=self._seq, duration_s=duration_s,
                       submit_node=-1, actor_id=actor_id)
        self.submit(task, at)
        return task

    def _actor_dispatch(self, task: SimTask) -> None:
        actor = self.actors[task.actor_id]
        if not self.nodes[actor.node_id].alive:
            self._relocate_actor(actor)
            if not self.nodes[actor.node_id].alive:
                # whole cluster down: park; an 'add' event revives it
                actor.queue.append(task)
                return
        # FIFO lane: a queued backlog (e.g. replayed calls awaiting the
        # relocation pump) always goes ahead of a fresh call
        if actor.running is None and not actor.queue:
            self._actor_start(actor, task)
        else:
            actor.queue.append(task)

    def _actor_start(self, actor: SimActor, task: SimTask) -> None:
        task.node = actor.node_id
        task.attempts += 1
        actor.running = task
        self.sched_latencies.append(
            ("actor", self.now + self.costs.actor_call_s - task.submit_t))
        task.start_t = self.now + self.costs.actor_call_s
        self._push(self.costs.actor_call_s + task.duration_s
                   + self.costs.gcs_op_s, "actor_finish",
                   (task, task.attempts, actor.actor_id))

    def _actor_finish(self, payload) -> None:
        task, attempt, actor_id = payload
        actor = self.actors[actor_id]
        if attempt != task.attempts or actor.running is not task:
            return  # stale attempt (actor was relocated mid-call)
        actor.running = None
        actor.calls_done += 1
        if not self.nodes[actor.node_id].alive:
            # result discarded; the kill path replays the call
            return
        task.finish_t = self.now
        self.finished.append(task)
        if actor.queue:
            self._actor_start(actor, actor.queue.pop(0))

    def _relocate_actor(self, actor: SimActor) -> None:
        """Node death: move the actor to a live node and replay its
        interrupted/queued calls there in order (log-replay semantics —
        cost is one global placement decision, charged via the pump
        event; the queue is preserved so a fresh call cannot jump ahead
        of replayed ones). With no live node the calls stay parked on
        the actor until an 'add' event revives it."""
        victims = ([actor.running] if actor.running is not None else [])
        victims += actor.queue
        actor.running = None
        actor.queue = victims
        live = [n for n in self.nodes if n.alive]
        if not live:
            return
        actor.node_id = min(live, key=lambda n: n.load()).node_id
        if victims:
            self.failures_replayed += len(victims)
            self._push(self.costs.global_sched_s, "actor_pump",
                       actor.actor_id)

    def _actor_pump(self, actor_id: int) -> None:
        """Restart a relocated actor's FIFO lane after the placement
        delay (finish events keep it draining from there)."""
        actor = self.actors[actor_id]
        if (actor.running is None and actor.queue
                and self.nodes[actor.node_id].alive):
            self._actor_start(actor, actor.queue.pop(0))

    # ------------------------------------------------------------ policies

    def _local_schedule(self, task: SimTask) -> None:
        node = self.nodes[task.submit_node]
        if node.alive and node.satisfies(task) and node.can_run(task):
            node.acquire(task)
            self._start(node, task, self.costs.local_sched_s, "local")
        elif (node.alive and node.satisfies(task)
              and len(node.backlog) < self.spill_threshold):
            node.backlog.append(task)
        else:
            task.spilled = True
            self._push(self.costs.global_sched_s, "global_place", task)

    def _global_place(self, task: SimTask) -> None:
        cands = [n for n in self.nodes if n.alive and n.satisfies(task)]
        if not cands:
            return  # unschedulable until topology changes
        # locality is approximated by preferring the submitting node, then
        # least-loaded of a random power-of-two-choices sample (scales O(1))
        sample = self.rng.sample(cands, min(2, len(cands)))
        home = self.nodes[task.submit_node]
        if home.alive and home.satisfies(task):
            sample.append(home)
        # memory-pressure-aware tiebreak (mirrors the runtime's
        # _select_node): equal load resolves toward free store bytes, so
        # big-output tasks land where memory is
        best = min(sample, key=lambda n: (n.load(), -n.store_free()))
        if best.can_run(task):
            best.acquire(task)
            self._start(best, task, 0.0, "global")
        else:
            best.backlog.append(task)

    def _start(self, node: SimNode, task: SimTask, extra_delay: float,
               how: str) -> None:
        task.node = node.node_id
        task.attempts += 1
        lat = self.now + extra_delay - task.submit_t
        self.sched_latencies.append((how, lat))
        task.start_t = self.now + extra_delay + self.costs.worker_overhead_s
        node.running[task.task_id] = task
        # finish events carry (task, attempt): a replayed task's stale
        # finish event from a dead node must not complete the new attempt
        self._push(extra_delay + self.costs.worker_overhead_s
                   + task.duration_s + self.costs.gcs_op_s, "finish",
                   (task, task.attempts, node.node_id))

    def _finish(self, payload) -> None:
        task, attempt, node_id = payload
        if attempt != task.attempts or node_id != task.node:
            return  # stale attempt (task was replayed elsewhere)
        node = self.nodes[node_id]
        node.running.pop(task.task_id, None)
        if not node.alive:
            return  # result discarded; replay was triggered by kill
        node.release(task)
        task.finish_t = self.now
        self.finished.append(task)
        # store the output; evictions under pressure delay the node's
        # next dispatch by the calibrated per-object eviction cost
        _, evict_delay = node.store_put(task, self.costs.evict_s)
        # compiled-graph chaining: the successor starts on this node
        # immediately (no scheduling event, no local_sched_s) — falls
        # back to normal submission if the node can't grant it now
        nxt = task.chain
        if nxt is not None:
            if node.alive and node.can_run(nxt):
                node.acquire(nxt)
                self._start(node, nxt, evict_delay, "chain")
            else:
                nxt.submit_node = node.node_id
                self._push(0.0, "submit", nxt)
        while node.backlog:
            nxt = next((t for t in node.backlog if node.can_run(t)), None)
            if nxt is None:
                break
            node.backlog.remove(nxt)
            node.acquire(nxt)
            self._start(node, nxt,
                        self.costs.local_sched_s + evict_delay, "backlog")

    # ------------------------------------------------------- fault inject

    def kill_node(self, node_id: int, at: float) -> None:
        self._seq += 1
        heapq.heappush(self._eq, (at, self._seq, "kill", node_id))

    def add_node(self, workers: int, at: float) -> None:
        self._seq += 1
        heapq.heappush(self._eq, (at, self._seq, "add", workers))

    def _do_kill(self, node_id: int) -> None:
        node = self.nodes[node_id]
        node.alive = False
        # lineage replay: every queued/running task resubmits elsewhere
        victims = list(node.running.values()) + node.backlog
        node.backlog = []
        for t in victims:
            if (self.max_task_attempts is not None
                    and t.attempts >= self.max_task_attempts):
                self.failed_permanently.append(t)
                continue
            self.failures_replayed += 1
            t.submit_node = self.rng.randrange(len(self.nodes))
            self._push(self.costs.global_sched_s, "global_place", t)
        # resident actors relocate and replay (mailbox + log semantics)
        for actor in self.actors:
            if actor.node_id == node_id:
                self._relocate_actor(actor)

    # ---------------------------------------------------------------- run

    def run(self, until: Optional[float] = None) -> None:
        while self._eq:
            t, _, kind, payload = heapq.heappop(self._eq)
            if until is not None and t > until:
                self.now = until
                return
            self.now = t
            if kind == "submit":
                if payload.actor_id >= 0:
                    self._actor_dispatch(payload)
                else:
                    self._local_schedule(payload)
            elif kind == "global_place":
                self._global_place(payload)
            elif kind == "finish":
                self._finish(payload)
            elif kind == "actor_finish":
                self._actor_finish(payload)
            elif kind == "actor_pump":
                self._actor_pump(payload)
            elif kind == "kill":
                self._do_kill(payload)
            elif kind == "add":
                self.nodes.append(SimNode(
                    len(self.nodes), payload,
                    store_capacity_bytes=self.store_capacity_bytes))
                # elastic rebalance: spill half of every backlog back to
                # the global scheduler so new capacity picks it up
                for node in self.nodes[:-1]:
                    take, node.backlog = (node.backlog[len(node.backlog)//2:],
                                          node.backlog[:len(node.backlog)//2])
                    for t2 in take:
                        self._push(self.costs.global_sched_s,
                                   "global_place", t2)
                # revive actors parked on dead nodes (cluster was down)
                for actor in self.actors:
                    if not self.nodes[actor.node_id].alive and actor.queue:
                        self._relocate_actor(actor)

    # ------------------------------------------------------------ metrics

    def throughput(self) -> float:
        if not self.finished:
            return 0.0
        span = max(t.finish_t for t in self.finished) - min(
            t.submit_t for t in self.finished)
        return len(self.finished) / max(span, 1e-9)

    def latency_percentiles(self, how: Optional[str] = None):
        lats = sorted(l for h, l in self.sched_latencies
                      if how is None or h == how)
        if not lats:
            return {}
        pick = lambda q: lats[min(len(lats) - 1, int(q * len(lats)))]
        return {"p50": pick(0.5), "p90": pick(0.9), "p99": pick(0.99)}


# ----------------------------------------------------------- chaos scenarios

def chaos_mass_failure(num_nodes: int = 100, kill_fraction: float = 0.3,
                       num_tasks: int = 2000, task_s: float = 1e-3,
                       seed: int = 0, costs: SimCosts = SimCosts(),
                       max_task_attempts: Optional[int] = None) -> Dict:
    """Correlated mass failure at scale: a steady task stream is hit by
    the simultaneous loss of ``kill_fraction`` of the cluster mid-run,
    with replacement capacity joining shortly after. Validates that
    lineage replay + elastic rebalance drain the full workload (every
    task finishes or — under a replay budget — fails permanently, none
    lost) and reports the replay bill."""
    sim = ClusterSim(num_nodes, costs=costs, seed=seed,
                     max_task_attempts=max_task_attempts)
    rng = random.Random(seed)
    span = num_tasks * task_s / (num_nodes * 4)
    for i in range(num_tasks):
        sim.submit(SimTask(task_id=i, duration_s=task_s,
                           submit_node=rng.randrange(num_nodes)),
                   at=rng.uniform(0.0, span))
    t_kill = span / 2
    killed = rng.sample(range(num_nodes), int(num_nodes * kill_fraction))
    for nid in killed:
        sim.kill_node(nid, at=t_kill)
    # replacements arrive one heartbeat-ish interval later
    for _ in killed:
        sim.add_node(8, at=t_kill + 0.05)
    sim.run()
    return {"finished": len(sim.finished),
            "failed_permanently": len(sim.failed_permanently),
            "replayed": sim.failures_replayed,
            "killed": len(killed),
            "throughput": sim.throughput(),
            "p50_sched": sim.latency_percentiles().get("p50", 0.0)}


def chaos_rolling_restart(num_nodes: int = 100, num_tasks: int = 2000,
                          task_s: float = 1e-3, period_s: float = 0.02,
                          restart_gap_s: float = 0.005, seed: int = 0,
                          costs: SimCosts = SimCosts()) -> Dict:
    """Rolling restart sweep: every node is fail-stopped in turn, one
    per ``period_s``, with its replacement joining ``restart_gap_s``
    later — the DES analogue of a cluster-wide upgrade under load. The
    workload must drain with bounded replay (each task sees at most a
    few kills) and no permanent losses."""
    sim = ClusterSim(num_nodes, costs=costs, seed=seed)
    rng = random.Random(seed)
    span = num_nodes * period_s
    for i in range(num_tasks):
        sim.submit(SimTask(task_id=i, duration_s=task_s,
                           submit_node=rng.randrange(num_nodes)),
                   at=rng.uniform(0.0, span))
    for k in range(num_nodes):
        sim.kill_node(k, at=(k + 1) * period_s)
        sim.add_node(8, at=(k + 1) * period_s + restart_gap_s)
    sim.run()
    attempts = [t.attempts for t in sim.finished]
    return {"finished": len(sim.finished),
            "replayed": sim.failures_replayed,
            "restarts": num_nodes,
            "max_attempts": max(attempts) if attempts else 0,
            "throughput": sim.throughput()}


# ---------------------------------------------------------- serving DES

def serving_diurnal(num_nodes: int = 100, mean_rate_hz: float = 2000.0,
                    amplitude: float = 0.8, period_s: float = 20.0,
                    duration_s: float = 40.0, seed: int = 0,
                    costs: SimCosts = SimCosts(),
                    deadline_s: float = 0.040,
                    base_s: float = 0.006, per_req_s: float = 0.0015,
                    knee: int = 5, cliff_s: float = 0.002,
                    target_wave_s: float = 0.015, max_batch: int = 16,
                    min_replicas: int = 2, max_queue: int = 4096,
                    scale_up_queue_depth: int = 32,
                    scale_up_cooldown_s: float = 0.25,
                    scale_down_idle_s: float = 2.0,
                    replica_spawn_s: float = 0.05) -> Dict:
    """Diurnal arrival wave against the front door's policies in virtual
    time: a sinusoidally modulated Poisson stream (the load harness's
    ``diurnal_trace``) over a cluster of up to ``num_nodes`` one-replica
    nodes, with the real ``BatchController`` driving per-replica AIMD
    wave sizing and the same admission / EDF-shed / queue-pressure
    autoscale rules the runtime front door applies — but with no
    wall-clock, so a 100-node day-cycle runs in milliseconds. Service
    time is the serve bench's calibrated engine curve
    (base + per_req * n + cliff * max(0, n - knee)^2); per-wave dispatch
    is charged the measured actor-call + graph-dispatch costs. Validates
    that replica count tracks the arrival wave (scale-up near the crest,
    reclaim in the trough) and that goodput holds through the cycle."""
    from repro_torch.serving.frontdoor import BatchController
    from repro_torch.serving.load import diurnal_trace

    arrivals = diurnal_trace(mean_rate_hz, amplitude, period_s,
                             duration_s, seed=seed)
    dispatch_cost = costs.actor_call_s + costs.graph_dispatch_s

    queue: List[Tuple[float, int]] = []      # (deadline, seq) EDF heap
    replicas: List[Dict] = [
        {"free_at": 0.0,
         "ctl": BatchController(target_wave_s, max_batch=max_batch)}
        for _ in range(min_replicas)]
    admitted = rejected = shed = ok = late = 0
    inflight = 0
    last_scale_t = -1e9
    last_pressure_t = 0.0
    max_replicas_seen = min_replicas
    wave_sizes: List[int] = []
    timeline: List[Tuple[float, int]] = []

    # event heap: (t, kind, payload); kinds: 0=arrival, 1=wave done,
    # 2=autoscaler tick (time-uniform pressure sampling, like the
    # runtime control loop — sampling at arrival events alone is biased
    # toward queue-occupied instants and starves scale-down)
    events: List[Tuple[float, int, int, tuple]] = []
    for seq, (t, _plen, _budget) in enumerate(arrivals):
        heapq.heappush(events, (t, 0, seq, ()))
    seq_gen = len(arrivals)
    tick = scale_down_idle_s / 4.0
    n_ticks = int((duration_s + 2 * scale_down_idle_s) / tick)
    for k in range(1, n_ticks + 1):
        heapq.heappush(events, (k * tick, 2, seq_gen, ()))
        seq_gen += 1

    def service_s(n: int) -> float:
        return (base_s + per_req_s * n
                + cliff_s * max(0, n - knee) ** 2)

    while events:
        t, kind, seq, payload = heapq.heappop(events)
        if kind == 0:                                   # arrival
            if len(queue) + inflight >= max_queue:
                rejected += 1
            else:
                admitted += 1
                heapq.heappush(queue, (t + deadline_s, seq))
        elif kind == 2:                                 # autoscaler tick
            if queue:
                last_pressure_t = t
        else:                                           # wave completion
            ridx, size, n_late = payload
            r = replicas[ridx] if ridx < len(replicas) else None
            inflight -= size
            ok += size - n_late
            late += n_late
            if r is not None:
                r["ctl"].observe(service_s(size), wave_size=size)
        # shed expired heads (never dispatched late)
        while queue and queue[0][0] <= t:
            heapq.heappop(queue)
            shed += 1
        # dispatch to every free replica
        for ridx, r in enumerate(replicas):
            if r["free_at"] > t or not queue:
                continue
            size = min(len(queue), r["ctl"].size)
            deadlines = [heapq.heappop(queue)[0] for _ in range(size)]
            done_at = t + dispatch_cost + service_s(size)
            n_late = sum(1 for d in deadlines if done_at > d)
            r["free_at"] = done_at
            inflight += size
            wave_sizes.append(size)
            heapq.heappush(events, (done_at, 1, seq_gen,
                                    (ridx, size, n_late)))
            seq_gen += 1
        # autoscale on queue pressure / staleness, one step per event
        if (len(queue) > scale_up_queue_depth
                and len(replicas) < num_nodes
                and t - last_scale_t >= scale_up_cooldown_s):
            replicas.append(
                {"free_at": t + replica_spawn_s,
                 "ctl": BatchController(target_wave_s,
                                        max_batch=max_batch)})
            last_scale_t = t
            max_replicas_seen = max(max_replicas_seen, len(replicas))
        elif (len(replicas) > min_replicas
                and t - last_pressure_t >= scale_down_idle_s
                and t - last_scale_t >= scale_up_cooldown_s):
            # retire the most recently added idle replica
            for ridx in range(len(replicas) - 1, min_replicas - 1, -1):
                if replicas[ridx]["free_at"] <= t:
                    replicas.pop(ridx)
                    last_scale_t = t
                    break
        timeline.append((round(t, 3), len(replicas)))
    resolved = ok + late + shed + rejected
    return {"offered": len(arrivals),
            "admitted": admitted, "rejected": rejected, "shed": shed,
            "completed_ok": ok, "completed_late": late,
            "ledger_balanced": resolved == len(arrivals),
            "goodput_rps": ok / duration_s,
            "goodput_fraction": ok / max(admitted, 1),
            "mean_wave_size": (sum(wave_sizes) / max(len(wave_sizes), 1)),
            "max_replicas_seen": max_replicas_seen,
            "final_replicas": len(replicas),
            "replica_timeline": timeline[:: max(1, len(timeline) // 200)]}


# --------------------------------------------------- heterogeneous fleet

def heterogeneous_fleet(num_cpu: int = 80, num_gpu: int = 20,
                        workers_per_node: int = 8,
                        num_tasks: int = 4000,
                        kernel_fraction: float = 0.3,
                        task_s: float = 1e-3,
                        kernel_s: Optional[float] = None,
                        seed: int = 0,
                        costs: SimCosts = SimCosts()) -> Dict:
    """Mixed cpu/gpu fleet under a blended workload (the paper's R5 at
    scale): ``kernel_fraction`` of the stream requests ``{"gpu": 1}``
    and costs one calibrated kernel step; the rest are ordinary cpu
    tasks. Kernel tasks submitted on cpu-only nodes must spill to the
    global scheduler and land only on gpu-capacity nodes — queueing
    behind a busy device rather than misplacing — so the scenario's
    headline metric, ``device_misplaced``, must be zero, while the cpu
    stream keeps its local-first fast path."""
    if kernel_s is None:
        kernel_s = costs.kernel_step_s
    topo = ([{"cpu": float(workers_per_node), "gpu": 1.0}] * num_gpu
            + [{"cpu": float(workers_per_node)}] * num_cpu)
    sim = ClusterSim(len(topo), workers_per_node, costs=costs, seed=seed,
                     node_resources=topo)
    rng = random.Random(seed)
    num_nodes = len(topo)
    # arrival span sized so the gpu lanes are saturated (forced queueing)
    span = max(num_tasks * kernel_fraction * kernel_s / max(num_gpu, 1),
               num_tasks * task_s / (num_nodes * workers_per_node))
    kernel_ids = set()
    for i in range(num_tasks):
        if rng.random() < kernel_fraction:
            kernel_ids.add(i)
            t = SimTask(task_id=i, duration_s=kernel_s,
                        submit_node=rng.randrange(num_nodes),
                        resources={"cpu": 1.0, "gpu": 1.0})
        else:
            t = SimTask(task_id=i, duration_s=task_s,
                        submit_node=rng.randrange(num_nodes))
        sim.submit(t, at=rng.uniform(0.0, span))
    sim.run()
    gpu_capacity = {n.node_id for n in sim.nodes
                    if n.capacity.get("gpu", 0.0) > 0.0}
    kern_done = [t for t in sim.finished if t.task_id in kernel_ids]
    misplaced = sum(1 for t in kern_done if t.node not in gpu_capacity)
    kern_waits = sorted(t.start_t - t.submit_t for t in kern_done)
    pick = lambda q: (kern_waits[min(len(kern_waits) - 1,  # noqa: E731
                                     int(q * len(kern_waits)))]
                      if kern_waits else 0.0)
    return {"finished": len(sim.finished),
            "kernel_tasks": len(kern_done),
            "device_misplaced": misplaced,
            "kernel_spilled": sum(1 for t in kern_done if t.spilled),
            "kernel_wait_p50_s": pick(0.5),
            "kernel_wait_p99_s": pick(0.99),
            "throughput": sim.throughput()}


# ----------------------------------------------------- streaming DES

def streaming_drift(num_batches: int = 400, batch: int = 32,
                    dim: int = 16, interval_s: float = 0.05,
                    drift_at: int = 200, seed: int = 42,
                    lr: float = 0.5, publish_every: int = 8,
                    swap_interval_s: float = 1.0,
                    train_lag_batches: int = 2,
                    adwin_delta: float = 0.002,
                    ewma_factor: float = 1.6) -> Dict:
    """Train-while-serve in virtual time: the REAL streaming policies —
    ``synthetic_stream`` (seeded drift schedule), ``OnlineLogit``
    (predict-then-learn), ``DriftMonitor`` (ADWIN + loss-EWMA, firing
    learner resets), and the publish-every-N / swap-on-interval cadence
    the runtime pipeline runs — driven by a virtual clock instead of
    actor round trips, so a multi-minute stream with an abrupt
    mid-stream drift replays in milliseconds.

    Batch ``k`` arrives at ``k * interval_s``; the learner trains it
    ``train_lag_batches`` later (pipeline lag) and publishes on its
    cadence; the serving side re-fetches the newest published version
    once per ``swap_interval_s`` and scores each arriving batch with
    whatever weights it last swapped to, next to a frozen arm pinned at
    the first publish. Validates the runtime bench's drift-recovery
    claim structurally (online recovers post-drift and beats frozen)
    and reports staleness in virtual time: max version lag and mean
    stream-seconds the serving weights trailed the stream head."""
    from repro_torch.streaming.drift import (AdwinDetector, DriftMonitor,
                                             LossEWMADetector)
    from repro_torch.streaming.learner import OnlineLogit
    from repro_torch.streaming.sources import (DriftSpec, StreamConfig,
                                               synthetic_stream)

    cfg = StreamConfig(dim=dim, batch=batch, seed=seed,
                       interval_s=interval_s,
                       drifts=(DriftSpec(at_step=drift_at, kind="abrupt",
                                         target="label"),))
    stream = synthetic_stream(cfg)
    model = OnlineLogit(dim, lr=lr)
    monitor = DriftMonitor(AdwinDetector(delta=adwin_delta),
                           LossEWMADetector(factor=ewma_factor))

    # published versions: version -> (publish_t, trained_through_t, w, b)
    published: Dict[int, Tuple[float, float, List[float], float]] = {}
    latest_version = 0
    served_version = 0
    frozen: Optional[Tuple[List[float], float]] = None
    next_swap_t = 0.0
    resets = 0
    max_lag = 0
    behind_total = 0.0
    behind_samples = 0
    swaps = 0
    serve_w, serve_b = model.params()["w"].copy(), 0.0
    acc_series: List[Tuple[int, float, float]] = []  # per-batch accs

    for k in range(num_batches):
        b = next(stream)
        t = k * interval_s
        # ---- serving side: swap on its interval, then score the batch
        if t >= next_swap_t:
            next_swap_t = t + swap_interval_s
            if latest_version > served_version:
                swaps += 1
                served_version = latest_version
                _, _, serve_w, serve_b = published[latest_version]
        lag = latest_version - served_version
        max_lag = max(max_lag, lag)
        if served_version:
            behind_total += max(0.0, t - published[served_version][1])
            behind_samples += 1
        margin = b.x @ serve_w + serve_b
        online_acc = float(((margin > 0) == (b.y > 0.5)).mean())
        if frozen is not None:
            fmargin = b.x @ frozen[0] + frozen[1]
            frozen_acc = float(((fmargin > 0) == (b.y > 0.5)).mean())
        else:
            frozen_acc = online_acc
        acc_series.append((b.step, online_acc, frozen_acc))
        # ---- learner side: trains this batch train_lag_batches later
        train_t = (k + train_lag_batches) * interval_s
        preds = model.predict_proba(b.x) > 0.5
        err = float((preds != (b.y > 0.5)).mean())
        model.learn(b.x, b.y)
        if monitor.update(err, b.step):
            model.reset()
            resets += 1
        if (k + 1) % publish_every == 0:
            latest_version += 1
            p = model.params()
            published[latest_version] = (train_t, b.t,
                                         p["w"].copy(), float(p["b"]))
            if frozen is None:
                frozen = (p["w"].copy(), float(p["b"]))

    def window_acc(lo: int, hi: int, arm: int) -> float:
        xs = [a[arm] for a in acc_series if lo <= a[0] < hi]
        return sum(xs) / max(len(xs), 1)

    tail = drift_at + (num_batches - drift_at) // 2
    return {"batches": num_batches,
            "drift_events": len(monitor.events),
            "learner_resets": resets,
            "published_versions": latest_version,
            "weight_swaps": swaps,
            "version_lag_max": max_lag,
            "behind_s_mean": behind_total / max(behind_samples, 1),
            "pre_drift_acc": window_acc(drift_at // 2, drift_at, 1),
            "post_drift_acc_online": window_acc(tail, num_batches, 1),
            "post_drift_acc_frozen": window_acc(tail, num_batches, 2),
            "recovered": (window_acc(tail, num_batches, 1)
                          > window_acc(tail, num_batches, 2) + 0.05)}
