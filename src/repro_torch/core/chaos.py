"""Seeded fault injection against a live cluster.

The failure machinery (heartbeat detection, lineage replay with bounded
budgets, actor restarts, graph re-dispatch) is only trustworthy if it is
exercised continuously — not just by tests that call ``kill_node()`` at
hand-picked moments. ``FaultInjector`` schedules a reproducible sequence
of fault events against a running ``Cluster``:

  * ``kill``    — fail-stop a random live node (respecting ``min_live``)
  * ``restart`` — bring a dead node back under the same id (or fail-stop
                  restart a live one when nothing is dead)
  * ``delay``   — degrade a node: inject object-transfer latency for a
                  bounded window (a straggler, not a corpse)
  * ``drop``    — suppress a node's heartbeats while its threads keep
                  running (a network partition / hung host as seen by
                  the detector), restored after a bounded window

The schedule is derived *only* from ``(seed, len(cluster.nodes),
kinds, n_events)`` via :meth:`plan`, so the same seed replays the same
event sequence — CI chaos jobs and "same seed, same faults" tests rely
on this. Application adapts to runtime state deterministically (a
planned kill of an already-dead node walks cyclically to the next live
one) and every *applied* event is recorded in ``self.applied`` and in
the control-plane event log under kind ``"chaos"``.

Use synchronously (``run()``) for deterministic soaks, or in the
background (``start()`` / ``stop()``) to shake a live workload.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

KINDS = ("kill", "restart", "delay", "drop")


@dataclass(frozen=True)
class ChaosEvent:
    """One planned fault: fire at ``t`` seconds after run start."""
    t: float
    kind: str
    node_id: int


class FaultInjector:
    def __init__(self, cluster, seed: int = 0,
                 kinds: Sequence[str] = KINDS, min_live: int = 1,
                 mean_interval_s: float = 0.05,
                 delay_s: float = 0.002, delay_window_s: float = 0.1,
                 drop_window_s: float = 0.3):
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"unknown chaos kind {k!r}")
        self.cluster = cluster
        self.seed = seed
        self.kinds = tuple(kinds)
        self.min_live = max(1, min_live)
        self.mean_interval_s = mean_interval_s
        self.delay_s = delay_s
        self.delay_window_s = delay_window_s
        self.drop_window_s = drop_window_s
        #: (event index, planned kind, outcome, node_id) per applied event
        self.applied: List[Tuple[int, str, str, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._timers: List[threading.Timer] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- planning

    def plan(self, n_events: int) -> List[ChaosEvent]:
        """The full fault schedule, a pure function of the seed (plus
        the cluster size and configured kinds). Event times jitter
        uniformly in [0.5, 1.5] x mean_interval."""
        rng = random.Random(self.seed)
        num = len(self.cluster.nodes)
        events, t = [], 0.0
        for _ in range(n_events):
            t += rng.uniform(0.5, 1.5) * self.mean_interval_s
            events.append(ChaosEvent(round(t, 6), rng.choice(self.kinds),
                                     rng.randrange(num)))
        return events

    # ------------------------------------------------------------ injection

    def inject(self, idx: int, ev: ChaosEvent) -> str:
        """Apply one event, adapting deterministically to runtime state;
        returns the outcome actually applied ('kill', 'restart',
        'delay', 'drop', or 'skip')."""
        c = self.cluster
        outcome = "skip"
        if ev.kind == "kill":
            nid = self._pick(ev.node_id, alive=True)
            if nid is not None and self._live_count() > self.min_live:
                c.kill_node(nid)
                outcome = "kill"
        elif ev.kind == "restart":
            nid = self._pick(ev.node_id, alive=False)
            if nid is None:
                nid = ev.node_id  # nothing dead: fail-stop restart
            c.restart_node(nid)
            outcome = "restart"
        elif ev.kind == "delay":
            nid = self._pick(ev.node_id, alive=True)
            if nid is not None:
                self._degrade(c.nodes[nid])
                outcome = "delay"
        elif ev.kind == "drop":
            nid = self._pick(ev.node_id, alive=True)
            if nid is not None:
                self._partition(c.nodes[nid])
                outcome = "drop"
        if outcome != "skip":
            c.gcs.log_event("chaos", f"node{nid}", "chaos",
                            event=idx, fault=outcome)
        self.applied.append((idx, ev.kind, outcome,
                             nid if outcome != "skip" else ev.node_id))
        return outcome

    def _live_count(self) -> int:
        return sum(1 for n in self.cluster.nodes if n.alive)

    def _pick(self, start: int, alive: bool) -> Optional[int]:
        """The planned node if it matches liveness, else the cyclically
        next matching one — deterministic given the liveness map."""
        nodes = self.cluster.nodes
        for k in range(len(nodes)):
            nid = (start + k) % len(nodes)
            if nodes[nid].alive == alive:
                return nid
        return None

    def _degrade(self, node) -> None:
        store, old = node.store, node.store.transfer_latency_s
        store.transfer_latency_s = max(old, self.delay_s)

        def heal():
            store.transfer_latency_s = old
        self._after(self.delay_window_s, heal)

    def _partition(self, node) -> None:
        node.hb_suspended = True

    def _heal_partition(self, node) -> None:
        # the detector may have killed-and-restarted the node meanwhile;
        # clearing the stale incarnation's flag is harmless
        node.hb_suspended = False

    def _after(self, delay_s: float, fn) -> None:
        t = threading.Timer(delay_s, fn)
        t.daemon = True
        with self._lock:
            self._timers.append(t)
        t.start()

    # --------------------------------------------------------------- drive

    def run(self, n_events: int = 10,
            events: Optional[List[ChaosEvent]] = None) -> List[Tuple]:
        """Apply the schedule synchronously (paced by each event's
        ``t``); returns ``self.applied``. Interruptible via stop()."""
        events = self.plan(n_events) if events is None else events
        start = time.perf_counter()
        for idx, ev in enumerate(events):
            if self._stop.is_set():
                break
            wait = ev.t - (time.perf_counter() - start)
            if wait > 0 and self._stop.wait(wait):
                break
            self.inject(idx, ev)
            if ev.kind == "drop":
                # bounded partition: schedule the heal against whatever
                # incarnation holds the id when the window closes
                nid = self.applied[-1][3]
                self._after(self.drop_window_s, lambda n=nid:
                            self._heal_partition(self.cluster.nodes[n]))
        return self.applied

    def start(self, n_events: int = 10,
              events: Optional[List[ChaosEvent]] = None) -> "FaultInjector":
        """Run the schedule on a background daemon thread."""
        if self._thread is not None:
            raise RuntimeError("FaultInjector already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, args=(n_events, events), name="chaos",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop injecting, cancel pending heal timers, and restore any
        still-degraded/partitioned nodes."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            timers, self._timers = self._timers, []
        for t in timers:
            t.cancel()
        for n in self.cluster.nodes:
            n.hb_suspended = False

    def kill_restart_cycle(self, cycles: int = 5,
                           interval_s: Optional[float] = None
                           ) -> List[ChaosEvent]:
        """Convenience plan: ``cycles`` alternating kill/restart pairs
        (2 x cycles events) against seed-chosen nodes — the soak shape
        the acceptance criteria call for."""
        rng = random.Random(self.seed)
        num = len(self.cluster.nodes)
        step = interval_s if interval_s is not None else self.mean_interval_s
        events, t = [], 0.0
        for _ in range(cycles):
            nid = rng.randrange(num)
            t += step
            events.append(ChaosEvent(round(t, 6), "kill", nid))
            t += step
            events.append(ChaosEvent(round(t, 6), "restart", nid))
        return events
