"""Baseline executors for the paper's §4.2 comparison: the port of
`repro.core.executors` onto `repro_torch.core`.

The paper compares its prototype against (a) a single-threaded
implementation and (b) a Spark implementation (9x slower than
single-threaded due to system overhead). We model the Spark-style system
*structurally* rather than shipping Spark: BSP stage barriers + a single
centralized driver that dispatches every task (no local schedulers) + a
configurable per-task driver overhead (default 2.5 ms, in the range
reported for Spark task launch overhead [Ousterhout NSDI'15]).

``HybridExecutor`` is the paper's architecture: the repro_torch.core
runtime with local-first scheduling and `wait`-based pipelining.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Sequence

from repro_torch.core import api


class SerialExecutor:
    """Single-threaded reference."""

    def map_stage(self, fn: Callable, items: Sequence) -> List:
        return [fn(x) for x in items]


class BSPExecutor:
    """Centralized driver + stage barrier, Spark-style.

    Every task goes through ONE driver thread (serialization point), pays
    `driver_overhead_s`, is executed by a fixed worker pool, and the stage
    only returns when ALL tasks finish (barrier -> stragglers stall the
    stage).
    """

    def __init__(self, num_workers: int = 8,
                 driver_overhead_s: float = 0.0025):
        self.driver_overhead_s = driver_overhead_s
        self._tasks: "queue.Queue" = queue.Queue()
        self._workers = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(num_workers)]
        for w in self._workers:
            w.start()

    def _work(self):
        while True:
            item = self._tasks.get()
            if item is None:
                return
            fn, x, out, i, done = item
            out[i] = fn(x)
            done.put(i)

    def map_stage(self, fn: Callable, items: Sequence) -> List:
        out = [None] * len(items)
        done: "queue.Queue" = queue.Queue()
        for i, x in enumerate(items):
            time.sleep(self.driver_overhead_s)   # centralized dispatch cost
            self._tasks.put((fn, x, out, i, done))
        for _ in items:                           # full-stage barrier
            done.get()
        return out

    def shutdown(self):
        for _ in self._workers:
            self._tasks.put(None)


class HybridExecutor:
    """The paper's architecture: submit through repro_torch.core, consume
    with wait() so downstream work pipelines with stragglers (§4.2)."""

    def __init__(self, remote_fn: api.RemoteFunction):
        self.remote_fn = remote_fn

    def map_stage(self, items: Sequence) -> List:
        refs = [self.remote_fn.submit(x) for x in items]
        return api.get(list(refs))

    def map_pipelined(self, items: Sequence, consume: Callable,
                      batch: int = 1) -> List:
        """Process results in completion order (wait-driven pipelining)."""
        pending = [self.remote_fn.submit(x) for x in items]
        outs = []
        while pending:
            done, pending = api.wait(pending, num_returns=min(batch,
                                                              len(pending)))
            for r in done:
                outs.append(consume(api.get(r)))
        return outs
