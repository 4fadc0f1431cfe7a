"""SLO metrics for the serving front door (open-loop measurement).

The port's own copy of ``repro.serving.slo``. Closed-loop runs report
p50s over a drained batch: the client waits for completions, so overload
shows up as lower throughput, never as queueing delay. An open-loop front
door is measured the opposite way — arrivals keep coming at their own
rate, so the numbers that matter are *goodput* (requests completed within
their deadline, per second) and tail latency over a sliding window, plus
the shed/reject/retry counters that say where the missing requests went.
This module is pure bookkeeping: no runtime imports, no torch, safe to
use from the load harness and the front door alike.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile matching profiler.summarize's convention."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class SLOTracker:
    """Sliding-window serving metrics: p50/p99 latency, goodput
    (completed-within-deadline/s), and the full disposition ledger
    (admitted / rejected / shed / retried / failed / completed-late).

    Every admitted request ends in exactly one terminal counter —
    ``completed_ok``, ``completed_late``, ``shed``, or ``failed`` — so
    ``admitted == completed_ok + completed_late + shed + failed`` once
    the front door drains; the serve bench asserts this to prove no
    request hangs. Thread-safe; recording is O(1) amortized (expired
    window entries are popped on record/snapshot).
    """

    def __init__(self, window_s: float = 30.0,
                 clock=time.perf_counter):
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        # (completion_t, latency_s, met_deadline) — window entries
        self._window: Deque[Tuple[float, float, bool]] = deque()
        self.admitted = 0
        self.rejected = 0
        self.shed = 0
        self.retried = 0
        self.failed = 0
        self.completed_ok = 0
        self.completed_late = 0
        # requests dispatched to a replica after their deadline had
        # already passed — the EDF queue must keep this at zero (a late
        # *completion* can race the deadline; a late *dispatch* cannot)
        self.dispatched_past_deadline = 0
        # of `shed`, the requests that expired between their wave's
        # formation and its dispatch (the control thread stalled there),
        # and the most any of them was past its deadline
        self.shed_at_dispatch = 0
        self.shed_at_dispatch_late_ms_max = 0.0
        self._first_completion: Optional[float] = None
        self._last_completion: Optional[float] = None
        # ---- weight staleness (streaming train-while-serve plane) ----
        # publisher side bumps published_version; replicas bump
        # served_version on a between-wave hot swap. The live lag
        # (published - served) is monotone nondecreasing between swaps
        # and drops back on swap; version_lag_max records the worst gap
        # ever observed, swap lag the per-swap version jump.
        self.published_version = 0
        self.served_version = 0
        self.weight_swaps = 0
        self.version_lag_max = 0
        self._swap_lag_total = 0
        # per-completion staleness samples: how stale were the weights
        # that actually served the request (versions behind the newest
        # publish, and seconds of stream the weights had not seen)
        self.staleness_samples = 0
        self._lag_total = 0
        self._behind_total = 0.0
        self.behind_s_max = 0.0
        self.behind_s_last = 0.0

    # ------------------------------------------------------------ record

    def record_admit(self) -> None:
        with self._lock:
            self.admitted += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_shed(self, at_dispatch_late_ms: Optional[float] = None
                    ) -> None:
        with self._lock:
            self.shed += 1
            if at_dispatch_late_ms is not None:
                self.shed_at_dispatch += 1
                self.shed_at_dispatch_late_ms_max = max(
                    self.shed_at_dispatch_late_ms_max, at_dispatch_late_ms)

    def record_retry(self) -> None:
        with self._lock:
            self.retried += 1

    def record_failure(self) -> None:
        with self._lock:
            self.failed += 1

    def record_late_dispatch(self) -> None:
        with self._lock:
            self.dispatched_past_deadline += 1

    # ------------------------------------------------- weight staleness

    def record_publish(self, version: int) -> None:
        """A new weight version landed (learner side). Monotone: a
        replayed/duplicate publish notification never lowers it."""
        with self._lock:
            self.published_version = max(self.published_version, version)
            self.version_lag_max = max(
                self.version_lag_max,
                self.published_version - self.served_version)

    def record_swap(self, version: int) -> None:
        """A serving replica hot-swapped to `version` between waves:
        the live lag resets against the new served version."""
        with self._lock:
            self.weight_swaps += 1
            self._swap_lag_total += max(0, version - self.served_version)
            self.served_version = max(self.served_version, version)
            self.published_version = max(self.published_version, version)

    def record_staleness(self, version_lag: int, behind_s: float) -> None:
        """One served request's weight staleness: versions behind the
        newest publish at completion time, and stream-seconds the
        serving weights had not yet trained through."""
        with self._lock:
            self.staleness_samples += 1
            self._lag_total += max(0, version_lag)
            self._behind_total += max(0.0, behind_s)
            self.behind_s_last = behind_s
            self.behind_s_max = max(self.behind_s_max, behind_s)

    def version_lag(self) -> int:
        """Live lag: published versions the serving tier has not swapped
        to yet. Grows monotonically between swaps, resets on swap."""
        with self._lock:
            return self.published_version - self.served_version

    def record_completion(self, latency_s: float, met_deadline: bool,
                          now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            if met_deadline:
                self.completed_ok += 1
            else:
                self.completed_late += 1
            if self._first_completion is None:
                self._first_completion = now
            self._last_completion = now
            self._window.append((now, latency_s, met_deadline))
            self._expire(now)

    def _expire(self, now: float) -> None:
        cutoff = now - self.window_s
        w = self._window
        while w and w[0][0] < cutoff:
            w.popleft()

    # ---------------------------------------------------------- snapshot

    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        now = self._clock() if now is None else now
        with self._lock:
            self._expire(now)
            lats = [l for _, l, _ in self._window]
            ok_in_window = sum(1 for _, _, met in self._window if met)
            if self._window:
                span = max(now - self._window[0][0], 1e-9)
            else:
                span = self.window_s
            return {
                "latency_p50_ms": percentile(lats, 0.5) * 1e3,
                "latency_p99_ms": percentile(lats, 0.99) * 1e3,
                "goodput_rps": ok_in_window / span,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "shed": self.shed,
                "retried": self.retried,
                "failed": self.failed,
                "completed_ok": self.completed_ok,
                "completed_late": self.completed_late,
                "dispatched_past_deadline": self.dispatched_past_deadline,
                "shed_at_dispatch": self.shed_at_dispatch,
                "shed_at_dispatch_late_ms_max":
                    self.shed_at_dispatch_late_ms_max,
                "published_version": self.published_version,
                "served_version": self.served_version,
                "version_lag": (self.published_version
                                - self.served_version),
                "version_lag_max": self.version_lag_max,
                "weight_swaps": self.weight_swaps,
                "swap_lag_mean": (self._swap_lag_total
                                  / max(self.weight_swaps, 1)),
                "staleness_samples": self.staleness_samples,
                "staleness_lag_mean": (self._lag_total
                                       / max(self.staleness_samples, 1)),
                "behind_s_mean": (self._behind_total
                                  / max(self.staleness_samples, 1)),
                "behind_s_max": self.behind_s_max,
            }

    def overall_goodput(self, now: Optional[float] = None) -> float:
        """Whole-run goodput: completed-within-deadline over the span
        from first to last completion (window-independent — what the
        bench A/B compares)."""
        with self._lock:
            if self._first_completion is None:
                return 0.0
            end = self._last_completion
            span = max(end - self._first_completion, 1e-9)
            return self.completed_ok / span

    def resolved(self) -> int:
        """Requests with a terminal disposition (see class docstring)."""
        with self._lock:
            return (self.completed_ok + self.completed_late
                    + self.shed + self.failed)
