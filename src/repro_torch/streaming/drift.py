"""Online concept-drift detection over a loss/error stream: the port of
`repro.streaming.drift`, a copy (pure Python, no torch).

Two detectors, both pure (no runtime imports, no wall clock — safe in
the DES simulator and unit-testable deterministically):

  * `AdwinDetector` — ADWIN-style adaptive windowing: keep a bounded
    window of recent values, test every (strided) split point for a
    significant difference between the older and newer sub-window means
    (Hoeffding-style cut threshold), and on detection *shrink* the
    window to the recent side so the next test runs against post-change
    data only.
  * `LossEWMADetector` — two exponentially weighted moving averages of
    the loss, one fast and one slow; fires when the fast average climbs
    a factor above the slow baseline. Cheap, reacts in O(1), catches
    abrupt shifts a few batches after they land.

`DriftMonitor` runs both and deduplicates fires into a single typed
`DriftEvent` stream. Determinism: detectors are pure functions of the
value sequence — the same seeded stream always produces the same event
sequence (tests/test_torch_streaming.py holds the port to the
reference's sequence).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class DriftEvent:
    """One detector fire: which detector, at which stream step, with the
    pre/post-change means it observed (score = their gap)."""
    detector: str
    step: int
    score: float
    mean_before: float
    mean_after: float


class LossEWMADetector:
    """Fast-vs-slow EWMA trigger: drift when the fast average exceeds
    ``slow * factor + margin`` after a warmup, with a cooldown so one
    regime change fires once, not every step of the transient."""

    def __init__(self, fast: float = 0.3, slow: float = 0.02,
                 factor: float = 1.6, margin: float = 0.05,
                 warmup: int = 20, cooldown: int = 30):
        self.fast_alpha = fast
        self.slow_alpha = slow
        self.factor = factor
        self.margin = margin
        self.warmup = warmup
        self.cooldown = cooldown
        self.fast: Optional[float] = None
        self.slow: Optional[float] = None
        self._n = 0
        self._cool = 0

    def update(self, value: float, step: int) -> Optional[DriftEvent]:
        self._n += 1
        if self.fast is None:
            self.fast = self.slow = float(value)
            return None
        self.fast += self.fast_alpha * (value - self.fast)
        self.slow += self.slow_alpha * (value - self.slow)
        if self._cool > 0:
            self._cool -= 1
            return None
        if (self._n > self.warmup
                and self.fast > self.slow * self.factor + self.margin):
            self._cool = self.cooldown
            ev = DriftEvent("loss_ewma", step, self.fast - self.slow,
                            mean_before=self.slow, mean_after=self.fast)
            # re-baseline so recovery is measured against the new regime
            self.slow = self.fast
            return ev
        return None


class AdwinDetector:
    """ADWIN-style window split test. The window holds the most recent
    ``max_window`` values; each update tests split points (every
    ``stride`` values, sub-windows at least ``min_cut`` long) for
    ``|mean_old - mean_new| > eps_cut`` with the Hoeffding-style bound

        eps_cut = sqrt( (1 / (2 m)) * ln(4 n / delta) ),
        m = harmonic mean of the two sub-window sizes,

    and on the most significant violation drops the older side — the
    window adapts to exactly the post-change data."""

    def __init__(self, delta: float = 0.002, max_window: int = 256,
                 min_cut: int = 16, stride: int = 8):
        self.delta = delta
        self.max_window = max_window
        self.min_cut = min_cut
        self.stride = stride
        self.window: List[float] = []
        self._sum = 0.0

    @property
    def mean(self) -> float:
        return self._sum / len(self.window) if self.window else 0.0

    def update(self, value: float, step: int) -> Optional[DriftEvent]:
        self.window.append(float(value))
        self._sum += float(value)
        if len(self.window) > self.max_window:
            self._sum -= self.window[0]
            del self.window[0]
        n = len(self.window)
        if n < 2 * self.min_cut:
            return None
        # prefix sums once per update; strided cut scan keeps the test
        # O(window/stride) — bounded per step
        best: Optional[DriftEvent] = None
        best_excess = 0.0
        prefix = 0.0
        for i, v in enumerate(self.window):
            prefix += v
            cut = i + 1
            if cut < self.min_cut or n - cut < self.min_cut:
                continue
            if cut % self.stride:
                continue
            m0 = prefix / cut
            m1 = (self._sum - prefix) / (n - cut)
            m = 1.0 / (1.0 / cut + 1.0 / (n - cut))
            eps = math.sqrt(math.log(4.0 * n / self.delta) / (2.0 * m))
            gap = abs(m1 - m0)
            if gap > eps and gap - eps > best_excess:
                best_excess = gap - eps
                best = DriftEvent("adwin", step, gap,
                                  mean_before=m0, mean_after=m1)
                keep = n - cut
        if best is not None:
            self.window = self.window[-keep:]
            self._sum = sum(self.window)
        return best


class DriftMonitor:
    """Both detectors over one loss/error stream, fires deduplicated:
    when both trip on the same step only one event per detector is
    emitted (callers usually act once per step regardless)."""

    def __init__(self, adwin: Optional[AdwinDetector] = None,
                 ewma: Optional[LossEWMADetector] = None):
        self.adwin = adwin if adwin is not None else AdwinDetector()
        self.ewma = ewma if ewma is not None else LossEWMADetector()
        self.events: List[DriftEvent] = []

    def update(self, value: float, step: int) -> List[DriftEvent]:
        fired = []
        for det in (self.adwin, self.ewma):
            if det is None:
                continue
            ev = det.update(value, step)
            if ev is not None:
                fired.append(ev)
        self.events.extend(fired)
        return fired
