"""Seeded, replayable feature/label streams with scheduled concept
drift, produced into the object store by long-lived actors: the port of
`repro.streaming.sources` onto `repro_torch.core`. The data stays numpy
on the host, as in the reference.

`synthetic_stream` is the data model: a hidden linear concept ``w``
labels Gaussian features; scheduled `DriftSpec`s mutate the concept
(label/concept shift — ``w`` is redrawn) or the input distribution
(covariate shift — the feature mean moves), either abruptly or ramped
over a window of steps. Everything derives from one `numpy` Generator
seeded by `StreamConfig.seed`, so the same config replays the same
stream bit-for-bit — the drift-recovery benchmark runs its online and
frozen arms on identical data, and detector determinism is testable.

`StreamSource` is the producer actor body. It is *pull-driven with
credit*: the pipeline's control loop calls `pump()` on the stream clock,
and the actor materializes mini-batches into the object store only
while ``buffered + lent < max_ahead`` — back-pressure is the credit
window, so a lagging learner stalls (policy="block") or sheds
(policy="shed", the stream advances but batches drop) production
instead of growing store residency without bound. Consumers `take()`
batch descriptors, pass `ObjectRef(oid)` into the learner's compiled
step graph, and `ack()` after the step resolves — ack drops the
producer's owning refs, so consumed batches hit refcount zero and the
GC reclaims them (the churn benchmark's residency plateau).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DriftSpec:
    """One scheduled drift: at batch ``at_step``, mutate the concept
    (``target="label"``: redraw ``w``) or the input distribution
    (``target="covariate"``: shift the feature mean by ``magnitude``),
    abruptly (``duration=0``) or ramped linearly over ``duration``
    steps."""
    at_step: int
    kind: str = "abrupt"            # "abrupt" | "gradual"
    target: str = "label"           # "label" | "covariate"
    duration: int = 0               # ramp length in steps (gradual only)
    magnitude: float = 2.0


@dataclass(frozen=True)
class StreamConfig:
    dim: int = 16
    batch: int = 32
    seed: int = 42
    interval_s: float = 0.02        # stream time between batches
    label_noise: float = 0.02       # flip probability
    drifts: Tuple[DriftSpec, ...] = ()


@dataclass
class StreamBatch:
    """One mini-batch: features, labels, and its position on the stream
    clock (`t` is *stream time* — step * interval — which is what
    seconds-behind-stream staleness is measured against)."""
    step: int
    t: float
    x: np.ndarray                   # (batch, dim) float32
    y: np.ndarray                   # (batch,) float32 in {0, 1}


def synthetic_stream(cfg: StreamConfig) -> Iterator[StreamBatch]:
    """Infinite seeded stream of mini-batches under cfg's drift
    schedule. Pure generator: no runtime imports, no wall clock."""
    rng = np.random.default_rng(cfg.seed)
    w = rng.standard_normal(cfg.dim)
    w /= np.linalg.norm(w) + 1e-9
    mu = np.zeros(cfg.dim)
    # active gradual ramps: (spec, start_value, target_value)
    ramps: List[Tuple[DriftSpec, np.ndarray, np.ndarray]] = []
    drifts = {d.at_step: d for d in cfg.drifts}
    step = 0
    while True:
        spec = drifts.get(step)
        if spec is not None:
            if spec.target == "label":
                new_w = rng.standard_normal(cfg.dim)
                new_w /= np.linalg.norm(new_w) + 1e-9
                if spec.kind == "gradual" and spec.duration > 0:
                    ramps.append((spec, w.copy(), new_w))
                else:
                    w = new_w
            else:                                      # covariate shift
                delta = rng.standard_normal(cfg.dim)
                delta *= spec.magnitude / (np.linalg.norm(delta) + 1e-9)
                if spec.kind == "gradual" and spec.duration > 0:
                    ramps.append((spec, mu.copy(), mu + delta))
                else:
                    mu = mu + delta
        for spec, start, target in list(ramps):
            frac = min(1.0, (step - spec.at_step) / max(spec.duration, 1))
            mixed = (1.0 - frac) * start + frac * target
            if spec.target == "label":
                w = mixed / (np.linalg.norm(mixed) + 1e-9)
            else:
                mu = mixed
            if frac >= 1.0:
                ramps.remove((spec, start, target))
        x = rng.standard_normal((cfg.batch, cfg.dim)) + mu
        margin = x @ (w * 3.0)                  # sharp-ish boundary
        y = (margin > 0).astype(np.float32)
        flip = rng.random(cfg.batch) < cfg.label_noise
        y = np.where(flip, 1.0 - y, y).astype(np.float32)
        yield StreamBatch(step=step, t=step * cfg.interval_s,
                          x=x.astype(np.float32), y=y)
        step += 1


def _log_event(kind: str, task_id: str, **extra) -> None:
    """Best-effort control-plane event (no-op outside a live cluster)."""
    try:
        from repro_torch.core.api import _cluster
        _cluster().gcs.log_event(kind, task_id, "streaming", **extra)
    except Exception:  # noqa: BLE001 - observability must never fail data
        pass


class StreamSource:
    """Producer actor body (spawn via ``core.remote(StreamSource)``).

    Credit-window protocol (all methods are actor calls, so the state
    machine is single-threaded by the mailbox):

      pump(n)   materialize up to n new batches into the object store,
                bounded by the ``max_ahead`` credit window over
                buffered + lent (un-acked) batches. policy="block"
                holds the stream still when the window is full (nothing
                is lost — the stream replays from where it paused);
                policy="shed" advances the stream and counts the
                dropped batches.
      take(k)   pop up to k batch descriptors (oid, step, t); the
                source retains the owning refs (the batch stays
                GC-protected while the learner's borrow is in flight).
      ack(oids) drop the owning refs for consumed batches — refcount
                hits zero and the GC reclaims them.
    """

    def __init__(self, cfg: StreamConfig, max_ahead: int = 8,
                 policy: str = "block"):
        from repro_torch.core.api import put as _put
        assert policy in ("block", "shed")
        self.cfg = cfg
        self.max_ahead = max(1, max_ahead)
        self.policy = policy
        self._put = _put
        self._gen = synthetic_stream(cfg)
        self._buffer: List[Tuple[str, int, float]] = []
        self._owned: Dict[str, Any] = {}     # oid -> owning ObjectRef
        self.produced = 0
        self.shed = 0
        self.acked = 0

    def _credit(self) -> int:
        return self.max_ahead - len(self._owned)

    def pump(self, n: int = 4) -> Dict[str, int]:
        made = 0
        for _ in range(max(0, n)):
            if self._credit() <= 0:
                if self.policy == "shed":
                    next(self._gen)          # stream advances, batch lost
                    self.shed += 1
                    _log_event("stream_shed", f"stream{self.cfg.seed}")
                    continue
                break                        # block: stream clock pauses
            b = next(self._gen)
            ref = self._put(b)
            self._owned[ref.id] = ref
            self._buffer.append((ref.id, b.step, b.t))
            self.produced += 1
            made += 1
            _log_event("stream_batch", f"stream{self.cfg.seed}",
                       step=b.step, bytes=int(b.x.nbytes + b.y.nbytes))
        return {"produced": made, "buffered": len(self._buffer),
                "outstanding": len(self._owned), "shed": self.shed}

    def take(self, k: int = 4) -> List[Tuple[str, int, float]]:
        out = self._buffer[:max(0, k)]
        del self._buffer[:len(out)]
        return out

    def ack(self, oids: List[str]) -> int:
        n = 0
        for oid in oids:
            if self._owned.pop(oid, None) is not None:
                n += 1
        self.acked += n
        return n

    def stats(self) -> Dict[str, int]:
        return {"produced": self.produced, "shed": self.shed,
                "acked": self.acked, "buffered": len(self._buffer),
                "outstanding": len(self._owned)}
