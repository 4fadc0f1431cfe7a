"""StreamLearner: prequential (predict-then-learn) online learner actor
publishing versioned weights on a cadence policy. The port of
`repro.streaming.learner` onto `repro_torch.core` and
`repro_torch.compute.params`; the model stays numpy float64 on the host,
as in the reference (at dim 8-32 the card would only add launches).

The River idiom (SNIPPETS.md): every mini-batch is first *predicted* —
scoring the model on data it has never seen, the honest online metric —
and then *learned*. The model is a pure-numpy online logistic
regression (SGD on log loss), deliberately simple: the subsystem under
test is the train-while-serve loop, not the estimator.

The actor rides the existing runtime machinery end-to-end:

  * steps arrive through a compiled per-step graph
    (``dag.compile(learner.step.bind(dag.input(0)))`` — the pipeline
    executes it once per mini-batch ref, amortizing orchestration);
  * weights publish as versioned `ParamSet`s (every ``publish_every``
    steps, plus immediately on a drift fire — the loss-triggered
    cadence), carrying ``meta`` with the stream step/time the weights
    were trained through, which is what serve-time staleness is
    measured against;
  * drift fires from `DriftMonitor` reset the model (or boost the LR),
    land as ``drift`` / ``learner_reset`` events in the profiler, and
    force a publish so serving recovers at the cadence floor;
  * `__getstate__`/`__setstate__` make the actor checkpointable through
    the standard actor checkpoint path (``checkpoint_interval=K`` at
    spawn) — a killed learner node restores from the last checkpoint
    and replays only the log tail.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.streaming.drift import (AdwinDetector, DriftMonitor,
                                         LossEWMADetector)
from repro_torch.streaming.sources import StreamBatch, _log_event


class OnlineLogit:
    """Online logistic regression: ``p = sigmoid(x @ w + b)``, one SGD
    step on the mean log-loss gradient per mini-batch."""

    def __init__(self, dim: int, lr: float = 0.8, l2: float = 1e-4):
        self.dim = dim
        self.lr = lr
        self.l2 = l2
        self.w = np.zeros(dim, np.float64)
        self.b = 0.0

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        z = np.clip(x @ self.w + self.b, -30.0, 30.0)
        return 1.0 / (1.0 + np.exp(-z))

    def learn(self, x: np.ndarray, y: np.ndarray,
              lr: Optional[float] = None) -> float:
        """One minibatch SGD step; returns the pre-update log loss."""
        lr = self.lr if lr is None else lr
        p = self.predict_proba(x)
        eps = 1e-7
        loss = float(-np.mean(y * np.log(p + eps)
                              + (1.0 - y) * np.log(1.0 - p + eps)))
        g = (p - y) / max(len(y), 1)
        self.w -= lr * (x.T @ g + self.l2 * self.w)
        self.b -= lr * float(np.sum(g))
        return loss

    def reset(self) -> None:
        self.w = np.zeros(self.dim, np.float64)
        self.b = 0.0

    def params(self) -> Dict[str, np.ndarray]:
        return {"w": self.w.astype(np.float32),
                "b": np.float32(self.b)}


class StreamLearner:
    """Actor body: predict-then-learn per mini-batch, drift-reactive,
    publishing versioned ParamSets. ``on_drift`` is the reaction policy:
    ``"reset"`` reinitializes the model (abrupt concept change — old
    weights are anti-knowledge), ``"boost"`` multiplies the LR for
    ``boost_steps`` steps (gradual change — adapt faster, keep what
    transfers)."""

    def __init__(self, name: str, dim: int, lr: float = 0.8,
                 publish_every: int = 8, on_drift: str = "reset",
                 boost_factor: float = 4.0, boost_steps: int = 20,
                 adwin_delta: float = 0.002, ewma_factor: float = 1.6,
                 num_shards: int = 1):
        assert on_drift in ("reset", "boost")
        self.name = name
        self.model = OnlineLogit(dim, lr=lr)
        self.monitor = DriftMonitor(
            adwin=AdwinDetector(delta=adwin_delta),
            ewma=LossEWMADetector(factor=ewma_factor))
        self.publish_every = max(1, publish_every)
        self.on_drift = on_drift
        self.boost_factor = boost_factor
        self.boost_steps = boost_steps
        self.num_shards = num_shards
        self.steps = 0
        self.samples = 0
        self.resets = 0
        self.drift_events = 0
        self.published_version = 0
        self.trained_through_step = -1
        self.trained_through_t = 0.0
        self._boost_left = 0

    # ------------------------------------------------------------- step

    def step(self, batch: StreamBatch) -> Dict[str, Any]:
        """One prequential step: predict (score), learn, feed the drift
        monitor, react, publish on cadence. Returns the step metrics the
        pipeline folds into its rolling accuracy series."""
        x, y = batch.x.astype(np.float64), batch.y.astype(np.float64)
        p = self.model.predict_proba(x)
        acc = float(np.mean((p > 0.5) == (y > 0.5)))
        lr = None
        if self._boost_left > 0:
            lr = self.model.lr * self.boost_factor
            self._boost_left -= 1
        loss = self.model.learn(x, y, lr=lr)
        self.steps += 1
        self.samples += len(y)
        self.trained_through_step = batch.step
        self.trained_through_t = batch.t

        fired = self.monitor.update(1.0 - acc, batch.step)
        reset = False
        for ev in fired:
            self.drift_events += 1
            _log_event("drift", f"{self.name}@s{ev.step}",
                       detector=ev.detector, score=round(ev.score, 4))
            if self.on_drift == "reset" and not reset:
                self.model.reset()
                self.resets += 1
                reset = True
                _log_event("learner_reset", f"{self.name}@s{ev.step}",
                           detector=ev.detector)
            elif self.on_drift == "boost":
                self._boost_left = self.boost_steps

        version = None
        if fired or self.steps % self.publish_every == 0:
            version = self._publish()
        return {"step": batch.step, "t": batch.t, "loss": loss,
                "acc": acc, "drift": len(fired), "reset": reset,
                "version": version, "learner_steps": self.steps}

    def _publish(self) -> int:
        from repro_torch.compute.params import ParamSet
        ps = ParamSet.publish(
            self.name, self.model.params(), num_shards=self.num_shards,
            meta={"stream_step": self.trained_through_step,
                  "stream_t": self.trained_through_t,
                  "learner_steps": self.steps})
        self.published_version = ps.version
        return ps.version

    def publish_now(self) -> int:
        """Off-cadence publish (pipeline warmup / recovery probe)."""
        return self._publish()

    def stats(self) -> Dict[str, Any]:
        return {"steps": self.steps, "samples": self.samples,
                "resets": self.resets, "drift_events": self.drift_events,
                "published_version": self.published_version,
                "trained_through_step": self.trained_through_step,
                "trained_through_t": self.trained_through_t}

    # ------------------------------------------- checkpoint (actor path)

    def __getstate__(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["model"] = {"dim": self.model.dim, "lr": self.model.lr,
                      "l2": self.model.l2, "w": self.model.w.copy(),
                      "b": self.model.b}
        return d

    def __setstate__(self, state: Dict[str, Any]) -> None:
        m = state.pop("model")
        self.__dict__.update(state)
        self.model = OnlineLogit(m["dim"], lr=m["lr"], l2=m["l2"])
        self.model.w = np.asarray(m["w"], np.float64)
        self.model.b = float(m["b"])
