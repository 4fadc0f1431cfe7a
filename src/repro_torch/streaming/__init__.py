"""Streaming online-learning plane: train-while-serve on live data. The
port of `repro.streaming` onto `repro_torch.core` and the port's
FrontDoor; streams, detectors, the learner's model and the scoring stay
numpy on the host, as in the reference.

The paper's motivating loop — perceive, learn, and act inside one
millisecond-scale feedback cycle — needs training and serving active on
the *same* stream at the same time. This package wires the existing
planes together into that loop:

  * `sources` — long-lived producer actors emitting seeded, replayable
    feature/label streams with scheduled concept drift, batched into
    bounded, back-pressured mini-batch refs in the object store.
  * `learner` — a `StreamLearner` actor running predict-then-learn
    (prequential, River idiom) through compiled per-step graphs and
    publishing weights as versioned `ParamSet`s on a cadence policy.
  * `drift` — online drift detectors (ADWIN-style window split, loss
    EWMA) that fire learner resets / LR boosts and emit typed
    `DriftEvent`s into the profiler's event log.
  * `pipeline` — `StreamingPipeline`: sources → learner → the serving
    `FrontDoor`, with replicas hot-swapping to the newest weight version
    between waves and weight-staleness SLOs (version lag,
    seconds-behind-stream) tracked next to p50/p99 goodput.
"""
from repro_torch.streaming.drift import (AdwinDetector, DriftEvent,
                                         DriftMonitor, LossEWMADetector)
from repro_torch.streaming.sources import (DriftSpec, StreamBatch,
                                           StreamConfig, StreamSource,
                                           synthetic_stream)

# learner/pipeline resolve lazily (serving-layer idiom): they pull in
# the FrontDoor, and the pure pieces above must stay importable by the
# DES simulator without paying that import.
_LEARNER = ("OnlineLogit", "StreamLearner")
_PIPELINE = ("OnlineServingEngine", "StreamingPipeline", "StreamResponse")

__all__ = [
    "AdwinDetector", "DriftEvent", "DriftMonitor", "LossEWMADetector",
    "DriftSpec", "StreamBatch", "StreamConfig", "StreamSource",
    "synthetic_stream", *_LEARNER, *_PIPELINE,
]


def __getattr__(name):
    if name in _LEARNER:
        from repro_torch.streaming import learner
        return getattr(learner, name)
    if name in _PIPELINE:
        from repro_torch.streaming import pipeline
        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
