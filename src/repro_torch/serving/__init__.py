"""Serving layer of the port: batched engine + replica pool (closed loop)
and the open-loop front door (admission control, EDF queueing, adaptive
batching, autoscaling — see frontdoor.py), with the `serve_llm` entry
point above them.

Attributes resolve lazily so the pure pieces (`repro_torch.serving.load`
traces, `repro_torch.serving.slo` metrics) never pay the engine's torch
and model imports.
"""
_ENGINE = ("ReplicaPool", "Request", "Response", "ServingEngine",
           "ServingReplica", "length_aligned_waves")
_FRONTDOOR = ("AdmissionError", "BatchController", "DeadlineShedError",
              "FrontDoor", "ServeTicket")
_SLO = ("SLOTracker",)

__all__ = list(_ENGINE + _FRONTDOOR + _SLO)


def __getattr__(name):
    if name in _ENGINE:
        from repro_torch.serving import engine
        return getattr(engine, name)
    if name in _FRONTDOOR:
        from repro_torch.serving import frontdoor
        return getattr(frontdoor, name)
    if name in _SLO:
        from repro_torch.serving import slo
        return getattr(slo, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
