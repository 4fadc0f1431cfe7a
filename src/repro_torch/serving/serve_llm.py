"""Serve an LM through the open-loop front door: seeded Poisson arrivals
land on their own clock, admission control bounds the queue, expired
requests are shed before dispatch (EDF), the AIMD controller adapts the
wave size to the engine's measured latency, and the replica actors run the
port's `ServingEngine` — the port of `examples/serve_llm.py`.

Requests are submitted with a per-request deadline; the run ends with the
SLO tracker's disposition ledger (ok/late/shed/rejected), sliding latency
percentiles, and goodput.

Run:
    python -m repro_torch.serving.serve_llm                 # the card, smoke config
    python -m repro_torch.serving.serve_llm --full          # full width, bf16
    python -m repro_torch.serving.serve_llm --device cpu    # the CPU

Without `--full` the model is the arch's smoke config in fp32, as in the
reference; with it, the full config in its own dtype. The weights are
random from `--seed` (`bridge.init_params`), made once on the device; every
replica's engine reads that one copy.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import core
from repro_torch.bridge import init_params
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import profiler
from repro_torch.core.api import _cluster
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import load as serving_load
from repro_torch.serving.engine import Request, Response, ServingEngine
from repro_torch.serving.frontdoor import (AdmissionError, DeadlineShedError,
                                           FrontDoor)

#: the widest wave a replica serves (the reference example's setting)
MAX_BATCH = 2


@dataclass
class ServeRun:
    """What one `serve` saw once its arrival clock started."""
    offered: int                 # submit calls the trace made
    tickets: int                 # requests admitted
    ok: int                      # tickets fulfilled
    shed: int                    # tickets that raised
    responses: List[Response]    # the fulfilled tickets' responses
    stats: dict                  # `FrontDoor.stats()` after the drain
    goodput: float               # `SLOTracker.overall_goodput()`
    waves: int                   # waves dispatched after the probes
    wave_width: float            # their mean width
    events: list                 # the control plane's event log


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean open-loop arrival rate (req/s)")
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--deadline-ms", type=float, default=2000.0)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not smoke) architecture config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def warm_engine_factory(model, params, max_seq: int, max_batch: int,
                        device) -> Callable[[], ServingEngine]:
    """The factory each replica actor runs in its constructor: an engine
    over the shared `params` (no copy where they already live on
    `device`), warmed on every (wave width, prompt length) shape the trace
    can produce, so no first-call cost blows a deadline once the open-loop
    clock starts."""
    def warm_engine():
        eng = ServingEngine(model, params, max_seq=max_seq, device=device)
        for plen in serving_load.LENGTH_BUCKETS:
            for width in range(1, max_batch + 1):
                reqs = [Request(0, np.arange(plen, dtype=np.int32) % 7 + 1,
                                max_new_tokens=2) for _ in range(width)]
                eng.serve(reqs, max_wave=width)
        return eng
    return warm_engine


def _waves(gcs) -> tuple:
    """Waves dispatched so far and the requests in them."""
    s = profiler.summarize(gcs)
    return s["serve_waves"], s["serve_waves"] * s["serve_wave_size_mean"]


def serve(args: argparse.Namespace, model=None, params=None,
          on_clock_start: Optional[Callable[[], None]] = None) -> ServeRun:
    """The example's run: build the fleet, probe every replica, replay the
    open-loop trace, drain, print the ledger, shut the cluster down, and
    check that every ticket resolved and none was dispatched late.
    `model` and `params` default to the config's model and random weights
    from `--seed` on the device; `on_clock_start` runs just before the
    arrival clock starts."""
    device = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.full
           else get_smoke_config(args.arch).scaled(param_dtype="float32"))
    if model is None:
        model = build_model(cfg)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed))
    max_seq = max(serving_load.LENGTH_BUCKETS) + args.max_new + 4

    core.init(num_nodes=2, workers_per_node=2)
    try:
        # fixed fleet: the example demonstrates the open-loop SLO path;
        # each replica actor builds its engine on its node
        fd = FrontDoor(
            warm_engine_factory(model, params, max_seq, MAX_BATCH, device),
            num_replicas=args.replicas, min_replicas=args.replicas,
            max_replicas=args.replicas,
            default_deadline_s=args.deadline_ms / 1e3,
            target_wave_s=0.5 * args.deadline_ms / 1e3,
            max_batch=MAX_BATCH, resources={"cpu": 0.25})
        try:
            run = _drive(args, cfg, fd, on_clock_start)
        finally:
            fd.close()
    finally:
        core.shutdown()
    assert run.ok + run.shed == run.tickets
    assert run.stats["dispatched_past_deadline"] == 0
    return run


def _drive(args, cfg, fd: FrontDoor, on_clock_start) -> ServeRun:
    """Probe every replica, replay the trace, drain, print the ledger."""
    # readiness probes: replica constructors (and their warm-up) run
    # asynchronously — don't start the arrival clock until every replica
    # has served a round
    probe_trace = [(0.0, serving_load.LENGTH_BUCKETS[0], args.max_new)
                   ] * (2 * args.replicas)
    probes = serving_load.materialize(probe_trace, seed=args.seed,
                                      vocab=cfg.vocab_size - 1)
    for t in [fd.submit_request(r, deadline_s=600.0) for _, r in probes]:
        t.result(timeout=600)

    trace = serving_load.poisson_trace(args.rate, args.duration,
                                       seed=args.seed,
                                       max_new_tokens=args.max_new)
    reqs = serving_load.materialize(trace, seed=args.seed,
                                    vocab=cfg.vocab_size - 1)
    tickets = []

    def submit(req):
        try:
            tickets.append(fd.submit_request(req))
        except AdmissionError:
            pass                           # counted by the SLO tracker

    gcs = _cluster().gcs
    waves0, requests0 = _waves(gcs)
    if on_clock_start is not None:
        on_clock_start()
    # open loop: replay submits on the trace's clock and never waits on
    # completions — the system keeps up or the ledger shows it didn't
    offered = serving_load.replay(reqs, submit)

    ok = shed = 0
    responses = []
    for t in tickets:
        try:
            responses.append(t.result(timeout=120))
            ok += 1
        except (DeadlineShedError, core.TaskError, TimeoutError):
            shed += 1
    st = fd.stats()
    goodput = fd.slo.overall_goodput()
    waves1, requests1 = _waves(gcs)
    waves = waves1 - waves0
    print(f"offered {offered} req @ {args.rate:.0f}/s open-loop, "
          f"deadline {args.deadline_ms:.0f}ms")
    print(f"  admitted={st['admitted']} rejected={st['rejected']} "
          f"ok={st['completed_ok']} late={st['completed_late']} "
          f"shed={st['shed']}")
    print(f"  latency p50={st['latency_p50_ms']:.1f}ms "
          f"p99={st['latency_p99_ms']:.1f}ms "
          f"goodput={goodput:.1f}/s")
    print(f"  replicas={st['replicas']} batch_limits={st['batch_limits']} "
          f"dispatched_past_deadline={st['dispatched_past_deadline']}")
    width = (requests1 - requests0) / max(waves, 1)
    print(f"  waves={waves} mean width={width:.2f} (after the probes)")
    return ServeRun(offered, len(tickets), ok, shed, responses, st, goodput,
                    waves, width, gcs.events())


def main(argv=None) -> int:
    serve(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
