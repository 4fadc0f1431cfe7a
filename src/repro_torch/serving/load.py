"""Open-loop load generation: seeded arrival traces + replay.

The paper's serving deployments face an *arrival process*, not a batch:
requests show up on their own clock whether or not the system keeps up
(open loop). A closed-loop driver — submit, wait, submit — self-throttles
under overload and hides exactly the queueing collapse an SLO benchmark
exists to measure. This module builds deterministic, seeded traces as
plain ``(arrival_s, prompt_len, max_new_tokens)`` tuples so the same
trace can drive the front door (``replay``), a fixed-batch baseline or a
smoke run of the engine — no torch, no engine import at module load. This
is the port's own copy of ``repro.serving.load``.

Arrival shapes:
  * ``poisson_trace``  — memoryless steady load (exponential gaps);
  * ``burst_trace``    — steady base rate with a rate-step burst window
                         (the autoscale scenario's 3x step);
  * ``diurnal_trace``  — sinusoidal rate via thinning (peak-hour wave).

Prompt lengths are heavy-tailed over a *small bucket set*: mostly short
prompts with a long-prompt tail, matching observed LLM serving mixes,
while keeping the number of distinct lengths small enough that
length-aligned batching (engine.length_aligned_waves) can actually form
full waves.
"""
from __future__ import annotations

import math
import random
import time
from typing import Callable, List, Sequence, Tuple

# one trace entry: (arrival time s from trace start, prompt len, budget)
TraceEntry = Tuple[float, int, int]

#: heavy-tail prompt-length mix: few distinct buckets (EDF queues and
#: length-aligned waves stay dense), weighted toward short prompts
LENGTH_BUCKETS: Sequence[int] = (8, 16, 32, 64)
LENGTH_WEIGHTS: Sequence[float] = (0.45, 0.30, 0.17, 0.08)


def _lengths(rng: random.Random) -> Callable[[], int]:
    buckets, weights = list(LENGTH_BUCKETS), list(LENGTH_WEIGHTS)

    def draw() -> int:
        return rng.choices(buckets, weights=weights, k=1)[0]
    return draw


def poisson_trace(rate_hz: float, duration_s: float, seed: int,
                  max_new_tokens: int = 4) -> List[TraceEntry]:
    """Memoryless arrivals: exponential inter-arrival gaps at `rate_hz`."""
    rng = random.Random(seed)
    draw_len = _lengths(rng)
    out: List[TraceEntry] = []
    t = rng.expovariate(rate_hz)
    while t < duration_s:
        out.append((t, draw_len(), max_new_tokens))
        t += rng.expovariate(rate_hz)
    return out


def burst_trace(base_rate_hz: float, burst_rate_hz: float,
                duration_s: float, burst_start_s: float,
                burst_end_s: float, seed: int,
                max_new_tokens: int = 4) -> List[TraceEntry]:
    """Steady base rate with a rate step inside [burst_start, burst_end)
    — the autoscaling scenario's 3x arrival-rate step."""
    rng = random.Random(seed)
    draw_len = _lengths(rng)
    out: List[TraceEntry] = []
    t = 0.0
    while True:
        rate = (burst_rate_hz if burst_start_s <= t < burst_end_s
                else base_rate_hz)
        t += rng.expovariate(rate)
        if t >= duration_s:
            return out
        out.append((t, draw_len(), max_new_tokens))


def diurnal_trace(mean_rate_hz: float, amplitude: float, period_s: float,
                  duration_s: float, seed: int,
                  max_new_tokens: int = 4) -> List[TraceEntry]:
    """Sinusoidal arrival-rate wave via thinning: candidate arrivals at
    the peak rate, kept with probability rate(t)/peak. `amplitude` in
    [0, 1) scales the swing around the mean (1.0 would touch zero)."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = random.Random(seed)
    draw_len = _lengths(rng)
    peak = mean_rate_hz * (1.0 + amplitude)
    out: List[TraceEntry] = []
    t = rng.expovariate(peak)
    while t < duration_s:
        rate = mean_rate_hz * (
            1.0 + amplitude * math.sin(2.0 * math.pi * t / period_s))
        if rng.random() < rate / peak:
            out.append((t, draw_len(), max_new_tokens))
        t += rng.expovariate(peak)
    return out


def materialize(trace: Sequence[TraceEntry], seed: int = 0,
                vocab: int = 1000) -> List[Tuple[float, "object"]]:
    """Turn a pure trace into ``(arrival_s, Request)`` pairs with seeded
    random token prompts. Imports the engine lazily — traces themselves
    never pay the torch import."""
    import numpy as np

    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    out = []
    for i, (t, plen, budget) in enumerate(trace):
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        out.append((t, Request(i, prompt, budget)))
    return out


def replay(trace_requests, submit: Callable, *,
           time_fn: Callable[[], float] = time.perf_counter,
           sleep: Callable[[float], None] = time.sleep) -> int:
    """Open-loop replay: call ``submit(request)`` at each arrival's
    scheduled wall-clock offset, *never* waiting on completions — a slow
    server sees the queue grow, exactly as production would. ``submit``
    absorbs admission/overload errors itself (the front door's submit
    raises typed errors; the bench wraps it to count them). Returns the
    number of submit calls made."""
    start = time_fn()
    n = 0
    for arrival_s, request in trace_requests:
        delay = start + arrival_s - time_fn()
        if delay > 0:
            sleep(delay)
        submit(request)
        n += 1
    return n
