"""Paper §4.2: the RL training workload, three executors — the port of
the runs of `benchmarks/rl_workload.py` onto `repro_torch.core`, with the
policy update in PyTorch on the card. It writes no file: `run()` returns
the reference's dict.

Workload (faithful to the paper's description): alternate stages of
(a) parallel environment simulations (~7ms heterogeneous CPU tasks — the
paper reports ~7ms mean task length) and (b) batched policy updates on an
accelerator. Executors:

  serial  — single-threaded reference (paper's baseline = 1.0x)
  bsp     — centralized-driver + stage-barrier (the structural model of
            the paper's Spark comparison; per-task driver overhead 2.5ms)
  hybrid  — the runtime: local-first scheduling, wait()-pipelined
            consumption so policy updates overlap straggler simulations

Paper numbers: Spark 9x SLOWER than serial; prototype 7x FASTER than
serial => 63x end-to-end. The policy is a real (tiny) parameter vector
updated with a real gradient step on `device` (the card unless
`device="cpu"`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import core
from repro_torch.core.executors import BSPExecutor, SerialExecutor
from repro_torch.device import DeviceLike, resolve_device

SIM_MS = 7.0          # paper: ~7ms tasks
HETERO = 0.5          # +-50% duration heterogeneity (R4)
N_SIM = 32            # simulations per stage
N_STAGES = 6
STRAGGLER_MS = 25.0   # one straggler per stage


def simulate(args):
    """One environment rollout of `dur_ms`. As in the paper (whose
    simulators are external processes), the rollout duration is modeled
    by a GIL-releasing sleep plus a small real numpy step. What the
    workload then measures is exactly what §4.2 compares: per-task system
    overhead + the schedule's critical path."""
    seed, dur_ms = args
    rng = np.random.default_rng(seed)
    time.sleep(dur_ms / 1e3)
    g = rng.standard_normal(8).astype(np.float32)      # rollout gradient
    return np.float32(g.mean()), g


def _durations(stage: int) -> list:
    rng = np.random.default_rng(stage)
    durs = SIM_MS * (1 + HETERO * (2 * rng.random(N_SIM) - 1))
    durs[0] = STRAGGLER_MS          # straggler (R1/R4: wait() should hide it)
    return [(stage * 1000 + i, float(d)) for i, d in enumerate(durs)]


def policy_update(w: torch.Tensor, grads_batch: torch.Tensor) -> torch.Tensor:
    g = torch.mean(grads_batch, dim=0)
    return w - 0.01 * g


def _grads(gs, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.stack(gs)).to(device)


def _block(w: torch.Tensor) -> None:
    """Wait until the device has computed `w` (block_until_ready)."""
    if w.is_cuda:
        torch.cuda.synchronize(w.device)


def run_serial(device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    ex = SerialExecutor()
    w = torch.zeros(8, device=dev)
    t0 = time.perf_counter()
    for stage in range(N_STAGES):
        outs = ex.map_stage(simulate, _durations(stage))
        w = policy_update(w, _grads([g for _, g in outs], dev))
    _block(w)
    return time.perf_counter() - t0


def run_bsp(driver_overhead_s: float = 0.0025,
            device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    ex = BSPExecutor(num_workers=8, driver_overhead_s=driver_overhead_s)
    w = torch.zeros(8, device=dev)
    t0 = time.perf_counter()
    for stage in range(N_STAGES):
        outs = ex.map_stage(simulate, _durations(stage))
        w = policy_update(w, _grads([g for _, g in outs], dev))
    _block(w)
    ex.shutdown()
    return time.perf_counter() - t0


def run_hybrid(device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    core.init(num_nodes=4, workers_per_node=2)
    try:
        sim_task = core.remote(simulate)
        w = torch.zeros(8, device=dev)
        t0 = time.perf_counter()
        pending = [sim_task.submit(a) for a in _durations(0)]
        for stage in range(N_STAGES):
            # pipeline: consume in completion order, update policy on
            # partial batches while stragglers run; prefetch next stage
            # immediately (R3)
            nxt = ([sim_task.submit(a) for a in _durations(stage + 1)]
                   if stage + 1 < N_STAGES else [])
            grads = []
            while pending:
                done, pending = core.wait(pending,
                                          num_returns=min(8, len(pending)),
                                          timeout=1.0)
                if done:
                    grads.extend(g for _, g in core.get(done))
                    w = policy_update(w, _grads(grads[-len(done):], dev))
            pending = nxt
        _block(w)
        return time.perf_counter() - t0
    finally:
        core.shutdown()


def run(device: DeviceLike = None) -> dict:
    dev = resolve_device(device)     # no card: raise before any run
    serial_s = run_serial(dev)
    # the BSP/"Spark" number is a function of the modeled per-task driver
    # overhead; report the sensitivity instead of picking one flattering
    # point. 2.5 ms is conservative (Ousterhout NSDI'15 task-launch range);
    # the paper's "Spark 9x slower than serial" implies ~60 ms/task for
    # 7 ms tasks, i.e. the 10 ms point is still charitable to Spark.
    bsp_s = run_bsp(0.0025, dev)
    bsp10_s = run_bsp(0.010, dev)
    hybrid_s = run_hybrid(dev)
    return {
        "serial_s": serial_s, "bsp_s": bsp_s, "bsp10_s": bsp10_s,
        "hybrid_s": hybrid_s,
        "bsp_vs_serial": serial_s / bsp_s,          # paper: 1/9 = 0.11
        "bsp10_vs_serial": serial_s / bsp10_s,
        "hybrid_vs_serial": serial_s / hybrid_s,    # paper: 7
        "hybrid_vs_bsp": bsp_s / hybrid_s,          # paper: 63
        "hybrid_vs_bsp10": bsp10_s / hybrid_s,
        "paper": {"bsp_vs_serial": 1 / 9, "hybrid_vs_serial": 7,
                  "hybrid_vs_bsp": 63},
        "config": {"n_sim": N_SIM, "n_stages": N_STAGES, "sim_ms": SIM_MS,
                   "straggler_ms": STRAGGLER_MS},
    }
