"""Data-parallel LM training: the port of `examples/train_lm.py`, both its
modes, which compute the same step.

Each step computes the loss and gradients of every data shard, takes their
mean, and applies AdamW with `lr_scale` 1.

- Task-graph mode (the default, as in the reference): every step is ONE
  compiled-graph invocation over a device-typed cluster of the port's
  runtime: one `kernel_task` grad shard per data shard, a reduce node
  averaging the shard gradients and an AdamW apply node. The cluster
  declares one `{"cpu": 2, "gpu": 1}` node per shard and a `{"cpu": 2}`
  node, as the reference's does, but the runtime's compile-time plan
  (the reference's planner) co-locates all four graph nodes on node 0:
  the grad shards run in turn on that node's one device lane (ROADMAP
  §C, open question of the plan). The updated params and opt-state futures feed the
  next step's execute directly; every `publish_every` steps the driver
  publishes a versioned `ParamSet`. The apply returns new tensors and
  leaves its inputs as they are: they stay in the object store, where a
  lineage replay after a node loss reads them again.
- `--sync`: a single-process loop that updates params and moments in
  place, with no runtime.

Run:  python -m repro_torch.train.lm --device cpu --steps 12
      python -m repro_torch.train.lm --sync --device cpu --steps 12
      python -m repro_torch.train.lm --full            # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch import core, dag
from repro_torch.bridge import init_params
from repro_torch.compute import ParamSet, kernel_task
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import profiler
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_map


# Seconds a driver waits for one step's results, as the reference's loop.
GET_TIMEOUT_S = 120.0


def build_step_fns(model, opt_cfg: AdamWConfig):
    """The compute payloads of one training step: per-shard (loss, grads),
    the mean of the shards' grads, and the AdamW apply. The apply updates
    copies of params and moments, so the tensors it was given are left as
    they were (the `--sync` loop updates in place with `adamw_update`)."""
    def grad_shard(params, batch):
        (loss, _), grads = value_and_grad(model, params, batch)
        return loss, grads

    def reduce_grads(*shard_grads):
        n = float(len(shard_grads))
        return tree_map(lambda *gs: sum(gs) / n, *shard_grads)

    def apply_update(params, opt_state, grads):
        params, opt_state, _ = adamw_update(
            opt_cfg, grads, tree_map(torch.clone, opt_state),
            tree_map(torch.clone, params))
        return params, opt_state

    return grad_shard, reduce_grads, apply_update


class StepGraph:
    """`examples/train_lm.py`'s step compiled once on the running cluster:
    inputs (params, opt_state, *shard batches), outputs (params',
    opt_state', *shard losses). `params_ref`/`opt_ref` are the futures of
    the newest params and optimizer state."""

    def __init__(self, model, opt_cfg: AdamWConfig, params, opt_state,
                 shards: int):
        grad_shard_fn, reduce_fn, apply_fn = build_step_fns(model, opt_cfg)
        # forward/backward is a device kernel task, placed only where a gpu
        # unit exists. Unlike the reference it takes no warm-up call: there
        # is nothing to compile, and the first step builds the CUDA kernels
        grad_shard = kernel_task(grad_shard_fn, resources={"gpu": 1.0},
                                 num_returns=2)
        reduce_grads = core.remote(reduce_fn)
        apply_update = core.remote(apply_fn, num_returns=2)
        gs = [grad_shard.bind(dag.input(0), dag.input(2 + s))
              for s in range(shards)]
        red = reduce_grads.bind(*[g[1] for g in gs])
        upd = apply_update.bind(dag.input(0), dag.input(1), red)
        self.cg = dag.compile([upd[0], upd[1]] + [g[0] for g in gs])
        # The first state enters through a task, not a driver put: a driver
        # put has no lineage, and once its node is lost (or it is reclaimed
        # after step 1) no replay could reach back past it. The task hands
        # back the caller's tensors, which the apply never modifies.
        self.params_ref, self.opt_ref = core.remote(
            lambda: (params, opt_state), num_returns=2).submit()

    def step(self, batches) -> float:
        """One invocation; returns the mean loss over the shards."""
        # A graph root whose input was lost with its node waits for the
        # object on pub-sub and never asks for a replay; a get does. Under
        # the thread backend it hands back the stored objects, no copy.
        core.get([self.params_ref, self.opt_ref], timeout=GET_TIMEOUT_S)
        refs = self.cg.execute(self.params_ref, self.opt_ref, *batches)
        self.params_ref, self.opt_ref = refs[0], refs[1]
        losses = core.get(list(refs[2:]), timeout=GET_TIMEOUT_S)
        return float(sum(losses) / len(losses))


@dataclass
class TrainResult:
    losses: List[float]            # mean loss over the shards, per step
    step_ms: List[float]           # host clock per step, data included
    params: Any
    opt_state: Dict[str, Any]
    # task-graph mode: `profiler.summarize` of the run's cluster
    stats: Dict[str, float] = field(default_factory=dict)


def train_lm(cfg: ModelConfig, steps: int, batch: int, seq_len: int,
             shards: int, device: DeviceLike = None, *,
             params: Optional[Any] = None, sync: bool = False,
             publish_every: int = 10) -> TrainResult:
    """Train `steps` steps on `batch_for_step` data, `batch` sequences of
    `seq_len` tokens a step in `shards` data shards, as one compiled task
    graph a step (or, with `sync`, the single-process loop). `params`
    default to `init_params` from seed 0; given, the `sync` loop trains
    them in place and the task graph leaves them as they are. The graph
    publishes a `ParamSet` "lm" every `publish_every` steps (0: never).
    Runs on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    if batch % shards:
        raise ValueError(f"batch {batch} is not a multiple of shards {shards}")
    model = build_model(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=batch, num_shards=shards,
                          input_mode=cfg.input_mode, d_model=cfg.d_model,
                          num_image_tokens=cfg.num_image_tokens)
    opt_cfg = AdamWConfig(lr=1e-3)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params)
    shard_cfgs = [dataclasses.replace(data_cfg, shard_id=s)
                  for s in range(shards)]

    def batches(step):
        return [{"tokens": torch.from_numpy(batch_for_step(c, step)["tokens"])
                 .long().to(dev)} for c in shard_cfgs]

    if sync:
        return _train_sync(model, opt_cfg, params, opt_state, batches, steps)
    cluster = core.init(node_resources=(
        [{"cpu": 2.0, "gpu": 1.0}] * shards + [{"cpu": 2.0}]))
    try:
        graph = StepGraph(model, opt_cfg, params, opt_state, shards)
        losses, step_ms = [], []
        for step in range(steps):
            t0 = time.perf_counter()
            losses.append(graph.step(batches(step)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if publish_every and (step + 1) % publish_every == 0:
                ParamSet.publish("lm", core.get(graph.params_ref,
                                                timeout=GET_TIMEOUT_S),
                                 num_shards=shards)
        params, opt_state = core.get([graph.params_ref, graph.opt_ref],
                                     timeout=GET_TIMEOUT_S)
        stats = profiler.summarize(cluster.gcs)
    finally:
        core.shutdown()
    return TrainResult(losses, step_ms, params, opt_state, stats)


def _train_sync(model, opt_cfg, params, opt_state, batches, steps
                ) -> TrainResult:
    grad_shard, reduce_grads, _ = build_step_fns(model, opt_cfg)
    losses, step_ms = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        results = []     # the last step's grads go before this one's come
        for b in batches(step):
            results.append(grad_shard(params, b))
        params, opt_state, _ = adamw_update(
            opt_cfg, reduce_grads(*[g for _, g in results]), opt_state,
            params)
        losses.append(float(sum(loss for loss, _ in results) / len(results)))
        step_ms.append((time.perf_counter() - t0) * 1e3)   # float() synced
    return TrainResult(losses, step_ms, params, opt_state)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shards", type=int, default=2,
                    help="data-parallel gradient shards")
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--publish-every", type=int, default=10,
                    help="publish a versioned ParamSet every N steps")
    ap.add_argument("--sync", action="store_true",
                    help="single-process loop (no task runtime)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = (get_config(args.arch) if args.full
           else get_smoke_config(args.arch).scaled(
               num_layers=4, d_model=256, param_dtype="float32",
               vocab_size=2048))
    cfg = cfg.scaled(train_microbatch=0)
    t0 = time.perf_counter()
    result = train_lm(cfg, args.steps, args.batch, args.seq_len, args.shards,
                      args.device, sync=args.sync,
                      publish_every=args.publish_every)
    dt = time.perf_counter() - t0
    losses = result.losses
    if not args.sync:
        stats = result.stats
        print(f"kernel tasks: {stats['kernel_tasks']:.0f}, mean on-device "
              f"{stats['kernel_time_ms_mean']:.1f} ms, device waits "
              f"{stats['device_waits']:.0f}, param publishes "
              f"{stats['param_publishes']:.0f}")
    print(f"\ntrained {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq_len / dt:.0f} tok/s)")
    print("loss curve:", [(s, round(l, 3)) for s, l in
                          list(enumerate(losses))[:: max(1, len(losses) // 8)]])
    first, last = losses[0], losses[-1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
