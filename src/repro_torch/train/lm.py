"""Data-parallel LM training: the port of `examples/train_lm.py`'s `--sync`
loop, which computes the same step as its task-graph mode.

Each step computes the loss and gradients of every data shard, takes their
mean, and applies AdamW with `lr_scale` 1. The task-graph mode (`kernel_task`
shards, compiled graphs, `ParamSet` publishing) needs the port's runtime,
which is not there yet.

Run:  python -m repro_torch.train.lm --sync --device cpu --steps 12
      python -m repro_torch.train.lm --sync --full            # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.bridge import init_params
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_map


def build_step_fns(model, opt_cfg: AdamWConfig):
    """The compute payloads of one training step: per-shard (loss, grads),
    the mean of the shards' grads, and the AdamW apply (in place)."""
    def grad_shard(params, batch):
        (loss, _), grads = value_and_grad(model, params, batch)
        return loss, grads

    def reduce_grads(*shard_grads):
        n = float(len(shard_grads))
        return tree_map(lambda *gs: sum(gs) / n, *shard_grads)

    def apply_update(params, opt_state, grads):
        params, opt_state, _ = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state

    return grad_shard, reduce_grads, apply_update


@dataclass
class TrainResult:
    losses: List[float]            # mean loss over the shards, per step
    step_ms: List[float]           # host clock per step, data included
    params: Any
    opt_state: Dict[str, Any]


def train_lm(cfg: ModelConfig, steps: int, batch: int, seq_len: int,
             shards: int, device: DeviceLike = None, *,
             params: Optional[Any] = None) -> TrainResult:
    """Train `steps` steps on `batch_for_step` data, `batch` sequences of
    `seq_len` tokens a step in `shards` data shards. `params` defaults to
    `init_params` from seed 0; given, they are trained in place. Runs on
    the card unless `device="cpu"`."""
    dev = resolve_device(device)
    if batch % shards:
        raise ValueError(f"batch {batch} is not a multiple of shards {shards}")
    model = build_model(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=batch, num_shards=shards,
                          input_mode=cfg.input_mode, d_model=cfg.d_model,
                          num_image_tokens=cfg.num_image_tokens)
    grad_shard, reduce_grads, apply_update = build_step_fns(
        model, AdamWConfig(lr=1e-3))
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params)
    shard_cfgs = [dataclasses.replace(data_cfg, shard_id=s)
                  for s in range(shards)]

    losses, step_ms = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        results = []
        for c in shard_cfgs:
            tokens = torch.from_numpy(batch_for_step(c, step)["tokens"])
            results.append(grad_shard(params, {"tokens": tokens.long().to(dev)}))
        params, opt_state = apply_update(
            params, opt_state, reduce_grads(*[g for _, g in results]))
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
    ap.add_argument("--sync", action="store_true",
                    help="single-process loop (the only mode ported)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.sync:
        raise NotImplementedError(
            "the task-graph mode of train_lm needs the port's runtime "
            "(ROADMAP A10); pass --sync")

    cfg = (get_config(args.arch) if args.full
           else get_smoke_config(args.arch).scaled(
               num_layers=4, d_model=256, param_dtype="float32",
               vocab_size=2048))
    cfg = cfg.scaled(train_microbatch=0)
    t0 = time.perf_counter()
    result = train_lm(cfg, args.steps, args.batch, args.seq_len, args.shards,
                      args.device)
    dt = time.perf_counter() - t0
    losses = result.losses
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
