"""Train launcher: --arch <id> on one card. The port of
`repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --steps 100 --batch 8 --seq-len 256 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --smoke --steps 2 --batch 2 --seq-len 32 --device cpu

The reference jit-compiles its train step under the sharding rules of its
mesh; the port runs `make_train_step` eagerly at world size 1 (`--mesh
host`), the card by default, the CPU only with `--device cpu`. `single` and
`multi` are the production plans over many devices: the loop drives one
card and raises for them (ROADMAP A18); `repro_torch.launch.dryrun` traces
a step under either plan without devices. The config's
`remat_policy` and `train_microbatch` hold as the model and the step read
them; `--smoke` takes the reduced config in fp32 without microbatches.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, List, Optional

import torch

from repro_torch.bridge import init_params
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import _to_device


def launch_config(arch: str, smoke: bool) -> ModelConfig:
    """The config `--arch` and `--smoke` select."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if smoke:
        cfg = cfg.scaled(param_dtype="float32", train_microbatch=0)
    return cfg


def train(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
          device: DeviceLike = None, ckpt_dir: str = "", log_every: int = 10,
          params=None, mesh: Optional[Mesh] = None,
          on_step: Optional[Callable[[int, dict], None]] = None,
          on_state: Optional[Callable[[Any, Any], None]] = None
          ) -> List[float]:
    """The launcher's loop on `mesh` (`make_host_mesh()` by default; the
    port drives one card): `Prefetcher` batches, `make_train_step`, AdamW
    moments in `cfg.opt_state_dtype`, a log line every `log_every` steps
    and at the last, an async checkpoint every 50 steps. `params` (updated
    in place) default to `init_params` from a generator seeded 0 on the
    device. `on_step(step, metrics)`, if given, is called after each step
    is queued, with the metrics still on the device; `on_state(params,
    opt_state)` once before the first step, with the state the loop holds.
    Returns every step's
    loss, read from the device once at the end: only the log lines wait
    for the card inside the loop."""
    mesh = mesh or make_host_mesh()
    if mesh.size != 1:
        raise ValueError(f"mesh {mesh.shape}: the port's loop drives one "
                         "device (ROADMAP A18)")
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params, cfg.opt_state_dtype)
    step_fn = make_train_step(model, AdamWConfig(state_dtype=cfg.opt_state_dtype))
    if on_state is not None:
        on_state(params, opt_state)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    pf = Prefetcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=batch, input_mode=cfg.input_mode,
                               d_model=cfg.d_model,
                               num_image_tokens=cfg.num_image_tokens))
    losses = []
    try:
        for step in range(steps):
            params, opt_state, metrics = step_fn(
                params, opt_state, _to_device(pf.next(), dev))
            losses.append(metrics["loss"].detach())
            if on_step is not None:
                on_step(step, metrics)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            if ckpt and (step + 1) % 50 == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          blocking=False)
    finally:
        pf.close()
        if ckpt:
            ckpt.wait()
    return torch.stack(losses).tolist() if losses else []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                         "the host)")
    args = ap.parse_args(argv)

    cfg = launch_config(args.arch, args.smoke)
    if args.mesh != "host":
        plan = make_production_mesh(multi_pod=args.mesh == "multi")
        raise NotImplementedError(
            f"--mesh {args.mesh} plans {plan.size} devices {plan.shape}; "
            "this loop drives one card (ROADMAP A18). For the plan's "
            "memory, FLOPs and collectives per device run python -m "
            f"repro_torch.launch.dryrun --arch {args.arch} --mesh "
            f"{args.mesh}")
    mesh = make_host_mesh()
    train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
          device=args.device, ckpt_dir=args.ckpt_dir,
          log_every=args.log_every, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
