"""Train launcher: --arch <id> on one card or over a process group. The
port of `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --steps 100 --batch 8 --seq-len 256 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --smoke --steps 2 --batch 2 --seq-len 32 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.train --arch stablelm-1.6b \
      --smoke --steps 2 --batch 4 --seq-len 32 --device cpu

The reference jit-compiles its train step under the sharding rules of its
mesh, "whatever devices exist". The port runs `make_train_step` eagerly:
at world size 1 (no process group) on one device, the card by default,
the CPU only with `--device cpu`, without rules, as before; under
`torch.distributed.run` every rank runs its part of the same step, laid
out by the reference's `ShardingRules` (`parallel.sharding`, executing
over `parallel.collectives.Comm`): one rank a card over `nccl` at
`cuda:LOCAL_RANK`, or ranks on the CPU over `gloo` with `--device cpu`.
`--mesh host` is the reference's pure FSDP mesh (world, 1); `single` and
`multi` are the production plans and run when the world has their 256 or
512 ranks (`repro_torch.launch.dryrun` traces a step under either plan
without devices). Over more than one rank every arch runs on a mesh
whose model axis splits its heads or their columns
(`sharding.check_executable`; phi3's 40 heads over the production plans'
16 run as 320 columns, 2.5 heads, a rank): the dense decoders, mixtral
(MoE, sliding window, any dispatch), jamba (Mamba, MoE, with or without
sequence parallelism), deepseek-v2 (MLA), xlstm-125m (the xLSTM cells),
gemma3-12b (the tied, chunked head), seamless (the encoder, cross-attention and
`frames`, the untied chunked head) and internvl2 (image rows before the
tokens); a rank takes its rows of every input of the batch (`tokens`,
`frames`, `image_embeds`). The config's `remat_policy` and
`train_microbatch` hold as the model and the step read them; `--smoke`
takes the reduced config in fp32 without microbatches;
`--grad-compression` the int8 compressing step. A rank draws only its
blocks of the seeded weights.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.bridge import init_params
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, world_size)
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.collectives import Comm
from repro_torch.parallel.compression import (init_error_feedback,
                                              make_compressing_train_step)
from repro_torch.parallel.sharding import (ShardingRules, block_keeper,
                                           check_executable, make_rules,
                                           shard_tree)
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import _to_device


def launch_config(arch: str, smoke: bool) -> ModelConfig:
    """The config `--arch` and `--smoke` select."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if smoke:
        cfg = cfg.scaled(param_dtype="float32", train_microbatch=0)
    return cfg


def _sharded(cfg: ModelConfig, mesh: Mesh, batch: int, seq_len: int, comm):
    """(rules, the config the rank's model runs) of a step over the process
    group: the executing rules of `mesh` over `comm`, and the microbatch a
    rank takes (the global one over the batch split, as the dry run's
    `trace_cell` takes it)."""
    if comm.mesh != mesh:
        raise ValueError(f"comm over {comm.mesh.shape}, mesh {mesh.shape}")
    rules = make_rules(mesh, cfg, ShapeConfig("cli", "train", seq_len, batch),
                       comm=comm)
    micro = cfg.train_microbatch
    if micro:
        cfg = cfg.scaled(train_microbatch=max(1, micro
                                              // rules.batch_split()[1]))
    return rules, cfg


def _draw(cfg: ModelConfig, dev: torch.device, seed: int,
          rules: Optional[ShardingRules]):
    """`init_params` from a generator seeded `seed` on `dev`: the whole
    tree, or under executing rules the rank's blocks alone
    (`block_keeper`). Ranks over gloo on a card share the host's cards:
    they draw one at a time, each giving back what its allocator cached
    of the whole leaves before the next draws, so the card holds one
    rank's largest leaf drawn whole at a time."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if rules is None:
        return init_params(cfg, gen)
    comm = rules.comm
    keep = block_keeper(rules.param_specs(), rules.mesh, comm.coords)
    if dev.type != "cuda" or comm.backend != "gloo":
        return init_params(cfg, gen, keep=keep)
    params = None
    for r in range(comm.world):
        if r == comm.rank:
            params = init_params(cfg, gen, keep=keep)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def train(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
          device: DeviceLike = None, ckpt_dir: str = "", log_every: int = 10,
          params=None, mesh: Optional[Mesh] = None,
          on_step: Optional[Callable[[int, dict], None]] = None,
          on_state: Optional[Callable[..., None]] = None,
          comm=None, seed: int = 0,
          grad_compression: bool = False) -> List[float]:
    """The launcher's loop on `mesh` (`make_host_mesh()` by default: the
    ranks of the process group, or this process): `Prefetcher` batches,
    `make_train_step`, AdamW moments in `cfg.opt_state_dtype`, a log line
    every `log_every` steps and at the last (rank 0 prints), an async
    checkpoint every 50 steps (gathered to rank 0 over many ranks).
    `params` (whole leaves) default to `init_params` from a generator
    seeded `seed` on the device, of which a rank over many draws only its
    blocks (`_draw`: each leaf's block kept as it is drawn, bit for bit the
    whole tree's; gloo ranks on a card one at a time); at world size 1 they are updated in
    place, over more ranks each rank takes its blocks of them
    (`shard_tree`) and updates those, on its rows of each global batch.
    `grad_compression` takes `compression.make_compressing_train_step`'s
    step (int8 gradients with an error feedback residual, a rank's blocks
    of it over many ranks). `on_step(step, metrics)`, if given, is called
    after each step is queued, with the metrics still on the device;
    `on_state(params, opt_state)` once before the first step, with the
    state the loop holds (a rank's blocks over many ranks), and the
    residual third where the step compresses (all updated in place).
    `comm`, a `collectives.Comm` over `mesh`, is the caller's
    where it wants the collectives' counts (`comm.stats`); without one the
    loop makes its own and closes it at the end. Returns every step's loss
    (the global batch's), read from the device once at the end: only the
    log lines wait for the card inside the loop."""
    mesh = mesh or make_host_mesh()
    world = world_size()
    if mesh.size != world:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} devices; the "
                         f"process group has {world} "
                         f"rank{'s' if world > 1 else ''}")
    if world > 1 and comm is None:
        # a Comm of this loop's own: what the executed plan does not cover
        # raises before any group is made, and the groups go at the end
        check_executable(ShardingRules(mesh, cfg, ShapeConfig(
            "cli", "train", seq_len, batch)))
        comm = Comm(mesh)
        try:
            return train(cfg, steps=steps, batch=batch, seq_len=seq_len,
                         device=device, ckpt_dir=ckpt_dir,
                         log_every=log_every, params=params, mesh=mesh,
                         on_step=on_step, on_state=on_state, comm=comm,
                         seed=seed, grad_compression=grad_compression)
        finally:
            comm.close()
    dev = resolve_device(device)
    rules = None
    if world > 1:
        rules, cfg = _sharded(cfg, mesh, batch, seq_len, comm)
    model = build_model(cfg, rules)
    specs = None if rules is None else rules.param_specs()
    if params is None:
        params = _draw(cfg, dev, seed, rules)
    elif rules is not None:
        params = shard_tree(params, specs, mesh, rules.comm.coords)
    opt_state = adamw_init(params, cfg.opt_state_dtype)
    opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    residual = ()
    if grad_compression:
        residual = (init_error_feedback(params),)
        compressing = make_compressing_train_step(model, opt_cfg)

        def step_fn(params, opt_state, batch):
            params, opt_state, _, metrics = compressing(
                params, opt_state, residual[0], batch)
            return params, opt_state, metrics
    else:
        step_fn = make_train_step(model, opt_cfg)
    if on_state is not None:
        on_state(params, opt_state, *residual)
    comm = rules.comm if rules is not None else None
    printer = comm is None or comm.rank == 0
    ckpt = Checkpointer(ckpt_dir, comm=comm) if ckpt_dir else None
    ckpt_specs = None if rules is None else {
        "params": specs, "opt": rules.state_specs(opt_state)}
    pf = Prefetcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=batch, input_mode=cfg.input_mode,
                               d_model=cfg.d_model,
                               num_image_tokens=cfg.num_image_tokens))
    losses = []
    try:
        for step in range(steps):
            data = pf.next()
            if rules is not None:
                data = rules.local_batch(data)
            params, opt_state, metrics = step_fn(
                params, opt_state, _to_device(data, dev))
            losses.append(metrics["loss"].detach())
            if on_step is not None:
                on_step(step, metrics)
            if printer and (step % log_every == 0 or step == steps - 1):
                print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            if ckpt and (step + 1) % 50 == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          blocking=False, specs=ckpt_specs)
    finally:
        pf.close()
        if ckpt:
            ckpt.wait()
    return torch.stack(losses).tolist() if losses else []


def _start_group(device: Optional[str]) -> Optional[str]:
    """Under `torch.distributed.run` (WORLD_SIZE above 1), the process
    group: `gloo` with `--device cpu`, else `nccl` with this rank on card
    LOCAL_RANK (more ranks on the host than cards raise). Returns the
    device the rank runs on."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device
    if device == "cpu":
        dist.init_process_group("gloo")
        return device
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if local > torch.cuda.device_count():
        raise RuntimeError(f"{local} ranks on a host with "
                           f"{torch.cuda.device_count()} cards: nccl takes "
                           "one rank a card (--device cpu runs gloo)")
    device = device or f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    torch.cuda.set_device(device)
    dist.init_process_group("nccl")
    return device


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
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 gradients with error feedback")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                         "the host)")
    args = ap.parse_args(argv)

    cfg = launch_config(args.arch, args.smoke)
    started = not dist.is_initialized()
    device = _start_group(args.device)
    started = started and dist.is_initialized()
    try:
        world = world_size()
        if args.mesh == "host":
            mesh = make_host_mesh()
        else:
            mesh = make_production_mesh(multi_pod=args.mesh == "multi")
            if mesh.size != world:
                raise ValueError(
                    f"--mesh {args.mesh} plans {mesh.size} ranks "
                    f"{mesh.shape}; the process group has {world} "
                    f"rank{'s' if world > 1 else ''}. For the plan's "
                    "memory, FLOPs and collectives per device run python "
                    f"-m repro_torch.launch.dryrun --arch {args.arch} "
                    f"--mesh {args.mesh}")
        losses = train(cfg, steps=args.steps, batch=args.batch,
                       seq_len=args.seq_len, device=device,
                       ckpt_dir=args.ckpt_dir, log_every=args.log_every,
                       mesh=mesh, grad_compression=args.grad_compression)
        if world > 1 and dist.get_rank() == 0:
            print(f"losses {json.dumps(losses)}", flush=True)
    finally:
        if started:
            dist.destroy_process_group()
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
