"""Trainers: the port of `repro.train.trainer`.

`Trainer` — classic synchronous loop (train step, prefetch, periodic async
checkpoint). Its step updates params and moments in place, and
`restore_or_init` restores into the freshly initialized tensors, so the
state is held once.

`AsyncTrainer` — the paper's architecture applied to training: every
pipeline stage is a *task* in the port's runtime (data-load tasks,
train-step tasks on a gpu-typed node, async checkpoint tasks), composed
through futures, so data loading and checkpointing overlap the step and
the whole loop inherits lineage-replay fault tolerance: kill a node mid-run
and training continues, re-executing lost work (the batch loader is a pure
function of the step index, so replay is exact). Its step works on copies
of the state it is given: a replay after a node loss reads the step's
input state again from the object store, which an update in place would
have changed. That costs a second copy of the state on the device. The
first state comes from a task that draws it from the seed, where the
reference `put`s it from the caller: such a `put` has no lineage and is
reclaimed once the first step has read it, so after a node loss the
reference's replay cannot reach back past it, and its run waits forever.
A replay here draws the first state again.

Straggler mitigation: with `backup_tasks=True` the trainer launches the
step's data-load twice and `wait`s for the first (the paper's wait
primitive, §3.1.5).

Both run on the card unless given `device="cpu"`; the data comes from the
port's `Prefetcher`/`batch_for_step` on the host and is moved to the
device a step at a time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import core as api
from repro_torch.bridge import init_params
from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig, Prefetcher, batch_for_step
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_map

# Seconds `run` waits for a step's metrics or a checkpoint task: a save
# of a state of some 17 GB (mixtral-8x22b cut to one layer) takes minutes.
GET_TIMEOUT_S = 900.0


@dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    opt: AdamWConfig = AdamWConfig()


def _to_device(batch: Dict[str, np.ndarray], device: torch.device):
    """A host batch as tensors on `device`; tokens as int64 indices."""
    return {k: torch.from_numpy(v).to(device, torch.long if k == "tokens"
                                       else None)
            for k, v in batch.items()}


def init_state(model: Model, opt: AdamWConfig, seed: int,
               device: torch.device):
    """Params from `init_params` with a generator seeded `seed` on
    `device`, and zero AdamW moments in `opt.state_dtype`."""
    params = init_params(model.cfg,
                         torch.Generator(device=device).manual_seed(seed))
    return params, adamw_init(params, opt.state_dtype)


class Trainer:
    def __init__(self, model: Model, data_cfg: DataConfig,
                 cfg: TrainerConfig, device: DeviceLike = None):
        self.model = model
        self.data_cfg = data_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model, cfg.opt)
        self.ckpt = (Checkpointer(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)

    def init_state(self, seed: int = 0):
        return init_state(self.model, self.cfg.opt, seed, self.device)

    def restore_or_init(self, seed: int = 0):
        params, opt_state = self.init_state(seed)
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            start = self.ckpt.latest_step()
            self.ckpt.restore_into({"params": params, "opt": opt_state},
                                   start)
        return params, opt_state, start

    def run(self, seed: int = 0) -> Dict[str, Any]:
        """Train from the latest checkpoint (or from `seed`) to
        `cfg.steps`. Returns the logged (step, loss) pairs, the state, the
        wall time and each step's ms on the host clock (a step that logs
        its loss waits for the device; the others are enqueue time)."""
        params, opt_state, start = self.restore_or_init(seed)
        pf = Prefetcher(self.data_cfg, start_step=start)
        losses, step_ms = [], []
        t0 = time.perf_counter()
        try:
            for step in range(start, self.cfg.steps):
                t_step = time.perf_counter()
                batch = _to_device(pf.next(), self.device)
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                if step % self.cfg.log_every == 0 or \
                        step == self.cfg.steps - 1:
                    loss = float(metrics["loss"])
                    losses.append((step, loss))
                step_ms.append((time.perf_counter() - t_step) * 1e3)
                if self.ckpt and (step + 1) % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step + 1,
                                   {"params": params, "opt": opt_state},
                                   blocking=False)
        finally:
            pf.close()
            if self.ckpt:
                self.ckpt.wait()
        return {"losses": losses, "params": params, "opt": opt_state,
                "wall_s": time.perf_counter() - t0, "step_ms": step_ms}


class AsyncTrainer:
    """Training driven through the port's dataflow runtime. Needs a running
    cluster (`repro_torch.core.init`) with a node that has a "gpu"
    resource."""

    def __init__(self, model: Model, data_cfg: DataConfig, cfg: TrainerConfig,
                 backup_tasks: bool = False, device: DeviceLike = None):
        self.model = model
        self.data_cfg = data_cfg
        self.cfg = cfg
        self.backup_tasks = backup_tasks
        self.device = dev = resolve_device(device)
        step_fn = make_train_step(model, cfg.opt)
        data_cfg_ref = data_cfg

        @api.remote(resources={"gpu": 1.0})
        def init_state_task(seed: int):
            return init_state(model, cfg.opt, seed, dev)

        @api.remote
        def load_batch(step: int):
            return batch_for_step(data_cfg_ref, step)

        @api.remote(resources={"gpu": 1.0})
        def train_step_task(state, batch):
            # copies: the input state stays as it was for a replay
            params, opt_state = tree_map(torch.clone, state)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 _to_device(batch, dev))
            return (params, opt_state), {k: float(v)
                                         for k, v in metrics.items()}

        @api.remote
        def save_ckpt(step, state, directory):
            Checkpointer(directory).save(step, {"params": state[0],
                                                "opt": state[1]})
            return step

        self._init_state = init_state_task
        self._load_batch = load_batch
        self._train_step = train_step_task
        self._save = save_ckpt

    def run(self, seed: int = 0, start_step: int = 0) -> Dict[str, Any]:
        state_ref = self._init_state.submit(seed)
        ckpt_refs = []
        metrics_ref = None
        losses = []

        # pipeline: batch t+1 loads while step t runs (futures as deps)
        batch_refs = {start_step: self._submit_load(start_step)}
        for step in range(start_step, self.cfg.steps):
            if step + 1 < self.cfg.steps:
                batch_refs[step + 1] = self._submit_load(step + 1)
            out = self._train_step.options(num_returns=2).submit(
                state_ref, batch_refs.pop(step))
            state_ref, metrics_ref = out
            if self.cfg.checkpoint_dir and \
                    (step + 1) % self.cfg.checkpoint_every == 0:
                ckpt_refs.append(self._save.submit(
                    step + 1, state_ref, self.cfg.checkpoint_dir))
            if step % self.cfg.log_every == 0:
                losses.append((step, api.get(metrics_ref,
                                             timeout=GET_TIMEOUT_S)["loss"]))
        final_metrics = (api.get(metrics_ref, timeout=GET_TIMEOUT_S)
                         if metrics_ref else {})
        if ckpt_refs:
            # ensure checkpoints are durable
            api.get(ckpt_refs, timeout=GET_TIMEOUT_S)
        losses.append((self.cfg.steps - 1, final_metrics.get("loss")))
        return {"losses": losses, "state_ref": state_ref}

    def _submit_load(self, step: int):
        if not self.backup_tasks:
            return self._load_batch.submit(step)
        # straggler mitigation: duplicate the load, take the first done
        a = self._load_batch.submit(step)
        b = self._load_batch.submit(step)
        done, _ = api.wait([a, b], num_returns=1)
        return done[0]
