"""Dry run: every (arch x shape x mesh) cell of the port traced on `meta`.
The port of `repro.launch.dryrun`.

The reference lowers and compiles each cell's jitted step for its 16x16
(single-pod) or 2x16x16 (multi-pod) TPU mesh and reads XLA's memory and
cost analyses. The port has no compiler to ask: it runs the same step
eagerly on meta tensors (shapes and dtypes, no data, no device) under the
cell's sharding rules (`parallel.sharding.make_rules`) and counts what the
step does (`analysis.trace`). Nothing is allocated, on the host or on a
card, and nothing of `torch.distributed` starts.

What a record holds, per device of the plan:
  * arg / out / alias bytes: exact, each leaf's shard under its spec
    (`parallel.sharding.shard_shape`): params, AdamW state and the batch
    of a train step (params and state donated: aliased); params and the
    batch of a prefill, its logits and cache out; params, the cache and
    the token of a decode step (the cache donated).
  * temp bytes: the trace's peak of live temporaries, run at the
    per-device batch (the global batch over the batch axes the rules
    shard it over; the config's microbatch likewise). At world size 1 it
    is the port's own peak. Over a plan it is an estimate: the peak, over
    the trace, of the live tensors shaped like a parameter leaf
    (gradients, their accumulators) over the params' shard factor plus
    every other live temporary over the devices that split a batch shard
    (the model axis, and for batch-1 decode every axis). It is an upper
    bound where XLA would fuse or free earlier than eager mode, and under
    where an op of the batch shard is replicated over the model axis.
  * hlo_flops / hlo_dot_flops / hlo_bytes: the trace's counts at the
    per-device batch over the same divisor (exact at world size 1; over a
    plan the model axis is taken to split every op of a batch shard
    evenly). `trace_flops` keeps the undivided count.
  * collectives: the plan's, by `analysis.trace` (FSDP gathers at each
    use, the residual stream's partial sums, the vocab-parallel logits'
    all-to-all, gathered KV heads, a Mamba mixer's gathers and sums over
    `model`, each of these again for the gradient in the backward, a MoE
    layer's aux sums, the gradients' reduce-scatter and all-reduce, the
    loss's and the norm's sums), with the ring model's bytes. A train step
    that `launch.train` executes over a process group (`executes`: the
    configs `sharding.check_executable` passes, every train cell but
    phi3's, whose 40 heads the model axis of 16 cuts) is traced as rank 0
    runs it instead, on its blocks and rows, with its own collectives
    (`collectives.PlanComm`; `collectives_from` says which): its FLOPs, bytes and peak are then a
    device's own (`divisor` 1). `collective_bytes_dcn` the groups over
    the `pod` axis alone (as the reference counts DCN),
    `collective_bytes_off_node` the groups that leave an 8-card NVLink node
    (an HGX H100 board; the 16-wide model axis spans two).
  * kernel_calls: each kernel's calls in the step (a device makes as many
    as its batch shard), with its `cost` totals over the same divisor.
  * fits_80gb: arg + out + temp - alias under the H100's 80 GB.

A cell that fails is recorded with its error, as the reference does.
Results go to build/dryrun_results_torch/ as one JSON a cell; a cell
already there and ok is skipped unless --force. No card is needed:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-medium-14b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.analysis.trace import Trace
from repro_torch.bridge import param_shapes
from repro_torch.configs.base import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, all_cells, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.collectives import PlanComm
from repro_torch.parallel.sharding import (_axis_size, bytes_per_device,
                                           check_executable, make_rules,
                                           shard_bytes, shard_tree)
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_leaves

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_results_torch"


def _shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def _meta_batch(specs: Dict[str, torch.Tensor], b: int) -> Dict:
    """The input stand-ins at batch `b`."""
    return {k: torch.empty((b, *v.shape[1:]), dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def n_params(cfg: ModelConfig) -> int:
    """The config's parameters, from the meta tree."""
    return sum(t.numel() for t in tree_leaves(param_shapes(cfg)))


def executes(rules) -> bool:
    """Whether the rules' step is one that `launch.train` executes over a
    process group (a train step over more than one device of a config
    `sharding.check_executable` passes)."""
    if rules.shape.kind != "train" or rules.mesh.size == 1:
        return False
    try:
        check_executable(rules)
    except (NotImplementedError, ValueError):
        return False
    return True


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Traces one cell's step on `meta` at the per-device batch under the
    rules of `mesh`; returns the record's figures (no timing, no error
    handling). A step the rules execute (`executes`) is traced as rank 0
    runs it, on its blocks and rows, its collectives those of a `PlanComm`;
    any other, the whole batch shard under the plan's model of its
    collectives."""
    rules = make_rules(mesh, cfg, shape)
    model = build_model(cfg, rules)
    specs = model.input_specs(shape)
    in_specs = rules.input_shardings(specs)
    b = shape.global_batch
    split = _axis_size(mesh, in_specs["tokens"][0])
    b_dev = b // split
    # the devices a batch shard's work is split over
    divisor = mesh.size // split
    params = param_shapes(cfg)
    p_specs = rules.param_shardings(params)
    param_bytes = _tree_bytes(params)
    param_dev = bytes_per_device(params, p_specs, mesh)
    per_device = (divisor, param_bytes / param_dev)
    in_dev = sum(shard_bytes(v, in_specs[k], mesh) for k, v in specs.items())
    batch = _meta_batch(specs, b_dev)
    executed = executes(rules)
    rec = {"batch_per_device": b_dev,
           "collectives_from": "executed step" if executed else "plan"}
    if shape.kind == "train":
        micro = cfg.train_microbatch
        micro_dev = max(1, micro // split) if micro else 0
        opt = adamw_init(params, cfg.opt_state_dtype)
        o_specs = rules.opt_shardings(opt)
        state_dev = param_dev + bytes_per_device(opt, o_specs, mesh)
        n_micro = b_dev // micro_dev if micro_dev and micro_dev < b_dev \
            else 1
        if executed:        # rank 0's step: its work is its own
            comm = PlanComm(mesh)
            rules = make_rules(mesh, cfg, shape, comm)
            local = shard_tree(params, p_specs, mesh, comm.coords)
            local_opt = adamw_init(local, cfg.opt_state_dtype)
            step = make_train_step(build_model(cfg.scaled(
                train_microbatch=micro_dev), rules), AdamWConfig(
                    state_dtype=cfg.opt_state_dtype))
            divisor = 1
            with Trace(rules, args=(local, local_opt, batch)) as tr:
                out = step(local, local_opt, batch)
            comm.close()
        else:
            model = build_model(cfg.scaled(train_microbatch=micro_dev), rules)
            step = make_train_step(model, AdamWConfig(
                state_dtype=cfg.opt_state_dtype))
            with Trace(rules, params=params, args=(params, opt, batch),
                       per_device=per_device) as tr:
                out = step(params, opt, batch)
            tr.gradient_sync(params, times=n_micro)
        arg_dev, alias_dev = state_dev + in_dev, state_dev
        out_dev = state_dev + _tree_bytes(out[2])
        rec.update(microbatches=n_micro, state_bytes_per_dev=state_dev,
                   state_bytes=_tree_bytes(params) + _tree_bytes(opt))
    elif shape.kind == "prefill":
        with torch.no_grad(), Trace(rules, params=params,
                                    args=(params, batch),
                                    per_device=per_device) as tr:
            logits, cache = model.prefill(params, batch, max_seq=shape.seq_len)
        full = model.init_cache(b, shape.seq_len, device="meta")
        arg_dev, alias_dev = param_dev + in_dev, 0
        out_dev = (bytes_per_device(full, rules.cache_shardings(full), mesh)
                   + _tree_bytes(logits))
    else:
        cache = model.init_cache(b_dev, shape.seq_len, device="meta")
        full = model.init_cache(b, shape.seq_len, device="meta")
        c_specs = rules.cache_shardings(full)
        cache_dev = bytes_per_device(full, c_specs, mesh)
        with torch.no_grad(), Trace(rules, params=params,
                                    args=(params, cache, batch),
                                    per_device=per_device) as tr:
            logits, cache = model.decode_step(params, cache, batch["tokens"],
                                              shape.seq_len - 1)
        arg_dev = param_dev + cache_dev + in_dev + 4      # + the int32 pos
        alias_dev = cache_dev
        out_dev = cache_dev + _tree_bytes(logits)
    res = tr.res
    rec["divisor"] = divisor
    temp_dev = res.peak_bytes_per_device
    n_pods = mesh.shape.get("pod", 1)
    rec.update(
        n_params=sum(t.numel() for t in tree_leaves(params)),
        hlo_flops=res.flops / divisor, hlo_dot_flops=res.dot_flops / divisor,
        hlo_bytes=res.hbm_bytes / divisor, trace_flops=res.flops,
        trace_ops=res.ops,
        collective_bytes_total=res.collective_bytes(),
        collective_bytes_dcn=(res.axes_bytes(lambda c: c.axes == ("pod",))
                              if n_pods > 1 else 0.0),
        collective_bytes_off_node=res.axes_bytes(lambda c: c.off_node),
        collective_by_kind=res.by_kind(),
        collective_off_node_by_kind={
            k: sum(c.transfer_bytes * c.count for c in res.collectives
                   if c.off_node and c.op == k)
            for k in res.by_kind()},
        unknown_trip_loops=res.unknown_trip_loops,
        kernel_calls={k: {"calls": v.calls, "flops": v.flops / divisor,
                          "bytes": v.bytes / divisor,
                          "exps": v.exps / divisor}
                      for k, v in res.kernels.items()},
        arg_bytes_per_dev=int(arg_dev), out_bytes_per_dev=int(out_dev),
        temp_bytes_per_dev=int(temp_dev), alias_bytes_per_dev=int(alias_dev),
        temp_bytes_batch_shard=int(res.peak_bytes),
    )
    tot = arg_dev + out_dev + temp_dev - alias_dev
    rec["hbm_per_dev_gb"] = round(tot / 2**30, 3)
    rec["fits_80gb"] = bool(tot < mesh_lib.HBM_BYTES)
    return rec


def run_cell(arch: str, shape: ShapeConfig, mesh_kind: str, *,
             opt_overrides: Optional[dict] = None,
             tag: str = "baseline") -> dict:
    """One cell's record on the "single" or "multi" production plan."""
    mesh = mesh_lib.make_production_mesh(multi_pod=mesh_kind == "multi")
    t0 = time.time()
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
           "devices": mesh.size, "tag": tag, "ok": False}
    try:
        cfg = get_config(arch)
        if opt_overrides:
            cfg = cfg.scaled(**opt_overrides)
        rec.update(trace_cell(cfg, shape, mesh))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record failures, they are bugs
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    return rec


def save(rec: dict, results_dir: Optional[Path] = None) -> Path:
    results_dir = results_dir or RESULTS_DIR
    results_dir.mkdir(parents=True, exist_ok=True)
    path = results_dir / (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__"
                          f"{rec['tag']}.json")
    path.write_text(json.dumps(rec, indent=1, default=str))
    return path


def table(tag: str = "baseline") -> str:
    """A markdown table of the saved records of `tag`: a row an arch, a
    column a shape, each cell "GB a card / TFLOP a card / collective GB a
    card", single-pod and multi-pod plans joined by "|" (fits: "*" marks a
    cell over 80 GB; a failed cell shows its error)."""
    def num(x):
        return f"{x:,.0f}" if x >= 1000 else f"{x:.3g}"

    def one(r):
        if not r.get("ok"):
            return r.get("error", "missing")[:40]
        return (f"{num(r['hbm_per_dev_gb'])}"
                f"{'' if r['fits_80gb'] else '*'} / "
                f"{num(r['hlo_flops'] / 1e12)} / "
                f"{num(r['collective_bytes_total'] / 1e9)}")

    rows = ["| arch | " + " | ".join(s.name for s in ALL_SHAPES) + " |",
            "| --- |" + " --- |" * len(ALL_SHAPES)]
    for arch in ARCH_IDS:
        cells = []
        for shape in ALL_SHAPES:
            recs = [RESULTS_DIR / f"{arch}__{shape.name}__{mk}__{tag}.json"
                    for mk in ("single", "multi")]
            cells.append(" \\| ".join(one(json.loads(p.read_text()))
                                      for p in recs if p.exists()) or "-")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the saved records of --tag as a table")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.tag))
        return 0
    if not args.all and not args.arch:
        ap.error("--arch or --all")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(all_cells())
    else:
        cfg = get_config(args.arch)
        from repro_torch.configs.base import shapes_for
        shs = ([_shape_by_name(args.shape)] if args.shape
               else list(shapes_for(cfg)))
        cells = [(args.arch, s) for s in shs]

    n_ok = n_fail = 0
    for arch, sh in cells:
        for mk in meshes:
            out = RESULTS_DIR / f"{arch}__{sh.name}__{mk}__{args.tag}.json"
            if out.exists() and not args.force:
                prev = json.loads(out.read_text())
                if prev.get("ok"):
                    print(f"[skip] {arch} {sh.name} {mk} (cached ok)")
                    n_ok += 1
                    continue
            rec = run_cell(arch, sh, mk, tag=args.tag)
            save(rec)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
            print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {arch} {sh.name} {mk} "
                  f"{rec.get('hbm_per_dev_gb', '?')}GB/dev "
                  f"{rec['total_s']}s {rec.get('error', '')}", flush=True)
    print(f"dry-run: {n_ok} ok, {n_fail} failed; "
          f"cuda initialized: {torch.cuda.is_initialized()}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
