"""The port's sharded train step against the JAX package's sharded step on
the CPU for what the executed plan runs beyond the shipped layouts:
phi3-medium-14b's smoke config with 10 query heads of 32 over 2 KV heads
on (1, 4), so that `model` cuts through heads (80 columns, 2.5 query heads
and half a KV head a rank: the production plan's 40 over 16 in small);
stablelm-1.6b's smoke config on (2, 2) through the int8 compressing step
(`make_compressing_train_step`, its error feedback residual held too) and
through `make_train_step` with a compressing hook; jamba's smoke config
with `sequence_parallel=True` on (2, 2) (Mamba under sequence
parallelism); mixtral's smoke config with the `ragged` dispatch on (1, 4)
(expert parallel) and with 3 experts on (2, 2) (the expert-internal TP
fallback); attention logit softcapping (`attn_logit_softcap` 2.0) on
stablelm's smoke config over (4, 1) and seamless's (its encoder's and
decoder's self-attention; cross-attention takes none, as in the reference)
over (2, 2). fp32, batch 4 x 64, two steps.

Each side runs as `tests/test_torch_distributed_modal.py` runs it: the
reference's step under its rules (`make_rules`, `build_model(cfg, rules)`,
`jax.jit` with the rules' shardings) on a `jax.sharding.Mesh` built
directly over 4 host devices in one subprocess, every case in turn, each
case's initial params written first; the port's step as 4 gloo ranks from
those params: `launch.train.train`, or for the hook a loop of
`make_train_step` on the rank's blocks and rows. All five processes start
together under one deadline; any still running at its end is killed.

Under int8 compression a gradient entry within its rounding error of the
half-way point between two int8 levels takes either, and XLA's sums and
torch's round in other orders: such an entry's residual moves by a whole
quantization step and its AdamW moments by a step's share. A leaf may
hold LEVEL_CHANGES of its entries past the tolerance there."""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ_LEN = 2, 4, 64
AXES = ("data", "model")
# case -> (arch, mesh shape, config overrides ("moe": fields of the MoE
# config), the step: "train" (`make_train_step`), "compressing"
# (`make_compressing_train_step`) or "hook" (`make_train_step` with
# `compress_grads` as its hook, a zero residual each step))
CASES = {
    "phi3 query heads cut over model (1, 4)": (
        "phi3-medium-14b", (1, 4),
        {"num_heads": 10, "num_kv_heads": 2, "head_dim": 32}, "train"),
    "stablelm compressing step (2, 2)": ("stablelm-1.6b", (2, 2), {},
                                         "compressing"),
    "stablelm train step with a compressing hook (2, 2)": (
        "stablelm-1.6b", (2, 2), {}, "hook"),
    "jamba under sequence parallel (2, 2)": (
        "jamba-1.5-large-398b", (2, 2), {"sequence_parallel": True},
        "train"),
    "mixtral ragged, expert parallel (1, 4)": (
        "mixtral-8x22b", (1, 4), {"moe": {"dispatch": "ragged"}}, "train"),
    "mixtral ragged 3 experts, expert-internal TP (2, 2)": (
        "mixtral-8x22b", (2, 2),
        {"moe": {"dispatch": "ragged", "num_experts": 3}}, "train"),
    "stablelm softcap (4, 1)": ("stablelm-1.6b", (4, 1),
                                {"attn_logit_softcap": 2.0}, "train"),
    "seamless softcap (2, 2)": ("seamless-m4t-medium", (2, 2),
                                {"attn_logit_softcap": 2.0}, "train"),
}
# fp32 on both sides: XLA's and torch's sums over devices and columns
# round in other orders, carried through two AdamW updates
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
# the residual, a share of its largest entry (half a quantization step,
# 1/254 of the leaf's largest gradient: LEAF_TOL of that gradient is 2.5%
# of it), and the share of a leaf's entries a level change may move past
# a tolerance (module docstring)
RESIDUAL_TOL = 5e-2
LEVEL_CHANGES = 1e-3
TIMEOUT_S = 600


def _dump(path: Path, obj) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(obj))
    os.replace(tmp, path)


def _scaled(cfg, over):
    """`cfg` with `over`; its "moe" entry overrides fields of the MoE
    config."""
    over = dict(over)
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return cfg.scaled(**over)


def _jax(work: Path) -> None:
    """The reference's sharded step of every case: all initial params
    first (the port's ranks start from them), then each case's losses,
    gradient norms, final params, AdamW moments and residual."""
    import jax
    from jax.sharding import Mesh

    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.data.pipeline import DataConfig, batch_for_step
    from repro.models import build_model
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel import compression
    from repro.parallel.sharding import make_rules
    from repro.train.train_step import make_train_step

    built = []
    for i, (arch, mesh_shape, over, _) in enumerate(CASES.values()):
        mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape), AXES)
        cfg = _scaled(get_smoke_config(arch).scaled(
            param_dtype="float32", train_microbatch=0), over)
        rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                                  BATCH))
        model = build_model(cfg, rules)
        params = model.init(jax.random.PRNGKey(i))
        _dump(work / f"init{i}.pkl", jax.tree.map(np.asarray, params))
        built.append((cfg, rules, model, params))
    for i, (cfg, rules, model, params) in enumerate(built):
        how = list(CASES.values())[i][3]
        opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        opt = adamw_init(params, cfg.opt_state_dtype)
        p_sh = rules.param_shardings(jax.eval_shape(lambda: params))
        o_sh = rules.opt_shardings(jax.eval_shape(lambda: opt))
        o_sh["step"] = rules.scalar_sharding()
        params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
        efb = jax.device_put(compression.init_error_feedback(params), p_sh)
        if how == "compressing":
            fn = jax.jit(compression.make_compressing_train_step(
                model, opt_cfg), in_shardings=(p_sh, o_sh, p_sh, None),
                out_shardings=(p_sh, o_sh, p_sh, None))
            step = fn
        else:
            hook = None
            if how == "hook":
                def hook(g, zero=efb):
                    return compression.compress_grads(g, zero)[0]
            fn = jax.jit(make_train_step(model, opt_cfg,
                                         grad_compression=hook),
                         in_shardings=(p_sh, o_sh, None),
                         out_shardings=(p_sh, o_sh, None))

            def step(p, o, e, b):
                p, o, m = fn(p, o, b)
                return p, o, e, m
        # the config's inputs (seamless's frames), as the launchers make them
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                          global_batch=BATCH, input_mode=cfg.input_mode,
                          d_model=cfg.d_model,
                          num_image_tokens=cfg.num_image_tokens)
        losses, norms = [], []
        for s in range(STEPS):
            params, opt, efb, metrics = step(params, opt, efb,
                                             batch_for_step(data, s))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        _dump(work / f"jax{i}.pkl", {
            "losses": losses, "norms": norms,
            "params": jax.tree.map(np.asarray, params),
            "m": jax.tree.map(np.asarray, opt["m"]),
            "v": jax.tree.map(np.asarray, opt["v"]),
            "residual": jax.tree.map(np.asarray, efb)})


def _wait(path: Path) -> None:
    deadline = time.monotonic() + TIMEOUT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"the JAX step wrote no {path.name}")
        time.sleep(0.1)


def _hook_loop(cfg, mesh, comm, params, norms):
    """The launcher's loop with `make_train_step` and a hook that
    compresses the rank's synced blocks (`compress_grads(..., rules=)`)
    against a zero residual each step, as the reference's hook takes one:
    (losses, params, AdamW state)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.compression import (compress_grads,
                                                  init_error_feedback)
    from repro_torch.parallel.sharding import make_rules, shard_tree
    from repro_torch.train.train_step import make_train_step
    rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                              BATCH), comm)
    params = shard_tree(params, rules.param_specs(), mesh, comm.coords)
    opt = adamw_init(params, cfg.opt_state_dtype)
    zero = init_error_feedback(params)
    step = make_train_step(
        build_model(cfg, rules), AdamWConfig(state_dtype=cfg.opt_state_dtype),
        grad_compression=lambda g: compress_grads(g, zero, rules=rules)[0])
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                      global_batch=BATCH)
    losses = []
    for s in range(STEPS):
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 rules.local_batch(batch_for_step(data, s)).items()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, params, opt


def _port(rank: int, work: Path) -> None:
    """One rank of the port's step of every case, from the JAX step's
    initial params."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import launch_config, train
    from repro_torch.parallel.collectives import Comm
    from repro_torch.parallel.sharding import gather_tree, make_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv",
                            rank=rank, world_size=4,
                            timeout=timedelta(seconds=TIMEOUT_S))
    for i, (arch, mesh_shape, over, how) in enumerate(CASES.values()):
        _wait(work / f"init{i}.pkl")
        host = pickle.loads((work / f"init{i}.pkl").read_bytes())
        cfg = _scaled(launch_config(arch, True), over)
        mesh = Mesh(mesh_shape, AXES)
        comm = Comm(mesh)
        params = params_from_numpy(host, "cpu")
        held, norms = {}, []
        if how == "hook":
            losses, held["params"], held["opt"] = _hook_loop(
                cfg, mesh, comm, params, norms)
        else:
            def on_state(p, o, *residual):
                held.update(params=p, opt=o, residual=residual)
            losses = train(cfg, steps=STEPS, batch=BATCH, seq_len=SEQ_LEN,
                           device="cpu", params=params, mesh=mesh,
                           comm=comm, log_every=STEPS,
                           on_step=lambda s, m: norms.append(
                               float(m["grad_norm"])),
                           on_state=on_state,
                           grad_compression=how == "compressing")
        rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                                  BATCH), comm)
        specs = rules.param_specs()
        parts = [("params", held["params"]), ("m", held["opt"]["m"]),
                 ("v", held["opt"]["v"])]
        parts += [("residual", e) for e in held.get("residual", ())]
        full = {k: params_to_numpy(gather_tree(t, specs, comm))
                for k, t in parts}
        if rank == 0:
            _dump(work / f"port{i}.pkl", {"losses": losses, "norms": norms,
                                          **full})
        comm.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case, from one launch of five processes."""
    work = tmp_path_factory.mktemp("override_ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    cmds = [[sys.executable, __file__, "jax", str(work)]] + [
        [sys.executable, __file__, "port", str(work), str(r)]
        for r in range(4)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, deadline = [], time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, log in zip(cmds, procs, logs):
        assert p.returncode == 0, f"{c[2:]} rc {p.returncode}:\n{log}"
    return work


def _close(got, want, tol, changed, what):
    """Every entry within `tol` of the leaf's largest, but for at most a
    `changed` share of the leaf's entries. A residual of a leaf under the
    compressing step's threshold stays 0 on both sides."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = np.abs(want).max()
    if what == "residual" and scale == 0:
        assert not got.any(), what
        return
    assert scale > 0, what                  # the step updated it
    off = np.abs(got - want) > tol * scale
    assert off.sum() <= changed * off.size, (what, int(off.sum()))


@pytest.mark.parametrize("case", list(CASES))
def test_port_sharded_step_equals_the_jax_sharded_step(runs, case):
    from repro_torch.tree import tree_leaves
    i = list(CASES).index(case)
    how = CASES[case][3]
    want = pickle.loads((runs / f"jax{i}.pkl").read_bytes())
    got = pickle.loads((runs / f"port{i}.pkl").read_bytes())
    assert min(want["norms"]) > 1.0          # the reference's clip bit
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL)
    n = len(tree_leaves(pickle.loads((runs / f"init{i}.pkl").read_bytes())))
    changed = 0.0 if how == "train" else LEVEL_CHANGES
    parts = [("params", LEAF_TOL, 0.0), ("m", LEAF_TOL, changed),
             ("v", LEAF_TOL, changed)]
    if how == "compressing":
        parts.append(("residual", RESIDUAL_TOL, changed))
    else:
        assert "residual" not in got
    for part, tol, share in parts:
        pairs = list(zip(tree_leaves(got[part]), tree_leaves(want[part])))
        assert len(pairs) == len(tree_leaves(want[part])) == n
        for g, w in pairs:
            _close(g, w, tol, share, part)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax(Path(sys.argv[2]))
    else:
        _port(int(sys.argv[3]), Path(sys.argv[2]))
