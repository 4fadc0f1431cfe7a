"""The port's sharded train step against the JAX package's sharded step on
the CPU for the MoE and hybrid decoders: mixtral-8x22b's smoke config with
the `dropping` dispatch under expert parallelism, with 3 experts and the
`dense` dispatch (the expert-internal TP fallback: 3 experts over model 2)
and with a shared expert; jamba-1.5-large-398b's smoke config (Mamba over
the model axis, the residual stream without sequence parallelism, MoE
`dropping` under expert parallelism). fp32, batch 4 x 64 (mixtral's window
of 16 masks), two steps.

Each side runs as `tests/test_torch_distributed_jax.py` runs it: the
reference's launcher step (`make_rules`, `build_model(cfg, rules)`,
`jax.jit` with the rules' shardings) on a `jax.sharding.Mesh` built
directly over 4 host devices in one subprocess, every case in turn, each
case's initial params written first; the port's step as 4 gloo ranks of
`launch.train.train` from those params. The aux losses of the first step's
forward are the reference's `loss_fn` at the initial params on the first
batch. All five processes start together; each has a timeout and is
killed at its end."""
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
# case -> (arch, mesh shape, MoE config overrides, the spec string of the
# first MoE layer's w_gate on the reference's side)
CASES = {
    "mixtral dropping, expert parallel (2, 2)": (
        "mixtral-8x22b", (2, 2), {"dispatch": "dropping"},
        "PartitionSpec(None, 'model', 'data', None)"),
    "mixtral 3 experts dense, expert-internal TP (2, 2)": (
        "mixtral-8x22b", (2, 2), {"num_experts": 3, "dispatch": "dense"},
        "PartitionSpec(None, None, 'data', 'model')"),
    "mixtral shared expert (1, 4)": (
        "mixtral-8x22b", (1, 4), {"num_shared_experts": 1},
        "PartitionSpec(None, 'model', 'data', None)"),
    "jamba dropping, no sequence parallel (2, 2)": (
        "jamba-1.5-large-398b", (2, 2), {"dispatch": "dropping"},
        "PartitionSpec(None, 'model', 'data', None)"),
}
# fp32 on both sides: XLA's and torch's sums over devices and columns
# round in other orders, carried through two AdamW updates
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
TIMEOUT_S = 400


def _dump(path: Path, obj) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(obj))
    os.replace(tmp, path)


def _moe_layer(cfg) -> int:
    return cfg.ffn_pattern.index("moe")


def _jax(work: Path) -> None:
    """The reference's sharded step of every case: all initial params
    first (the port's ranks start from them), then each case's losses,
    gradient norms, load-balance losses, the first forward's aux losses,
    final params and AdamW moments."""
    import jax
    from jax.sharding import Mesh

    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.data.pipeline import DataConfig, batch_for_step
    from repro.models import build_model
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel.sharding import make_rules
    from repro.train.train_step import make_train_step

    built = []
    for i, (arch, mesh_shape, over, _) in enumerate(CASES.values()):
        mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape), AXES)
        cfg = get_smoke_config(arch)
        cfg = cfg.scaled(param_dtype="float32", train_microbatch=0,
                         moe=dataclasses.replace(cfg.moe, **over))
        rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                                  BATCH))
        model = build_model(cfg, rules)
        params = model.init(jax.random.PRNGKey(i))
        _dump(work / f"init{i}.pkl", jax.tree.map(np.asarray, params))
        built.append((cfg, rules, model, params))
    for i, (cfg, rules, model, params) in enumerate(built):
        opt = adamw_init(params, cfg.opt_state_dtype)
        p_sh = rules.param_shardings(jax.eval_shape(lambda: params))
        o_sh = rules.opt_shardings(jax.eval_shape(lambda: opt))
        o_sh["step"] = rules.scalar_sharding()
        params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                          global_batch=BATCH)
        _, aux = jax.jit(model.loss_fn, in_shardings=(p_sh, None))(
            params, batch_for_step(data, 0))
        step = jax.jit(make_train_step(model, AdamWConfig(
            state_dtype=cfg.opt_state_dtype)),
            in_shardings=(p_sh, o_sh, None), out_shardings=(p_sh, o_sh, None))
        losses, norms, lbs = [], [], []
        for s in range(STEPS):
            params, opt, metrics = step(params, opt, batch_for_step(data, s))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            lbs.append(float(metrics["moe_lb_loss"]))
        w_gate = params["groups"][_moe_layer(cfg)]["ffn"]["w_gate"]
        _dump(work / f"jax{i}.pkl", {
            "losses": losses, "norms": norms, "lb": lbs,
            "aux0": {k: float(aux[k]) for k in ("moe_lb_loss",
                                                "moe_z_loss")},
            "params": jax.tree.map(np.asarray, params),
            "m": jax.tree.map(np.asarray, opt["m"]),
            "v": jax.tree.map(np.asarray, opt["v"]),
            "w_gate": str(w_gate.sharding.spec)})


def _wait(path: Path) -> None:
    deadline = time.monotonic() + TIMEOUT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"the JAX step wrote no {path.name}")
        time.sleep(0.1)


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
    for i, (arch, mesh_shape, over, _) in enumerate(CASES.values()):
        _wait(work / f"init{i}.pkl")
        host = pickle.loads((work / f"init{i}.pkl").read_bytes())
        cfg = launch_config(arch, True)
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, **over))
        mesh = Mesh(mesh_shape, AXES)
        comm = Comm(mesh)
        held, metrics = {}, []
        losses = train(cfg, steps=STEPS, batch=BATCH, seq_len=SEQ_LEN,
                       device="cpu", params=params_from_numpy(host, "cpu"),
                       mesh=mesh, comm=comm, log_every=STEPS,
                       on_step=lambda s, m: metrics.append(
                           {k: float(m[k]) for k in (
                               "grad_norm", "moe_lb_loss", "moe_z_loss")}),
                       on_state=lambda p, o: held.update(params=p, opt=o))
        rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                                  BATCH), comm)
        specs = rules.param_specs()
        full = {k: params_to_numpy(gather_tree(t, specs, comm)) for k, t in
                (("params", held["params"]), ("m", held["opt"]["m"]),
                 ("v", held["opt"]["v"]))}
        if rank == 0:
            _dump(work / f"port{i}.pkl", {
                "losses": losses,
                "norms": [m["grad_norm"] for m in metrics],
                "lb": [m["moe_lb_loss"] for m in metrics],
                "aux0": {k: metrics[0][k] for k in ("moe_lb_loss",
                                                    "moe_z_loss")},
                **full})
        comm.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case, from one launch of five processes."""
    work = tmp_path_factory.mktemp("moe_ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    cmds = [[sys.executable, __file__, "jax", str(work)]] + [
        [sys.executable, __file__, "port", str(work), str(r)]
        for r in range(4)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, log in zip(cmds, procs, logs):
        assert p.returncode == 0, f"{c[2:]} rc {p.returncode}:\n{log}"
    return work


@pytest.mark.parametrize("case", list(CASES))
def test_port_sharded_moe_step_equals_the_jax_sharded_step(runs, case):
    from repro_torch.tree import tree_leaves
    i = list(CASES).index(case)
    want = pickle.loads((runs / f"jax{i}.pkl").read_bytes())
    got = pickle.loads((runs / f"port{i}.pkl").read_bytes())
    # the reference's step really ran the case's layout, and its clip bit
    assert want["w_gate"] == CASES[case][3]
    assert min(want["norms"]) > 1.0
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["lb"], want["lb"], rtol=LOSS_RTOL)
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert want["aux0"][k] > 0
        np.testing.assert_allclose(got["aux0"][k], want["aux0"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    for part in ("params", "m", "v"):
        pairs = list(zip(tree_leaves(got[part]), tree_leaves(want[part])))
        assert len(pairs) == len(tree_leaves(want[part]))
        for g, w in pairs:
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(w).max() > 0, part     # the step updated it
            assert np.abs(g - w).max() <= LEAF_TOL * np.abs(w).max(), part


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax(Path(sys.argv[2]))
    else:
        _port(int(sys.argv[3]), Path(sys.argv[2]))
