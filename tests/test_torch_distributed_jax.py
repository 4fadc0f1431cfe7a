"""The port's sharded train step against the JAX package's sharded step on
the CPU: stablelm-1.6b's smoke config in fp32, batch 4 x 32, two steps, on
a (2, 2) ("data", "model") mesh on both sides.

The JAX side is the reference launcher's step: `make_rules`,
`build_model(cfg, rules)`, params and AdamW state placed by the rules'
shardings and `jax.jit(make_train_step(...), in_shardings=...,
out_shardings=...)`, on a `jax.sharding.Mesh` built directly over 4 host
devices (its axes are `Auto`, which the reference's sharding constraints
need; `jax.make_mesh`'s are not). It runs in a subprocess, since the host
device count is fixed when JAX starts. The port's side is 4 gloo ranks
(`launch.train.train` on `Mesh((2, 2))`) from the JAX step's initial
params. All five processes start together; each has a timeout and is
killed at its end.

Over two steps from step 0 the warm-up keeps the learning rate near 0, so
the params barely move and alone would check only the forward; the AdamW
moments `m` and `v` (the clipped gradients' running means) and each step's
gradient norm are what hold the backward, the gradients' sync over ranks
and the clip to the reference's."""
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
ARCH, STEPS, BATCH, SEQ_LEN = "stablelm-1.6b", 2, 4, 32
MESH, AXES = (2, 2), ("data", "model")
# fp32 on both sides: XLA's and torch's sums over devices and columns
# round in other orders, carried through two AdamW updates
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
TIMEOUT_S = 180


def _dump(path: Path, obj) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(obj))
    os.replace(tmp, path)


def _jax(work: Path) -> None:
    """The reference's sharded step; its initial params first (the port's
    ranks start from them), then its losses, gradient norms, final params
    and AdamW moments."""
    import jax
    from jax.sharding import Mesh

    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.data.pipeline import DataConfig, batch_for_step
    from repro.models import build_model
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel.sharding import make_rules
    from repro.train.train_step import make_train_step

    mesh = Mesh(np.array(jax.devices()).reshape(MESH), AXES)
    cfg = get_smoke_config(ARCH).scaled(param_dtype="float32",
                                        train_microbatch=0)
    rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                              BATCH))
    model = build_model(cfg, rules)
    params = model.init(jax.random.PRNGKey(0))
    _dump(work / "init.pkl", jax.tree.map(np.asarray, params))
    opt = adamw_init(params, cfg.opt_state_dtype)
    p_sh = rules.param_shardings(jax.eval_shape(lambda: params))
    o_sh = rules.opt_shardings(jax.eval_shape(lambda: opt))
    o_sh["step"] = rules.scalar_sharding()
    params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
    step = jax.jit(make_train_step(model, AdamWConfig(
        state_dtype=cfg.opt_state_dtype)), in_shardings=(p_sh, o_sh, None),
        out_shardings=(p_sh, o_sh, None))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                      global_batch=BATCH)
    losses, norms = [], []
    for s in range(STEPS):
        params, opt, metrics = step(params, opt, batch_for_step(data, s))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    _dump(work / "jax.pkl", {
        "losses": losses, "norms": norms,
        "params": jax.tree.map(np.asarray, params),
        "m": jax.tree.map(np.asarray, opt["m"]),
        "v": jax.tree.map(np.asarray, opt["v"]),
        "w_q": str(params["groups"][0]["mixer"]["w_q"].sharding.spec)})


def _port(rank: int, work: Path) -> None:
    """One rank of the port's step from the JAX step's initial params."""
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
    deadline = time.monotonic() + TIMEOUT_S
    while not (work / "init.pkl").exists():
        if time.monotonic() > deadline:
            raise TimeoutError("the JAX step wrote no initial params")
        time.sleep(0.1)
    host = pickle.loads((work / "init.pkl").read_bytes())
    cfg = launch_config(ARCH, True)
    mesh = Mesh(MESH, AXES)
    comm = Comm(mesh)
    held, norms = {}, []
    losses = train(cfg, steps=STEPS, batch=BATCH, seq_len=SEQ_LEN,
                   device="cpu", params=params_from_numpy(host, "cpu"),
                   mesh=mesh, comm=comm, log_every=STEPS,
                   on_step=lambda s, m: norms.append(float(m["grad_norm"])),
                   on_state=lambda p, o: held.update(params=p, opt=o))
    rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                              BATCH), comm)
    specs = rules.param_specs()
    full = {k: params_to_numpy(gather_tree(t, specs, comm)) for k, t in
            (("params", held["params"]), ("m", held["opt"]["m"]),
             ("v", held["opt"]["v"]))}
    if rank == 0:
        _dump(work / "port.pkl", {"losses": losses, "norms": norms, **full})
    comm.close()
    dist.destroy_process_group()


def test_port_sharded_step_equals_the_jax_sharded_step(tmp_path):
    from repro_torch.tree import tree_leaves
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    cmds = [[sys.executable, __file__, "jax", str(tmp_path)]] + [
        [sys.executable, __file__, "port", str(tmp_path), str(r)]
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
    want = pickle.loads((tmp_path / "jax.pkl").read_bytes())
    got = pickle.loads((tmp_path / "port.pkl").read_bytes())
    # the reference's step really ran sharded, and its clip bit
    assert want["w_q"] == "PartitionSpec(None, 'data', 'model')"
    assert min(want["norms"]) > 1.0
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL)
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
