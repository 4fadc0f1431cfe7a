"""The port's sharded train step against the JAX package's sharded step on
the CPU for MLA, the xLSTM cells and the tied, chunked vocabulary head:
deepseek-v2's smoke config (MLA's latents column-parallel and gathered
whole, its heads over `model`; its MoE, shared expert and dense first layer
as `tests/test_torch_distributed_moe.py`'s cases run them) over (2, 2) and
(1, 4); xlstm-125m's smoke config (an sLSTM and an mLSTM cell on a rank's
heads, the residual stream without sequence parallelism, the tied head)
over (2, 2), with 4 heads over (1, 4), and with 2 heads a cell over (1, 4)
(each head cut over 2 ranks, which both compute it); gemma3-12b's smoke
config (sliding-window and global GQA, the tied table as the
whole-vocabulary head) over (2, 2), and through the chunked loss:
`CHUNKED_LOSS_VOCAB` set to 512 on both packages' `Model` class inside this
test's processes, at 2048 positions, so that its 512 entries split over
`model` and each of two chunks takes its log-sum-exp over the ranks. fp32,
batch 4 x 64 (the chunked case 4 x 2048), two steps.

Each side runs as `tests/test_torch_distributed_moe.py` runs it: the
reference's launcher step (`make_rules`, `build_model(cfg, rules)`,
`jax.jit` with the rules' shardings) on a `jax.sharding.Mesh` built
directly over 4 host devices in one subprocess, every case in turn, each
case's initial params written first; the port's step as 4 gloo ranks of
`launch.train.train` from those params. All five processes start
together under one deadline; any still running at its end is killed."""
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
STEPS, BATCH = 2, 4
AXES = ("data", "model")
# the chunked loss's vocabulary threshold in the chunked case: the smoke
# config's padded 512 entries
CHUNKED_VOCAB = 512
# case -> (arch, mesh shape, config overrides (an "xlstm" entry overrides
# fields of the xLSTM config), sequence length, chunked)
CASES = {
    "deepseek MLA (2, 2)": ("deepseek-v2-236b", (2, 2), {}, 64, False),
    "deepseek MLA (1, 4)": ("deepseek-v2-236b", (1, 4), {}, 64, False),
    "xlstm (2, 2)": ("xlstm-125m", (2, 2), {}, 64, False),
    "xlstm 4 heads (1, 4)": ("xlstm-125m", (1, 4),
                             {"num_heads": 4, "num_kv_heads": 4}, 64, False),
    "xlstm heads cut over model (1, 4)": (
        "xlstm-125m", (1, 4), {"xlstm": {"num_heads_slstm": 2}}, 64, False),
    "gemma3 whole vocabulary (2, 2)": ("gemma3-12b", (2, 2), {}, 64, False),
    "gemma3 chunked loss (2, 2)": ("gemma3-12b", (2, 2), {}, 2048, True),
}
# fp32 on both sides: XLA's and torch's sums over devices and columns
# round in other orders, carried through two AdamW updates
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
TIMEOUT_S = 800
# A leaf whose every entry starts at 0 (a conv bias) is after two steps
# AdamW's updates alone, lr x m / sqrt(v) an entry: an entry's error is
# m's error over the entry's own scale, so an entry whose m is far below
# the leaf's largest shows m's error magnified by that ratio. In xlstm's
# (1, 4) case one entry of the mLSTM conv bias has |m| 2.5e-4 of the
# leaf's largest (its two gradients nearly cancel); m is 2.5e-6 of the
# leaf's largest apart there, within LEAF_TOL like every entry of m, and
# the entry 3.0e-3 of the leaf's largest. Such a leaf's entries are held
# at LEAF_TOL where JAX's |m| is at least ZERO_START_M_SHARE of the leaf's
# largest (m's error magnified at most 100 times; the worst of them reads
# 2.9e-5); the others are held through m and v, as every leaf is.
ZERO_START_M_SHARE = 1e-2


def _dump(path: Path, obj) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(obj))
    os.replace(tmp, path)


def _jax(work: Path) -> None:
    """The reference's sharded step of every case: all initial params
    first (the port's ranks start from them), then each case's losses,
    gradient norms, final params and AdamW moments, and whether its loss
    took the chunked path."""
    import jax
    from jax.sharding import Mesh

    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.data.pipeline import DataConfig, batch_for_step
    from repro.models import build_model
    from repro.models.model import Model, padded_vocab
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel.sharding import make_rules
    from repro.train.train_step import make_train_step

    built = []
    for i, (arch, mesh_shape, over, seq, _) in enumerate(CASES.values()):
        mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape), AXES)
        cfg = _scaled(get_smoke_config(arch), param_dtype="float32",
                      train_microbatch=0, **over)
        rules = make_rules(mesh, cfg, ShapeConfig("test", "train", seq,
                                                  BATCH))
        model = build_model(cfg, rules)
        params = model.init(jax.random.PRNGKey(i))
        _dump(work / f"init{i}.pkl", jax.tree.map(np.asarray, params))
        built.append((cfg, rules, model, params))
    for i, (cfg, rules, model, params) in enumerate(built):
        seq, chunked = list(CASES.values())[i][3:]
        Model.CHUNKED_LOSS_VOCAB = CHUNKED_VOCAB if chunked else 131_072
        opt = adamw_init(params, cfg.opt_state_dtype)
        p_sh = rules.param_shardings(jax.eval_shape(lambda: params))
        o_sh = rules.opt_shardings(jax.eval_shape(lambda: opt))
        o_sh["step"] = rules.scalar_sharding()
        params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=BATCH)
        step = jax.jit(make_train_step(model, AdamWConfig(
            state_dtype=cfg.opt_state_dtype)),
            in_shardings=(p_sh, o_sh, None), out_shardings=(p_sh, o_sh, None))
        losses, norms = [], []
        for s in range(STEPS):
            params, opt, metrics = step(params, opt, batch_for_step(data, s))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        _dump(work / f"jax{i}.pkl", {
            "losses": losses, "norms": norms,
            "chunked": padded_vocab(cfg) >= Model.CHUNKED_LOSS_VOCAB
            and seq > 1024,
            "params": jax.tree.map(np.asarray, params),
            "m": jax.tree.map(np.asarray, opt["m"]),
            "v": jax.tree.map(np.asarray, opt["v"])})


def _scaled(cfg, **over):
    """`cfg.scaled(**over)`, an "xlstm" entry's fields replaced in the
    config's xLSTM config (either package's)."""
    import dataclasses
    if "xlstm" in over:
        over["xlstm"] = dataclasses.replace(cfg.xlstm, **over["xlstm"])
    return cfg.scaled(**over)


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
    from repro_torch.models.model import Model
    from repro_torch.parallel.collectives import Comm
    from repro_torch.parallel.sharding import gather_tree, make_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv",
                            rank=rank, world_size=4,
                            timeout=timedelta(seconds=TIMEOUT_S))
    for i, (arch, mesh_shape, over, seq, chunked) in \
            enumerate(CASES.values()):
        Model.CHUNKED_LOSS_VOCAB = CHUNKED_VOCAB if chunked else 131_072
        _wait(work / f"init{i}.pkl")
        host = pickle.loads((work / f"init{i}.pkl").read_bytes())
        cfg = _scaled(launch_config(arch, True), **over)
        mesh = Mesh(mesh_shape, AXES)
        comm = Comm(mesh)
        held, norms, seen = {}, [], []
        real = Model._vocab_parallel_xent

        def vocab_parallel(self, *args, **kw):
            seen.append(True)
            return real(self, *args, **kw)
        Model._vocab_parallel_xent = vocab_parallel
        try:
            losses = train(cfg, steps=STEPS, batch=BATCH, seq_len=seq,
                           device="cpu",
                           params=params_from_numpy(host, "cpu"),
                           mesh=mesh, comm=comm, log_every=STEPS,
                           on_step=lambda s, m: norms.append(
                               float(m["grad_norm"])),
                           on_state=lambda p, o: held.update(params=p,
                                                             opt=o))
        finally:
            Model._vocab_parallel_xent = real
        rules = make_rules(mesh, cfg, ShapeConfig("test", "train", seq,
                                                  BATCH), comm)
        specs = rules.param_specs()
        full = {k: params_to_numpy(gather_tree(t, specs, comm)) for k, t in
                (("params", held["params"]), ("m", held["opt"]["m"]),
                 ("v", held["opt"]["v"]))}
        if rank == 0:
            _dump(work / f"port{i}.pkl", {
                "losses": losses, "norms": norms, "chunked": bool(seen),
                **full})
        comm.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case, from one launch of five processes."""
    work = tmp_path_factory.mktemp("zoo_ranks")
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


@pytest.mark.parametrize("case", list(CASES))
def test_port_sharded_step_equals_the_jax_sharded_step(runs, case):
    from repro_torch.tree import tree_leaves
    i = list(CASES).index(case)
    want = pickle.loads((runs / f"jax{i}.pkl").read_bytes())
    got = pickle.loads((runs / f"port{i}.pkl").read_bytes())
    # both took the case's loss path, and the reference's clip bit
    assert got["chunked"] == want["chunked"] == CASES[case][4]
    assert min(want["norms"]) > 1.0
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL)
    init = tree_leaves(pickle.loads((runs / f"init{i}.pkl").read_bytes()))
    for part in ("params", "m", "v"):
        pairs = list(zip(tree_leaves(got[part]), tree_leaves(want[part]),
                         init, tree_leaves(want["m"])))
        assert len(pairs) == len(tree_leaves(want[part])) == len(init)
        for g, w, w0, m in pairs:
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(w).max() > 0, part     # the step updated it
            held = np.ones(w.shape, bool)
            if part == "params" and not np.abs(w0).max():
                # the updates alone: where m is near 0, held by m and v
                held = np.abs(m) >= ZERO_START_M_SHARE * np.abs(m).max()
            assert np.abs(g - w)[held].max() <= LEAF_TOL * np.abs(w).max(), \
                part


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax(Path(sys.argv[2]))
    else:
        _port(int(sys.argv[3]), Path(sys.argv[2]))
