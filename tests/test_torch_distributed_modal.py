"""The port's sharded train step against the JAX package's sharded step on
the CPU for the encoder-decoder and the image inputs: seamless-m4t-medium's
smoke config (an encoder of non-causal attention layers over projected
`frames`, every decoder layer cross-attending to its output, the untied
head) over (2, 2), and through the chunked loss over its untied head:
`CHUNKED_LOSS_VOCAB` set to its padded 512 on both packages' `Model` class
inside this test's processes, at 2048 positions, so that each of two chunks
takes its log-sum-exp over the ranks' `lm_head` columns; internvl2-2b's
smoke config (16 projected image rows before the tokens) over (1, 4), where
the image rows are rank 0's block of the sequence alone, and over (2, 2),
where a rank's block holds image and token rows. fp32, batch 4 x 64 (the
chunked case 2 x 2048), two steps.

Each side runs as `tests/test_torch_distributed_zoo.py` runs it: the
reference's launcher step (`make_rules`, `build_model(cfg, rules)`,
`jax.jit` with the rules' shardings, the `DataConfig` of the config's
inputs) on a `jax.sharding.Mesh` built directly over 4 host devices in one
subprocess, every case in turn, each case's initial params written first;
the port's step as 4 gloo ranks of `launch.train.train` from those params.
All five processes start together under one deadline; any still running at
its end is killed."""
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
STEPS = 2
AXES = ("data", "model")
# the chunked loss's vocabulary threshold in the chunked case: the smoke
# config's padded 512 entries
CHUNKED_VOCAB = 512
# case -> (arch, mesh shape, batch, sequence length (image rows and tokens
# together), chunked)
CASES = {
    "seamless (2, 2)": ("seamless-m4t-medium", (2, 2), 4, 64, False),
    "seamless untied chunked loss (2, 2)": ("seamless-m4t-medium", (2, 2),
                                            2, 2048, True),
    "internvl2 image rows on rank 0 alone (1, 4)": ("internvl2-2b", (1, 4),
                                                    4, 64, False),
    "internvl2 image and token rows on a rank (2, 2)": (
        "internvl2-2b", (2, 2), 4, 64, False),
}
# fp32 on both sides: XLA's and torch's sums over devices and columns
# round in other orders, carried through two AdamW updates
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
TIMEOUT_S = 600


def _dump(path: Path, obj) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(obj))
    os.replace(tmp, path)


def _data(DataConfig, cfg, batch: int, seq: int):
    """The `DataConfig` of the config's inputs, as the launchers make it."""
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, input_mode=cfg.input_mode,
                      d_model=cfg.d_model,
                      num_image_tokens=cfg.num_image_tokens)


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
    for i, (arch, mesh_shape, batch, seq, _) in enumerate(CASES.values()):
        mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape), AXES)
        cfg = get_smoke_config(arch).scaled(param_dtype="float32",
                                            train_microbatch=0)
        rules = make_rules(mesh, cfg, ShapeConfig("test", "train", seq,
                                                  batch))
        model = build_model(cfg, rules)
        params = model.init(jax.random.PRNGKey(i))
        _dump(work / f"init{i}.pkl", jax.tree.map(np.asarray, params))
        built.append((cfg, rules, model, params))
    for i, (cfg, rules, model, params) in enumerate(built):
        _, _, batch, seq, chunked = list(CASES.values())[i]
        Model.CHUNKED_LOSS_VOCAB = CHUNKED_VOCAB if chunked else 131_072
        opt = adamw_init(params, cfg.opt_state_dtype)
        p_sh = rules.param_shardings(jax.eval_shape(lambda: params))
        o_sh = rules.opt_shardings(jax.eval_shape(lambda: opt))
        o_sh["step"] = rules.scalar_sharding()
        params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
        data = _data(DataConfig, cfg, batch, seq)
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
    for i, (arch, mesh_shape, batch, seq, chunked) in \
            enumerate(CASES.values()):
        Model.CHUNKED_LOSS_VOCAB = CHUNKED_VOCAB if chunked else 131_072
        _wait(work / f"init{i}.pkl")
        host = pickle.loads((work / f"init{i}.pkl").read_bytes())
        cfg = launch_config(arch, True)
        mesh = Mesh(mesh_shape, AXES)
        comm = Comm(mesh)
        held, norms, seen = {}, [], []
        real = Model._vocab_parallel_xent

        def vocab_parallel(self, *args, **kw):
            seen.append(True)
            return real(self, *args, **kw)
        Model._vocab_parallel_xent = vocab_parallel
        try:
            losses = train(cfg, steps=STEPS, batch=batch, seq_len=seq,
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
                                                  batch), comm)
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
    work = tmp_path_factory.mktemp("modal_ranks")
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
    n = len(tree_leaves(pickle.loads((runs / f"init{i}.pkl").read_bytes())))
    for part in ("params", "m", "v"):
        pairs = list(zip(tree_leaves(got[part]), tree_leaves(want[part])))
        assert len(pairs) == len(tree_leaves(want[part])) == n
        for g, w in pairs:
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(w).max() > 0, part     # the step updated it
            assert np.abs(g - w).max() <= LEAF_TOL * np.abs(w).max(), part


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax(Path(sys.argv[2]))
    else:
        _port(int(sys.argv[3]), Path(sys.argv[2]))
