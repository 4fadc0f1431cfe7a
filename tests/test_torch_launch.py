"""The port's train launcher (`repro_torch.launch.train`) on the CPU: two
steps of every arch at `--smoke` against the JAX package's train step with
the launcher's settings, and the host mesh.

The reference launcher itself cannot be run here: under this jax its
sharding rules fail on the host mesh (a `with_sharding_constraint` on a
non-Auto axis; a `ShardingTypeError` in the embedding gather). So the
port is held against the step that launcher compiles, without the rules:
`build_model(cfg)`, `make_train_step(model, AdamWConfig(state_dtype=
cfg.opt_state_dtype))`, params from `PRNGKey(0)`, `adamw_init` and the
pipeline's batches for steps 0 and 1, as its `Prefetcher` yields them."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel processes on one host, where torch's default
# of a thread per core in each of them oversubscribes it
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import batch_for_step  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402

STEPS, BATCH, SEQ_LEN = 2, 2, 32
# The JAX and the port's losses, fp32: one step summed in other orders by
# XLA and torch, carried through one AdamW update (3e-7 seen).
LOSS_RTOL = 1e-5


def _jax_run(arch):
    """(the JAX step's losses, its initial params as numpy)."""
    cfg = jreg.get_smoke_config(arch).scaled(param_dtype="float32",
                                             train_microbatch=0)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    opt_state = jax_adamw_init(params, cfg.opt_state_dtype)
    step = jax.jit(jax_train_step(
        model, JaxAdamWConfig(state_dtype=cfg.opt_state_dtype)))
    data = JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                         global_batch=BATCH, input_mode=cfg.input_mode,
                         d_model=cfg.d_model,
                         num_image_tokens=cfg.num_image_tokens)
    losses = []
    for s in range(STEPS):
        params, opt_state, metrics = step(params, opt_state,
                                          batch_for_step(data, s))
        losses.append(float(metrics["loss"]))
    return losses, host


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_steps_equal_the_jax_step(arch, capsys):
    want, host = _jax_run(arch)
    cfg = launch_train.launch_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreg.get_smoke_config(arch).scaled(param_dtype="float32",
                                           train_microbatch=0))
    seen = []
    got = launch_train.train(cfg, steps=STEPS, batch=BATCH, seq_len=SEQ_LEN,
                             device="cpu", params=params_from_numpy(host, "cpu"),
                             log_every=1, on_step=lambda s, m: seen.append(
                                 (s, m["loss"])))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # each step's metrics reach `on_step` as tensors, before any host read
    assert [s for s, _ in seen] == list(range(STEPS))
    assert all(isinstance(x, torch.Tensor) for _, x in seen)
    assert [float(x) for _, x in seen] == got
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:4] for ln in lines] == [
        ["step", str(s), "loss", f"{got[s]:.4f}"] for s in range(STEPS)]


def test_main_takes_the_reference_flags(tmp_path, capsys):
    """The reference's flags plus `--device`; a checkpoint every 50 steps,
    written before `main` returns."""
    argv = ["--arch", "stablelm-1.6b", "--smoke", "--steps", "50",
            "--batch", "2", "--seq-len", "16", "--log-every", "25",
            "--mesh", "host", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    assert launch_train.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "25", "49"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_50"]


def test_train_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "xlstm-125m", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("which", ["single", "multi"])
def test_mesh_over_many_devices_raises(which):
    """A production plan runs only over a process group of its size: at
    world size 1 the launcher names the plan's ranks against the world's,
    and the dry run that traces the plan without devices."""
    ranks = {"single": 256, "multi": 512}[which]
    with pytest.raises(ValueError, match=f"plans {ranks} ranks.*has 1 rank\\."
                       ".*repro_torch.launch.dryrun"):
        launch_train.main(["--arch", "xlstm-125m", "--smoke", "--mesh",
                           which, "--device", "cpu"])


def test_host_mesh_is_world_size_one():
    """Without a process group the host mesh is this one process; a model
    axis or a mesh of more devices than the world raises."""
    m = mesh.make_host_mesh()
    assert (m.size, m.shape, m.axis_names) == (
        1, {"data": 1, "model": 1}, ("data", "model"))
    with pytest.raises(ValueError, match="model axis of 2 does not divide "
                       "a world of 1 rank"):
        mesh.make_host_mesh(model=2)
    # the production meshes are plans (the dry run's), not devices
    plan = mesh.make_production_mesh(multi_pod=True)
    assert (plan.size, plan.shape) == (
        512, {"pod": 2, "data": 16, "model": 16})
    # the loop runs on the ranks of its process group: here one
    with pytest.raises(ValueError, match="2 devices; the process group has "
                       "1 rank"):
        launch_train.train(launch_train.launch_config("xlstm-125m", True),
                           steps=1, batch=2, seq_len=8, device="cpu",
                           mesh=mesh.Mesh((2, 1), ("data", "model")))
    # the H100 SXM's rates, not v5e's
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_FP32, mesh.HBM_BW) == (
        989e12, 67e12, 3.35e12)
