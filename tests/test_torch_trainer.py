"""The port's Checkpointer and trainers on the CPU: checkpoints that cross
between the two packages in both directions (bf16 leaves included), the
`Trainer` resumed from a checkpoint the JAX package wrote against the JAX
`Trainer`, and the `AsyncTrainer` on a cluster of the port's runtime,
through a node kill."""
import json
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.trainer import (AsyncTrainer, Trainer,  # noqa: E402
                                       TrainerConfig, init_state)
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "mixtral-8x22b"
# The JAX and the port's losses over 3 AdamW steps, fp32: one algorithm
# summed in other orders by XLA and torch, carried through the updates.
LOSS_RTOL = 1e-4


def _tree(seed=0):
    """bf16, fp32 and int32 leaves, nested in dicts and a tuple."""
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "a": (torch.randn(5, generator=g), torch.zeros(()))}}


def _jax_tree(seed=0):
    """The same kinds of leaves, made by JAX."""
    k = jax.random.PRNGKey(seed)
    return {"w": jax.random.normal(k, (4, 3)).astype(jnp.bfloat16),
            "b": {"c": jnp.arange(6, dtype=jnp.int32),
                  "a": (jax.random.normal(k, (5,)), jnp.zeros(()))}}


def _bits(x):
    """A leaf's values as numpy, bf16 (and the `|V2` it loads as) by its
    uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _same(got, want):
    """Leaf by leaf in the reference's order (dict keys sorted), which
    `jax.tree.leaves` gives for tensors (leaves to JAX) too."""
    assert len(jax.tree.leaves(got)) == len(jax.tree.leaves(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ------------------------------------------------------------ Checkpointer

def test_checkpoint_roundtrip_and_layout(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(10, t)
    manifest = json.loads((tmp_path / "step_10" / "manifest.json").read_text())
    assert manifest == {"step": 10, "leaves": {
        "b/a/0": {"shape": [5], "dtype": "float32"},
        "b/a/1": {"shape": [], "dtype": "float32"},
        "b/c": {"shape": [6], "dtype": "int32"},
        "w": {"shape": [4, 3], "dtype": "bfloat16"}}}
    out = ck.restore(t)
    for a, b in zip(tree_leaves(out), tree_leaves(t)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert ck.latest_step() == 10
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_checkpoint_async_gc_and_snapshot_at_save(tmp_path):
    """Async saves keep the newest `keep`; the snapshot is taken in `save`,
    so an update in place right after it does not reach the file."""
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    want = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t, blocking=False)
        t["b"]["a"][0].add_(1.0)       # the trainer's in-place step
        ck.wait()
    assert ck.steps() == [3, 4]
    want["b"]["a"][0].add_(3.0)
    got = ck.restore(t, step=4)
    assert torch.equal(got["b"]["a"][0], want["b"]["a"][0])
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_restore_to_a_device_and_into_tensors(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree())
    meta = ck.restore(_tree(1), device="meta")
    assert all(x.device.type == "meta" for x in tree_leaves(meta))
    dst = _tree(1)
    ids = [id(x) for x in tree_leaves(dst)]
    ck.restore_into(dst)
    assert [id(x) for x in tree_leaves(dst)] == ids
    for a, b in zip(tree_leaves(dst), tree_leaves(_tree())):
        assert torch.equal(a, b)


def test_restore_checks_shape_and_dtype(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    bad = _tree()
    bad["w"] = torch.zeros(3, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w: saved shape"):
        ck.restore(bad)
    bad["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="w: saved torch.bfloat16"):
        ck.restore_into(bad)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(_tree())


def test_members_read_as_np_load_reads_them(tmp_path):
    """The restore reads each member from its offset in the file; it gives
    what `np.load` gives, for a transposed leaf (saved C-ordered), bf16 and
    a scalar. A compressed member raises."""
    from repro_torch.checkpoint.checkpointer import _Arrays
    t = dict(_tree(), t=torch.randn(3, 5).t())
    Checkpointer(str(tmp_path)).save(1, t)
    path = tmp_path / "step_1" / "arrays.npz"
    with _Arrays(path) as got, np.load(path) as want:
        for key in want.files:
            a, b = got[key], want[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key
    assert torch.equal(Checkpointer(str(tmp_path)).restore(t)["t"], t["t"])
    np.savez_compressed(tmp_path / "z.npz", x=np.arange(12.0))
    with _Arrays(tmp_path / "z.npz") as got, \
            pytest.raises(ValueError, match="compressed"):
        got["x"]


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint of bf16, fp32 and int32 leaves written by the JAX
    package: the port restores every leaf in its dtype, bit for bit (the
    reference itself cannot restore its bf16 leaves: `|V2` arrays)."""
    jt = _jax_tree()
    JaxCheckpointer(str(tmp_path)).save(7, jt)
    got = Checkpointer(str(tmp_path)).restore(_tree())
    assert got["w"].dtype == torch.bfloat16
    assert got["b"]["c"].dtype == torch.int32
    _same(got, jt)


def test_port_checkpoint_restores_into_jax_byte_for_byte(tmp_path):
    """The port's files are the ones JAX writes for the same values: the
    same manifest text and the same bytes in every .npy member; JAX's
    Checkpointer restores them (bf16 as `|V2`, read with ml_dtypes)."""
    jt = _jax_tree()
    tt = {"w": torch.from_numpy(np.array(jt["w"]).view(np.int16)
                                ).view(torch.bfloat16),
          "b": {"c": torch.from_numpy(np.array(jt["b"]["c"])),
                "a": tuple(torch.from_numpy(np.array(x))
                           for x in jt["b"]["a"])}}
    JaxCheckpointer(str(tmp_path / "jax")).save(5, jt)
    Checkpointer(str(tmp_path / "port")).save(5, tt)
    j, p = tmp_path / "jax" / "step_5", tmp_path / "port" / "step_5"
    assert (p / "manifest.json").read_text() == \
        (j / "manifest.json").read_text()
    with zipfile.ZipFile(j / "arrays.npz") as zj, \
            zipfile.ZipFile(p / "arrays.npz") as zp:
        assert zp.namelist() == zj.namelist()
        for name in zj.namelist():
            assert zp.read(name) == zj.read(name), name
    back = JaxCheckpointer(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: jt))
    assert np.asarray(back["w"]).dtype.str == "|V2"
    np.testing.assert_array_equal(
        np.asarray(back["w"]).view(ml_dtypes.bfloat16), np.asarray(jt["w"]))
    _same(tt, back)


# ------------------------------------------------------------------ Trainer

def _cfgs():
    """mixtral smoke, fp32: SWA (window 16) and MoE (dense dispatch)."""
    return (jreg.get_smoke_config(ARCH).scaled(param_dtype="float32"),
            registry.get_smoke_config(ARCH).scaled(param_dtype="float32"))


def _data(cls):
    return cls(vocab_size=256, seq_len=32, global_batch=2)


def test_trainer_resumed_from_a_jax_checkpoint_gives_jax_losses(tmp_path):
    """JAX writes step 0 (params and AdamW state); each package's Trainer
    resumes from its own copy of it and takes 3 steps; the losses agree.
    The port then saved step 2 in the same layout, which JAX restores."""
    jcfg, tcfg = _cfgs()
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    JaxCheckpointer(str(tmp_path / "jax")).save(
        0, {"params": params, "opt": jax_adamw_init(params)})
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw = dict(steps=3, checkpoint_every=2, log_every=1)
    want = JaxTrainer(jm, _data(JaxDataConfig), JaxTrainerConfig(
        checkpoint_dir=str(tmp_path / "jax"), **kw)).run(seed=1)
    got = Trainer(build_model(tcfg), _data(DataConfig), TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **kw), device="cpu").run(seed=1)
    assert [s for s, _ in got["losses"]] == [0, 1, 2]
    np.testing.assert_allclose([l for _, l in got["losses"]],
                               [l for _, l in want["losses"]], rtol=LOSS_RTOL)
    assert Checkpointer(str(tmp_path / "port")).steps() == [0, 2]
    j2 = JaxCheckpointer(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: {"params": params,
                                "opt": jax_adamw_init(params)}), step=2)
    assert int(j2["opt"]["step"]) == 2


def test_trainer_resume_reproduces_the_uninterrupted_losses(tmp_path):
    """4 steps with a checkpoint at step 2; a fresh Trainer resumes from it
    (into its own freshly initialized tensors) and repeats steps 2 and 3."""
    _, tcfg = _cfgs()
    model, data = build_model(tcfg), _data(DataConfig)
    full = Trainer(model, data, TrainerConfig(
        steps=4, checkpoint_every=2, log_every=1,
        checkpoint_dir=str(tmp_path / "a")), device="cpu").run()
    ck = Checkpointer(str(tmp_path / "a"))
    assert ck.steps() == [2, 4]
    shutil.rmtree(tmp_path / "a" / "step_4")
    resumed = Trainer(model, data, TrainerConfig(
        steps=4, checkpoint_every=100, log_every=1,
        checkpoint_dir=str(tmp_path / "a")), device="cpu").run(seed=5)
    assert resumed["losses"] == full["losses"][2:]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(full["params"])):
        assert torch.equal(a, b)


def test_trainer_runs_on_the_card_by_default():
    _, tcfg = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(build_model(tcfg), _data(DataConfig), TrainerConfig())


# ------------------------------------------------------------- AsyncTrainer

@pytest.fixture
def cluster():
    cl = core.init(node_resources=[{"cpu": 2}, {"cpu": 2, "gpu": 1},
                                   {"cpu": 2, "gpu": 1}])
    yield cl
    core.shutdown()


def test_async_trainer_gives_trainer_losses(cluster, tmp_path):
    """5 steps with backup loads (each batch loaded twice, the first one
    taken) and a checkpoint task at step 4: the losses are the Trainer's,
    and the checkpoint holds the Trainer's state at step 4."""
    _, tcfg = _cfgs()
    model, data = build_model(tcfg), _data(DataConfig)
    want = Trainer(model, data, TrainerConfig(steps=5, log_every=1,
                                              checkpoint_every=4,
                                              checkpoint_dir=str(tmp_path / "s")),
                   device="cpu").run()
    trainer = AsyncTrainer(model, data, TrainerConfig(
        steps=5, log_every=1, checkpoint_every=4,
        checkpoint_dir=str(tmp_path / "a")), backup_tasks=True,
        device="cpu")
    load, loads = trainer._load_batch, []

    class Counted:
        def submit(self, step):
            loads.append(step)
            return load.submit(step)

    trainer._load_batch = Counted()
    got = trainer.run()
    assert got["losses"] == want["losses"] + want["losses"][-1:]
    assert loads == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
    a = Checkpointer(str(tmp_path / "a")).restore(
        {"params": want["params"], "opt": want["opt"]})
    s = Checkpointer(str(tmp_path / "s")).restore(
        {"params": want["params"], "opt": want["opt"]})
    for x, y in zip(tree_leaves(a), tree_leaves(s)):
        assert torch.equal(x, y)


def test_async_trainer_survives_a_node_kill_out_of_place(cluster):
    """The node that ran the first 3 steps (and holds their states and the
    first state) is killed; lineage replay redraws the first state, re-runs
    the lost steps elsewhere, and the run ends with the Trainer's losses.
    Every state the run made is kept and read back at the end: the first
    is still the state drawn from the seed, and no step changed the state
    it was given (each one's moments differ from the next's)."""
    _, tcfg = _cfgs()
    model, data = build_model(tcfg), _data(DataConfig)
    cfg = TrainerConfig(steps=5, log_every=1)
    want = Trainer(model, data, cfg, device="cpu").run(seed=3)
    trainer = AsyncTrainer(model, data, cfg, device="cpu")
    step_fn, states, killed = trainer._train_step, [], []

    class KillAfterThree:
        def options(self, **kw):
            rf = step_fn.options(**kw)

            class Submit:
                def submit(self, state_ref, batch_ref):
                    out = rf.submit(state_ref, batch_ref)
                    states.append(state_ref)
                    if len(states) == 3:
                        core.get(out[1])
                        node = min(cluster.gcs.locations(out[0].id))
                        assert node in (1, 2)
                        cluster.kill_node(node)
                        killed.append(node)
                    return out
            return Submit()

    trainer._train_step = KillAfterThree()
    got = trainer.run(seed=3)
    assert killed and got["losses"][:-1] == want["losses"]
    assert any(e[1] == "reconstruct" for e in cluster.gcs.events())
    states.append(got["state_ref"])
    read = [core.get(r, timeout=60) for r in states]
    first = init_state(model, cfg.opt, 3, torch.device("cpu"))
    for a, b in zip(tree_leaves(read[0]), tree_leaves(first)):
        assert torch.equal(a, b)
    for prev, nxt in zip(read, read[1:]):
        assert not torch.equal(prev[1]["m"]["embed"]["table"],
                               nxt[1]["m"]["embed"]["table"])
        assert int(nxt[1]["step"]) == int(prev[1]["step"]) + 1
    for a, b in zip(tree_leaves(read[-1]), tree_leaves((want["params"],
                                                        want["opt"]))):
        assert torch.equal(a, b)
