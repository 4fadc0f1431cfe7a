"""The paper's RL workload on the port (`repro_torch.examples.rl_pipeline`,
`repro_torch.examples.rl_workload`) against the reference's
(`examples/rl_pipeline.py`, `benchmarks/rl_workload.py`): the torch policy
started from the JAX policy's weights follows JAX's updates to 1e-5, the
rollouts are equal, the example trains on the CPU in both loop modes and
through a node kill, the §4.2 runs return the reference's keys, and both
`simulate`s ship to a worker process."""
import importlib.util
import multiprocessing
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro_torch import core  # noqa: E402
from repro_torch.examples import rl_pipeline, rl_workload  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# max |port - jax| <= RTOL max |jax| for each weight (and action), fp32 on
# the CPU: the two sum the same products in other orders
RTOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


def _load(relpath: str, name: str):
    """A reference script as a module (it is not a package module)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


@pytest.fixture(scope="module")
def ref_pipeline():
    return _load("examples/rl_pipeline.py", "ref_rl_pipeline")


@pytest.fixture(scope="module")
def ref_workload():
    return _load("benchmarks/rl_workload.py", "ref_rl_workload")


def _rollout_batches(n, size=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((size, 8)).astype(np.float32),
             np.tanh(rng.standard_normal((size, 2))).astype(np.float32),
             rng.standard_normal(size).astype(np.float32))
            for _ in range(n)]


def test_policy_follows_jax_from_carried_weights(ref_pipeline):
    """The JAX policy's init, carried into the port: after 5 updates on
    the same batches the weights and actions agree to 1e-5, relative."""
    import jax.numpy as jnp
    w_jax, act_jax, update_jax = ref_pipeline.make_policy()
    w_port = rl_pipeline.policy_from_numpy(
        jax.tree.map(np.asarray, w_jax), "cpu")
    _, act_port, update_port = rl_pipeline.make_policy("cpu")
    for obs, acts, rews in _rollout_batches(5):
        w_jax = update_jax(w_jax, jnp.asarray(obs), jnp.asarray(acts),
                           jnp.asarray(rews))
        w_port = update_port(w_port, torch.from_numpy(obs),
                             torch.from_numpy(acts), torch.from_numpy(rews))
    for k in ("w1", "w2"):
        got, want = w_port[k].numpy(), np.asarray(w_jax[k])
        assert got.dtype == np.float32 and got.shape == want.shape
        _close(got, want)
        assert not np.array_equal(want, np.asarray(
            ref_pipeline.make_policy()[0][k]))     # the updates moved it
    obs = _rollout_batches(1, size=16, seed=1)[0][0]
    _close(act_port(w_port, torch.from_numpy(obs)).numpy(),
           np.asarray(act_jax(w_jax, jnp.asarray(obs))))


def test_policy_init_is_seeded_and_on_its_device():
    a, _, _ = rl_pipeline.make_policy("cpu")
    b, _, _ = rl_pipeline.make_policy("cpu")
    for k, shape in (("w1", (8, 32)), ("w2", (32, 2))):
        assert a[k].shape == shape and a[k].dtype == torch.float32
        assert a[k].device.type == "cpu"
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_learner_checkpoint_round_trip_in_numpy():
    """`__getstate__` holds numpy only; `__setstate__` rebuilds the same
    weights on the recorded device, and the learner goes on updating."""
    cls = rl_pipeline.PolicyLearner._cls
    ln = cls("cpu")
    batch = [(o, a, r) for o, a, r in zip(*_rollout_batches(1)[0])]
    ln.update(tuple(batch))
    state = ln.__getstate__()
    assert state["device"] == "cpu" and state["updates"] == 1
    assert all(isinstance(v, np.ndarray) for v in state["w"].values())
    ln2 = cls.__new__(cls)
    ln2.__setstate__(state)
    for k, v in ln.weights().items():
        np.testing.assert_array_equal(ln2.weights()[k], v)
    assert ln2.stats() == {"device": "cpu", "updates": 1}
    ln2.update(tuple(batch))
    assert ln2.updates == 2
    assert ln.update(()) == 0.0 and ln.updates == 1     # empty: no update


def test_pipeline_simulate_equals_the_reference(ref_pipeline):
    w = {"w1": np.random.default_rng(0).standard_normal((8, 32))
         .astype(np.float32) * 0.3,
         "w2": np.random.default_rng(1).standard_normal((32, 2))
         .astype(np.float32) * 0.3}
    for seed in (0, 7, 1003):
        got = rl_pipeline.simulate._fn(w, seed)
        want = ref_pipeline.simulate._fn(w, seed)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_workload_simulate_and_durations_equal_the_reference(ref_workload):
    for stage in range(rl_workload.N_STAGES):
        assert rl_workload._durations(stage) == ref_workload._durations(stage)
    for args in ((3, 0.1), (1005, 0.2)):
        got, want = rl_workload.simulate(args), ref_workload.simulate(args)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_workload_policy_update_equals_the_reference(ref_workload):
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal(8).astype(np.float32)
    g = rng.standard_normal((32, 8)).astype(np.float32)
    got = rl_workload.policy_update(torch.from_numpy(w0),
                                    torch.from_numpy(g)).numpy()
    want = np.asarray(ref_workload.policy_update(jnp.asarray(w0),
                                                 jnp.asarray(g)))
    _close(got, want)


@pytest.mark.parametrize("mode", ["compiled", "eager", "kill-node"])
def test_rl_pipeline_trains_on_the_cpu(mode, capsys):
    out = rl_pipeline.run(iters=10, kill_node=mode == "kill-node",
                          eager=mode == "eager", device="cpu")
    printed = capsys.readouterr().out
    assert out["device"] == "cpu"
    assert out["fetch_ok"] is True
    assert "fetch round-trip: ok" in printed
    assert "learner device: cpu" in printed
    if mode == "kill-node":
        assert "killed node" in printed
        assert out["learner_updates"] > 0 and len(out["returns"]) > 0
    else:   # every update applied
        assert len(out["returns"]) == 10
        assert out["learner_updates"] == 10
    assert all(np.isfinite(out["returns"]))


def test_rl_pipeline_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        rl_pipeline.main(["--iters", "1"])
    with pytest.raises(RuntimeError, match="is_available"):
        rl_workload.run()


def test_rl_workload_runs_on_the_cpu():
    out = rl_workload.run("cpu")
    # the keys of benchmarks/rl_workload.py's run()
    assert set(out) == {"serial_s", "bsp_s", "bsp10_s", "hybrid_s",
                        "bsp_vs_serial", "bsp10_vs_serial",
                        "hybrid_vs_serial", "hybrid_vs_bsp",
                        "hybrid_vs_bsp10", "paper", "config"}
    assert out["paper"] == {"bsp_vs_serial": 1 / 9, "hybrid_vs_serial": 7,
                            "hybrid_vs_bsp": 63}
    assert out["config"] == {"n_sim": 32, "n_stages": 6, "sim_ms": 7.0,
                             "straggler_ms": 25.0}
    # the serial run sleeps through every rollout: 6 stages of 32
    serial_floor = sum(d for s in range(6)
                       for _, d in rl_workload._durations(s)) / 1e3
    assert out["serial_s"] >= serial_floor
    assert 0 < out["hybrid_s"] < out["serial_s"]
    assert out["hybrid_vs_serial"] == out["serial_s"] / out["hybrid_s"]


def test_simulate_resolves_under_the_process_backend():
    """Both `simulate`s are module-level functions a spawned worker
    resolves by name."""
    core.init(num_nodes=1, workers_per_node=1, backend="process")
    try:
        w = {"w1": np.full((8, 32), 0.01, np.float32),
             "w2": np.full((32, 2), 0.02, np.float32)}
        got = core.get(rl_pipeline.simulate.submit(w, 5), timeout=120)
        want = rl_pipeline.simulate._fn(w, 5)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        ref = core.remote(rl_workload.simulate).submit((9, 0.5))
        mean, g = core.get(ref, timeout=120)
        assert mean == rl_workload.simulate((9, 0.0))[0]
        np.testing.assert_array_equal(g, rl_workload.simulate((9, 0.0))[1])
    finally:
        core.shutdown()
    deadline = time.monotonic() + 10
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not multiprocessing.active_children()
