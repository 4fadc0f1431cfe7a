"""The port's compute plane (`repro_torch.compute`) on the CPU: kernel tasks
of torch functions on the device lane, int8_matmul run as a kernel task,
and `ParamSet` over pytrees of tensors, held against the reference's
`repro.compute` where both can run the same program."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.compute as jax_compute  # noqa: E402
from repro import core as jax_core  # noqa: E402
from repro.kernels.int8_matmul import int8_matmul_ref as jax_int8_matmul_ref  # noqa: E402
from repro.kernels.int8_matmul import quantize_weights as jax_quantize  # noqa: E402
from repro_torch import compute, core  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.compute import ParamSet, kernel_task  # noqa: E402
from repro_torch.compute.params import ParamVersionRetiredError  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_ref,  # noqa: E402
                                             quantize_weights)

RUNTIME_THREADS = ("worker-", "lane-", "heartbeat-")


def _drain_threads(timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith(RUNTIME_THREADS)]
        if not left:
            return
        time.sleep(0.02)
    raise AssertionError(f"runtime threads left: {left}")


@pytest.fixture()
def hetero():
    """One gpu-typed node and one cpu node, as compute_bench.py's cluster."""
    c = core.init(node_resources=[{"cpu": 4.0, "gpu": 1.0}, {"cpu": 4.0}])
    yield c
    core.shutdown()
    _drain_threads()


# ---------------------------------------------------------- kernel tasks

def _mm(x):
    return torch.tanh(x @ x.T)


def test_kernel_task_runs_and_logs_a_kernel_event(hetero):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 16)).astype(np.float32))
    kt = kernel_task(_mm)
    out = core.get(kt.submit(x), timeout=30)
    np.testing.assert_allclose(out.numpy(), np.tanh(x.numpy() @ x.numpy().T),
                               rtol=1e-5, atol=1e-6)
    kernels = [e for e in hetero.gcs.events() if e[1] == "kernel"]
    assert len(kernels) == 1
    _, _, _, where, extra = kernels[0]
    assert where == "node0" and extra["kernel"] == "_mm" and extra["ms"] > 0
    stats = profiler.summarize(hetero.gcs)
    assert stats["kernel_tasks"] == 1
    assert stats["kernel_time_ms_mean"] == pytest.approx(extra["ms"])


def test_kernel_task_decorator_defaults():
    @kernel_task
    def double(x):
        return x * 2

    assert double.resources == {"gpu": 1.0}
    assert isinstance(double, compute.KernelFunction)
    kt = kernel_task(double.kernel_fn, resources={"gpu": 2.0},
                     num_returns=1)
    assert kt.resources == {"gpu": 2.0}
    assert jax_compute.kernel_task(lambda x: x).resources == double.resources


def test_warmup_runs_once_on_the_caller():
    calls = []

    def f(x):
        calls.append(threading.current_thread().name)
        return x + 1

    kernel_task(f, warmup_args=(torch.zeros(2),))
    assert calls == [threading.current_thread().name]


def test_lane_keeps_grad_mode_of_its_own(hetero):
    """A kernel task runs on the node's device lane with PyTorch's
    thread-local defaults, whatever its caller's grad mode."""
    def grad_of_square(x):
        x = x.detach().requires_grad_(True)
        (x * x).sum().backward()
        return threading.current_thread().name, torch.is_grad_enabled(), x.grad

    kt = kernel_task(grad_of_square)
    x = torch.arange(4.0)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            name, enabled, grad = core.get(kt.submit(x), timeout=30)
        assert name == "lane-gpu-n0" and enabled
        torch.testing.assert_close(grad, 2 * x)


def test_int8_matmul_as_a_kernel_task(hetero):
    """compute_bench.py's pallas smoke (8 x 128 x 128 fp32, gate max abs err
    < 1e-3) on the port: the wrapper run as a kernel task on the gpu node,
    against the port's and the reference's plain versions."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 128), dtype=np.float32)
    w = rng.standard_normal((128, 128), dtype=np.float32)
    wq, scales = quantize_weights(torch.from_numpy(w))
    kt = kernel_task(lambda xx: int8_matmul(xx, wq, scales),
                     resources={"gpu": 1.0})
    out = core.get(kt.submit(torch.from_numpy(x)), timeout=30)
    torch.testing.assert_close(out, int8_matmul_ref(torch.from_numpy(x), wq,
                                                    scales), rtol=0, atol=0)
    jwq, jsc = jax_quantize(jnp.asarray(w))
    want = np.asarray(jax_int8_matmul_ref(jnp.asarray(x), jwq, jsc))
    assert float(np.max(np.abs(out.numpy() - want))) < 1e-3
    assert profiler.summarize(hetero.gcs)["kernel_tasks"] == 1


# ------------------------------------------------------------- ParamSet

def _weights(seed=0):
    """A params-like numpy pytree: bf16 leaves (as `ml_dtypes.bfloat16`),
    fp32 leaves, tuple-stacked groups and a list."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32))
                          .astype(jnp.bfloat16))

    return {"embed": bf16(64, 32),
            "groups": tuple({"w": bf16(32, 32),
                             "gate": rng.standard_normal(32).astype(np.float32)}
                            for _ in range(3)),
            "extra": [bf16(5), np.arange(7, dtype=np.int32)]}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, path + (type(v).__name__, i))]
    return [(path, tree)]


def test_paramset_of_tensors_fetches_the_references_leaves():
    """The same weights published as JAX arrays through the reference and as
    torch tensors (bf16 included) through the port: the fetched pytrees
    have one structure and equal leaves, bit for bit."""
    weights = _weights()
    jax_core.init(node_resources=[{"cpu": 4.0, "gpu": 1.0}, {"cpu": 4.0}])
    try:
        jax_tree = {"embed": jnp.asarray(weights["embed"]),
                    "groups": weights["groups"], "extra": weights["extra"]}
        jax_compute.ParamSet.publish("lm", jax_tree, num_shards=2)
        want = jax_compute.ParamSet.latest("lm").fetch()
    finally:
        jax_core.shutdown()
    core.init(node_resources=[{"cpu": 4.0, "gpu": 1.0}, {"cpu": 4.0}])
    try:
        ps = ParamSet.publish("lm", params_from_numpy(weights, "cpu"),
                              num_shards=2)
        got = ParamSet.latest("lm").fetch()
    finally:
        core.shutdown()
        _drain_threads()
    assert ps.version == 1 and len(ps.shard_ids) == 2
    assert isinstance(got["groups"], tuple) and isinstance(got["extra"], list)
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        assert (a.dtype.name, a.shape) == (b.dtype.name, b.shape), path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_paramset_fetch_is_zero_copy_and_read_only(hetero):
    src = params_from_numpy(_weights(1), "cpu")
    ParamSet.publish("z", src, num_shards=2)
    fresh = ParamSet.latest("z")
    got = fresh.fetch()
    for path, _, _, shard, *_ in fresh.layout:
        leaf = got
        for key in path.split("/"):
            leaf = leaf[int(key[1:])] if key[0] in "#~" else leaf[key]
        assert np.shares_memory(leaf, fresh._shard(shard, timeout=10))
        assert not leaf.flags.writeable
    before = got["embed"].copy()
    src["embed"].add_(1)       # the published copy does not alias the tensor
    np.testing.assert_array_equal(ParamSet.latest("z").fetch()["embed"],
                                  before)


def test_paramset_version_swap_and_gc(hetero):
    ps1 = ParamSet.publish("v", params_from_numpy(_weights(1), "cpu"),
                           num_shards=2)
    ps2 = ParamSet.publish("v", params_from_numpy(_weights(2), "cpu"),
                           num_shards=2)
    assert ps2.version == ps1.version + 1 == 2
    assert ParamSet.latest("v").version == 2
    for sid in ps1.shard_ids:
        assert hetero.memory.wait_reclaimed(sid, timeout=10.0)
    with pytest.raises(ParamVersionRetiredError):
        ParamSet.latest("v").fetch(version=1)
    np.testing.assert_array_equal(
        ParamSet.latest("v").fetch()["embed"].view(np.uint16),
        _weights(2)["embed"].view(np.uint16))
    stats = profiler.summarize(hetero.gcs)
    assert stats["param_publishes"] == 2 and stats["param_bytes"] > 0


def test_compute_keeps_the_reference_names():
    public = {n for n in vars(jax_compute) if not n.startswith("_")}
    assert public <= set(vars(compute)), public - set(vars(compute))
