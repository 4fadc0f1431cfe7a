"""The port's baseline executors (`repro_torch.core.executors`) against the
reference's (`repro.core.executors`): the reference's executor tests run
on both packages, then the `HybridExecutor`'s `map_stage` and
`map_pipelined` on each package's runtime."""
import importlib
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = ["repro", "repro_torch"]
RUNTIME_THREADS = ("worker-", "lane-", "heartbeat-", "actor-",
                   "failure-detector", "mm-reclaimer")


def _drain_threads(timeout=10.0):
    """Every runtime thread ends shortly after `shutdown()`."""
    def alive():
        return [t.name for t in threading.enumerate()
                if t.name.startswith(RUNTIME_THREADS)]
    deadline = time.monotonic() + timeout
    while alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not alive(), alive()


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """One package's `core` and `executors`; whatever cluster a test
    starts is shut down, and its threads must end."""
    mods = SimpleNamespace(
        name=request.param,
        core=importlib.import_module(f"{request.param}.core"),
        executors=importlib.import_module(
            f"{request.param}.core.executors"))
    yield mods
    mods.core.shutdown()
    _drain_threads()


def _square(x):
    return x * x


def _sleep_square(x):
    time.sleep(0.2 if x == 0 else 0.001)    # item 0 is the straggler
    return x * x


def test_bsp_executor_barrier_semantics(pkg):
    ex = pkg.executors.BSPExecutor(num_workers=4, driver_overhead_s=0.0)
    out = ex.map_stage(lambda x: x * 2, list(range(10)))
    assert out == [x * 2 for x in range(10)]
    ex.shutdown()


def test_serial_executor(pkg):
    assert pkg.executors.SerialExecutor().map_stage(
        lambda x: x + 1, [1, 2]) == [2, 3]


def test_bsp_executor_charges_the_driver_per_task(pkg):
    """The stage returns only after every task, and the driver's overhead
    is paid once per task, in turn."""
    ex = pkg.executors.BSPExecutor(num_workers=8, driver_overhead_s=0.01)
    try:
        t0 = time.perf_counter()
        out = ex.map_stage(_square, list(range(8)))
        assert time.perf_counter() - t0 >= 8 * 0.01
        assert out == [x * x for x in range(8)]
    finally:
        ex.shutdown()


def test_bsp_executor_shutdown_ends_its_workers(pkg):
    ex = pkg.executors.BSPExecutor(num_workers=3, driver_overhead_s=0.0)
    ex.map_stage(_square, [1, 2, 3])
    ex.shutdown()
    for w in ex._workers:
        w.join(timeout=5.0)
    assert not any(w.is_alive() for w in ex._workers)


def test_hybrid_executor_map_stage(pkg):
    pkg.core.init(num_nodes=2, workers_per_node=2)
    ex = pkg.executors.HybridExecutor(pkg.core.remote(_square))
    assert ex.map_stage(list(range(12))) == [x * x for x in range(12)]


def test_hybrid_executor_map_pipelined_completion_order(pkg):
    """Results are consumed as they finish: the straggler's comes last,
    and every item is consumed once."""
    pkg.core.init(num_nodes=2, workers_per_node=2)
    ex = pkg.executors.HybridExecutor(pkg.core.remote(_sleep_square))
    seen = []
    outs = ex.map_pipelined(list(range(6)), consume=lambda v: seen.append(v)
                            or v + 1, batch=1)
    assert sorted(outs) == sorted(x * x + 1 for x in range(6))
    assert sorted(seen) == sorted(x * x for x in range(6))
    assert seen[-1] == 0                  # the straggler, item 0


def test_hybrid_executor_map_pipelined_batches(pkg):
    """With `batch`, each wait hands over up to that many results; every
    item is consumed once, whatever the batch."""
    pkg.core.init(num_nodes=2, workers_per_node=2)
    ex = pkg.executors.HybridExecutor(pkg.core.remote(_square))
    outs = ex.map_pipelined(list(range(7)), consume=lambda v: -v, batch=3)
    assert sorted(outs) == sorted(-x * x for x in range(7))

