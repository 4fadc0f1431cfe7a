"""The port's copy of the task runtime (`repro_torch.core`) against the
reference's (`repro.core`): each small program runs on each package, and
both give the results the program states. The runtime is plain Python, so
both packages must behave the same, torch tensors included."""
import importlib
import multiprocessing
import operator
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ["repro", "repro_torch"]
RUNTIME_THREADS = ("worker-", "lane-", "heartbeat-", "actor-",
                   "failure-detector", "mm-reclaimer")


def _runtime_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(RUNTIME_THREADS)]


def _drain_threads(timeout=10.0):
    """Every runtime thread ends shortly after `shutdown()`."""
    deadline = time.monotonic() + timeout
    while _runtime_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _runtime_threads(), _runtime_threads()


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """One package's `core` and `dag`; whatever cluster a test starts is
    shut down, and its threads must end."""
    mods = SimpleNamespace(
        name=request.param,
        core=importlib.import_module(f"{request.param}.core"),
        dag=importlib.import_module(f"{request.param}.dag"),
        profiler=importlib.import_module(f"{request.param}.core.profiler"))
    yield mods
    mods.core.shutdown()
    _drain_threads()


def _inc(x):
    return x + 1


def _add(a, b):
    return a + b


def _slow_inc(x):
    time.sleep(0.1)
    return x + 1


def _where():
    from threading import current_thread
    return current_thread().name


class _Counter:
    def __init__(self):
        self.seen = []

    def push(self, k):
        self.seen.append(k)
        return list(self.seen)


def test_remote_put_get_wait_edges(pkg):
    core = pkg.core
    core.init(num_nodes=2, workers_per_node=2)
    inc, add = core.remote(_inc), core.remote(_add)
    x = core.put(41)
    a = inc.submit(x)
    b = add.submit(a, inc.submit(a))           # a future inside the args
    assert core.get([a, b], timeout=10) == [42, 85]
    assert core.get(add.submit([1], [a]), timeout=10) == [1, 42]
    done, pending = core.wait([a, a, b], num_returns=5, timeout=10)
    assert (len(done), pending) == (3, [])     # duplicates, too many asked
    slow = core.remote(_slow_inc).submit(0)
    done, pending = core.wait([slow], timeout=0)
    assert (done, [r.id for r in pending]) == ([], [slow.id])
    with pytest.raises(core.GetTimeoutError):
        core.get(core.remote(_slow_inc).submit(slow), timeout=0.01)
    assert core.get(slow, timeout=10) == 1


def test_stored_tensor_is_the_same_object(pkg):
    """The thread backend holds a stored value by reference: a tensor comes
    back as the very object that was put, and a task's tensor result as
    the one it returned, with no copy."""
    core = pkg.core
    core.init(num_nodes=2, workers_per_node=1)
    t = torch.arange(6.0)
    assert core.get(core.put(t), timeout=10) is t
    keep = []

    def make():
        out = torch.ones(3)
        keep.append(out)
        return out

    assert core.get(core.remote(make).submit(), timeout=10) is keep[0]


def test_ordered_actor_calls(pkg):
    core = pkg.core
    core.init(num_nodes=2, workers_per_node=2)
    h = core.remote(_Counter).submit()
    refs = [h.push.submit(k) for k in range(20)]
    assert core.get(refs[-1], timeout=10) == list(range(20))
    assert [len(v) for v in core.get(refs, timeout=10)] == list(range(1, 21))


def test_compiled_graph(pkg):
    """A diamond and a 20-deep chain, executed three times each."""
    core, dag = pkg.core, pkg.dag
    c = core.init(num_nodes=2, workers_per_node=2)
    inc, add = core.remote(_inc), core.remote(_add)
    left = inc.bind(dag.input(0))
    diamond = dag.compile([add.bind(left, inc.bind(left)), left])
    node = dag.input(0)
    for _ in range(20):
        node = inc.bind(node)
    chain = dag.compile(node)
    for x in range(3):
        s, l_ = diamond.execute(x)
        assert core.get([s, l_], timeout=10) == [2 * x + 3, x + 1]
        assert core.get(chain.execute(x), timeout=10) == x + 20
    stats = pkg.profiler.summarize(c.gcs)
    assert (stats["graph_compiles"], stats["graph_invocations"]) == (2, 6)


def test_kill_node_replays_lineage(pkg):
    """An eager result and a compiled chain mid-invocation lose their node;
    lineage replay gives the same values."""
    core, dag = pkg.core, pkg.dag
    c = core.init(num_nodes=2, workers_per_node=2)
    inc = core.remote(_inc)
    ref = inc.submit(inc.submit(1))
    assert core.get(ref, timeout=10) == 3
    for node in c.gcs.locations(ref.id):
        c.kill_node(node)
    assert core.get(ref, timeout=30) == 3

    c = core.init(num_nodes=2, workers_per_node=2)
    slow = core.remote(_slow_inc)
    cg = dag.compile(slow.bind(slow.bind(slow.bind(dag.input(0)))))
    planned = c.gcs.graph_meta(cg.graph_id)["planned"][0]
    out = cg.execute(0)
    time.sleep(0.05)
    c.kill_node(planned)
    assert core.get(out, timeout=30) == 3
    kinds = {e[1] for e in c.gcs.events()}
    assert {"node_failure", "graph_replay"} <= kinds


def test_gpu_task_on_device_lane_and_unschedulable(pkg):
    core = pkg.core
    core.init(node_resources=[{"cpu": 2.0, "gpu": 1.0}, {"cpu": 2.0}])
    on_gpu = core.remote(_where, resources={"gpu": 1.0})
    names = core.get([on_gpu.submit() for _ in range(4)], timeout=10)
    assert set(names) == {"lane-gpu-n0"}
    t0 = time.perf_counter()
    with pytest.raises(core.UnschedulableTaskError):
        core.get(core.remote(_where, resources={"tpu": 1.0}).submit(),
                 timeout=10)
    assert time.perf_counter() - t0 < 2.0


def test_process_backend_round_trip(pkg):
    """A CPU array (128 KiB: a shared-memory segment) through a spawned
    worker: the result is a read-only view of a segment, and after
    shutdown no segment and no child process is left."""
    core = pkg.core
    c = core.init(num_nodes=1, workers_per_node=1, backend="process")
    x = np.arange(32768, dtype=np.float32)
    ref = core.remote(operator.mul).submit(x, 2.0)
    got = core.get(ref, timeout=60)
    np.testing.assert_array_equal(got, x * 2.0)
    assert not got.flags.writeable
    segment = c.nodes[0].store.payload_of(ref.id).segment
    assert segment is not None
    core.shutdown()
    assert not os.path.exists(f"/dev/shm/{segment}")
    deadline = time.monotonic() + 10
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not multiprocessing.active_children()


def test_profiler_keys_match():
    """The same program on both packages: the same summary keys, and the
    same counts of what the program did."""
    summaries = []
    for name in PACKAGES:
        core = importlib.import_module(f"{name}.core")
        profiler = importlib.import_module(f"{name}.core.profiler")
        c = core.init(node_resources=[{"cpu": 2.0, "gpu": 1.0}, {"cpu": 2.0}])
        try:
            inc = core.remote(_inc)
            on_gpu = core.remote(_inc, resources={"gpu": 1.0})
            core.get([inc.submit(i) for i in range(5)]
                     + [on_gpu.submit(1)], timeout=10)
            summaries.append(profiler.summarize(c.gcs))
        finally:
            core.shutdown()
        _drain_threads()
    ref, port = summaries
    assert set(ref) == set(port)
    assert ref["num_tasks"] == port["num_tasks"] == 6
    assert ref["kernel_tasks"] == port["kernel_tasks"] == 0


def test_port_keeps_the_reference_names():
    """The same public names in `core`, `core.dag` and `dag`."""
    for mod in ("core", "dag", "core.dag"):
        ref = importlib.import_module(f"repro.{mod}")
        port = importlib.import_module(f"repro_torch.{mod}")
        public = {n for n in vars(ref) if not n.startswith("_")
                  and not isinstance(getattr(ref, n), type(importlib))}
        assert public <= set(vars(port)), public - set(vars(port))


def _hold_the_interpreter(at_least_s: float) -> float:
    """One C call that keeps the GIL for at least `at_least_s` (no thread
    of the process runs meanwhile); returns its seconds."""
    n = 1 << 18
    while True:
        t0 = time.perf_counter()
        sum(range(n))
        dt = time.perf_counter() - t0
        if dt >= at_least_s:
            return dt
        n *= 2


def test_detector_counts_no_miss_from_a_late_scan():
    """The port only: the interleaving that failed under load, forced with
    an injected clock. Between the many C calls of a stall the detector
    may take the interpreter back before any beater, three times: each of
    those scans is late (more than two intervals after the one before), so
    it finds no new beat and is no evidence. Counted as misses, as they
    were, they reached `miss` with the last beat long past the horizon and
    killed all three live nodes at the third. A node whose beats really
    stop is still killed at the third on-time scan."""
    from repro_torch import core
    c = core.init(num_nodes=3, workers_per_node=1)   # no detector thread
    try:
        det = c.detector
        det.enabled = True
        iv = det.interval
        for node in c.nodes:
            c.gcs.beat(node.node_id, 0.0)
        det._tick(0.0)
        for t in (0.45, 0.9, 1.35):          # late scans, no beat between
            det._tick(t)
        assert all(n.alive for n in c.nodes)
        t = 1.35
        for i in range(3):                   # node 1's beats have stopped
            t += iv
            for live in (0, 2):
                c.gcs.beat(live, t)
            det._tick(t)
            assert c.nodes[1].alive == (i < 2)
        assert c.nodes[0].alive and c.nodes[2].alive
    finally:
        core.shutdown()
    _drain_threads()


def test_detector_outlasts_a_stall_of_the_interpreter():
    """The port only: a stall of the whole interpreter delays every beater
    and the detector alike and counts as one missed scan, so no live node
    is killed; a node whose beats stop is still killed within a few scans.
    (The reference's detector judges wall time alone and may fail-stop
    every node after such a stall.)"""
    from repro_torch import core
    from repro_torch.core.profiler import summarize
    c = core.init(num_nodes=3, workers_per_node=1, failure_detection=True,
                  heartbeat_interval_s=0.05)
    try:
        time.sleep(0.2)
        stalls = [_hold_the_interpreter(0.4) for _ in range(3)]
        time.sleep(0.3)
        assert min(stalls) >= 0.4      # over 2x the detector's 150 ms horizon
        assert all(n.alive for n in c.nodes)
        assert summarize(c.gcs)["detector_kills"] == 0
        c.nodes[1].hb_suspended = True
        deadline = time.monotonic() + 5.0
        while c.nodes[1].alive and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not c.nodes[1].alive
        assert c.nodes[0].alive and c.nodes[2].alive
        assert summarize(c.gcs)["detector_kills"] == 1
    finally:
        core.shutdown()
    _drain_threads()
