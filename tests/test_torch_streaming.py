"""The port's streaming plane (`repro_torch.streaming`) against the
reference's (`repro.streaming`). On both packages: seeded streams give
identical batches, the drift detectors identical event sequences, the
learner's step equal metrics and float64 weights, and the source's
credit window the same back-pressure. On the port: the weight-staleness
path, the version-pinned ParamSet fetch, the learner, the pipeline end to
end, and a run under forced back-pressure that ends with the source
having produced and acked exactly the batches the run asked for."""
import dataclasses
import importlib
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import core
from repro_torch.compute.params import (KEEP_VERSION_HANDLES, ParamSet,
                                        ParamVersionRetiredError)
from repro_torch.core.memory import ObjectReclaimedError
from repro_torch.serving.slo import SLOTracker
from repro_torch.streaming import learner as learner_mod
from repro_torch.streaming.learner import OnlineLogit, StreamLearner
from repro_torch.streaming.pipeline import (OnlineServingEngine,
                                            StreamingPipeline)
from repro_torch.streaming.sources import (DriftSpec, StreamConfig,
                                           synthetic_stream)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ["repro", "repro_torch"]
RUNTIME_THREADS = ("worker-", "lane-", "heartbeat-", "actor-",
                   "failure-detector", "mm-reclaimer", "frontdoor-ctl")


def _drain_threads(timeout=15.0):
    """Every runtime thread ends shortly after `shutdown()`."""
    def alive():
        return [t.name for t in threading.enumerate()
                if t.name.startswith(RUNTIME_THREADS)]
    deadline = time.monotonic() + timeout
    while alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not alive(), alive()


def _pkg(name):
    return SimpleNamespace(
        name=name,
        core=importlib.import_module(f"{name}.core"),
        sources=importlib.import_module(f"{name}.streaming.sources"),
        drift=importlib.import_module(f"{name}.streaming.drift"),
        learner=importlib.import_module(f"{name}.streaming.learner"))


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """One package's runtime and streaming modules, with a cluster that
    is shut down after the test."""
    mods = _pkg(request.param)
    mods.core.init(num_nodes=3, workers_per_node=2)
    yield mods
    mods.core.shutdown()
    _drain_threads()


@pytest.fixture()
def both():
    """Both packages, each with a cluster of its own."""
    mods = [_pkg(name) for name in PACKAGES]
    for m in mods:
        m.core.init(num_nodes=1, workers_per_node=2)
    yield mods
    for m in mods:
        m.core.shutdown()
    _drain_threads()


@pytest.fixture()
def cluster():
    c = core.init(num_nodes=3, workers_per_node=2)
    yield c
    core.shutdown()
    _drain_threads()


def _cfg(mod, **kw):
    """The same StreamConfig in `mod`'s package."""
    drifts = tuple(mod.DriftSpec(**d) for d in kw.pop("drifts", ()))
    return mod.StreamConfig(drifts=drifts, **kw)


STREAMS = [
    dict(dim=8, batch=16, seed=7),
    dict(dim=16, batch=32, seed=42, interval_s=0.01,
         drifts=(dict(at_step=5, kind="abrupt", target="label"),)),
    dict(dim=4, batch=64, seed=0, drifts=(
        dict(at_step=2, kind="gradual", target="covariate", duration=6,
             magnitude=4.0),
        dict(at_step=9, kind="gradual", target="label", duration=4)))]


# ------------------------------------------------ parity, both packages

@pytest.mark.parametrize("kw", STREAMS, ids=["plain", "abrupt", "gradual"])
def test_seeded_stream_equals_the_reference(kw):
    ref, port = _pkg("repro"), _pkg("repro_torch")
    a = ref.sources.synthetic_stream(_cfg(ref.sources, **dict(kw)))
    b = port.sources.synthetic_stream(_cfg(port.sources, **dict(kw)))
    for _ in range(14):
        ba, bb = next(a), next(b)
        assert (ba.step, ba.t) == (bb.step, bb.t)
        assert ba.x.dtype == bb.x.dtype == np.float32
        np.testing.assert_array_equal(ba.x, bb.x)
        np.testing.assert_array_equal(ba.y, bb.y)


def _error_series(seed=11, n=200, shift_at=100, lo=0.1, hi=0.6):
    rng = np.random.default_rng(seed)
    return [float(np.clip((lo if i < shift_at else hi)
                          + rng.normal(0, 0.03), 0, 1))
            for i in range(n)]


@pytest.mark.parametrize("seed,shift_at", [(5, 100), (11, 60), (3, 10**9)])
def test_drift_events_equal_the_reference(seed, shift_at):
    def events(mod):
        m = mod.DriftMonitor(mod.AdwinDetector(), mod.LossEWMADetector())
        for i, v in enumerate(_error_series(seed=seed, shift_at=shift_at)):
            m.update(v, i)
        return [dataclasses.astuple(e) for e in m.events]
    want = events(_pkg("repro").drift)
    assert events(_pkg("repro_torch").drift) == want
    assert (len(want) >= 1) == (shift_at < 200)


@pytest.mark.parametrize("on_drift", ["reset", "boost"])
def test_learner_step_equals_the_reference(both, on_drift):
    """The same batches through each package's StreamLearner: equal step
    metrics (drift fires and published versions included) and float64
    weights equal bit for bit."""
    kw = dict(dim=8, batch=64, seed=9, drifts=(
        dict(at_step=60, kind="abrupt", target="label"),))
    runs = []
    for m in both:
        ln = m.learner.StreamLearner(f"parity-{on_drift}", dim=8,
                                     publish_every=16, lr=0.3,
                                     on_drift=on_drift)
        gen = m.sources.synthetic_stream(_cfg(m.sources, **dict(kw)))
        metrics = [ln.step(next(gen)) for _ in range(120)]
        runs.append((metrics, ln))
    (want, ref), (got, port) = runs
    assert got == want
    assert port.model.w.dtype == np.float64
    np.testing.assert_array_equal(port.model.w, ref.model.w)
    assert port.model.b == ref.model.b
    assert port.stats() == ref.stats()
    assert any(r["drift"] for r in got)


def test_source_backpressure_blocks_at_credit(pkg):
    src = pkg.core.remote(pkg.sources.StreamSource).submit(
        pkg.sources.StreamConfig(dim=4, batch=8, seed=1), max_ahead=3,
        policy="block")
    get = pkg.core.get
    stats = get(src.pump.submit(10))
    assert stats["produced"] == 3          # credit window, not request
    assert stats["outstanding"] == 3
    assert get(src.stats.submit())["shed"] == 0
    taken = get(src.take.submit(10))
    assert [s for _, s, _ in taken] == [0, 1, 2]
    assert get(src.pump.submit(10))["produced"] == 0
    assert get(src.ack.submit([oid for oid, _, _ in taken])) == 3
    assert get(src.pump.submit(10))["produced"] == 3


def test_source_shed_policy_advances_stream(pkg):
    src = pkg.core.remote(pkg.sources.StreamSource).submit(
        pkg.sources.StreamConfig(dim=4, batch=8, seed=1), max_ahead=2,
        policy="shed")
    get = pkg.core.get
    get(src.pump.submit(6))
    st = get(src.stats.submit())
    assert st["shed"] == 4 and st["produced"] == 2
    taken = get(src.take.submit(2))
    get(src.ack.submit([oid for oid, _, _ in taken]))
    get(src.pump.submit(1))
    assert get(src.take.submit(1))[0][1] == 6     # steps 2..5 were shed


def test_acked_batches_are_gc_reclaimed(pkg):
    c = pkg.core.api._cluster()
    src = pkg.core.remote(pkg.sources.StreamSource).submit(
        pkg.sources.StreamConfig(dim=16, batch=64, seed=2), max_ahead=2)
    pkg.core.get(src.pump.submit(2))
    oids = [oid for oid, _, _ in pkg.core.get(src.take.submit(2))]
    assert all(c.gcs.refcount(o) > 0 for o in oids)
    pkg.core.get(src.ack.submit(oids))
    for o in oids:
        assert c.memory.wait_reclaimed(o, timeout=5.0)


# ----------------------------------------------- the port: staleness

def test_hot_swap_records_staleness(cluster):
    """A replica's engine swaps to the newest version at wave start only:
    the tracker's lag grows with each publish and drops to 0 on the swap,
    and the wave's responses carry the version that scored them."""
    slo = SLOTracker()
    eng = OnlineServingEngine("stale", 4, tracker=slo, base_s=0.0,
                              per_req_s=0.0)
    for v in range(1, 4):
        ps = ParamSet.publish("stale", {"w": np.full(4, v, np.float32),
                                        "b": np.float32(0.0)},
                              meta={"stream_t": 0.1 * v})
        slo.record_publish(ps.version)
    assert slo.version_lag() == 3 and eng.version == 0
    reqs = [SimpleNamespace(request_id=i, prompt=np.ones(4, np.float32),
                            created=time.perf_counter()) for i in range(3)]
    out = eng.serve(reqs)
    assert [r.version for r in out] == [3, 3, 3]
    assert slo.version_lag() == 0 and eng.swaps == 1
    np.testing.assert_array_equal(eng._w, np.full(4, 3.0))
    assert eng.meta["stream_t"] == pytest.approx(0.3)
    assert not eng.maybe_swap()            # nothing newer: no swap


# -------------------------------------- the port: version-pinned fetch

def test_fetch_specific_version_via_handle_history(cluster):
    for i in range(3):
        ParamSet.publish("vh", {"w": np.full(8, i, np.float32)})
    ps = ParamSet.latest("vh")
    assert ps.version == 3
    tree = ps.fetch(version=3)
    assert float(tree["w"][0]) == 2.0
    old = ParamSet.at("vh", 2)
    for sid in old.shard_ids:
        assert cluster.memory.wait_reclaimed(sid, timeout=5.0)
    with pytest.raises(ParamVersionRetiredError):
        ps.fetch(version=2)
    with pytest.raises(ParamVersionRetiredError):
        ps.fetch(version=3 + KEEP_VERSION_HANDLES + 1)


def test_publish_fetch_hammer_no_reclaimed_error(cluster):
    """Continuous republish against concurrent fetch_latest readers never
    surfaces a raw ObjectReclaimedError nor a retired error."""
    stop = threading.Event()
    errors = []

    def publisher():
        i = 0
        while not stop.is_set():
            ParamSet.publish("hammer", {"w": np.full(2048, i, np.float32)})
            i += 1

    def reader():
        while not stop.is_set():
            try:
                got = ParamSet.fetch_latest("hammer", timeout=10.0)
                if got is not None:
                    w = got[1]["w"]
                    assert float(w.sum()) == w[0] * len(w)
            except ObjectReclaimedError as e:
                errors.append(f"ObjectReclaimedError escaped: {e}")
            except ParamVersionRetiredError as e:
                errors.append(f"retired escaped fetch_latest: {e}")
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    threads = [threading.Thread(target=publisher, daemon=True)] + [
        threading.Thread(target=reader, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_pinned_fetch_defers_reclaim_under_pin(cluster):
    ps = ParamSet.publish("pin", {"w": np.arange(16, dtype=np.float32)})
    sid = ps.shard_ids[0]
    cluster.memory.pin_ids("test-pin", [sid])
    try:
        ParamSet.publish("pin", {"w": np.zeros(16, np.float32)})
        deadline = time.time() + 5.0
        while cluster.gcs.refcount(sid) > 0 and time.time() < deadline:
            time.sleep(0.01)
        assert cluster.gcs.refcount(sid) <= 0
        buf = core.get(core.ObjectRef(sid), timeout=5.0)
        assert buf.nbytes == 16 * 4
    finally:
        cluster.memory.unpin("test-pin")
    assert cluster.memory.wait_reclaimed(sid, timeout=5.0)


# --------------------------------------------------- the port: learner

def _batches(cfg, n):
    gen = synthetic_stream(cfg)
    return [next(gen) for _ in range(n)]


def test_learner_prequential_improves(cluster):
    ln = StreamLearner("t-learn", dim=8, publish_every=4)
    accs = [ln.step(b)["acc"]
            for b in _batches(StreamConfig(dim=8, batch=64, seed=9), 30)]
    assert np.mean(accs[:3]) < np.mean(accs[-5:])
    assert np.mean(accs[-5:]) > 0.85
    st = ln.stats()
    assert st["steps"] == 30 and st["samples"] == 30 * 64
    assert st["published_version"] == ParamSet.latest("t-learn").version
    assert ParamSet.latest("t-learn").meta["learner_steps"] == 28


def test_learner_checkpoint_roundtrip():
    ln = StreamLearner("t-ckpt", dim=4, publish_every=2)
    ln.model.w = np.array([1.0, 2.0, 3.0, 4.0])
    ln.steps = 7
    ln2 = StreamLearner.__new__(StreamLearner)
    ln2.__setstate__(ln.__getstate__())
    np.testing.assert_array_equal(ln2.model.w, ln.model.w)
    assert ln2.steps == 7 and ln2.model.dim == 4
    assert isinstance(ln2.model, OnlineLogit)


# ------------------------------------------------- the port: pipeline

def test_pipeline_end_to_end_with_staleness(cluster):
    cfg = StreamConfig(dim=8, batch=24, seed=42, interval_s=0.01,
                       drifts=(DriftSpec(at_step=25, kind="abrupt",
                                         target="label"),))
    p = StreamingPipeline(cfg, publish_every=4, serve_per_batch=6,
                          deadline_s=0.5, engine_base_s=0.0005,
                          engine_per_req_s=0.0001)
    rep = p.run(50)
    p.close()
    assert rep["unresolved"] == 0
    assert rep["lost_steps"] == 0
    assert rep["served_samples"] > 0
    slo = rep["slo"]
    assert slo["dispatched_past_deadline"] == 0
    assert slo["weight_swaps"] > 0
    assert slo["staleness_samples"] > 0
    assert slo["published_version"] >= slo["served_version"] > 0
    post = [s for s in p.samples if s[0] >= 38]
    assert post
    assert (sum(s[1] for s in post) / len(post)
            > sum(s[2] for s in post) / len(post))
    from repro_torch.core.profiler import summarize
    s = summarize(cluster.gcs)
    assert s["stream_batches"] >= 50
    assert s["weight_swaps"] == slo["weight_swaps"]
    assert s["drift_events"] >= 0 and s["learner_resets"] >= 0
    assert s["swap_version_lag_mean"] >= 0
    roll = p.rolling_accuracy(window=50)
    assert len(roll) == len(p.samples)
    assert all(0.0 <= a <= 1.0 for _, a, _ in roll)


@pytest.mark.parametrize("num_batches,pump_chunk,max_ahead",
                         [(20, 4, 3), (23, 5, 4)])
def test_pipeline_pumps_only_what_the_run_needs(cluster, monkeypatch,
                                                num_batches, pump_chunk,
                                                max_ahead):
    """Forced back-pressure: a credit window narrower than a pump, a
    learner step that sleeps, and a driver pass that waits long enough for
    the learner to catch up, so a pump is cut to the window while the
    steps are un-acked and gets the whole window once they are acked.
    The source still produces and acks exactly `num_batches`, and holds
    none after. (The reference's run, which pumps `pump_chunk` on every
    pass, takes and acks a window's worth past `num_batches` here.)"""
    step = StreamLearner.step

    def slow_step(self, batch):
        time.sleep(0.002)
        return step(self, batch)

    monkeypatch.setattr(learner_mod.StreamLearner, "step", slow_step)
    cfg = StreamConfig(dim=4, batch=8, seed=1, interval_s=0.0)
    p = StreamingPipeline(cfg, publish_every=4, serve_per_batch=2,
                          max_ahead=max_ahead, engine_base_s=0.0,
                          engine_per_req_s=0.0)
    rep = p.run(num_batches, pump_chunk=pump_chunk,
                mid_run=lambda consumed: time.sleep(0.02))
    p.close()
    src = rep["source"]
    assert src["produced"] == src["acked"] == num_batches
    assert src["outstanding"] == 0 and src["buffered"] == 0
    assert rep["learner"]["steps"] == num_batches
    assert rep["lost_steps"] == 0 and rep["unresolved"] == 0


def test_pipeline_runs_back_to_back(cluster):
    """Runs in a row on one pipeline (the churn scenario's loop): the
    source's totals are the sum of what the runs asked for."""
    cfg = StreamConfig(dim=4, batch=8, seed=3, interval_s=0.0)
    p = StreamingPipeline(cfg, publish_every=2, serve_per_batch=1,
                          max_ahead=2, engine_base_s=0.0,
                          engine_per_req_s=0.0)
    for n in (7, 9, 5):
        rep = p.run(n, pump_chunk=4)
    p.close()
    src = rep["source"]
    assert src["produced"] == src["acked"] == 21
    assert src["outstanding"] == 0
    assert rep["learner"]["steps"] == 21


def _small_pipeline():
    cfg = StreamConfig(dim=4, batch=8, seed=3, interval_s=0.0)
    return StreamingPipeline(cfg, publish_every=2, serve_per_batch=1,
                             max_ahead=2, engine_base_s=0.0,
                             engine_per_req_s=0.0)


def test_pipeline_run_starts_with_a_full_collection(cluster):
    """A run collects the oldest generation before its first pass: the
    garbage promoted there before the run is gone when the stream starts,
    and no other collection of that generation falls due inside the run."""
    import gc
    import weakref

    class Cyclic:
        pass
    seen = []

    def on_gc(phase, info):
        if phase == "stop" and info["generation"] == 2:
            seen.append("collection")
    p = _small_pipeline()
    cycle = Cyclic()
    cycle.me = cycle
    ref = weakref.ref(cycle)
    gc.collect()        # it survives into the oldest generation
    del cycle
    gone_at_first_pass = []

    def mid_run(consumed):
        if not gone_at_first_pass:
            gone_at_first_pass.append(ref() is None)
            seen.append("pass")
    gc.callbacks.append(on_gc)
    try:
        p.run(5, pump_chunk=4, mid_run=mid_run)
    finally:
        gc.callbacks.remove(on_gc)
    p.close()
    assert gone_at_first_pass == [True]
    assert seen == ["collection", "pass"]


def test_pipeline_run_leaves_the_callers_freeze(cluster):
    """The objects a caller froze (`gc.freeze`, as a server does before it
    forks) stay frozen through a run and after it."""
    import gc
    p = _small_pipeline()
    mine = [[] for _ in range(3)]
    gc.freeze()
    try:
        p.run(5, pump_chunk=4)
        tracked = {id(o) for o in gc.get_objects()}
        assert gc.get_freeze_count() > 0
        assert not any(id(o) in tracked for o in mine)
    finally:
        gc.unfreeze()
        p.close()


def test_streaming_pure_pieces_import_without_the_frontdoor():
    """The package resolves learner and pipeline lazily, so the DES's
    streaming scenario runs without importing the FrontDoor or torch."""
    code = ("import sys\n"
            "from repro_torch.core.simulator import streaming_drift\n"
            "import repro_torch.streaming as s\n"
            "r = streaming_drift(num_batches=40, drift_at=20)\n"
            "assert r['batches'] == 40\n"
            "assert 'repro_torch.serving.frontdoor' not in sys.modules\n"
            "assert 'torch' not in sys.modules\n"
            "assert s.StreamingPipeline.__module__ == "
            "'repro_torch.streaming.pipeline'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
