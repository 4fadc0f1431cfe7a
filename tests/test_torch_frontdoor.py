"""The port's open-loop serving tier (`repro_torch.serving.{frontdoor,slo}`,
`ServingReplica`/`ReplicaPool`, `serve_llm`) against the reference's: each
of the reference's FrontDoor, SLOTracker, BatchController and ReplicaPool
tests runs as a case on both packages over a sleep-based engine; then the
port's FrontDoor over the port's engine gives the JAX engine's greedy
tokens, and the entry point runs on the CPU and refuses to run without a
card unless asked for the CPU."""
import importlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as torch_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

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


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """One package's runtime and serving modules; whatever cluster a test
    starts is shut down, and its threads must end."""
    name = request.param
    mods = SimpleNamespace(
        name=name,
        core=importlib.import_module(f"{name}.core"),
        serving=importlib.import_module(f"{name}.serving"),
        engine=importlib.import_module(f"{name}.serving.engine"),
        frontdoor=importlib.import_module(f"{name}.serving.frontdoor"),
        slo=importlib.import_module(f"{name}.serving.slo"))
    yield mods
    mods.core.shutdown()
    _drain_threads()


@pytest.fixture()
def cluster(pkg):
    return pkg.core.init(num_nodes=2, workers_per_node=2)


class FakeEngine:
    """Deterministic sleep-based engine: service time is affine in the
    wave size, so batching dynamics are controlled without a model."""

    def __init__(self, response_cls, base_s=0.004, per_req_s=0.002):
        self.response_cls = response_cls
        self.base_s = base_s
        self.per_req_s = per_req_s

    def serve(self, requests, max_wave=8):
        time.sleep(self.base_s + self.per_req_s * len(requests))
        now = time.perf_counter()
        return [self.response_cls(r.request_id, [1] * r.max_new_tokens,
                                  now - r.created) for r in requests]


def _factory(pkg, **kw):
    response_cls = pkg.engine.Response
    return lambda: FakeEngine(response_cls, **kw)


# ------------------------------------------------- AIMD control, SLO ledger

def test_batch_controller_aimd(pkg):
    c = pkg.frontdoor.BatchController(target_wave_s=0.05, max_batch=8,
                                      initial=1)
    for _ in range(10):
        c.observe(0.01)                   # under target: +1 each
    assert c.size == 8                    # capped at max_batch
    c.observe(0.10)                       # overshoot: 10% backoff
    assert c.size == 7
    for _ in range(40):
        c.observe(0.10)                   # sustained overshoot
    assert c.size == 1                    # floored at 1
    fixed = pkg.frontdoor.FixedBatchController(3)
    fixed.observe(10.0)
    assert fixed.size == 3


def test_slo_ledger_and_goodput(pkg):
    t = pkg.slo.SLOTracker(window_s=60.0)
    for _ in range(4):
        t.record_admit()
    t.record_completion(0.01, met_deadline=True, now=100.0)
    t.record_completion(0.02, met_deadline=True, now=101.0)
    t.record_completion(0.50, met_deadline=False, now=102.0)
    t.record_shed()
    assert t.resolved() == 4
    # 2 within-deadline completions over the 2s first..last span
    assert t.overall_goodput() == pytest.approx(1.0)
    snap = t.snapshot(now=102.0)
    assert snap["completed_ok"] == 2
    assert snap["completed_late"] == 1
    assert snap["shed"] == 1
    assert snap["latency_p50_ms"] == pytest.approx(20.0)
    assert pkg.slo.percentile([3, 1, 2], 0.5) == 2
    assert pkg.slo.percentile([], 0.99) == 0.0


def test_staleness_lag_monotone_between_swaps_resets_on_swap(pkg):
    slo = pkg.slo.SLOTracker()
    lags = []
    for v in range(1, 5):
        slo.record_publish(v)
        lags.append(slo.version_lag())
    assert lags == [1, 2, 3, 4]            # monotone between swaps
    assert slo.snapshot()["version_lag_max"] == 4
    slo.record_swap(4)
    assert slo.version_lag() == 0          # reset on swap
    assert slo.snapshot()["weight_swaps"] == 1
    assert slo.snapshot()["swap_lag_mean"] == 4.0
    # duplicate/replayed publish notification never lowers the version
    slo.record_publish(2)
    assert slo.snapshot()["published_version"] == 4


def test_staleness_samples_aggregate(pkg):
    slo = pkg.slo.SLOTracker()
    slo.record_staleness(2, 0.5)
    slo.record_staleness(0, 0.1)
    slo.record_staleness(4, 1.4)
    snap = slo.snapshot()
    assert snap["staleness_samples"] == 3
    assert snap["staleness_lag_mean"] == pytest.approx(2.0)
    assert snap["behind_s_mean"] == pytest.approx(2.0 / 3)
    assert snap["behind_s_max"] == pytest.approx(1.4)


# --------------------------------------------- priority within a bucket

def test_priority_orders_within_deadline_bucket(pkg):
    entry = pkg.frontdoor._Entry
    base = 1000.0
    quantum = 0.01
    low = entry(base + 0.001, seq=0, request=None, ticket=None,
                priority=0, quantum=quantum)
    high = entry(base + 0.004, seq=1, request=None, ticket=None,
                 priority=1, quantum=quantum)
    # same quantized bucket: priority wins despite later seq/deadline
    assert high < low
    # an earlier bucket always dominates any priority
    earlier = entry(base - 0.5, seq=2, request=None, ticket=None,
                    priority=0, quantum=quantum)
    assert earlier < high
    # quantum 0 restores pure EDF: priority inert
    a = entry(base + 0.001, seq=0, request=None, ticket=None,
              priority=0, quantum=0.0)
    b = entry(base + 0.004, seq=1, request=None, ticket=None,
              priority=5, quantum=0.0)
    assert a < b


def test_request_carries_priority_default_zero(pkg):
    r = pkg.engine.Request(0, np.zeros(4, np.int32))
    assert r.priority == 0
    r2 = pkg.engine.Request(1, np.zeros(4, np.int32), priority=3)
    assert r2.priority == 3


def test_serving_exports_resolve_lazily(pkg):
    """The package's names are the modules' own; loading `load` and `slo`
    imports no engine."""
    assert pkg.serving.FrontDoor is pkg.frontdoor.FrontDoor
    assert pkg.serving.SLOTracker is pkg.slo.SLOTracker
    assert pkg.serving.ReplicaPool is pkg.engine.ReplicaPool
    assert set(pkg.serving.__all__) >= {"FrontDoor", "ServingReplica",
                                        "AdmissionError", "SLOTracker"}
    with pytest.raises(AttributeError):
        pkg.serving.NoSuchName  # noqa: B018
    src = str(Path(pkg.serving.__file__).resolve().parents[2])
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; from {pkg.name}.serving import load, slo; "
         f"print(sorted(m for m in sys.modules if m.startswith("
         f"('{pkg.name}.serving.engine', 'torch', 'jax'))))"],
        capture_output=True, text=True, check=True, timeout=60,
        env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.strip() == "[]"


# ----------------------------------------------------------- front door

def test_frontdoor_serves_and_adapts(pkg, cluster):
    fd = pkg.frontdoor.FrontDoor(_factory(pkg), num_replicas=2,
                                 max_queue=64, default_deadline_s=1.0,
                                 target_wave_s=0.03, max_batch=8,
                                 resources={"cpu": 0.25})
    try:
        tickets = [fd.submit(np.arange(8), 2) for _ in range(40)]
        responses = [t.result(timeout=20) for t in tickets]
        assert sorted(r.request_id for r in responses) == list(range(40))
        st = fd.stats()
        assert st["completed_ok"] + st["completed_late"] == 40
        assert st["dispatched_past_deadline"] == 0
        # AIMD grew past the initial singleton waves
        assert max(st["batch_limits"]) > 1
    finally:
        fd.close()


def test_frontdoor_stall_after_wave_formation(pkg, cluster):
    """The control thread stalls between forming a wave and dispatching
    it (here inside the formation) until the head's deadline has passed:
    the reference dispatches it and counts one late dispatch; the port
    sheds it at the dispatch instant, so none is dispatched late, and
    counts it apart from the queue's sheds with how late it was."""
    fd = pkg.frontdoor.FrontDoor(_factory(pkg), num_replicas=1,
                                 max_queue=8, default_deadline_s=0.2,
                                 resources={"cpu": 0.25})
    form = fd._form_wave_locked

    def stalled(limit):
        entries = form(limit)
        if entries:
            time.sleep(max(e.deadline for e in entries)
                       - time.perf_counter() + 0.01)
        return entries

    fd._form_wave_locked = stalled
    try:
        ticket = fd.submit(np.arange(8), 2)
        if pkg.name == "repro":
            ticket.result(timeout=20)
            assert fd.stats()["dispatched_past_deadline"] == 1
        else:
            with pytest.raises(pkg.frontdoor.DeadlineShedError):
                ticket.result(timeout=20)
            st = fd.stats()
            assert st["dispatched_past_deadline"] == 0 and st["shed"] == 1
            assert st["shed_at_dispatch"] == 1
            assert st["shed_at_dispatch_late_ms_max"] >= 10.0
    finally:
        fd.close()


def test_frontdoor_counts_a_dispatch_past_the_deadline():
    """The port's late-dispatch count reads the clock at the dispatch
    itself: if the clock passes a head's deadline after the at-dispatch
    shed let it through, the head is dispatched and counted late."""
    from repro_torch import core
    from repro_torch.serving import engine, frontdoor
    real = time.perf_counter
    jump = {"armed": False, "calls": 0, "by": 0.0}

    def perf_counter():
        if jump["armed"] and threading.current_thread().name.startswith(
                "frontdoor-ctl"):
            jump["calls"] += 1
            if jump["calls"] == 2:       # the clock read at the dispatch
                jump["armed"] = False
                return real() + jump["by"]
        return real()

    core.init(num_nodes=2, workers_per_node=2)
    fd = frontdoor.FrontDoor(lambda: FakeEngine(engine.Response),
                             num_replicas=1, max_queue=8,
                             default_deadline_s=0.5,
                             resources={"cpu": 0.25})
    form = fd._form_wave_locked

    def formed(limit):
        entries = form(limit)
        if entries:
            jump["by"] = max(e.deadline for e in entries) - real() + 0.01
            jump["armed"] = True
        return entries

    fd._form_wave_locked = formed
    old_time = frontdoor.time
    frontdoor.time = SimpleNamespace(perf_counter=perf_counter,
                                     sleep=time.sleep,
                                     monotonic=time.monotonic)
    try:
        fd.submit(np.arange(8), 2).result(timeout=20)
        st = fd.stats()
        assert st["dispatched_past_deadline"] == 1
        assert st["shed"] == st["shed_at_dispatch"] == 0
    finally:
        frontdoor.time = old_time
        fd.close()
        core.shutdown()
        _drain_threads()


def test_frontdoor_admission_control(pkg, cluster):
    fd = pkg.frontdoor.FrontDoor(_factory(pkg), num_replicas=1, max_queue=4,
                                 default_deadline_s=5.0,
                                 resources={"cpu": 0.25})
    try:
        tickets, rejected = [], 0
        for _ in range(50):
            try:
                tickets.append(fd.submit(np.arange(8), 2))
            except pkg.frontdoor.AdmissionError:
                rejected += 1
        assert rejected > 0                # the bounded queue refused some
        for t in tickets:
            t.result(timeout=20)           # admitted ones all complete
        assert fd.stats()["rejected"] == rejected
    finally:
        fd.close()


def test_frontdoor_deadline_shedding(pkg, cluster):
    # service 60ms vs 25ms deadlines: most queued requests expire and
    # must be shed, never dispatched
    fd = pkg.frontdoor.FrontDoor(_factory(pkg, base_s=0.06, per_req_s=0.0),
                                 num_replicas=1, max_queue=128,
                                 default_deadline_s=0.025,
                                 target_wave_s=0.03,
                                 resources={"cpu": 0.25})
    try:
        tickets = [fd.submit(np.arange(8), 2) for _ in range(30)]
        shed = ok = 0
        for t in tickets:
            try:
                t.result(timeout=20)
                ok += 1
            except pkg.frontdoor.DeadlineShedError:
                shed += 1
        st = fd.stats()
        assert shed > 0 and ok + shed == 30
        assert st["dispatched_past_deadline"] == 0
        assert st["admitted"] == (st["completed_ok"] + st["completed_late"]
                                  + st["shed"] + st["failed"])
    finally:
        fd.close()


def test_frontdoor_autoscale_up_and_down(pkg, cluster):
    fd = pkg.frontdoor.FrontDoor(_factory(pkg), num_replicas=1,
                                 min_replicas=1, max_replicas=3,
                                 max_queue=256, default_deadline_s=5.0,
                                 scale_up_queue_depth=4,
                                 scale_up_cooldown_s=0.1,
                                 scale_down_idle_s=0.3,
                                 resources={"cpu": 0.25})
    try:
        tickets = [fd.submit(np.arange(8), 2) for _ in range(60)]
        for t in tickets:
            t.result(timeout=30)
        assert fd.replica_count() > 1      # queue depth drove scale-up
        deadline = time.perf_counter() + 10.0
        while (fd.replica_count() > 1
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        assert fd.replica_count() == 1     # idle reclaimed to min
    finally:
        fd.close()


def test_frontdoor_replica_kill_all_tickets_resolve(pkg, cluster):
    # the test kills the node by hand, like the
    # ReplicaPool failure tests
    fd = pkg.frontdoor.FrontDoor(_factory(pkg), num_replicas=2,
                                 max_replicas=4, max_queue=256,
                                 default_deadline_s=2.0,
                                 resources={"cpu": 0.25})
    try:
        tickets = []
        for i in range(60):
            tickets.append(fd.submit(np.arange(8), 2))
            if i == 30:
                nid = cluster.gcs.actor_node(
                    fd._replicas[0].handle.actor_id)
                if nid is not None:
                    cluster.kill_node(nid)
            time.sleep(0.002)
        values = errors = 0
        for t in tickets:
            try:
                t.result(timeout=30)
                values += 1
            except (pkg.frontdoor.DeadlineShedError, pkg.core.TaskError,
                    TimeoutError):
                errors += 1
        assert values + errors == 60       # no hung futures
        assert values > 0
        st = fd.stats()
        assert st["admitted"] == (st["completed_ok"] + st["completed_late"]
                                  + st["shed"] + st["failed"])
    finally:
        fd.close()


def test_frontdoor_hot_spare_on_death(pkg, cluster):
    fd = pkg.frontdoor.FrontDoor(_factory(pkg), num_replicas=2,
                                 max_replicas=4, max_queue=256,
                                 default_deadline_s=5.0,
                                 scale_down_idle_s=60.0,
                                 resources={"cpu": 0.25})
    try:
        # keep traffic flowing so the ctl loop is active
        tickets = [fd.submit(np.arange(8), 2) for _ in range(10)]
        nid = cluster.gcs.actor_node(fd._replicas[0].handle.actor_id)
        cluster.kill_node(nid)
        deadline = time.perf_counter() + 10.0
        while (fd.replica_count() < 3
               and time.perf_counter() < deadline):
            time.sleep(0.02)
        assert fd.replica_count() == 3     # spare spawned over the loss
        for t in tickets:
            t.result(timeout=30)
    finally:
        fd.close()


# ------------------------------------------------- serving replica pool

def test_replica_pool_routes_and_recovers(pkg, cluster):
    pool = pkg.engine.ReplicaPool(_factory(pkg, base_s=0.01, per_req_s=0.0),
                                  num_replicas=2)
    reqs = [pkg.engine.Request(i, prompt=list(range(4))) for i in range(16)]
    responses = pool.serve(reqs, max_wave=2)
    assert sorted(r.request_id for r in responses) == list(range(16))
    stats = pool.stats()
    # wait-based routing used both replicas
    assert all(s["waves_served"] >= 1 for s in stats)
    assert sum(s["requests_served"] for s in stats) == 16


def test_replica_pool_respawns_dead_replica(pkg):
    pkg.core.init(num_nodes=3, workers_per_node=2)
    Request = pkg.engine.Request
    pool = pkg.engine.ReplicaPool(_factory(pkg, base_s=0.005, per_req_s=0.0),
                                  num_replicas=2)
    reqs = [Request(i, prompt=list(range(4))) for i in range(8)]
    assert len(pool.serve(reqs, max_wave=2)) == 8
    old = pool.replicas[0]
    pool.respawn_replica(0)
    assert pool.replicas[0] is not old
    assert pool._inflight[0] == []
    # the respawned replica serves traffic again
    out = pool.serve([Request(100 + i, prompt=list(range(4)))
                      for i in range(8)], max_wave=2)
    assert sorted(r.request_id for r in out) == list(range(100, 108))


def test_replica_pool_timeout_names_waves_and_frees(pkg):
    pkg.core.init(num_nodes=3, workers_per_node=2)
    block = threading.Event()
    response_cls = pkg.engine.Response

    class StuckEngine:
        def serve(self, requests, max_wave=8):
            block.wait(10)
            return [response_cls(r.request_id, [0], 0.0) for r in requests]

    pool = pkg.engine.ReplicaPool(StuckEngine, num_replicas=1)
    try:
        with pytest.raises(TimeoutError) as ei:
            pool.serve([pkg.engine.Request(0, prompt=[1, 2])], timeout=0.3)
        msg = str(ei.value)
        assert "replica0" in msg and "freed" in msg
        assert pool._wave_meta == {}  # abandoned wave books are cleared
    finally:
        block.set()


# ------------------------------------- the port's FrontDoor over its engine

def test_frontdoor_over_the_engine_gives_the_jax_greedy_tokens():
    """12 requests of `load.poisson_trace` (seed 0) through the port's
    FrontDoor over two replicas of the port's engine on the CPU (stablelm
    smoke widths, 2 layers, fp32, JAX's init carried over): each response
    is the JAX engine's `generate` of the same prompt."""
    from repro_torch import core
    from repro_torch.serving import load
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.frontdoor import FrontDoor

    jcfg = get_smoke_config("stablelm-1.6b").scaled(param_dtype="float32")
    assert jcfg.num_layers == 2
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = torch_smoke_config("stablelm-1.6b").scaled(param_dtype="float32")
    model = build_model(tcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    max_new = 6
    max_seq = max(load.LENGTH_BUCKETS) + max_new + 4
    trace = load.poisson_trace(20.0, 2.0, seed=0,
                               max_new_tokens=max_new)[:12]
    assert len(trace) == 12
    requests = [r for _, r in load.materialize(trace, seed=0,
                                               vocab=tcfg.vocab_size - 1)]

    core.init(num_nodes=2, workers_per_node=2)
    try:
        fd = FrontDoor(lambda: ServingEngine(model, params, max_seq=max_seq,
                                             device="cpu"),
                       num_replicas=2, default_deadline_s=120.0,
                       max_batch=2, resources={"cpu": 0.25})
        try:
            tickets = [fd.submit_request(r) for r in requests]
            got = [t.result(timeout=120) for t in tickets]
            st = fd.stats()
        finally:
            fd.close()
    finally:
        core.shutdown()
        _drain_threads()
    assert st["completed_ok"] == 12 and st["dispatched_past_deadline"] == 0

    jax_engine = JaxServingEngine(jm, jp, max_seq=max_seq)
    for req, resp in zip(requests, got):
        assert resp.request_id == req.request_id
        want = jax_engine.generate(req.prompt, max_new)
        assert resp.tokens == want, req.request_id
        assert len(resp.tokens) == max_new


def test_serve_llm_runs_on_the_cpu(capsys):
    from repro_torch.serving import serve_llm
    assert serve_llm.main(["--device", "cpu", "--duration", "1",
                           "--rate", "10"]) == 0
    out = capsys.readouterr().out
    assert "dispatched_past_deadline=0" in out and "goodput=" in out
    _drain_threads()


def test_serve_llm_defaults_to_the_card(monkeypatch):
    """Without a card the entry point raises; it never drops to the CPU."""
    from repro_torch.serving import serve_llm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_llm.main([])
    args = serve_llm.parse_args([])
    assert (args.arch, args.rate, args.duration, args.deadline_ms,
            args.max_new, args.replicas, args.seed, args.full,
            args.device) == ("stablelm-1.6b", 20.0, 3.0, 2000.0, 8, 2, 0,
                             False, None)
