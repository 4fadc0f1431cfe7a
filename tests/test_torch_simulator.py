"""The port's discrete-event simulator (`repro_torch.core.simulator`)
against the reference's (`repro.core.simulator`): each scenario, run
through both packages on the same arguments, returns equal dicts, exactly;
then the reference's `ClusterSim` tests run on both packages, and each
gives the same virtual times on both."""
import importlib
import json

import pytest

PACKAGES = ["repro", "repro_torch"]


def _sim(name):
    return importlib.import_module(f"{name}.core.simulator")


@pytest.fixture(params=PACKAGES)
def sim_mod(request):
    return _sim(request.param)


SCENARIOS = [
    ("streaming_drift", dict(num_batches=240, drift_at=120, seed=42)),
    ("serving_diurnal", {}),
    ("heterogeneous_fleet", {}),
    ("chaos_mass_failure", dict(num_nodes=100, kill_fraction=0.3,
                                num_tasks=1500, seed=0)),
    ("chaos_rolling_restart", dict(num_nodes=50, num_tasks=1500, seed=0)),
    ("chaos_mass_failure", dict(num_nodes=20, kill_fraction=0.5,
                                num_tasks=500, seed=1, max_task_attempts=1)),
    ("heterogeneous_fleet", dict(num_cpu=10, num_gpu=3, num_tasks=400,
                                 seed=7, kernel_s=2.5e-4)),
]


@pytest.mark.parametrize("name,kwargs", SCENARIOS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCENARIOS)])
def test_scenario_equals_the_reference(name, kwargs):
    want = getattr(_sim("repro"), name)(**kwargs)
    got = getattr(_sim("repro_torch"), name)(**kwargs)
    assert got == want


def test_scenarios_take_the_same_costs():
    """A `SimCosts` of the port's drives its scenarios as the reference's
    same costs drive the reference's."""
    costs = dict(kernel_step_s=3.7e-4, actor_call_s=4e-5,
                 graph_dispatch_s=6e-5)
    ref, port = _sim("repro"), _sim("repro_torch")
    assert (port.heterogeneous_fleet(num_tasks=800,
                                     costs=port.SimCosts(**costs))
            == ref.heterogeneous_fleet(num_tasks=800,
                                       costs=ref.SimCosts(**costs)))


def _finishes(sim):
    return sorted((t.task_id, t.node, t.attempts, t.start_t, t.finish_t)
                  for t in sim.finished)


def _actor_lanes(mod):
    sim = mod.ClusterSim(4, workers_per_node=2, seed=0)
    a = sim.create_actor()
    for i in range(30):
        sim.submit_actor_call(a, duration_s=0.001, at=i * 0.0001)
    sim.kill_node(sim.actors[a].node_id, at=0.005)
    sim.run()
    return sim, a


def test_simulator_actor_lanes(sim_mod):
    sim, a = _actor_lanes(sim_mod)
    calls = [t for t in sim.finished if t.actor_id == a]
    assert len(calls) == 30                      # every call survives
    assert sim.failures_replayed > 0             # the kill forced replays
    finishes = [t.finish_t for t in calls]
    assert finishes == sorted(finishes)          # FIFO lane
    assert sim.latency_percentiles("actor")["p50"] > 0


def _chain(mod):
    costs = mod.SimCosts()
    sim = mod.ClusterSim(num_nodes=4, workers_per_node=2, costs=costs,
                         seed=1)
    tasks = [mod.SimTask(task_id=100 + i, duration_s=1e-3, submit_node=0)
             for i in range(3)]
    sim.submit_chain(tasks, at=0.0)
    sim.run()
    return sim, tasks, costs


def test_sim_compiled_chain_dispatch(sim_mod):
    sim, tasks, costs = _chain(sim_mod)
    assert len(sim.finished) == 3
    # chained successors run back-to-back on the head's node with no
    # per-task scheduling events
    assert len({t.node for t in tasks}) == 1
    hows = [h for h, _ in sim.sched_latencies]
    assert hows.count("chain") == 2
    # one graph dispatch charge, then 3 tasks + overheads
    span = max(t.finish_t for t in tasks)
    assert span >= costs.graph_dispatch_s + 3 * 1e-3
    assert span < costs.graph_dispatch_s + 3 * (
        1e-3 + costs.worker_overhead_s + costs.gcs_op_s
        + costs.local_sched_s) + 1e-4


def test_sim_costs_calibrate_graph_dispatch(sim_mod, tmp_path):
    doc = {"runs": {"prX": {
        "submit": {"p50_us": 20.0}, "gcs_put": {"p50_us": 1.0},
        "get_done": {"p50_us": 5.0}, "e2e_local": {"p50_us": 70.0},
        "graph_step": {"compiled": {"p50_us": 120.0},
                       "eager": {"p50_us": 300.0}},
    }}, "speedup_run": "prX"}
    p = tmp_path / "bench.json"
    p.write_text(json.dumps(doc))
    costs = sim_mod.SimCosts.from_microbench(
        str(p), compute_path=str(tmp_path / "absent.json"))
    assert costs.graph_dispatch_s == pytest.approx(50e-6, rel=1e-6)


def _store(mod):
    sim = mod.ClusterSim(4, workers_per_node=2, costs=mod.SimCosts(),
                         store_capacity_bytes=10_000, seed=0)
    for i in range(400):
        sim.submit(mod.SimTask(i, 1e-3, i % 4, output_bytes=500), at=0.0)
    sim.run()
    return sim


def test_des_store_occupancy_and_eviction(sim_mod):
    sim = _store(sim_mod)
    assert len(sim.finished) == 400
    assert sim.evictions > 0
    assert all(n.store_used <= 10_000 for n in sim.nodes)


def test_simcosts_calibrate_evict_from_churn(sim_mod, tmp_path):
    doc = {"runs": {"pr4": {
        "submit": {"p50_us": 20.0}, "gcs_put": {"p50_us": 1.0},
        "get_done": {"p50_us": 5.0}, "e2e_local": {"p50_us": 70.0},
        "churn": {"reclaim_us": {"p50_us": 40.0}},
    }}, "speedup_run": "pr4"}
    p = tmp_path / "bench.json"
    p.write_text(json.dumps(doc))
    costs = sim_mod.SimCosts.from_microbench(
        str(p), compute_path=str(tmp_path / "absent.json"))
    assert costs.evict_s == pytest.approx(40e-6)


def test_simcosts_kernel_calibration(sim_mod, tmp_path):
    core_p = tmp_path / "core.json"
    comp_p = tmp_path / "compute.json"
    comp_p.write_text(
        '{"runs": {"pr9": {"kernel_task_e2e": {"p50_us": 1234.0}}},'
        ' "speedup_run": "pr9"}')
    costs = sim_mod.SimCosts.from_microbench(str(core_p),
                                             compute_path=str(comp_p))
    assert costs.kernel_step_s == pytest.approx(1234e-6)


def _elastic(mod, nodes_late):
    sim = mod.ClusterSim(4, workers_per_node=2, seed=0)
    for i in range(800):
        sim.submit(mod.SimTask(i, 5e-3, i % 4), at=0.0)
    if nodes_late:
        for _ in range(12):
            sim.add_node(2, at=0.05)
    sim.run()
    return sim


def test_des_elastic_add_increases_throughput(sim_mod):
    def end(nodes_late):
        return max(t.finish_t for t in _elastic(sim_mod, nodes_late).finished)
    assert end(True) < end(False)


def test_des_latency_percentiles_present(sim_mod):
    sim = sim_mod.ClusterSim(4, workers_per_node=2, seed=0)
    for i in range(100):
        sim.submit(sim_mod.SimTask(i, 1e-3, i % 4), at=0.0)
    sim.run()
    p = sim.latency_percentiles()
    assert set(p) == {"p50", "p90", "p99"} and p["p99"] >= p["p50"]


@pytest.mark.parametrize("program", ["actor_lanes", "chain", "store",
                                     "elastic"])
def test_cluster_sim_times_equal_the_reference(program):
    """Each ClusterSim program above gives the same tasks, nodes, attempts
    and virtual start and finish times on both packages."""
    def run(mod):
        if program == "actor_lanes":
            sim = _actor_lanes(mod)[0]
        elif program == "chain":
            sim = _chain(mod)[0]
        elif program == "store":
            sim = _store(mod)
        else:
            sim = _elastic(mod, True)
        return (_finishes(sim), sim.sched_latencies, sim.failures_replayed,
                sim.evictions)
    assert run(_sim("repro_torch")) == run(_sim("repro"))
