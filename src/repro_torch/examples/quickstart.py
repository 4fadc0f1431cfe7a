"""Quickstart: the paper's programming model in 60 lines, on the port's
runtime (`repro_torch.core`), the port of `examples/quickstart.py`. Its
tasks are numpy on the host, as in the reference; `main` returns 0 when
the value lost with its node came back by lineage replay.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
import time

import numpy as np

from repro_torch import core


def main():
    cluster = core.init(num_nodes=4, workers_per_node=2)

    # -- 1. arbitrary functions become remote tasks (R4); creation is
    #       non-blocking and returns futures (R3)
    @core.remote
    def rollout(seed):
        rng = np.random.default_rng(seed)
        time.sleep(0.01 * rng.random())              # heterogeneous tasks
        return rng.standard_normal(4)

    @core.remote
    def reduce_mean(*chunks):
        return np.mean(np.stack(chunks), axis=0)

    # -- 2. futures as arguments build an arbitrary DAG (R5)
    futures = [rollout.submit(i) for i in range(16)]
    total = reduce_mean.submit(*futures)
    print("mean of 16 rollouts:", core.get(total).round(3))

    # -- 3. wait() gives latency-budgeted dynamic control flow (R1):
    #       act on whatever finished within 8 ms, leave stragglers running
    futures = [rollout.submit(100 + i) for i in range(16)]
    done, pending = core.wait(futures, num_returns=16, timeout=0.008)
    print(f"after 8ms: {len(done)} done, {len(pending)} stragglers")

    # -- 4. compiled graphs: the same DAG shape replayed at high rate
    #       pays ONE batched control-plane round per invocation instead
    #       of one per task — bind() builds the graph lazily, compile()
    #       plans it once, execute() replays it with fresh inputs
    from repro_torch import dag
    rollouts = [rollout.bind(dag.input(i)) for i in range(4)]
    step = dag.compile(reduce_mean.bind(*rollouts))
    for gen in range(2):
        ref = step.execute(*(200 + 100 * gen + s for s in range(4)))
        print(f"compiled gen {gen}:", core.get(ref).round(3))

    # -- 5. transparent fault tolerance (R6): kill the node holding a
    #       result; lineage replay reconstructs it on get()
    ref = rollout.submit(7)
    val = core.get(ref)
    for node_id in cluster.gcs.locations(ref.id):
        cluster.kill_node(node_id)
    val2 = core.get(ref)                              # replayed
    survived = bool(np.allclose(val, val2))
    print("survived node failure:", survived)

    # -- 6. profiling (R7): every transition is in the control plane
    from repro_torch.core.profiler import summarize
    print({k: round(v, 1) for k, v in summarize(cluster.gcs).items()})
    core.shutdown()
    return 0 if survived else 1


if __name__ == "__main__":
    raise SystemExit(main())
