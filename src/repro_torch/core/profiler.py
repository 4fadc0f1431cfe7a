"""Debugging & profiling (R7): every state transition lands in the control
plane's event log; this module turns it into task timelines and summaries.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from repro_torch.core.control_plane import ControlPlane


def task_timeline(gcs: ControlPlane) -> Dict[str, List]:
    """task_id -> ordered [(t, kind, where)] transitions."""
    out: Dict[str, List] = defaultdict(list)
    for t, kind, task_id, where, extra in gcs.events():
        out[task_id].append((t, kind, where, extra))
    for v in out.values():
        v.sort()
    return out


def summarize(gcs: ControlPlane) -> Dict[str, float]:
    """Aggregate scheduling + memory-governance + compiled-graph metrics
    from the event log. The eviction/reclaim counters come from the data
    plane's event kinds: ``evict`` (LRU eviction under store pressure,
    with the freed byte count), ``reclaim`` (refcount-zero GC
    collection), and ``reconstruct`` events tagged ``after_evict``
    (lineage replay repairing an evicted-but-still-referenced object).
    Graph counters come from the dag layer: ``graph_compile`` (plans
    built), ``graph_execute`` (invocations, each carrying the size of
    its single batched registration), and ``graph_chain`` (dependents
    executed inline on the finishing worker, never re-entering the
    scheduler). Failure-hardening counters come from the detector and
    retry machinery: ``node_failure`` (fail-stops, however triggered),
    ``detector_kill`` / ``watchdog_kill`` (failures the heartbeat
    monitor / hung-task watchdog declared), ``retry`` (policy-driven
    exception retries), ``task_unrecoverable`` / ``task_deadline``
    (tasks sealed by budget exhaustion / deadline expiry),
    ``actor_unrecoverable`` (actors past their restart budget), and
    ``chaos`` (injected fault events). Serving counters come from the
    front door's control loop (repro_torch.serving.frontdoor): ``serve_admit``
    / ``serve_reject`` (admission control), ``serve_shed`` (deadline
    shedding), ``serve_wave`` (dispatched waves, with sizes for the mean
    wave width), ``serve_retry`` (re-enqueues after replica failure),
    ``serve_scale_up`` / ``serve_scale_down`` / ``serve_spare``
    (autoscaler decisions), and ``actor_retired`` (planned actor
    scale-down via Cluster.retire_actor). Compute-plane counters come
    from the device-typed kernel path (repro_torch.compute): ``kernel``
    (kernel-task executions, with on-device milliseconds for the mean),
    ``device_wait`` (tasks that stalled for a busy device grant),
    ``task_unschedulable`` (tasks sealed because no declared node can
    ever satisfy their resources), and ``param_publish`` (ParamSet
    versions published, with their total shard bytes). Streaming-plane
    counters come from the train-while-serve loop (not in this package yet):
    ``stream_batch`` (mini-batches produced into the object store),
    ``drift`` (detector fires),
    ``learner_reset`` (drift-triggered model resets), and
    ``weight_swap`` (serving replicas hot-swapping to a newer ParamSet
    version between waves, each carrying ``lag`` — the version jump —
    whose mean is ``swap_version_lag_mean``)."""
    raw = gcs.events()
    tl: Dict[str, List] = defaultdict(list)
    evictions = reclaims = reconstructs_after_evict = 0
    bytes_freed = 0
    graph_compiles = graph_invocations = graph_chained = 0
    graph_batched_tasks = 0
    node_failures = detector_kills = watchdog_kills = 0
    retries = unrecoverable = deadline_expired = 0
    actor_unrecoverable = chaos_events = 0
    serve_admitted = serve_rejected = serve_shed = serve_retries = 0
    serve_waves = serve_wave_requests = 0
    serve_scale_ups = serve_scale_downs = serve_spares = 0
    actors_retired = 0
    kernel_tasks = device_waits = unschedulable = param_publishes = 0
    kernel_ms_total = 0.0
    param_bytes = 0
    stream_batches = drift_events = weight_swaps = learner_resets = 0
    swap_lag_total = 0
    for t, kind, task_id, where, extra in raw:
        tl[task_id].append((t, kind, where, extra))
        if kind == "evict":
            evictions += 1
            bytes_freed += extra.get("bytes", 0)
        elif kind == "reclaim":
            reclaims += 1
            bytes_freed += extra.get("bytes", 0)
        elif kind == "reconstruct" and extra.get("after_evict"):
            reconstructs_after_evict += 1
        elif kind == "graph_compile":
            graph_compiles += 1
        elif kind == "graph_execute":
            graph_invocations += 1
            graph_batched_tasks += extra.get("nodes", 0)
        elif kind == "graph_chain":
            graph_chained += 1
        elif kind == "node_failure":
            node_failures += 1
        elif kind == "detector_kill":
            detector_kills += 1
        elif kind == "watchdog_kill":
            watchdog_kills += 1
        elif kind == "retry":
            retries += 1
        elif kind == "task_unrecoverable":
            unrecoverable += 1
        elif kind == "task_deadline":
            deadline_expired += 1
        elif kind == "actor_unrecoverable":
            actor_unrecoverable += 1
        elif kind == "chaos":
            chaos_events += 1
        elif kind == "serve_admit":
            serve_admitted += 1
        elif kind == "serve_reject":
            serve_rejected += 1
        elif kind == "serve_shed":
            serve_shed += 1
        elif kind == "serve_retry":
            serve_retries += 1
        elif kind == "serve_wave":
            serve_waves += 1
            serve_wave_requests += extra.get("size", 0)
        elif kind == "serve_scale_up":
            serve_scale_ups += 1
        elif kind == "serve_scale_down":
            serve_scale_downs += 1
        elif kind == "serve_spare":
            serve_spares += 1
        elif kind == "actor_retired":
            actors_retired += 1
        elif kind == "kernel":
            kernel_tasks += 1
            kernel_ms_total += extra.get("ms", 0.0)
        elif kind == "device_wait":
            device_waits += 1
        elif kind == "task_unschedulable":
            unschedulable += 1
        elif kind == "param_publish":
            param_publishes += 1
            param_bytes += extra.get("bytes", 0)
        elif kind == "stream_batch":
            stream_batches += 1
        elif kind == "drift":
            drift_events += 1
        elif kind == "weight_swap":
            weight_swaps += 1
            swap_lag_total += extra.get("lag", 0)
        elif kind == "learner_reset":
            learner_resets += 1
    submit_to_start, run_times, spills, locals_ = [], [], 0, 0
    for task_id, events in tl.items():
        events.sort()
        kinds = {k: t for t, k, _, _ in events}
        if "submit" in kinds and "start" in kinds:
            submit_to_start.append(kinds["start"] - kinds["submit"])
        if "start" in kinds and "finish" in kinds:
            run_times.append(kinds["finish"] - kinds["start"])
        spills += any(k == "spill" for _, k, _, _ in events)
        locals_ += any(k == "sched_local" for _, k, _, _ in events)

    def pct(xs, q):
        if not xs:
            return 0.0
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    return {
        "num_tasks": len(tl),
        "sched_latency_p50_us": pct(submit_to_start, 0.5) * 1e6,
        "sched_latency_p99_us": pct(submit_to_start, 0.99) * 1e6,
        "task_runtime_p50_ms": pct(run_times, 0.5) * 1e3,
        "spill_fraction": spills / max(len(tl), 1),
        "local_fraction": locals_ / max(len(tl), 1),
        "evictions": evictions,
        "reclaims": reclaims,
        "bytes_freed": float(bytes_freed),
        "reconstruct_after_evict": reconstructs_after_evict,
        "graph_compiles": graph_compiles,
        "graph_invocations": graph_invocations,
        "graph_batched_tasks_mean": (graph_batched_tasks
                                     / max(graph_invocations, 1)),
        "graph_inline_chained": graph_chained,
        "node_failures": node_failures,
        "detector_kills": detector_kills,
        "watchdog_kills": watchdog_kills,
        "retries": retries,
        "tasks_unrecoverable": unrecoverable,
        "tasks_deadline_expired": deadline_expired,
        "actors_unrecoverable": actor_unrecoverable,
        "chaos_events": chaos_events,
        "serve_admitted": serve_admitted,
        "serve_rejected": serve_rejected,
        "serve_shed": serve_shed,
        "serve_retries": serve_retries,
        "serve_waves": serve_waves,
        "serve_wave_size_mean": (serve_wave_requests
                                 / max(serve_waves, 1)),
        "serve_scale_ups": serve_scale_ups,
        "serve_scale_downs": serve_scale_downs,
        "serve_spares": serve_spares,
        "actors_retired": actors_retired,
        "kernel_tasks": kernel_tasks,
        "kernel_time_ms_mean": kernel_ms_total / max(kernel_tasks, 1),
        "device_waits": device_waits,
        "tasks_unschedulable": unschedulable,
        "param_publishes": param_publishes,
        "param_bytes": float(param_bytes),
        "stream_batches": stream_batches,
        "drift_events": drift_events,
        "weight_swaps": weight_swaps,
        "swap_version_lag_mean": swap_lag_total / max(weight_swaps, 1),
        "learner_resets": learner_resets,
    }


def dump_chrome_trace(gcs: ControlPlane, path: str) -> None:
    """Chrome trace-event JSON for chrome://tracing inspection."""
    import json
    events = []
    for t, kind, task_id, where, extra in gcs.events():
        events.append({"name": f"{kind}:{task_id}", "ph": "i",
                       "ts": t * 1e6, "pid": where, "tid": where,
                       "args": dict(extra)})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
