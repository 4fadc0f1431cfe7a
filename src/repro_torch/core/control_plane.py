"""Logically-centralized control plane (the paper's §3.2.1).

A sharded in-memory key-value store with publish-subscribe, holding ALL
system control state: the task table, object table, function table,
actor table (specs, locations, method-sequence counters, replay logs,
checkpoints), computation lineage, and the profiling event log. Every other component
(workers, schedulers, object stores) is stateless with respect to control
state and can be restarted, exactly as the paper prescribes; recovery
re-reads this store and replays lineage.

The paper uses sharded Redis; here each shard is a dict + lock + subscriber
map (no external dependency — same logical design, hash-sharded exact-match
keys, pub-sub channels). Shard count is configurable to demonstrate R2
scaling in the throughput benchmark.

Hot-path design notes (R1/R2, millisecond-latency tasks):
  * pub-sub is push-on-put — every write notifies subscribers outside the
    shard lock, so waiters (fetch/wait/dataflow gates) never poll;
  * `subscribe` returns a `Subscription` handle for O(1) removal (the
    subscriber map is keyed by token, not scanned);
  * `put_many` writes a batch of keys acquiring each shard lock at most
    once — task registration (spec + state + lineage) is one such batch;
  * the profiling event log is striped per thread (each thread appends to
    its own buffer with no lock at all), so concurrent workers never
    serialize on a single global `_events_lock`;
  * where shard lookup repeats for the same key — the subscribe/
    unsubscribe pair on every blocked fetch — the resolved shard is
    cached on the `Subscription` handle, so removal never rehashes;
  * `wait()` completions ride a dedicated completion-notify channel
    (`add_waiters`/`notify_completion`) instead of the generic object
    pub-sub: one targeted `notify()` per completion wakes exactly the
    blocked waiter thread, with no per-ref callback closures and no
    subscriber-map churn on the object shards.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# ------------------------------------------------------------------ tables

TASK_PENDING = "PENDING"
TASK_RUNNING = "RUNNING"
TASK_DONE = "DONE"
TASK_LOST = "LOST"


@dataclass
class TaskSpec:
    task_id: str
    func_name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    return_ids: Tuple[str, ...]
    resources: Dict[str, float]
    submitter_node: int
    created_ts: float = field(default_factory=time.perf_counter)
    # actor method calls: the owning actor, the method name, and the
    # control-plane-issued sequence number that totally orders this call
    # against every other call on the same actor (plain tasks: defaults)
    actor_id: Optional[str] = None
    actor_method: Optional[str] = None
    actor_seq: int = -1
    # memory-pressure placement hint (resources={"mem": nbytes} at
    # submit): expected output footprint, scored against store free
    # bytes — NOT a capacity resource (never acquired/released)
    mem_bytes: int = 0
    # compiled-graph membership: the invocation this task belongs to and
    # its node index in the compiled plan. The runtime uses these to
    # release/dispatch plan-order dependents directly (no dataflow-gate
    # pass for intra-graph edges) and to inline-chain same-node
    # dependents on the finishing worker. Plain eager tasks: defaults.
    graph_inv: Optional[str] = None
    graph_idx: int = -1
    # bounded retry / deadline policy (fn.options): replay budget for
    # failure replays and matching application exceptions (-1 = cluster
    # default), exception types the worker retries instead of storing a
    # TaskError, base backoff (attempt k waits backoff_s * 2**(k-1)
    # seconds), and a relative deadline from task creation (0 = none)
    max_retries: int = -1
    retry_exceptions: Optional[Tuple[type, ...]] = None
    backoff_s: float = 0.0
    deadline_s: float = 0.0


@dataclass
class ActorSpec:
    """A stateful actor: the class, its constructor arguments, and its
    resource footprint. Lives in the control plane's actor table so a
    restarted node (or a fresh one) can reconstruct the actor — lineage
    for state is the ctor args plus the logged method sequence."""
    actor_id: str
    class_name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    resources: Dict[str, float]
    submitter_node: int
    checkpoint_interval: int = 0
    created_ts: float = field(default_factory=time.perf_counter)


class _Shard:
    __slots__ = ("lock", "data", "subs")

    def __init__(self):
        self.lock = threading.Lock()
        self.data: Dict[str, Any] = {}
        # key -> {token: callback}; token-keyed for O(1) unsubscribe
        self.subs: Dict[str, Dict[int, Callable[[str, Any], None]]] = {}


class Subscription:
    """Handle returned by `subscribe`; pass back to `unsubscribe` for O(1)
    removal without scanning the subscriber list."""
    __slots__ = ("key", "token", "_shard")

    def __init__(self, key: str, token: int, shard: _Shard):
        self.key = key
        self.token = token
        self._shard = shard


class CompletionWaiter:
    """One blocked `wait()` call on the completion-notify channel: a
    single condition variable plus the set of object ids whose completion
    notifies have landed. `complete` issues one targeted `notify()` —
    exactly one thread ever waits on this condition."""
    __slots__ = ("cond", "done")

    def __init__(self):
        self.cond = threading.Condition()
        self.done: set = set()

    def complete(self, obj_id: str) -> None:
        with self.cond:
            self.done.add(obj_id)
            self.cond.notify()


class ControlPlane:
    """Sharded KV + pub-sub. Keys are hashed strings (exact-match only)."""

    def __init__(self, num_shards: int = 8):
        self.num_shards = num_shards
        self._shards = [_Shard() for _ in range(num_shards)]
        # completion-notify channel: striped obj_id -> [CompletionWaiter]
        self._wait_locks = [threading.Lock() for _ in range(num_shards)]
        self._wait_maps: List[Dict[str, List[CompletionWaiter]]] = [
            {} for _ in range(num_shards)]
        # per-thread event stripes: each thread owns a buffer it appends
        # to without locking (list.append is atomic under the GIL); the
        # registry lock only guards stripe creation and enumeration
        self._event_tls = threading.local()
        self._event_stripes: List[List[Tuple[float, str, str, str, dict]]] = []
        self._event_registry_lock = threading.Lock()
        self._counter = itertools.count()
        self._sub_tokens = itertools.count()
        self.failed = False  # fault-injection: the DB itself

    # -------------------------------------------------------------- kv api

    def _shard(self, key: str) -> _Shard:
        return self._shards[hash(key) % self.num_shards]

    def put(self, key: str, value: Any) -> None:
        sh = self._shard(key)
        with sh.lock:
            sh.data[key] = value
            subs = sh.subs.get(key)
            cbs = list(subs.values()) if subs else None
        if cbs:
            for cb in cbs:
                cb(key, value)

    def put_many(self, items: Iterable[Tuple[str, Any]]) -> None:
        """Write a batch of keys, acquiring each shard's lock at most once
        (one 'sharded transaction' per shard). Notifications fire after all
        locks are released, in batch order."""
        # batches are tiny (task registration is 3-4 keys): a linear scan
        # over the group list beats dict-based grouping
        grouped: List[Tuple[_Shard, List[Tuple[str, Any]]]] = []
        for key, value in items:
            sh = self._shard(key)
            for g_sh, g_kvs in grouped:
                if g_sh is sh:
                    g_kvs.append((key, value))
                    break
            else:
                grouped.append((sh, [(key, value)]))
        fired: List[Tuple[Callable, str, Any]] = []
        for sh, kvs in grouped:
            with sh.lock:
                for key, value in kvs:
                    sh.data[key] = value
                    subs = sh.subs.get(key)
                    if subs:
                        fired.extend((cb, key, value)
                                     for cb in subs.values())
        for cb, key, value in fired:
            cb(key, value)

    def update(self, key: str, fn: Callable[[Any], Any], default=None) -> Any:
        sh = self._shard(key)
        with sh.lock:
            new = fn(sh.data.get(key, default))
            sh.data[key] = new
            subs = sh.subs.get(key)
            cbs = list(subs.values()) if subs else None
        if cbs:
            for cb in cbs:
                cb(key, new)
        return new

    def get(self, key: str, default=None) -> Any:
        sh = self._shard(key)
        with sh.lock:
            return sh.data.get(key, default)

    def subscribe(self, key: str,
                  cb: Callable[[str, Any], None]) -> Subscription:
        """cb fires on every put to `key`; fires immediately if present.
        Returns a Subscription handle for O(1) unsubscribe."""
        sh = self._shard(key)
        token = next(self._sub_tokens)
        with sh.lock:
            sh.subs.setdefault(key, {})[token] = cb
            cur = sh.data.get(key)
        if cur is not None:
            cb(key, cur)
        return Subscription(key, token, sh)

    def unsubscribe(self, sub: Subscription) -> None:
        """O(1) removal via the handle `subscribe` returned; the shard
        cached on the handle means no rehash on the way out."""
        sh = sub._shard
        with sh.lock:
            entry = sh.subs.get(sub.key)
            if entry is not None:
                entry.pop(sub.token, None)
                if not entry:
                    del sh.subs[sub.key]

    # ----------------------------------------------------------- task table

    def register_task(self, spec: TaskSpec) -> None:
        """Spec + state + lineage land in one batched sharded write."""
        self.register_tasks((spec,))

    def register_tasks(self, specs: Iterable[TaskSpec],
                       extra_items: Iterable[Tuple[str, Any]] = ()
                       ) -> None:
        """Batched multi-task registration: every spec's spec + state +
        lineage keys — plus caller-supplied extras (e.g. a compiled
        graph's invocation record) — land in ONE `put_many` round,
        acquiring each shard lock at most once. A compiled graph's
        `execute()` registers its whole invocation through here, so an
        N-node graph costs one control-plane registration, not N."""
        items: List[Tuple[str, Any]] = []
        for spec in specs:
            items.append((f"task:{spec.task_id}", spec))
            items.append((f"task_state:{spec.task_id}", TASK_PENDING))
            items.extend((f"lineage:{rid}", spec.task_id)
                         for rid in spec.return_ids)
        items.extend(extra_items)
        self.put_many(items)

    def task_spec(self, task_id: str) -> Optional[TaskSpec]:
        return self.get(f"task:{task_id}")

    def set_task_state(self, task_id: str, state: str) -> None:
        self.put(f"task_state:{task_id}", state)

    def task_state(self, task_id: str) -> Optional[str]:
        return self.get(f"task_state:{task_id}")

    # --------------------------------------------------------- object table

    def add_location(self, obj_id: str, node: int) -> None:
        self.update(f"obj:{obj_id}",
                    lambda s: (s or frozenset()) | {node})
        self.notify_completion(obj_id)

    def remove_locations(self, obj_id: str, nodes) -> None:
        self.update(f"obj:{obj_id}",
                    lambda s: (s or frozenset()) - frozenset(nodes))

    def locations(self, obj_id: str) -> frozenset:
        return self.get(f"obj:{obj_id}") or frozenset()

    def notify_lost(self, obj_id: str) -> None:
        """Push-based loss notification: rewrite the (possibly empty)
        location set so blocked fetchers wake and trigger lineage replay,
        instead of discovering the loss on a polling timer."""
        self.update(f"obj:{obj_id}", lambda s: s or frozenset())

    def producing_task(self, obj_id: str) -> Optional[str]:
        return self.get(f"lineage:{obj_id}")

    # -------------------------------------------- reference counts / GC
    # Distributed reference counting lives in the object table like
    # locations do: owning ObjectRef handles hold one count each
    # (adopted at submit/put, released by __del__ or api.free); the
    # MemoryManager reclaims an object cluster-wide when its count hits
    # zero and no pending task pins it. `freed` records reclaimed ids so
    # a late fetch with no lineage to replay fails promptly.

    # refcnt keys have no subscribers by design (the reclaimer polls
    # counts it was handed, never watches them), so these specialized
    # read-modify-writes skip update()'s closure + callback collection —
    # incr_ref sits on the submit hot path.

    def incr_ref(self, obj_id: str) -> int:
        key = f"refcnt:{obj_id}"
        sh = self._shard(key)
        with sh.lock:
            v = (sh.data.get(key) or 0) + 1
            sh.data[key] = v
        return v

    def incr_refs(self, obj_ids: Iterable[str]) -> None:
        """Batched adoption: one lock pass per shard for a compiled
        invocation's sink handles (K serial `incr_ref` rounds would sit
        on the very dispatch path `register_tasks` batches)."""
        grouped: List[Tuple[_Shard, List[str]]] = []
        for oid in obj_ids:
            key = f"refcnt:{oid}"
            sh = self._shard(key)
            for g_sh, g_keys in grouped:
                if g_sh is sh:
                    g_keys.append(key)
                    break
            else:
                grouped.append((sh, [key]))
        for sh, keys in grouped:
            with sh.lock:
                for key in keys:
                    sh.data[key] = (sh.data.get(key) or 0) + 1

    def decr_ref(self, obj_id: str) -> int:
        key = f"refcnt:{obj_id}"
        sh = self._shard(key)
        with sh.lock:
            v = (sh.data.get(key) or 0) - 1
            sh.data[key] = v
        return v

    def refcount(self, obj_id: str) -> int:
        return self.get(f"refcnt:{obj_id}") or 0

    def drop_ref_key(self, obj_id: str) -> None:
        """Prune a reclaimed object's count entry: the count can never
        rise again (freed ids are never re-adopted), and a long-running
        churn loop must not accrete one key per object ever created.
        The `freed` tombstone stays — it is what makes late fetches
        fail promptly instead of hanging."""
        key = f"refcnt:{obj_id}"
        sh = self._shard(key)
        with sh.lock:
            sh.data.pop(key, None)

    def mark_freed(self, obj_id: str) -> None:
        self.put(f"freed:{obj_id}", True)

    def is_freed(self, obj_id: str) -> bool:
        return bool(self.get(f"freed:{obj_id}"))

    # ------------------------------------------ completion-notify channel

    def _wait_stripe(self, obj_id: str) -> int:
        return hash(obj_id) % self.num_shards

    def add_waiters(self, waiter: CompletionWaiter,
                    obj_ids: Iterable[str]) -> None:
        """Register one waiter for several object completions. Callers
        must re-check availability after registering: a completion that
        raced the registration fires no notify (the fast-path guard in
        `notify_completion` reads the stripe map without the lock)."""
        for oid in obj_ids:
            i = self._wait_stripe(oid)
            with self._wait_locks[i]:
                self._wait_maps[i].setdefault(oid, []).append(waiter)

    def remove_waiters(self, waiter: CompletionWaiter,
                       obj_ids: Iterable[str]) -> None:
        for oid in obj_ids:
            i = self._wait_stripe(oid)
            with self._wait_locks[i]:
                ws = self._wait_maps[i].get(oid)
                if ws is not None:
                    try:
                        ws.remove(waiter)
                    except ValueError:
                        pass
                    if not ws:
                        del self._wait_maps[i][oid]

    def notify_completion(self, obj_id: str) -> None:
        """One targeted wake per registered waiter — fired on every
        location add. The unlocked emptiness probe keeps the no-waiter
        hot path (every task-output put) at a dict read."""
        i = self._wait_stripe(obj_id)
        if not self._wait_maps[i]:
            return
        with self._wait_locks[i]:
            ws = self._wait_maps[i].get(obj_id)
            if not ws:
                return
            ws = list(ws)
        for w in ws:
            w.complete(obj_id)

    # ---------------------------------------------------------- actor table
    # All actor control state lives here (the node holding the instance is
    # stateless, per the paper's architecture): the ActorSpec, the current
    # owning node, a monotonic per-actor method-sequence counter that
    # totally orders calls from concurrent callers, the ordered log of
    # method-call task ids (replayed to rebuild state after a failure),
    # and an optional `__getstate__` checkpoint that bounds replay length.

    def register_actor(self, spec: "ActorSpec") -> None:
        self.put(f"actor:{spec.actor_id}", spec)

    def actor_spec(self, actor_id: str) -> Optional["ActorSpec"]:
        return self.get(f"actor:{actor_id}")

    def set_actor_node(self, actor_id: str, node: int) -> None:
        self.put(f"actor_node:{actor_id}", node)

    def actor_node(self, actor_id: str) -> Optional[int]:
        return self.get(f"actor_node:{actor_id}")

    def next_actor_seq(self, actor_id: str) -> int:
        """Issue the next method-sequence number for this actor. The
        control plane is the single ordering authority, so concurrent
        callers (driver + workers) get a total order their mailbox
        releases in."""
        return self.update(f"actor_seq:{actor_id}",
                           lambda v: (v or 0) + 1) - 1

    def reserve_actor_seqs(self, actor_id: str, count: int) -> int:
        """Reserve a contiguous block of `count` method-sequence numbers
        in one control-plane round and return the first. A compiled
        graph reserves every seq its plan needs per invocation up front,
        so N actor calls cost one ordering op instead of N — the block
        is totally ordered against concurrent eager callers exactly like
        individually issued seqs."""
        return self.update(f"actor_seq:{actor_id}",
                           lambda v: (v or 0) + count) - count

    def log_actor_calls(self, actor_id: str,
                        entries: List[Tuple[int, str]]) -> None:
        """Batched replay-log append: all of a compiled invocation's
        calls on one actor land under a single shard-lock acquisition
        (mirrors `log_actor_call`'s in-place O(1) append)."""
        def append(l):
            if l is None:
                return list(entries)
            l.extend(entries)
            return l
        self.update(f"actor_log:{actor_id}", append)

    def log_actor_call(self, actor_id: str, seq: int,
                       task_id: str) -> None:
        """Append a method call to the actor's replay log. Callers log
        *before* routing to the owning node's mailbox, so a call that
        races an actor restart is always either delivered or replayed.
        O(1): the list is mutated in place under the shard lock (the log
        has no subscribers); checkpointing truncates it, so a
        checkpointed actor's log stays bounded."""
        def append(l):
            if l is None:
                return [(seq, task_id)]
            l.append((seq, task_id))
            return l
        self.update(f"actor_log:{actor_id}", append)

    def actor_log(self, actor_id: str) -> Tuple[Tuple[int, str], ...]:
        """Snapshot of the (seq, task_id) replay log, oldest first by
        append order (seqs may interleave slightly under concurrent
        callers; the mailbox re-orders on delivery)."""
        return tuple(self.get(f"actor_log:{actor_id}") or ())

    def retire_actor(self, actor_id: str) -> None:
        """Mark an actor retired (planned scale-down, not failure). The
        relocation machinery consults this so a later node death never
        resurrects a retired actor via restart-with-replay."""
        self.put(f"actor_retired:{actor_id}", True)

    def actor_retired(self, actor_id: str) -> bool:
        return bool(self.get(f"actor_retired:{actor_id}"))

    def set_actor_checkpoint(self, actor_id: str, seq: int,
                             state: Any) -> None:
        """Record a `__getstate__` snapshot covering method seqs < `seq`;
        restart restores it and replays only the log tail. The covered
        log prefix is dropped — it can never be replayed again (results
        lost after this point surface as errors, not replays)."""
        self.put(f"actor_ckpt:{actor_id}", (seq, state))
        self.update(f"actor_log:{actor_id}",
                    lambda l: [e for e in (l or []) if e[0] >= seq])

    def actor_checkpoint(self, actor_id: str) -> Optional[Tuple[int, Any]]:
        return self.get(f"actor_ckpt:{actor_id}")

    # ------------------------------------------------- heartbeat table
    # Liveness beats: one key per node, rewritten by the node's beater
    # thread at the detector interval — batched in the sense that a
    # single beat covers every worker/actor thread the node hosts, and
    # nothing on the task hot path ever touches these keys. The failure
    # detector's monitor thread is the only reader. Beats skip put()'s
    # subscriber collection (nothing subscribes to them by design).

    def beat(self, node_id: int, t: float) -> None:
        key = f"hb:{node_id}"
        sh = self._shard(key)
        with sh.lock:
            sh.data[key] = t

    def heartbeat(self, node_id: int) -> Optional[float]:
        return self.get(f"hb:{node_id}")

    # ------------------------------------------------- replay counters
    # Per-task (and per-actor) failure-replay attempt counters, bounded
    # by the `max_retries` budget. They live here rather than on the
    # TaskSpec because specs in the task table are immutable and shared
    # by every replay. Written only on failure paths (lineage replay,
    # drained-node resubmit, application retries) — never on a task's
    # normal lifecycle.

    def count_replay(self, task_id: str) -> int:
        """Increment and return the replay-attempt counter (lock-only,
        like incr_ref — no subscribers, no callback collection)."""
        key = f"attempts:{task_id}"
        sh = self._shard(key)
        with sh.lock:
            v = (sh.data.get(key) or 0) + 1
            sh.data[key] = v
        return v

    def replay_count(self, task_id: str) -> int:
        return self.get(f"attempts:{task_id}") or 0

    # --------------------------------------------------------- graph table
    # Compiled task graphs (dag.py). The static plan is registered once
    # at compile; each `execute()` writes one `graph_inv:` record — the
    # epoch table — as part of its batched task registration, so the
    # control plane can answer "which invocation/epoch produced this
    # task" for debugging and replay tooling without any extra write on
    # the dispatch path.

    def register_graph(self, graph_id: str, meta: Dict[str, Any]) -> None:
        self.put(f"graph:{graph_id}", meta)

    def graph_meta(self, graph_id: str) -> Optional[Dict[str, Any]]:
        return self.get(f"graph:{graph_id}")

    def graph_invocation(self, inv_id: str) -> Optional[Dict[str, Any]]:
        """Epoch-table record one `execute()` wrote: graph id, epoch,
        node count, sink ids (rides the batched registration)."""
        return self.get(f"graph_inv:{inv_id}")

    # ------------------------------------------------------- function table

    def register_function(self, name: str, fn: Callable) -> None:
        self.put(f"func:{name}", fn)

    def function(self, name: str) -> Callable:
        fn = self.get(f"func:{name}")
        if fn is None:
            raise KeyError(f"function {name!r} not registered")
        return fn

    # ------------------------------------------------------------ profiling

    def log_event(self, kind: str, task_id: str, where: str, **extra) -> None:
        stripe = getattr(self._event_tls, "stripe", None)
        if stripe is None:
            stripe = []
            self._event_tls.stripe = stripe
            with self._event_registry_lock:
                self._event_stripes.append(stripe)
        stripe.append((time.perf_counter(), kind, task_id, where, extra))

    def events(self) -> List[Tuple[float, str, str, str, dict]]:
        with self._event_registry_lock:
            stripes = list(self._event_stripes)
        merged: List[Tuple[float, str, str, str, dict]] = []
        for stripe in stripes:
            merged.extend(stripe)
        merged.sort(key=lambda e: e[0])
        return merged

    def next_id(self, prefix: str) -> str:
        return f"{prefix}{next(self._counter)}"
