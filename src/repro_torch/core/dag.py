"""Compiled task graphs: ``bind()`` / ``compile()`` / ``execute()``.

The eager API pays one control-plane round per task: ``submit()``
registers, pins, and schedules each node of a feedback loop
individually, every iteration. The paper's R1/R2 workloads (serving
pipelines, RL loops) re-run the *same* graph shape at high rate, so the
per-request orchestration work — dependency analysis, topological
order, placement, actor ordering — can be done once and replayed:

  * ``fn.bind(*args)`` on a remote function and
    ``handle.method.bind(*args)`` on an actor method return lazy
    ``GraphNode``s instead of submitting; nodes compose into a DAG
    (other GraphNodes, ``dag.input(i)`` placeholders, ObjectRefs, and
    plain values are all legal arguments, top-level or one level inside
    a plain list/tuple — mirroring the eager dependency scan).
  * ``dag.compile(outputs)`` resolves the static structure once: the
    topological order, intra-graph dependency edges, a per-node
    placement plan (the global scheduler's ``_select_node`` scoring
    plus a graph-affinity term that keeps chains co-resident), and the
    per-actor method-call order (so each invocation can reserve one
    contiguous seq block per actor).
  * ``CompiledGraph.execute(*inputs)`` dispatches one whole invocation
    in a single batched control-plane round: fresh epoch-tagged task
    ids, one ``register_tasks`` write covering every node's spec +
    state + lineage plus the invocation's epoch-table record, one seq
    reservation + one replay-log append per actor, then grouped
    per-planned-node ``submit_ready_batch`` handoffs for the roots.
    Non-root nodes never touch the dataflow gate: the runtime holds the
    invocation's dependency counters, and a worker finishing node N
    dispatches (or inline-chains, when co-planned) the dependents whose
    last edge N satisfied.

Execution results are ordinary ``ObjectRef``s — they compose with
``get``/``wait``/``free``, actor ordering, lineage replay, and the
memory governor exactly like eager futures. Intermediate outputs are
borrows pinned for the lifetime of their consuming nodes and are
garbage-collected once the invocation's sinks complete.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.control_plane import TaskSpec


class InputNode:
    """Placeholder for the ``index``-th positional argument of
    ``CompiledGraph.execute``; create via ``dag.input(i)``."""

    __slots__ = ("index",)

    def __init__(self, index: int = 0):
        self.index = int(index)
        if self.index < 0:
            # a negative index would silently alias the LAST execute()
            # argument via Python indexing — reject it loudly instead
            raise ValueError(
                f"dag.input index must be >= 0, got {self.index}")

    def __repr__(self):
        return f"dag.input({self.index})"


def input(index: int = 0) -> InputNode:  # noqa: A001 - namespaced builtin
    return InputNode(index)


class GraphOutput:
    """One return slot of a multi-return GraphNode (``node[i]``)."""

    __slots__ = ("node", "index")

    def __init__(self, node: "GraphNode", index: int):
        self.node = node
        self.index = index


class GraphNode:
    """One lazy task (or actor method call) in an un-compiled DAG.
    Holds the callable's identity and its bound arguments; nothing is
    registered or scheduled until ``compile`` + ``execute``."""

    __slots__ = ("func_name", "fn", "num_returns", "resources",
                 "mem_bytes", "actor_handle", "actor_method",
                 "args", "kwargs", "max_retries", "retry_exceptions",
                 "backoff_s", "deadline_s")

    def __init__(self, *, func_name: str, fn=None, num_returns: int = 1,
                 resources: Optional[Dict[str, float]] = None,
                 mem_bytes: int = 0, actor_handle=None,
                 actor_method: Optional[str] = None,
                 args: Tuple[Any, ...] = (),
                 kwargs: Optional[Dict[str, Any]] = None,
                 max_retries: int = -1,
                 retry_exceptions: Optional[Tuple[type, ...]] = None,
                 backoff_s: float = 0.0, deadline_s: float = 0.0):
        self.func_name = func_name
        self.fn = fn
        self.num_returns = num_returns
        self.resources = dict(resources or {})
        self.mem_bytes = mem_bytes
        self.actor_handle = actor_handle
        self.actor_method = actor_method
        self.args = args
        self.kwargs = dict(kwargs or {})
        self.max_retries = max_retries
        self.retry_exceptions = retry_exceptions
        self.backoff_s = backoff_s
        self.deadline_s = deadline_s
        _check_bindable(self.args, self.kwargs)

    def __getitem__(self, i: int) -> GraphOutput:
        if not 0 <= i < self.num_returns:
            raise IndexError(
                f"{self.func_name} has {self.num_returns} return(s); "
                f"index {i} is out of range")
        return GraphOutput(self, i)

    def __repr__(self):
        kind = "actor" if self.actor_handle is not None else "task"
        return f"GraphNode<{kind} {self.func_name}>"


_GRAPHY = (GraphNode, GraphOutput, InputNode)


def _check_bindable(args, kwargs) -> None:
    """Graph arguments follow the same nesting rule as eager ObjectRef
    arguments: top level, or one level inside a plain list/tuple. A
    GraphNode/InputNode anywhere deeper would silently arrive as an
    unsubstituted placeholder, so reject it loudly at bind time."""
    from repro_torch.core.api import _check_no_deep_refs, _holds_graph_node
    _check_no_deep_refs(args, kwargs)
    for a in itertools.chain(args, kwargs.values()):
        if isinstance(a, _GRAPHY):
            _check_single_return(a)
            continue
        if type(a) in (list, tuple):
            for e in a:
                if isinstance(e, _GRAPHY):
                    _check_single_return(e)
                    continue
                if _holds_graph_node(e):
                    raise TypeError(
                        "GraphNode/dag.input nested more than one "
                        "container level deep in bound arguments is not "
                        "substituted; pass it at the top level or one "
                        "level inside a plain list/tuple")
        elif _holds_graph_node(a):
            raise TypeError(
                f"GraphNode/dag.input inside a {type(a).__name__} "
                "argument is not substituted; pass it at the top level "
                "or one level inside a plain list/tuple")


def _check_single_return(a) -> None:
    """A multi-return GraphNode passed bare as an argument would be
    silently substituted as its first return slot — reject it like
    compile() outputs are, forcing an explicit ``node[i]``."""
    if isinstance(a, GraphNode) and a.num_returns != 1:
        raise TypeError(
            f"{a.func_name} has {a.num_returns} returns; select one "
            "with node[i] when binding it as an argument")


class _PlanNode:
    """Compile-time state for one graph node: identity, dependency
    edges, and the static placement decision."""

    __slots__ = ("idx", "gnode", "deps", "dependents", "planned")

    def __init__(self, idx: int, gnode: GraphNode):
        self.idx = idx
        self.gnode = gnode
        self.deps: List[int] = []            # intra-graph edges (in)
        self.dependents: List[int] = []      # plain-task edges (out)
        self.planned: Optional[int] = None   # node_id from the plan


class _GraphInvocation:
    """Runtime state of one ``execute()``: per-node pending-dependency
    counters the workers decrement as plan-order edges are satisfied.
    Lives in ``Cluster._graph_invs`` until every node completes."""

    __slots__ = ("inv_id", "specs", "pending", "dependents", "planned",
                 "remaining", "done", "lock", "sink_ids", "externals")

    def __init__(self, inv_id: str, specs: List[TaskSpec],
                 pending: List[int], dependents: List[List[int]],
                 planned: List[Optional[int]], sink_ids: List[str],
                 externals: List[List[str]]):
        self.inv_id = inv_id
        self.specs = specs
        self.pending = pending
        self.dependents = dependents
        self.planned = planned
        self.remaining = len(specs)
        self.done: set = set()
        self.lock = threading.Lock()
        self.sink_ids = sink_ids
        # per-node ids of dependencies *outside* the graph (eager
        # futures bound or passed as inputs): intra-graph edges are
        # satisfied by plan order, but these may still be pending at
        # dispatch time and need a dataflow-gate pass
        self.externals = externals


def compile(outputs) -> "CompiledGraph":  # noqa: A001 - namespaced
    """Resolve a DAG of GraphNodes into a reusable ``CompiledGraph``.
    `outputs` is one GraphNode/GraphOutput or a list/tuple of them; the
    corresponding ObjectRefs are what each ``execute()`` returns."""
    single = isinstance(outputs, _GRAPHY[:2])
    out_list = [outputs] if single else list(outputs)
    if not out_list:
        raise ValueError("compile() needs at least one output node")
    for o in out_list:
        if isinstance(o, GraphNode):
            if o.num_returns != 1:
                raise TypeError(
                    f"{o.func_name} has {o.num_returns} returns; select "
                    "one with node[i] when using it as a compile output")
        elif not isinstance(o, GraphOutput):
            raise TypeError(f"compile() outputs must be GraphNodes, "
                            f"got {type(o).__name__}")
    return CompiledGraph(out_list, single)


class CompiledGraph:
    """A reusable, pre-planned task graph. Thread-compatible: each
    ``execute()`` builds fresh epoch-tagged specs, so one compiled plan
    can serve a high-rate loop."""

    def __init__(self, outputs: List, single_output: bool):
        from repro_torch.core.api import _cluster
        self._cluster = _cluster()
        self._cluster_epoch = self._cluster.epoch
        self._single = single_output
        gcs = self._cluster.gcs
        self.graph_id = gcs.next_id("cg")
        self._epochs = itertools.count()

        # -- topological order (post-order DFS from the outputs).
        # The index map is keyed by object identity so GraphNodes stay
        # shareable between separately compiled graphs; the map is kept
        # on the CompiledGraph (never stamped on the nodes).
        self.nodes: List[_PlanNode] = []
        index: Dict[int, int] = {}           # id(GraphNode) -> plan idx
        self._index = index

        def visit(root: GraphNode) -> None:
            # iterative post-order (an explicit stack): deep pipelines
            # are exactly the shape this API targets, so the plan walk
            # must not hit Python's recursion limit
            stack: List[Tuple[GraphNode, bool]] = [(root, False)]
            while stack:
                g, expanded = stack.pop()
                if id(g) in index:
                    continue
                if expanded:
                    index[id(g)] = len(self.nodes)
                    self.nodes.append(_PlanNode(len(self.nodes), g))
                else:
                    stack.append((g, True))
                    # reversed so pop order matches recursive DFS: the
                    # first-bound dependency gets the lower plan index
                    # (plan order IS actor seq order — it must not
                    # depend on stack mechanics)
                    stack.extend((dep, False)
                                 for dep in reversed(_graph_deps(g)))

        for o in outputs:
            visit(o.node if isinstance(o, GraphOutput) else o)
        self._outputs: List[Tuple[int, int]] = [
            (index[id(o.node)], o.index) if isinstance(o, GraphOutput)
            else (index[id(o)], 0) for o in outputs]

        # -- edges and input arity
        self.n_inputs = 0
        for pn in self.nodes:
            deps = set()
            for a in _flat_args(pn.gnode):
                if isinstance(a, (GraphNode, GraphOutput)):
                    g = a.node if isinstance(a, GraphOutput) else a
                    deps.add(index[id(g)])
                elif isinstance(a, InputNode):
                    self.n_inputs = max(self.n_inputs, a.index + 1)
            pn.deps = sorted(deps)
            for d in pn.deps:
                # only plain-task dependents are gate-dispatched by the
                # runtime; actor calls are mailbox-delivered up front
                # and self-order via their reserved seq block
                if pn.gnode.actor_handle is None:
                    self.nodes[d].dependents.append(pn.idx)

        # -- per-actor call order (plan order == seq order)
        self._actor_calls: Dict[str, List[int]] = {}
        for pn in self.nodes:
            h = pn.gnode.actor_handle
            if h is not None:
                self._actor_calls.setdefault(h.actor_id, []).append(pn.idx)

        # -- register functions once (actor classes were registered at
        #    ActorClass.submit) and run the static placement pass
        for pn in self.nodes:
            if pn.gnode.fn is not None:
                gcs.register_function(pn.gnode.func_name, pn.gnode.fn)
        self._plan_placement()
        gcs.register_graph(self.graph_id, {
            "nodes": len(self.nodes),
            "actors": sorted(self._actor_calls),
            "planned": [pn.planned for pn in self.nodes],
            "n_inputs": self.n_inputs,
        })
        gcs.log_event("graph_compile", self.graph_id, "driver",
                      nodes=len(self.nodes), inputs=self.n_inputs)

    # ------------------------------------------------------------ planning

    def _plan_placement(self) -> None:
        """One `_select_node` pass per plain-task node, in topo order.
        External ObjectRef args count toward locality via the template
        spec; a graph-affinity bonus pulls a node toward where its
        dependencies were planned, so chains co-reside and the worker's
        inline chaining applies. Actor calls carry no plan — they route
        to the owning node's mailbox like eager method calls."""
        gs = self._cluster.global_scheduler
        from repro_torch.core.api import ObjectRef
        for pn in self.nodes:
            g = pn.gnode
            if g.actor_handle is not None:
                continue
            template = TaskSpec(
                task_id=f"{self.graph_id}.plan{pn.idx}",
                func_name=g.func_name,
                args=tuple(a for a in g.args if isinstance(a, ObjectRef)),
                kwargs={}, return_ids=(), resources=g.resources,
                submitter_node=0, mem_bytes=g.mem_bytes)
            affinity: Dict[int, float] = {}
            for d in pn.deps:
                planned = self.nodes[d].planned
                if planned is not None:
                    affinity[planned] = affinity.get(planned, 0.0) + 8192.0
            pn.planned = gs.plan_node(template, affinity)

    # ------------------------------------------------------------- execute

    def execute(self, *inputs):
        """Dispatch one invocation of the compiled plan. Returns the
        sink ObjectRef(s) immediately (non-blocking, like submit)."""
        from repro_torch.core import api
        cluster = api._cluster()
        if (cluster is not self._cluster
                or cluster.epoch != self._cluster_epoch):
            raise RuntimeError(
                "CompiledGraph was compiled against a different cluster; "
                "recompile after init()")
        if len(inputs) != self.n_inputs:
            # exact-arity like a plain call: surplus inputs silently
            # dropped would mask stale call sites after a graph edit
            raise TypeError(
                f"execute() takes exactly {self.n_inputs} input(s) "
                f"(highest dag.input index + 1); got {len(inputs)}")
        gcs = cluster.gcs
        mm = cluster.memory
        epoch = next(self._epochs)
        inv_id = f"{self.graph_id}.e{epoch}"

        # -- substitute every node's arguments FIRST: this is the only
        #    step that can reject bad inputs, and it must fail before
        #    any control-plane state moves — reserving actor seqs ahead
        #    of a substitution error would leave undeliverable gaps
        #    that wedge the actors' FIFO mailboxes forever. The
        #    substituter records each ref it emits so pinning needs no
        #    second argument scan.
        bound: List[Tuple[Tuple[Any, ...], Dict[str, Any]]] = []
        pin_ids: List[List[str]] = []
        sub = _Substituter(inv_id, inputs, api.ObjectRef, self._index)
        for pn in self.nodes:
            sub.ref_ids = []
            bound.append((tuple(sub(a) for a in pn.gnode.args),
                          {k: sub(v)
                           for k, v in pn.gnode.kwargs.items()}))
            pin_ids.append(sub.ref_ids)

        # -- reserve each actor's contiguous seq block (one ordering op
        #    per actor, assigned in plan order)
        seqs: Dict[int, int] = {}
        for actor_id, idxs in self._actor_calls.items():
            start = gcs.reserve_actor_seqs(actor_id, len(idxs))
            for k, idx in enumerate(idxs):
                seqs[idx] = start + k

        # -- build every node's spec with epoch-tagged ids
        specs: List[TaskSpec] = []
        for pn, (args, kwargs) in zip(self.nodes, bound):
            g = pn.gnode
            task_id = f"{inv_id}.n{pn.idx}"
            h = g.actor_handle
            specs.append(TaskSpec(
                task_id=task_id, func_name=g.func_name, args=args,
                kwargs=kwargs,
                return_ids=tuple(f"{task_id}.r{j}"
                                 for j in range(g.num_returns)),
                resources={} if h is not None else g.resources,
                submitter_node=(pn.planned
                                if h is None and pn.planned is not None
                                else 0),
                mem_bytes=g.mem_bytes,
                actor_id=None if h is None else h.actor_id,
                actor_method=g.actor_method,
                actor_seq=seqs.get(pn.idx, -1),
                graph_inv=inv_id, graph_idx=pn.idx,
                max_retries=g.max_retries,
                retry_exceptions=g.retry_exceptions,
                backoff_s=g.backoff_s, deadline_s=g.deadline_s))

        # -- adopt sink handles before anything can run (a worker
        #    finishing first must not hand a sink to the reclaimer),
        #    then pin every node's ref args for its pending lifetime
        refs = [api.ObjectRef(f"{inv_id}.n{i}.r{j}")
                for i, j in self._outputs]
        mm.adopt_all(refs)
        mm.pin_tasks_with_ids(
            (spec.task_id, ids) for spec, ids in zip(specs, pin_ids))

        # -- ONE batched control-plane registration for the whole
        #    invocation: every spec + state + lineage key, plus the
        #    epoch-table record
        gcs.register_tasks(specs, extra_items=(
            (f"graph_inv:{inv_id}", {"graph": self.graph_id,
                                     "epoch": epoch,
                                     "nodes": len(specs),
                                     "sinks": [r.id for r in refs]}),))
        for spec in specs:
            if spec.deadline_s:
                cluster.detector.track_deadline(spec)

        # -- one batched replay-log append per actor (logged BEFORE any
        #    mailbox routing, like eager calls: a call racing an actor
        #    restart is either delivered or replayed, never lost)
        for actor_id, idxs in self._actor_calls.items():
            gcs.log_actor_calls(
                actor_id,
                [(seqs[idx], f"{inv_id}.n{idx}") for idx in idxs])

        # -- install the invocation's dependency counters before any
        #    dispatch (a finishing worker consults them immediately)
        prefix = f"{inv_id}.n"
        cluster.graph_register_invocation(_GraphInvocation(
            inv_id, specs,
            pending=[len(pn.deps) for pn in self.nodes],
            dependents=[list(pn.dependents) for pn in self.nodes],
            planned=[pn.planned for pn in self.nodes],
            sink_ids=[r.id for r in refs],
            externals=[[rid for rid in ids
                        if not rid.startswith(prefix)]
                       for ids in pin_ids]))
        gcs.log_event("graph_execute", inv_id, "driver",
                      graph=self.graph_id, epoch=epoch, nodes=len(specs),
                      registrations=1)

        # -- dispatch: actor calls are mailbox-delivered up front (the
        #    mailbox releases them in reserved-seq order; argument
        #    futures resolve via fetch exactly like eager method calls);
        #    plain roots go out in grouped per-planned-node batches
        by_node: Dict[Optional[int], List[TaskSpec]] = {}
        for pn, spec in zip(self.nodes, specs):
            if spec.actor_id is not None:
                gcs.log_event("submit_actor", spec.task_id, "driver",
                              actor=spec.actor_id, seq=spec.actor_seq)
                cluster.submit_actor_task(spec)
            elif not pn.deps:
                by_node.setdefault(pn.planned, []).append(spec)
        for planned, group in by_node.items():
            cluster.graph_dispatch_roots(planned, group)
        return refs[0] if self._single else refs


class _Substituter:
    """Replace bind-time placeholders with invocation-time values:
    GraphNode/GraphOutput -> borrowed ObjectRef of the producing node's
    epoch-tagged return id; InputNode -> the execute() argument (refs
    borrowed); eager ObjectRef -> borrow. Applies one level inside
    plain list/tuple, mirroring the eager dependency scan."""

    __slots__ = ("inv_id", "inputs", "ObjectRef", "index", "ref_ids")

    def __init__(self, inv_id: str, inputs: Sequence[Any], ref_cls,
                 index: Dict[int, int]):
        self.inv_id = inv_id
        self.inputs = inputs
        self.ObjectRef = ref_cls
        self.index = index
        # every ref emitted for the current node's arguments — the
        # exact set `_ref_ids` would later rediscover, collected here so
        # pinning skips the re-scan
        self.ref_ids: List[str] = []

    def __call__(self, a, depth: int = 0):
        R = self.ObjectRef
        if isinstance(a, GraphNode):
            rid = f"{self.inv_id}.n{self.index[id(a)]}.r0"
            self.ref_ids.append(rid)
            return R(rid)
        if isinstance(a, GraphOutput):
            rid = (f"{self.inv_id}.n{self.index[id(a.node)]}"
                   f".r{a.index}")
            self.ref_ids.append(rid)
            return R(rid)
        if isinstance(a, InputNode):
            return self._input_value(self.inputs[a.index], depth)
        if isinstance(a, R):
            self.ref_ids.append(a.id)
            return R(a.id)                       # borrow
        if depth == 0 and type(a) in (list, tuple) and any(
                isinstance(e, _GRAPHY + (R,)) for e in a):
            return type(a)(self(e, 1) for e in a)
        return a

    def _input_value(self, v, depth: int):
        """An execute() argument lands in the (immortal) task table, so
        it must follow the same rules as eager submit args: ObjectRefs —
        top-level or one level inside a plain list/tuple — become
        borrows (never the caller's owning handles) and are recorded
        for pinning/gating; refs nested deeper are rejected loudly,
        exactly like ``_check_no_deep_refs`` does at submit time."""
        R = self.ObjectRef
        if isinstance(v, R):
            self.ref_ids.append(v.id)
            return R(v.id)
        if type(v) in (list, tuple) and any(isinstance(e, R) for e in v):
            if depth:
                raise TypeError(
                    "execute() input holding ObjectRefs was bound inside "
                    "a container — the refs would nest deeper than "
                    "argument resolution reaches; pass the input at the "
                    "top level of bind()")
            out = []
            for e in v:
                if isinstance(e, R):
                    self.ref_ids.append(e.id)
                    out.append(R(e.id))
                else:
                    out.append(e)
            return type(v)(out)
        if isinstance(v, (list, tuple, dict, set, frozenset)):
            from repro_torch.core.api import _holds_ref
            if _holds_ref(v):
                raise TypeError(
                    "ObjectRef nested more than one container level deep "
                    "in an execute() input is not resolved; pass it at "
                    "the top level or one level inside a plain "
                    "list/tuple")
        return v


def _graph_deps(g: GraphNode) -> List[GraphNode]:
    deps = []
    for a in _flat_args(g):
        if isinstance(a, GraphNode):
            deps.append(a)
        elif isinstance(a, GraphOutput):
            deps.append(a.node)
    return deps


def _flat_args(g: GraphNode):
    for a in itertools.chain(g.args, g.kwargs.values()):
        if type(a) in (list, tuple):
            yield from a
        else:
            yield a
