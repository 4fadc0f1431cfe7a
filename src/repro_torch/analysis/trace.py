"""A cost trace of a program on the `meta` device: the port of
`repro.analysis.hlo`.

The reference compiles its step with XLA and reads the roofline terms off
the optimized HLO. The port runs eagerly, so its program is the sequence of
aten ops it dispatches: `analyze_trace(fn, *args)` runs `fn` on meta
tensors (shapes and dtypes, no data, no device) under a
`TorchDispatchMode` that sees every op, the backward's and the
recomputation's included, and counts:

  * FLOPs      - products exactly, 2 x result x contracted (`mm`, `bmm`,
                 `addmm`, `baddbmm`), as `hlo._dot_flops` counts dots
                 (the port has no convolution); ops tagged pointwise or
                 reduction at 1 a result
                 element, as `hlo` counts elementwise and reduce ops
                 (copies and casts count none).
  * HBM bytes  - every op's tensor inputs and outputs, each at its logical
                 size (numel x element size), views excepted. In eager mode
                 every op materializes, so this is the traffic of the
                 port's program, not of a fused one.
  * kernels    - each call of a kernel wrapper on `meta` records one call
                 and its `cost` (the wrapper's own formula of its useful
                 FLOPs, bytes and, for ssm_scan, exps); the kernel's FLOPs
                 and bytes are added to the totals above.
  * peak bytes - the largest sum, over the trace, of live storages that the
                 trace created (an output's storage is live until every
                 tensor on it is released, autograd's saved tensors
                 included); the arguments' storages are not counted.
  * collectives - under sharding rules (`parallel.sharding`), by the plan,
                 with the ring model of `hlo._collective_transfer`, so a
                 byte means the same thing in both records:
                 - a parameter leaf sharded over the FSDP axes is
                   all-gathered over them at each use by a compute op of
                   a train or prefill step, the backward's included
                   (ZeRO-3 gathers again for it); the optimizer's reads
                   (`not_a_use`) and casts, copies and in-place updates
                   gather nothing; a decode step gathers only the
                   embedding table, whole, for its lookup (its products
                   keep their weights in place and move the one token's
                   activations, which are not counted), as XLA plans the
                   reference's decode;
                 - at each residual-stream constraint (`constrain_act`,
                   "btd"), the partial sums a row-parallel product leaves
                   over `model` are all-reduced, or under Megatron-SP
                   reduce-scattered and all-gathered again before the next
                   column-parallel product;
                 - at the "enc_in" constraint (the encoder's input,
                   `frame_proj`'s column blocks) as at "btd", but under
                   Megatron-SP an all-to-all from the column blocks to
                   the rank's positions in place of the reduce-scatter;
                 - at the "logits" constraint of a train or prefill step,
                   vocab-parallel logits become sequence-parallel: an
                   all-to-all over `model`;
                 - at each "moe_egcd" constraint nothing: a MoE layer
                   takes its tokens whole along the sequence and leaves
                   its partial sums as a dense FFN does (the "btd"
                   constraints around it), as the executed layer does
                   (`models.moe`); at its "moe_aux" point of a training
                   step, one all-reduce over every device of its aux
                   losses' sums;
                 - at each "kv" constraint (KV heads the model axis does
                   not divide, before `_group_for_tp` expands them), the
                   keys or values are all-gathered over `model`;
                 - a Mamba mixer as the executed one runs on a block of
                   channels (`models.ssm`): at "mamba_xz" its in_proj
                   columns all-gathered over `model`, at "mamba_xdb" its
                   x_proj partial sums all-reduced there (each again for
                   the gradient), and its `x_proj` and `dt_proj`
                   (`sharding.WHOLE`) gathered whole at a forward use,
                   their gradients reduce-scattered back in
                   `gradient_sync` in place of the FSDP reduce-scatter;
                 - an xLSTM cell and an MLA layer as the executed ones run
                   on a rank's heads (`models.xlstm`,
                   `models.attention`): at "mlstm_xz", "mlstm_conv",
                   "slstm_pre", "slstm_y", "slstm_up" and "mla_latent"
                   (and "mlstm_qkv", "slstm_conv" where the model axis
                   cuts the cell's heads) a tensor all-gathered over
                   `model` from column blocks (its gradient
                   reduce-scattered back), `w_if` gathered
                   whole (`sharding.WHOLE`); a train step's tied table is
                   gathered at its lookup only (the head reads that
                   copy); the chunked loss's "vocab_max" (forward) and
                   "vocab_sum" (and its gradient) all-reduce a chunk's
                   row statistics over `model`;
                 - a constraint's tensor that takes a gradient records,
                   when its backward runs, the collectives that carry the
                   gradient back: all-gather for reduce-scatter and the
                   reverse, all-reduce for all-reduce, all-to-all for
                   all-to-all;
                 - `Trace.gradient_sync` adds a training step's gradient
                   reduce-scatter over the FSDP axes and all-reduce over
                   the batch axes a leaf is replicated on (and over
                   `model` for a leaf `model` does not shard when the
                   residual stream splits its sequence there, and for
                   `sharding.partial_over_model`'s leaves whatever the
                   layout), the loss's
                   all-reduce a microbatch and the gradient norm's a step.
                 These are the plan's model, estimates of the collectives
                 XLA would plan (its own resharding is not seen). A step
                 that executing rules run (`launch.dryrun.executes`) is
                 traced instead as a rank runs it: its collectives are its
                 own, each recorded by a `parallel.collectives.PlanComm`,
                 and its ZeRO-3 products (`gathered_mm`, one op) count as
                 dots, their gathers recorded. Without a remat the two
                 agree by kind (tests/test_torch_distributed.py).

An eager trace unrolls every Python loop, so `unknown_trip_loops` is 0. A
loop of many identical steps may instead be folded: `scan` (a recurrence:
one step runs and its counts, its backward's too, are multiplied by the
trip count; the storages a step leaves alive for the backward count once
per step, even inside a remat region whose saved tensors the card frees
until the recompute, so there the peak is an upper bound) and `steps` (a
loop of independent iterations: one runs, counted n times).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.mesh import NVLINK_DOMAIN

aten = torch.ops.aten

_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
         aten.baddbmm.default}
_NO_FLOPS = {aten.clone.default, aten._to_copy.default, aten.copy_.default}
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default}
# ops that read a parameter without computing with it: the optimizer's
_NOT_A_USE = {aten._to_copy.default, aten.copy_.default, aten.clone.default}
_LOOKUPS = {aten.index.Tensor}           # `table[tokens]`
# ZeRO-3's product with a sharded weight (`parallel.collectives`): one op
# that gathers the weight and multiplies by it
_GATHERED_MM = "repro_torch::gathered_mm"

_STACK: List["Trace"] = []
# constraint points whose tensor the executed step all-gathers over `model`
# from each rank's block of its last dimension (the backward
# reduce-scatters), and those it all-reduces there, by name -> label
_GATHERED = {"kv": "kv heads", "mamba_xz": "mamba x, z",
             "mlstm_xz": "mlstm x_m, z", "mlstm_conv": "mlstm conv",
             "slstm_pre": "slstm gates", "slstm_y": "slstm heads",
             "slstm_up": "slstm g, u", "mla_latent": "mla latent"}
_SUMMED = {"mamba_xdb": "mamba x_proj", "vocab_max": "vocab row max",
           "vocab_sum": "vocab sum of exponentials"}
# gathered as `_GATHERED`'s only where the model axis cuts the cell's
# heads (a multiple of them: `models.xlstm._RankHeads`), by the heads
_CUT_HEADS = {"mlstm_qkv": lambda cfg: cfg.num_heads,
              "slstm_conv": lambda cfg: cfg.xlstm.num_heads_slstm}


def active() -> Optional["Trace"]:
    """The innermost trace running on this thread, or None."""
    return _STACK[-1] if _STACK else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclass
class CollectiveOp:
    op: str
    group_size: int
    in_bytes: int
    out_bytes: int
    transfer_bytes: float   # ring-model bytes per participating device
    count: float            # how many times the trace ran it
    name: str = ""
    axes: Tuple[str, ...] = ()
    off_node: bool = False  # the group spans more than one NVLink node


@dataclass
class KernelCalls:
    calls: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    exps: float = 0.0


@dataclass
class TraceAnalysis:
    """`HloAnalysis`'s fields and methods, and the trace's own: the
    kernels' calls and costs, and the peak of live bytes."""
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: List[CollectiveOp] = field(default_factory=list)
    unknown_trip_loops: int = 0
    top_memory: List[Tuple[float, str, str, str]] = field(default_factory=list)
    kernels: Dict[str, KernelCalls] = field(default_factory=dict)
    peak_bytes: float = 0.0
    # the peak of live bytes a device of the plan holds (`Trace`'s
    # `per_device`): tensors shaped like a parameter leaf (gradients and
    # their accumulators) sharded as the params are, the rest split over
    # the devices that share a batch shard
    peak_bytes_per_device: float = 0.0
    ops: int = 0

    def collective_bytes(self, group_size: Optional[int] = None,
                         exclude_size: Optional[int] = None) -> float:
        tot = 0.0
        for c in self.collectives:
            if group_size is not None and c.group_size != group_size:
                continue
            if exclude_size is not None and c.group_size == exclude_size:
                continue
            tot += c.transfer_bytes * c.count
        return tot

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.op] += c.transfer_bytes * c.count
        return dict(out)

    def axes_bytes(self, pred: Callable[[CollectiveOp], bool]) -> float:
        return sum(c.transfer_bytes * c.count for c in self.collectives
                   if pred(c))


def collective_transfer(op: str, n: int, in_bytes: float,
                        out_bytes: float) -> float:
    """Ring-model bytes through each device's links
    (`hlo._collective_transfer`)."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * in_bytes * frac
    if op == "all-gather":
        return out_bytes * frac
    if op in ("reduce-scatter", "all-to-all"):
        return in_bytes * frac
    if op in ("collective-permute", "collective-broadcast"):
        return float(max(in_bytes, out_bytes))
    return float(in_bytes)


def _off_node(mesh, axes: Sequence[str], node: int) -> bool:
    """Whether a group over `axes` holds devices of more than one node of
    `node` cards, the mesh's devices numbered row-major over its axes (the
    last axis innermost)."""
    names = list(mesh.axis_names)
    sizes = [mesh.shape[a] for a in names]
    strides = [math.prod(sizes[i + 1:]) for i in range(len(names))]
    ids = [0]
    for a in axes:
        i = names.index(a)
        ids = [d + j * strides[i] for d in ids for j in range(sizes[i])]
    return len({d // node for d in ids}) > 1


class Trace(TorchDispatchMode):
    """The counting mode. `rules` (a `ShardingRules`) enables the
    collectives; `params` (the tree the rules shard) names the parameter
    storages; `args` are the storages that are arguments, not temps.
    `per_device` = (the devices a batch shard's work is split over, the
    params' shard factor) weighs the live bytes for `peak_bytes_per_device`
    (both 1 at world size 1)."""

    def __init__(self, rules=None, params=None, args=(), fold: bool = True,
                 per_device: Tuple[float, float] = (1, 1)):
        super().__init__()
        self.per_device = per_device
        self.rules = rules
        self.fold = fold
        self.res = TraceAnalysis()
        self._scale = 1.0
        # storage -> [live tensors on it, bytes, shaped like a param leaf]
        self._live: Dict[int, List] = {}
        self._seen: Dict[int, int] = {}        # id(tensor) -> storage
        self._cur = 0.0
        self._cur_shaped = 0.0
        self._args = {_key(t) for t in _tensors(args)}
        self._fold_new: Optional[List[int]] = None
        self._params: Dict[int, Tuple[Any, str]] = {}   # storage -> spec, name
        self._aliases = set()    # storages of parameters' layout copies
        self._uses_off = 0       # inside `not_a_use`
        self._shapes = set()
        if params is not None:
            from repro_torch.parallel.sharding import (_map_with_path,
                                                       tree_leaves_specs)
            from repro_torch.tree import tree_leaves
            names = tree_leaves(_map_with_path(
                lambda path, _: path.rsplit("/", 1)[-1], params))
            specs = tree_leaves_specs(rules.param_shardings(params)) \
                if rules is not None else [None] * len(names)
            for t, spec, name in zip(tree_leaves(params), specs, names):
                self._params[_key(t)] = (spec, name)
                self._shapes.add(tuple(t.shape))

    # ------------------------------------------------------------ context

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.pop()
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def scaled(self, n: float):
        """Counts of the ops run inside multiplied by `n`."""
        old = self._scale
        self._scale = old * n
        try:
            yield
        finally:
            self._scale = old

    # ------------------------------------------------------------- memory

    def _track(self, t: torch.Tensor, new_ok: bool) -> None:
        if id(t) in self._seen:
            return
        k = _key(t)
        if k in self._args:
            return
        entry = self._live.get(k)
        if entry is None:
            if not new_ok:
                return
            nb = t.untyped_storage().nbytes()
            shaped = tuple(t.shape) in self._shapes
            entry = self._live[k] = [0, nb, shaped]
            self._add(nb, shaped)
            if self._fold_new is not None:
                self._fold_new.append(k)
        entry[0] += 1
        self._seen[id(t)] = k
        weakref.finalize(t, self._release, id(t), k)

    def _add(self, nb: float, shaped: bool) -> None:
        self._cur += nb
        if shaped:
            self._cur_shaped += nb
        res = self.res
        res.peak_bytes = max(res.peak_bytes, self._cur)
        split, factor = self.per_device
        res.peak_bytes_per_device = max(
            res.peak_bytes_per_device,
            (self._cur - self._cur_shaped) / split + self._cur_shaped / factor)

    def _release(self, tid: int, k: int) -> None:
        self._seen.pop(tid, None)
        entry = self._live.get(k)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            del self._live[k]
            if k in self._aliases:      # its storage may be reused
                self._aliases.discard(k)
                del self._params[k]
            self._cur -= entry[1]
            if entry[2]:
                self._cur_shaped -= entry[1]

    # ------------------------------------------------------------ counting

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_key(t) for t in ins}
        view = func.is_view or (not func._schema.is_mutable and outs and all(
            _key(t) in in_keys for t in outs))
        for t in outs:
            self._track(t, not view and not func._schema.is_mutable)
        if view:
            return out
        s = self._scale
        res = self.res
        res.ops += 1
        gathered = func._schema.name == _GATHERED_MM
        if gathered:
            from repro_torch.parallel.collectives import _comm_of
            x, w, dim, key = args
            comm, axes = _comm_of(key)
            if comm.backend == "plan":   # a plan's gather, recorded
                comm.all_gather(w, dim, axes)
        if func in _DOTS or gathered:
            f = 2.0 * ins[0].numel() * outs[0].shape[-1] if gathered \
                else self._dot_flops(func, args)
            res.flops += f * s
            res.dot_flops += f * s
        elif func not in _NO_FLOPS and (torch.Tag.pointwise in func.tags
                                        or torch.Tag.reduction in func.tags):
            res.flops += sum(t.numel() for t in outs) * s
        if func not in _NO_BYTES:
            nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            res.hbm_bytes += nb * s
            if nb * s >= 1e9:
                self._top(nb * s, func, outs)
        if self._params and not self._uses_off and func not in _NOT_A_USE \
                and not func._schema.is_mutable:
            for t in ins:
                info = self._params.get(_key(t))
                if info is not None:
                    self._gather(func, t, *info)
        elif func is aten.clone.default and self._params \
                and not self._uses_off:
            # a layout copy of a parameter for a product (an einsum's
            # permuted weight) is that parameter where it is used
            info = self._params.get(_key(ins[0]))
            if info is not None:
                self._params[_key(outs[0])] = info
                self._aliases.add(_key(outs[0]))
        return out

    @staticmethod
    def _dot_flops(func, args) -> float:
        if func is aten.mm.default:
            a, b = args
            return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        if func is aten.addmm.default:
            a, b = args[1], args[2]
            return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        a, b = (args[0], args[1]) if func is aten.bmm.default \
            else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]

    def _top(self, nb: float, func, outs, keep: int = 24) -> None:
        shape = str(tuple(outs[0].shape)) if outs else ""
        self.res.top_memory.append((nb, str(func), "", shape[:48]))
        if len(self.res.top_memory) > 4 * keep:
            self.res.top_memory.sort(reverse=True)
            del self.res.top_memory[keep:]

    # --------------------------------------------------------- collectives

    def _collective(self, op: str, axes, in_b: float, out_b: float,
                    name: str, count: Optional[float] = None) -> None:
        rules = self.rules
        from repro_torch.parallel.sharding import _axis_size, _flat_axes
        axes = _flat_axes(axes)
        n = _axis_size(rules.mesh, axes)
        if n <= 1:
            return
        self.res.collectives.append(CollectiveOp(
            op=op, group_size=n, in_bytes=int(in_b), out_bytes=int(out_b),
            transfer_bytes=collective_transfer(op, n, in_b, out_b),
            count=self._scale if count is None else count, name=name,
            axes=axes, off_node=_off_node(rules.mesh, axes, NVLINK_DOMAIN)))

    def _split(self, spec) -> Tuple[Tuple[str, ...], int, int]:
        """(FSDP axes a spec shards over, their size, the size of all its
        axes)."""
        from repro_torch.parallel.sharding import _axis_size, _flat_axes
        fsdp = set(_flat_axes(self.rules.fsdp))
        used = [a for axes in spec for a in _flat_axes(axes)]
        gather = tuple(a for a in used if a in fsdp)
        return gather, _axis_size(self.rules.mesh, gather), \
            _axis_size(self.rules.mesh, tuple(used))

    def _whole(self, t: torch.Tensor, spec, backward: bool) -> None:
        """A leaf the executed step gathers whole (`sharding.WHOLE`): at a
        forward use, all-gathered along each dimension its spec splits, the
        last first; in the backward (`backward`), its gradient
        reduce-scattered back in the reverse order."""
        from repro_torch.parallel.sharding import _axis_size
        spec = tuple(spec)[-t.dim():]
        dims = [(d, spec[d]) for d in reversed(range(t.dim()))
                if spec[d] is not None]
        cur = _nbytes(t) / math.prod(_axis_size(self.rules.mesh, a)
                                     for _, a in dims)
        recs = []
        for _, axes in dims:
            n = _axis_size(self.rules.mesh, axes)
            recs.append(("all-gather", axes, cur, cur * n))
            cur *= n
        if backward:
            recs = [("reduce-scatter", a, o, i) for _, a, i, o in
                    reversed(recs)]
        for op, axes, in_b, out_b in recs:
            self._collective(op, axes, in_b, out_b, "whole param")

    def _gather(self, func, t: torch.Tensor, spec, name: str) -> None:
        if self.rules is None:
            return
        from repro_torch.parallel.sharding import WHOLE
        if name in WHOLE and self.rules.shape.kind != "decode":
            if torch._C._current_autograd_node() is None:   # not a backward
                self._whole(t, spec, backward=False)
            return
        axes, n_fsdp, n_all = self._split(spec)
        if n_fsdp <= 1:
            return
        if name == "table" and func not in _LOOKUPS \
                and self.rules.cfg.tie_embeddings \
                and self.rules.shape.kind == "train":
            return      # a tied head reads the rows the lookup gathered
        if self.rules.shape.kind == "decode":
            # a decode step's products keep their weights where they are
            # (its activations, one token a sequence, are what moves); the
            # embedding lookup gathers the whole table over the FSDP axes,
            # as XLA plans the reference's decode cells
            if name != "table" or func not in _LOOKUPS:
                return
            full = _nbytes(t)
        else:
            full = _nbytes(t) * n_fsdp / n_all  # gathered, still TP-sharded
        self._collective("all-gather", axes, full / n_fsdp, full,
                         "fsdp param")

    def constrain(self, rules, x: torch.Tensor, name: str, spec):
        """A `constrain_act` / `constrain_moe` point (see the module
        docstring): its collectives recorded, and `x` returned, wrapped
        (`_Transposed`) where it takes a gradient, so that the backward
        records the collectives that carry the gradient back. Bytes are per
        device: the trace runs a batch shard, so a tensor's bytes over its
        spec's non-batch axes."""
        if self.rules is None:
            return x
        if name == "moe_aux":
            every = tuple(rules.mesh.axis_names)
            self._collective("all-reduce", every, _nbytes(x), _nbytes(x),
                             "moe aux")
            return x
        if rules.tp_size <= 1:
            return x
        from repro_torch.parallel.sharding import _axis_size, _flat_axes
        bat = set(rules.batch_axes)
        other = tuple(a for axes in spec for a in _flat_axes(axes)
                      if a not in bat)
        per_dev = _nbytes(x) / _axis_size(rules.mesh, other)
        full = _nbytes(x)
        tp = rules.tp
        fwd: List[Tuple] = []
        bwd: List[Tuple] = []
        if name == "btd":
            if tp in other:        # Megatron-SP: reduce-scatter, re-gather
                fwd = [("reduce-scatter", tp, full, per_dev, "sp residual"),
                       ("all-gather", tp, per_dev, full, "sp residual")]
                bwd = [("reduce-scatter", tp, full, per_dev, "sp residual"),
                       ("all-gather", tp, per_dev, full, "sp residual")]
            else:
                fwd = bwd = [("all-reduce", tp, full, full, "residual")]
        elif name == "enc_in":
            if tp in other:        # column blocks to the rank's positions
                fwd = [("all-to-all", tp, per_dev, per_dev, "enc in"),
                       ("all-gather", tp, per_dev, full, "sp residual")]
                bwd = [("reduce-scatter", tp, full, per_dev, "sp residual"),
                       ("all-to-all", tp, per_dev, per_dev, "enc in")]
            else:
                fwd = bwd = [("all-reduce", tp, full, full, "residual")]
        elif name == "logits" and rules.shape.kind != "decode":
            fwd = bwd = [("all-to-all", tp, per_dev, per_dev, "logits")]
        elif name in _GATHERED or (name in _CUT_HEADS and rules.tp_size
                                   > _CUT_HEADS[name](rules.cfg)):
            n = _axis_size(rules.mesh, tp)
            label = _GATHERED.get(name, name)
            fwd = [("all-gather", tp, full / n, full, label)]
            bwd = [("reduce-scatter", tp, full, full / n, label)]
        elif name in _SUMMED:
            fwd = [("all-reduce", tp, full, full, _SUMMED[name])]
            if name != "vocab_max":     # a stabilizer: no gradient
                bwd = fwd
        for rec in fwd:
            self._collective(*rec)
        if bwd and x.requires_grad and torch.is_grad_enabled():
            return _Transposed.apply(self, [(*r, self._scale) for r in bwd],
                                     x)
        return x

    def gradient_sync(self, params, times: float = 1.0) -> None:
        """A training step's gradient collectives, `times` a step (one a
        microbatch, as the reference's accumulation pins each
        microbatch's gradients to the parameters' shardings): each leaf's
        gradient reduce-scattered over the FSDP axes its spec shards, then
        its shard all-reduced over the batch axes the spec leaves
        replicated."""
        if self.rules is None:
            return
        from repro_torch.parallel.sharding import (WHOLE, _axis_size,
                                                   _flat_axes,
                                                   _map_with_path,
                                                   partial_over_model,
                                                   tree_leaves_specs)
        from repro_torch.tree import tree_leaves
        rules = self.rules
        sp = rules.tp in _flat_axes(rules._act_spec(
            "btd", (rules.shape.global_batch, rules.shape.seq_len,
                    rules.cfg.d_model))[1])
        specs = tree_leaves_specs(rules.param_shardings(params))
        paths = tree_leaves(_map_with_path(lambda path, _: path, params))
        for t, spec, path in zip(tree_leaves(params), specs, paths):
            name = path.rsplit("/", 1)[-1]
            axes, n_fsdp, n_all = self._split(spec)
            local = _nbytes(t) * n_fsdp / n_all
            if name in WHOLE:
                layers = t.shape[0] if len(spec) > 1 and spec[0] is None \
                    and t.dim() == len(spec) and t.dim() > 2 else 1
                with self.scaled(times * layers):
                    self._whole(t[0] if layers > 1 else t, spec,
                                backward=True)
            elif n_fsdp > 1:
                self._collective("reduce-scatter", axes, local,
                                 local / n_fsdp, "grad", times)
            used = {a for a_ in spec for a in _flat_axes(a_)}
            rep = [a for a in rules.batch_axes if a not in used]
            if (sp or partial_over_model(path)) and rules.tp not in used:
                rep.append(rules.tp)
            rep = tuple(a for a in rules.mesh.axis_names if a in rep)
            if _axis_size(rules.mesh, rep) > 1:
                self._collective("all-reduce", rep, local / n_fsdp,
                                 local / n_fsdp, "grad", times)
        # the loss's sum over every device a microbatch, the norm's a step
        every = tuple(rules.mesh.axis_names)
        self._collective("all-reduce", every, 4, 4, "loss", times)
        self._collective("all-reduce", every, 4, 4, "grad norm", 1.0)

    # ------------------------------------------------------------- kernels

    def kernel(self, name: str, cost) -> None:
        s = self._scale
        k = self.res.kernels.setdefault(name, KernelCalls())
        k.calls += s
        k.flops += cost.flops * s
        k.bytes += cost.bytes * s
        k.exps += cost.exps * s
        self.res.flops += cost.flops * s
        self.res.hbm_bytes += cost.bytes * s


@contextlib.contextmanager
def not_a_use():
    """Reads of a parameter inside (the optimizer's) gather nothing in the
    active trace."""
    tr = active()
    if tr is None:
        yield
        return
    tr._uses_off += 1
    try:
        yield
    finally:
        tr._uses_off -= 1


class _Transposed(torch.autograd.Function):
    """`x` as it is; its backward records `recs`, the collectives that
    carry a constrained tensor's gradient back, each with the count of
    the forward that made it."""

    @staticmethod
    def forward(ctx, tr, recs, x):
        ctx.tr, ctx.recs = tr, recs
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for rec in ctx.recs:
            ctx.tr._collective(*rec)
        return None, None, g


def record_kernel(name: str, cost) -> None:
    """One call of kernel `name` with its `cost`, into the active trace
    (no-op without one)."""
    tr = active()
    if tr is not None:
        tr.kernel(name, cost)


def _same(x):
    return x


class _Fold(torch.autograd.Function):
    """One step run for `n`: its forward counted n times, and its backward
    (autograd through the recorded step) n times."""

    @staticmethod
    def forward(ctx, tr, n, fn, *inputs):
        ctx.tr, ctx.n = tr, n
        # step 0 stands for every step: a later step's carry depends on the
        # weights, so every floating input takes a gradient
        leaves = [x.detach().requires_grad_(x.is_floating_point())
                  for x in inputs]
        # the step's graph keeps its own saved tensors: a remat region's
        # pack hooks would recompute the whole region inside `backward`
        with torch.enable_grad(), tr.scaled(n), \
                torch.autograd.graph.saved_tensors_hooks(_same, _same):
            outs = fn(*leaves)
        ctx.leaves, ctx.outs = leaves, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        want = [x for x in ctx.leaves if x.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        got = {}
        if pairs and want:
            with ctx.tr.scaled(ctx.n):
                gs = torch.autograd.grad([o for o, _ in pairs], want,
                                         [g for _, g in pairs],
                                         allow_unused=True)
            got = {id(x): g for x, g in zip(want, gs)}
        return (None, None, None, *(got.get(id(x)) for x in ctx.leaves))


def scan(step: Callable, carry: Tuple[torch.Tensor, ...],
         xs: Sequence[Tuple[torch.Tensor, int]], n: int,
         consts: Sequence[torch.Tensor] = (), stack_dim: int = 1):
    """`for t in range(n): carry, y = step(carry, *(x.select(d, t) for x, d
    in xs), *consts)`, the y's stacked along `stack_dim`. Eager as written;
    under a trace folded: step 0 runs once for n (its ops and its
    backward's counted n times, the storages it leaves alive for the
    backward n times) and the stack is allocated whole. Every tensor the
    step reads goes in through `carry`, `xs` or `consts`, so that the
    folded step's backward reaches it."""
    tr = active()
    if tr is None or not tr.fold or n <= 1:
        ys = []
        for t in range(n):
            carry, y = step(carry, *(x.select(d, t) for x, d in xs), *consts)
            ys.append(y)
        return carry, torch.stack(ys, dim=stack_dim)
    inputs = (*carry, *(x.select(d, 0) for x, d in xs), *consts)
    nc = len(carry)

    def one(*args):
        c, y = step(tuple(args[:nc]), *args[nc:])
        return (*c, y)

    new: List[int] = []
    prev, tr._fold_new = tr._fold_new, new
    try:
        if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
            outs = _Fold.apply(tr, n, one, *inputs)
        else:
            with tr.scaled(n):
                outs = one(*inputs)
    finally:
        tr._fold_new = prev
    out_keys = {_key(o) for o in outs}
    for k in set(new):
        entry = tr._live.get(k)
        if entry is not None and k not in out_keys:
            tr._add(entry[1] * (n - 1), entry[2])
            entry[1] *= n
    y = outs[-1]
    stacked = y.unsqueeze(stack_dim).expand(
        *y.shape[:stack_dim], n, *y.shape[stack_dim:]).contiguous()
    return tuple(outs[:nc]), stacked


def steps(n: int):
    """`range(n)` for a loop whose iterations do the same work on the same
    shapes and each free what the one before held (a training step's
    microbatches). Under a trace one iteration runs, its counts multiplied
    by n; its peak is every iteration's."""
    tr = active()
    if tr is None or not tr.fold or n <= 1:
        yield from range(n)
        return
    with tr.scaled(n):
        yield 0


def analyze_trace(fn: Callable, *args, rules=None, params=None,
                  fold: bool = True, **kwargs) -> Tuple[TraceAnalysis, Any]:
    """Runs `fn(*args, **kwargs)` (meta tensors) under a `Trace`; returns
    (the analysis, fn's result). `params` names the parameter tree that
    `rules` shard (the FSDP gathers; the plan is `rules.mesh`); `fold=False`
    unrolls `scan`'s loops. Every tensor argument is an argument storage,
    not a temp."""
    with Trace(rules=rules, params=params, args=(args, kwargs),
               fold=fold) as tr:
        out = fn(*args, **kwargs)
    return tr.res, out
