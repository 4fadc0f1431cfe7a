"""Sharding rules: the port of `repro.parallel.sharding`. Logical-axis
mapping from parameter, optimizer-state, cache and input trees to partition
specs over the (pod, data, model) production mesh.

Strategy, as the reference's:
  * DP/FSDP: batch over (pod, data); every 2-D weight shards its non-TP
    dimension over `data` (ZeRO-3), the AdamW state mirrors the params.
  * TP: Megatron column/row parallel over `model`; vocab-parallel
    embedding and LM head.
  * EP: the MoE expert dimension over `model` where it divides, else
    expert-internal TP.
  * SP: long-context decode (batch 1) shards the cache's sequence over
    `data`.
  * Multi-pod: params replicated across pods (the gradient all-reduce
    crosses the `pod` axis) unless the config sets `fsdp_over_pod`.

Rules are driven by name and shape with a divisibility filter (`_fit`): a
mesh axis that does not divide its dimension is dropped, so a spec is never
invalid. A mesh is any object with `shape` (axis name -> size) and
`axis_names`: `launch.mesh.Mesh`, a `jax.sharding.Mesh`, or a test's
stand-in. A spec is the port's own `PartitionSpec`, whose `str` is the
reference's.

`constrain_act` and `constrain_moe` return their tensor unchanged. Under
the dry run's trace (`repro_torch.analysis.trace`) they also record the
collective that moves the tensor to the constrained layout.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.tree import tree_leaves


class PartitionSpec(tuple):
    """One entry per dimension: an axis name, a tuple of names, or None.
    `str` and `repr` are `jax.sharding.PartitionSpec`'s."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + repr(tuple(self))

    __str__ = __repr__


P = PartitionSpec


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _flat_axes(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    out = []
    for a in axes:
        out.extend(_flat_axes(a))
    return tuple(out)


def _fit(mesh, spec_axes, shape) -> PartitionSpec:
    """Drop axes that don't divide their dim; returns a valid spec."""
    fixed = []
    for dim, axes in zip(shape, spec_axes):
        if axes is None:
            fixed.append(None)
            continue
        keep = []
        rem = dim
        for a in _flat_axes(axes):
            n = mesh.shape[a]
            if rem % n == 0:
                keep.append(a)
                rem //= n
        fixed.append(tuple(keep) if len(keep) > 1
                     else (keep[0] if keep else None))
    return P(*fixed)


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a `shape` array under `spec`
    (dimensions past the spec's length are whole)."""
    out = list(shape)
    for i, axes in enumerate(spec):
        n = _axis_size(mesh, axes)
        if out[i] % n:
            raise ValueError(f"axes {axes} ({n}) do not divide dim {i} of "
                             f"{tuple(shape)}")
        out[i] //= n
    return tuple(out)


def shard_bytes(tensor, spec, mesh) -> int:
    """Bytes of one device's shard of `tensor` (any object with `shape`
    and a torch `dtype`) under `spec`."""
    return (math.prod(shard_shape(tuple(tensor.shape), spec, mesh))
            * tensor.dtype.itemsize)


def bytes_per_device(tree, specs, mesh) -> int:
    """Bytes one device holds of `tree` whose leaves have the partition
    specs of `specs` (a tree of one structure)."""
    return sum(shard_bytes(t, s, mesh)
               for t, s in zip(tree_leaves(tree), tree_leaves_specs(specs)))


def tree_leaves_specs(specs) -> list:
    """The specs of a spec tree in `tree_leaves` order (a spec is a tuple,
    so it is a leaf here, not a node)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in tree_leaves_specs(v)]
    if isinstance(specs, (tuple, list)):
        return [x for v in specs for x in tree_leaves_specs(v)]
    raise TypeError(f"not a spec tree: {type(specs)}")


def _map_with_path(fn, tree, path=()):
    """`fn("a/b/0/w", leaf)` over a tree of dicts, tuples and lists, keys
    joined as `jax.tree_util.tree_map_with_path` paths are (tuple and list
    positions as their index)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


# parameter names that are row-parallel (input dim on `model`)
_ROW_2D = {"w_o", "down", "w_down", "out_proj", "dt_proj"}
# names that live on the inner (d_inner/model-sharded) dimension
_DI_VECTORS = {"D", "dt_bias", "conv_b"}
_REPLICATED = {"scale", "b", "b_if", "router", "r_rec"}


@dataclass
class ShardingRules:
    mesh: Any
    cfg: ModelConfig
    shape: ShapeConfig

    def __post_init__(self):
        names = self.mesh.axis_names
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names)
        self.tp = "model"
        # ZeRO-3 param sharding; across pods too where the config says so
        if self.cfg.fsdp_over_pod and "pod" in names:
            self.fsdp: Any = ("pod", "data")
        else:
            self.fsdp = "data"
        # long-context decode with batch=1: shard sequence instead of batch
        self.seq_shard = (self.shape.kind == "decode"
                          and self.shape.global_batch == 1)

    # ----------------------------------------------------------- parameters

    def _param_spec(self, path: str, shape: Tuple[int, ...]) -> PartitionSpec:
        mesh, tp, fsdp = self.mesh, self.tp, self.fsdp
        stacked = bool(re.search(r"(groups|encoder/layers)", path))
        base_shape = shape[1:] if stacked else shape
        name = path.rsplit("/", 1)[-1]

        def out(*axes):
            spec = _fit(mesh, axes, base_shape)
            return P(None, *spec) if stacked else spec

        nd = len(base_shape)
        if name in _REPLICATED or nd == 0:
            return out(*([None] * nd))
        if name in _DI_VECTORS and nd == 1:
            return out(tp)
        if name == "A_log":
            return out(tp, None)
        if name == "conv_w":
            return out(None, tp)
        if name == "table":                      # (vocab, d)
            return out(tp, fsdp)
        if name == "lm_head":
            return out(fsdp, tp)
        if name in ("w_uk", "w_uv"):             # (r, H, e) MLA per-head
            return out(None, tp, None)
        if nd == 3 and name in ("w_gate", "w_up", "w_down"):
            e = base_shape[0]
            if e % mesh.shape[tp] == 0:          # expert parallel
                if name == "w_down":
                    return out(tp, None, fsdp)
                return out(tp, fsdp, None)
            # expert-internal TP fallback
            if name == "w_down":
                return out(None, tp, fsdp)
            return out(None, fsdp, tp)
        if nd == 2:
            if name in _ROW_2D:
                return out(tp, fsdp)
            return out(fsdp, tp)                 # column-parallel default
        if nd == 1:
            return out(None)
        return out(*([None] * nd))

    def param_shardings(self, params_shapes) -> Any:
        """The spec of every leaf, in the tree's structure."""
        return _map_with_path(
            lambda path, leaf: self._param_spec(path, tuple(leaf.shape)),
            params_shapes)

    def opt_shardings(self, opt_shapes) -> Any:
        return self.param_shardings(opt_shapes)

    # ---------------------------------------------------------- activations

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp]

    def constrain_act(self, x, name: str = "btd"):
        if name == "bshd":   # (B, S, H, hd) attention heads over `model`
            spec = _fit(self.mesh,
                        ((None if self.seq_shard else self.batch_axes),
                         None, self.tp, None), x.shape)
        else:
            spec = self._act_spec(name, x.shape)
        return _constrain(self, x, name, spec)

    def _act_spec(self, name: str, shape) -> PartitionSpec:
        bat = self.batch_axes
        decode = self.shape.kind == "decode"
        if name == "logits":
            if self.seq_shard:
                return _fit(self.mesh, (None, self.fsdp, self.tp), shape)
            if decode:
                return _fit(self.mesh, (bat, None, self.tp), shape)
            # train/prefill: loss is per-token -> sequence-parallel logits
            return _fit(self.mesh, (bat, self.tp, None), shape)
        # (B, S, d) hidden states
        if self.seq_shard:
            return _fit(self.mesh, (None, "data", None), shape)
        if decode or not self.cfg.sequence_parallel:
            return _fit(self.mesh, (bat, None, None), shape)
        # Megatron-SP: the residual stream shards its sequence over `model`
        return _fit(self.mesh, (bat, self.tp, None), shape)

    def constrain_moe(self, name: str, x):
        mesh, tp, bat = self.mesh, self.tp, self.batch_axes
        if name == "moe_dispatch":               # (G, N, E, C)
            g = x.shape[0]
            if g % _axis_size(mesh, bat) == 0:
                spec = _fit(mesh, (bat, None, tp, None), x.shape)
            else:                                # decode: one flat group
                spec = _fit(mesh, (None, bat, tp, None), x.shape)
        elif name == "moe_egcd":                 # (E, G, C, d)
            g = x.shape[1]
            if g % _axis_size(mesh, bat) == 0:
                spec = _fit(mesh, (tp, bat, None, None), x.shape)
            else:
                spec = _fit(mesh, (tp, None, bat, None), x.shape)
        else:
            return x
        return _constrain(self, x, name, spec)

    # --------------------------------------------------------------- inputs

    def input_shardings(self, specs: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in specs.items():
            if k == "tokens" and self.shape.kind == "decode":
                axes = (bat_or_none(self.batch_axes, v.shape[0]), None)
            elif k == "tokens":
                axes = (self.batch_axes, None)
            elif k in ("frames", "image_embeds"):
                axes = (self.batch_axes, None, None)
            else:
                axes = tuple([None] * len(v.shape))
            out[k] = _fit(self.mesh, axes, v.shape)
        return out

    # --------------------------------------------------------------- caches

    def _cache_spec(self, path: str, shape) -> PartitionSpec:
        mesh, tp = self.mesh, self.tp
        stacked = "groups" in path
        base = shape[1:] if stacked else shape
        name = path.rsplit("/", 1)[-1]
        bat = None if self.seq_shard else self.batch_axes
        seq = self.fsdp if self.seq_shard else None

        def out(*axes):
            spec = _fit(mesh, axes, base)
            return P(None, *spec) if stacked else spec

        if name == "slot_pos":
            return out(*([None] * len(base)))
        if name in ("k", "v", "cross_k", "cross_v"):   # (B, cap, kv, hd)
            kv = base[2]
            if kv % mesh.shape[tp] == 0:
                return out(bat, seq, tp, None)
            # kv heads don't divide TP: shard the sequence dim over `model`
            # instead (flash-decoding-style split-KV)
            cap_axes = ((self.fsdp, tp) if self.seq_shard else tp)
            return out(bat, cap_axes, None, None)
        if name in ("c_kv", "k_rope"):                 # (B, cap, r)
            cap_axes = ((self.fsdp, tp) if self.seq_shard
                        else (tp if not seq else seq))
            return out(bat, cap_axes, None)
        if name == "h" and len(base) == 3:             # mamba (B, di, ds)
            return out(bat, tp, None)
        if name == "conv":                             # (B, K, di)
            return out(bat, None, tp)
        if name == "C":                                # mlstm (B,H,hd,hd)
            return out(bat, tp, None, None)
        return out(*([bat] + [None] * (len(base) - 1)))

    def cache_shardings(self, cache_shapes) -> Any:
        return _map_with_path(
            lambda path, leaf: self._cache_spec(path, tuple(leaf.shape)),
            cache_shapes)

    def scalar_sharding(self) -> PartitionSpec:
        return P()


def _constrain(rules: ShardingRules, x, name: str, spec: PartitionSpec):
    """x as it is; under an active cost trace, the layout change recorded
    (`analysis.trace.Trace.constrain`)."""
    from repro_torch.analysis import trace   # the trace imports the rules
    active: Optional[Any] = trace.active()
    if active is not None:
        active.constrain(rules, x, name, spec)
    return x


def bat_or_none(bat, dim):
    return bat if dim > 1 else None


def make_rules(mesh, cfg: ModelConfig, shape: ShapeConfig) -> ShardingRules:
    return ShardingRules(mesh, cfg, shape)
