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

Planning mode (no `comm`): `constrain_act` and `constrain_moe` return their
tensor unchanged; under the dry run's trace (`repro_torch.analysis.trace`)
they also record the collectives that move the tensor to the constrained
layout, and its gradient back.

Executing mode (`make_rules(..., comm=Comm(mesh))` over a process group):
the model runs rank-local (`models.model`, `models.attention`,
`models.layers`) and moves tensors through this object as the specs say:
  * the residual stream is `btd`'s layout: under Megatron-SP (the config's
    `sequence_parallel`, S divisible by the model axis) its sequence is
    split over `model`, all-gathered before a column-parallel product
    (`enter`) and reduce-scattered after a row-parallel one (`exit`);
    without SP it is whole, and `exit` all-reduces the partial sums;
  * every weight is all-gathered over the FSDP axes of its spec at each
    use (`linear`, ZeRO-3's `collectives.gathered_mm`), its gradient
    reduce-scattered back to the shard;
  * the embedding is vocab-parallel (`lookup`: a masked lookup in the
    rank's rows of the table, then `exit`); the LM head's vocab-parallel logits
    go to the sequence-parallel `logits` layout by an all-to-all
    (`to_seq`), where each rank takes the loss of its positions;
  * KV heads the model axis does not divide (`_group_for_tp`'s expand
    case) are all-gathered, and the rank takes those its query heads read
    (`kv_heads`); query heads it does not divide while it divides their
    columns (phi3's 40 over 16) are all-gathered too, the rank runs flash
    on every head its columns reach into and keeps its own columns of
    their output for its rows of `w_o` (`q_heads`, `head_cols`);
  * a MoE layer takes its tokens in (`enter`: every model rank routes the
    same whole groups) and runs the rank's experts (expert parallel) or
    every expert's `d_ff` columns (the expert-internal TP fallback), its
    partial sums out through `exit`; the aux losses are sums over each
    rank's own block of positions, all-reduced over every rank
    (`models.moe`);
  * a Mamba mixer runs the rank's block of `d_inner` channels over the
    whole sequence (under SP too: `enter` gathers it, so no scan passes
    its state between ranks): `in_proj`'s column blocks all-gathered over
    `model` for the rank's x and z channels, `x_proj` and `dt_proj`
    gathered whole (`whole`), its `x_proj` partial sums all-reduced
    (`models.ssm`);
  * an xLSTM cell runs the rank's heads from column blocks all-gathered
    over `model` (`cols`) and `w_if` gathered whole (`models.xlstm`); an
    MLA layer gathers its latents whole and runs the rank's heads
    (`models.attention`);
  * an encoder (`frames` inputs) runs its layers as the decoder's on the
    residual stream's layout, from `frame_proj`'s column blocks moved
    to the rank's positions under SP (`to_seq`), else summed whole
    (`pad_cols`, then `exit`); its output is entered whole along
    the sequence once, and every decoder layer's cross-attention takes
    its rank's heads of the keys and values from it (`models.attention`);
  * `tokens+image` inputs put the projected image rows before the
    tokens: `img_proj`'s column blocks and the rank's part of the
    token lookup (`lookup`) summed into the residual stream's layout over
    the whole sequence by one `exit`, so a rank's block of positions may
    hold image rows, token rows or both; image positions predict no token
    in the loss;
  * a tied head reads the rank's rows of the table the lookup gathered
    (`vocab_rows`), an untied one its `lm_head` columns (`linear`, or for
    the chunked loss `fsdp_gather`, once a step); the chunked
    loss takes each chunk's log-sum-exp over the ranks' vocab columns
    (`models.model`);
  * after a microbatch's backward a gradient is all-reduced over the batch
    axes its spec leaves replicated, and over `model` too for a leaf
    `model` does not shard while its ranks' gradients differ: any such
    leaf under SP (the tokens that reach it are split), the router always
    (each model rank's experts or columns see their own part of it), and
    the leaves an xLSTM cell or MLA layer reads only its heads' slices of
    (`partial_over_model`) (`sync_grads`); the global norm counts each
    element once (`global_norm`).
A layer names its leaves by their path in the params (`at`, `linear`), so
two leaves of one name in layers of other kinds (jamba's dense and MoE
`ffn/w_gate`) each gather the block their own spec describes.
`constrain_act` and `constrain_moe` return their tensor as it is: the
layout is already the spec's. `shard_tree` cuts a rank's blocks out of
whole leaves and `gather_tree` puts them back together.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, ShapeConfig
from repro_torch.parallel import collectives as c
from repro_torch.tree import tree_leaves, tree_map


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


# leaves a rank gathers whole for its block of a Mamba mixer's channels or
# an mLSTM cell's heads (`whole`): their specs cut across the block
WHOLE = {"x_proj", "dt_proj", "w_if"}
# replicated leaves whose gradient the model ranks each hold a part of
# whatever the residual stream's layout, by the end of their path: the
# router's (a rank's experts or columns weigh their own gates), and the
# leaves an xLSTM cell or an MLA layer reads only its own heads' slices of
# (the recurrence, the gate biases, the head norms) or feeds only its own
# heads from (MLA's latent norms)
_PARTIAL_OVER_MODEL = ("router", "r_rec", "b", "b_if", "norm_scale",
                       "q_norm/scale", "kv_norm/scale")


def partial_over_model(path: str) -> bool:
    """Whether the model ranks' gradients of the replicated leaf at `path`
    are parts of it, whatever the residual stream's layout."""
    return any(path == end or path.endswith("/" + end)
               for end in _PARTIAL_OVER_MODEL)
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
    comm: Any = None      # a `collectives.Comm` over `mesh`: executing mode

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
        self._specs = self._by_path = None
        if self.comm is not None:
            check_executable(self)

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
        if self.executing:
            return x
        if name == "bshd":   # (B, S, H, hd) attention heads over `model`
            spec = _fit(self.mesh,
                        ((None if self.seq_shard else self.batch_axes),
                         None, self.tp, None), x.shape)
        elif name == "kv":   # (B, S, Kv, hd) KV heads whole on each rank
            spec = _fit(self.mesh, (self.batch_axes, None, None, None),
                        x.shape)
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
        if self.executing:
            return x
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
        elif name == "moe_aux":                  # the aux losses' sums
            spec = P(None)
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

    # ------------------------------------------------------------ execution

    @property
    def executing(self) -> bool:
        return self.comm is not None

    @property
    def sequence_parallel(self) -> bool:
        """Whether the residual stream of this step splits its sequence
        over `model` (`btd`'s spec at the step's global shape)."""
        spec = self._act_spec("btd", (self.shape.global_batch,
                                      self.shape.seq_len, self.cfg.d_model))
        return self.tp in _flat_axes(spec[1])

    def param_specs(self):
        """The spec of every leaf of the config's params (from the whole
        leaves' shapes), in the params' structure."""
        if self._specs is None:
            from repro_torch.bridge import param_shapes
            self._specs = self.param_shardings(param_shapes(self.cfg))
        return self._specs

    def state_specs(self, opt_state) -> Dict[str, Any]:
        """The specs of an AdamW state: moments as the params, the step
        replicated."""
        specs = self.param_specs()
        return {k: (P() if k == "step" else specs) for k in opt_state}

    def _leaf_spec(self, path: str) -> PartitionSpec:
        """The spec of the leaf at `path` in the params ("embed/table",
        "groups/1/ffn/w_gate"), a stacked leaf's without its leading layer
        axis: one layer's block."""
        if self._by_path is None:
            out = {}

            def one(path, spec):
                stacked = bool(re.search(r"(groups|encoder/layers)", path))
                out[path] = P(*spec[1:]) if stacked else spec
                return spec
            _map_specs(one, self.param_specs())
            self._by_path = out
        return self._by_path[path]

    def _fsdp_dim(self, path: str) -> Tuple[int, Tuple[str, ...]]:
        """(the dimension of the leaf at `path` its spec shards over FSDP
        axes, those axes); (-1, ()) where there is none."""
        fsdp = set(_flat_axes(self.fsdp))
        for i, axes in enumerate(self._leaf_spec(path)):
            got = tuple(a for a in _flat_axes(axes) if a in fsdp)
            if got:
                return i, got
        return -1, ()

    def at(self, prefix: str) -> "Scoped":
        """These rules as the layer or sublayer at `prefix` in the params
        sees them: `linear(x, w, "w_q")` is the leaf `prefix/w_q`'s."""
        return Scoped(self, prefix)

    def enter(self, x):
        """The residual stream into a column-parallel product: under SP
        all-gathered along the sequence (its backward reduce-scatters);
        else as it is, its gradient all-reduced over `model`."""
        if self.sequence_parallel:
            return c.all_gather(self.comm, x, 1, self.tp)
        return c.all_reduce_backward(self.comm, x, self.tp)

    def exit(self, y):
        """A row-parallel product's partial sums back to the residual
        stream: under SP reduce-scattered along the sequence, else
        all-reduced over `model`."""
        if self.sequence_parallel:
            return c.reduce_scatter(self.comm, y, 1, self.tp)
        return c.all_reduce(self.comm, y, self.tp)

    def linear(self, x, w, path: str):
        """`x @ w` for this rank's block `w` of the leaf at `path`: the
        block gathered over the FSDP axes of its spec (ZeRO-3), still split
        over `model` where the spec says. A 3-D block (experts) multiplies
        a batch of the same leading size."""
        dim, axes = self._fsdp_dim(path)
        return c.gathered_mm(self.comm, x, w, dim, axes)

    def cols(self, y):
        """A column-parallel product's output (or any tensor split so along
        its last dimension) whole on every model rank: its blocks
        all-gathered over `model` (the backward reduce-scatters the
        gradient, so each rank's part of it is summed)."""
        return c.all_gather(self.comm, y, y.dim() - 1, self.tp)

    def whole(self, w, path: str):
        """The whole leaf at `path` from this rank's block `w`: all-gathered
        along each dimension its spec splits, the last dimension first
        (the backward reduce-scatters the gradient back to the block, so
        the ranks' parts of it are summed)."""
        spec = self._leaf_spec(path)
        for dim in reversed(range(len(spec))):
            if spec[dim] is not None:
                w = c.all_gather(self.comm, w, dim, spec[dim])
        return w

    def tp_block(self, n: int) -> Tuple[int, int]:
        """This rank's block [start, stop) of `n` (channels, experts,
        positions) split over `model`."""
        m = self.comm.index(self.tp)
        return m * n // self.tp_size, (m + 1) * n // self.tp_size

    def fsdp_gather(self, w, path: str):
        """The block `w` of the leaf at `path` all-gathered over the FSDP
        axes of its spec, still split over `model` where the spec says (the
        backward reduce-scatters the gradient): an untied `lm_head`'s vocab
        columns whole along `d_model`, once a step for every chunk of the
        chunked loss."""
        dim, axes = self._fsdp_dim(path)
        return c.all_gather(self.comm, w, dim, axes) if dim >= 0 else w

    def vocab_rows(self, table):
        """This rank's rows of the embedding table, whole along `d_model`
        (`fsdp_gather`). A tied head reads the copy the lookup read: one
        gather a step for both."""
        return self.fsdp_gather(table, "embed/table")

    def vocab_start(self, rows: int) -> int:
        """The first vocabulary entry of this rank's `rows`."""
        return self.comm.index(self.tp) * rows

    def lookup(self, rows, tokens):
        """This rank's part of the vocab-parallel lookup of `tokens`: their
        rows where this rank's rows of the table (`vocab_rows`) hold them,
        zero elsewhere; `exit` sums the parts over `model` into the
        residual stream."""
        n = rows.shape[0]
        idx = tokens - self.vocab_start(n)
        valid = (idx >= 0) & (idx < n)
        return rows[idx.clamp(0, n - 1)] * valid[..., None].to(rows.dtype)

    def pad_cols(self, y):
        """A column-parallel product's output (..., d / M), this rank's
        columns, in place in a zero (..., d): the model ranks' tensors sum
        to the whole product, so `exit` reduces it into the residual
        stream's layout (reduce-scattered along the sequence under SP,
        all-reduced without), and its backward hands each rank the
        gradient of its own columns."""
        n = y.shape[-1]
        first = self.comm.index(self.tp) * n
        return torch.nn.functional.pad(
            y, (first, n * self.tp_size - first - n))

    def to_seq(self, logits):
        """A tensor split over `model` along its last dimension, (B, S,
        n/M), to the sequence-split layout (B, S/M, n): an all-to-all over
        `model` (its backward the inverse one). Vocab-parallel logits go so
        to the `logits` layout, `frame_proj`'s columns under SP to `btd`'s."""
        return c.all_to_all(self.comm, logits, 1, 2, self.tp)

    def seq_start(self, s_local: int) -> int:
        """The first position of this rank's block of the sequence in the
        `logits` layout."""
        return self.comm.index(self.tp) * s_local

    @property
    def heads_cut(self) -> bool:
        """Whether `model` cuts through query heads: it divides their
        columns, not the heads (phi3's 40 over 16: 320 columns, 2.5 heads
        a rank)."""
        return self.cfg.num_heads % self.tp_size != 0

    def head_span(self) -> Tuple[int, int]:
        """This rank's query heads [first, stop): those its block of
        `w_q`'s columns touches, whole. Where `model` divides the heads,
        its own H / M; where it cuts through them, every head its columns
        reach into (3 a rank for phi3 over 16)."""
        hd = self.cfg.head_dim
        c0, c1 = self.tp_block(self.cfg.num_heads * hd)
        return c0 // hd, -(-c1 // hd)

    def q_heads(self, t):
        """This rank's queries (B, S, cols), its block of `w_q`'s columns,
        as whole heads (B, S, h, hd): where `model` cuts through heads,
        every rank's columns all-gathered over `model` and the heads of
        `head_span` taken (the backward reduce-scatters the gradient, so
        a head two ranks share sums their parts)."""
        b, s = t.shape[:2]
        h0, h1 = self.head_span()
        hd = self.cfg.head_dim
        if self.heads_cut:
            t = c.all_gather(self.comm, t, 2, self.tp)[..., h0 * hd:h1 * hd]
        return t.reshape(b, s, h1 - h0, hd)

    def head_cols(self, y):
        """The attention output of this rank's heads (B, S, h * hd) to its
        own block of columns (B, S, cols), the rows of `w_o` it holds:
        itself where `model` divides the heads; else the columns of
        `head_span`'s heads that are the rank's, so the output needs no
        second gather."""
        if not self.heads_cut:
            return y
        c0, c1 = self.tp_block(self.cfg.num_heads * self.cfg.head_dim)
        start = c0 - self.head_span()[0] * self.cfg.head_dim
        return y[..., start:start + c1 - c0]

    def kv_heads(self, t):
        """This rank's keys or values (B, S, cols) as heads (B, S, kv, hd)
        for its query heads (`head_span`): its own KV heads where `model`
        divides them; else (`_group_for_tp`'s expand case, a column block
        cutting through a head) every KV head all-gathered over `model`
        and the ones its query heads read taken, one a query head."""
        cfg = self.cfg
        b, s = t.shape[:2]
        if cfg.num_kv_heads % self.tp_size == 0:
            return t.reshape(b, s, cfg.num_kv_heads // self.tp_size,
                             cfg.head_dim)
        full = c.all_gather(self.comm, t, 2, self.tp).reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        first, stop = self.head_span()
        idx = torch.arange(first, stop, device=t.device) // cfg.q_per_kv
        return full.index_select(2, idx)

    def reduce_loss(self, total, count: int):
        """A sum every rank holds a part of, over every rank, over
        `count`: the loss's mean (its backward passes the gradient
        through)."""
        return c.all_reduce(self.comm, total, self.mesh.axis_names) / count

    def batch_split(self) -> Tuple[int, int]:
        """(this rank's block, the number of blocks) of the global batch,
        as `input_shardings` splits its rows."""
        spec = self.input_shardings({"tokens": torch.empty(
            (self.shape.global_batch, self.shape.seq_len),
            device="meta")})["tokens"]
        axes = _flat_axes(spec[0])
        return (self.comm.index(axes) if axes else 0,
                _axis_size(self.mesh, axes))

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch (numpy arrays or tensors)."""
        from repro_torch.data.pipeline import shard_rows
        i, n = self.batch_split()
        return {k: shard_rows(v, i, n) for k, v in batch.items()}

    def sync_axes(self, path: str) -> Tuple[str, ...]:
        """The axes the gradient of the leaf at `path` is all-reduced over
        after a microbatch: the batch axes its spec leaves replicated, and
        `model` where the spec does not shard it while the model ranks'
        gradients of it differ (under SP every such leaf; the router, the
        xLSTM cells' per-head leaves and MLA's latent norms always:
        `partial_over_model`)."""
        used = {a for axes in self._leaf_spec(path) for a in _flat_axes(axes)}
        rep = [a for a in self.batch_axes if a not in used]
        partial = self.sequence_parallel or partial_over_model(path)
        if partial and self.tp not in used:
            rep.append(self.tp)
        return tuple(a for a in self.mesh.axis_names if a in rep)

    def sync_grads(self, grads):
        """A microbatch's gradients, each all-reduced over the axes its
        leaf is replicated on while its parts differ (`sync_axes`): a
        norm's scale under SP sees only its rank's positions, the router
        only its rank's experts or columns, an xLSTM cell's recurrence
        only its rank's heads. The FSDP reduce-scatters ran in the
        backward."""
        return _map_with_path(lambda path, g: self.comm.all_reduce(
            g, self.sync_axes(path)), grads)

    def global_norm(self, grads):
        """The gradients' global norm over every rank, each element
        counted once: a leaf's squares count on the ranks at coordinate 0
        of every axis its spec does not shard."""
        from repro_torch.optim.adamw import _chunks
        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(grads)[0].device)
        for g, spec in leaf_specs(grads, self.param_specs()):
            used = {a for axes in spec for a in _flat_axes(axes)}
            if not any(self.comm.coords[a] for a in self.mesh.axis_names
                       if a not in used):
                total = total + sum(torch.sum(torch.square(part.float()))
                                    for (part,) in _chunks(g))
        return torch.sqrt(self.comm.all_reduce(total, self.mesh.axis_names))


class Scoped:
    """Executing rules as one layer or sublayer sees them (`ShardingRules.
    at`): its leaves named by their path under `prefix`; everything else
    the rules'. `inner` keeps its products' partial sums and takes its
    input as it comes: a part of a layer that shares the layer's `enter`
    and `exit` (a MoE layer's shared experts)."""

    def __init__(self, rules: ShardingRules, prefix: str,
                 inner: bool = False):
        self.rules, self.prefix, self.inner = rules, prefix, inner

    def __getattr__(self, name):
        return getattr(self.rules, name)

    def _path(self, name: str) -> str:
        return f"{self.prefix}/{name}"

    def at(self, sub: str, inner: bool = False) -> "Scoped":
        return Scoped(self.rules, self._path(sub), inner or self.inner)

    def enter(self, x):
        return x if self.inner else self.rules.enter(x)

    def exit(self, y):
        return y if self.inner else self.rules.exit(y)

    def linear(self, x, w, name: str):
        return self.rules.linear(x, w, self._path(name))

    def whole(self, w, name: str):
        return self.rules.whole(w, self._path(name))

    def gather_dim(self, name: str) -> Tuple[int, Tuple[str, ...]]:
        return self.rules._fsdp_dim(self._path(name))


def _constrain(rules: ShardingRules, x, name: str, spec: PartitionSpec):
    """x as it is; under an active cost trace, the layout change and its
    gradient's recorded (`analysis.trace.Trace.constrain`)."""
    from repro_torch.analysis import trace   # the trace imports the rules
    active: Optional[Any] = trace.active()
    if active is not None:
        return active.constrain(rules, x, name, spec)
    return x


def bat_or_none(bat, dim):
    return bat if dim > 1 else None


def leaf_specs(tree, specs) -> list:
    """(leaf, spec) of every leaf of `tree`, paired by key with `specs` (a
    spec tree of the same nesting, whatever the order of its dicts)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaf_specs(v, specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v, sp in zip(tree, specs) for x in leaf_specs(v, sp)]
    return [(tree, specs)]


def _map_specs(fn, specs, path=()):
    """`fn("a/b/0/w", spec)` over a spec tree (a spec is a leaf)."""
    if isinstance(specs, PartitionSpec):
        return fn("/".join(path), specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, path + (str(k),))
                for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v, path + (str(i),))
                       for i, v in enumerate(specs))


# leaves each rank holds a block of along `model` and uses as its own part
# of the layer (x_proj, dt_proj and w_if are gathered whole: `whole`)
_TP_LEAVES = {"w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down",
              "table", "lm_head", "in_proj", "out_proj", "conv_w", "conv_b",
              "D", "dt_bias", "A_log", "w_dq", "w_dkv", "w_kr", "w_uq",
              "w_uk", "w_uv", "up", "down", "w_in", "frame_proj",
              "img_proj"}


def _unsupported(cfg: ModelConfig, mesh, item: str) -> str:
    return (f"{cfg.name} over a mesh of {mesh.size} ranks {mesh.shape}: "
            f"{item} is not executed yet (ROADMAP A18, executing the plan)")


def check_executable(rules: ShardingRules) -> None:
    """Raise `NotImplementedError`, naming its ROADMAP item, for a config
    or step the executing rules do not run: a train step of anything but
    models of GQA/MHA (logits softcapped or not), sliding-window or MLA
    attention, Mamba mixers and
    xLSTM cells, SwiGLU or MoE FFNs (`dense`, `dropping` or `ragged`
    dispatch, shared experts), an encoder of attention layers that every
    decoder layer cross-attends to (`frames` inputs) or image embeddings
    before the tokens (`tokens+image`), their vocabulary head tied or not,
    its loss whole or chunked, the residual stream sequence-parallel or
    not; and `ValueError` for a step whose shapes the mesh does not split
    evenly (attention heads whose columns do not split either, an xLSTM
    cell's heads, the sequence, the batch, or a leaf a rank takes its
    block of along `model`)."""
    cfg, mesh = rules.cfg, rules.mesh
    kinds = set(cfg.pattern) | set(cfg.ffn_pattern)
    if rules.shape.kind != "train":
        raise NotImplementedError(_unsupported(
            cfg, mesh, f"a {rules.shape.kind} step"))
    m = rules.tp_size
    b, s = rules.shape.global_batch, rules.shape.seq_len
    problems = []
    # an xLSTM cell's heads may also be cut over a multiple of them
    # (`models.xlstm`); attention's split whole, or their columns do
    # (`head_span`: a rank runs every head its columns reach into)
    cells = [(kind, n) for kind, n in (
        (MLSTM, cfg.num_heads),
        (SLSTM, cfg.xlstm and cfg.xlstm.num_heads_slstm)) if kind in kinds]
    for kind, n in cells:
        if n % m and m % n:
            problems.append(f"{n} {kind} heads over model={m}")
    if not cells and cfg.num_heads % m and cfg.num_heads * cfg.head_dim % m:
        problems.append(f"{cfg.num_heads} heads over model={m}")
    if m > 1 and s % m:
        problems.append(f"sequence {s} over model={m}")
    if b % _axis_size(mesh, rules.batch_axes):
        problems.append(f"batch {b} over {rules.batch_axes}")
    if m > 1:
        def one(path, spec):
            if path.rsplit("/", 1)[-1] in _TP_LEAVES and \
                    rules.tp not in _flat_axes(spec):
                problems.append(f"{path} not split over model")
            return spec
        _map_specs(one, rules.param_specs())
    if problems:
        raise ValueError(f"{cfg.name} on {mesh.shape}: "
                         + "; ".join(problems))


def _block(spec, coords, mesh, shape) -> Tuple[slice, ...]:
    """The index of the block at `coords` of a `shape` leaf under `spec`."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        axes = _flat_axes(axes)
        n = _axis_size(mesh, axes)
        i = c.axes_index(mesh, coords, axes)
        out.append(slice(i * dim // n, (i + 1) * dim // n))
    return tuple(out)


def shard_tree(tree, specs, mesh, coords: Dict[str, int]):
    """The block of every whole leaf of `tree` that the device at `coords`
    holds under `specs` (a tree of one nesting, paired by key): contiguous
    copies."""
    return tree_map(lambda t, spec: t[_block(spec, coords, mesh, t.shape)]
                    .contiguous().clone(), tree, specs)


def block_keeper(specs, mesh, coords: Dict[str, int]):
    """`bridge.init_params`'s `keep` for the device at `coords`: the block
    of each whole leaf, by its path, that `shard_tree` cuts (a contiguous
    copy; the whole leaf is the caller's to free)."""
    by_path: Dict[str, PartitionSpec] = {}
    _map_specs(lambda path, spec: by_path.setdefault(path, spec), specs)
    return lambda path, t: t[_block(by_path[path], coords, mesh, t.shape)] \
        .contiguous().clone()


def gather_leaf(t, spec, comm, dst: Optional[int] = None):
    """The whole leaf from every rank's block `t` under `spec`: on every
    rank (all-gathered over the process group where the spec shards it),
    or with `dst` on rank `dst` alone (gathered there; None on the other
    ranks, which hold no more than their block)."""
    mesh = comm.mesh
    whole = list(t.shape)
    for i, axes in enumerate(spec):
        whole[i] *= _axis_size(mesh, axes)
    if tuple(whole) == tuple(t.shape):
        return t if dst is None or comm.rank == dst else None
    if dst is None:
        blocks = list(comm.all_gather(t.contiguous().reshape(1, -1), 0,
                                      mesh.axis_names))
    else:
        blocks = comm.gather(t, dst)
        if blocks is None:
            return None
    out = blocks[0].new_empty(whole)
    for r in range(comm.world):
        out[_block(spec, c.rank_coords(mesh, r), mesh, whole)] = \
            blocks[r].view(t.shape)
    return out


def gather_tree(tree, specs, comm):
    """Whole leaves from every rank's blocks (`shard_tree`'s inverse), on
    every rank."""
    return tree_map(lambda t, spec: gather_leaf(t, spec, comm), tree, specs)


def make_rules(mesh, cfg: ModelConfig, shape: ShapeConfig,
               comm=None) -> ShardingRules:
    """The rules of `mesh`: a plan, or with `comm` (a `collectives.Comm`
    over the same mesh) the executing rules of this rank."""
    return ShardingRules(mesh, cfg, shape, comm)
