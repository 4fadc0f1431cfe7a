"""Weights across the two packages, and random weights for the port.

`params_from_numpy` takes the reference's params pytree as
`jax.tree.map(np.asarray, params)` gives it (nested dict/tuple/list of
numpy arrays) and returns the same nesting of tensors, the stacked `groups`
leaves included. `params_to_numpy` is the reverse. A bf16 leaf is an
`ml_dtypes.bfloat16` array, which `torch.from_numpy` rejects: it crosses as
its uint16 bits.

`init_params` draws the port's own weights with the reference's
distributions. torch cannot reproduce `jax.random`, so parity tests always
carry JAX-initialized weights across with `params_from_numpy`.
`param_shapes` is the port's `jax.eval_shape(model.init)`: the same tree
as meta tensors, drawn from no generator.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MLA, MLSTM, MOE,
                                      NONE, SLSTM, SWA, ModelConfig)
from repro_torch.models.attention import (attention_init,
                                          cross_attention_init, mla_init)
from repro_torch.models.layers import (dense_init, embedding_init,
                                       rmsnorm_init, swiglu_init, torch_dtype)
from repro_torch.models.model import (_dense_ffn_width, check_supported,
                                      padded_vocab)
from repro_torch.models.moe import moe_init
from repro_torch.models.ssm import mamba_init
from repro_torch.models.xlstm import mlstm_init, slstm_init
from repro_torch.tree import tree_map


def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), order="C")
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array on the host: a copy from the card, a view
    of a CPU tensor; bf16 as `ml_dtypes.bfloat16`."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only where bf16 arrays are wanted back
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Any, device) -> Any:
    """numpy pytree -> tensor pytree on `device`, same nesting."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """tensor pytree -> numpy pytree (bf16 as `ml_dtypes.bfloat16`)."""
    return tree_map(leaf_to_numpy, tree)


def params_to(tree: Any, device) -> Any:
    """The same pytree with every tensor on `device` (no copy where it is
    already there)."""
    return tree_map(lambda t: t.to(device), tree)


Keep = Optional[Callable[[str, torch.Tensor], torch.Tensor]]


def _kept(keep: Keep, path: str, tree):
    """`tree` (a leaf or a dict of them) as `keep(path, leaf)` leaves it,
    each leaf named by its path in the params; itself without `keep`."""
    if keep is None:
        return tree
    if isinstance(tree, dict):
        return {k: _kept(keep, f"{path}/{k}", v) for k, v in tree.items()}
    return keep(path, tree)


def _init_layer(cfg: ModelConfig, generator: torch.Generator, kind: str,
                ffn: str, with_cross: bool, lead, device, keep: Keep = None,
                path: str = "") -> dict:
    """One layer subtree with the reference's nesting (`_init_layer`):
    pre_norm, mixer, then cross_norm and cross, then post_norm and ffn;
    each part through `keep` as soon as it is drawn (`path`: the layer's
    in the params)."""
    dt = torch_dtype(cfg.param_dtype)
    mixer_init = {ATTN: attention_init, SWA: attention_init, MLA: mla_init,
                  MAMBA: mamba_init, MLSTM: mlstm_init, SLSTM: slstm_init}
    layer = {}

    def put(name, sub):
        layer[name] = _kept(keep, f"{path}/{name}", sub)
    put("pre_norm", rmsnorm_init(cfg.d_model, dt, device, lead))
    put("mixer", mixer_init[kind](generator, cfg, lead))
    if with_cross:
        put("cross_norm", rmsnorm_init(cfg.d_model, dt, device, lead))
        put("cross", cross_attention_init(generator, cfg, lead))
    if ffn in (DENSE, MOE):
        put("post_norm", rmsnorm_init(cfg.d_model, dt, device, lead))
    if ffn == DENSE:
        put("ffn", swiglu_init(generator, cfg.d_model,
                               cfg.d_ff or 4 * cfg.d_model, dt, lead))
    elif ffn == MOE:
        put("ffn", moe_init(generator, cfg, lead))
    return layer


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on `meta`: the init's shapes and
    dtypes, no numbers."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Any:
    """The params tree of `init_params` as meta tensors (shapes, dtypes and
    nesting; no data, no device): the port's `jax.eval_shape(model.init)`.
    `init_params` takes a generator on the device it draws on, and no
    generator lives on `meta`: this draws the tree there through a CPU
    generator that reports `meta` as its device."""
    return init_params(cfg, _MetaGenerator())


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, keep: Keep = None) -> Any:
    """Random params with the reference's distributions (`Model.init`):
    dense weights normal * 1/sqrt(d_in), the embedding normal * 0.02, norm
    scales ones; for xLSTM layers the conv normal * 1/sqrt(kernel), the
    sLSTM recurrence normal * 1/sqrt(head_dim), the gate biases [0]*h ++
    [3]*h (mLSTM) and [0]*d ++ [3]*d ++ [0]*2d (sLSTM), and the gate
    weights `w_if`, `w_in` in fp32 whatever `param_dtype` is; for Mamba
    layers the conv normal * 1/sqrt(d_conv), `dt_proj` fp32 normal *
    dt_rank^-0.5, `dt_bias` the inverse softplus of a log-uniform draw in
    [1e-3, 1e-1], `A_log` log(1..d_state) and `D` ones, the last four in
    fp32 whatever `param_dtype` is; for MoE layers the router fp32 normal *
    1/sqrt(d_model), the experts' `w_gate`/`w_up` (E,d,f) normal *
    1/sqrt(d) and `w_down` (E,f,d) normal * 1/sqrt(f); for MLA layers
    `w_uk`/`w_uv` (kv_lora_rank, h, e) normal * 1/sqrt(kv_lora_rank) and
    the `q_norm`/`kv_norm` scales ones. The `first` layers (a list) take
    `pattern[0]`'s mixer and a dense FFN of `_dense_ffn_width`; an
    encoder-decoder has the `encoder` subtree (`layers` stacked along
    `encoder_layers`: attention and dense FFN, no cross) and every decoder
    layer `cross_norm`/`cross`; `frames` input has `frame_proj`
    (frame_dim or d_model, d_model), `tokens+image` `img_proj` (d_model,
    d_model). Drawn in fp32 on `device`, which must be the generator's
    (default), and stored there in `cfg.param_dtype`. Tied embeddings have
    no `lm_head`.

    `keep(path, leaf)`, where given, takes each leaf as soon as its part
    of the tree is drawn (a norm, a mixer, an FFN, the table, a
    projection; "groups/0/mixer/w_q" names a leaf as
    `sharding._map_with_path` does) and returns what the tree holds of it:
    a rank's block (`sharding.block_keeper`), the whole leaf freed. The
    draws are the same, in the same order, so the blocks are the whole
    tree's bit for bit, and the init's peak is the largest part drawn."""
    check_supported(cfg)
    device = generator.device if device is None else torch.device(device)
    if device.type != generator.device.type:
        raise ValueError(f"generator on {generator.device}, params wanted "
                         f"on {device}: draw them where they will live")
    dt = torch_dtype(cfg.param_dtype)
    vp = padded_vocab(cfg)
    with_cross = cfg.encoder_layers > 0
    p = {}

    def put(name, sub):
        p[name] = _kept(keep, name, sub)
    put("embed", embedding_init(generator, vp, cfg.d_model, dt))
    put("final_norm", rmsnorm_init(cfg.d_model, dt, device))
    if not cfg.tie_embeddings:
        put("lm_head", dense_init(generator, cfg.d_model, vp, dt))
    if cfg.input_mode == "frames":
        put("frame_proj", dense_init(generator, cfg.frame_dim or cfg.d_model,
                                     cfg.d_model, dt))
    if cfg.input_mode == "tokens+image":
        put("img_proj", dense_init(generator, cfg.d_model, cfg.d_model, dt))
    p["groups"] = tuple(
        _init_layer(cfg, generator, kind, ffn, with_cross, (cfg.num_groups,),
                    device, keep, f"groups/{i}")
        for i, (kind, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)))
    if cfg.first_k_dense:
        first = []
        for j in range(cfg.first_k_dense):
            layer = _init_layer(cfg, generator, cfg.pattern[0], NONE,
                                with_cross, (), device, keep, f"first/{j}")
            layer["post_norm"] = _kept(keep, f"first/{j}/post_norm",
                                       rmsnorm_init(cfg.d_model, dt, device))
            layer["ffn"] = _kept(keep, f"first/{j}/ffn", swiglu_init(
                generator, cfg.d_model, _dense_ffn_width(cfg), dt))
            first.append(layer)
        p["first"] = first
    if cfg.encoder_layers:
        p["encoder"] = {
            "layers": _init_layer(cfg, generator, ATTN, DENSE, False,
                                  (cfg.encoder_layers,), device, keep,
                                  "encoder/layers"),
            "final_norm": _kept(keep, "encoder/final_norm",
                                rmsnorm_init(cfg.d_model, dt, device))}
    return p
