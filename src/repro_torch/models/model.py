"""The decoder model: the port of `repro.models.model` for the attention +
dense-FFN pattern (stablelm-1.6b's `(ATTN,)` / `(DENSE,)`).

Params keep the reference's nesting: `embed.table`, `final_norm.scale`,
`lm_head`, and `groups`, a tuple with one layer subtree per pattern entry
whose leaves are stacked along a leading `num_groups` axis. A Python loop
over that axis takes the place of the reference's `lax.scan`. The decode
cache is stacked the same way.

Public surface:
    model = build_model(cfg)
    logits, aux = model.forward(params, batch)
    logits, cache = model.prefill(params, batch, max_seq)   # builds the cache
    logits, cache = model.decode_step(params, cache, tokens, pos)
    cache = model.init_cache(batch_size, max_seq, device)

Other mixer and FFN kinds, the encoder, modality inputs and `first_k_dense`
layers raise `NotImplementedError` until their slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ATTN, DENSE, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_tokens, rmsnorm, swiglu,
                                       torch_dtype, unembed)

Params = Dict[str, Any]


def padded_vocab(cfg: ModelConfig) -> int:
    """Round vocab up to a multiple of 512, as the reference does."""
    return -(-cfg.vocab_size // 512) * 512


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming what this slice does not port."""
    for kind in cfg.pattern:
        if kind != ATTN:
            raise NotImplementedError(f"mixer kind {kind!r} is not ported")
    for kind in cfg.ffn_pattern:
        if kind != DENSE:
            raise NotImplementedError(f"ffn kind {kind!r} is not ported")
    for field, value in (("first_k_dense", cfg.first_k_dense),
                         ("encoder_layers", cfg.encoder_layers)):
        if value:
            raise NotImplementedError(f"{field}={value} is not ported")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"input_mode {cfg.input_mode!r} is not ported")


def _layer(group: Params, g: int) -> Params:
    """Layer `g` of a stacked subtree (views, no copies)."""
    if isinstance(group, dict):
        return {k: _layer(v, g) for k, v in group.items()}
    return group[g]


class Model:
    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    def _layers(self, params: Params):
        """Yield (pattern index, group index, layer params)."""
        cfg = self.cfg
        for g in range(cfg.num_groups):
            for i in range(len(cfg.pattern)):
                yield i, g, _layer(params["groups"][i], g)

    def _ffn(self, lp: Params, h):
        f_in = rmsnorm(lp["post_norm"], h, self.cfg.norm_eps)
        return h + swiglu(lp["ffn"], f_in)

    def _logits(self, params: Params, h):
        cfg = self.cfg
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return unembed(params["embed"], h, cfg.tie_embeddings,
                       params.get("lm_head"))

    # ------------------------------------------------------------- forward

    def forward(self, params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence logits (B,S,V_padded) and the aux losses (zero:
        the pattern has no MoE layer)."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], batch["tokens"])
        for _, _, lp in self._layers(params):
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            h = h + attn.attention_forward(lp["mixer"], cfg, mix_in)
            h = self._ffn(lp, h)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        return self._logits(params, h), {"moe_lb_loss": zero,
                                         "moe_z_loss": zero}

    # ------------------------------------------------------------- caches

    def init_cache(self, batch: int, max_seq: int, device=None,
                   dtype=None) -> Params:
        cfg = self.cfg
        dt = dtype or torch_dtype(cfg.param_dtype)
        return {"groups": tuple(
            attn.init_attn_cache(cfg, batch, max_seq, dtype=dt, device=device,
                                 lead=(cfg.num_groups,))
            for _ in cfg.pattern)}

    # ------------------------------------------------------------ prefill

    def prefill(self, params: Params, batch, max_seq: int = 0):
        """Full-sequence forward that also builds the decode cache. Returns
        the last position's logits (B,1,V_padded), padded rows unmasked as
        in the reference."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = embed_tokens(params["embed"], tokens)
        max_seq = max_seq or tokens.shape[1]
        cache = self.init_cache(tokens.shape[0], max_seq, h.device, h.dtype)
        for i, g, lp in self._layers(params):
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            out, c = attn.attention_prefill(lp["mixer"], cfg, mix_in,
                                            max_seq=max_seq)
            for key, val in c.items():
                cache["groups"][i][key][g] = val
            h = self._ffn(lp, h + out)
        return self._logits(params, h[:, -1:]), cache

    # ------------------------------------------------------------- decode

    def decode_step(self, params: Params, cache: Params, tokens, pos):
        """tokens: (B,1) int; pos: position of the new token -> (logits
        (B,1,V_padded), cache). The cache is updated in place."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        for i, g, lp in self._layers(params):
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            out, _ = attn.attention_decode(lp["mixer"], cfg, mix_in,
                                           _layer(cache["groups"][i], g), pos)
            h = self._ffn(lp, h + out)
        return self._logits(params, h), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
