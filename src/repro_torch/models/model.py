"""The decoder model: the port of `repro.models.model` for the mixer kinds
attention (GQA), sliding-window attention, Mamba, sLSTM and mLSTM, with
dense (SwiGLU), MoE or no FFN: stablelm-1.6b's `(ATTN,)`/`(DENSE,)`,
xlstm-125m's `(SLSTM, MLSTM)`/`(NONE, NONE)`, mixtral-8x22b's
`(SWA,)`/`(MOE,)` and jamba's 8-layer group of 7 Mamba layers and one
attention layer with dense and MoE FFNs in turn. On the card the attention
layers' full-sequence forward runs the flash attention kernel, the mLSTM
layers the mlstm_scan kernel and the Mamba layers the ssm_scan kernel.

Params keep the reference's nesting: `embed.table`, `final_norm.scale`,
`lm_head` (absent with tied embeddings), and `groups`, a tuple with one
layer subtree per pattern entry whose leaves are stacked along a leading
`num_groups` axis. A Python loop over that axis takes the place of the
reference's `lax.scan`. The decode cache is stacked the same way.

Public surface:
    model = build_model(cfg)
    logits, aux = model.forward(params, batch)
    loss, aux = model.loss_fn(params, batch)
    logits, cache = model.prefill(params, batch, max_seq)   # builds the cache
    logits, cache = model.decode_step(params, cache, tokens, pos)
    cache = model.init_cache(batch_size, max_seq, device)

MoE layers add their aux losses across layers in `forward` and `loss_fn`;
prefill and decode drop them, as the reference does. MLA, the encoder,
modality inputs, `first_k_dense` layers and the chunked loss raise
`NotImplementedError` until their slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MLSTM, MOE, NONE,
                                      SLSTM, SWA, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm, xlstm
from repro_torch.models.layers import (embed_tokens, rmsnorm, softmax_xent,
                                       swiglu, torch_dtype, unembed)

Params = Dict[str, Any]
MIXERS = (ATTN, SWA, MAMBA, SLSTM, MLSTM)
FFNS = (DENSE, MOE, NONE)


def padded_vocab(cfg: ModelConfig) -> int:
    """Round vocab up to a multiple of 512, as the reference does."""
    return -(-cfg.vocab_size // 512) * 512


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming what the port does not have yet."""
    for kind in cfg.pattern:
        if kind not in MIXERS:
            raise NotImplementedError(f"mixer kind {kind!r} is not ported")
    for kind in cfg.ffn_pattern:
        if kind not in FFNS:
            raise NotImplementedError(f"ffn kind {kind!r} is not ported")
    if (SLSTM in cfg.pattern or MLSTM in cfg.pattern) and cfg.xlstm is None:
        raise ValueError(f"{cfg.name}: xLSTM layers need cfg.xlstm")
    if MAMBA in cfg.pattern and cfg.mamba is None:
        raise ValueError(f"{cfg.name}: Mamba layers need cfg.mamba")
    if MOE in cfg.ffn_pattern and cfg.moe is None:
        raise ValueError(f"{cfg.name}: MoE layers need cfg.moe")
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


def _store(stacked: Params, g: int, core: Params) -> None:
    """Write one layer's cache entries into the stacked cache, in place. A
    conv tail shorter than the cache's (a prompt shorter than the conv
    kernel) goes to its end: the zero rows before it are the conv's own
    left padding."""
    for key, val in core.items():
        dst = stacked[key][g]
        if key == "conv":
            dst = dst[:, dst.shape[1] - val.shape[1]:]
        dst.copy_(val)


class Model:
    # vocabularies at/above this size use the chunked loss (not ported)
    CHUNKED_LOSS_VOCAB = 131_072

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    def _layers(self, params: Params):
        """Yield (pattern index, group index, layer params)."""
        cfg = self.cfg
        for g in range(cfg.num_groups):
            for i in range(len(cfg.pattern)):
                yield i, g, _layer(params["groups"][i], g)

    def _ffn(self, lp: Params, i: int, h, aux=None):
        """h + the layer's FFN; a MoE layer adds its aux losses into `aux`
        (in place) where one is given."""
        kind = self.cfg.ffn_pattern[i]
        if kind == NONE:
            return h
        f_in = rmsnorm(lp["post_norm"], h, self.cfg.norm_eps)
        if kind == DENSE:
            return h + swiglu(lp["ffn"], f_in)
        y, moe_aux = moe.moe_apply(lp["ffn"], self.cfg, f_in)
        if aux is not None:
            for k in aux:
                aux[k] = aux[k] + moe_aux[k]
        return h + y

    def _logits(self, params: Params, h):
        cfg = self.cfg
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return unembed(params["embed"], h, cfg.tie_embeddings,
                       params.get("lm_head"))

    @staticmethod
    def _zero_aux(device) -> Dict[str, torch.Tensor]:
        """The MoE aux losses before the first layer: zero."""
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return {"moe_lb_loss": zero, "moe_z_loss": zero}

    # ------------------------------------------------------------- forward

    def _window(self, kind: str) -> int:
        return self.cfg.window_size if kind == SWA else 0

    def _mix(self, lp: Params, kind: str, x):
        cfg = self.cfg
        if kind in (ATTN, SWA):
            return attn.attention_forward(lp["mixer"], cfg, x,
                                          window=self._window(kind))
        if kind == MAMBA:
            return ssm.mamba_mix(lp["mixer"], cfg, x)[0]
        if kind == MLSTM:
            return xlstm.mlstm_mix(lp["mixer"], cfg, x)[0]
        return xlstm.slstm_mix(lp["mixer"], cfg, x)[0]

    def _backbone(self, params: Params, tokens):
        """Hidden states before the final norm, and the aux losses."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        aux = self._zero_aux(h.device)
        for i, _, lp in self._layers(params):
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            h = self._ffn(lp, i, h + self._mix(lp, cfg.pattern[i], mix_in),
                          aux)
        return h, aux

    def forward(self, params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence logits (B,S,V_padded) and the aux losses."""
        h, aux = self._backbone(params, batch["tokens"])
        return self._logits(params, h), aux

    def loss_fn(self, params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy over the unchunked logits, padded
        vocab rows masked to -1e30; total = xent + 0.01 lb + 1e-3 z."""
        cfg = self.cfg
        vp = padded_vocab(cfg)
        tokens = batch["tokens"]
        if vp >= self.CHUNKED_LOSS_VOCAB and tokens.shape[1] > 1024:
            raise NotImplementedError("the chunked loss is not ported")
        logits, aux = self.forward(params, batch)
        if vp != cfg.vocab_size:
            pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
            logits = torch.where(pad, -1e30, logits.float())
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:],
                            logit_softcap=cfg.logit_softcap)
        total = loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        return total, dict(aux, xent=loss)

    # ------------------------------------------------------------- caches

    def _init_layer_cache(self, kind: str, batch: int, max_seq: int, dt,
                          device) -> Params:
        cfg = self.cfg
        lead = (cfg.num_groups,)
        if kind in (ATTN, SWA):
            return attn.init_attn_cache(cfg, batch, max_seq,
                                        window=self._window(kind), dtype=dt,
                                        device=device, lead=lead)
        if kind == MAMBA:
            return ssm.init_mamba_cache(cfg, batch, dt, device, lead)
        if kind == MLSTM:
            return xlstm.init_mlstm_cache(cfg, batch, dt, device, lead)
        return xlstm.init_slstm_cache(cfg, batch, dt, device, lead)

    def init_cache(self, batch: int, max_seq: int, device=None,
                   dtype=None) -> Params:
        dt = dtype or torch_dtype(self.cfg.param_dtype)
        return {"groups": tuple(
            self._init_layer_cache(kind, batch, max_seq, dt, device)
            for kind in self.cfg.pattern)}

    # ------------------------------------------------------------ prefill

    def _mix_prefill(self, lp: Params, kind: str, x, max_seq: int):
        cfg = self.cfg
        if kind in (ATTN, SWA):
            return attn.attention_prefill(lp["mixer"], cfg, x,
                                          window=self._window(kind),
                                          max_seq=max_seq)
        if kind == MAMBA:
            out, (h_last, tail) = ssm.mamba_mix(lp["mixer"], cfg, x)
            return out, {"h": h_last, "conv": tail}
        if kind == MLSTM:
            out, ((c, n, m), tail) = xlstm.mlstm_mix(lp["mixer"], cfg, x)
            return out, {"C": c, "n": n, "m": m, "conv": tail}
        out, ((c, n, m, hh), tail) = xlstm.slstm_mix(lp["mixer"], cfg, x)
        return out, {"c": c, "n": n, "m": m, "h": hh, "conv": tail}

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
            out, core = self._mix_prefill(lp, cfg.pattern[i], mix_in, max_seq)
            _store(cache["groups"][i], g, core)
            h = self._ffn(lp, i, h + out)
        return self._logits(params, h[:, -1:]), cache

    # ------------------------------------------------------------- decode

    def decode_step(self, params: Params, cache: Params, tokens, pos):
        """tokens: (B,1) int; pos: position of the new token -> (logits
        (B,1,V_padded), cache). The cache is updated in place."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        for i, g, lp in self._layers(params):
            kind = cfg.pattern[i]
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            layer_cache = _layer(cache["groups"][i], g)
            if kind in (ATTN, SWA):
                out, _ = attn.attention_decode(lp["mixer"], cfg, mix_in,
                                               layer_cache, pos,
                                               window=self._window(kind))
            else:
                decode = {MAMBA: ssm.mamba_decode, MLSTM: xlstm.mlstm_decode,
                          SLSTM: xlstm.slstm_decode}[kind]
                out, core = decode(lp["mixer"], cfg, mix_in, layer_cache)
                _store(cache["groups"][i], g, core)
            h = self._ffn(lp, i, h + out)
        return self._logits(params, h), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
