"""The unified model: the port of `repro.models.model`. Every architecture of
the reference's registry is an instance of this composable decoder,
optionally with an encoder stack and a modality input.

Mixer kinds: attention (GQA), sliding-window attention, MLA, Mamba, sLSTM
and mLSTM. FFN kinds: dense (SwiGLU), MoE, none. `first_k_dense` leading
layers take `pattern[0]`'s mixer and a dense FFN of `_dense_ffn_width`
(deepseek-v2). An encoder (`encoder_layers > 0`, seamless-m4t) runs
non-causal attention layers over projected `frames`, and every decoder
layer cross-attends to its output. `tokens+image` inputs (internvl2) put
projected image embeddings before the token embeddings. On the card the
attention layers' full-sequence forward (self, encoder, cross and MLA) runs
the flash attention kernel, the mLSTM layers the mlstm_scan kernel and the
Mamba layers the ssm_scan kernel.

Params keep the reference's nesting: `embed.table`, `final_norm.scale`,
`lm_head` (absent with tied embeddings), `frame_proj` / `img_proj`, `first`
(a list of layer subtrees), `encoder` (`layers`, stacked along a leading
`encoder_layers` axis, and `final_norm`), and `groups`, a tuple with one
layer subtree per pattern entry whose leaves are stacked along a leading
`num_groups` axis. A Python loop over those axes takes the place of the
reference's `lax.scan`. The decode cache is nested the same way (`first`,
`groups`); an encoder-decoder's layer caches hold `cross_k`/`cross_v`.

Public surface:
    model = build_model(cfg, rules=None)
    logits, aux = model.forward(params, batch)
    loss, aux = model.loss_fn(params, batch)
    logits, cache = model.prefill(params, batch, max_seq)   # builds the cache
    logits, cache = model.decode_step(params, cache, tokens, pos)
    cache = model.init_cache(batch_size, max_seq, device)

`batch` holds `tokens`, and `frames` (B,T,frame_dim) for `frames` input or
`image_embeds` (B,num_image_tokens,d) for `tokens+image`. MoE layers add
their aux losses across layers in `forward` and `loss_fn`; prefill and
decode drop them, as the reference does. Vocabularies of
`CHUNKED_LOSS_VOCAB` and up take the chunked loss above 1024 positions.

The config's `remat_policy` applies under autograd, as the reference's
`_remat` does: each decoder group and each encoder layer runs inside a
non-reentrant `torch.utils.checkpoint` (the `first` layers run outside it,
as the reference runs them outside its scan). `"full"` keeps every
activation; `"nothing"` keeps only the group's inputs and recomputes the
rest in the backward; `"dots"` also keeps the outputs of the weight GEMMs
(`save_dots`, JAX's `dots_with_no_batch_dims_saveable`). A kernel inside a
recomputed group launches again in the backward, into fresh buffers.

`rules` (a `parallel.sharding.ShardingRules`) are the reference's three
hooks at its points: `_act` constrains the residual stream after each
mixer, cross-attention and FFN, the embedded inputs and the logits
(forward, loss and prefill; decode takes none), `_moe_shard` the MoE
dispatch, and `_attn_tp` expands the KV heads to the query heads where the
model axis divides H but not Kv (`attention._group_for_tp`). A constraint
returns its tensor as it is: under the dry run's trace it records a
layout change. At world size 1 the model axis is 1 and nothing expands;
without rules the model is the card's.

Executing rules (`ShardingRules` with a `comm`, over a process group) make
`loss_fn` rank-local for the configs `sharding.check_executable` passes:
params are the rank's blocks, the batch its rows; the embedding is
vocab-parallel, each layer's attention (global, windowed or MLA), Mamba
mixer, xLSTM cell and FFN (SwiGLU or MoE) compute the rank's heads,
`d_inner` channels, `d_ff` columns or experts on the residual stream the
rules move (`enter`, `exit`), each layer seeing the rules at its path in
the params (`ShardingRules.at`); a MoE layer's aux losses are already the
global batch's; an encoder's layers run as the decoder's (at
"encoder/layers") from `frame_proj`'s column blocks, its output is
entered whole along the sequence once and every decoder layer's
cross-attention takes its rank's heads of it; image rows go before the
tokens in one reduction into the residual stream (`_rank_inputs`); a
tied head reads the rank's rows of the table the lookup gathered, an
untied one its `lm_head` columns; and the loss is taken on the rank's
positions of the sequence-parallel logits (image positions predict
nothing), or where the chunked loss applies over the rank's vocab
columns chunk by chunk (`_vocab_parallel_xent`), and summed over every
rank. Forward, prefill and
decode stay world-size-1 paths. The remat's recompute stops, as at world
size 1, once it has remade what the backward needs: the reduce-scatter
or all-reduce of a group's output does not run again (its last product,
`gathered_mm`, does: a custom op saves its inputs after it runs).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MLA, MLSTM, MOE,
                                      NONE, SLSTM, SWA, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm, xlstm
from repro_torch.models.layers import (LOCAL, embed_tokens, rmsnorm,
                                       softmax_xent, swiglu, torch_dtype,
                                       unembed)
from repro_torch.parallel.collectives import (GATHERED_MM, all_reduce,
                                              all_reduce_backward)

Params = Dict[str, Any]
MIXERS = (ATTN, SWA, MLA, MAMBA, SLSTM, MLSTM)
FFNS = (DENSE, MOE, NONE)
INPUT_MODES = ("tokens", "frames", "tokens+image")


def padded_vocab(cfg: ModelConfig) -> int:
    """Round vocab up to a multiple of 512, as the reference does."""
    return -(-cfg.vocab_size // 512) * 512


def _dense_ffn_width(cfg: ModelConfig) -> int:
    """The dense FFN of a `first_k_dense` layer: deepseek-style, wider than
    a routed expert when the config's d_ff is the expert width."""
    if cfg.moe is not None and cfg.d_ff < cfg.d_model:
        return 2 * cfg.d_model
    return cfg.d_ff or 4 * cfg.d_model


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a kind the port does not know, or a layer kind without its
    sub-config."""
    for kind in cfg.pattern:
        if kind not in MIXERS:
            raise NotImplementedError(f"mixer kind {kind!r} is not ported")
    for kind in cfg.ffn_pattern:
        if kind not in FFNS:
            raise NotImplementedError(f"ffn kind {kind!r} is not ported")
    if cfg.input_mode not in INPUT_MODES:
        raise NotImplementedError(f"input_mode {cfg.input_mode!r} is not "
                                  "ported")
    if (SLSTM in cfg.pattern or MLSTM in cfg.pattern) and cfg.xlstm is None:
        raise ValueError(f"{cfg.name}: xLSTM layers need cfg.xlstm")
    if MAMBA in cfg.pattern and cfg.mamba is None:
        raise ValueError(f"{cfg.name}: Mamba layers need cfg.mamba")
    if MLA in cfg.pattern and cfg.mla is None:
        raise ValueError(f"{cfg.name}: MLA layers need cfg.mla")
    if MOE in cfg.ffn_pattern and cfg.moe is None:
        raise ValueError(f"{cfg.name}: MoE layers need cfg.moe")


_aten = torch.ops.aten


def save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The `"dots"` policy: keep the output of a matrix product with no
    batch dimension, recompute everything else. A weight GEMM reaches the
    policy as `aten.mm` (`x @ w`) or as an `aten.bmm` of batch 1 (what
    `einsum("btd,df->btf")` becomes); attention's and the experts' products
    are `bmm`s of a batch above 1. So the batch size decides, not the op's
    name. Allocations (`torch.empty`, the buffers a kernel writes) are
    never kept. A sharded weight's product (`collectives.gathered_mm`) is
    kept too, so its recompute gathers nothing, unless it is a batch of
    products above 1 (a rank's experts), which is recomputed and gathers
    its weights again."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1) or (
            op is GATHERED_MM and (args[1].dim() == 2
                                   or args[1].shape[0] == 1)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer(group: Params, g: int) -> Params:
    """Layer `g` of a stacked subtree (views, no copies)."""
    if isinstance(group, dict):
        return {k: _layer(v, g) for k, v in group.items()}
    return group[g]


def _cache_view(cache: Params, slot) -> Params:
    """The cache entries of the layer at `slot` (views, no copies)."""
    part, i, g = slot
    entry = cache[part][i]
    return entry if g is None else _layer(entry, g)


def _store(cache: Params, slot, core: Params) -> None:
    """Write one layer's cache entries into the cache, in place. A conv
    tail shorter than the cache's (a prompt shorter than the conv kernel)
    goes to its end: the zero rows before it are the conv's own left
    padding. Cross keys and values of an encoder shorter than `max_seq`
    go to the front: the zero slots after them are the reference's pads."""
    part, i, g = slot
    entry = cache[part][i]
    for key, val in core.items():
        dst = entry[key] if g is None else entry[key][g]
        if key == "conv":
            dst = dst[:, dst.shape[1] - val.shape[1]:]
        elif key in ("cross_k", "cross_v"):
            dst = dst[:, :val.shape[1]]
        dst.copy_(val)


class Model:
    # vocabularies at/above this size use the chunked loss
    CHUNKED_LOSS_VOCAB = 131_072

    def __init__(self, cfg: ModelConfig, rules=None):
        check_supported(cfg)
        self.cfg = cfg
        self.rules = rules
        # executing rules: this rank's part of the step
        self.tp = rules if rules is not None and rules.executing else None

    # -------------------------------------------------------------- shards

    def _act(self, x, name="btd"):
        if self.rules is not None:
            return self.rules.constrain_act(x, name)
        return x

    def _moe_shard(self):
        if self.rules is not None:
            return self.rules.constrain_moe
        return None

    def _shard_act(self):
        """`constrain_act` as a mixer's `shard_fn(x, name)`; None without
        rules."""
        if self.rules is None:
            return None
        return self.rules.constrain_act

    def _attn_tp(self):
        """(expand_kv, shard_fn): expand KV to full heads when TP divides H
        but not Kv (see attention._group_for_tp)."""
        cfg = self.cfg
        if self.rules is None or self.tp is not None:   # a rank's heads
            return False, None
        tp = self.rules.tp_size
        expand = (cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp != 0
                  and cfg.q_per_kv > 1)
        return expand, (lambda a, nm: self.rules.constrain_act(a, nm))

    def _tp_at(self, where):
        """The executing rules as the layer at `where` ("groups/1",
        "first/0") sees them; None without them."""
        return None if self.tp is None or where is None \
            else self.tp.at(where)

    def _layers(self, params: Params):
        """Yield (mixer kind, ffn kind, layer params, cache slot) for every
        decoder layer in order: the `first` layers, then the groups. A slot
        is (cache part, index in it, group index or None)."""
        cfg = self.cfg
        for j, lp in enumerate(params.get("first", [])):
            yield cfg.pattern[0], DENSE, lp, ("first", j, None)
        for g in range(cfg.num_groups):
            for i, kind in enumerate(cfg.pattern):
                yield (kind, cfg.ffn_pattern[i], _layer(params["groups"][i], g),
                       ("groups", i, g))

    def _ffn(self, lp: Params, kind: str, h, aux=None, tp=None):
        """h + the layer's FFN; a MoE layer adds its aux losses into `aux`
        (in place) where one is given. `tp`: the executing rules at this
        layer (`_tp_at`)."""
        if kind == NONE:
            return h
        f_in = rmsnorm(lp["post_norm"], h, self.cfg.norm_eps)
        tp = None if tp is None else tp.at("ffn")
        if kind == DENSE:
            return h + swiglu(lp["ffn"], f_in, LOCAL if tp is None else tp)
        y, moe_aux = moe.moe_apply(lp["ffn"], self.cfg, f_in,
                                   self._moe_shard(), tp)
        if tp is None and self.rules is not None and aux is not None \
                and torch.is_grad_enabled():
            # the plan of the executed layer's one all-reduce of its sums
            self.rules.constrain_moe("moe_aux", torch.empty(
                2 * self.cfg.moe.num_experts + 1, device=h.device))
        if aux is not None:
            for k in aux:
                aux[k] = aux[k] + moe_aux[k]
        return h + y

    def _unembed(self, params: Params, h):
        return unembed(params["embed"], h, self.cfg.tie_embeddings,
                       params.get("lm_head"))

    @staticmethod
    def _zero_aux(device) -> Dict[str, torch.Tensor]:
        """The MoE aux losses before the first layer: zero."""
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return {"moe_lb_loss": zero, "moe_z_loss": zero}

    # ------------------------------------------------------------- forward

    def _window(self, kind: str) -> int:
        return self.cfg.window_size if kind == SWA else 0

    def _mix(self, lp: Params, kind: str, x, tp=None):
        cfg = self.cfg
        tp = None if tp is None else tp.at("mixer")
        if kind in (ATTN, SWA):
            expand, sf = self._attn_tp()
            return attn.attention_forward(lp["mixer"], cfg, x,
                                          window=self._window(kind),
                                          expand_kv=expand, shard_fn=sf,
                                          tp=tp)
        if kind == MLA:
            return attn.mla_forward(lp["mixer"], cfg, x,
                                    shard_fn=self._shard_act(), tp=tp)
        if tp is not None:
            rank_mix = {MAMBA: ssm.mamba_mix_rank,
                        MLSTM: xlstm.mlstm_mix_rank,
                        SLSTM: xlstm.slstm_mix_rank}[kind]
            return rank_mix(lp["mixer"], cfg, x, tp)
        mix = {MAMBA: ssm.mamba_mix, MLSTM: xlstm.mlstm_mix,
               SLSTM: xlstm.slstm_mix}[kind]
        return mix(lp["mixer"], cfg, x, shard_fn=self._shard_act())[0]

    def _remat(self, fn):
        """`fn` under the config's remat policy: `"full"` as it is,
        `"dots"` checkpointed keeping `save_dots`'s products, anything else
        (`"nothing"`) checkpointed keeping only its inputs. Without grad
        `fn` runs as it is."""
        pol = self.cfg.remat_policy
        if pol == "full":
            return fn
        kw = {}
        if pol == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, save_dots)

        def run(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return run

    def _layer_forward(self, lp: Params, kind: str, ffn: str, h, aux,
                       enc_out=None, where=None):
        """One decoder layer: mixer, cross-attention to the encoder where
        there is one, FFN (a MoE layer adds its aux losses into `aux`).
        `where` is the layer's path in the params ("groups/1")."""
        cfg = self.cfg
        tp = self._tp_at(where)
        mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
        h = self._act(h + self._mix(lp, kind, mix_in, tp))
        if enc_out is not None and "cross" in lp:
            ctp = None if tp is None else tp.at("cross")
            h = self._act(self._cross(lp, h, attn.encode_cross_kv(
                lp["cross"], cfg, enc_out, ctp), ctp))
        return self._ffn_act(lp, ffn, h, aux, tp)

    def _ffn_act(self, lp: Params, kind: str, h, aux=None, tp=None):
        """`_ffn`, its output constrained where there is an FFN."""
        out = self._ffn(lp, kind, h, aux, tp)
        return out if kind == NONE else self._act(out)

    def _cross(self, lp: Params, h, enc_kv, tp=None):
        """h + cross-attention to the encoder's keys and values (`tp`: the
        executing rules at the layer's `cross`)."""
        c_in = rmsnorm(lp["cross_norm"], h, self.cfg.norm_eps)
        return h + attn.cross_attention_forward(lp["cross"], self.cfg, c_in,
                                                enc_kv, tp)

    def _encode(self, params: Params, frames):
        """The encoder: projected frames through its non-causal attention
        layers with dense FFNs, then its final norm. Under executing rules
        `frame_proj`'s column blocks go to the residual stream's layout:
        under SP by an all-to-all to the rank's positions (`to_seq`); else
        summed whole on every rank (`pad_cols`, `exit`), since there the
        stream's gradient is whole on every rank and the all-reduce's
        backward passes it to `pad_cols`, which takes the rank's columns.
        Each layer computes its rank's heads and `d_ff` columns, as a
        decoder layer does."""
        cfg = self.cfg
        enc = params["encoder"]
        x = frames.to(params["frame_proj"].dtype)
        if self.tp is None:
            h = self._act(x @ params["frame_proj"], "enc_in")
        else:
            y = self.tp.linear(x, params["frame_proj"], "frame_proj")
            h = (self.tp.to_seq(y) if self.tp.sequence_parallel
                 else self.tp.exit(self.tp.pad_cols(y)))
        tp = self._tp_at("encoder/layers")

        def enc_layer(lp, h):
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            h = self._act(h + attn.attention_forward(
                lp["mixer"], cfg, mix_in, causal=False,
                tp=None if tp is None else tp.at("mixer")))
            return self._ffn_act(lp, DENSE, h, None, tp)

        for e in range(cfg.encoder_layers):
            h = self._remat(functools.partial(
                enc_layer, _layer(enc["layers"], e)))(h)
        return rmsnorm(enc["final_norm"], h, cfg.norm_eps)

    def _embed_inputs(self, params: Params, batch, rows=None):
        """(decoder-input hidden states, encoder output or None). `rows`:
        under executing rules, the rank's rows of the table already
        gathered (`ShardingRules.vocab_rows`), for a tied head to read
        too."""
        cfg = self.cfg
        enc_out = None
        if cfg.input_mode == "frames":
            enc_out = self._encode(params, batch["frames"])
        if self.tp is not None:
            return self._rank_inputs(params, batch, rows), enc_out
        h = embed_tokens(params["embed"], batch["tokens"])
        if cfg.input_mode == "tokens+image":
            img = batch["image_embeds"].to(params["img_proj"].dtype) \
                @ params["img_proj"]
            h = torch.cat([img.to(h.dtype), h], dim=1)
        return self._act(h), enc_out

    def _rank_inputs(self, params: Params, batch, rows=None):
        """The decoder's input under executing rules, in the residual
        stream's layout: the vocab-parallel lookup in the rank's rows of
        the table (`rows`, gathered here where not given) and, for
        `tokens+image`, `img_proj`'s column block of the image rows before
        the tokens, zero outside the rank's columns (`pad_cols`): partial
        sums over `model` that one `exit` reduces over the whole sequence
        of image and token positions, so a rank's block of positions may
        hold image rows, token rows or both."""
        tp = self.tp
        if rows is None:
            rows = tp.vocab_rows(params["embed"]["table"])
        h = tp.lookup(rows, batch["tokens"])
        if self.cfg.input_mode != "tokens+image":
            return tp.exit(h)
        img = tp.pad_cols(tp.linear(
            batch["image_embeds"].to(params["img_proj"].dtype),
            params["img_proj"], "img_proj"))
        return tp.exit(torch.cat([img.to(h.dtype), h], dim=1))

    def _hidden(self, params: Params, batch, rows=None):
        """Hidden states after the final norm, and the aux losses."""
        cfg = self.cfg
        h, enc_out = self._embed_inputs(params, batch, rows)
        if enc_out is not None and self.tp is not None:
            # whole along the sequence once for every decoder layer's cross
            # keys and values: their gradients sum before it is carried back
            enc_out = self.tp.enter(enc_out)
        aux = self._zero_aux(h.device)
        for j, lp in enumerate(params.get("first", [])):   # outside the remat
            h = self._layer_forward(lp, cfg.pattern[0], DENSE, h, aux,
                                    enc_out, f"first/{j}")

        def group(layers, h, lb, z):
            g_aux = {"moe_lb_loss": lb, "moe_z_loss": z}
            for i, (kind, ffn, lp) in enumerate(zip(cfg.pattern,
                                                    cfg.ffn_pattern, layers)):
                h = self._layer_forward(lp, kind, ffn, h, g_aux, enc_out,
                                        f"groups/{i}")
            return h, g_aux["moe_lb_loss"], g_aux["moe_z_loss"]

        for g in range(cfg.num_groups):
            layers = [_layer(stack, g) for stack in params["groups"]]
            h, aux["moe_lb_loss"], aux["moe_z_loss"] = self._remat(
                functools.partial(group, layers))(
                    h, aux["moe_lb_loss"], aux["moe_z_loss"])
        return rmsnorm(params["final_norm"], h, cfg.norm_eps), aux

    def _world_size_one(self, what: str) -> None:
        if self.tp is not None:
            raise NotImplementedError(
                f"{what} under executing sharding rules: the executed plan "
                "covers the training step (ROADMAP A18)")

    def forward(self, params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence logits (B,S,V_padded) and the aux losses."""
        self._world_size_one("forward")
        h, aux = self._hidden(params, batch)
        return self._act(self._unembed(params, h), "logits"), aux

    def _labels_and_mask(self, batch, s: int):
        """Next-token labels and their validity mask at every position of
        the hidden sequence (so the loss can chunk over S)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, n = tokens.shape
        dev = tokens.device
        if cfg.input_mode == "tokens+image":
            p = cfg.num_image_tokens
            # position p-1+j predicts tokens[:, j]
            labels = torch.zeros((b, s), dtype=tokens.dtype, device=dev)
            start = max(0, min(p - 1, s - n))   # dynamic_update_slice's clamp
            labels[:, start:start + n] = tokens
            pos = torch.arange(s, device=dev)
            mask = ((pos >= p - 1) & (pos < p - 1 + n)).float()
            return labels, mask[None, :].expand(b, s)
        labels = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
        mask = torch.ones((b, s), dtype=torch.float32, device=dev)
        mask[:, -1] = 0.0
        return labels, mask

    def _chunked_xent(self, params: Params, h, labels, mask,
                      chunk: int = 1024):
        """The loss without the whole (B,S,V) logits: S in chunks, each
        chunk's logits computed, reduced and dropped; under autograd each
        chunk is recomputed in the backward (`checkpoint`), as the
        reference's `jax.checkpoint`ed scan body is."""
        cfg = self.cfg
        s = h.shape[1]
        chunk = math.gcd(s, chunk)
        vp = padded_vocab(cfg)
        pad = (torch.arange(vp, device=h.device) >= cfg.vocab_size
               if vp != cfg.vocab_size else None)
        sf = self._shard_act()

        def body(hc, lc, mc):
            logits = self._unembed(params, hc).float()
            if cfg.logit_softcap:
                logits = torch.tanh(logits / cfg.logit_softcap) \
                    * cfg.logit_softcap
            if pad is not None:
                logits = torch.where(pad, -1e30, logits)
            lse = torch.logsumexp(logits, dim=-1)
            if sf is not None:
                # the plan of `_vocab_parallel_xent`'s row max and sum of
                # exponentials over the model axis
                sf(lse.detach(), "vocab_max")
                lse = sf(lse, "vocab_sum")
            gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
            return torch.sum((lse - gold) * mc)

        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for a in range(0, s, chunk):
            args = (h[:, a:a + chunk], labels[:, a:a + chunk],
                    mask[:, a:a + chunk])
            if torch.is_grad_enabled():
                tot = tot + checkpoint(body, *args, use_reentrant=False)
            else:
                tot = tot + body(*args)
        return tot / torch.clamp_min(mask.sum(), 1.0)

    def loss_fn(self, params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy, padded vocab rows masked to -1e30
        (image positions predict nothing); total = xent + 0.01 lb + 1e-3 z.
        Vocabularies of CHUNKED_LOSS_VOCAB and up over more than 1024
        positions take `_chunked_xent`."""
        cfg = self.cfg
        vp = padded_vocab(cfg)
        rows = None
        if self.tp is not None and cfg.tie_embeddings:
            # a tied head reads the rows the lookup read: one gather
            rows = self.tp.vocab_rows(params["embed"]["table"])
        h, aux = self._hidden(params, batch, rows)
        s = h.shape[1]
        if self.tp is not None:
            loss = self._local_xent(params, h, batch, rows)
        elif vp >= self.CHUNKED_LOSS_VOCAB and s > 1024:
            labels, mask = self._labels_and_mask(batch, s)
            loss = self._chunked_xent(params, h, labels, mask)
        else:
            logits = self._act(self._unembed(params, h), "logits")
            if vp != cfg.vocab_size:
                pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
                logits = torch.where(pad, -1e30, logits.float())
            tokens = batch["tokens"]
            if cfg.input_mode == "tokens+image":
                p = cfg.num_image_tokens
                loss = softmax_xent(logits[:, p - 1:-1], tokens,
                                    logit_softcap=cfg.logit_softcap)
            else:
                loss = softmax_xent(logits[:, :-1], tokens[:, 1:],
                                    logit_softcap=cfg.logit_softcap)
        total = loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        return total, dict(aux, xent=loss)

    def _label_count(self, b: int, s: int, n: int) -> int:
        """The positions of `b` rows of `s` (`n` tokens a row) that predict
        a token (`_labels_and_mask`'s mask summed, on the host)."""
        if self.cfg.input_mode == "tokens+image":
            p = self.cfg.num_image_tokens
            return b * max(0, min(s, p - 1 + n) - max(0, p - 1))
        return b * (s - 1)

    def _local_xent(self, params: Params, h, batch, rows=None):
        """`loss_fn`'s cross-entropy under executing rules: the final
        hidden states whole along the sequence (`tp.enter`) into the head's
        vocab columns: an untied `lm_head`'s or, tied, the rank's rows of
        the table the lookup read (`rows`). The labels and their mask are
        `_labels_and_mask`'s (with images, position p-1+j predicts token j
        and image positions predict nothing). Where `loss_fn` takes the
        chunked loss, `_vocab_parallel_xent` over those vocab columns (an
        untied head's gathered once a step, `tp.fsdp_gather`); else the
        logits (`tp.linear`) to this rank's positions over the whole
        padded vocabulary (`tp.to_seq`), the pad columns -1e30 and the
        softcap as `softmax_xent` takes them, the summed loss of the
        positions the mask keeps. Reduced over every rank and divided by
        the global count of those positions."""
        cfg, tp = self.cfg, self.tp
        b, n = batch["tokens"].shape
        h = tp.enter(h)
        s = h.shape[1]
        count = self._label_count(b * tp.batch_split()[1], s, n)
        labels, mask = self._labels_and_mask(batch, s)
        if padded_vocab(cfg) >= self.CHUNKED_LOSS_VOCAB and s > 1024:
            if not cfg.tie_embeddings:
                rows = tp.fsdp_gather(params["lm_head"], "lm_head").T
            return tp.reduce_loss(self._vocab_parallel_xent(
                h, labels, mask, rows), count)
        logits = tp.to_seq(h @ rows.T if cfg.tie_embeddings else
                           tp.linear(h, params["lm_head"], "lm_head"))
        lf = logits.float()
        vp = padded_vocab(cfg)
        if vp != cfg.vocab_size:
            pad = torch.arange(vp, device=lf.device) >= cfg.vocab_size
            lf = torch.where(pad, -1e30, lf)
        if cfg.logit_softcap:
            lf = torch.tanh(lf / cfg.logit_softcap) * cfg.logit_softcap
        first = tp.seq_start(lf.shape[1])
        block = slice(first, first + lf.shape[1])
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[:, block].long()[..., None])[
            ..., 0]
        total = torch.sum((lse - gold) * mask[:, block])
        return tp.reduce_loss(total, count)

    def _vocab_parallel_xent(self, h, labels, mask, rows,
                             chunk: int = 1024):
        """`_chunked_xent` under executing rules, the head's vocabulary
        split over `model` (`rows`, the rank's (V/M, d) rows of the head:
        of the tied table, or an untied `lm_head`'s columns transposed):
        this rank's part of the summed loss, without the (B,S,V) logits or
        their (B,S/M,V) block. h (B,S,d) is whole
        along the sequence; S goes in the reference's chunks of gcd(S,
        1024) positions, each recomputed in the backward (`checkpoint`).
        A chunk's logits are taken over the rank's vocab columns only,
        softcapped and their pad columns -1e30 as `_chunked_xent` does;
        the row max is all-reduced (max) over `model`, then the sum of
        exponentials under it (the backward all-reduces its gradient:
        each rank's log-sum-exp below is a copy); the gold logit comes
        from the rank whose columns hold the label, 0 elsewhere. Each rank
        adds its copy of the log-sum-exp over M and its own gold logits,
        so `reduce_loss`'s sum over every rank is the loss's."""
        cfg, tp = self.cfg, self.tp
        comm, axis, m = tp.comm, tp.tp, tp.tp_size
        w = rows.T
        v0 = tp.vocab_start(w.shape[1])
        pad = torch.arange(v0, v0 + w.shape[1], device=h.device) \
            >= cfg.vocab_size
        s = h.shape[1]
        chunk = math.gcd(s, chunk)

        def body(hc, lc, mc, w):
            logits = (hc @ w).float()
            if cfg.logit_softcap:
                logits = torch.tanh(logits / cfg.logit_softcap) \
                    * cfg.logit_softcap
            logits = torch.where(pad, -1e30, logits)
            top = comm.all_reduce(logits.detach().amax(-1), axis, op="max")
            sumexp = torch.exp(logits - top[..., None]).sum(-1)
            lse = top + torch.log(all_reduce_backward(
                comm, all_reduce(comm, sumexp, axis), axis))
            idx = lc.long() - v0
            own = (idx >= 0) & (idx < w.shape[1])
            gold = torch.gather(logits, -1, idx.clamp(0, w.shape[1] - 1)
                                [..., None])[..., 0]
            return torch.sum((lse / m - gold * own) * mc)

        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for a in range(0, s, chunk):
            tot = tot + checkpoint(body, h[:, a:a + chunk],
                                   labels[:, a:a + chunk],
                                   mask[:, a:a + chunk], w,
                                   use_reentrant=False)
        return tot

    # ------------------------------------------------------------- caches

    def _init_layer_cache(self, kind: str, batch: int, max_seq: int, dt,
                          device, lead: Tuple[int, ...]) -> Params:
        cfg = self.cfg
        if kind in (ATTN, SWA):
            c = attn.init_attn_cache(cfg, batch, max_seq,
                                     window=self._window(kind), dtype=dt,
                                     device=device, lead=lead)
        elif kind == MLA:
            c = attn.init_mla_cache(cfg, batch, max_seq, dt, device, lead)
        elif kind == MAMBA:
            c = ssm.init_mamba_cache(cfg, batch, dt, device, lead)
        elif kind == MLSTM:
            c = xlstm.init_mlstm_cache(cfg, batch, dt, device, lead)
        else:
            c = xlstm.init_slstm_cache(cfg, batch, dt, device, lead)
        if cfg.encoder_layers > 0:
            shape = (*lead, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
        return c

    def init_cache(self, batch: int, max_seq: int, device=None,
                   dtype=None) -> Params:
        cfg = self.cfg
        dt = dtype or torch_dtype(cfg.param_dtype)
        cache: Params = {"groups": tuple(
            self._init_layer_cache(kind, batch, max_seq, dt, device,
                                   (cfg.num_groups,))
            for kind in cfg.pattern)}
        if cfg.first_k_dense:
            cache["first"] = [
                self._init_layer_cache(cfg.pattern[0], batch, max_seq, dt,
                                       device, ())
                for _ in range(cfg.first_k_dense)]
        return cache

    # ------------------------------------------------------------ prefill

    def _mix_prefill(self, lp: Params, kind: str, x, max_seq: int):
        cfg = self.cfg
        if kind in (ATTN, SWA):
            expand, sf = self._attn_tp()
            return attn.attention_prefill(lp["mixer"], cfg, x,
                                          window=self._window(kind),
                                          max_seq=max_seq, expand_kv=expand,
                                          shard_fn=sf)
        if kind == MLA:
            return attn.mla_prefill(lp["mixer"], cfg, x, max_seq=max_seq)
        if kind == MAMBA:
            out, (h_last, tail) = ssm.mamba_mix(lp["mixer"], cfg, x,
                                                shard_fn=self._shard_act())
            return out, {"h": h_last, "conv": tail}
        if kind == MLSTM:
            out, ((c, n, m), tail) = xlstm.mlstm_mix(lp["mixer"], cfg, x)
            return out, {"C": c, "n": n, "m": m, "conv": tail}
        out, ((c, n, m, hh), tail) = xlstm.slstm_mix(lp["mixer"], cfg, x)
        return out, {"c": c, "n": n, "m": m, "h": hh, "conv": tail}

    def prefill(self, params: Params, batch, max_seq: int = 0):
        """Full-sequence forward that also builds the decode cache. Returns
        the last position's logits (B,1,V_padded), padded rows unmasked as
        in the reference. An encoder-decoder's cross cache holds the
        encoder's first `max_seq` keys and values, zero slots after them
        where it is shorter, as the reference's does."""
        cfg = self.cfg
        self._world_size_one("prefill")
        h, enc_out = self._embed_inputs(params, batch)
        max_seq = max_seq or h.shape[1]
        cache = self.init_cache(h.shape[0], max_seq, h.device, h.dtype)
        for kind, ffn, lp, slot in self._layers(params):
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            out, core = self._mix_prefill(lp, kind, mix_in, max_seq)
            h = self._act(h + out)
            if enc_out is not None and "cross" in lp:
                kv = attn.encode_cross_kv(lp["cross"], cfg, enc_out)
                h = self._act(self._cross(lp, h, kv))
                core = dict(core, cross_k=kv["k"][:, :max_seq],
                            cross_v=kv["v"][:, :max_seq])
            _store(cache, slot, core)
            h = self._ffn_act(lp, ffn, h)
        h = rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        return self._unembed(params, h), cache

    # ------------------------------------------------------------- decode

    def decode_step(self, params: Params, cache: Params, tokens, pos):
        """tokens: (B,1) int; pos: position of the new token -> (logits
        (B,1,V_padded), cache). The cache is updated in place."""
        cfg = self.cfg
        self._world_size_one("decode_step")
        h = embed_tokens(params["embed"], tokens)
        for kind, ffn, lp, slot in self._layers(params):
            mix_in = rmsnorm(lp["pre_norm"], h, cfg.norm_eps)
            layer_cache = _cache_view(cache, slot)
            core = {k: v for k, v in layer_cache.items()
                    if not k.startswith("cross_")}
            if kind in (ATTN, SWA):
                out, _ = attn.attention_decode(lp["mixer"], cfg, mix_in, core,
                                               pos, window=self._window(kind))
            elif kind == MLA:
                out, _ = attn.mla_decode(lp["mixer"], cfg, mix_in, core, pos)
            else:
                decode = {MAMBA: ssm.mamba_decode, MLSTM: xlstm.mlstm_decode,
                          SLSTM: xlstm.slstm_decode}[kind]
                out, core = decode(lp["mixer"], cfg, mix_in, core)
                _store(cache, slot, core)
            h = h + out
            if "cross_k" in layer_cache:
                c_in = rmsnorm(lp["cross_norm"], h, cfg.norm_eps)
                h = h + attn.cross_attention_decode(
                    lp["cross"], cfg, c_in, {"k": layer_cache["cross_k"],
                                             "v": layer_cache["cross_v"]})
            h = self._ffn(lp, ffn, h)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return self._unembed(params, h), cache


    # -------------------------------------------------------------- specs

    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Stand-ins on the `meta` device for every model input of this
        cell: the shapes and dtypes of the reference's ShapeDtypeStructs."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        dt, i32 = torch_dtype(cfg.param_dtype), torch.int32
        if shape.kind in ("train", "prefill"):
            if cfg.input_mode == "frames":
                return {"frames": spec((b, s, cfg.frame_dim or cfg.d_model),
                                       dt),
                        "tokens": spec((b, s), i32)}
            if cfg.input_mode == "tokens+image":
                p = cfg.num_image_tokens
                return {"image_embeds": spec((b, p, cfg.d_model), dt),
                        "tokens": spec((b, s - p), i32)}
            return {"tokens": spec((b, s), i32)}
        # decode: one new token against a cache of length seq_len
        return {"tokens": spec((b, 1), i32)}


def build_model(cfg: ModelConfig, rules=None) -> Model:
    return Model(cfg, rules)
