"""Mixture-of-Experts FFN with three dispatch strategies: the port of
`repro.models.moe`.

``dense``    — compute every expert for every token, weight by gates. Exact,
               used for smoke tests and as the oracle in the tests.
``dropping`` — GShard/Switch-style capacity-bounded dispatch: a (groups,
               tokens, experts, capacity) one-hot gathers each expert's
               tokens, one batched GEMM a projection over the experts.
``ragged``   — sort by expert, then one GEMM over each expert's contiguous
               rows ("dropless"), where the reference has `lax.ragged_dot`.

Router: fp32 logits, softmax-then-top-k with renormalization. Aux losses
(switch load-balance + router z-loss) are returned for the trainer.

The reference's products are einsums and `lax.ragged_dot` outside any
Pallas kernel, so the port's are `torch.einsum`/`torch.bmm` and a loop of
`torch.matmul`. The scatters `.at[...].add` become `index_add`; on the card
its float sums run in no fixed order (atomics).

Under executing sharding rules (`moe_apply(..., tp=)`, a rank of the
sharded train step) the layer computes the reference's global function
from the rank's blocks: the residual stream comes in whole along the
sequence (`tp.enter`), so every model rank routes the same whole groups
and drops exactly the tokens the reference drops; the rank runs its own
experts (expert parallel: the model axis divides E) or every expert's
block of `d_ff` columns (the expert-internal TP fallback), and the shared
experts' columns, each expert weight gathered over its FSDP axes at the
product; the `ragged` dispatch sorts every token-expert pair by expert and
takes the rows of the rank's experts; the partial sums leave through
`tp.exit`. The aux losses are the
global batch's: each rank sums its counts, probabilities and squared
log-normalizers over its own block of positions, and one all-reduce over
every rank adds them up, so each token's gradient is counted once.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import dense_init, swiglu, swiglu_init, torch_dtype
from repro_torch.parallel import collectives as c

Params = Dict[str, Any]


def _expert_normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
                   dtype) -> torch.Tensor:
    """normal * scale in `dtype`, drawn in fp32 one (d_in, d_out) matrix at a
    time: a whole stack of experts in fp32 would double the peak memory of
    an init on the card (26 GB for eight of mixtral's layers)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.device.type == "meta":          # shapes only: nothing to draw
        return out
    for idx in itertools.product(*map(range, shape[:-2])):
        w = torch.randn(shape[-2:], generator=gen, device=gen.device,
                        dtype=torch.float32)
        out[idx] = w * scale
    return out


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = ()) -> Params:
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.num_experts
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "router": dense_init(gen, d, e, torch.float32, lead),
        "w_gate": _expert_normal(gen, (*lead, e, d, f), 1.0 / math.sqrt(d), dt),
        "w_up": _expert_normal(gen, (*lead, e, d, f), 1.0 / math.sqrt(d), dt),
        "w_down": _expert_normal(gen, (*lead, e, f, d), 1.0 / math.sqrt(f), dt),
    }
    if mc.num_shared_experts:
        p["shared"] = swiglu_init(gen, d, f * mc.num_shared_experts, dt, lead)
    return p


def _route(params: Params, mc: MoEConfig, x2d: torch.Tensor):
    """x2d: (T, d) -> fp32 logits and probabilities (T, E), the top-k
    gates renormalized (T, k) and their experts (T, k)."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, mc.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return logits, probs, top_p, top_i


def _router(params: Params, mc: MoEConfig, x2d: torch.Tensor):
    """x2d: (T, d) -> gates (T, k), idx (T, k), aux losses."""
    logits, probs, top_p, top_i = _route(params, mc, x2d)
    # switch load-balance loss: E * sum_e f_e * P_e
    e = mc.num_experts
    f_e = _expert_counts(top_i, e).float()
    f_e = f_e / torch.clamp_min(f_e.sum(), 1.0)
    p_e = probs.mean(dim=0)
    lb_loss = e * torch.sum(f_e * p_e)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, top_i, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert, (E,) int64: `bincount` as a scatter-add of
    ones, whose shape does not depend on the data (so a trace on `meta`
    runs it)."""
    flat = idx.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat.long(), torch.ones_like(flat, dtype=torch.int64))


def _swiglu_act(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu in fp32, cast back before the up-product."""
    return F.silu(g.float()).to(u.dtype) * u


def _expert_ffn(params: Params, h_in: torch.Tensor) -> torch.Tensor:
    """h_in: (E, C, d) -> (E, C, d), per-expert SwiGLU."""
    h = _swiglu_act(torch.bmm(h_in, params["w_gate"]),
                    torch.bmm(h_in, params["w_up"]))
    return torch.bmm(h, params["w_down"])


def _dense_moe(params: Params, mc: MoEConfig, x2d, gates, idx):
    t = x2d.shape[0]
    # (T,E) combine weights from the top-k selection
    comb = torch.zeros((t, mc.num_experts), dtype=x2d.dtype,
                       device=x2d.device)
    comb = comb.scatter(1, idx, gates.to(x2d.dtype))
    g = torch.einsum("td,edf->tef", x2d, params["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, params["w_up"])
    y = torch.einsum("tef,efd->ted", _swiglu_act(g, u), params["w_down"])
    return torch.einsum("ted,te->td", y, comb)


def capacity(mc: MoEConfig, n: int) -> int:
    """Slots per (group, expert) for groups of `n` tokens, rounded as the
    reference rounds them."""
    cap = int(math.ceil(n * mc.top_k / mc.num_experts * mc.capacity_factor))
    cap = max(8, -(-cap // 8) * 8)  # round up to 8 for lane alignment
    return min(cap, n) if n >= 8 else cap


def _dropping_moe(params: Params, mc: MoEConfig, x3d, gates, idx,
                  shard_fn=None):
    """GShard dispatch with per-*group* expert capacity.

    x3d: (G, N, d) — G groups of N tokens. Capacity is per (group, expert),
    so the dispatch tensor is (G, N, E, C). Tokens past an expert's capacity
    in their group are dropped (their output from this layer is 0).
    shard_fn(name, x) lets the model annotate intermediate shardings."""
    g_, n, d = x3d.shape
    e = mc.num_experts
    cap = capacity(mc, n)
    sf = shard_fn or (lambda name, a: a)
    dispatch, combine = _dispatch(mc, x3d, gates, idx)
    dispatch = sf("moe_dispatch", dispatch)
    h_in = sf("moe_egcd", torch.einsum("gnec,gnd->egcd", dispatch, x3d))
    h_out = _expert_ffn(params, h_in.reshape(e, g_ * cap, d))
    h_out = sf("moe_egcd", h_out.reshape(e, g_, cap, d))
    # combine weights in activation dtype, as the reference does
    return torch.einsum("gnec,egcd->gnd", combine.to(x3d.dtype), h_out)


def _dispatch(mc: MoEConfig, x3d, gates, idx):
    """The (G, N, E, C) dispatch one-hot (in x3d's dtype) and combine
    weights (fp32) of groups x3d (G, N, d) routed to `idx` with `gates`."""
    g_, n, d = x3d.shape
    e = mc.num_experts
    cap = capacity(mc, n)
    slots = torch.arange(cap, device=x3d.device)

    # position of each (token, rank) within its (group, expert) queue;
    # earlier ranks get priority, matching GShard.
    dispatch = torch.zeros((g_, n, e, cap), dtype=x3d.dtype, device=x3d.device)
    combine = torch.zeros((g_, n, e, cap), dtype=torch.float32,
                          device=x3d.device)
    counts = torch.zeros((g_, 1, e), dtype=torch.int64, device=x3d.device)
    for r in range(mc.top_k):
        mask_r = F.one_hot(idx[..., r], e)                    # (G,N,E)
        pos_r = torch.cumsum(mask_r, dim=1) - 1 + counts
        counts = counts + mask_r.sum(dim=1, keepdim=True)
        keep = (mask_r > 0) & (pos_r < cap)
        # the reference's one_hot(where(keep, pos, -1)): all zeros where
        # dropped, built here in the activation dtype, not int64
        oh = (pos_r[..., None] == slots) & keep[..., None]
        dispatch = dispatch + oh.to(x3d.dtype)
        combine = combine + oh.float() * gates[..., r:r + 1, None]
    return dispatch, combine


def _ragged_moe(params: Params, mc: MoEConfig, x2d, gates, idx):
    """Dropless dispatch: sort by expert, one GEMM over each expert's
    contiguous rows."""
    t = x2d.shape[0]
    flat_e = idx.reshape(-1)                       # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    tok = torch.arange(t, device=x2d.device).repeat_interleave(mc.top_k)[order]
    w = gates.reshape(-1)[order]
    xs = x2d[tok]                                  # (T*k, d) sorted by expert
    ys = []
    for ex, rows in enumerate(torch.split(xs, _ragged_sizes(mc, flat_e, t))):
        h = _swiglu_act(rows @ params["w_gate"][ex], rows @ params["w_up"][ex])
        ys.append(h @ params["w_down"][ex])
    y = torch.cat(ys) * w[:, None].to(xs.dtype)
    return torch.zeros_like(x2d).index_add(0, tok, y)


def _groups(b: int, s: int) -> Tuple[int, int]:
    """(groups, tokens a group) of the dropping dispatch: groups of <=4096
    tokens of one row, one flat group at decode."""
    if s > 1:
        gsz = math.gcd(s, 4096)
        return b * (s // gsz), gsz
    return 1, b * s


def _global_aux(mc: MoEConfig, logits, probs, top_i, b: int, s: int, tp):
    """The aux losses of the global batch from a rank's whole-sequence
    routing of its rows: the counts, probabilities and squared
    log-normalizers of its own block of positions (`tp.tp_block`) summed
    over every rank (the all-reduce's backward passes each rank its own
    part), then `_router`'s formulas over every token."""
    e = mc.num_experts
    p0, p1 = tp.tp_block(s)

    def own(t):
        return t.reshape(b, s, -1)[:, p0:p1].reshape(-1, t.shape[-1])
    lse = torch.logsumexp(own(logits), dim=-1)
    stats = c.all_reduce(tp.comm, torch.cat([
        _expert_counts(own(top_i), e).float(), own(probs).sum(dim=0),
        torch.sum(lse ** 2)[None]]), tp.mesh.axis_names)
    tokens = b * s * tp.batch_split()[1]
    f_e = stats[:e] / torch.clamp_min(stats[:e].sum(), 1.0)
    p_e = stats[e:2 * e] / tokens
    return {"moe_lb_loss": e * torch.sum(f_e * p_e),
            "moe_z_loss": stats[2 * e] / tokens}


def _gathered_columns(params: Params, name: str, x2d, tp):
    """x2d (T, d) through every local expert's `name` block (E_l, d_l, f_l)
    at once: the block laid out as one (d_l, E_l * f_l) matrix, gathered
    over its FSDP axes along d for the product -> (T, E_l, f_l)."""
    w = params[name]
    dim, axes = tp.gather_dim(name)
    flat = w.permute(1, 0, 2).reshape(w.shape[1], -1)
    out = c.gathered_mm(tp.comm, x2d, flat, 0, axes if dim == 1 else ())
    return out.reshape(x2d.shape[0], w.shape[0], w.shape[2])


def _rank_dense(params: Params, mc: MoEConfig, x2d, gates, idx, e0: int,
                tp):
    """`_dense_moe` on a rank: its experts [e0, e0 + E_l) or every
    expert's block of columns, partial sums out."""
    t = x2d.shape[0]
    el = params["w_gate"].shape[0]
    comb = torch.zeros((t, mc.num_experts), dtype=x2d.dtype,
                       device=x2d.device)
    comb = comb.scatter(1, idx, gates.to(x2d.dtype))[:, e0:e0 + el]
    h = _swiglu_act(_gathered_columns(params, "w_gate", x2d, tp),
                    _gathered_columns(params, "w_up", x2d, tp))
    y = tp.linear(h.transpose(0, 1), params["w_down"], "w_down")
    return torch.einsum("etd,te->td", y, comb)


def _rank_dropping(params: Params, mc: MoEConfig, x3d, gates, idx, e0: int,
                   tp):
    """`_dropping_moe` on a rank: the whole groups' dispatch, its experts'
    slots [e0, e0 + E_l) (or every expert's, on its columns) through
    their SwiGLU, partial sums out."""
    g_, n, d = x3d.shape
    el = params["w_gate"].shape[0]
    cap = capacity(mc, n)
    dispatch, combine = _dispatch(mc, x3d, gates, idx)
    dispatch = dispatch[:, :, e0:e0 + el]
    combine = combine[:, :, e0:e0 + el]
    h_in = torch.einsum("gnec,gnd->egcd", dispatch, x3d).reshape(
        el, g_ * cap, d)
    h = _swiglu_act(tp.linear(h_in, params["w_gate"], "w_gate"),
                    tp.linear(h_in, params["w_up"], "w_up"))
    h_out = tp.linear(h, params["w_down"], "w_down").reshape(el, g_, cap, d)
    return torch.einsum("gnec,egcd->gnd", combine.to(x3d.dtype), h_out)


def _ragged_sizes(mc: MoEConfig, flat_e: torch.Tensor, t: int) -> list:
    """Rows of each expert among `t` tokens' top-k choices `flat_e`,
    counted on the host; on `meta` (no data to count) a balanced split:
    any split of the T*k rows costs the same products."""
    if flat_e.device.type == "meta":
        q, r = divmod(t * mc.top_k, mc.num_experts)
        return [q + (ex < r) for ex in range(mc.num_experts)]
    return _expert_counts(flat_e, mc.num_experts).tolist()


def _rank_ragged(params: Params, mc: MoEConfig, x2d, gates, idx, e0: int,
                 tp):
    """`_ragged_moe` on a rank: every token-expert pair sorted by expert,
    the contiguous rows of its experts [e0, e0 + E_l) (or of every
    expert, on its block of columns) through one product an expert, each
    expert's block gathered over its FSDP axes at the product
    (`gathered_mm`, as ZeRO-3 gathers: again in the backward, its gradient
    reduce-scattered), partial sums out. Dropless, as on one card."""
    t = x2d.shape[0]
    el = params["w_gate"].shape[0]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sizes = _ragged_sizes(mc, flat_e, t)
    lo = sum(sizes[:e0])
    mine = sizes[e0:e0 + el]
    rows = order[lo:lo + sum(mine)]
    tok = torch.arange(t, device=x2d.device).repeat_interleave(
        mc.top_k)[rows]
    w = gates.reshape(-1)[rows]

    def mm(xs, name, j):                 # expert j's (d_in, d_out) block
        dim, axes = tp.gather_dim(name)
        return c.gathered_mm(tp.comm, xs, params[name][j], dim - 1,
                             axes if dim > 0 else ())
    ys = []
    for j, xs in enumerate(torch.split(x2d[tok], mine)):
        h = _swiglu_act(mm(xs, "w_gate", j), mm(xs, "w_up", j))
        ys.append(mm(h, "w_down", j))
    y = torch.cat(ys) * w[:, None].to(x2d.dtype)
    return torch.zeros_like(x2d).index_add(0, tok, y)


def _rank_moe(params: Params, cfg: ModelConfig, x: torch.Tensor, tp
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`moe_apply` as a rank of the sharded step runs it (module
    docstring): x in the residual stream's layout -> the layer's output in
    the same layout, the global aux losses."""
    mc = cfg.moe
    xf = tp.enter(x)
    b, s, d = xf.shape
    x2d = xf.reshape(b * s, d)
    logits, probs, gates, idx = _route(params, mc, x2d)
    aux = _global_aux(mc, logits, probs, idx, b, s, tp)
    el = params["w_gate"].shape[0]
    e0 = tp.tp_block(mc.num_experts)[0] if el < mc.num_experts else 0
    if mc.dispatch == "dense":
        y = _rank_dense(params, mc, x2d, gates, idx, e0, tp)
    elif mc.dispatch == "dropping":
        g_, n = _groups(b, s)
        y = _rank_dropping(params, mc, x2d.reshape(g_, n, d),
                           gates.reshape(g_, n, -1), idx.reshape(g_, n, -1),
                           e0, tp).reshape(b * s, d)
    elif mc.dispatch == "ragged":
        y = _rank_ragged(params, mc, x2d, gates, idx, e0, tp)
    else:
        raise ValueError(f"unknown moe dispatch {mc.dispatch!r}")
    if mc.num_shared_experts:
        y = y + swiglu(params["shared"], x2d, tp.at("shared", inner=True))
    return tp.exit(y.reshape(b, s, d)), aux


def moe_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
              shard_fn=None, tp=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), aux losses. `shard_fn` annotates the
    dropping dispatch's layouts (the model's `_moe_shard`); `tp`, the
    executing rules at this layer's FFN, makes it a rank's part of the
    layer (module docstring)."""
    if tp is not None:
        return _rank_moe(params, cfg, x, tp)
    mc = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, idx, aux = _router(params, mc, x2d)
    if mc.dispatch == "dense":
        y = _dense_moe(params, mc, x2d, gates, idx)
    elif mc.dispatch == "dropping":
        # groups of <=4096 tokens: capacity (and the dispatch one-hot) stays
        # bounded regardless of sequence length; one flat group at decode
        g_, n = _groups(b, s)
        y = _dropping_moe(params, mc, x2d.reshape(g_, n, d),
                          gates.reshape(g_, n, -1), idx.reshape(g_, n, -1),
                          shard_fn)
        y = y.reshape(b * s, d)
    elif mc.dispatch == "ragged":
        y = _ragged_moe(params, mc, x2d, gates, idx)
    else:
        raise ValueError(f"unknown moe dispatch {mc.dispatch!r}")
    if mc.num_shared_experts:
        y = y + swiglu(params["shared"], x2d)
    return y.reshape(b, s, d), aux
