"""The port's MoE layer and mixtral-8x22b (sliding-window attention, MoE
FFNs) on the CPU against the JAX package, with weights that JAX initialized
carried across by the bridge."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import init_params, params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "mixtral-8x22b"
# fp32: one algorithm summed in other orders by torch and XLA.
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       # bf16 GEMM outputs (x @ W and the dispatch products) round to bf16 on
       # both sides, but from fp32 sums taken in other orders: an ulp of
       # bf16 is 2^-8 of the value, and the layer rounds three times
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# Logits of the whole model, as tests/test_models.py bounds them.
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
# Each gradient leaf, against the largest entry of JAX's leaf.
GRAD_RTOL = 1e-3
# Parameters from `jax.eval_shape` of the reference's `Model.init`: the full
# config, the 8-layer cut chip_smoke.py serves and the 1-layer cut it trains.
FULL_PARAMS = 140_630_071_296
SERVE_CUT_PARAMS = 20_435_146_752
TRAIN_CUT_PARAMS = 2_906_720_256
DISPATCHES = ("dense", "dropping", "ragged")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), "cpu")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32),
                               **(tol or TOL["float32"]))


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _cfgs(dispatch, dtype="float32", **moe_kw):
    """(jax cfg, port cfg): mixtral smoke with `dispatch`."""
    kw = dict(num_experts=4, top_k=2, d_ff_expert=256, dispatch=dispatch,
              **moe_kw)
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype=dtype,
                                              moe=JMoEConfig(**kw))
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype=dtype,
                                                  moe=MoEConfig(**kw))
    return jcfg, tcfg


def _moe_pair(dispatch, dtype, seed=0, **moe_kw):
    jcfg, tcfg = _cfgs(dispatch, dtype, **moe_kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 32, jcfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(jcfg.param_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, tcfg, jp, _t(jp), jx, tx


# ---------------------------------------------------------------- configs

def test_configs_are_the_reference_ones():
    for get in ("get_smoke_config", "get_config"):
        jcfg, tcfg = getattr(jreg, get)(ARCH), getattr(registry, get)(ARCH)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), get


@pytest.mark.parametrize("layers,want", [
    (56, FULL_PARAMS), (8, SERVE_CUT_PARAMS), (1, TRAIN_CUT_PARAMS)])
def test_param_counts_equal_jax_eval_shape(layers, want):
    """The port's init (on fake tensors: no memory) has the reference's
    parameter count at full width, uncut and as chip_smoke.py cuts it."""
    jcfg = jreg.get_config(ARCH).scaled(num_layers=layers)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(shapes)) == want
    with FakeTensorMode():
        p = init_params(registry.get_config(ARCH).scaled(num_layers=layers),
                        torch.Generator().manual_seed(0))
        assert sum(x.numel() for x in tree_leaves(p)) == want


def test_init_params_moe_leaves():
    """The reference's nesting, shapes and dtypes (router fp32 in a bf16
    model), and its scales: experts normal * 1/sqrt(d_in)."""
    jcfg, tcfg = _cfgs("dropping", "bfloat16")
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = init_params(tcfg, torch.Generator().manual_seed(0))
    _same_tree(got, want, "params")
    ffn = got["groups"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    for name, d_in in (("w_gate", 128), ("w_up", 128), ("w_down", 256)):
        std = float(ffn[name].float().std())
        assert abs(std * math.sqrt(d_in) - 1) < 0.05, name


def _same_tree(got, want, path):
    """Same keys and nesting, and each leaf's shape and dtype."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    else:
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path


# ---------------------------------------------------------------- moe_apply

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_apply_matches_jax(dispatch, dtype):
    """Outputs and both aux losses, for each dispatch in each dtype."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_pair(dispatch, dtype)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx)
    ty, taux = moe.moe_apply(tp, tcfg, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, **TOL[dtype])
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert taux[k].dtype == torch.float32
        _close(taux[k], jaux[k], **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropping_past_capacity_matches_jax(dtype):
    """capacity_factor 0.25 at 32 tokens a group: 8 slots an expert for 64
    (token, rank) pairs over 4 experts, so some tokens are dropped; the
    port drops the same ones."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_pair("dropping", dtype,
                                           capacity_factor=0.25)
    assert moe.capacity(tcfg.moe, 32) == 8
    _, idx, _ = moe._router(tp, tcfg.moe, tx[0])
    assert int(torch.bincount(idx.reshape(-1)).max()) > 8   # an overflow
    jy, _ = jmoe.moe_apply(jp, jcfg, jx)
    ty, _ = moe.moe_apply(tp, tcfg, tx)
    _close(ty, jy, **TOL[dtype])
    dense_cfg = _cfgs("dense", dtype)[1]
    yd, _ = moe.moe_apply(tp, dense_cfg, tx)
    assert not torch.allclose(ty.float(), yd.float(), atol=1e-3)


@pytest.mark.parametrize("n,cf,want", [
    (1, 1.25, 8), (4, 1.25, 8), (24, 1.25, 8), (2048, 1.25, 640),
    (4096, 1.25, 1280), (4, 16.0, 16), (24, 8.0, 24)])
def test_capacity_is_the_reference_rounding(n, cf, want):
    """`_dropping_moe`'s capacity (`moe.py:98-100`) at mixtral's 8 experts,
    top-2: decode (one group of B), its 2x2048 training step and its 1x8192
    prefill (groups of 4096); below 8 tokens the capacity may pass n."""
    mc = MoEConfig(num_experts=8, top_k=2, d_ff_expert=8, capacity_factor=cf)
    assert moe.capacity(mc, n) == want


def test_dispatch_modes_agree():
    """tests/test_models.py's check on the port: dropping and ragged equal
    dense where the capacity drops nothing."""
    cfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    outs = []
    for dispatch in DISPATCHES:
        c = cfg.scaled(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                                     capacity_factor=8.0, dispatch=dispatch))
        params = moe.moe_init(torch.Generator().manual_seed(0), c)
        x = torch.randn(2, 16, c.d_model,
                        generator=torch.Generator().manual_seed(1))
        outs.append(moe.moe_apply(params, c, x)[0])
    for y in outs[1:]:
        torch.testing.assert_close(y, outs[0], rtol=1e-4, atol=1e-4)


def test_decode_is_one_flat_group():
    """At S=1 dropping takes the batch as one group of B tokens."""
    jcfg, tcfg, jp, tp, _, _ = _moe_pair("dropping", "float32")
    x = np.random.default_rng(5).standard_normal((3, 1, 128), dtype=np.float32)
    jy, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, _ = moe.moe_apply(tp, tcfg, torch.from_numpy(x))
    _close(ty, jy)


# ------------------------------------------------------------- the model

@pytest.fixture(scope="module", params=DISPATCHES)
def pair(request):
    """(jax model, jax params, port model, port params): mixtral smoke,
    fp32, one fixture a dispatch (window 16)."""
    jcfg, tcfg = _cfgs(request.param)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), _t(jp)


def test_forward_loss_and_every_grad_match_jax(pair):
    """40 tokens against a window of 16: logits, loss, both aux losses and
    every gradient leaf."""
    jm, jp, tm, tp = pair
    tok = _tokens(0, 2, 40)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    _close(tl, jl, **MODEL_TOL)
    assert float(taux["moe_lb_loss"]) > 0
    for k in ("moe_lb_loss", "moe_z_loss"):
        _close(taux[k], jaux[k])

    (jloss, _), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok)})
    (tloss, _), tgrads = value_and_grad(
        tm, tp, {"tokens": torch.from_numpy(tok).long()})
    _close(tloss, jloss)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = _flat(tgrads)
    assert sorted(tflat) == sorted(_key(p) for p, _ in jleaves)
    for path, jg in jleaves:
        jg = np.asarray(jg, np.float32)
        err = np.abs(tflat[_key(path)].numpy() - jg).max()
        assert err <= GRAD_RTOL * max(np.abs(jg).max(), 1e-30), _key(path)


def _key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree
                for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def test_prefill_and_decode_past_the_window_match_jax(pair):
    """A 20-token prefill into ring caches of 16 slots, then 6 decode steps
    past the window: logits and the ring buffers against JAX's."""
    jm, jp, tm, tp = pair
    tok = _tokens(1, 2, 26)
    s = 20
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :s])}, max_seq=26)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :s]).long()},
                        max_seq=26)
    _close(tl, jl, **MODEL_TOL)
    assert tc["groups"][0]["k"].shape[2] == 16
    for key in ("k", "v"):
        _close(tc["groups"][0][key], jc["groups"][0][key])
    np.testing.assert_array_equal(tc["groups"][0]["slot_pos"].numpy(),
                                  np.asarray(jc["groups"][0]["slot_pos"]))
    step = jax.jit(jm.decode_step)
    for t in range(s, 26):
        jl, jc = step(jp, jc, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc,
                                torch.from_numpy(tok[:, t:t + 1]).long(), t)
        _close(tl, jl, **MODEL_TOL)
    np.testing.assert_array_equal(tc["groups"][0]["slot_pos"].numpy(),
                                  np.asarray(jc["groups"][0]["slot_pos"]))


def test_greedy_tokens_equal_jax_engine():
    """Prompts of 12 and 20 tokens, up to 8 new: decode crosses the window;
    `dropping`, the dispatch mixtral's config serves with."""
    jcfg, tcfg = _cfgs("dropping")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm, tp = build_model(tcfg), _t(jp)
    rng = np.random.default_rng(3)
    mix = [(12, 8), (20, 6), (12, 5)]
    prompts = [(i, rng.integers(0, 256, n).astype(np.int32), b)
               for i, (n, b) in enumerate(mix)]
    want = JaxServingEngine(jm, jp, max_seq=32).serve(
        [JaxRequest(i, p, b) for i, p, b in prompts], 2)
    got = ServingEngine(tm, tp, max_seq=32, device="cpu").serve(
        [Request(i, p, b) for i, p, b in prompts], 2)
    assert {r.request_id: r.tokens for r in got} == \
        {r.request_id: r.tokens for r in want}
