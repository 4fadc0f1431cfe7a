"""The port's Mamba mixer and the jamba cut (one 8-layer group, dense FFNs in
place of the experts) on the CPU against the JAX package, with weights that
JAX initialized carried across by the bridge (smoke widths, fp32)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import init_params, params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import DENSE, MAMBA  # noqa: E402
from repro_torch.models import build_model, padded_vocab, ssm  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "jamba-1.5-large-398b"
# The cut chip_smoke.py serves: one Jamba group, dense FFNs, no experts.
CUT = dict(num_layers=8, ffn_pattern=(DENSE,) * 8, moe=None)
# Parameters of the cut at full width, from `jax.eval_shape` of the
# reference's `Model.init`; chip_smoke.py holds the port's count to it.
FULL_CUT_PARAMS = 8_999_034_880
# fp32 throughout: one algorithm summed in other orders by torch and XLA.
TOL = dict(rtol=2e-4, atol=2e-4)
# Logits of the whole model, as tests/test_models.py bounds them.
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
# The reference's own bound for the chunked scan against decode
# (tests/test_models.py:173-188).
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), "cpu")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _x(seed, b, s, d, scale=0.5):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d), dtype=np.float32) * scale


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def cell():
    """JAX-initialized Mamba params at smoke widths (fp32), both sides."""
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32")
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _t(jp)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params): the cut, fp32."""
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32", **CUT)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32", **CUT)
    return jm, jp, build_model(tcfg), _t(jp)


# ---------------------------------------------------------------- configs

def test_configs_are_the_reference_ones():
    for get in ("get_smoke_config", "get_config"):
        jcfg, tcfg = getattr(jreg, get)(ARCH), getattr(registry, get)(ARCH)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "pattern", "ffn_pattern",
                  "rope_theta", "norm_eps", "param_dtype", "tie_embeddings",
                  "opt_state_dtype", "sub_quadratic"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (get, f)
        assert vars(tcfg.mamba) == vars(jcfg.mamba)
        assert vars(tcfg.moe) == vars(jcfg.moe)
    full = registry.get_config(ARCH)
    assert (full.d_model, full.mamba.expand * full.d_model,
            full.pattern.count(MAMBA), padded_vocab(full)) == (
        8192, 16_384, 7, 65_536)


def test_full_config_builds_with_the_reference_param_count():
    """The full config, MoE layers included, builds; the port's init (on
    fake tensors: no memory) has the reference's 398B parameters."""
    cfg = registry.get_config(ARCH)
    build_model(cfg)
    shapes = jax.eval_shape(jax_build_model(jreg.get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    with FakeTensorMode():
        p = init_params(cfg, torch.Generator().manual_seed(0))
        assert sum(x.numel() for x in tree_leaves(p)) == want
    assert 397e9 < want < 400e9


def test_mamba_layers_need_a_mamba_config():
    cfg = registry.get_smoke_config(ARCH).scaled(mamba=None, **CUT)
    with pytest.raises(ValueError, match="Mamba layers need cfg.mamba"):
        build_model(cfg)


def test_full_cut_param_count_and_leaf_shapes(pair):
    """The full-width cut's size from the reference's init, and the port's
    init giving the reference's nesting, shapes and dtypes at smoke widths
    (bf16, where the fp32 leaves show)."""
    jcfg = jreg.get_config(ARCH).scaled(**CUT)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(shapes)) == \
        FULL_CUT_PARAMS
    jcfg = jreg.get_smoke_config(ARCH).scaled(**CUT)
    tcfg = registry.get_smoke_config(ARCH).scaled(**CUT)
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = init_params(tcfg, torch.Generator().manual_seed(0))
    _same_tree(got, want, "params")


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


def test_init_params_mamba_leaves():
    """A bf16 model keeps `dt_proj`, `dt_bias`, `A_log`, `D` in fp32, with
    mamba_init's distributions: softplus(dt_bias) in [1e-3, 1e-1],
    A_log = log(1..d_state), D ones, conv_b zeros, dt_proj's std
    dt_rank^-0.5."""
    cfg = registry.get_smoke_config(ARCH).scaled(**CUT)
    p = init_params(cfg, torch.Generator().manual_seed(1))
    mix = p["groups"][0]["mixer"]
    g, di, ds, dtr = 1, 256, 8, 8
    f32, bf16 = torch.float32, torch.bfloat16
    want = {"in_proj": (bf16, (g, 128, 2 * di)), "conv_w": (bf16, (g, 4, di)),
            "conv_b": (bf16, (g, di)), "x_proj": (bf16, (g, di, dtr + 2 * ds)),
            "dt_proj": (f32, (g, dtr, di)), "dt_bias": (f32, (g, di)),
            "A_log": (f32, (g, di, ds)), "D": (f32, (g, di)),
            "out_proj": (bf16, (g, di, 128))}
    assert {k: (v.dtype, tuple(v.shape)) for k, v in mix.items()} == want
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    # log-uniform: the mean of log(dt) sits mid-way between the ends
    assert abs(float(torch.log(dt).mean()) - math.log(1e-2)) < 0.5
    torch.testing.assert_close(
        mix["A_log"], torch.log(torch.arange(1.0, ds + 1)).expand(g, di, ds))
    assert bool((mix["D"] == 1).all()) and bool((mix["conv_b"] == 0).all())
    assert abs(float(mix["dt_proj"].std()) - dtr ** -0.5) < 0.05
    assert p["groups"][4]["mixer"]["w_q"].dtype == bf16


# ------------------------------------------------------------------ Mamba

@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16)])
def test_mamba_mix_matches_jax(cell, s, chunk):
    """y, h_last and the conv tail; the reference scans `chunk` rows at a
    time, the port one call over the sequence."""
    jcfg, tcfg, jp, tp = cell
    x = _x(0, 2, s, jcfg.d_model)
    jout, (jh, jtail) = jssm.mamba_mix(jp, jcfg, jnp.asarray(x), chunk=chunk)
    tout, (th, ttail) = ssm.mamba_mix(tp, tcfg, torch.from_numpy(x),
                                      chunk=chunk)
    _close(tout, jout)
    _close(th, jh)
    _close(ttail, jtail)


def test_mamba_mix_with_state_and_conv_in_matches_jax(cell):
    """A second segment continues from the first's state and conv tail."""
    jcfg, tcfg, jp, tp = cell
    x = _x(1, 2, 24, jcfg.d_model)
    _, (jh, jtail) = jssm.mamba_mix(jp, jcfg, jnp.asarray(x[:, :16]), chunk=8)
    jout, (jh2, jtail2) = jssm.mamba_mix(jp, jcfg, jnp.asarray(x[:, 16:]),
                                         h0=jh, conv0=jtail, chunk=8)
    _, (th, ttail) = ssm.mamba_mix(tp, tcfg, torch.from_numpy(x[:, :16]))
    tout, (th2, ttail2) = ssm.mamba_mix(tp, tcfg, torch.from_numpy(x[:, 16:]),
                                        h0=th, conv0=ttail)
    _close(tout, jout)
    _close(th2, jh2)
    _close(ttail2, jtail2)


def test_mamba_decode_steps_match_jax(cell):
    jcfg, tcfg, jp, tp = cell
    x = _x(2, 2, 6, jcfg.d_model)
    jc = jssm.init_mamba_cache(jcfg, 2, dtype=jnp.float32)
    tc = ssm.init_mamba_cache(tcfg, 2, dtype=torch.float32)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).removeprefix("torch.") == str(jc[key].dtype)
    step = jax.jit(lambda p, xx, c: jssm.mamba_decode(p, jcfg, xx, c))
    for t in range(6):
        jy, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = ssm.mamba_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                  tc)
        _close(ty, jy)
        for key in jc:
            _close(tc[key], jc[key])


def test_mamba_cache_state_is_fp32_in_a_bf16_model():
    cfg = registry.get_smoke_config(ARCH)
    c = ssm.init_mamba_cache(cfg, 2, dtype=torch.bfloat16, lead=(3,))
    assert (c["h"].dtype, tuple(c["h"].shape)) == (torch.float32, (3, 2, 256, 8))
    assert (c["conv"].dtype, tuple(c["conv"].shape)) == (torch.bfloat16,
                                                         (3, 2, 3, 256))


def test_mamba_chunked_matches_decode(cell):
    """The reference's invariant (tests/test_models.py:173-188), on the
    port: the scan over the sequence equals step-by-step decode."""
    _, tcfg, _, tp = cell
    x = torch.from_numpy(_x(3, 1, 16, tcfg.d_model))
    y_par, _ = ssm.mamba_mix(tp, tcfg, x, chunk=4)
    cache = ssm.init_mamba_cache(tcfg, 1, dtype=torch.float32)
    ys = []
    for t in range(16):
        y_t, cache = ssm.mamba_decode(tp, tcfg, x[:, t:t + 1], cache)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_par, **DECODE_TOL)


# ------------------------------------------------------------ the jamba cut

def test_forward_matches_jax(pair):
    jm, jp, tm, tp = pair
    tok = _tokens(0, 2, 32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    assert tl.shape == (2, 32, 512)
    _close(tl, jl, **MODEL_TOL)


def test_prefill_and_decode_steps_match_jax(pair):
    """Prefill logits and caches (the Mamba states and conv tails, the
    attention layer's K), then 4 decode steps' logits."""
    jm, jp, tm, tp = pair
    tok = _tokens(1, 2, 28)
    s = 24
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :s])}, max_seq=28)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :s]).long()},
                        max_seq=28)
    _close(tl, jl, **MODEL_TOL)
    for i in (0, 7):
        for key in ("h", "conv"):
            _close(tc["groups"][i][key], jc["groups"][i][key])
    _close(tc["groups"][4]["k"], jc["groups"][4]["k"])
    step = jax.jit(jm.decode_step)
    for t in range(s, 28):
        jl, jc = step(jp, jc, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, t:t + 1]).long(),
                                t)
        _close(tl, jl, **MODEL_TOL)


@pytest.mark.parametrize("s", [2, 20])
def test_prefill_decode_reproduces_forward(pair, s):
    """Decoding token t after a prefill reproduces the full forward logits
    at t; a 2-token prompt is shorter than the conv window (3), which the
    port's cache takes and the reference's does not."""
    _, _, tm, tp = pair
    tok = torch.from_numpy(_tokens(2, 2, s + 4)).long()
    full, _ = tm.forward(tp, {"tokens": tok})
    _, cache = tm.prefill(tp, {"tokens": tok[:, :s]}, max_seq=s + 4)
    for t in range(s, s + 4):
        logits, cache = tm.decode_step(tp, cache, tok[:, t:t + 1], t)
        torch.testing.assert_close(logits[:, 0], full[:, t], **MODEL_TOL)


def test_greedy_tokens_equal_jax_engine(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(3)
    mix = [(8, 5), (16, 3), (8, 4), (16, 6)]
    prompts = [(i, rng.integers(0, 256, n).astype(np.int32), b)
               for i, (n, b) in enumerate(mix)]
    want = JaxServingEngine(jm, jp, max_seq=32).serve(
        [JaxRequest(i, p, b) for i, p, b in prompts], 2)
    got = ServingEngine(tm, tp, max_seq=32, device="cpu").serve(
        [Request(i, p, b) for i, p, b in prompts], 2)
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, g.request_id
        assert len(g.tokens) == dict((i, b) for i, _, b in prompts)[g.request_id]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_hands_the_kernel_what_it_takes(pair, monkeypatch, dtype):
    """Every ssm_scan call of prefill and decode passes the checks the card
    applies before a launch (dtypes, shapes, strides), here on CPU tensors:
    the fp32 model's B and C are column views of x_proj's output, the bf16
    model's x is bf16 beside fp32 dt, B, C."""
    from repro_torch.kernels.ssm_scan import ops
    calls = []

    def checked(x, dt, b_t, c_t, a, d, h0=None):
        ops._check(x, dt, b_t, c_t, a, d, h0)
        calls.append((x.dtype, dt.dtype, x.shape[1], h0 is not None))
        return ops.ssm_scan_ref(x, dt, b_t, c_t, a, d, h0)

    monkeypatch.setattr(ssm, "ssm_scan", checked)
    _, _, tm, tp = pair
    tp = {k: v for k, v in tp.items()}
    if dtype == "bfloat16":
        tcfg = registry.get_smoke_config(ARCH).scaled(**CUT)
        tm = build_model(tcfg)
        tp = init_params(tcfg, torch.Generator().manual_seed(2))
    tok = torch.from_numpy(_tokens(4, 2, 10)).long()
    with torch.inference_mode():
        _, cache = tm.prefill(tp, {"tokens": tok[:, :8]}, max_seq=10)
        for t in range(8, 10):
            _, cache = tm.decode_step(tp, cache, tok[:, t:t + 1], t)
    xdt = getattr(torch, dtype)
    assert calls == [(xdt, torch.float32, 8, False)] * 7 + \
        [(xdt, torch.float32, 1, True)] * 14


# ------------------------------------------------- the smoke config, MoE on

@pytest.fixture(scope="module")
def moe_pair():
    """(jax model, jax params, port model, port params): jamba's smoke
    config as it is, MoE layers (4 experts, top-2, dense dispatch) in every
    other layer, fp32."""
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    return jm, jp, build_model(tcfg), _t(jp)


def test_smoke_with_moe_layers_matches_jax(moe_pair):
    """Logits, loss and both aux losses of the whole model, then a prefill
    of 24 tokens and 4 decode steps."""
    jm, jp, tm, tp = moe_pair
    assert "router" in tp["groups"][1]["ffn"]
    tok = _tokens(4, 2, 28)
    jloss, jaux = jm.loss_fn(jp, {"tokens": jnp.asarray(tok)})
    tloss, taux = tm.loss_fn(tp, {"tokens": torch.from_numpy(tok).long()})
    _close(tloss, jloss)
    for k in ("moe_lb_loss", "moe_z_loss", "xent"):
        _close(taux[k], jaux[k])
    assert float(taux["moe_lb_loss"]) > 0
    s = 24
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :s])}, max_seq=28)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :s]).long()},
                        max_seq=28)
    _close(tl, jl, **MODEL_TOL)
    step = jax.jit(jm.decode_step)
    for t in range(s, 28):
        jl, jc = step(jp, jc, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, t:t + 1]).long(),
                                t)
        _close(tl, jl, **MODEL_TOL)
