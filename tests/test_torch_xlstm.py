"""The port's xLSTM mixers and the xlstm-125m model on the CPU against the
JAX package, with weights that JAX initialized carried across by the bridge
(smoke config, fp32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref  # noqa: E402
from repro_torch.models import build_model, padded_vocab  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

# fp32 throughout: one algorithm summed in other orders by torch and XLA.
TOL = dict(rtol=2e-4, atol=2e-4)
# Logits of the whole model, as tests/test_models.py bounds them.
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
# The reference's own bound for the parallel form against decode
# (tests/test_models.py:154-170).
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)


def _cfgs():
    return (get_smoke_config("xlstm-125m").scaled(param_dtype="float32"),
            registry.get_smoke_config("xlstm-125m").scaled(param_dtype="float32"))


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


@pytest.fixture(scope="module")
def cells():
    """JAX-initialized mLSTM and sLSTM params, both sides."""
    jcfg, tcfg = _cfgs()
    jm = jx.mlstm_init(jax.random.PRNGKey(0), jcfg)
    js = jx.slstm_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jm, js, _t(jm), _t(js)


def test_smoke_and_full_config_are_the_reference_ones():
    for get in ("get_smoke_config", "get_config"):
        from repro.configs import registry as jreg
        jcfg, tcfg = getattr(jreg, get)("xlstm-125m"), getattr(
            registry, get)("xlstm-125m")
        for f in ("num_layers", "d_model", "num_heads", "head_dim",
                  "vocab_size", "pattern", "ffn_pattern", "tie_embeddings",
                  "param_dtype", "opt_state_dtype", "norm_eps"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (get, f)
        assert vars(tcfg.xlstm) == vars(jcfg.xlstm)
    full = registry.get_config("xlstm-125m")
    di, h = 2 * full.d_model, full.num_heads
    assert (full.num_layers, full.d_model, di // h, padded_vocab(full)) == (
        12, 768, 384, 50_688)


# ------------------------------------------------------------------ mLSTM

@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32)])
def test_mlstm_mix_matches_jax(cells, s, chunk):
    jcfg, tcfg, jm, _, tm, _ = cells
    x = _x(0, 2, s, jcfg.d_model)
    jout, (jst, jtail) = jx.mlstm_mix(jm, jcfg, jnp.asarray(x), chunk=chunk)
    tout, (tst, ttail) = xlstm.mlstm_mix(tm, tcfg, torch.from_numpy(x),
                                         chunk=chunk)
    _close(tout, jout)
    _close(ttail, jtail)
    for a, b in zip(tst, jst):
        _close(a, b)


def test_mlstm_mix_with_state_and_conv_in_matches_jax(cells):
    """A second segment continues from the first's state and conv tail."""
    jcfg, tcfg, jm, _, tm, _ = cells
    x = _x(1, 2, 24, jcfg.d_model)
    _, (jst, jtail) = jx.mlstm_mix(jm, jcfg, jnp.asarray(x[:, :16]), chunk=8)
    jout, (jst2, jtail2) = jx.mlstm_mix(jm, jcfg, jnp.asarray(x[:, 16:]),
                                        state=jst, conv0=jtail, chunk=8)
    _, (tst, ttail) = xlstm.mlstm_mix(tm, tcfg, torch.from_numpy(x[:, :16]))
    tout, (tst2, ttail2) = xlstm.mlstm_mix(tm, tcfg, torch.from_numpy(x[:, 16:]),
                                           state=tst, conv0=ttail)
    _close(tout, jout)
    _close(ttail2, jtail2)
    for a, b in zip(tst2, jst2):
        _close(a, b)


def test_mlstm_decode_steps_match_jax(cells):
    jcfg, tcfg, jm, _, tm, _ = cells
    x = _x(2, 2, 6, jcfg.d_model)
    jc = jx.init_mlstm_cache(jcfg, 2, dtype=jnp.float32)
    tc = xlstm.init_mlstm_cache(tcfg, 2, dtype=torch.float32)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
    step = jax.jit(lambda p, xx, c: jx.mlstm_decode(p, jcfg, xx, c))
    for t in range(6):
        jy, jc = step(jm, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = xlstm.mlstm_decode(tm, tcfg, torch.from_numpy(x[:, t:t + 1]), tc)
        _close(ty, jy)
        for key in jc:
            _close(tc[key], jc[key])


def _plain_forward(q, k, v, log_i, log_f, state, bc):
    return mlstm_scan_ref(q, k, v, log_i, log_f, state, bc=bc)


def _through_function(q, k, v, log_i, log_f, state=None, *, bc=256):
    """The card's route on CPU tensors: the autograd Function, with the
    plain version standing in for the kernel launch."""
    y, c, n, m = ops._MLSTMScan.apply(_plain_forward, bc, q, k, v, log_i,
                                      log_f, *(state or (None,) * 3))
    return y, (c, n, m)


@pytest.fixture(scope="module")
def mlstm_grads(cells):
    """x, the output cotangent w, and `jax.grad` of the reference's
    `mlstm_mix` with respect to every param and x."""
    jcfg, _, jm, _, _, _ = cells
    x = _x(3, 2, 16, jcfg.d_model)
    w = np.random.default_rng(4).standard_normal(
        (2, 16, jcfg.d_model), dtype=np.float32)

    def jloss(p, xx):
        return jnp.sum(jx.mlstm_mix(p, jcfg, xx, chunk=8)[0] * w)

    return x, w, jax.jit(jax.grad(jloss, argnums=(0, 1)))(jm, jnp.asarray(x))


@pytest.mark.parametrize("route", ["plain", "function"])
def test_mlstm_mix_grads_match_jax_grad(cells, mlstm_grads, monkeypatch,
                                        route):
    """Gradients of every param and of x: autograd through the plain
    version, and the custom backward of the card's Function, against
    `jax.grad` of the reference's `mlstm_mix`."""
    _, tcfg, jm, _, _, _ = cells
    if route == "function":
        monkeypatch.setattr(xlstm, "mlstm_scan", _through_function)
    x, w, (jg, jgx) = mlstm_grads
    tp = {k: v.requires_grad_(True) for k, v in _t(jm).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = (xlstm.mlstm_mix(tp, tcfg, tx, chunk=8)[0]
            * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    for (name, _), g in zip(tp.items(), grads):
        _close(g, jg[name], rtol=1e-3, atol=1e-4)
    _close(grads[-1], jgx, rtol=1e-3, atol=1e-4)


def test_mlstm_parallel_matches_recurrent_decode(cells):
    """The reference's invariant (tests/test_models.py:154-170), on the
    port: the chunkwise form equals step-by-step decode."""
    _, tcfg, _, _, tm, _ = cells
    x = torch.from_numpy(_x(5, 1, 16, tcfg.d_model))
    y_par, _ = xlstm.mlstm_mix(tm, tcfg, x, chunk=8)
    cache = xlstm.init_mlstm_cache(tcfg, 1, dtype=torch.float32)
    ys = []
    for t in range(16):
        y_t, cache = xlstm.mlstm_decode(tm, tcfg, x[:, t:t + 1], cache)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_par, **DECODE_TOL)


# ------------------------------------------------------------------ sLSTM

def test_slstm_mix_matches_jax(cells):
    jcfg, tcfg, _, js, _, ts = cells
    x = _x(6, 2, 20, jcfg.d_model)
    jout, (jst, jtail) = jx.slstm_mix(js, jcfg, jnp.asarray(x[:, :12]))
    jout2, (jst2, _) = jx.slstm_mix(js, jcfg, jnp.asarray(x[:, 12:]),
                                    state=jst, conv0=jtail)
    tout, (tst, ttail) = xlstm.slstm_mix(ts, tcfg, torch.from_numpy(x[:, :12]))
    tout2, (tst2, _) = xlstm.slstm_mix(ts, tcfg, torch.from_numpy(x[:, 12:]),
                                       state=tst, conv0=ttail)
    _close(tout, jout)
    _close(tout2, jout2)
    for a, b in zip(tst2, jst2):
        _close(a, b)


def test_slstm_decode_matches_jax_and_the_parallel_form(cells):
    jcfg, tcfg, _, js, _, ts = cells
    x = _x(7, 2, 8, jcfg.d_model)
    jc = jx.init_slstm_cache(jcfg, 2, dtype=jnp.float32)
    tc = xlstm.init_slstm_cache(tcfg, 2, dtype=torch.float32)
    np.testing.assert_array_equal(tc["m"].numpy(), np.asarray(jc["m"]))
    ys = []
    step = jax.jit(lambda p, xx, c: jx.slstm_decode(p, jcfg, xx, c))
    for t in range(8):
        jy, jc = step(js, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = xlstm.slstm_decode(ts, tcfg, torch.from_numpy(x[:, t:t + 1]), tc)
        _close(ty, jy)
        ys.append(ty)
    for key in jc:
        _close(tc[key], jc[key])
    y_par, _ = xlstm.slstm_mix(ts, tcfg, torch.from_numpy(x))
    torch.testing.assert_close(torch.cat(ys, dim=1), y_par, **DECODE_TOL)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), _t(jp)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_params_are_tied_and_stacked(pair):
    _, jp, _, tp = pair
    assert "lm_head" not in tp and "lm_head" not in jp
    assert len(tp["groups"]) == 2
    assert set(tp["groups"][0]) == {"pre_norm", "mixer"}
    assert tp["groups"][1]["mixer"]["w_if"].dtype == torch.float32


def test_forward_matches_jax(pair):
    jm, jp, tm, tp = pair
    tok = _tokens(0, 2, 32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    assert tl.shape == (2, 32, 512)
    _close(tl, jl, **MODEL_TOL)
    assert float(aux["moe_lb_loss"]) == 0.0


def test_loss_and_grads_match_jax(pair):
    """`loss_fn` (padded vocab masked to -1e30) and the gradient of every
    leaf against `jax.value_and_grad(model.loss_fn)`."""
    from repro_torch.tree import tree_leaves, tree_map
    jm, jp, tm, tp = pair
    tok = _tokens(1, 2, 24)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {"tokens": jnp.asarray(tok)})
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, aux = tm.loss_fn(leaves, {"tokens": torch.from_numpy(tok).long()})
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    _close(loss, jloss, rtol=1e-5, atol=1e-5)
    _close(aux["xent"], jaux["xent"], rtol=1e-5, atol=1e-5)
    jleaves = tree_leaves(_np(jg))
    assert len(jleaves) == len(grads)
    for g, j in zip(grads, jleaves):
        _close(g, j, rtol=2e-3, atol=2e-5)


def _prefill_both(pair, tok, max_seq):
    """Prefill logits and every cache entry, the port against JAX."""
    jm, jp, tm, tp = pair
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_seq=max_seq)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok).long()},
                        max_seq=max_seq)
    _close(tl, jl, **MODEL_TOL)
    for i in range(2):
        for key in jc["groups"][i]:
            tv, jv = tc["groups"][i][key], np.asarray(jc["groups"][i][key])
            if key == "conv":
                tv = tv[:, :, tv.shape[2] - jv.shape[2]:]
            _close(tv, jv)
    return jc, tc


@pytest.mark.parametrize("s,max_seq", [(32, 40), (5, 8)])
def test_prefill_logits_and_cache_match_jax(pair, s, max_seq):
    jm, jp, tm, tp = pair
    tok = _tokens(2, 2, s + 3)
    jc, tc = _prefill_both(pair, tok[:, :s], max_seq)
    decode = jax.jit(jm.decode_step)
    for t in range(s, s + 3):
        jl, jc = decode(jp, jc, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, t:t + 1]).long(),
                                t)
        _close(tl, jl, **MODEL_TOL)


def test_init_cache_matches_jax(pair):
    jm, _, tm, _ = pair
    jc, tc = jm.init_cache(3, 20), tm.init_cache(3, 20)
    for i in range(2):
        assert set(tc["groups"][i]) == set(jc["groups"][i])
        for key, jv in jc["groups"][i].items():
            assert tuple(tc["groups"][i][key].shape) == jv.shape, key
            np.testing.assert_array_equal(tc["groups"][i][key].numpy(),
                                          np.asarray(jv))


def test_prefill_decode_reproduces_forward(pair):
    """The reference's invariant (tests/test_models.py:61-87) on the port:
    decoding token t with a prefilled cache reproduces the full forward
    logits at t."""
    _, _, tm, tp = pair
    tok = torch.from_numpy(_tokens(3, 2, 32)).long()
    full, _ = tm.forward(tp, {"tokens": tok})
    _, cache = tm.prefill(tp, {"tokens": tok[:, :28]}, max_seq=32)
    for t in range(28, 32):
        logits, cache = tm.decode_step(tp, cache, tok[:, t:t + 1], t)
        torch.testing.assert_close(logits[:, 0], full[:, t], **MODEL_TOL)


def test_short_prompt_prefill_then_decode(pair):
    """A prompt shorter than the conv kernel (S=2) leaves a short conv tail
    in the JAX cache, which the reference's decode cannot take. The port's
    cache puts that tail at the end of its zero rows, the conv's own left
    padding, so decode from it reproduces the full forward."""
    _, _, tm, tp = pair
    tok = _tokens(4, 2, 6)
    _, cache = _prefill_both(pair, tok[:, :2], 8)
    tok = torch.from_numpy(tok).long()
    full, _ = tm.forward(tp, {"tokens": tok})
    for t in range(2, 6):
        logits, cache = tm.decode_step(tp, cache, tok[:, t:t + 1], t)
        torch.testing.assert_close(logits[:, 0], full[:, t], **MODEL_TOL)
