"""The port's stablelm model on the CPU against the JAX model, with weights
that JAX initialized carried across by the bridge (smoke config, fp32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import MLA, MOE, SWA  # noqa: E402
from repro_torch.models import build_model, padded_vocab  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params), fp32 smoke."""
    jcfg = get_smoke_config("stablelm-1.6b").scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = registry.get_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, build_model(tcfg), tp


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def test_smoke_config_is_the_reference_one():
    jcfg = get_smoke_config("stablelm-1.6b")
    tcfg = registry.get_smoke_config("stablelm-1.6b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "d_ff", "vocab_size", "partial_rotary_factor", "rope_theta",
              "norm_eps", "param_dtype", "tie_embeddings", "pattern"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    full = registry.get_config("stablelm-1.6b")
    assert (full.num_layers, full.d_model, full.num_heads, full.head_dim,
            full.d_ff, padded_vocab(full)) == (24, 2048, 32, 64, 5632, 100_352)


def test_registry_names_the_ported_arches():
    """All ten of the reference's arch ids resolve, in its order, and an
    unknown id raises the reference's KeyError."""
    from repro.configs import registry as jreg
    assert registry.ARCH_IDS == jreg.ARCH_IDS
    for arch in registry.ARCH_IDS:
        assert registry.get_config(arch).name == arch
        assert registry.get_smoke_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch 'gemma4'; known: "):
        registry.get_config("gemma4")
    with pytest.raises(KeyError, match="unknown arch 'gemma4'"):
        jreg.get_config("gemma4")


@pytest.mark.parametrize("override,name", [
    (dict(pattern=(MLA,)), "mla"),
])
def test_unported_kinds_raise(override, name):
    """MLA is ported: an MLA layer without its sub-config is refused, as a
    MoE layer without `cfg.moe` is."""
    cfg = registry.get_smoke_config("stablelm-1.6b").scaled(**override)
    assert cfg.mla is None
    with pytest.raises(ValueError, match=f"{name.upper()} layers need "
                       f"cfg.{name}"):
        build_model(cfg)


def test_moe_layers_need_a_moe_config():
    cfg = registry.get_smoke_config("stablelm-1.6b").scaled(
        ffn_pattern=(MOE,))
    with pytest.raises(ValueError, match="MoE layers need cfg.moe"):
        build_model(cfg)


def test_swa_layers_pass_their_window(pair):
    """SWA layers with a window that covers the sequence give the ATTN
    model's logits; with a window of 4 they do not, and they equal JAX's
    SWA model's."""
    jm, jp, tm, tp = pair
    tok = _tokens(7, 2, 12)
    full, _ = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    for window, same in ((12, True), (4, False)):
        cfg = tm.cfg.scaled(pattern=(SWA,), window_size=window)
        got, _ = build_model(cfg).forward(
            tp, {"tokens": torch.from_numpy(tok).long()})
        assert torch.allclose(got, full, atol=1e-5) == same, window
    want, _ = jax_build_model(jm.cfg.scaled(pattern=("swa",), window_size=4)
                              ).forward(jp, {"tokens": jnp.asarray(tok)})
    _close(got, want)


@pytest.mark.parametrize("window,causal,softcap", [
    (0, True, 0.0), (3, True, 0.0), (0, False, 0.0), (0, True, 5.0)])
def test_naive_sdpa_matches_jax(window, causal, softcap):
    """GQA (G=2) over a ring-buffer cache with free slots (kv_pos -1)."""
    from repro.models.attention import naive_sdpa as jax_sdpa
    from repro_torch.models.attention import naive_sdpa
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 2, 2, 32), dtype=np.float32)
    k, v = (rng.standard_normal((2, 8, 2, 32), dtype=np.float32)
            for _ in range(2))
    q_pos = np.array([4, 5, 6], np.int32)
    kv_pos = np.array([0, 1, 2, 3, 4, 5, 6, -1], np.int32)
    args = [q, k, v, q_pos, kv_pos]
    want = jax_sdpa(*map(jnp.asarray, args), window=window, causal=causal,
                    softcap=softcap)
    got = naive_sdpa(*(torch.from_numpy(a) for a in args), window=window,
                     causal=causal, softcap=softcap)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_attention_softcap_on_cpu_matches_jax():
    """A nonzero attention softcap on the CPU: the flash wrapper's plain
    version with the softcap, against the reference's `sdpa`."""
    from repro.models.attention import attention_forward as jax_forward
    from repro.models.attention import attention_init
    from repro_torch.models.attention import attention_forward
    jcfg = get_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32", attn_logit_softcap=2.0)
    tcfg = registry.get_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32", attn_logit_softcap=2.0)
    jp = attention_init(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(6).standard_normal((2, 12, 128), dtype=np.float32)
    want = jax_forward(jp, jcfg, jnp.asarray(x))
    got = attention_forward(params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"), tcfg, torch.from_numpy(x))
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [256, 3072])
def test_softcap_attention_layer_matches_jax_with_grads(s):
    """stablelm's smoke attention layer with attn_logit_softcap 2.0, fp32,
    one sequence of S rows: the output and the gradients of a random
    projection of it, in every weight and in x, against the reference's
    `attention_forward` (`naive_sdpa` at S = 256, `blockwise_sdpa` and its
    custom VJP above 2048). Sums over 3072 rows in other orders: to 1e-5 of
    each array's largest entry."""
    from repro.models.attention import attention_forward as jax_forward
    from repro.models.attention import attention_init
    from repro_torch.models.attention import attention_forward
    jcfg = get_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32", attn_logit_softcap=2.0)
    tcfg = registry.get_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32", attn_logit_softcap=2.0)
    jp = attention_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, s, jcfg.d_model), dtype=np.float32)
    ct = rng.standard_normal((1, s, jcfg.d_model), dtype=np.float32)

    def jax_loss(p, xx):
        y = jax_forward(p, jcfg, xx)
        return jnp.sum(y * ct), y
    (_, want), (jg, jgx) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                              has_aux=True)(jp, jnp.asarray(x))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for leaf in tp.values():
        leaf.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    got = attention_forward(tp, tcfg, xt)
    (got * torch.from_numpy(ct)).sum().backward()
    pairs = [(got.detach(), want), (xt.grad, jgx)] + [
        (tp[name].grad, jg[name]) for name in sorted(jg)]
    for g, w in pairs:
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_forward_matches_jax(pair):
    jm, jp, tm, tp = pair
    tok = _tokens(0, 2, 32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    assert tl.shape == (2, 32, 512)
    _close(tl, jl)
    assert float(aux["moe_lb_loss"]) == 0.0


@pytest.mark.parametrize("s,max_seq", [(32, 40), (8, 8), (24, 64)])
def test_prefill_logits_and_cache_match_jax(pair, s, max_seq):
    jm, jp, tm, tp = pair
    tok = _tokens(1, 2, s)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_seq=max_seq)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok).long()},
                        max_seq=max_seq)
    assert tl.shape == (2, 1, 512)
    _close(tl, jl)
    for key in ("k", "v"):
        assert tc["groups"][0][key].shape == jc["groups"][0][key].shape
        _close(tc["groups"][0][key], jc["groups"][0][key], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc["groups"][0]["slot_pos"].numpy(),
                                  np.asarray(jc["groups"][0]["slot_pos"]))


def test_init_cache_matches_jax(pair):
    jm, _, tm, _ = pair
    jc = jm.init_cache(3, 20)["groups"][0]
    tc = tm.init_cache(3, 20)["groups"][0]
    for key in ("k", "v", "slot_pos"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))


def test_each_decode_step_matches_jax(pair):
    jm, jp, tm, tp = pair
    tok = _tokens(2, 2, 36)
    s = 28
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :s])}, max_seq=36)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :s]).long()},
                       max_seq=36)
    for t in range(s, 36):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, t:t + 1]).long(),
                                t)
        _close(tl, jl)
        np.testing.assert_array_equal(tc["groups"][0]["slot_pos"].numpy(),
                                      np.asarray(jc["groups"][0]["slot_pos"]))
        _close(tc["groups"][0]["k"], jc["groups"][0]["k"], rtol=1e-5, atol=1e-5)


def test_prefill_decode_reproduces_forward(pair):
    """The reference's own invariant (tests/test_models.py): decoding token t
    with a prefilled cache reproduces the full forward logits at t."""
    _, _, tm, tp = pair
    tok = torch.from_numpy(_tokens(3, 2, 32)).long()
    full, _ = tm.forward(tp, {"tokens": tok})
    _, cache = tm.prefill(tp, {"tokens": tok[:, :28]}, max_seq=32)
    for t in range(28, 32):
        logits, cache = tm.decode_step(tp, cache, tok[:, t:t + 1], t)
        torch.testing.assert_close(logits[:, 0], full[:, t], **TOL)


def test_decode_writes_the_cache_in_place(pair):
    _, _, tm, tp = pair
    tok = torch.from_numpy(_tokens(4, 1, 8)).long()
    _, cache = tm.prefill(tp, {"tokens": tok}, max_seq=12)
    k = cache["groups"][0]["k"]
    _, cache2 = tm.decode_step(tp, cache, tok[:, :1], 8)
    assert cache2["groups"][0]["k"] is k
    assert cache2["groups"][0]["slot_pos"].tolist() == [
        [0, 1, 2, 3, 4, 5, 6, 7, 8, -1, -1, -1]] * 2
    assert bool(k[:, :, 8].abs().sum() > 0) and bool(k[:, :, 9].abs().sum() == 0)
