"""gemma3-12b in the port on the CPU against the JAX package, with weights
that JAX initialized carried across by the bridge (smoke config, fp32): its
qk-norm, its pattern of five sliding-window layers and one global layer,
its tied embeddings, and the chunked loss of vocabularies of 131,072 and
up."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ATTN, SWA  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "gemma3-12b"
# model logits and loss against JAX, fp32; a layer's output
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or MODEL_TOL))


@pytest.fixture(scope="module")
def pair():
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32")
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), _t(jp)


def test_smoke_is_gemma3_in_small():
    cfg = registry.get_smoke_config(ARCH)
    assert cfg.pattern == (SWA,) * 5 + (ATTN,)
    assert cfg.qk_norm and cfg.tie_embeddings and cfg.window_size == 16
    full = registry.get_config(ARCH)
    assert (full.head_dim, full.num_heads, full.num_kv_heads,
            full.window_size, full.vocab_size) == (256, 16, 8, 1024, 262_144)


@pytest.mark.parametrize("window", [0, 8])
def test_qk_norm_attention_matches_jax(window):
    """With qk_norm, q and k are l2-normalized per head before RoPE: a layer
    against JAX's, global and windowed; without it the output differs."""
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32")
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    jp = jattn.attention_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(4).standard_normal((2, 24, 128), dtype=np.float32)
    want = jattn.attention_forward(jp, jcfg, jnp.asarray(x), window=window)
    got = attn.attention_forward(_t(jp), tcfg, torch.from_numpy(x),
                                 window=window)
    _close(got, want, **LAYER_TOL)
    plain = attn.attention_forward(_t(jp), tcfg.scaled(qk_norm=False),
                                   torch.from_numpy(x), window=window)
    assert not torch.allclose(plain, got, atol=1e-3)


def test_swa_and_global_layers_match_jax(pair):
    """40 tokens through five windowed layers (16 keys) and one global one:
    the logits equal JAX's, and differ from the model whose global layer
    is windowed too."""
    jm, jp, tm, tp = pair
    tok = _tokens(1, 2, 40)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    _close(got, want)
    all_swa = build_model(tm.cfg.scaled(pattern=(SWA,) * 6))
    other, _ = all_swa.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    assert not torch.allclose(other, got, atol=1e-3)


def test_tied_embeddings(pair):
    """No `lm_head`: the logits are the final hidden states times the
    embedding table, which gets the gradient of both uses."""
    _, _, tm, tp = pair
    assert "lm_head" not in tp
    tok = torch.from_numpy(_tokens(2, 2, 12)).long()
    logits, _ = tm.forward(tp, {"tokens": tok})
    h, _ = tm._hidden(tp, {"tokens": tok})
    torch.testing.assert_close(logits, h @ tp["embed"]["table"].T,
                               rtol=0, atol=0)
    (_, _), grads = value_and_grad(tm, tp, {"tokens": tok})
    table_grad = grads["embed"]["table"]
    assert bool(table_grad[tok.unique()].abs().sum() > 0)
    unseen = torch.ones(table_grad.shape[0], dtype=torch.bool)
    unseen[tok.unique()] = False
    assert bool(table_grad[unseen].abs().sum() > 0)   # from the unembed


def test_prefill_and_decode_past_the_window_match_jax(pair):
    jm, jp, tm, tp = pair
    tok = _tokens(3, 2, 24)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :19])}, max_seq=30)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :19]).long()},
                        max_seq=30)
    for t in range(19, 24):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc,
                                torch.from_numpy(tok[:, t:t + 1]).long(), t)
        _close(tl, jl)
    # ring caches of the window's 16 slots, the global layer's of 30
    assert tc["groups"][0]["k"].shape[2] == 16
    assert tc["groups"][5]["k"].shape[2] == 30


def _chunked(model):
    """The model with the chunked loss at any vocabulary, as
    tests/test_models.py lowers CHUNKED_LOSS_VOCAB."""
    return type("Chunked", (type(model),), {"CHUNKED_LOSS_VOCAB": 1})(model.cfg)


@pytest.fixture(scope="module")
def long_batch():
    return np.random.default_rng(9).integers(0, 500, (1, 2048)).astype(np.int32)


def test_chunked_loss_and_grads_equal_the_unchunked(pair, long_batch):
    """2048 positions in two chunks of 1024: the value to 1e-5 and every
    gradient leaf to the reference test's 2e-4 / 2e-5, against the port's
    unchunked loss."""
    _, _, tm, tp = pair
    chunked = _chunked(tm)
    batch = {"tokens": torch.from_numpy(long_batch).long()}
    (l_full, _), g_full = value_and_grad(tm, tp, batch)
    (l_chunk, _), g_chunk = value_and_grad(chunked, tp, batch)
    np.testing.assert_allclose(float(l_chunk), float(l_full), rtol=1e-5)
    for a, b in zip(tree_leaves(g_chunk), tree_leaves(g_full)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_chunked_loss_value_equals_jax(pair, long_batch):
    """The chunked loss's value against the reference's chunked loss (its
    forward only: JAX's gradient test is `slow`)."""
    jm, jp, tm, tp = pair
    jchunked = _chunked(jm)
    want, _ = jax.jit(jchunked.loss_fn)(jp, {"tokens": jnp.asarray(long_batch)})
    with torch.no_grad():
        got, _ = _chunked(tm).loss_fn(
            tp, {"tokens": torch.from_numpy(long_batch).long()})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3, atol=2e-3)


def test_chunked_loss_recomputes_each_chunk_in_the_backward(pair):
    """Each chunk's logits are computed once without grad and, under
    autograd, again in the backward (`checkpoint`), never kept: 1536
    positions in 3 chunks of gcd(1536, 1024) = 512 take 6 unembeds."""
    _, _, tm, tp = pair
    model = _chunked(tm)
    calls = []
    unembed = model._unembed

    def counting(params, h):
        calls.append(tuple(h.shape))
        return unembed(params, h)

    model._unembed = counting
    tok = torch.from_numpy(_tokens(5, 1, 1500, 500)).long()
    with torch.no_grad():
        model.loss_fn(tp, {"tokens": tok})
    # gcd(1500, 1024) = 4: 375 chunks of 4 positions
    assert len(calls) == 375 and calls[0] == (1, 4, 128)
    calls.clear()
    tok = torch.from_numpy(_tokens(6, 1, 1536, 500)).long()
    value_and_grad(model, tp, {"tokens": tok})
    assert calls == [(1, 512, 128)] * 6
