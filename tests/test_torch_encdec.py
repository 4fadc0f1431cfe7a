"""seamless-m4t's encoder-decoder in the port on the CPU against the JAX
package, with weights that JAX initialized carried across by the bridge
(smoke config, fp32): the encoder, cross-attention, forward, loss, prefill
and decode, and the reference's cross cache, padded with zero keys and
values to `max_seq` and cropped there, which the port copies."""
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
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "seamless-m4t-medium"
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or MODEL_TOL))


def _batch(seed, b, s, t):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
            "frames": rng.standard_normal((b, t, 128), dtype=np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {"tokens": torch.from_numpy(batch["tokens"]).long(),
            "frames": torch.from_numpy(batch["frames"])}


@pytest.fixture(scope="module")
def pair():
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32")
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), _t(jp)


def test_params_have_the_encoder_and_cross_layers(pair):
    _, jp, tm, tp = pair
    cfg = tm.cfg
    assert cfg.encoder_layers == 2 and cfg.input_mode == "frames"
    assert sorted(tp["encoder"]) == ["final_norm", "layers"]
    assert tp["encoder"]["layers"]["mixer"]["w_q"].shape == (2, 128, 128)
    assert "cross" not in tp["encoder"]["layers"]
    assert tp["groups"][0]["cross"]["w_k"].shape == (2, 128, 128)
    assert tp["frame_proj"].shape == (128, 128)


def test_encoder_matches_jax(pair):
    jm, jp, tm, tp = pair
    frames = _batch(1, 2, 4, 19)["frames"]
    want = jm._encode(jp, jnp.asarray(frames))
    got = tm._encode(tp, torch.from_numpy(frames))
    _close(got, want, **LAYER_TOL)


def test_cross_attention_matches_jax(pair):
    """S decoder rows over T encoder rows, no mask: the layer and the cross
    keys and values against JAX's, full-sequence and in decode."""
    jm, jp, tm, tp = pair
    jc = jax.tree.map(lambda a: a[0], jp["groups"][0]["cross"])
    tc = {k: v[0] for k, v in tp["groups"][0]["cross"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 128), dtype=np.float32)
    enc = rng.standard_normal((2, 13, 128), dtype=np.float32)
    jkv = jattn.encode_cross_kv(jc, jm.cfg, jnp.asarray(enc))
    tkv = attn.encode_cross_kv(tc, tm.cfg, torch.from_numpy(enc))
    for key in ("k", "v"):
        _close(tkv[key], jkv[key], **LAYER_TOL)
    want = jattn.cross_attention_forward(jc, jm.cfg, jnp.asarray(x), jkv)
    _close(attn.cross_attention_forward(tc, tm.cfg, torch.from_numpy(x), tkv),
           want, **LAYER_TOL)
    want = jattn.cross_attention_forward(jc, jm.cfg, jnp.asarray(x[:, :1]),
                                         jkv)
    _close(attn.cross_attention_decode(tc, tm.cfg, torch.from_numpy(x[:, :1]),
                                       tkv), want, **LAYER_TOL)


def test_forward_and_loss_match_jax(pair):
    jm, jp, tm, tp = pair
    batch = _batch(3, 2, 20, 17)
    jl, _ = jm.forward(jp, _jb(batch))
    tl, _ = tm.forward(tp, _tb(batch))
    _close(tl, jl)
    _close(tm.loss_fn(tp, _tb(batch))[0], jm.loss_fn(jp, _jb(batch))[0])


@pytest.mark.parametrize("frames", [12, 24, 30],
                         ids=["padded", "exact", "cropped"])
def test_prefill_and_decode_match_jax(pair, frames):
    """An encoder shorter than, equal to and longer than max_seq 24: each
    decode step's logits and the cross cache equal JAX's."""
    jm, jp, tm, tp = pair
    batch = _batch(4, 2, 20, frames)
    pre = dict(batch, tokens=batch["tokens"][:, :16])
    jl, jc = jm.prefill(jp, _jb(pre), max_seq=24)
    tl, tc = tm.prefill(tp, _tb(pre), max_seq=24)
    _close(tl, jl)
    for key in ("cross_k", "cross_v"):
        assert tuple(tc["groups"][0][key].shape) == jc["groups"][0][key].shape
        _close(tc["groups"][0][key], jc["groups"][0][key], **LAYER_TOL)
    for t in range(16, 20):
        tok = batch["tokens"][:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long(), t)
        _close(tl, jl)


def _decode_off_forward(model, params, batch, to_batch, max_seq, step):
    """Largest gap between the decode logits after a 16-token prefill and
    the full forward's at the same positions, and the first layer's cross
    keys from the cache."""
    full, _ = model.forward(params, to_batch(batch))
    pre = dict(batch, tokens=batch["tokens"][:, :16])
    _, cache = model.prefill(params, to_batch(pre), max_seq=max_seq)
    gap = 0.0
    for t in range(16, 20):
        tok = batch["tokens"][:, t:t + 1]
        logits, cache = step(params, cache, tok, t)
        gap = max(gap, float(np.abs(np.asarray(logits[:, 0], np.float32)
                                    - np.asarray(full[:, t], np.float32)).max()))
    return gap, np.asarray(cache["groups"][0]["cross_k"])


@pytest.mark.parametrize("frames,same", [(12, False), (24, True),
                                         (30, False)],
                         ids=["zero-padded", "exact", "cropped"])
def test_cross_cache_pad_and_crop_on_both_packages(pair, frames, same):
    """The reference's behaviour, which the port copies: decode attends the
    zero keys and values that pad an encoder shorter than max_seq (24) and
    never sees the frames past it, so decode reproduces the forward only
    when the encoder has exactly max_seq frames. Shown on both packages."""
    jm, jp, tm, tp = pair
    batch = _batch(5, 2, 20, frames)
    jgap, jkeys = _decode_off_forward(
        jm, jp, batch, _jb, 24,
        lambda p, c, tok, t: jm.decode_step(p, c, jnp.asarray(tok),
                                            jnp.int32(t)))
    with torch.no_grad():
        tgap, tkeys = _decode_off_forward(
            tm, tp, batch, _tb, 24,
            lambda p, c, tok, t: tm.decode_step(p, c, torch.from_numpy(tok)
                                                .long(), t))
    for gap in (jgap, tgap):
        assert (gap <= 2e-3) == same, (jgap, tgap)
    n = min(frames, 24)
    for keys in (jkeys, tkeys):
        assert keys.shape[2] == 24          # (groups, B, max_seq, kv, hd)
        assert not (keys[:, :, :n] == 0).all()
        assert (keys[:, :, n:] == 0).all()
    np.testing.assert_allclose(tkeys, jkeys, **LAYER_TOL)


def test_prefill_runs_flash_per_encoder_self_and_cross_layer(pair,
                                                             monkeypatch):
    """Full-sequence attention goes through the flash wrapper: one call a
    layer for the encoder (non-causal), the decoder's self-attention
    (causal) and its cross-attention (non-causal, S rows over T); decode
    calls none."""
    _, _, tm, tp = pair
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw.get("causal", True)))
        return flash_attention(q, k, v, **kw)

    from repro_torch.kernels.flash_attention import flash_attention
    monkeypatch.setattr(attn, "flash_attention", spy)
    batch = _batch(6, 1, 8, 11)
    _, cache = tm.prefill(tp, _tb(batch), max_seq=12)
    assert sorted(calls) == sorted(
        [(11, 11, False)] * 2 + [(8, 8, True)] * 2 + [(8, 11, False)] * 2)
    calls.clear()
    tm.decode_step(tp, cache, torch.zeros((1, 1), dtype=torch.long), 8)
    assert calls == []
