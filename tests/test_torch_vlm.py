"""internvl2's `tokens+image` input in the port on the CPU against the JAX
package, with weights that JAX initialized carried across by the bridge
(smoke config, fp32): projected image embeddings before the tokens, the
loss that skips the image positions, prefill and decode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402

ARCH = "internvl2-2b"
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
P = 16   # the smoke config's image tokens


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or MODEL_TOL))


def _batch(seed, b, s):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
            "image_embeds": rng.standard_normal((b, P, 128),
                                                dtype=np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {"tokens": torch.from_numpy(batch["tokens"]).long(),
            "image_embeds": torch.from_numpy(batch["image_embeds"])}


@pytest.fixture(scope="module")
def pair():
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32")
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), _t(jp)


def test_forward_matches_jax(pair):
    """Logits over the image positions and the tokens after them."""
    jm, jp, tm, tp = pair
    assert tm.cfg.num_image_tokens == P and tp["img_proj"].shape == (128, 128)
    batch = _batch(1, 2, 20)
    jl, _ = jm.forward(jp, _jb(batch))
    tl, _ = tm.forward(tp, _tb(batch))
    assert tl.shape == (2, P + 20, 512)
    _close(tl, jl)


def test_loss_skips_the_image_positions(pair):
    """Position P-1+j predicts token j: the loss equals JAX's and the
    cross-entropy of those logits alone, and the image positions before
    P-1 predict nothing (over the real vocabulary's 256 rows)."""
    jm, jp, tm, tp = pair
    batch = _batch(2, 2, 20)
    loss, aux = tm.loss_fn(tp, _tb(batch))
    _close(loss, jm.loss_fn(jp, _jb(batch))[0])
    logits, _ = tm.forward(tp, _tb(batch))
    # the padded vocab rows (256 and up) weigh nothing in the loss
    by_hand = softmax_xent(logits[:, P - 1:-1, :256].float(),
                           torch.from_numpy(batch["tokens"]).long())
    torch.testing.assert_close(aux["xent"], by_hand, rtol=1e-6, atol=1e-6)


def test_labels_and_mask_match_jax(pair):
    """The chunked loss's labels and mask over the whole hidden sequence."""
    jm, _, tm, _ = pair
    batch = _batch(3, 2, 20)
    jl, jmask = jm._labels_and_mask(_jb(batch), P + 20)
    tl, tmask = tm._labels_and_mask(_tb(batch), P + 20)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert float(tmask[0, :P - 1].sum()) == 0 and float(tmask[0, -1]) == 0


def test_chunked_loss_matches_the_unchunked(pair):
    """The image offset in the chunked loss too: at any vocabulary it equals
    the unchunked loss (2048 positions, two chunks)."""
    _, _, tm, tp = pair
    chunked = type("Chunked", (type(tm),), {"CHUNKED_LOSS_VOCAB": 1})(tm.cfg)
    batch = _tb(_batch(4, 1, 2048 - P))
    with torch.no_grad():
        want, _ = tm.loss_fn(tp, batch)
        got, _ = chunked.loss_fn(tp, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_prefill_and_decode_match_jax(pair):
    """The prompt is the image and 12 tokens; decode continues at position
    P + 12 with tokens only."""
    jm, jp, tm, tp = pair
    batch = _batch(5, 2, 16)
    pre = dict(batch, tokens=batch["tokens"][:, :12])
    jl, jc = jm.prefill(jp, _jb(pre), max_seq=P + 16)
    tl, tc = tm.prefill(tp, _tb(pre), max_seq=P + 16)
    _close(tl, jl)
    assert tc["groups"][0]["slot_pos"][0].tolist()[:P + 13] == \
        list(range(P + 12)) + [-1]
    for t in range(12, 16):
        tok = batch["tokens"][:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(P + t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long(), P + t)
        _close(tl, jl)
    full, _ = tm.forward(tp, _tb(batch))
    torch.testing.assert_close(tl[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)
