"""deepseek-v2's MLA and its dense first layer in the port on the CPU
against the JAX package, with weights that JAX initialized carried across
by the bridge (smoke config, fp32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import MLAConfig as JMLAConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import init_params, params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import _dense_ffn_width  # noqa: E402

ARCH = "deepseek-v2-236b"
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
# MLA at the full config's head dims (the kernel's 192), smoke widths
WIDE = dict(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=64,
            nope_head_dim=128, v_head_dim=128)


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or MODEL_TOL))


def _cfgs(absorb=True, wide=False):
    jcfg = jreg.get_smoke_config(ARCH).scaled(param_dtype="float32")
    tcfg = registry.get_smoke_config(ARCH).scaled(param_dtype="float32")
    m = dict(WIDE) if wide else dict(vars(tcfg.mla))
    m["absorb_decode"] = absorb
    return (jcfg.scaled(mla=JMLAConfig(**m)), tcfg.scaled(mla=MLAConfig(**m)))


def _x(seed, b, s, d=128):
    return np.random.default_rng(seed).standard_normal((b, s, d),
                                                       dtype=np.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["smoke", "wide"])
def layer(request):
    jcfg, tcfg = _cfgs(wide=request.param)
    jp = jattn.mla_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jp, _t(jp)


def test_mla_forward_matches_jax(layer):
    jcfg, tcfg, jp, tp = layer
    x = _x(2, 2, 20)
    want = jattn.mla_forward(jp, jcfg, jnp.asarray(x))
    got = attn.mla_forward(tp, tcfg, torch.from_numpy(x))
    _close(got, want, **LAYER_TOL)


def test_mla_prefill_cache_matches_jax(layer):
    jcfg, tcfg, jp, tp = layer
    x = _x(3, 2, 12)
    jo, jc = jattn.mla_prefill(jp, jcfg, jnp.asarray(x), max_seq=16)
    to, tc = attn.mla_prefill(tp, tcfg, torch.from_numpy(x), max_seq=16)
    _close(to, jo, **LAYER_TOL)
    for key in ("c_kv", "k_rope"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key], **LAYER_TOL)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))


@pytest.mark.parametrize("absorb", [True, False],
                         ids=["absorbed", "unabsorbed"])
def test_mla_decode_matches_jax(layer, absorb):
    """Decode steps after a prefill, absorbed (in the latent space) and
    unabsorbed (K, V expanded per head), against JAX's of the same kind;
    the cache is written in place."""
    jcfg, tcfg, jp, tp = layer
    jcfg = jcfg.scaled(mla=jcfg.mla.__class__(
        **{**vars(jcfg.mla), "absorb_decode": absorb}))
    tcfg = tcfg.scaled(mla=MLAConfig(**{**vars(tcfg.mla),
                                        "absorb_decode": absorb}))
    x = _x(4, 2, 14)
    _, jc = jattn.mla_prefill(jp, jcfg, jnp.asarray(x[:, :10]), max_seq=14)
    _, tc = attn.mla_prefill(tp, tcfg, torch.from_numpy(x[:, :10]),
                             max_seq=14)
    c_kv = tc["c_kv"]
    for t in range(10, 14):
        jo, jc = jattn.mla_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc,
                                  jnp.int32(t))
        to, tc = attn.mla_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                 tc, t)
        _close(to, jo, **LAYER_TOL)
    assert tc["c_kv"] is c_kv
    _close(tc["c_kv"], jc["c_kv"], **LAYER_TOL)
    assert tc["slot_pos"].tolist() == list(range(14))


def test_absorbed_decode_equals_unabsorbed(layer):
    _, tcfg, _, tp = layer
    x = torch.from_numpy(_x(5, 1, 9))
    outs = []
    for absorb in (True, False):
        cfg = tcfg.scaled(mla=MLAConfig(**{**vars(tcfg.mla),
                                           "absorb_decode": absorb}))
        _, cache = attn.mla_prefill(tp, cfg, x[:, :8], max_seq=9)
        outs.append(attn.mla_decode(tp, cfg, x[:, 8:], cache, 8)[0])
    torch.testing.assert_close(outs[0], outs[1], **LAYER_TOL)


@pytest.mark.parametrize("s", [1, 7, 33])
def test_zero_padded_values_equal_unpadded_attention(s):
    """MLA's flash call: v (B,H,S,128) zero-padded to the 192 of q and k,
    the output's first 128 columns kept, against plain attention with the
    unpadded v at the same 1/sqrt(192) scale."""
    rng = np.random.default_rng(s)
    q, k = (torch.from_numpy(rng.standard_normal((2, 4, s, 192),
                                                 dtype=np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 4, s, 128), dtype=np.float32))
    padded = torch.nn.functional.pad(v, (0, 64))
    got = flash_attention(q, k, padded, causal=True)
    assert bool((got[..., 128:] == 0).all())
    pos = torch.arange(s)
    want = attn.naive_sdpa(q.transpose(1, 2)[:, :, :, None], k.transpose(1, 2),
                           v.transpose(1, 2), pos, pos, causal=True)
    torch.testing.assert_close(got[..., :128], want[:, :, :, 0].transpose(1, 2),
                               rtol=1e-5, atol=1e-5)


def test_mla_hands_the_kernel_one_head_dim(monkeypatch):
    """At the full config's head dims the flash wrapper gets q, k and v of
    head_dim 192, v's last 64 columns zero: a head_dim the card takes."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    _, tcfg = _cfgs(wide=True)
    seen = []

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw,
                     bool((v[..., 128:] == 0).all())))
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(attn, "flash_attention", spy)
    params = attn.mla_init(torch.Generator().manual_seed(0), tcfg)
    attn.mla_forward(params, tcfg, torch.from_numpy(_x(6, 2, 10)))
    assert seen == [((2, 4, 10, 192),) * 3 + ({"causal": True}, True)]
    assert 192 in HEAD_DIMS


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), _t(jp)


def test_first_layer_is_dense(pair):
    """`first_k_dense = 1`: a list of one layer, MLA with a dense SwiGLU of
    `_dense_ffn_width` (2 d_model: the config's d_ff is the expert width),
    then the MoE groups."""
    _, _, tm, tp = pair
    cfg = tm.cfg
    assert cfg.first_k_dense == 1 and cfg.num_groups == 2
    assert isinstance(tp["first"], list) and len(tp["first"]) == 1
    assert tp["first"][0]["ffn"]["w_up"].shape == (128, 256) == \
        (cfg.d_model, _dense_ffn_width(cfg))
    assert "router" in tp["groups"][0]["ffn"]
    full = registry.get_config(ARCH)
    assert _dense_ffn_width(full) == 10_240
    got = init_params(cfg, torch.Generator().manual_seed(0))
    assert got["first"][0]["mixer"]["w_uk"].shape == (32, 4, 32)


def test_forward_and_loss_match_jax(pair):
    jm, jp, tm, tp = pair
    tok = np.random.default_rng(7).integers(0, 256, (2, 24)).astype(np.int32)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    _close(tl, jl)
    _close(taux["moe_lb_loss"], jaux["moe_lb_loss"])
    jloss, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(tok)})
    tloss, _ = tm.loss_fn(tp, {"tokens": torch.from_numpy(tok).long()})
    _close(tloss, jloss)


def test_prefill_and_decode_match_jax(pair):
    """Prefill builds the `first` layer's cache beside the groups'; each
    decode step's logits equal JAX's."""
    jm, jp, tm, tp = pair
    tok = np.random.default_rng(8).integers(0, 256, (2, 20)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :16])}, max_seq=20)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :16]).long()},
                        max_seq=20)
    _close(tl, jl)
    assert sorted(tc) == sorted(jc) == ["first", "groups"]
    assert tuple(tc["first"][0]["c_kv"].shape) == jc["first"][0]["c_kv"].shape
    assert tuple(tc["groups"][0]["c_kv"].shape) == jc["groups"][0]["c_kv"].shape
    for t in range(16, 20):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc,
                                torch.from_numpy(tok[:, t:t + 1]).long(), t)
        _close(tl, jl)
    _close(tc["first"][0]["c_kv"], jc["first"][0]["c_kv"], **LAYER_TOL)
