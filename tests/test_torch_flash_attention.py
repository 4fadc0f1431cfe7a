"""The port's flash attention on the CPU: the plain version against the JAX
kernel (interpret mode) and the JAX oracle, the plain backward against the
VJP of the reference's `blockwise_sdpa`, the wrapper's routing and checks,
and the kernel build logic. The Hopper kernels themselves are held against
the plain versions on the card by chip_smoke.py (phase 2,
`check_flash_backward`)."""
import math
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_ref, flash_attention)

# fp32 2e-5; bf16 2e-2 (one bf16 rounding of the output), compared in fp32
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, b, hq, hkv, s, t, hd, dtype):
    """Same numbers for both sides: numpy fp32, rounded to `dtype` once."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, n, hd), dtype=np.float32)
            for h, n in ((hq, s), (hkv, t), (hkv, t))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tt


def _compare(out_t, ref_j, dtype):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(ref_j, np.float32), **TOL[dtype])


SHAPES = [  # (b, hq, hkv, s, t, hd): tests/test_kernels.py shapes + ragged S
    (2, 4, 4, 128, 128, 64),     # MHA
    (2, 8, 2, 256, 256, 64),     # GQA 4:1
    (2, 4, 1, 128, 128, 128),    # MQA, wide head
    (2, 4, 4, 8, 8, 32),         # ragged: one short prompt
    (2, 4, 4, 40, 40, 32),       # ragged: not a multiple of any tile
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,t,hd", SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_plain_version_matches_jax(dtype, b, hq, hkv, s, t, hd, causal,
                                   window):
    (qj, kj, vj), (q, k, v) = _inputs(0, b, hq, hkv, s, t, hd, dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    _compare(out, jax_attention_ref(qj, kj, vj, causal=causal, window=window),
             dtype)
    _compare(out, jax_flash_attention(qj, kj, vj, causal=causal,
                                      window=window, backend="interpret"),
             dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,t,hd,causal,window", [
    (1, 4, 2, 32, 32, 256, True, 0),      # gemma3: hd 256, GQA 2:1, global
    (1, 4, 2, 32, 32, 256, True, 8),      # gemma3's sliding window
    (1, 4, 4, 32, 32, 192, True, 0),      # MLA: hd 192 (nope + rope)
    (1, 4, 4, 16, 32, 192, False, 0),     # non-causal, S != T
])
def test_plain_version_wide_heads_match_jax(dtype, b, hq, hkv, s, t, hd,
                                            causal, window):
    """The head dims 256 (gemma3) and 192 (MLA) that the Hopper kernel now
    takes, against the Pallas kernel in interpret mode and the oracle."""
    (qj, kj, vj), (q, k, v) = _inputs(21, b, hq, hkv, s, t, hd, dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    _compare(out, jax_attention_ref(qj, kj, vj, causal=causal, window=window),
             dtype)
    _compare(out, jax_flash_attention(qj, kj, vj, causal=causal,
                                      window=window, bq=16, bk=16,
                                      backend="interpret"), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_cross_lengths(dtype):
    (qj, kj, vj), (q, k, v) = _inputs(1, 1, 2, 2, 64, 256, 64, dtype)
    out = attention_ref(q, k, v, causal=False)
    _compare(out, jax_attention_ref(qj, kj, vj, causal=False), dtype)
    _compare(out, jax_flash_attention(qj, kj, vj, causal=False, bq=64, bk=64,
                                      backend="interpret"), dtype)


@pytest.mark.parametrize("b,hq,hkv,s,t,hd,causal,window", [
    (1, 4, 4, 1, 1, 64, True, 0),            # one row
    (1, 4, 2, 129, 129, 64, True, 100),      # odd S, window off the tile
    (1, 4, 4, 100, 160, 32, False, 64),      # non-causal window, S < T
])
def test_plain_version_odd_shapes(b, hq, hkv, s, t, hd, causal, window):
    """Shapes the JAX kernel's divisibility assert refuses: the oracle only."""
    (qj, kj, vj), (q, k, v) = _inputs(4, b, hq, hkv, s, t, hd, "float32")
    _compare(flash_attention(q, k, v, causal=causal, window=window),
             jax_attention_ref(qj, kj, vj, causal=causal, window=window),
             "float32")


def test_strided_views_give_the_same_result():
    """The model hands the wrapper (B,S,H,hd) tensors as transposed views."""
    _, (q, k, v) = _inputs(2, 2, 8, 2, 40, 40, 32, "float32")
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert not qs.is_contiguous()
    torch.testing.assert_close(flash_attention(qs, ks, vs, window=16),
                               flash_attention(q, k, v, window=16),
                               rtol=0, atol=0)


def test_cpu_tensors_do_not_launch():
    before = flash_attention.launches
    _, (q, k, v) = _inputs(3, 1, 2, 2, 16, 16, 32, "float32")
    flash_attention(q, k, v)
    assert flash_attention.launches == before == 0


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: here the
    build is made to fail, and the plain version must not answer."""
    def no_build(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_build)
    ops._entry.cache_clear()
    q = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(RuntimeError, match="cannot build flash_attention"):
        flash_attention(q, q, q)
    ops._entry.cache_clear()
    assert flash_attention.launches == 0


# `_FlashAttention` with the plain pair (the blockwise backward) against
# autograd through the plain version: fp32 sums of 24 keys or rows in
# another order, to 1e-6; bf16 grads are rounded to bf16 once on each side
# (2e-2).
GRAD_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,needs", [
    (True, 0, (True, True, True)), (True, 5, (True, True, True)),
    (False, 0, (True, True, True)), (True, 5, (False, True, False))])
def test_recompute_backward_matches_autograd(dtype, causal, window, needs):
    """`_FlashAttention` with the plain versions injected in place of the
    launches (`plain_fwd`, `attention_bwd_ref`): its output, and dq, dk, dv
    (only those asked for) against autograd through `attention_ref`."""
    _, ins = _inputs(11, 2, 4, 2, 24, 24, 32, dtype)
    dout = torch.randn(2, 4, 24, 32, generator=torch.Generator().manual_seed(
        12)).to(ins[0].dtype)
    grads = []
    for fn in ("function", "autograd"):
        xs = [t.clone().requires_grad_(n) for t, n in zip(ins, needs)]
        if fn == "function":
            out = ops._FlashAttention.apply(ops.plain_fwd, attention_bwd_ref,
                                            causal, window, 0.0, *xs)
        else:
            out = attention_ref(*xs, causal=causal, window=window)
        out.backward(dout)
        grads.append([out] + [x.grad for x in xs])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, **GRAD_TOL[dtype])


def test_card_tensors_that_need_grad_go_through_the_function(monkeypatch):
    """On a non-CPU tensor that needs a gradient the wrapper launches the
    forward with its lse inside `_FlashAttention` (its output has that
    grad_fn), and backward reaches q, k, v through the backward launch,
    given the forward's out and lse and the mask, softcap included; the
    plain version is never called. Without grad, or under no_grad, it
    launches bare, without lse. Meta tensors and stub launches stand in for
    the card."""
    calls, bwd_calls = [], []

    def launch(q, k, v, *, causal, window, softcap=0.0, with_lse=False):
        calls.append((causal, window, softcap, with_lse))
        out = torch.empty_like(q)
        if not with_lse:
            return out
        return out, torch.empty(q.shape[:3], device=q.device)

    def launch_bwd(q, k, v, out, lse, dout, *, causal, window, softcap):
        assert lse.shape == q.shape[:3] and dout.shape == out.shape
        bwd_calls.append((causal, window, softcap))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on a card tensor")

    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(ops, "attention_ref", no_plain)
    q, k, v = (torch.empty(1, 4, 16, 32, device="meta") for _ in range(3))
    out = flash_attention(q, k, v)
    assert out.grad_fn is None
    qg, kg, vg = (t.requires_grad_() for t in (q.clone(), k.clone(), v.clone()))
    with torch.no_grad():
        assert flash_attention(qg, kg, vg).grad_fn is None
    out = flash_attention(qg, kg, vg, window=8, softcap=2.0)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert bwd_calls == []
    out.sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (qg, kg, vg))
    assert calls == [(True, 0, 0.0, False), (True, 0, 0.0, False),
                     (True, 8, 2.0, True)]
    assert bwd_calls == [(True, 8, 2.0)]


@pytest.mark.parametrize("hd,wide", [(48, 64), (96, 128), (20, 32)])
def test_head_dims_between_the_kernels_are_padded(monkeypatch, hd, wide):
    """Off the CPU a head_dim between the kernel's launches it at the next
    one (q, k, v zero-padded, q scaled) and crops the output; the same
    padding through the plain version gives the unpadded result (fp32)."""
    shapes = []

    def launch(q, k, v, *, causal, window, softcap=0.0):
        shapes.append(tuple(q.shape))
        return torch.empty_like(q)

    monkeypatch.setattr(ops, "_launch", launch)
    q, k, v = (torch.empty(1, 4, 16, hd, device="meta") for _ in range(3))
    assert flash_attention(q, k, v).shape == q.shape
    assert shapes == [(1, 4, 16, wide)]
    _, (q, k, v) = _inputs(5, 2, 4, 2, 24, 24, hd, "float32")
    for causal, window in ((True, 0), (True, 7), (False, 0)):
        torch.testing.assert_close(
            ops._padded(q, k, v, causal=causal, window=window),
            attention_ref(q, k, v, causal=causal, window=window),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,t,causal,window,chunk", [
    (40, 40, True, 0, 8), (40, 40, True, 7, 16), (64, 64, True, 100, 24),
    (30, 50, False, 9, 8), (50, 30, True, 0, 16)])
def test_row_chunked_plain_version_equals_the_whole(s, t, causal, window,
                                                     chunk):
    """`row_chunk` gives the unchunked result (fp32, sums of other lengths
    over keys whose weights are exactly 0)."""
    _, (q, k, v) = _inputs(13, 2, 4, 2, s, t, 32, "float32")
    torch.testing.assert_close(
        attention_ref(q, k, v, causal=causal, window=window, row_chunk=chunk),
        attention_ref(q, k, v, causal=causal, window=window),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------- the backward and the softcap

# GQA 4:1 over the reference's masks: name -> (causal, window, S, T)
BWD_MASKS = {"causal": (True, 0, 128, 128),
             "causal window 64": (True, 64, 128, 128),
             "non-causal S=64 T=256": (False, 0, 64, 256)}


def _bwd_inputs(seed, s, t, dtype, b=2, h=8, hkv=2, hd=32):
    """q, k, v and dout as torch tensors of `dtype` and the same numbers as
    fp32 numpy arrays (B,H|Hkv,S|T,hd)."""
    rng = np.random.default_rng(seed)
    tt = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
          .to(getattr(torch, dtype))
          for shape in ((b, h, s, hd), (b, hkv, t, hd), (b, hkv, t, hd),
                        (b, h, s, hd))]
    return [x.float().numpy() for x in tt], tt


def _to_jax(x, hkv, dtype):
    """(B,H,S,hd) -> the reference's (B,S,Kv,G,hd); (B,Hkv,T,hd) with
    hkv=None -> (B,T,Kv,hd)."""
    b, h, s, d = x.shape
    if hkv is None:
        return jnp.asarray(x.transpose(0, 2, 1, 3)).astype(dtype)
    return jnp.asarray(x.reshape(b, hkv, h // hkv, s, d)
                       .transpose(0, 3, 1, 2, 4)).astype(dtype)


def _from_jax(x):
    """(B,S,Kv,G,hd) -> (B,H,S,hd); (B,T,Kv,hd) -> (B,Kv,T,hd)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 4:
        return x.transpose(0, 2, 1, 3)
    b, s, kv, g, d = x.shape
    return x.transpose(0, 2, 3, 1, 4).reshape(b, kv * g, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", list(BWD_MASKS))
@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_plain_backward_matches_the_jax_blockwise_vjp(dtype, mask, softcap):
    """`attention_bwd_ref` (chunks of 64) from the plain forward's out and
    lse against `jax.vjp` of the reference's `blockwise_sdpa` (chunks of
    64), GQA 4:1: fp32 to 1e-5 (sums in other orders); bf16 to 2e-2 of the
    largest entry (the reference rounds P to bf16 before P.V, so the two
    outputs, and with them delta, differ by a bf16 rounding)."""
    causal, window, s, t = BWD_MASKS[mask]
    (qn, kn, vn, don), (q, k, v, do) = _bwd_inputs(31, s, t, dtype)
    jdt = getattr(jnp, dtype)
    qp, kp = jnp.arange(s), jnp.arange(t)

    def blockwise(a, b_, c):
        return jax_attention.blockwise_sdpa(a, b_, c, qp, kp, window, causal,
                                            softcap, 64, 64)
    _, vjp = jax.vjp(blockwise, _to_jax(qn, 2, jdt), _to_jax(kn, None, jdt),
                     _to_jax(vn, None, jdt))
    want = [_from_jax(g) for g in vjp(_to_jax(don, 2, jdt))]
    out, lse = attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, return_lse=True)
    got = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                            window=window, softcap=softcap, q_chunk=64,
                            kv_chunk=64)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape, name
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name


# (q/k head_dim, v's own head_dim, causal, window, S): gemma3's head_dim
# with a window, and MLA's 192 with v of 128 zero-padded to 192 as
# `mla_forward` pads it for the kernel
WIDE_BWD = {"hd 256 window 40": (256, 256, True, 40, 128),
            "hd 256 causal": (256, 256, True, 0, 128),
            "hd 192, v 128 padded": (192, 128, True, 0, 128)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WIDE_BWD))
@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_plain_backward_matches_the_jax_vjp_at_wide_heads(dtype, case,
                                                          softcap):
    """`attention_bwd_ref`, the plain version the card's backward at hd 192
    and 256 is held to, against `jax.vjp` of the reference's
    `blockwise_sdpa` (chunks of 64), GQA 2:1, at the tolerances of the hd
    32 test. MLA's case: the port's v zero-padded from 128 to 192 and an
    output gradient that is 0 in the padded columns (the output is cropped)
    against the reference on v of 128; the padded columns of dv are 0."""
    hd, v_hd, causal, window, s = WIDE_BWD[case]
    rng = np.random.default_rng(37)
    b, h, hkv = 1, 4, 2
    arrays = [rng.standard_normal(shape, dtype=np.float32) for shape in (
        (b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, v_hd), (b, h, s, v_hd))]
    tt = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays]
    qn, kn, vn, don = [x.float().numpy() for x in tt]
    q, k, v, do = (tt[0], tt[1], torch.nn.functional.pad(tt[2], (0, hd - v_hd)),
                   torch.nn.functional.pad(tt[3], (0, hd - v_hd)))
    jdt = getattr(jnp, dtype)
    pos = jnp.arange(s)

    def blockwise(a, b_, c):
        return jax_attention.blockwise_sdpa(a, b_, c, pos, pos, window,
                                            causal, softcap, 64, 64)
    _, vjp = jax.vjp(blockwise, _to_jax(qn, hkv, jdt),
                     _to_jax(kn, None, jdt), _to_jax(vn, None, jdt))
    want = [_from_jax(g) for g in vjp(_to_jax(don, hkv, jdt))]
    mask = {"causal": causal, "window": window, "softcap": softcap}
    out, lse = attention_ref(q, k, v, return_lse=True, **mask)
    assert not out[..., v_hd:].any()
    got = attention_bwd_ref(q, k, v, out, lse, do, q_chunk=64, kv_chunk=64,
                            **mask)
    assert not got[2][..., v_hd:].any()
    got = [got[0], got[1], got[2][..., :v_hd]]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape, name
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name


@pytest.mark.parametrize("mask", list(BWD_MASKS))
@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_plain_lse_matches_the_jax_blockwise_forward(mask, softcap):
    """The plain version's lse (whole and row-chunked) against the lse
    `blockwise_sdpa`'s forward saves (fp32, 1e-5)."""
    causal, window, s, t = BWD_MASKS[mask]
    (qn, kn, vn, _), (q, k, v, _) = _bwd_inputs(32, s, t, "float32")
    _, want = jax_attention._blockwise_fwd_impl(
        _to_jax(qn, 2, jnp.float32), _to_jax(kn, None, jnp.float32),
        _to_jax(vn, None, jnp.float32), jnp.arange(s), jnp.arange(t),
        window, causal, softcap, 64, 64)
    want = np.asarray(want).reshape(q.shape[:3])
    for chunk in (0, 48):
        _, lse = attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap, row_chunk=chunk,
                               return_lse=True)
        assert lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask", list(BWD_MASKS))
def test_softcap_plain_version_matches_jax_naive_sdpa(mask):
    """`attention_ref(softcap=)` against the reference's `naive_sdpa` with
    the same softcap (fp32, TOL), whole and row-chunked."""
    causal, window, s, t = BWD_MASKS[mask]
    (qn, kn, vn, _), (q, k, v, _) = _bwd_inputs(33, s, t, "float32")
    want = jax_attention.naive_sdpa(
        _to_jax(qn, 2, jnp.float32), _to_jax(kn, None, jnp.float32),
        _to_jax(vn, None, jnp.float32), jnp.arange(s), jnp.arange(t),
        window=window, causal=causal, softcap=2.0)
    for chunk in (0, 48):
        got = attention_ref(q, k, v, causal=causal, window=window,
                            softcap=2.0, row_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), _from_jax(want),
                                   **TOL["float32"])


@pytest.mark.parametrize("hd", [48, 96, 20])
def test_padded_head_dims_keep_the_softcap(hd):
    """`_padded` scales q so that the kernel's scaled score is the unpadded
    one, and so is its softcap: through the plain version it equals the
    unpadded plain version with the same softcap (fp32)."""
    _, (q, k, v) = _inputs(14, 2, 4, 2, 24, 24, hd, "float32")
    for causal, window in ((True, 0), (True, 7), (False, 0)):
        torch.testing.assert_close(
            ops._padded(q, k, v, causal=causal, window=window, softcap=2.0),
            attention_ref(q, k, v, causal=causal, window=window,
                          softcap=2.0),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shapes,kw,err", [
    (((1, 2, 8, 48), (1, 2, 8, 48)), {}, "head_dim 48"),
    (((1, 2, 8, 96), (1, 2, 8, 96)), {}, "head_dim 96"),
    (((1, 3, 8, 32), (1, 2, 8, 32)), {}, "do not match"),
    (((1, 2, 8, 32), (2, 2, 8, 32)), {}, "do not match"),
    (((1, 2, 8, 32, 1), (1, 2, 8, 32)), {}, "want q"),
    (((1, 2, 0, 32), (1, 2, 8, 32)), {}, "empty"),
    (((1, 2, 80, 32), (1, 2, 8, 32)), {"window": 16}, "see no key"),
    (((1, 2, 8, 32), (1, 2, 8, 32)), {"window": -1}, "window"),
    (((1, 2, 8, 32), (1, 2, 8, 32)), {"softcap": -1.0}, "softcap"),
    (((1, 2, 8, 32), (1, 2, 8, 32)), {"softcap": float("inf")}, "softcap"),
])
def test_wrapper_checks(shapes, kw, err):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=err):
        ops._check(q, k, k, kw.get("window", 0), kw.get("softcap", 0.0))


def test_wrapper_checks_dtype_and_strides():
    q = torch.zeros(1, 2, 8, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops._check(q, q, q, 0)
    q = torch.zeros(1, 2, 32, 8).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head_dim"):
        ops._check(q, q, q, 0)
    ops._check(torch.zeros(1, 2, 8, 32), torch.zeros(1, 1, 8, 32),
               torch.zeros(1, 1, 8, 32), 0)


def _bf16_view(b, s, h, hd, pad=0, offset=0):
    """A (B,H,S,hd) bf16 view of the first H*hd columns of a (B,S,H*hd+pad)
    tensor that starts `offset` elements into its storage."""
    n = b * s * (h * hd + pad)
    base = torch.zeros(n + offset, dtype=torch.bfloat16)[offset:]
    x = base.view(b, s, h * hd + pad)[..., :h * hd]
    return x.unflatten(-1, (h, hd)).transpose(1, 2)


@pytest.mark.parametrize("pad,offset", [(1, 0), (4, 0), (0, 1), (8, 3)])
def test_bf16_alignment_is_checked(pad, offset):
    """The tensor-core path copies 16 bytes from each row start: an S
    stride that is not a multiple of 8 bf16, or a data pointer off 16
    bytes, raises and names the alignment."""
    q = _bf16_view(2, 16, 4, 32, pad, offset)
    assert q.data_ptr() % 16 == (2 * offset) % 16
    k = _bf16_view(2, 16, 4, 32)
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(ValueError, match="16-byte alignment"):
            ops._check(*args, 0)


def test_aligned_views_pass_the_checks():
    """A view into a wider tensor whose strides keep 16-byte rows passes,
    as does a size-1 axis of any stride; fp32 (the CUDA-core path) needs no
    alignment."""
    q = _bf16_view(2, 16, 4, 32, pad=64)
    assert q.stride(2) == 4 * 32 + 64
    ops._check(q, q, q, 0)
    one = torch.zeros(1, 16, 4 * 32 + 8, dtype=torch.bfloat16)[..., :128]
    ops._check(*(one.unflatten(-1, (4, 32)).transpose(1, 2),) * 3, 0)
    f32 = torch.zeros(2, 16, 4 * 32 + 1)[..., :128].unflatten(
        -1, (4, 32)).transpose(1, 2)
    ops._check(f32, f32, f32, 0)


def test_paths_name_each_dtype():
    assert ops.PATHS == {torch.float32: "cuda-core fp32",
                         torch.bfloat16: "mma.sync bf16"}


# ------------------------------------------ the wgmma + TMA backward's host side

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_bwd_path_by_dtype_and_head_dim(dtype, hd):
    """bf16 at head_dim 64, 128, 192 and 256 takes the single-pass wgmma +
    TMA backward; fp32, and bf16 at 32, the two-kernel design."""
    want = (ops.SM90_PATH if dtype == torch.bfloat16
            and hd in (64, 128, 192, 256) else ops.PATHS[dtype])
    assert ops.bwd_path(dtype, hd) == want


def _bshd(b, s, h, hd, dtype=torch.bfloat16, device="cpu", pad=0):
    """A (B,H,S,hd) view of a (B,S,H*hd+pad) tensor, as the model hands the
    kernel its activations."""
    x = torch.zeros(b, s, h * hd + pad, dtype=dtype, device=device)
    return x[..., :h * hd].unflatten(-1, (h, hd)).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_bwd_buffers_hold_the_designs_scratch(dtype, hd):
    """dq, dk, dv in the inputs' (B,S,H,hd) layout; the wgmma design's
    scratch is fp32 row stats (2,B,H,Sp), an fp32 dQ accumulator
    (B,H,Sp,hd) and int32 counts, one a q tile and the blocks' ticket
    (B*H*Sp/64 + 1), with Sp = S rounded up to 64 (ragged S = 200 -> 256);
    the other design's is delta (B,H,S)."""
    q = _bshd(2, 200, 8, hd, dtype, "meta")
    k = _bshd(2, 130, 2, hd, dtype, "meta")
    dq, dk, dv, scratch = ops._bwd_buffers(q, k, k)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dq.transpose(1, 2).is_contiguous()
    assert dk.transpose(1, 2).is_contiguous()
    assert {x.dtype for x in (dq, dk, dv)} == {dtype}
    if ops.bwd_path(dtype, hd) == ops.SM90_PATH:
        rows, acc, tiles = scratch
        assert rows.shape == (2, 2, 8, 256) and acc.shape == (2, 8, 256, hd)
        assert tiles.shape == (2 * 8 * 4 + 1,)
        assert tiles.dtype == torch.int32
        assert rows.is_contiguous() and acc.is_contiguous()
        assert tiles.is_contiguous()
        assert rows.dtype == acc.dtype == torch.float32
    else:
        (delta,) = scratch
        assert delta.shape == (2, 8, 200) and delta.dtype == torch.float32


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 256),
                                      (torch.float32, 64)])
def test_meta_backward_allocates_the_card_scratch(monkeypatch, dtype, hd):
    """Under the dry run's trace the backward's `meta` path allocates the
    card path's buffers through the one `_bwd_buffers` (the fp32 dQ
    accumulator where the wgmma design runs), so the traced peak holds
    them."""
    from repro_torch.analysis import trace
    made = []
    real = ops._bwd_buffers

    def recording(q, k, v):
        out = real(q, k, v)
        made.append([(tuple(x.shape), x.dtype) for x in (*out[:3], *out[3])])
        return out
    monkeypatch.setattr(ops, "_bwd_buffers", recording)
    q = _bshd(1, 96, 4, hd, dtype, "meta").requires_grad_()
    k, v = (_bshd(1, 96, 2, hd, dtype, "meta").requires_grad_()
            for _ in range(2))

    def step():
        out = ops.flash_attention(q, k, v)
        return torch.autograd.grad(out.float().sum(), (q, k, v))
    res, _ = trace.analyze_trace(step)
    want = [(tuple(x.shape), x.dtype) for x in (*real(q, k, v)[:3],
                                                *real(q, k, v)[3])]
    assert made == [want]
    scratch = sum(math.prod(s) * d.itemsize for s, d in want[3:])
    if ops.bwd_path(dtype, hd) == ops.SM90_PATH:
        assert want[4] == ((1, 4, 128, hd), torch.float32)
    assert res.peak_bytes >= scratch


@pytest.mark.parametrize("b,s,h,hd,pad,want", [
    # (hd, rows, heads, batch) and byte strides of rows, heads, batch
    (2, 200, 8, 128, 0, (128, 200, 8, 2, 2 * 8 * 128, 2 * 128,
                         2 * 200 * 8 * 128)),          # ragged S
    (2, 130, 2, 64, 0, (64, 130, 2, 2, 2 * 2 * 64, 2 * 64,
                        2 * 130 * 2 * 64)),            # keys: T != S
    (1, 2048, 48, 128, 0, (128, 2048, 48, 1, 2 * 48 * 128, 2 * 128,
                           2 * 2048 * 48 * 128)),      # batch 1: the span
    (2, 64, 1, 64, 64, (64, 64, 1, 2, 2 * 128, 2 * 2 * 64 * 64,
                        2 * 64 * 128)),                # one head, padded rows
])
def test_tma_geometry_of_the_bshd_views(b, s, h, hd, pad, want):
    """The TMA descriptor of a (B,S,H,hd) tensor viewed as (B,H,S,hd):
    dims innermost first and the byte strides of rows, heads and batch; an
    axis of length 1 gets the tensor's byte span (a multiple of 16)."""
    x = _bshd(b, s, h, hd, pad=pad)
    got = ops._tma_geometry(x)
    assert got == want
    assert all(st % 16 == 0 for st in got[4:])


def test_tma_ready_copies_only_broadcast_views():
    x = _bshd(1, 16, 4, 64)
    assert ops._tma_ready(x) is x
    y = torch.zeros(1, 1, 16, 64, dtype=torch.bfloat16).expand(1, 4, 16, 64)
    z = ops._tma_ready(y)
    assert z is not y and z.stride(1) == 16 * 64 and torch.equal(z, y)


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("s,t", [(200, 200), (64, 160)])
def test_sm90_args_take_the_tma_strides(hd, s, t):
    """The bf16 wrapper hands the wgmma entry point the four TMA geometries
    (q, k, v and a dout whose rows are padded), the element strides of out,
    dout, dq, dk, dv, and the scratch's pointers (row stats, accumulator,
    the counts a q tile)."""
    q, out = _bshd(2, s, 4, hd), _bshd(2, s, 4, hd)
    dout = _bshd(2, s, 4, hd, pad=8)
    k, v = _bshd(2, t, 2, hd), _bshd(2, t, 2, hd)
    lse = torch.zeros(2, 4, s)
    dq, dk, dv, scratch = ops._bwd_buffers(q, k, v)
    args = ops._sm90_args(q, k, v, out, lse, dout, dq, dk, dv, scratch,
                          causal=True, window=0, softcap=2.0)
    rows, acc, tiles = scratch
    assert args[:12] == tuple(x.data_ptr() for x in (
        q, k, v, out, dout, lse, rows, acc, tiles, dq, dk, dv))
    assert args[12:18] == (2, 4, 2, s, t, hd)
    tma, strides = list(args[18]), list(args[19])
    row = 2 * 4 * hd
    assert tma[:7] == [hd, s, 4, 2, row, 2 * hd, row * s]
    assert tma[7:14] == tma[14:21] == [hd, t, 2, 2, 2 * 2 * hd, 2 * hd,
                                       2 * 2 * hd * t]
    assert tma[21:] == [hd, s, 4, 2, row + 16, 2 * hd, (row + 16) * s]
    assert strides == [s * 4 * hd, hd, 4 * hd,            # out
                       s * (4 * hd + 8), hd, 4 * hd + 8,  # dout
                       s * 4 * hd, hd, 4 * hd,            # dq
                       t * 2 * hd, hd, 2 * hd,            # dk
                       t * 2 * hd, hd, 2 * hd]            # dv
    assert args[20:] == (1, 0, 2.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_launch_bwd_calls_the_designs_entry(monkeypatch, dtype, hd):
    """`_launch_bwd` calls the entry point of the design `bwd_path` names,
    once, and counts one backward launch; a failing call raises (no
    fallback). Meta tensors and stub entry points stand in for the card."""
    import contextlib
    calls = []

    def entry(name, rc=0):
        def fn(*args):
            calls.append((name, len(args)))
            return rc
        return fn
    monkeypatch.setattr(ops, "_sm90_entry",
                        lambda: (entry("sm90"), lambda: 0))
    monkeypatch.setattr(ops, "_bwd_entry", lambda: entry("mma"))
    monkeypatch.setattr(ops, "_entry", lambda: (None, lambda e: b"stub"))
    monkeypatch.setattr(ops, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    q, out, dout = (_bshd(1, 80, 4, hd, dtype, "meta") for _ in range(3))
    k, v = (_bshd(1, 80, 2, hd, dtype, "meta") for _ in range(2))
    lse = torch.empty(1, 4, 80, device="meta")
    before = flash_attention.bwd_launches
    by_design = dict(flash_attention.bwd_launches_by_design)
    dq, dk, dv = ops._launch_bwd(q, k, v, out, lse, dout, causal=True,
                                 window=0)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    path = ops.bwd_path(dtype, hd)
    sm90 = path == ops.SM90_PATH
    assert calls == [("sm90", 24) if sm90 else ("mma", 45)]   # stream last
    assert flash_attention.bwd_launches == before + 1
    assert flash_attention.bwd_launches_by_design == {
        d: n + (d == path) for d, n in by_design.items()}
    flash_attention.bwd_launches = before
    flash_attention.bwd_launches_by_design.update(by_design)
    monkeypatch.setattr(ops, "_sm90_entry",
                        lambda: (entry("sm90", 1), lambda: 1))
    monkeypatch.setattr(ops, "_bwd_entry", lambda: entry("mma", 1))
    with pytest.raises(RuntimeError, match="backward launch failed"):
        ops._launch_bwd(q, k, v, out, lse, dout, causal=True, window=0)
    assert flash_attention.bwd_launches == before
    assert flash_attention.bwd_launches_by_design == by_design


def test_bwd_launches_by_design_name_every_design():
    """The backward's count by design has one key a design `bwd_path` can
    name, as the forward's has one a design `fwd_path` can name."""
    assert set(flash_attention.bwd_launches_by_design) == {
        ops.SM90_PATH, *ops.PATHS.values()}
    assert set(flash_attention.bwd_launches_by_design) == set(
        flash_attention.launches_by_design)
    assert {ops.bwd_path(dt, hd) for dt in ops.PATHS
            for hd in ops.HEAD_DIMS} <= set(
        flash_attention.bwd_launches_by_design)


# ---------------------------------------------------------------- the build

def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


def test_build_compiles_once_per_source_hash(tmp_path, monkeypatch):
    log = tmp_path / "calls"
    # writes its -o argument and records the call
    nvcc = _fake_nvcc(tmp_path / "nvcc", f"""
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "$@" >> {log}
echo built > "$out"
""")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    paths = _build.build_all()
    names = {"flash_attention", "flash_attention_bwd",
             "flash_attention_bwd_sm90", "flash_attention_fwd_sm90",
             "int8_matmul", "mlstm_scan", "ssm_scan"}
    assert set(paths) == names
    assert all(p.read_text() == "built\n" for p in paths.values())
    calls = sorted(log.read_text().splitlines(), key=lambda c: c.split()[-1])
    assert len(calls) == len(names)               # one nvcc per source
    for call, name in zip(calls, sorted(names)):
        assert "arch=compute_90a,code=sm_90a" in call
        assert call.endswith(f"csrc/{name}.cu")
    assert _build.build_all() == paths            # unchanged tree: no rebuild
    assert len(log.read_text().splitlines()) == len(names)
    assert not list((tmp_path / "build").glob("*.tmp.so"))
    # the headers the kernels share are part of every library's hash: an
    # edit to one rebuilds every source, and only once
    include = tmp_path / "include"
    include.mkdir()
    for header in _build.INCLUDE_DIR.glob("*.cuh"):
        (include / header.name).write_bytes(header.read_bytes())
    monkeypatch.setattr(_build, "INCLUDE_DIR", include)
    assert _build.build_all() == paths            # the same bytes: no rebuild
    assert len(log.read_text().splitlines()) == len(names)
    shared = next(include.glob("*.cuh"))
    shared.write_text(shared.read_text() + "// edited\n")
    rebuilt = _build.build_all()
    assert set(rebuilt) == names
    assert all(rebuilt[n] != paths[n] for n in names)
    calls = log.read_text().splitlines()
    assert len(calls) == 2 * len(names)
    assert all(f"-I {include}" in call for call in calls[len(names):])
    assert _build.build_all() == rebuilt
    assert len(log.read_text().splitlines()) == 2 * len(names)


PTXAS_OUT = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z2k2v' for 'sm_90a'
ptxas info    : Function properties for _Z2k2v
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 400 bytes cmem[0]
"""


def test_build_keeps_the_ptxas_report(tmp_path, monkeypatch):
    """nvcc's `-Xptxas -v` report is kept beside each library and read
    back per kernel: registers, static shared memory, spills."""
    nvcc = _fake_nvcc(tmp_path / "nvcc", f"""
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo built > "$out"
cat >&2 <<'PTXAS'
{PTXAS_OUT}PTXAS
""")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    assert "-v" in _build.NVCC_FLAGS and "-Xptxas" in _build.NVCC_FLAGS
    assert _build.ptxas_report("flash_attention") == []   # not built yet
    _build.build_all()
    want = [{"kernel": "_Z6kernelv", "registers": 128, "smem_bytes": 16384,
             "spill_stores": 8, "spill_loads": 4, "wgmma_serialized": []},
            {"kernel": "_Z2k2v", "registers": 40, "smem_bytes": 0,
             "spill_stores": 0, "spill_loads": 0, "wgmma_serialized": []}]
    for name in _build.sources():
        assert _build.ptxas_report(name) == want


# ptxas's notes on wgmma as the H100's toolkit prints them (names cut)
PTXAS_WGMMA = """ptxas info    : Compiling entry function '_Z4widev' for 'sm_90a'
ptxas info    : (C7519) warpgroup.arrive is injected in around line 21439 by compiler to allow use of registers in GMMA in function '_Z4widev'
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in the function '_Z4widev'
ptxas info    : Function properties for _Z4widev
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 400 bytes cmem[0]
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions defining accumulator registers of a wgmma between start and end of the pipeline stage in the function '_Z4loopv'
ptxas info    : Compiling entry function '_Z4loopv' for 'sm_90a'
ptxas info    : Function properties for _Z4loopv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4finev' for 'sm_90a'
ptxas info    : Function properties for _Z4finev
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, 400 bytes cmem[0]
"""


def test_ptxas_serialization_notes_stay_with_their_kernel():
    """A note that ptxas serialized a function's wgmma (C7520, C7515) is
    kept with that kernel, whether it comes before or after the kernel's
    own lines; C7519 (an injected arrive) is not a serialization."""
    got = {k["kernel"]: k for k in _build.parse_ptxas(PTXAS_WGMMA)}
    assert got["_Z4widev"]["wgmma_serialized"] == ["C7520"]
    assert got["_Z4loopv"]["wgmma_serialized"] == ["C7515"]
    assert got["_Z4finev"]["wgmma_serialized"] == []
    assert got["_Z4widev"]["registers"] == 168
    assert got["_Z4finev"]["spill_stores"] == 0


def _chip_smoke():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("serialized", [True, False])
def test_build_report_raises_on_serialized_wgmma(monkeypatch, serialized):
    """chip_smoke.py's phase 1 prints every kernel's ptxas figures and
    raises where ptxas serialized a kernel's wgmma."""
    cs = _chip_smoke()
    text = PTXAS_WGMMA if serialized else PTXAS_OUT
    monkeypatch.setattr(_build, "build_all",
                        lambda: {"flash_attention_bwd_sm90": None})
    monkeypatch.setattr(_build, "ptxas_report",
                        lambda name: _build.parse_ptxas(text))
    monkeypatch.setattr(cs, "_demangle", lambda names: names)
    monkeypatch.setattr(cs, "log", lambda line: None)
    if serialized:
        with pytest.raises(AssertionError,
                           match="(?s)serialized wgmma.*_Z4widev.*C7520.*"
                                 "_Z4loopv.*C7515"):
            cs.build_report()
    else:
        cs.build_report()


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path / "nvcc", "echo 'error: bad kernel' >&2\nexit 2\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="(?s)exit 2.*error: bad kernel"):
        _build.build_all()


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_source_and_flags(monkeypatch):
    src = _build.sources()["flash_attention"]
    name = _build.library_path(src)
    assert name.parent == _build.BUILD_DIR
    assert name.name.startswith("libflash_attention-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path(src) != name
