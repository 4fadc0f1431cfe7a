"""The host side of flash attention's wgmma + TMA forward on the CPU: which
design each dtype and head_dim takes, what `_launch` hands each design's C
entry point (stub entry points and `meta` tensors stand in for the card),
and that the dry run's `meta` path records the same cost whatever the
design. The kernel itself is held against the plain version on the card by
chip_smoke.py (phase 2, `check_flash_attention`)."""
import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import trace  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, ops  # noqa: E402


def _bshd(b, s, h, hd, dtype=torch.bfloat16, pad=0):
    """A (B,H,S,hd) `meta` view of a (B,S,H*hd+pad) tensor, as the model
    hands the kernel its activations."""
    x = torch.empty(b, s, h * hd + pad, dtype=dtype, device="meta")
    return x[..., :h * hd].unflatten(-1, (h, hd)).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_fwd_path_by_dtype_and_head_dim(dtype, hd):
    """bf16 at head_dim 64, 128, 192 and 256 takes the wgmma + TMA forward;
    fp32, and bf16 at 32, the designs of `csrc/flash_attention.cu`."""
    want = (ops.SM90_PATH if dtype == torch.bfloat16 and hd in
            (64, 128, 192, 256) else ops.PATHS[dtype])
    assert ops.fwd_path(dtype, hd) == want


@pytest.fixture
def entries(monkeypatch):
    """Stub entry points of both forward designs recording each call's
    arguments, returning `rc["code"]`; no card needed."""
    calls, rc = [], {"code": 0}

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return rc["code"]
        return fn
    monkeypatch.setattr(ops, "_fwd_sm90_entry",
                        lambda: (entry("sm90"), lambda: 7))
    monkeypatch.setattr(ops, "_entry",
                        lambda: (entry("mma"), lambda e: b"stub"))
    monkeypatch.setattr(ops, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_design))
    yield calls, rc
    flash_attention.launches = before[0]
    flash_attention.launches_by_design.update(before[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
@pytest.mark.parametrize("s,t", [(200, 200), (1, 37), (100, 160)])
def test_launch_calls_the_designs_entry(entries, dtype, hd, s, t):
    """`_launch` calls the entry point of the design `fwd_path` names, once:
    the wgmma forward with the TMA geometries of q, k, v and of the
    (B,S,H,hd) output's (B,H,S,hd) view, the other with the element
    strides; it counts one launch, under its design too."""
    calls, _ = entries
    q = _bshd(2, s, 4, hd, dtype)
    k, v = _bshd(2, t, 2, hd, dtype), _bshd(2, t, 2, hd, dtype)
    path = ops.fwd_path(dtype, hd)
    before = (flash_attention.launches,
              flash_attention.launches_by_design[path])
    out = ops._launch(q, k, v, causal=True, window=0, softcap=2.0)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    (name, args), = calls
    if path == ops.SM90_PATH:
        assert name == "sm90" and len(args) == 16   # stream last
        assert args[5:11] == (2, 4, 2, s, t, hd)
        assert list(args[11]) == [*ops._tma_geometry(q), *ops._tma_geometry(k),
                                  *ops._tma_geometry(v),
                                  *ops._tma_geometry(out)]
        assert args[12:15] == (1, 0, 2.0)
    else:
        assert name == "mma" and len(args) == 28   # stream last
        assert args[0] == ops._DTYPES[dtype] and args[6:12] == (
            2, 4, 2, s, t, hd)
        assert args[12:24] == (*q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3], *out.stride()[:3])
        assert args[24:28] == (1, 0, 2.0, 0)
    assert flash_attention.launches == before[0] + 1
    assert flash_attention.launches_by_design[path] == before[1] + 1


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 256),
                                      (torch.bfloat16, 32),
                                      (torch.float32, 128)])
def test_lse_only_with_lse(entries, dtype, hd):
    """The lse (B,H,S) fp32 is allocated and its pointer handed over only
    `with_lse`; without it the entry point gets None."""
    calls, _ = entries
    q, k = _bshd(1, 80, 4, hd, dtype), _bshd(1, 80, 2, hd, dtype)
    lse_arg = 4 if ops.fwd_path(dtype, hd) == ops.SM90_PATH else 5
    out = ops._launch(q, k, k, causal=True, window=0)
    assert isinstance(out, torch.Tensor)
    assert calls[-1][1][lse_arg] is None
    out, lse = ops._launch(q, k, k, causal=True, window=0, with_lse=True)
    assert lse.shape == (1, 4, 80) and lse.dtype == torch.float32
    assert lse.is_contiguous()
    assert calls[-1][1][lse_arg] == lse.data_ptr()


def test_launch_failure_raises_with_the_cu_result(entries):
    """On the card there is no fallback: a failed call raises with the
    cudaError and the last tensor-map encoding's CUresult, and counts no
    launch."""
    calls, rc = entries
    rc["code"] = 1
    q = _bshd(1, 64, 4, 128)
    before = flash_attention.launches
    with pytest.raises(RuntimeError,
                       match=r"launch failed: stub \(cudaError 1, "
                             r"tensor-map CUresult 7\)"):
        ops._launch(q, q, q, causal=True, window=0)
    assert flash_attention.launches == before
    assert [name for name, _ in calls] == ["sm90"]


def test_broadcast_views_are_copied_for_tma(entries, monkeypatch):
    """KV heads expanded to the query heads (a stride-0 axis, as phase 10's
    ranks hand them) are copied by `_tma_ready` before their descriptors
    are made; aligned views, padded rows included, are not."""
    calls, _ = entries
    seen = []
    real = ops._tma_ready

    def recording(x):
        y = real(x)
        seen.append(y is x)
        return y
    monkeypatch.setattr(ops, "_tma_ready", recording)
    q = _bshd(1, 64, 4, 64, pad=64)
    kv = torch.empty(1, 64, 1, 64, dtype=torch.bfloat16,
                     device="meta").transpose(1, 2).expand(1, 4, 64, 64)
    ops._launch(q, kv, kv, causal=True, window=0)
    assert seen == [True, False, False]
    tma = list(calls[-1][1][11])
    assert tma[:7] == list(ops._tma_geometry(q))
    assert tma[7:14] == tma[14:21] == [64, 64, 4, 1, 2 * 64, 2 * 64 * 64,
                                      2 * 4 * 64 * 64]
    seen.clear()
    k = _bshd(1, 64, 2, 64)
    ops._launch(q, k, k, causal=True, window=0)
    assert seen == [True, True, True]


def test_build_names_the_forward_source():
    srcs = _build.sources()
    assert srcs["flash_attention_fwd_sm90"].parts[-2:] == (
        "csrc", "flash_attention_fwd_sm90.cu")
    assert srcs["flash_attention"].parts[-2:] == ("csrc", "flash_attention.cu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 48, 0.0),
                                                   (False, 0, 30.0)])
def test_meta_path_records_the_same_cost(dtype, hd, causal, window, softcap):
    """Under the dry run's trace the forward records one call of
    `ops.cost` whatever design `fwd_path` names, and launches nothing."""
    q = _bshd(2, 96, 8, hd, dtype)
    k = _bshd(2, 96, 2, hd, dtype)
    mask = {"causal": causal, "window": window, "softcap": softcap}
    before = flash_attention.launches
    res, _ = trace.analyze_trace(lambda: flash_attention(q, k, k, **mask))
    want = ops.cost(q, k, k, **mask)
    got = res.kernels["flash_attention"]
    assert (got.calls, got.flops, got.bytes, got.exps) == (
        1, want.flops, want.bytes, want.exps)
    assert flash_attention.launches == before
