"""The port's weight-only int8 GEMM (`repro_torch.kernels.int8_matmul`) on
the CPU: quantization and the plain version against the JAX oracle and the
JAX kernel in interpret mode, and the wrapper's routing and checks. The
CUDA kernel itself runs only on the card (`chip_smoke.py`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul  # noqa: E402
from repro.kernels.int8_matmul import int8_matmul_ref as jax_int8_matmul_ref  # noqa: E402
from repro.kernels.int8_matmul import quantize_weights as jax_quantize  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_ref,  # noqa: E402
                                             ops, quantize_weights)

# tests/test_kernels.py's TOL: fp32 2e-5 (one fp32 product summed in other
# orders by torch and XLA); bf16 2e-2 (x and the output rounded to bf16).
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# tests/test_kernels.py's shapes and blocks: (m, k, n, bm, bn, bk).
SHAPES = [(64, 256, 128, 64, 64, 128), (128, 128, 256, 128, 128, 64)]


def _inputs(seed, m, k, n, dtype):
    """x (m,k) in `dtype` and w (k,n) fp32 from a numpy seed, as JAX arrays
    and, through the bridge (bf16 as its bits), as tensors."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((m, k), dtype=np.float32)).astype(dtype)
    w = jnp.asarray(rng.standard_normal((k, n), dtype=np.float32))
    t = params_from_numpy({"x": np.asarray(x), "w": np.asarray(w)}, "cpu")
    return (x, w), (t["x"], t["w"])


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


@pytest.mark.parametrize("k,n", [(256, 128), (128, 256), (2048, 64)])
def test_quantize_weights_matches_jax(k, n):
    """wq equal to JAX's, bit for bit; scales within 1 ulp."""
    (_, w), (_, tw) = _inputs(k + n, 1, k, n, jnp.float32)
    wq, sc = quantize_weights(tw)
    jwq, jsc = jax_quantize(w)
    assert wq.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_max_ulp(sc.numpy(), np.asarray(jsc), maxulp=1)


def test_quantize_rounds_half_to_even():
    """jnp.round's rule: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2 (scale 1 when the
    largest entry is 127)."""
    w = torch.tensor([[0.5, 1.5, -2.5, 127.0]]).T.expand(4, 2).contiguous()
    wq, sc = quantize_weights(w)
    assert sc.tolist() == [1.0, 1.0]
    assert wq[:, 0].tolist() == [0, 2, -2, 127]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", SHAPES)
def test_plain_version_matches_jax(dtype, m, k, n, bm, bn, bk):
    """tests/test_kernels.py's shapes, blocks and TOL: the port's plain
    version and its wrapper on CPU tensors against the JAX oracle and the
    Pallas kernel in interpret mode, on the same weights quantized by each
    side."""
    (x, w), (tx, tw) = _inputs(m + k + n, m, k, n, getattr(jnp, dtype))
    jwq, jsc = jax_quantize(w)
    wq, sc = quantize_weights(tw)
    want_ref = jax_int8_matmul_ref(x, jwq, jsc)
    want_kernel = jax_int8_matmul(x, jwq, jsc, backend="interpret", bm=bm,
                                  bn=bn, bk=bk)
    for got in (int8_matmul_ref(tx, wq, sc), int8_matmul(tx, wq, sc)):
        assert got.shape == (m, n) and got.dtype == tx.dtype
        _close(got, want_ref, **TOL[dtype])
        _close(got, want_kernel, **TOL[dtype])


@pytest.mark.parametrize("m,k,n", [(1, 7, 3), (5, 33, 65), (4, 2048, 96)])
def test_plain_version_takes_any_shape(m, k, n):
    """The Pallas wrapper needs its blocks to divide M, N and K; the port's
    kernel masks any edge, and its plain version is the float64 product of
    the same operands within fp32 rounding."""
    rng = np.random.default_rng(m * k * n)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    wq, sc = quantize_weights(torch.from_numpy(
        rng.standard_normal((k, n), dtype=np.float32)))
    want = (x.double() @ wq.double()) * sc.double()
    torch.testing.assert_close(int8_matmul(x, wq, sc).double(), want,
                               rtol=1e-5, atol=1e-4)


def test_strided_rows_match_contiguous():
    """x may be a row slice of a wider activation (stride(1) == 1)."""
    rng = np.random.default_rng(11)
    wide = torch.from_numpy(rng.standard_normal((8, 96), dtype=np.float32))
    wq, sc = quantize_weights(torch.from_numpy(
        rng.standard_normal((64, 40), dtype=np.float32)))
    x = wide[:, 16:80]
    assert x.stride() == (96, 1)
    torch.testing.assert_close(int8_matmul(x, wq, sc),
                               int8_matmul(x.contiguous(), wq, sc),
                               rtol=0, atol=0)


def test_cpu_tensors_do_not_launch():
    before = int8_matmul.launches
    wq, sc = quantize_weights(torch.ones(16, 8))
    int8_matmul(torch.ones(2, 16), wq, sc)
    assert int8_matmul.launches == before == 0


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: here the
    build is made to fail, and the plain version must not answer."""
    def no_build(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_build)
    ops._entry.cache_clear()
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="cannot build int8_matmul"):
        int8_matmul(torch.empty(4, 16, **meta),
                    torch.empty(16, 8, dtype=torch.int8, **meta),
                    torch.empty(8, **meta))
    ops._entry.cache_clear()
    assert int8_matmul.launches == 0


def _ok():
    return (torch.zeros(4, 16), torch.zeros(16, 8, dtype=torch.int8),
            torch.zeros(8))


@pytest.mark.parametrize("index,bad,exc,err", [
    (1, torch.zeros(16, 8), TypeError, "wq must be int8"),
    (1, torch.zeros(16, 8, dtype=torch.uint8), TypeError, "wq must be int8"),
    (0, torch.zeros(4, 16, dtype=torch.float16), TypeError,
     "float32 or bfloat16 x"),
    (2, torch.zeros(8, dtype=torch.int32), TypeError, "floating point"),
    (0, torch.zeros(4, 15), ValueError, "want x"),
    (0, torch.zeros(2, 4, 16), ValueError, "want x"),
    (1, torch.zeros(16, 8, 1, dtype=torch.int8), ValueError, "want x"),
    (2, torch.zeros(7), ValueError, "scales must be"),
    (2, torch.zeros(1, 8), ValueError, "scales must be"),
    (0, torch.zeros(0, 16), ValueError, "empty operand"),
    (2, torch.zeros(8, device="meta"), ValueError, "different devices"),
])
def test_wrapper_checks(index, bad, exc, err):
    args = list(_ok())
    args[index] = bad
    with pytest.raises(exc, match=err):
        int8_matmul(*args)
    assert int8_matmul.launches == 0


# ------------------------------------------- the kernel's paths (`_plan`)

PLAN_N, PLAN_K = 5632, 2048   # stablelm-1.6b's MLP up-projection


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 4096])
def test_plan_paths_and_splits(m, dtype):
    """M <= 16: the split-K GEMV in both types, its splits covering K once
    with no empty split, 2 blocks or more an SM, and a (splits, M, N)
    workspace; above, bf16 on the tensor cores and fp32 on the fp32 tiles."""
    plan = ops._plan(m, PLAN_N, PLAN_K, dtype)
    if m <= 16:
        assert plan.path == ops.GEMV == "split-K GEMV"
        assert plan.mt >= m and plan.mt * plan.cpt <= 64
        bounds = [(s * plan.kps, min(PLAN_K, (s + 1) * plan.kps))
                  for s in range(plan.splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == PLAN_K
        assert all(hi > lo for lo, hi in bounds)              # none empty
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert plan.kps % ops.GEMV_WARPS == 0
        assert plan.workspace == (plan.splits, m, PLAN_N)
        assert plan.grid == (-(-PLAN_N // (32 * plan.cpt)), plan.splits)
        assert plan.grid[0] * plan.grid[1] >= 2 * ops.SMS
    else:
        assert plan.path == (ops.MMA if dtype == torch.bfloat16
                             else ops.TILES)
        assert plan.workspace is None


@pytest.mark.parametrize("k", [8, 200, 2004, 4096])
def test_plan_splits_cover_any_k(k):
    for m in (1, 8, 16):
        plan = ops._plan(m, 333, k, torch.float32)
        assert (plan.splits - 1) * plan.kps < k <= plan.splits * plan.kps
        assert plan.kps * plan.mt <= ops.GEMV_SLICE_FLOATS


def _gemv_emulation(x, wq, scales, plan):
    """The GEMV's order of fp32 sums: in each split, warp w adds rows w,
    w + 8, ... one after another; the 8 warps fold as ((0+4) + (2+6)) +
    ((1+5) + (3+7)); the splits are summed in order from 0.0, then scaled."""
    m, k = x.shape
    total = torch.zeros(m, wq.shape[1])
    for s in range(plan.splits):
        lo, hi = s * plan.kps, min(k, (s + 1) * plan.kps)
        warps = []
        for w in range(ops.GEMV_WARPS):
            acc = torch.zeros(m, wq.shape[1])
            for r in range(lo + w, hi, ops.GEMV_WARPS):
                acc = acc + x[:, r:r + 1].float() * wq[r].float()
            warps.append(acc)
        half = ops.GEMV_WARPS // 2
        while half:
            warps = [warps[i] + warps[i + half] for i in range(half)]
            half //= 2
        total = total + warps[0]
    return (total * scales.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 96), (1, 203, 40),
                                   (16, 777, 33)])
def test_gemv_order_matches_plain_version(dtype, m, k, n):
    """Summing int8_matmul_ref's products over `_plan`'s K splits in the
    kernel's order gives int8_matmul_ref's result to fp32 rounding, ragged
    K included."""
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(
        getattr(torch, dtype))
    wq, sc = quantize_weights(torch.from_numpy(
        rng.standard_normal((k, n), dtype=np.float32)))
    plan = ops._plan(m, n, k, x.dtype)
    assert plan.path == ops.GEMV and plan.splits > 1
    got = _gemv_emulation(x, wq, sc, plan)
    want = int8_matmul_ref(x, wq, sc)
    assert got.dtype == want.dtype and got.shape == want.shape
    # fp32: sums of the same K products in two orders, TOL's 2e-5 grown
    # with K past tests/test_kernels.py's 256 as chip_smoke.py's int8_tol
    # does; bf16: the fp32 sums rounded once more, TOL's 2e-2
    tol = 2e-5 * max(1.0, k / 256) if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
