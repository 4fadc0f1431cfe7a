"""The port's chunkwise mLSTM (`repro_torch.kernels.mlstm_scan`) on the CPU:
its plain versions against the JAX kernel in interpret mode and the JAX
oracle, the state in and out against chained JAX `_mlstm_chunk` calls, and
the custom backward against autograd. The CUDA kernel itself runs only on
the card (`chip_smoke.py`)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_scan import mlstm_ref as jax_mlstm_ref  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan as jax_mlstm_scan  # noqa: E402
from repro.models.xlstm import _mlstm_chunk as jax_mlstm_chunk  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops  # noqa: E402
from repro_torch.kernels.mlstm_scan import (mlstm_ref, mlstm_scan,  # noqa: E402
                                            mlstm_scan_ref,
                                            mlstm_scan_two_pass_ref)

# The tolerances of tests/test_kernels.py's mlstm test: fp32 2e-4 (the
# chunkwise and sequential forms sum in other orders through exp-weighted
# state); bf16 5e-2 (inputs and y rounded to bf16).
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# One algorithm, one order of sums apart (chunk sizes, torch vs XLA).
TIGHT = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, h, s, hd, dtype="float32"):
    """numpy q, k, v (B,H,S,hd) rounded once to `dtype`, and fp32 gates
    shaped as tests/test_kernels.py makes them."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, h, s, hd), dtype=np.float32)
           for _ in range(3)]
    li = rng.standard_normal((b, h, s), dtype=np.float32) * 0.5
    lf = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((b, h, s), dtype=np.float32) + 2.0))
    jx = [jnp.asarray(a).astype(dtype) for a in qkv] + [jnp.asarray(li),
                                                        jnp.asarray(lf)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in qkv] + [
        torch.from_numpy(li), torch.from_numpy(np.array(lf))]
    return jx, tt


def _state(seed, b, h, hd):
    """A non-zero state: C (B,H,hd_k,hd_v), n (B,H,hd), m (B,H)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, hd, hd), dtype=np.float32) * 0.3,
            rng.standard_normal((b, h, hd), dtype=np.float32) * 0.3,
            rng.standard_normal((b, h), dtype=np.float32))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TIGHT))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hd,bc", [(64, 32, 16), (128, 64, 32),
                                     (128, 64, 128)])
def test_plain_versions_match_jax(dtype, s, hd, bc):
    """tests/test_kernels.py's shapes: the wrapper on CPU tensors (the
    chunkwise plain version) against the JAX kernel in interpret mode, and
    both oracles against each other."""
    jx, tt = _inputs(3, 2, 2, s, hd, dtype)
    y, state = mlstm_scan(*tt, bc=bc)
    assert y.shape == tt[0].shape and y.dtype == tt[0].dtype
    assert [tuple(x.shape) for x in state] == [(2, 2, hd, hd), (2, 2, hd),
                                               (2, 2)]
    _close(y, jax_mlstm_scan(*jx, bc=bc, backend="interpret"), **TOL[dtype])
    _close(y, jax_mlstm_ref(*jx), **TOL[dtype])
    _close(mlstm_ref(*tt), jax_mlstm_ref(*jx), **TOL[dtype])


@pytest.mark.parametrize("s,bcs", [(128, (32, 128, 48)), (40, (8, 32, 256))])
def test_chunk_invariance(s, bcs):
    """The chunk does not change the math, ragged last chunks included
    (128 = 2 x 48 + 32, 40 = 32 + 8): outputs and the state out."""
    _, tt = _inputs(4, 1, 2, s, 32)
    (y0, st0), *rest = [mlstm_scan_ref(*tt, bc=bc) for bc in bcs]
    for y, st in rest:
        torch.testing.assert_close(y, y0, **TIGHT)
        for a, b in zip(st, st0):
            torch.testing.assert_close(a, b, **TIGHT)
    torch.testing.assert_close(y0, mlstm_ref(*tt), **TOL["float32"])


def _jax_chained(jx, state, chunk):
    """JAX `_mlstm_chunk` over (B,S,H,..) chunks, the model's layout."""
    q, k, v, li, lf = (jnp.swapaxes(a, 1, 2) for a in jx)
    st = tuple(jnp.asarray(x) for x in state)
    scale = 1.0 / math.sqrt(q.shape[-1])
    step = jax.jit(jax_mlstm_chunk, static_argnums=6)
    ys = []
    for t0 in range(0, q.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        y, st = step(q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl], st,
                     scale)
        ys.append(y)
    return jnp.swapaxes(jnp.concatenate(ys, axis=1), 1, 2), st


@pytest.mark.parametrize("s,jax_chunk,bc", [(24, 8, 8), (24, 8, 256),
                                            (1, 1, 256), (20, 4, 32)])
def test_state_in_and_out_match_chained_jax_chunks(s, jax_chunk, bc):
    """A non-zero state in, the state out in the model's cache layout
    (C [k, v]), against chained JAX `_mlstm_chunk` calls; S=1 is decode."""
    jx, tt = _inputs(5, 2, 2, s, 32)
    st_np = _state(6, 2, 2, 32)
    want_y, want_st = _jax_chained(jx, st_np, jax_chunk)
    y, st = mlstm_scan(*tt, tuple(torch.from_numpy(x) for x in st_np), bc=bc)
    _close(y, want_y)
    for a, b in zip(st, want_st):
        _close(a, b)


def test_chained_calls_equal_one_call():
    """The state out of one call fed to the next gives the one-call result,
    as chip_smoke.py checks the kernel on the card."""
    _, tt = _inputs(7, 1, 2, 64, 32)
    y, st = mlstm_scan_ref(*tt)
    y1, st1 = mlstm_scan_ref(*(x[:, :, :40] for x in tt))
    y2, st2 = mlstm_scan_ref(*(x[:, :, 40:] for x in tt), st1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y, **TIGHT)
    for a, b in zip(st2, st):
        torch.testing.assert_close(a, b, **TIGHT)


def test_zero_state_is_none():
    _, tt = _inputs(8, 1, 2, 16, 32)
    zeros = (torch.zeros(1, 2, 32, 32), torch.zeros(1, 2, 32),
             torch.zeros(1, 2))
    y0, st0 = mlstm_scan(*tt)
    y1, st1 = mlstm_scan(*tt, zeros)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    for a, b in zip(st1, st0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _plain_forward(q, k, v, log_i, log_f, state, bc):
    return mlstm_scan_ref(q, k, v, log_i, log_f, state, bc=bc)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("fwd_bc,bwd_bc", [(8, 8), (256, 16)])
def test_custom_backward_matches_autograd(with_state, fwd_bc, bwd_bc):
    """`_MLSTMScan` (forward by the given function, backward by recompute)
    against autograd straight through the plain version: every input's
    gradient, with cotangents on y and on the state out. On the card the
    forward is the kernel; here it is the plain version."""
    _, tt = _inputs(9, 2, 2, 20, 32)
    st = tuple(torch.from_numpy(x) for x in _state(10, 2, 2, 32)) \
        if with_state else ()
    rng = np.random.default_rng(11)
    cot = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
           for shape in ((2, 2, 20, 32), (2, 2, 32, 32), (2, 2, 32), (2, 2))]

    def grads(run):
        leaves = [x.clone().requires_grad_(True) for x in (*tt, *st)]
        y, (c, n, m) = run(leaves)
        loss = sum((o * w).sum() for o, w in zip((y, c, n, m), cot))
        return torch.autograd.grad(loss, leaves)

    def custom(leaves):
        y, c, n, m = ops._MLSTMScan.apply(
            _plain_forward, bwd_bc, *leaves[:5],
            *(leaves[5:] or (None, None, None)))
        return y, (c, n, m)

    def straight(leaves):
        return mlstm_scan_ref(*leaves[:5], tuple(leaves[5:]) or None,
                              bc=fwd_bc)

    for a, b in zip(grads(custom), grads(straight)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_custom_backward_with_y_only():
    """Training uses y alone: the state outs get no cotangent."""
    _, tt = _inputs(12, 1, 2, 12, 32)
    leaves = [x.clone().requires_grad_(True) for x in tt]
    y, *_ = ops._MLSTMScan.apply(_plain_forward, 256, *leaves, None, None,
                                 None)
    got = torch.autograd.grad(y.square().sum(), leaves)
    ref = [x.clone().requires_grad_(True) for x in tt]
    want = torch.autograd.grad(mlstm_scan_ref(*ref)[0].square().sum(), ref)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,hd,bc", [(64, 32, 16), (128, 64, 32),
                                     (128, 64, 128), (192, 32, 64)])
def test_two_pass_plain_version_matches_jax(s, hd, bc):
    """The bf16 kernel's two-pass form, with its bf16 roundings, on bf16
    inputs at tests/test_kernels.py's shapes (and three whole chunks of
    64): against the JAX kernel in interpret mode and the JAX oracle, at
    the bf16 tolerance, and against the chunkwise plain version."""
    jx, tt = _inputs(14, 2, 2, s, hd, "bfloat16")
    y, state = mlstm_scan_two_pass_ref(*tt)
    assert y.shape == tt[0].shape and y.dtype == torch.bfloat16
    assert [tuple(x.shape) for x in state] == [(2, 2, hd, hd), (2, 2, hd),
                                               (2, 2)]
    _close(y, jax_mlstm_scan(*jx, bc=bc, backend="interpret"),
           **TOL["bfloat16"])
    _close(y, jax_mlstm_ref(*jx), **TOL["bfloat16"])
    torch.testing.assert_close(y.float(), mlstm_scan_ref(*tt)[0].float(),
                               **TOL["bfloat16"])


@pytest.mark.parametrize("b,s,hd,with_state", [
    (2, 40, 64, False),     # one ragged chunk
    (1, 77, 32, True),      # 64 + 13 rows, a state in
    (2, 1, 32, True),       # decode
    (1, 200, 384, False),   # xlstm-125m's head dim, 3 chunks + 8 rows
    (2, 130, 32, True),     # 2 chunks + 2 rows, a state in
])
def test_two_pass_state_meets_the_fp32_gate(b, s, hd, with_state):
    """The precision argument of the bf16 kernel, held where the card is not
    needed: on bf16 inputs its C, n and m (w_upd k split into three bf16
    parts before the tensor-core products) meet fp32's 1e-4 against the
    chunkwise fp32 plain version, as chip_smoke.py holds the kernel; y meets
    the bf16 5e-2. Ragged S and S = 1 included; the sequential JAX oracle
    checks y where no state is given."""
    jx, tt = _inputs(15, b, 2, s, hd, "bfloat16")
    st = (tuple(torch.from_numpy(x) for x in _state(16, b, 2, hd))
          if with_state else None)
    y, state = mlstm_scan_two_pass_ref(*tt, st)
    want_y, want_state = mlstm_scan_ref(*tt, st)
    torch.testing.assert_close(y.float(), want_y.float(), **TOL["bfloat16"])
    for got, want in zip(state, want_state):
        torch.testing.assert_close(got, want, **TIGHT)
    if not with_state:
        _close(y, jax_mlstm_ref(*jx), **TOL["bfloat16"])


def test_two_pass_chained_calls_equal_one_call():
    """The state out of one two-pass call fed to the next (72 + 56 rows: a
    ragged chunk in each) gives one call's result over all 128 rows."""
    _, tt = _inputs(17, 1, 2, 128, 64, "bfloat16")
    y, st = mlstm_scan_two_pass_ref(*tt)
    y1, st1 = mlstm_scan_two_pass_ref(*(x[:, :, :72] for x in tt))
    y2, st2 = mlstm_scan_two_pass_ref(*(x[:, :, 72:] for x in tt), st1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2).float(), y.float(),
                               **TOL["bfloat16"])
    for a, b in zip(st2, st):
        torch.testing.assert_close(a, b, **TIGHT)


def test_cpu_tensors_do_not_launch():
    before = mlstm_scan.launches
    _, tt = _inputs(13, 1, 2, 8, 32)
    mlstm_scan(*tt)
    assert mlstm_scan.launches == before == 0


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: here the
    build is made to fail, and the plain version must not answer."""
    def no_build(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_build)
    ops._entry.cache_clear()
    q = torch.empty(1, 2, 8, 32, device="meta")
    g = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="cannot build mlstm_scan"):
        mlstm_scan(q, q, q, g, g)
    ops._entry.cache_clear()
    assert mlstm_scan.launches == 0


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,err", [
    ((_t(1, 2, 8, 48), _t(1, 2, 8), None), "head_dim 48"),
    ((_t(1, 2, 8, 32), _t(1, 2, 9), None), "log_i must be"),
    ((_t(1, 2, 8, 32), _t(1, 2, 8, dtype=torch.bfloat16), None),
     "log_i must be"),
    ((_t(1, 2, 0, 32), _t(1, 2, 0), None), "empty"),
    ((_t(1, 2, 8, 32), _t(1, 2, 8), (_t(1, 2, 32, 32), _t(1, 2, 32),
                                     _t(1, 3))), "state m"),
    ((_t(1, 2, 8, 32), _t(1, 2, 8), (_t(1, 2, 32, 32, dtype=torch.bfloat16),
                                     _t(1, 2, 32), _t(1, 2))), "state C"),
    ((_t(1, 2, 8, 32, 1), _t(1, 2, 8), None), "want q"),
])
def test_wrapper_checks(args, err):
    q, g, state = args
    with pytest.raises(ValueError, match=err):
        ops._check(q, q, q, g, g, state)


def test_paths_name_each_dtype():
    assert set(ops.PATHS) == {torch.float32, torch.bfloat16}
    assert "mma.sync" in ops.PATHS[torch.bfloat16]


def test_wrapper_checks_bf16_row_alignment():
    """The bf16 kernels copy 16 bytes from each row start by cp.async: a row
    stride that is not a multiple of 8 elements is refused."""
    g = _t(1, 2, 8)
    q = _t(1, 8, 2 * 32 + 4, dtype=torch.bfloat16)[..., :64].unflatten(
        -1, (2, 32)).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check(q, q, q, g, g, None)
    ops._check(q.float(), q.float(), q.float(), g, g, None)   # fp32: any


def test_wrapper_checks_dtype_and_strides():
    g = _t(1, 2, 8)
    q = _t(1, 2, 8, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops._check(q, q, q, g, g, None)
    q = _t(1, 2, 32, 8).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head_dim"):
        ops._check(q, q, q, g, g, None)
    # the model's layout: transposed (B,S,H,hd) and (B,S,H) views
    q = _t(1, 8, 2, 384).transpose(1, 2)
    g = _t(1, 8, 2).transpose(1, 2)
    ops._check(q, q, q, g, g, (_t(1, 2, 384, 384), _t(1, 2, 384), _t(1, 2)))
