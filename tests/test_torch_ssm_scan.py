"""The port's Mamba selective scan (`repro_torch.kernels.ssm_scan`) on the
CPU: its plain version against the JAX oracle and the JAX kernel in
interpret mode, the state in and out, and the wrapper's routing and checks.
The CUDA kernel itself runs only on the card (`chip_smoke.py`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_ref as jax_ssm_scan_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssm_scan import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref  # noqa: E402

# tests/test_kernels.py's TOL for the ssm scan: fp32 2e-5 (one sequential
# recurrence, summed in other orders by torch and XLA); bf16 2e-2 (inputs
# and y rounded to bf16).
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# One recurrence split at another step: the same products in the same
# order, so only the fp32 state's round trip through the call boundary.
TIGHT = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(64, 128, 16), (128, 256, 16), (256, 128, 8)]   # (S, di, ds)


def _inputs(seed, b, s, di, ds, dtype="float32", param_dtype=None):
    """numpy inputs shaped as tests/test_kernels.py makes them: x, B, C
    scaled by 0.5, dt = softplus(0.3 n - 1), A = -exp(0.3 n), D = 0.1 n.
    x, B, C are rounded once to `dtype`, dt to `param_dtype` (default
    `dtype`). Returns (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di), dtype=np.float32)
                         * 0.3 - 1.0)).astype(np.float32)
    b_t = rng.standard_normal((b, s, ds), dtype=np.float32) * 0.5
    c_t = rng.standard_normal((b, s, ds), dtype=np.float32) * 0.5
    a = -np.exp(rng.standard_normal((di, ds), dtype=np.float32) * 0.3)
    d = rng.standard_normal((di,), dtype=np.float32) * 0.1
    pdt = param_dtype or dtype
    types = (dtype, pdt, dtype, dtype, "float32", "float32")
    arrs = (x, dt, b_t, c_t, a, d)
    jx = [jnp.asarray(v).astype(t) for v, t in zip(arrs, types)]
    tt = [torch.from_numpy(v).to(getattr(torch, t))
          for v, t in zip(arrs, types)]
    return jx, tt


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL["float32"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,di,ds", SHAPES)
def test_plain_version_matches_jax_oracle(dtype, s, di, ds):
    """tests/test_kernels.py's shapes and dtypes: the wrapper on CPU tensors
    (the plain version) against the JAX oracle."""
    jx, tt = _inputs(2, 2, s, di, ds, dtype)
    y, h = ssm_scan(*tt)
    assert y.shape == (2, s, di) and y.dtype == tt[0].dtype
    assert h.shape == (2, di, ds) and h.dtype == torch.float32
    _close(y, jax_ssm_scan_ref(*jx), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_interpret(dtype):
    """The smallest shape against the Pallas kernel in interpret mode, with
    tests/test_kernels.py's blocks (bd 128, bc 32: two chunks carried)."""
    jx, tt = _inputs(3, 2, 64, 128, 16, dtype)
    want = jax_ssm_scan(*jx, bd=128, bc=32, backend="interpret")
    _close(ssm_scan_ref(*tt)[0], want, **TOL[dtype])


def test_model_dtypes_match_jax_oracle():
    """The model's mix: bf16 x with fp32 dt, B, C (`ssm.py:_ssm_inputs`);
    y comes back in bf16."""
    jx, tt = _inputs(4, 2, 64, 128, 16, "bfloat16", param_dtype="float32")
    jx[2:4] = [a.astype(jnp.float32) for a in jx[2:4]]
    tt[2:4] = [t.float() for t in tt[2:4]]
    y, _ = ssm_scan(*tt)
    assert y.dtype == torch.bfloat16
    _close(y, jax_ssm_scan_ref(*jx), **TOL["bfloat16"])


@pytest.mark.parametrize("split", [1, 40, 63])
def test_chained_calls_equal_one_call(split):
    """The state out of one call fed to the next gives the one-call y and
    state, as chip_smoke.py checks the kernel on the card; split 63 leaves
    one step, which is decode."""
    jx, tt = _inputs(5, 2, 64, 128, 8)
    y, h = ssm_scan(*tt)
    head = [t[:, :split] for t in tt[:4]] + tt[4:]
    tail = [t[:, split:] for t in tt[:4]] + tt[4:]
    y1, h1 = ssm_scan(*head)
    y2, h2 = ssm_scan(*tail, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, **TIGHT)
    torch.testing.assert_close(h2, h, **TIGHT)
    _close(torch.cat([y1, y2], dim=1), jax_ssm_scan_ref(*jx))


def test_state_out_is_the_recurrence():
    """h_last against the recurrence written out in numpy (float64)."""
    _, tt = _inputs(6, 1, 12, 16, 8)
    x, dt, b_t, c_t, a, d = (t.double().numpy() for t in tt)
    h0 = np.random.default_rng(7).standard_normal((1, 16, 8)) * 0.3
    h = h0.copy()
    for t in range(12):
        h = (np.exp(dt[:, t, :, None] * a) * h
             + dt[:, t, :, None] * b_t[:, t, None, :] * x[:, t, :, None])
    _, got = ssm_scan(*tt, h0=torch.from_numpy(h0).float())
    np.testing.assert_allclose(got.numpy(), h, rtol=1e-5, atol=1e-6)


def test_zero_state_is_none():
    _, tt = _inputs(8, 1, 16, 128, 16)
    y0, h0 = ssm_scan(*tt)
    y1, h1 = ssm_scan(*tt, h0=torch.zeros(1, 128, 16))
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    torch.testing.assert_close(h1, h0, rtol=0, atol=0)


def test_cpu_tensors_do_not_launch():
    before = ssm_scan.launches
    _, tt = _inputs(9, 1, 4, 128, 16)
    ssm_scan(*tt)
    assert ssm_scan.launches == before == 0


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _meta_args(grad=False):
    return (_meta(1, 8, 128, grad=grad), _meta(1, 8, 128), _meta(1, 8, 16),
            _meta(1, 8, 16), _meta(128, 16), _meta(128))


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: here the
    build is made to fail, and the plain version must not answer."""
    def no_build(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_build)
    ops._entry.cache_clear()
    with pytest.raises(RuntimeError, match="cannot build ssm_scan"):
        ssm_scan(*_meta_args())
    ops._entry.cache_clear()
    assert ssm_scan.launches == 0


def test_gradient_on_the_card_raises(monkeypatch):
    """A call off the CPU that needs a gradient goes to the kernel too, and
    raises when the kernel cannot launch: the plain version never answers
    for it."""
    def no_build(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_build)
    ops._entry.cache_clear()
    with pytest.raises(RuntimeError, match="cannot build ssm_scan"):
        ssm_scan(*_meta_args(grad=True))
    ops._entry.cache_clear()
    assert ssm_scan.launches == 0


def _plain_forward(x, dt, b_t, c_t, a, d, h0):
    return ssm_scan_ref(x, dt, b_t, c_t, a, d, h0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_custom_backward_matches_autograd(dtype, with_state):
    """`_SSMScan` (forward by the given function, backward by recompute)
    against autograd straight through the plain version: dx, ddt, dB, dC,
    dA, dD and dh0, with cotangents on y and on the state out. x in
    `dtype`, dt, B, C in fp32 (jamba's types when x is bf16). On the card
    the forward is the kernel; here it is the plain version."""
    _, tt = _inputs(21, 2, 24, 32, 16, dtype, param_dtype="float32")
    rng = np.random.default_rng(22)
    h0 = [torch.from_numpy(rng.standard_normal((2, 32, 16),
                                               dtype=np.float32))] \
        if with_state else []
    cot = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
           for shape in ((2, 24, 32), (2, 32, 16))]

    def grads(run):
        leaves = [x.clone().requires_grad_(True) for x in (*tt, *h0)]
        y, h1 = run(leaves)
        loss = (y.float() * cot[0]).sum() + (h1 * cot[1]).sum()
        return torch.autograd.grad(loss, leaves)

    def custom(leaves):
        return ops._SSMScan.apply(_plain_forward, *leaves[:6],
                                  leaves[6] if with_state else None)

    def straight(leaves):
        return ssm_scan_ref(*leaves)

    got, want = grads(custom), grads(straight)
    assert len(got) == 6 + len(h0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_custom_backward_with_y_only_and_some_inputs():
    """Training gives h_last no cotangent; inputs that need no gradient
    (A and D frozen) get none."""
    _, tt = _inputs(23, 1, 16, 32, 8)
    needs = (True, True, True, True, False, False)
    leaves = [x.clone().requires_grad_(n) for x, n in zip(tt, needs)]
    y, _ = ops._SSMScan.apply(_plain_forward, *leaves, None)
    got = torch.autograd.grad(y.square().sum(), leaves[:4])
    ref = [x.clone().requires_grad_(n) for x, n in zip(tt, needs)]
    want = torch.autograd.grad(ssm_scan_ref(*ref)[0].square().sum(), ref[:4])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_card_tensors_that_need_grad_go_through_the_function(monkeypatch):
    """On a non-CPU tensor that needs a gradient the wrapper launches inside
    `_SSMScan` (backward reaches every input); without grad, or under
    no_grad, it launches bare. Meta tensors and a stub launch stand in for
    the card."""
    calls = []

    def launch(x, dt, b_t, c_t, a, d, h0):
        calls.append(h0 is None)
        return (torch.empty_like(x),
                torch.empty(x.shape[0], x.shape[2], a.shape[1],
                            device=x.device))

    monkeypatch.setattr(ops, "_launch", launch)
    y, _ = ssm_scan(*_meta_args())
    assert y.grad_fn is None
    args = [t.requires_grad_() for t in _meta_args()]
    with torch.no_grad():
        assert ssm_scan(*args)[0].grad_fn is None
    y, h1 = ssm_scan(*args)
    assert type(y.grad_fn).__name__ == "_SSMScanBackward"
    assert calls == [True, True, True]


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _ok():
    return [_t(2, 8, 128), _t(2, 8, 128), _t(2, 8, 16), _t(2, 8, 16),
            _t(128, 16), _t(128)]


@pytest.mark.parametrize("index,bad,err", [
    (0, _t(2, 8, 128, 1), "want x = dt"),
    (1, _t(2, 9, 128), "want x = dt"),
    (2, _t(2, 8, 8), "B must be"),
    (3, _t(1, 8, 16), "C must be"),
    (4, _t(64, 16), "A must be"),
    (4, _t(128, 16, 1), "A must be"),
    (5, _t(64), "D must be"),
    (6, _t(2, 128, 8), "h0 must be"),
    (6, _t(2, 128, 16, dtype=torch.bfloat16), "h0 must be"),
])
def test_wrapper_checks_shapes(index, bad, err):
    args = _ok() + [None]
    args[index] = bad
    with pytest.raises(ValueError, match=err):
        ops._check(*args)


@pytest.mark.parametrize("index,dtype,err", [
    (0, torch.float16, "float32 or bfloat16 x"),
    (1, torch.float16, "dt, B, C of one dtype"),
    (2, torch.bfloat16, "dt, B, C of one dtype"),
    (4, torch.bfloat16, "A must be float32"),
    (5, torch.float64, "D must be float32"),
])
def test_wrapper_checks_dtypes(index, dtype, err):
    args = _ok() + [None]
    args[index] = args[index].to(dtype)
    with pytest.raises(TypeError, match=err):
        ops._check(*args)


def test_wrapper_checks_state_dim_length_strides_and_devices():
    x = _t(2, 8, 128)
    with pytest.raises(ValueError, match="d_state 4"):
        ops._check(x, x, _t(2, 8, 4), _t(2, 8, 4), _t(128, 4), _t(128), None)
    e = _t(2, 0, 128)
    with pytest.raises(ValueError, match="empty"):
        ops._check(e, e, _t(2, 0, 16), _t(2, 0, 16), _t(128, 16), _t(128),
                   None)
    xt = _t(2, 128, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="x needs a contiguous last axis"):
        ops._check(xt, x, *_ok()[2:], None)
    with pytest.raises(ValueError, match="different devices"):
        ops._check(*_ok()[:5], _meta(128), None)
    # the model's layout: B and C as column views of x_proj's output
    x_db = _t(2, 8, 512 + 32)
    ops._check(x, x, x_db[..., 512:528], x_db[..., 528:], _t(128, 16),
               _t(128), _t(2, 128, 16))


@pytest.mark.parametrize("index", [4, 6])
def test_wrapper_checks_vector_alignment(index):
    """The kernel reads A and h0 as 16-byte vectors: a contiguous view whose
    start is not 16-byte aligned is refused, an aligned one passes."""
    args = _ok() + [_t(2, 128, 16)]
    flat = _t(args[index].numel() + 4)
    args[index] = flat[1:1 + args[index].numel()].view(args[index].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check(*args)
    args[index] = flat[4:].view(args[index].shape)
    ops._check(*args)
