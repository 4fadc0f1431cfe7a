"""The port's int8 gradient compression (`repro_torch.parallel.compression`)
on the CPU: bit for bit against the JAX package on the same numpy inputs,
the reference's convergence test of the compressing train step, and its two
quantization properties (with hypothesis, as tests/test_properties.py
has them)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.parallel import compression as jax_comp  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel.compression import (  # noqa: E402
    compress_grads, dequantize_int8, init_error_feedback,
    make_compressing_train_step, quantize_int8)
from repro_torch.tree import tree_leaves  # noqa: E402

SET = dict(max_examples=25, deadline=None)


def _draw(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((64, 33), 3e-4),
                                         ((7,), 2e3), ((4, 4, 4), 1.0)])
def test_quantize_and_dequantize_equal_jax_bit_for_bit(shape, scale):
    x = _draw(1, shape, scale)
    x.reshape(-1)[0] = 0.0
    qj, sj = jax_comp.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert s.numpy().tobytes() == np.asarray(sj).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jax_comp.dequantize_int8(qj, sj)))


def test_rounding_is_half_to_even_and_zero_is_safe():
    """Ties go to the even integer, as jnp.round's do; an all-zero leaf
    takes the 1e-12 floor of the scale."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    assert float(s) == np.float32(127.0) / np.float32(127.0)
    assert q.tolist() == [127, 0, 2, 2, 0, -2]
    assert q.tolist() == np.asarray(jax_comp.quantize_int8(
        jnp.asarray(x))[0]).tolist()
    q, s = quantize_int8(torch.zeros(5))
    assert q.tolist() == [0] * 5 and float(s) == np.float32(1e-12) / 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_equals_jax_bit_for_bit(dtype):
    """Three rounds with the error feedback carried: grads in their dtype,
    residuals in fp32, on a nested tree."""
    shapes = {"a": (128, 16), "b": [(33,), (2, 5, 7)]}
    jg = {"a": jnp.asarray(_draw(2, shapes["a"])).astype(dtype),
          "b": [jnp.asarray(_draw(3 + i, s, 10.0 ** -i)).astype(dtype)
                for i, s in enumerate(shapes["b"])]}
    tg = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)), jg)
    je, te = jax_comp.init_error_feedback(jg), init_error_feedback(tg)
    for _ in range(3):
        jc, je = jax_comp.compress_grads(jg, je)
        tc, te = compress_grads(tg, te)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            assert a.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))
        for a, b in zip(tree_leaves(te), jax.tree.leaves(je)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compressing_train_step_converges():
    """tests/test_infra.py's test on the port: stablelm's smoke config in
    fp32, every leaf compressed, 20 steps on one batch, lr 2e-3."""
    cfg = get_smoke_config("stablelm-1.6b").scaled(param_dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    efb = init_error_feedback(params)
    step = make_compressing_train_step(model, AdamWConfig(lr=2e-3),
                                       threshold_elems=0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64),
                                     generator=torch.Generator().manual_seed(1))}
    losses = []
    for _ in range(20):
        params, opt, efb, m = step(params, opt, efb, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(efb))


def test_small_leaves_stay_exact():
    """Under `threshold_elems` a leaf's grad passes unquantized and its
    residual stays zero: with every leaf under it the step is
    `make_train_step`'s."""
    from repro_torch.train.train_step import make_train_step
    cfg = get_smoke_config("stablelm-1.6b").scaled(param_dtype="float32")
    model = build_model(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(2))}
    runs = []
    for compressing in (True, False):
        params = init_params(cfg, torch.Generator().manual_seed(0))
        opt = adamw_init(params)
        if compressing:
            efb = init_error_feedback(params)
            step = make_compressing_train_step(model, AdamWConfig(),
                                               threshold_elems=1 << 30)
            params, opt, efb, m = step(params, opt, efb, batch)
            assert all(not e.any() for e in tree_leaves(efb))
        else:
            params, opt, m = make_train_step(model, AdamWConfig())(
                params, opt, batch)
        runs.append((float(m["loss"]), tree_leaves(params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@given(seed=st.integers(0, 2**16), scale=st.floats(1e-3, 1e3))
@settings(**SET)
def test_int8_roundtrip_error_bound(seed, scale):
    x = torch.randn(64, generator=torch.Generator().manual_seed(seed)) * scale
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


@given(seed=st.integers(0, 2**16))
@settings(**SET)
def test_error_feedback_preserves_sum(seed):
    """Over many steps, compressed grads + error feedback telescope: the
    accumulated applied update approaches the accumulated true gradient."""
    g = {"w": torch.randn(32, generator=torch.Generator().manual_seed(seed))}
    efb = init_error_feedback(g)
    applied = torch.zeros(32)
    for _ in range(20):
        cg, efb = compress_grads(g, efb)
        applied = applied + cg["w"]
    np.testing.assert_allclose((applied + efb["w"]).numpy(),
                               (20 * g["w"]).numpy(), rtol=1e-3, atol=1e-3)
