"""The port's layers against the JAX layers on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def test_rmsnorm():
    rng = np.random.default_rng(0)
    xj, xt = _both(_rand(rng, 2, 16, 128) * 3)
    sj, st = _both(1 + 0.1 * _rand(rng, 128))
    _close(tl.rmsnorm({"scale": st}, xt, 1e-6),
           jl.rmsnorm({"scale": sj}, xj, 1e-6))


def test_rmsnorm_bf16_keeps_value_path_dtype():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 64)
    out_t = tl.rmsnorm({"scale": torch.ones(64, dtype=torch.bfloat16)},
                       torch.from_numpy(x).bfloat16())
    out_j = jl.rmsnorm({"scale": jnp.ones(64, jnp.bfloat16)},
                       jnp.asarray(x).astype(jnp.bfloat16))
    assert out_t.dtype == torch.bfloat16
    _close(out_t, out_j, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("fraction", [0.25, 1.0])
def test_apply_rope(fraction):
    rng = np.random.default_rng(2)
    xj, xt = _both(_rand(rng, 2, 24, 4, 32))
    pos = np.arange(24, dtype=np.int32) + 5
    _close(tl.apply_rope(xt, torch.from_numpy(pos), 10_000.0, fraction),
           jl.apply_rope(xj, jnp.asarray(pos), 10_000.0, fraction))


def test_apply_rope_partial_passes_the_rest_through():
    x = torch.randn(1, 3, 2, 32, generator=torch.Generator().manual_seed(0))
    out = tl.apply_rope(x, torch.arange(3), 10_000.0, 0.25)
    torch.testing.assert_close(out[..., 8:], x[..., 8:], rtol=0, atol=0)
    torch.testing.assert_close(out[0, 0], x[0, 0], rtol=0, atol=0)  # pos 0


def test_swiglu():
    rng = np.random.default_rng(3)
    xj, xt = _both(_rand(rng, 2, 16, 128))
    p = {"w_gate": _rand(rng, 128, 256) / 11, "w_up": _rand(rng, 128, 256) / 11,
         "w_down": _rand(rng, 256, 128) / 16}
    _close(tl.swiglu({k: torch.from_numpy(v) for k, v in p.items()}, xt),
           jl.swiglu({k: jnp.asarray(v) for k, v in p.items()}, xj))


def test_embed_and_unembed():
    rng = np.random.default_rng(4)
    table = _rand(rng, 512, 64)
    head = _rand(rng, 64, 512)
    tok = rng.integers(0, 512, size=(2, 7)).astype(np.int32)
    hj, ht = _both(_rand(rng, 2, 7, 64))
    _close(tl.embed_tokens({"table": torch.from_numpy(table)},
                           torch.from_numpy(tok).long()),
           jl.embed_tokens({"table": jnp.asarray(table)}, jnp.asarray(tok)))
    for tied in (False, True):
        _close(tl.unembed({"table": torch.from_numpy(table)}, ht, tied,
                          torch.from_numpy(head)),
               jl.unembed({"table": jnp.asarray(table)}, hj, tied,
                          jnp.asarray(head)), rtol=1e-4, atol=1e-4)
