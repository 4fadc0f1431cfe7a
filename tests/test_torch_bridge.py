"""The port's weight bridge: JAX params pytree <-> torch, and the port's own
random init."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.bridge import (init_params, params_from_numpy,  # noqa: E402
                                params_to, params_to_numpy)
from repro_torch.configs.registry import get_smoke_config as torch_smoke_config  # noqa: E402


def _jax_params(dtype):
    cfg = get_smoke_config("stablelm-1.6b").scaled(param_dtype=dtype)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_keeps_nesting_values_and_dtype(dtype):
    cfg, tree = _jax_params(dtype)
    tp = params_from_numpy(tree, "cpu")
    assert isinstance(tp["groups"], tuple) and len(tp["groups"]) == 1
    assert tp["groups"][0]["mixer"]["w_q"].shape == (
        cfg.num_groups, cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert tp["lm_head"].dtype == getattr(torch, dtype)
    back = params_to_numpy(tp)
    src, out = list(_leaves(tree)), list(_leaves(back))
    assert [p for p, _ in src] == [p for p, _ in out]
    for (path, a), (_, b) in zip(src, out):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=str(path))


def test_bf16_leaf_carries_its_bits():
    import ml_dtypes
    arr = np.array([[1.0, -2.5, 3.140625], [1e-3, 65280.0, -0.0]],
                   dtype=ml_dtypes.bfloat16)
    t = params_from_numpy({"w": [arr]}, "cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
    back = params_to_numpy([t])[0]
    assert back.dtype.name == "bfloat16"
    np.testing.assert_array_equal(back.view(np.uint16), arr.view(np.uint16))


def test_from_numpy_copies_read_only_arrays():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    arr.flags.writeable = False
    t = params_from_numpy((arr,), "cpu")[0]
    t += 1                      # the port's tensor is its own
    assert arr[0, 0] == 0 and t[0, 0] == 1


def test_params_to_moves_every_leaf():
    _, tree = _jax_params("float32")
    tp = params_from_numpy(tree, "cpu")
    moved = params_to(tp, "meta")
    assert all(x.device.type == "meta" for _, x in _leaves(moved))
    assert params_to(tp, "cpu")["lm_head"] is tp["lm_head"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_structure(dtype):
    cfg, tree = _jax_params(dtype)
    tp = init_params(torch_smoke_config("stablelm-1.6b").scaled(
        param_dtype=dtype), torch.Generator().manual_seed(0))
    ref = [(p, a.shape, a.dtype.name) for p, a in _leaves(tree)]
    got = [(p, tuple(t.shape), str(t.dtype)[6:]) for p, t in _leaves(tp)]
    assert got == ref


def test_init_params_distributions_and_seed():
    cfg = torch_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32", d_model=256, d_ff=512)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    g = p["groups"][0]
    for w, d_in in ((g["mixer"]["w_q"], cfg.d_model),
                    (g["ffn"]["w_down"], cfg.d_ff),
                    (p["lm_head"], cfg.d_model)):
        assert abs(w.std().item() * math.sqrt(d_in) - 1.0) < 0.05
        assert abs(w.mean().item()) < 0.05 / math.sqrt(d_in)
    assert abs(p["embed"]["table"].std().item() - 0.02) < 0.001
    assert torch.equal(g["pre_norm"]["scale"], torch.ones_like(g["pre_norm"]["scale"]))
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    again = init_params(cfg, torch.Generator().manual_seed(0))
    other = init_params(cfg, torch.Generator().manual_seed(1))
    assert torch.equal(again["lm_head"], p["lm_head"])
    assert not torch.equal(other["lm_head"], p["lm_head"])


def test_init_params_refuses_a_generator_elsewhere():
    cfg = torch_smoke_config("stablelm-1.6b")
    with pytest.raises(ValueError, match="generator on cpu"):
        init_params(cfg, torch.Generator().manual_seed(0), device="meta")
