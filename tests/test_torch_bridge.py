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


def _jax_params(dtype, arch="stablelm-1.6b"):
    cfg = get_smoke_config(arch).scaled(param_dtype=dtype)
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


def _same_structure(dtype, arch):
    cfg, tree = _jax_params(dtype, arch)
    tp = init_params(torch_smoke_config(arch).scaled(
        param_dtype=dtype), torch.Generator().manual_seed(0))
    ref = [(p, a.shape, a.dtype.name) for p, a in _leaves(tree)]
    got = [(p, tuple(t.shape), str(t.dtype)[6:]) for p, t in _leaves(tp)]
    assert got == ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_structure(dtype):
    _same_structure(dtype, "stablelm-1.6b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_structure_xlstm(dtype):
    """The same keys, shapes and dtypes as the JAX tree: the gate weights
    `w_if`, `w_in`, `r_rec` and biases stay fp32 whatever `param_dtype`
    is, and tied embeddings have no `lm_head`."""
    _same_structure(dtype, "xlstm-125m")


def test_init_params_xlstm_distributions():
    """The xLSTM leaves' distributions, as `repro.models.xlstm` draws them:
    gate biases [0]*h ++ [3]*h (mLSTM) and [0]*d ++ [3]*d ++ [0]*2d
    (sLSTM), conv normal / sqrt(kernel), recurrence normal / sqrt(hd)."""
    cfg = torch_smoke_config("xlstm-125m").scaled(
        param_dtype="float32", num_layers=8, d_model=256)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    assert "lm_head" not in p
    sl, ml = p["groups"][0]["mixer"], p["groups"][1]["mixer"]
    h, d, kk = cfg.num_heads, cfg.d_model, cfg.xlstm.conv1d_kernel
    assert torch.equal(ml["b_if"], torch.tensor([0.0] * h + [3.0] * h)
                       .expand(cfg.num_groups, 2 * h))
    assert torch.equal(sl["b"], torch.tensor([0.0] * d + [3.0] * d + [0.0] * 2 * d)
                       .expand(cfg.num_groups, 4 * d))
    hd_s = d // cfg.xlstm.num_heads_slstm
    for w, std in ((ml["conv_w"], 1 / math.sqrt(kk)),
                   (sl["conv_w"], 1 / math.sqrt(kk)),
                   (sl["r_rec"], 1 / math.sqrt(hd_s)),
                   (ml["w_q"], 1 / math.sqrt(2 * d))):
        assert abs(w.std().item() / std - 1.0) < 0.05


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
