"""The config's `remat_policy` in the port (`Model._remat`) on the CPU: the
gradients under `"full"`, `"dots"` and `"nothing"` are equal to each other
and to the JAX package's (which applies the config's own policy), with the
weights carried over by `repro_torch.bridge`; what `"dots"` keeps; and a
kernel whose launch writes into a fresh `torch.empty` buffer behind
autograd's back (as a ctypes launch does) inside a recomputed group."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel processes on one host, where torch's default
# of a thread per core in each of them oversubscribes it
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import ATTN, MAMBA, MLA, SWA  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_ref  # noqa: E402
from repro_torch.models import attention, ssm  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

POLICIES = ("full", "dots", "nothing")
# every arch whose config sets a policy, and two that take the default
ARCHES = ("phi3-medium-14b", "mistral-large-123b", "gemma3-12b",
          "mixtral-8x22b", "deepseek-v2-236b", "jamba-1.5-large-398b",
          "xlstm-125m", "seamless-m4t-medium")
# Port against JAX, fp32: each gradient leaf to 1e-3 of its largest entry,
# the bound chip_smoke.py and tests/test_torch_moe.py hold grads to.
GRAD_RTOL = 1e-3
B, S = 2, 24


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size - 1, (B, S)).astype(
        np.int32)}
    if cfg.input_mode == "frames":
        out["frames"] = rng.standard_normal(
            (B, S, cfg.frame_dim or cfg.d_model)).astype(np.float32)
    return out


def _port_grads(cfg, host, batch, policy):
    model = build_model(cfg.scaled(remat_policy=policy))
    tb = {k: torch.from_numpy(v).long() if k == "tokens"
          else torch.from_numpy(v) for k, v in batch.items()}
    (loss, _), grads = value_and_grad(model, params_from_numpy(host, "cpu"),
                                      tb)
    return float(loss), tree_leaves(grads)


@pytest.mark.parametrize("arch", ARCHES)
def test_grads_equal_across_policies_and_jax(arch):
    jcfg = jreg.get_smoke_config(arch).scaled(param_dtype="float32")
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(params, batch)
    host = jax.tree.map(np.asarray, params)
    cfg = get_smoke_config(arch).scaled(param_dtype="float32")
    assert cfg.remat_policy == jcfg.remat_policy
    runs = {p: _port_grads(cfg, host, batch, p) for p in POLICIES}
    for p in ("dots", "nothing"):
        # the recompute runs the same ops on the same inputs: bit-equal
        assert runs[p][0] == runs["full"][0], p
        for a, b in zip(runs[p][1], runs["full"][1]):
            assert torch.equal(a, b), p
    loss, grads = runs[cfg.remat_policy]
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for a, b in zip(grads, jleaves):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= \
            GRAD_RTOL * max(float(np.abs(b).max()), 1e-30)


def _recorded_decisions(monkeypatch, cfg):
    """(op, shape of its first input, decision) for every op of the
    forward that reached the `"dots"` policy."""
    seen, policy = [], model_mod.save_dots

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        seen.append((op, tuple(getattr(args[0], "shape", ())), out))
        return out

    monkeypatch.setattr(model_mod, "save_dots", spy)
    _port_grads(cfg, _host(cfg), _batch(cfg), "dots")
    monkeypatch.undo()
    return seen


def _host(cfg):
    from repro_torch.bridge import init_params, params_to_numpy
    return params_to_numpy(init_params(cfg, torch.Generator().manual_seed(0)))


def test_dots_keeps_the_weight_gemms_not_attention(monkeypatch):
    """stablelm's smoke layer has 7 weight GEMMs (q, k, v, o, gate, up,
    down) and 2 batched attention products: "dots" keeps the 7 a layer and
    recomputes the rest. The LM head is outside the groups."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    cfg = get_smoke_config("stablelm-1.6b").scaled(param_dtype="float32")
    seen = _recorded_decisions(monkeypatch, cfg)
    saved = [(op, shape) for op, shape, d in seen
             if d == CheckpointPolicy.MUST_SAVE]
    assert len(saved) == 7 * cfg.num_layers
    assert all(op is aten.mm.default for op, _ in saved)
    batched = [(shape, d) for op, shape, d in seen if op is aten.bmm.default]
    assert len(batched) == 2 * cfg.num_layers
    assert all(shape[0] == B * cfg.num_heads
               and d == CheckpointPolicy.PREFER_RECOMPUTE
               for shape, d in batched)


def test_dots_decides_by_the_batch_size():
    """An einsum of weights reaches the policy as a bmm of batch 1 (kept);
    a bmm of a larger batch, an allocation and an elementwise op are
    recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    x, y = torch.zeros(1, 10, 8), torch.zeros(1, 8, 16)
    keep, again = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    assert model_mod.save_dots(None, aten.bmm.default, x, y) == keep
    assert model_mod.save_dots(None, aten.mm.default, x[0], y[0]) == keep
    assert model_mod.save_dots(None, aten.bmm.default, x.expand(4, 10, 8),
                               y.expand(4, 8, 16)) == again
    assert model_mod.save_dots(None, aten.empty.memory_format,
                               [2, 3]) == again
    assert model_mod.save_dots(None, aten.mul.Tensor, x, x) == again


def _out_of_band(launches):
    """Stand-ins for the ssm_scan and flash launches: each allocates its
    outputs with `torch.empty` and writes them through numpy, unseen by
    autograd and by the remat policy, as a ctypes kernel does, and counts
    itself; both go through the kernels' autograd Functions (flash's with
    its lse, and autograd through the plain version in place of the
    backward launch: the plain versions' own arithmetic)."""
    def ssm_launch(x, dt, b_t, c_t, a, d, h0):
        launches["ssm_scan"] += 1
        y = torch.empty(x.shape, dtype=x.dtype)
        h1 = torch.empty((x.shape[0], x.shape[2], a.shape[1]))
        with torch.no_grad():
            yr, hr = ssm_scan_ref(x, dt, b_t, c_t, a, d, h0)
        y.numpy()[...] = yr.numpy()
        h1.numpy()[...] = hr.numpy()
        return y, h1

    def flash_launch(q, k, v, *, causal, window, softcap):
        launches["flash_attention"] += 1
        out = torch.empty((q.shape[0], q.shape[2], q.shape[1], q.shape[3]),
                          dtype=q.dtype).transpose(1, 2)
        lse = torch.empty(q.shape[:3])
        with torch.no_grad():
            ref, ref_lse = attention_ref(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         return_lse=True)
        out.numpy()[...] = ref.numpy()
        lse.numpy()[...] = ref_lse.numpy()
        return out, lse

    def flash_bwd(q, k, v, out, lse, dout, *, causal, window, softcap):
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            ref = attention_ref(*xs, causal=causal, window=window,
                                softcap=softcap)
        return torch.autograd.grad(ref, xs, dout)

    def ssm_scan(x, dt, b_t, c_t, a, d, h0=None):
        return ssm_ops._SSMScan.apply(ssm_launch, x, dt, b_t, c_t, a, d, h0)

    def flash(q, k, v, *, causal=True, window=0, softcap=0.0):
        return flash_ops._FlashAttention.apply(flash_launch, flash_bwd,
                                               causal, window, softcap, q, k,
                                               v)
    return ssm_scan, flash


@pytest.mark.parametrize("policy", POLICIES)
def test_out_of_band_kernels_launch_again_in_the_recompute(monkeypatch,
                                                           policy):
    """jamba's smoke model with its Mamba and attention layers on the
    stand-ins: the same grads as the plain versions under autograd, and
    each kernel launched once a layer in the forward and, under remat,
    once more in the backward's recompute."""
    cfg = get_smoke_config("jamba-1.5-large-398b").scaled(
        param_dtype="float32")
    host, batch = _host(cfg), _batch(cfg)
    want = _port_grads(cfg, host, batch, "full")
    launches = {"ssm_scan": 0, "flash_attention": 0}
    ssm_scan, flash = _out_of_band(launches)
    monkeypatch.setattr(ssm, "ssm_scan", ssm_scan)
    monkeypatch.setattr(attention, "flash_attention", flash)
    got = _port_grads(cfg, host, batch, policy)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    runs = 1 if policy == "full" else 2
    layers = {"ssm_scan": cfg.pattern.count(MAMBA) * cfg.num_groups,
              "flash_attention": sum(k in (ATTN, SWA, MLA) for k in
                                     cfg.pattern) * cfg.num_groups}
    assert launches == {k: n * runs for k, n in layers.items()}
