"""All ten of the reference's architectures in the port, on the CPU at their
smoke configs: the port's counterpart of tests/test_models.py (a train
step, prefill and decode, prefill-then-decode against forward), each config
field-equal to the reference's, and the port's init against `jax.eval_shape`
of the reference's at full width."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel processes on one host, where torch's default
# of a thread per core in each of them oversubscribes it
torch.set_num_threads(1)
import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import build_model, padded_vocab  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# Parameters of the full configs and of the cuts chip_smoke.py serves, from
# `jax.eval_shape` of the reference's init.
PARAMS = {
    ("gemma3-12b", None): 11_765_395_200,
    ("phi3-medium-14b", None): 14_659_507_200,
    ("internvl2-2b", None): 1_893_828_608,
    ("seamless-m4t-medium", None): 979_433_472,
    ("deepseek-v2-236b", 5): 17_243_571_200,
    ("mistral-large-123b", 8): 11_878_477_824,
}


def _batch(cfg, b=2, s=64, seed=0):
    """tests/test_models.py's batch, drawn with numpy: tokens, and frames or
    image embeddings in the param dtype."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, cfg.param_dtype)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).long()}
    if cfg.input_mode == "frames":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32)).to(dt)
    elif cfg.input_mode == "tokens+image":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)).to(dt)
        batch["tokens"] = batch["tokens"][:, :s - cfg.num_image_tokens]
    return batch


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_configs_are_the_reference_ones(arch):
    """CONFIG and SMOKE field for field, sub-configs (MLA's
    `absorb_decode`, MoE, Mamba, xLSTM) included."""
    for get in ("get_config", "get_smoke_config"):
        got = dataclasses.asdict(getattr(registry, get)(arch))
        want = dataclasses.asdict(getattr(jreg, get)(arch))
        assert got == want, (arch, get)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_arch_smoke_train_step(arch):
    """loss, backward and one AdamW step of the smoke config: finite, and
    the backward reaches every leaf (each first moment has a nonzero
    entry)."""
    cfg = registry.get_smoke_config(arch).scaled(train_microbatch=0)
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw_init(params, cfg.opt_state_dtype)
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    params, opt, metrics = step(params, opt, _batch(cfg))
    assert math.isfinite(float(metrics["loss"])), arch
    assert int(opt["step"]) == 1
    assert all(torch.isfinite(p.float()).all() for p in tree_leaves(params))
    for i, m in enumerate(tree_leaves(opt["m"])):
        assert torch.isfinite(m.float()).all() and bool(m.abs().sum() > 0), \
            (arch, i, tuple(m.shape))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_arch_smoke_prefill_decode(arch):
    cfg = registry.get_smoke_config(arch)
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    s = batch["tokens"].shape[1] + (cfg.num_image_tokens
                                    if cfg.input_mode == "tokens+image" else 0)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, max_seq=s + 8)
        assert logits.shape == (2, 1, padded_vocab(cfg))
        tok = logits.argmax(-1)
        for i in range(3):
            logits, cache = model.decode_step(params, cache, tok, s + i)
            assert torch.isfinite(logits.float()).all(), arch
            tok = logits.argmax(-1)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-12b",
                                  "xlstm-125m", "jamba-1.5-large-398b",
                                  "deepseek-v2-236b"])
def test_prefill_decode_matches_forward(arch):
    """The reference's invariant for the arches its test lists: decoding
    token t with a prefilled cache reproduces the full forward logits at t
    (fp32)."""
    cfg = registry.get_smoke_config(arch).scaled(param_dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    b, s = 2, 32
    batch = _batch(cfg, b, s, seed=1)
    with torch.no_grad():
        full, _ = model.forward(params, batch)
        _, cache = model.prefill(params, {"tokens": batch["tokens"][:, :s - 4]},
                                 max_seq=s)
        for t in range(s - 4, s):
            logits, cache = model.decode_step(
                params, cache, batch["tokens"][:, t:t + 1], t)
            torch.testing.assert_close(logits[:, 0], full[:, t], rtol=2e-3,
                                       atol=2e-3)


def _same_tree(got, want, path):
    """Same keys and nesting, and each leaf's shape and dtype."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    else:
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_init_params_matches_reference_eval_shape(arch):
    """The port's init on fake tensors (no memory) against `jax.eval_shape`
    of the reference's, at the full config and at the smoke config: the
    same tree (`first` a list, `groups` a tuple), shapes and dtypes."""
    for get in ("get_config", "get_smoke_config"):
        want = jax.eval_shape(jax_build_model(getattr(jreg, get)(arch)).init,
                              jax.random.PRNGKey(0))
        with FakeTensorMode():
            got = init_params(getattr(registry, get)(arch),
                              torch.Generator().manual_seed(0))
            _same_tree(got, want, f"{arch} {get}")


@pytest.mark.parametrize("arch,layers", sorted(PARAMS))
def test_served_cuts_have_the_reference_param_count(arch, layers):
    """What chip_smoke.py serves: the whole config, or cut by depth only."""
    jcfg, tcfg = jreg.get_config(arch), registry.get_config(arch)
    if layers:
        jcfg, tcfg = (c.scaled(num_layers=layers) for c in (jcfg, tcfg))
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(want)) == \
        PARAMS[(arch, layers)]
    with FakeTensorMode():
        got = init_params(tcfg, torch.Generator().manual_seed(0))
        assert sum(x.numel() for x in tree_leaves(got)) == \
            PARAMS[(arch, layers)]
