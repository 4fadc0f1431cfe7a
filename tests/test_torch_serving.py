"""The port's serving slice on the CPU against the JAX serving engine, its
device rule, its copy of the load module, and its independence from JAX."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import load as jax_load  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.engine import length_aligned_waves as jax_waves  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as torch_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import load  # noqa: E402
from repro_torch.serving.engine import (Request, ServingEngine,  # noqa: E402
                                        length_aligned_waves)

ROOT = Path(__file__).resolve().parents[1]

# (prompt length, token budget): mixed lengths 8/16/32, mixed budgets
MIX = [(8, 5), (16, 3), (8, 7), (32, 4), (16, 6), (8, 2), (32, 1)]


@pytest.fixture(scope="module")
def engines():
    jcfg = get_smoke_config("stablelm-1.6b").scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(torch_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (JaxServingEngine(jm, jp, max_seq=48),
            ServingEngine(tm, tp, max_seq=48, device="cpu"))


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, size=n).astype(np.int32), b)
            for i, (n, b) in enumerate(MIX)]


@pytest.mark.parametrize("max_wave", [2, 8])
def test_greedy_tokens_equal_jax_engine(engines, max_wave):
    jax_engine, engine = engines
    prompts = _prompts(0)
    want = jax_engine.serve([JaxRequest(i, p, b) for i, p, b in prompts],
                            max_wave)
    got = engine.serve([Request(i, p, b) for i, p, b in prompts], max_wave)
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, g.request_id
        assert len(g.tokens) == dict((i, b) for i, _, b in prompts)[g.request_id]
        assert g.latency_s > 0


def test_generate_and_max_seq_stop_rule_match_jax(engines):
    jax_engine, engine = engines
    prompt = _prompts(1)[3][1]                          # 32 tokens
    # max_seq 48 stops decoding at position 47, before the budget of 30
    want = jax_engine.generate(prompt, 30)
    got = engine.generate(prompt, 30)
    assert got == want and len(got) == 48 - 32


def test_waves_match_reference():
    prompts = _prompts(2)
    mine = length_aligned_waves([Request(i, p, b) for i, p, b in prompts], 2)
    ref = jax_waves([JaxRequest(i, p, b) for i, p, b in prompts], 2)
    assert [[r.request_id for r in w] for w in mine] == \
        [[r.request_id for r in w] for w in ref]


def test_engine_defaults_to_the_card(monkeypatch):
    """Without a card the engine raises; it never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(torch_smoke_config("stablelm-1.6b"))
    with pytest.raises(RuntimeError, match="is_available"):
        ServingEngine(model, {}, max_seq=16)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda m: m.poisson_trace(20.0, 5.0, seed=3, max_new_tokens=6),
    lambda m: m.burst_trace(5.0, 15.0, 6.0, 2.0, 4.0, seed=4),
    lambda m: m.diurnal_trace(10.0, 0.5, 3.0, 6.0, seed=5),
])
def test_load_copy_gives_the_reference_traces(make):
    assert make(load) == make(jax_load)


def test_load_materialize_makes_port_requests():
    trace = load.poisson_trace(20.0, 2.0, seed=7)
    mine = load.materialize(trace, seed=7, vocab=256)
    ref = jax_load.materialize(trace, seed=7, vocab=256)
    assert all(isinstance(r, Request) for _, r in mine)
    assert set(load.LENGTH_BUCKETS) == {8, 16, 32, 64}
    for (ta, a), (tb, b) in zip(mine, ref):
        assert ta == tb and a.max_new_tokens == b.max_new_tokens
        np.testing.assert_array_equal(a.prompt, b.prompt)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    pkg = ROOT / "src" / "repro_torch"
    files = sorted(pkg.rglob("*.py"))
    assert {"models/moe.py", "checkpoint/checkpointer.py",
            "train/trainer.py", "configs/mixtral_8x22b.py",
            "configs/gemma3_12b.py", "configs/deepseek_v2_236b.py",
            "configs/seamless_m4t_medium.py", "configs/internvl2_2b.py",
            "configs/phi3_medium_14b.py",
            "configs/mistral_large_123b.py", "launch/train.py",
            "launch/serve.py", "launch/mesh.py",
            "parallel/compression.py"} <= {
        p.relative_to(pkg).as_posix() for p in files}
    files += [ROOT / "chip_smoke.py", ROOT / "chip_probes.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
