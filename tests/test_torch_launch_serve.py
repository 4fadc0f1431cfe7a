"""The port's serve launcher (`repro_torch.launch.serve`) on the CPU
against the JAX package's `ServingEngine`, and the cells of the launchers:
`shapes_for`, `all_cells` and `Model.input_specs` against the reference's.

`repro.launch.serve` builds its engine and requests as `serve` here does;
the JAX side builds the same engine on the same params and requests."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

REQUESTS, PROMPT, MAX_NEW = 4, 32, 8
MODAL = {"seamless-m4t-medium": "frames", "internvl2-2b": "image_embeds"}


def _jax_side(arch):
    """(the JAX engine's tokens a request, or the KeyError it raised; the
    params as numpy)."""
    cfg = jreg.get_smoke_config(arch).scaled(param_dtype="float32")
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    eng = JaxServingEngine(model, params, max_seq=PROMPT + MAX_NEW + 4)
    reqs = [JaxRequest(i, np.random.default_rng(i).integers(
        1, cfg.vocab_size - 1, size=(PROMPT,)).astype(np.int32), MAX_NEW)
        for i in range(REQUESTS)]
    host = jax.tree.map(np.asarray, params)
    try:
        return [r.tokens for r in eng.serve(reqs)], host
    except KeyError as e:
        return e, host


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_greedy_tokens_equal_the_jax_engine(arch, capsys):
    want, host = _jax_side(arch)
    args = launch_serve.parse_args(
        ["--arch", arch, "--smoke", "--requests", str(REQUESTS),
         "--prompt-len", str(PROMPT), "--max-new", str(MAX_NEW),
         "--device", "cpu"])
    params = params_from_numpy(host, "cpu")
    if arch in MODAL:
        # the engine takes tokens only, on both packages
        assert isinstance(want, KeyError) and want.args == (MODAL[arch],)
        with pytest.raises(KeyError, match=MODAL[arch]):
            launch_serve.serve(args, params=params)
        return
    got = launch_serve.serve(args, params=params)
    assert [r.request_id for r in got] == list(range(REQUESTS))
    assert [r.tokens for r in got] == want
    out = capsys.readouterr().out.splitlines()[-1]
    assert out.startswith(f"{REQUESTS} requests, {REQUESTS * MAX_NEW} tokens")


def test_main_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "stablelm-1.6b", "--smoke"])
    assert launch_serve.main(["--arch", "stablelm-1.6b", "--smoke",
                              "--requests", "2", "--device", "cpu"]) == 0


def test_shapes_and_cells_equal_the_reference():
    assert [dataclasses.asdict(s) for s in base.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.ALL_SHAPES]
    for arch in registry.ARCH_IDS:
        assert [dataclasses.asdict(s) for s in
                base.shapes_for(registry.get_config(arch))] == \
            [dataclasses.asdict(s) for s in
             jbase.shapes_for(jreg.get_config(arch))]
    cells = [(a, dataclasses.asdict(s)) for a, s in registry.all_cells()]
    assert len(cells) == 34
    assert cells == [(a, dataclasses.asdict(s)) for a, s in jreg.all_cells()]


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    """Over every cell of the arch: the same names, shapes and dtypes,
    as `meta` tensors (no memory)."""
    mine = build_model(registry.get_config(arch))
    ref = jax_build_model(jreg.get_config(arch))
    for (a, shape), (_, jshape) in zip(
            (c for c in registry.all_cells() if c[0] == arch),
            (c for c in jreg.all_cells() if c[0] == arch)):
        got, want = mine.input_specs(shape), ref.input_specs(jshape)
        assert list(got) == list(want), (a, shape.name)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape, (a, shape.name, k)
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype), (a, shape.name, k)
