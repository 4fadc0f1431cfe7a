#!/usr/bin/env python3
"""Single phases of chip_smoke.py on one NVIDIA card, for a first check of
a kernel or a measurement that does not need the whole run.

    python3 chip_probes.py backward
        Builds the kernels (printing ptxas's report), then runs phase 2's
        flash checks, forward (`check_flash_attention`), backward
        (`check_flash_backward`) and at head_dim 256 and 192
        (`check_flash_new_head_dims`), and phase 3's softcap parity
        (`check_softcap_card_vs_cpu`).

    python3 chip_probes.py mlstm
        Builds the kernels, then runs phase 2's mlstm_scan checks
        (`check_mlstm_scan`) and its seed sweep (`sweep_mlstm_seeds`: every
        bf16 case on 16 more seeds, gated against the fp32 and the two-pass
        plain versions).

    python3 chip_probes.py ab-train ROOT [ROOT ...]
        For each checkout ROOT in turn, in a process of its own, phase 5c's
        training steps (`_launch_train_one`: 1 warm-up and 3 timed steps of
        `launch.train`) of stablelm-1.6b whole at 2x2048, seamless-m4t-medium
        whole at 2x1024, mixtral-8x22b cut to 1 layer at 2x2048, gemma3-12b
        cut to 6 layers at 1x2048 and deepseek-v2-236b cut to 2 layers at
        1x2048, each through that checkout's own package and chip_smoke.py.
        Give the
        parent commit unpacked into an ignored directory and `.` in the
        order parent, change, change, parent, so that both are measured on
        the same card in one call. Prints one `AB <root> {...}` line a
        checkout: each config's median and all step ms and its peak
        `max_memory_allocated`.

    python3 chip_probes.py ab-backward PARENT
        The flash backward of the parent checkout PARENT (its
        csrc/flash_attention_bwd.cu and csrc/flash_attention_bwd_sm90.cu,
        built here with this tree's nvcc flags, loaded beside this tree's
        kernels and chosen by the parent's BWD_SM90_HEAD_DIMS) against
        this tree's, in one
        process on one card, at mixtral's 2x48(8)x2048x128 window 4096 and
        each of chip_smoke.py's BWD_TRAIN_SHAPES: in turn parent, change,
        change, parent, each ms a call (CUDA events) and on the card alone
        (`queued_ms`), and once each kernel's device ms; the bound
        (`ops.bwd_cost`); SDPA's backward alone; the largest |change -
        parent| of dq, dk and dv. Prints one `ABBWD {...}` line a shape.

    python3 chip_probes.py ab-forward PARENT
        The flash forward of the parent checkout PARENT (its
        csrc/flash_attention.cu, built here with this tree's nvcc flags and
        loaded beside this tree's kernels) against this tree's (`ops._launch`,
        the design `ops.fwd_path` names), in one process on one card, bf16,
        causal, at each of FWD_AB_SHAPES: in turn parent, change, change,
        parent, each ms a call (CUDA events, the host's descriptor encoding
        included) and on the card alone (`queued_ms`); the bound
        (`ops.cost`) and its share; SDPA on the card alone (causal, GQA; a
        window as a boolean mask over k, v expanded to the query heads); the
        largest |change - parent| of out and lse. Prints one `ABFWD {...}`
        line a shape.

Exits 1 without a card, as chip_smoke.py does.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (arch, depth cut or None, global batch, seq_len) of the A/B steps
AB_CONFIGS = (("stablelm-1.6b", None, 2, 2048),
              ("seamless-m4t-medium", None, 2, 1024),
              ("mixtral-8x22b", 1, 2, 2048),
              ("gemma3-12b", 6, 1, 2048),
              ("deepseek-v2-236b", 2, 1, 2048))


def _card(cs) -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    cs.torch.backends.cuda.matmul.allow_tf32 = False
    cs.torch.backends.cudnn.allow_tf32 = False


def backward() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    _card(cs)
    cs.build_report()
    cs.timed("flash forward", cs.check_flash_attention,
             torch.Generator(device="cuda").manual_seed(cs.SEED))
    bwd = cs.timed("flash backward", cs.check_flash_backward,
                   torch.Generator(device="cuda").manual_seed(cs.SEED + 19))
    bwd.pop("cases")
    print(json.dumps(bwd), flush=True)
    cs.timed("parity softcap", cs.check_softcap_card_vs_cpu)
    cs.timed("flash hd 256 and 192", cs.check_flash_new_head_dims,
             torch.Generator(device="cuda").manual_seed(cs.SEED + 11))


def mlstm() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    _card(cs)
    cs.build_report()
    entry = cs.timed("mlstm_scan", cs.check_mlstm_scan,
                     torch.Generator(device="cuda").manual_seed(cs.SEED + 3))
    sweep = cs.timed("mlstm_scan sweep", cs.sweep_mlstm_seeds)
    print(json.dumps({"mlstm_scan": entry, "sweep": sweep}), flush=True)


def _parent_bwd_sm90_head_dims(parent: Path) -> tuple:
    """BWD_SM90_HEAD_DIMS of the parent's `ops.py` (read, not imported: the
    two trees' packages share a name)."""
    import ast
    src = (parent / "src" / "repro_torch" / "kernels" / "flash_attention" /
           "ops.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "BWD_SM90_HEAD_DIMS":
            return ast.literal_eval(node.value)
    return ()


def _parent_backward(parent: str):
    """The parent's backward, each of its two designs built from its own
    source and headers with this tree's flags into build/ab_parent/ and
    chosen as the parent's `ops.bwd_path` chooses (bf16 at the parent's
    BWD_SM90_HEAD_DIMS: `flash_attention_bwd_sm90.cu`, else
    `flash_attention_bwd.cu`), as a function of (q, k, v, out, lse, dout,
    **mask) -> (dq, dk, dv)."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    root = Path(parent).resolve()
    kernels = root / "src" / "repro_torch" / "kernels"
    out_dir = ROOT / "build" / "ab_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("flash_attention_bwd", "flash_attention_bwd_sm90"):
        out = out_dir / f"lib{name}_parent.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(kernels / "include"), "-o", str(out),
                        str(kernels / "flash_attention" / "csrc" /
                            f"{name}.cu")],
                       check=True, capture_output=True, text=True,
                       timeout=600)
        libs[name] = ctypes.CDLL(str(out))
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    mma = libs["flash_attention_bwd"].repro_flash_attention_bwd
    mma.argtypes = ([i32] + [ptr] * 10 + [i32] * 6 + [i64] * 24
                    + [i32, i32, ctypes.c_float, ptr])
    sm90 = libs["flash_attention_bwd_sm90"].repro_flash_attention_bwd_sm90
    sm90.argtypes = ([ptr] * 11 + [i32] * 6 + [ptr] * 2
                     + [i32, i32, ctypes.c_float, ptr])
    mma.restype = sm90.restype = i32
    sm90_dims = _parent_bwd_sm90_head_dims(root)

    def bwd(q, k, v, o, lse, dout, **mask):
        b, h, s, hd = q.shape
        hkv, t = k.shape[1], k.shape[2]
        dq = torch.empty((b, s, h, hd), dtype=q.dtype,
                         device=q.device).transpose(1, 2)
        dk, dv = (torch.empty((b, t, hkv, hd), dtype=q.dtype,
                              device=q.device).transpose(1, 2)
                  for _ in range(2))
        f32 = {"dtype": torch.float32, "device": q.device}
        if q.dtype == torch.bfloat16 and hd in sm90_dims:
            sp = -(-s // ops.SM90_BQ) * ops.SM90_BQ
            scratch = (torch.empty((2, b, h, sp), **f32),
                       torch.empty((b, h, sp, hd), **f32),
                       torch.empty(0, dtype=torch.int32, device=q.device))
            args = list(ops._sm90_args(q, k, v, o, lse, dout, dq, dk, dv,
                                       scratch, **mask))
            del args[8]   # the parent's entry takes no counts a q tile
            err = sm90(*args, ops._stream(q.device))
        else:
            delta = torch.empty((b, h, s), **f32)
            err = mma(*ops._mma_args(q, k, v, o, lse, dout, dq, dk, dv,
                                     delta, **mask), ops._stream(q.device))
        if err:
            raise RuntimeError(f"the parent's backward failed: cudaError {err}")
        return dq, dk, dv
    return bwd


def ab_backward(parent: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels.flash_attention import ops
    _card(cs)
    cs.build_report()
    old = _parent_backward(parent)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
    h, hkv = cs.MIXTRAL_HEADS
    shapes = ((cs.MIXTRAL_TRAIN_LABEL, 2, h, hkv, 2048, 128, 128,
               cs.MIXTRAL_WINDOW), *cs.BWD_TRAIN_SHAPES)
    for label, b, h, hkv, s, hd, v_hd, window in shapes:
        q, k, v, dout = cs._bwd_case_inputs(gen, b, h, hkv, s, s, hd, v_hd,
                                            torch.bfloat16)
        mask = {"causal": True, "window": window, "softcap": 0.0}
        o, lse = ops._launch(q, k, v, with_lse=True, **mask)
        calls = {"parent": lambda: old(q, k, v, o, lse, dout, **mask),
                 "change": lambda: ops._launch_bwd(q, k, v, o, lse, dout,
                                                   **mask)}
        got = {n: f() for n, f in calls.items()}
        apart = {n: float((a.float() - b_.float()).abs().max())
                 for n, a, b_ in zip(("dq", "dk", "dv"), got["change"],
                                     got["parent"])}
        del got
        times = {n: {"ms": [], "alone_ms": []} for n in calls}
        for n in ("parent", "change", "change", "parent"):
            times[n]["ms"].append(cs.cuda_ms(calls[n], 10))
            times[n]["alone_ms"].append(cs.queued_ms(calls[n]))
        for n in calls:
            times[n]["kernels_ms"] = cs._bwd_kernel_split(calls[n])
        flops, nbytes, _ = ops.bwd_cost(q, k, v, v_head_dim=v_hd, **mask)
        bound = max(flops / cs.PEAK_FLOPS[torch.bfloat16],
                    nbytes / cs.PEAK_BYTES_PER_S) * 1e3
        print("ABBWD", json.dumps({
            "shape": label, "path": ops.bwd_path(q.dtype, hd),
            "bound_ms": bound, "flops": flops, "bytes": nbytes,
            **{n: dict(t, share_of_bound=[bound / m for m in t["alone_ms"]])
               for n, t in times.items()},
            "sdpa_bwd": cs._sdpa_bwd(q, k, v, dout, window),
            "change_minus_parent": apart}), flush=True)
        del q, k, v, dout, o, lse
        cs.release_memory()


# (label, B, H, Hkv, S = T, q/k hd, v hd, window) of the forward's A/B, all
# causal bf16: the serve and train paths' shapes (phases 4-4g, 5c)
FWD_AB_SHAPES = (
    ("stablelm 2x32x2048x64", 2, 32, 32, 2048, 64, 64, 0),
    ("FrontDoor wave 2x32x64x64", 2, 32, 32, 64, 64, 64, 0),
    ("jamba 2x64(8)x2048x128", 2, 64, 8, 2048, 128, 128, 0),
    ("mixtral 1x48(8)x8192x128 window 4096", 1, 48, 8, 8192, 128, 128,
     4096),
    ("gemma3 1x16(8)x8192x256 window 1024", 1, 16, 8, 8192, 256, 256, 1024),
    ("gemma3 1x16(8)x2048x256 global", 1, 16, 8, 2048, 256, 256, 0),
    ("MLA 2x128x2048x192, v padded from 128", 2, 128, 128, 2048, 192, 128,
     0),
    ("phi3 1x40(10)x2048x128 (5c)", 1, 40, 10, 2048, 128, 128, 0),
)


def _parent_forward(parent: str):
    """The parent's forward C entry point, built from its own
    csrc/flash_attention.cu and headers with this tree's flags into
    build/ab_parent/, as a function of (q, k, v, **mask) -> (out, lse)."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    kernels = Path(parent).resolve() / "src" / "repro_torch" / "kernels"
    src = kernels / "flash_attention" / "csrc" / "flash_attention.cu"
    out = ROOT / "build" / "ab_parent" / "libflash_attention_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(kernels / "include"), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(str(out)).repro_flash_attention_fwd
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = ([i32] + [ptr] * 5 + [i32] * 6 + [i64] * 12
                   + [i32, i32, ctypes.c_float, ptr])
    fn.restype = i32

    def fwd(q, k, v, *, causal, window, softcap):
        b, h, s, hd = q.shape
        hkv, t = k.shape[1], k.shape[2]
        o = torch.empty((b, s, h, hd), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        err = fn(ops._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, hkv, s, t,
                 hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], int(causal), int(window), float(softcap),
                 ops._stream(q.device))
        if err:
            raise RuntimeError(f"the parent's forward failed: cudaError {err}")
        return o, lse
    return fwd


def _sdpa_alone(cs, q, k, v, v_hd: int, window: int) -> float:
    """SDPA on the card alone on q, k and the unpadded v: causal (GQA), or
    the window as a boolean mask over k, v expanded to the query heads."""
    import torch
    import torch.nn.functional as F
    b, h, s, _ = q.shape
    hkv = k.shape[1]
    v = v[..., :v_hd]
    if not window:
        return cs.queued_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=hkv != h))
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & ((i[:, None] - i[None, :]) < window)
    kx, vx = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    return cs.queued_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, attn_mask=mask))


def ab_forward(parent: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    _card(cs)
    cs.build_report()
    old = _parent_forward(parent)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 29)
    bf16 = torch.bfloat16
    for label, b, h, hkv, s, hd, v_hd, window in FWD_AB_SHAPES:
        q, k, v = cs._attn_inputs(gen, b, h, hkv, s, s, hd, bf16)
        if v_hd != hd:
            v = F.pad(v[..., :v_hd], (0, hd - v_hd))
        mask = {"causal": True, "window": window, "softcap": 0.0}
        calls = {"parent": lambda: old(q, k, v, **mask),
                 "change": lambda: ops._launch(q, k, v, with_lse=True,
                                               **mask)}
        got = {n: f() for n, f in calls.items()}
        apart = {n: float((a.float() - b_.float()).abs().max())
                 for n, a, b_ in zip(("out", "lse"), got["change"],
                                     got["parent"])}
        del got
        times = {n: {"ms": [], "alone_ms": []} for n in calls}
        for n in ("parent", "change", "change", "parent"):
            times[n]["ms"].append(cs.cuda_ms(calls[n], 20))
            times[n]["alone_ms"].append(cs.queued_ms(calls[n]))
        flops, nbytes, _ = ops.cost(q, k, v, v_head_dim=v_hd, **mask)
        bound = max(flops / cs.PEAK_FLOPS[bf16],
                    nbytes / cs.PEAK_BYTES_PER_S) * 1e3
        sdpa = _sdpa_alone(cs, q, k, v, v_hd, window)
        print("ABFWD", json.dumps({
            "shape": label, "path": ops.fwd_path(bf16, hd),
            "bound_ms": bound, "flops": flops, "bytes": nbytes,
            **{n: dict(t, share_of_bound=[bound / m for m in t["alone_ms"]])
               for n, t in times.items()},
            "sdpa_alone_ms": sdpa,
            "change_over_sdpa": [m / sdpa for m in times["change"]["alone_ms"]],
            "change_minus_parent": apart}), flush=True)
        del q, k, v
        cs.release_memory()


def train_steps(root: str) -> None:
    """The A/B steps of one checkout, in this process."""
    sys.path[:0] = [str(Path(root) / "src"), root]
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    _card(cs)
    cs.build_report()
    out = {}
    for arch, layers, batch, seq_len in AB_CONFIGS:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.scaled(num_layers=layers)
        n = (cs.MIXTRAL_TRAIN_PARAMS if arch == "mixtral-8x22b" else
             next(p for a, _, _, _, p in cs.LAUNCH_TRAIN if a == arch))
        params = cs._init_checked(cfg, cs.SEED + 20, n)
        r = cs._launch_train_one(arch, cfg, params, batch, seq_len, n)
        out[arch] = {"step_ms": r["step_ms"], "all": r["all_step_ms"],
                     "peak": r["max_memory_allocated"]}
        del params
        cs.release_memory()
    print("AB", root, json.dumps(out), flush=True)


def ab_train(roots: list) -> int:
    for root in roots:
        rc = subprocess.run([sys.executable, __file__, "_train", root]).returncode
        if rc:
            return rc
    return 0


def main(argv: list) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probes: torch.cuda.is_available() is False; the probes "
              "need an NVIDIA card", file=sys.stderr)
        return 1
    if argv[:1] == ["backward"]:
        backward()
        return 0
    if argv[:1] == ["mlstm"]:
        mlstm()
        return 0
    if argv[:1] == ["ab-backward"] and len(argv) == 2:
        sys.path.insert(0, str(ROOT / "src"))
        ab_backward(argv[1])
        return 0
    if argv[:1] == ["ab-forward"] and len(argv) == 2:
        sys.path.insert(0, str(ROOT / "src"))
        ab_forward(argv[1])
        return 0
    if argv[:1] == ["ab-train"] and len(argv) > 1:
        return ab_train(argv[1:])
    if argv[:1] == ["_train"] and len(argv) == 2:
        train_steps(argv[1])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
