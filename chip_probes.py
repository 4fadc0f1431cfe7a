#!/usr/bin/env python3
"""Single phases of chip_smoke.py on one NVIDIA card, for a first check of
a kernel or a measurement that does not need the whole run.

    python3 chip_probes.py backward
        Builds the kernels (printing ptxas's report), then runs phase 2's
        flash checks, forward (`check_flash_attention`), backward
        (`check_flash_backward`) and at head_dim 256 and 192
        (`check_flash_new_head_dims`), and phase 3's softcap parity
        (`check_softcap_card_vs_cpu`).

    python3 chip_probes.py ab-train ROOT [ROOT ...]
        For each checkout ROOT in turn, in a process of its own, phase 5c's
        training steps (`_launch_train_one`: 1 warm-up and 3 timed steps of
        `launch.train`) of stablelm-1.6b whole at 2x2048, seamless-m4t-medium
        whole at 2x1024 and mixtral-8x22b cut to 1 layer at 2x2048, each
        through that checkout's own package and chip_smoke.py. Give the
        parent commit unpacked into an ignored directory and `.` in the
        order parent, change, change, parent, so that both are measured on
        the same card in one call. Prints one `AB <root> {...}` line a
        checkout: each config's median and all step ms and its peak
        `max_memory_allocated`.

    python3 chip_probes.py ab-backward PARENT
        The flash backward of the parent checkout PARENT (its
        csrc/flash_attention_bwd.cu, built here with this tree's nvcc flags
        and loaded beside this tree's kernels) against this tree's, in one
        process on one card, at mixtral's 2x48(8)x2048x128 window 4096 and
        each of chip_smoke.py's BWD_TRAIN_SHAPES: in turn parent, change,
        change, parent, each ms a call (CUDA events) and on the card alone
        (`queued_ms`), and once each kernel's device ms; the bound
        (`ops.bwd_cost`); SDPA's backward alone; the largest |change -
        parent| of dq, dk and dv. Prints one `ABBWD {...}` line a shape.

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
              ("mixtral-8x22b", 1, 2, 2048))


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


def _parent_backward(parent: str):
    """The parent's backward C entry point, built from its own source and
    headers with this tree's flags into build/ab_parent/, as a function of
    (q, k, v, out, lse, dout, **mask) -> (dq, dk, dv)."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    kernels = Path(parent).resolve() / "src" / "repro_torch" / "kernels"
    src = kernels / "flash_attention" / "csrc" / "flash_attention_bwd.cu"
    out = ROOT / "build" / "ab_parent" / "libflash_attention_bwd_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(kernels / "include"), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(str(out)).repro_flash_attention_bwd
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = ([i32] + [ptr] * 10 + [i32] * 6 + [i64] * 24
                   + [i32, i32, ctypes.c_float, ptr])
    fn.restype = i32

    def bwd(q, k, v, o, lse, dout, **mask):
        b, h, s, hd = q.shape
        hkv, t = k.shape[1], k.shape[2]
        dq = torch.empty((b, s, h, hd), dtype=q.dtype,
                         device=q.device).transpose(1, 2)
        dk, dv = (torch.empty((b, t, hkv, hd), dtype=q.dtype,
                              device=q.device).transpose(1, 2)
                  for _ in range(2))
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        err = fn(*ops._mma_args(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                **mask), ops._stream(q.device))
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
    if argv[:1] == ["ab-backward"] and len(argv) == 2:
        sys.path.insert(0, str(ROOT / "src"))
        ab_backward(argv[1])
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
