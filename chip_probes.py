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
    if argv[:1] == ["ab-train"] and len(argv) > 1:
        return ab_train(argv[1:])
    if argv[:1] == ["_train"] and len(argv) == 2:
        train_steps(argv[1])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
