"""Serving launcher: --arch <id>, synthetic batched requests. The port of
`repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --smoke --device cpu

The `ServingEngine` takes tokens only, as the reference's does: for
seamless-m4t-medium and internvl2-2b, whose models also need `frames` or
`image_embeds`, the prefill raises `KeyError`, as the reference's does.
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.bridge import init_params
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, Response, ServingEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                         "the host)")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, params=None) -> List[Response]:
    """The body of `main`: serve `--requests` random prompts and print the
    summary line; `params` default to `init_params` from a generator
    seeded 0 on the device."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled(param_dtype="float32")
    dev = resolve_device(args.device)
    model = build_model(cfg)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServingEngine(model, params,
                        max_seq=args.prompt_len + args.max_new + 4,
                        device=dev)
    reqs = [Request(i, np.random.default_rng(i).integers(
                1, cfg.vocab_size - 1, size=(args.prompt_len,)
            ).astype(np.int32), args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    resp = eng.serve(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(r.tokens) for r in resp)
    print(f"{len(resp)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s)")
    return resp


def main(argv=None):
    serve(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
