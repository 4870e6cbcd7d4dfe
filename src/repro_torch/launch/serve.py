"""Serving driver: batched generation with the AMQ-guarded prefix cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_4b \\
        --reduced --device cpu --requests 8 --steps 16

Runs on the GPU unless ``--device`` names another device; without a CUDA
device the default raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..models import build_model
from ..serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--repeat-fraction", type=float, default=0.5,
                    help="fraction of requests repeating a previous prompt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device, seed=args.seed)
    engine = ServeEngine(model, batch=args.batch,
                         max_len=args.prompt_len + args.steps)

    rng = np.random.default_rng(args.seed)
    base_prompts = [rng.integers(0, cfg.vocab_size,
                                 (args.batch, args.prompt_len)).astype(np.int32)
                    for _ in range(max(2, args.requests // 2))]
    total_tokens = 0
    t0 = time.perf_counter()
    for r in range(args.requests):
        if rng.random() < args.repeat_fraction and r > 0:
            prompts = base_prompts[rng.integers(0, len(base_prompts))]
        else:
            prompts = base_prompts[r % len(base_prompts)]
        tokens, stats = engine.generate(prompts, steps=args.steps)
        total_tokens += tokens.size
    dt = time.perf_counter() - t0
    print(f"served {args.requests} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.0f} tok/s) on {model.device}")
    print("prefix-cache stats:", stats)


if __name__ == "__main__":
    main()
