"""Serving example on the PyTorch port: batched generation with an
AMQ-guarded prefix cache.

The counterpart of ``examples/serve_with_prefix_filter.py`` on
``repro_torch``, at its sizes (``gemma2_2b.reduced()``, batch 2, 24-token
prompts, 8 decode steps), with its request sequence and its checks. Half
the requests repeat earlier prompts; the cuckoo filter in front of the
prefix cache answers "never cached" for fresh prompts (skipping the probe)
and stays in sync under LRU eviction via deletions. On the GPU each
prefill's attention is the flash kernel with gemma2's attention softcap.

    PYTHONPATH=src python examples/serve_with_prefix_filter_torch.py             # the GPU
    PYTHONPATH=src python examples/serve_with_prefix_filter_torch.py --device cpu

Without a CUDA device it fails unless ``--device cpu`` is given, which runs
the kernels' plain PyTorch versions.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine

BATCH, PROMPT, STEPS = 2, 24, 8
# fill the 4-entry cache, re-serve two prompts (hits), then push three fresh
# prompts (LRU evictions + filter deletions), then repeat an evicted one.
SEQUENCE = [0, 1, 2, 3, 1, 2, 4, 5, 0, 1]


def main(device: str = "cuda") -> dict:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_with_prefix_filter_torch: no CUDA device is "
                         "available; run with --device cpu")
    cfg = get_config("gemma2_2b").reduced()
    model = build_model(cfg, device=device, seed=0)
    engine = ServeEngine(model, batch=BATCH, max_len=PROMPT + STEPS,
                         prefix_cache_entries=4,
                         # serving SLO knobs flow to the guard-filter
                         # service: 1ms deadline, bounded queue.
                         prefix_cache_service_kw={"max_delay": 0.001,
                                                  "max_pending": 32})

    rng = np.random.default_rng(0)
    pool = [rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
            for _ in range(6)]

    t0 = time.perf_counter()
    for i in SEQUENCE:
        tokens, stats = engine.generate(pool[i], steps=STEPS)
    dt = time.perf_counter() - t0
    print(f"{len(SEQUENCE)} requests in {dt:.1f}s on {model.device}")
    slo = stats.pop("filter_service")
    print("prefix cache stats:", stats)
    print(f"guard-filter SLO: p99 enqueue-to-ready "
          f"{slo['ready']['p99_s'] * 1e6:.0f}us over {slo['ready']['count']} "
          f"ops, dispatch causes {slo['dispatch_kinds']}")
    assert stats["hits"] > 0, "repeat prompts must hit the prefix cache"
    assert stats["filtered"] > 0, "fresh prompts must be filtered (neg lookup)"
    if stats["evictions"]:
        print(f"LRU evicted {stats['evictions']} entries — filter deletions "
              "kept the AMQ in sync (a Bloom filter would rot here)")
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain versions of the kernels)")
    main(ap.parse_args().device)
