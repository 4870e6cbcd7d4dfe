"""Synthetic token pipeline — deterministic, cursor-resumable.

Port of ``repro.data.pipeline``. A batch is a pure function of (seed,
step), so a restart at step k regenerates exactly the batches k, k+1, ...
(the checkpoint stores only the cursor). Token statistics are Zipf-ish,
with injected duplicate sequences to exercise the dedup filter. The
batches come from the JAX package's numpy generators, draw for draw, so
their values are equal bit for bit; they are returned as tensors on
``device`` (default: the GPU; ``device="cpu"`` for the host).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    duplicate_fraction: float = 0.2   # fraction of sequences that are repeats
    zipf_a: float = 1.2


def make_batch(cfg: DataConfig, step: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Batch for ``step``: tokens int32[batch, seq_len + 1]."""
    device = resolve_device(device)
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    z = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq_len + 1))
    tokens = (z - 1) % cfg.vocab_size
    # inject duplicates: some rows repeat a small pool of canned sequences
    n_dup = int(cfg.batch * cfg.duplicate_fraction)
    if n_dup:
        pool_rng = np.random.default_rng(cfg.seed + 7)
        pool = (pool_rng.zipf(cfg.zipf_a, size=(8, cfg.seq_len + 1)) - 1) \
            % cfg.vocab_size
        rows = rng.choice(cfg.batch, size=n_dup, replace=False)
        tokens[rows] = pool[rng.integers(0, len(pool), n_dup)]
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}


def make_frames_batch(cfg: DataConfig, step: int, d_model: int,
                      device=None) -> Dict[str, torch.Tensor]:
    """Audio-stub batch: frame embeddings + codebook labels (hubert)."""
    device = resolve_device(device)
    rng = np.random.default_rng(np.uint64(cfg.seed * 999_983 + step))
    frames = rng.normal(size=(cfg.batch, cfg.seq_len, d_model)) * 0.02
    labels = rng.integers(0, cfg.vocab_size, (cfg.batch, cfg.seq_len))
    return {"frames": torch.from_numpy(frames.astype(np.float32)).to(device),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(device)}


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, step, device)
        step += 1
