"""Blocked-Bloom query and insert: the CUDA kernels' bindings and their
plain versions.

The kernels (``csrc/bloom_query.cu``, ``csrc/bloom_insert.cu``) replace
``repro/kernels/bloom.py: bloom_query_pallas`` and ``bloom_insert_pallas``.
The plain versions are ``filters.blocked_bloom``'s query and insert with
the torch hash; ``kernels.ops.bloom_query`` / ``bloom_insert`` pick one
by the device the table lives on.
"""

from __future__ import annotations

import torch

from ..core.bits64 import MASK64
from ..filters import blocked_bloom as BB
from . import build
from .hash64 import HASH_KINDS

# Keys a plain insert scatters at a time: its (word, bit) codes and their
# sort stay near 2 GiB at k = 8.
_PLAIN_CHUNK = 1 << 22


def bloom_query_plain(config: BB.BloomConfig, table: torch.Tensor,
                      keys: torch.Tensor) -> torch.Tensor:
    """Membership of int32[n, 2] keys -> bool[n]."""
    state = BB.BloomState(table, torch.zeros((), dtype=torch.int32,
                                           device=table.device))
    return BB.query(config, state, keys, plain=True)


def bloom_insert_plain(config: BB.BloomConfig, table: torch.Tensor,
                       keys: torch.Tensor, valid: torch.Tensor) -> None:
    """Set the k bits of every valid key in ``table``, in place (in key
    chunks: OR commutes, so the chunking changes nothing)."""
    state = BB.BloomState(table, torch.zeros((), dtype=torch.int32,
                                           device=table.device))
    for k, v in zip(keys.split(_PLAIN_CHUNK), valid.split(_PLAIN_CHUNK)):
        BB.insert(config, state, k, v, plain=True)


def geometry(config: BB.BloomConfig) -> tuple:
    """The geometry arguments both kernels take, from a config."""
    return (config.num_blocks, config.words_per_block, config.k,
            max(1, (config.block_bits - 1).bit_length()),
            HASH_KINDS[config.hash_kind], config.seed & MASK64)


def bloom_query_launch(config: BB.BloomConfig, table: torch.Tensor,
                       keys: torch.Tensor, hit: torch.Tensor) -> None:
    """Launch the query kernel on the current stream (arguments checked)."""
    rc = build.load("bloom_query").bloom_query_launch(
        table.data_ptr(), keys.data_ptr(), hit.data_ptr(), keys.shape[0],
        *geometry(config), torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "bloom_query")


def bloom_insert_launch(config: BB.BloomConfig, table: torch.Tensor,
                        keys: torch.Tensor, valid: torch.Tensor) -> None:
    """Launch the insert kernel on the current stream (arguments checked)."""
    rc = build.load("bloom_insert").bloom_insert_launch(
        table.data_ptr(), keys.data_ptr(), valid.data_ptr(), keys.shape[0],
        *geometry(config), torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "bloom_insert")
