"""Blocked-Bloom query and insert: the CUDA kernels' bindings and their
plain versions.

The kernels (``csrc/bloom_query.cu``, ``csrc/bloom_insert.cu``) replace
``repro/kernels/bloom.py: bloom_query_pallas`` and ``bloom_insert_pallas``.
The plain versions are ``filters.blocked_bloom``'s query and insert with
the torch hash; ``kernels.ops.bloom_query`` / ``bloom_insert`` pick one
by the device the table lives on.

A query takes one of two routes on the card, by the shape alone
(:func:`query_plan`): one thread a key, or, for a batch of many keys a
block against a table larger than the L2, the windowed route, which
partitions the batch by table window so that each window's blocks come
from device memory about once.
"""

from __future__ import annotations

from typing import NamedTuple

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


# bloom_query.cu's most windows (one a thread of a tile's block).
MAX_WINDOWS = 256
# The windowed route's rule, from the card's own times (PERF.md §6):
# a window is the largest power of two of blocks within a fifth of the L2
# (8 MiB of 64-byte blocks on an H100); the route pays from 16 windows
# (a table over about 2.5 L2s) and 12 keys a block on.
WINDOW_L2_SHARE = 1 / 5
MIN_WINDOWS = 16
WINDOWED_KEYS_PER_BLOCK = 12


class WindowPlan(NamedTuple):
    """The route of one call of a kernel with a windowed route (this
    query, the cuckoo bulk insert): ``windowed``, and the windows it would
    use: ``windows`` of ``2 ** log2_window`` table units (blocks, buckets)
    each."""

    windowed: bool
    log2_window: int
    windows: int


def window_split(units: int, unit_bytes: int, l2_bytes: int) -> tuple:
    """(log2_window, windows): a window is the largest power of two of
    ``units`` within ``WINDOW_L2_SHARE`` of the L2, and the windows cover
    the table's ``units``."""
    budget = int(l2_bytes * WINDOW_L2_SHARE) // unit_bytes
    log2_window = max(0, budget.bit_length() - 1)
    return log2_window, -(-units >> log2_window)


def query_plan(config: BB.BloomConfig, n: int, l2_bytes: int) -> WindowPlan:
    """The route a query of ``n`` keys takes on a card with ``l2_bytes`` of
    L2, from the shape alone. A window is the largest power of two of
    blocks within ``WINDOW_L2_SHARE`` of the L2, so that its blocks stay in
    L2 while its keys are tested. The windowed route is taken where the
    table spans ``MIN_WINDOWS`` to ``MAX_WINDOWS`` windows and the batch
    asks at least ``WINDOWED_KEYS_PER_BLOCK`` keys a block; elsewhere one
    thread a key was faster on the card."""
    log2_window, windows = window_split(
        config.num_blocks, 4 * config.words_per_block, l2_bytes)
    windowed = (MIN_WINDOWS <= windows <= MAX_WINDOWS and 0 < n < 2 ** 31
                and n >= WINDOWED_KEYS_PER_BLOCK * config.num_blocks)
    return WindowPlan(windowed, log2_window, windows)


def l2_bytes(device: torch.device) -> int:
    """The L2 size of a CUDA device, as the kernels read it."""
    with torch.cuda.device(device):
        got = build.load("bloom_query").bloom_query_l2_bytes()
    build.check(max(0, -got), "bloom_query")
    return got


def bloom_query_launch(config: BB.BloomConfig, table: torch.Tensor,
                       keys: torch.Tensor, hit: torch.Tensor,
                       plan: WindowPlan = None) -> None:
    """Launch the query on the current stream (arguments checked) by the
    route of ``plan``, by default :func:`query_plan`'s for this card. The
    windowed route's scratch comes from torch's allocator."""
    n = keys.shape[0]
    if plan is None:
        plan = query_plan(config, n, l2_bytes(table.device))
    lib = build.load("bloom_query")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    if plan.windowed:
        scratch = torch.empty(
            (lib.bloom_query_scratch_bytes(n, plan.windows),),
            dtype=torch.uint8, device=table.device)
        rc = lib.bloom_query_windowed_launch(
            table.data_ptr(), keys.data_ptr(), hit.data_ptr(), n,
            scratch.data_ptr(), plan.log2_window, plan.windows,
            *geometry(config), stream)
    else:
        rc = lib.bloom_query_launch(table.data_ptr(), keys.data_ptr(),
                                    hit.data_ptr(), n, *geometry(config),
                                    stream)
    build.check(rc, "bloom_query")


def bloom_insert_launch(config: BB.BloomConfig, table: torch.Tensor,
                        keys: torch.Tensor, valid: torch.Tensor) -> None:
    """Launch the insert kernel on the current stream (arguments checked)."""
    rc = build.load("bloom_insert").bloom_insert_launch(
        table.data_ptr(), keys.data_ptr(), valid.data_ptr(), keys.shape[0],
        *geometry(config), torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "bloom_insert")
