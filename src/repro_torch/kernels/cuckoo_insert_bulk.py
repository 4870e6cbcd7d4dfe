"""Bucket-major direct insert (the bulk-build kernel): the CUDA route's
binding, its rule and its plain version.

The route (``csrc/cuckoo_insert_bulk.cu``) replaces ``repro/kernels/
cuckoo_insert.py: cuckoo_insert_bulk_pallas``: each valid key takes the
first free slot of bucket i1, else of bucket i2, scanning circularly from
the tag-derived start. No eviction: keys with both buckets full report
ok = False. On the card a batch takes one of two routes, by the shape
alone (:func:`bulk_plan`): partitioned by table window with the hash fused
in (five launches, no host sync, no sort), so that each window's buckets
come from device memory about once; or, for a table in L2 or a sparse
batch, the insert pass alone in batch order. Every write is an atomicCAS.

:func:`cuckoo_insert_bulk_plain` sorts the batch and runs the literal
sequential loop on the sorted stream (the JAX kernel's function,
``cuckoo_insert_ref`` on that stream), one valid linearisation of the
kernel's concurrent inserts. ``kernels.ops.cuckoo_insert_bulk`` picks one
by the device the table lives on.
"""

from __future__ import annotations

import torch

from ..core.cuckoo_filter import CuckooConfig, prepare_keys_plain
from . import build
from .autotune import DEFAULT_BLOCK_KEYS
from .bloom import MAX_WINDOWS, WindowPlan, l2_bytes, window_split
from .cuckoo_insert import cuckoo_insert_direct_plain

# The windowed route's rule, from the card's own times (chip_smoke.py's
# `rule_sweep`, PERF.md §6): a window is the largest power of two of
# buckets within a fifth of the L2, as for the Bloom query (2^18 buckets
# of 32 bytes on an H100; 2^17 and 2^19 were slower); on the main path's
# 512 MiB table the route about tied the insert pass alone at 3/8 keys a
# bucket and won at 1/2.
WINDOWED_KEYS_PER_BUCKET = 0.5


def cuckoo_insert_bulk_plain(config: CuckooConfig, table: torch.Tensor,
                             keys: torch.Tensor,
                             valid: torch.Tensor = None) -> torch.Tensor:
    """Sort the batch stably by primary bucket, insert the sorted stream
    one key at a time in place, and return ok bool[n] in batch order.

    On a stream already sorted by primary bucket this is the JAX kernel's
    function: ``cuckoo_insert_ref`` on the sorted stream.
    """
    _, i1, _ = prepare_keys_plain(config, keys)
    order = torch.sort(i1, stable=True).indices
    ok = torch.empty((keys.shape[0],), dtype=torch.bool, device=keys.device)
    ok[order] = cuckoo_insert_direct_plain(
        config, table, keys[order], None if valid is None else valid[order])
    return ok


def bulk_plan(config: CuckooConfig, n: int, l2_bytes: int) -> WindowPlan:
    """The route a bulk insert of ``n`` keys takes on a card with
    ``l2_bytes`` of L2, from the shape alone: windows of buckets as the
    Bloom query's (``bloom.window_split``). The windowed route is taken
    where the table is larger than the L2 and spans at most
    ``MAX_WINDOWS`` windows, and the batch holds at least
    ``WINDOWED_KEYS_PER_BUCKET`` keys a bucket; elsewhere the insert pass
    runs alone over the batch, as one window."""
    log2_window, windows = window_split(
        config.num_buckets, 4 * config.layout.words_per_bucket, l2_bytes)
    windowed = (config.table_bytes > l2_bytes and windows <= MAX_WINDOWS
                and 0 < n < 2 ** 31
                and n >= WINDOWED_KEYS_PER_BUCKET * config.num_buckets)
    return WindowPlan(windowed, log2_window, windows)


def cuckoo_insert_bulk_launch(config: CuckooConfig, table: torch.Tensor,
                              keys: torch.Tensor, valid: torch.Tensor,
                              ok: torch.Tensor, plan: WindowPlan = None, *,
                              block_keys: int = DEFAULT_BLOCK_KEYS[
                                  "bulk_insert"]) -> None:
    """Run the route on the current stream (arguments checked, ``n >= 1``)
    by ``plan``, by default :func:`bulk_plan`'s for this card, with a tile
    of ``block_keys`` entries (half of it a block where the insert pass
    runs alone). The windowed route's scratch comes from torch's
    allocator."""
    n = keys.shape[0]
    if plan is None:
        plan = bulk_plan(config, n, l2_bytes(table.device))
    lib = build.load("cuckoo_insert_bulk")
    scratch, windows = None, 1
    if plan.windowed:
        windows = plan.windows
        scratch = torch.empty(
            (lib.cuckoo_insert_bulk_scratch_bytes(n, windows),),
            dtype=torch.uint8, device=table.device)
    rc = lib.cuckoo_insert_bulk_launch(
        table.data_ptr(), keys.data_ptr(), valid.data_ptr(), ok.data_ptr(), n,
        None if scratch is None else scratch.data_ptr(), plan.log2_window,
        windows, block_keys, *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_insert_bulk")
