"""Bucket-major direct insert (the bulk-build kernel): the CUDA kernel's
binding and its plain version.

The kernel (``csrc/cuckoo_insert_bulk.cu``) replaces ``repro/kernels/
cuckoo_insert.py: cuckoo_insert_bulk_pallas``: keys sorted by primary
bucket each take the first free slot of bucket i1, else of bucket i2,
scanning circularly from the tag-derived start. No eviction: keys with
both buckets full report ok = False. One thread walks one primary-bucket
segment with the bucket's words in registers; every write is an atomicCAS.

:func:`cuckoo_insert_bulk_plain` sorts the batch and runs the literal
sequential loop on the sorted stream (the JAX kernel's function,
``cuckoo_insert_ref`` on that stream), one valid linearisation of the
kernel's concurrent segments. ``kernels.ops.cuckoo_insert_bulk`` picks
one by the device the table lives on.
"""

from __future__ import annotations

import torch

from ..core.cuckoo_filter import CuckooConfig, prepare_keys_plain
from . import build
from .cuckoo_insert import cuckoo_insert_direct_plain


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


def cuckoo_insert_bulk_launch(config: CuckooConfig, table: torch.Tensor,
                              keys: torch.Tensor, valid: torch.Tensor,
                              order: torch.Tensor, seg_start: torch.Tensor,
                              ok: torch.Tensor) -> None:
    """Launch the kernel on the current stream (arguments already checked)."""
    rc = build.load("cuckoo_insert_bulk").cuckoo_insert_bulk_launch(
        table.data_ptr(), keys.data_ptr(), valid.data_ptr(), order.data_ptr(),
        seg_start.data_ptr(), seg_start.shape[0], keys.shape[0],
        ok.data_ptr(), *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_insert_bulk")
