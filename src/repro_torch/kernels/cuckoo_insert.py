"""Direct cuckoo insert: the CUDA kernel's binding and its plain version.

The kernel (``csrc/cuckoo_insert.cu``) replaces ``repro/kernels/
cuckoo_insert.py: cuckoo_insert_fused_pallas``: each key takes the first
free slot of bucket i1, else of bucket i2, scanning circularly from its
tag-derived start, with one atomicCAS on the word it changes. No eviction:
keys with both buckets full report ok = False.

:func:`cuckoo_insert_direct_plain` is the literal sequential loop (a port
of ``cuckoo_insert_ref``), which is one valid linearisation of the
kernel's concurrent inserts. ``kernels.ops.cuckoo_insert_direct`` picks
one by the device the table lives on.
"""

from __future__ import annotations

import torch

from ..amq.protocol import OP_INSERT
from ..core.cuckoo_filter import CuckooConfig
from . import build
from .ref import apply_sequential


def cuckoo_insert_direct_plain(config: CuckooConfig, table: torch.Tensor,
                               keys: torch.Tensor,
                               valid: torch.Tensor = None) -> torch.Tensor:
    """Insert keys one at a time in batch order, in place -> ok bool[n]."""
    ops = torch.full((keys.shape[0],), OP_INSERT, dtype=torch.int32,
                     device=keys.device)
    return apply_sequential(config, table, keys, ops, valid)


def cuckoo_insert_launch(config: CuckooConfig, table: torch.Tensor,
                         keys: torch.Tensor, valid: torch.Tensor,
                         ok: torch.Tensor) -> None:
    """Launch the kernel on the current stream (arguments already checked)."""
    rc = build.load("cuckoo_insert").cuckoo_insert_launch(
        table.data_ptr(), keys.data_ptr(), valid.data_ptr(), ok.data_ptr(),
        keys.shape[0], *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_insert")
