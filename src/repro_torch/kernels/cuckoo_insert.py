"""Direct cuckoo insert: the two CUDA kernels' bindings and their plain
versions.

Both kernels compute one function: each key takes the first free slot of
bucket i1, else of bucket i2, scanning circularly from its tag-derived
start, with one atomicCAS on the word it changes. No eviction: keys with
both buckets full report ok = False.

* Fused (``csrc/cuckoo_insert.cu``) replaces ``repro/kernels/
  cuckoo_insert.py: cuckoo_insert_fused_pallas`` (SWAR zero masks; bucket
  i2 read only when i1 is full, a lost CAS refreshes the one word).
* Unfused (``csrc/cuckoo_insert_unfused.cu``) replaces
  ``cuckoo_insert_pallas``: the fused kernel's reads and CAS loop (bucket
  i2 read only when i1 is full, a lost CAS refreshes the one word), with
  each lane unpacked and tested on its own instead of the SWAR masks.

:func:`cuckoo_insert_direct_plain` is the plain version of both: the
literal sequential loop in batch order (a port of ``cuckoo_insert_ref``,
extracting each lane as the unfused TPU kernel does), which is one valid
linearisation of either kernel's concurrent inserts.
``kernels.ops.cuckoo_insert_direct(fused=...)`` picks the kernel, and the
device the table lives on picks kernel or plain version.
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


def cuckoo_insert_unfused_launch(config: CuckooConfig, table: torch.Tensor,
                                 keys: torch.Tensor, valid: torch.Tensor,
                                 ok: torch.Tensor) -> None:
    """Launch the unfused kernel on the current stream (arguments already
    checked)."""
    rc = build.load("cuckoo_insert_unfused").cuckoo_insert_unfused_launch(
        table.data_ptr(), keys.data_ptr(), valid.data_ptr(), ok.data_ptr(),
        keys.shape[0], *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_insert_unfused")
