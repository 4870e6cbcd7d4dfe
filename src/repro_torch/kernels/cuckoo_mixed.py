"""Mixed QUERY/INSERT/DELETE op stream: the CUDA kernel's binding and its
plain version.

The kernel (``csrc/cuckoo_mixed.cu``) replaces ``repro/kernels/
cuckoo_mixed.py: cuckoo_mixed_pallas``. It gives the normative semantics
of DESIGN.md §9 — operations on the same 64-bit key resolve in batch
order — with one thread per key segment of the stably key-sorted batch
(:func:`segments`). The TPU kernel's exact cross-key order cannot be had
from a grid of parallel blocks: cross-key fingerprint aliasing within one
batch is observed in an unspecified order.

:func:`cuckoo_mixed_plain` is the literal sequential loop in batch order
(a port of ``cuckoo_mixed_ref``), one valid linearisation of the kernel.
"""

from __future__ import annotations

import torch

from ..core.bits64 import MASK32
from ..core.cuckoo_filter import CuckooConfig
from . import build
from .ref import apply_sequential


def cuckoo_mixed_plain(config: CuckooConfig, table: torch.Tensor,
                       keys: torch.Tensor, ops: torch.Tensor,
                       valid: torch.Tensor = None) -> torch.Tensor:
    """Apply the op stream in batch order, in place -> ok bool[n]."""
    return apply_sequential(config, table, keys, ops, valid)


def sorted_runs(values: torch.Tensor):
    """Stable sort of int64[n] ``values`` into runs of equal values.

    Returns (order int64[n]: batch positions in sorted order, batch order
    within a run; seg_start int64[s]: the sorted position where each run
    begins).
    """
    sorted_v, order = torch.sort(values, stable=True)
    head = torch.ones_like(sorted_v, dtype=torch.bool)
    head[1:] = sorted_v[1:] != sorted_v[:-1]
    return order, head.nonzero().squeeze(1)


def segments(keys: torch.Tensor):
    """:func:`sorted_runs` of the batch by 64-bit key value."""
    return sorted_runs((keys[:, 1].to(torch.int64) << 32)
                       | (keys[:, 0].to(torch.int64) & MASK32))


def cuckoo_mixed_launch(config: CuckooConfig, table: torch.Tensor,
                        keys: torch.Tensor, ops: torch.Tensor,
                        valid: torch.Tensor, order: torch.Tensor,
                        seg_start: torch.Tensor, ok: torch.Tensor) -> None:
    """Launch the kernel on the current stream (arguments already checked)."""
    rc = build.load("cuckoo_mixed").cuckoo_mixed_launch(
        table.data_ptr(), keys.data_ptr(), ops.data_ptr(), valid.data_ptr(),
        order.data_ptr(), seg_start.data_ptr(), seg_start.shape[0],
        keys.shape[0], ok.data_ptr(), *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_mixed")
