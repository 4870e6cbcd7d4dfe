"""Mixed QUERY/INSERT/DELETE op stream: the CUDA kernels' binding, the
route that runs them, and their plain version.

The route (``csrc/cuckoo_mixed.cu``, whose header gives the argument)
replaces ``repro/kernels/cuckoo_mixed.py: cuckoo_mixed_pallas``. It gives
the normative semantics of DESIGN.md §9: ``ok`` and the table are what one
sequential order of the ops gives, an order that keeps each 64-bit key's
ops in batch order. Ops on keys that occur once in the batch run in batch
layout, with no sort: a scratch hash table marks the repeated keys, then
the once-only queries, deletes and inserts each take a launch. Only the
ops of repeated keys are compacted (the route's one host sync), sorted
stably by key value and walked, a key's run in batch order, round by
round. So the order realised is: once-only queries, deletes, inserts,
then the repeated keys' ops; only ops of different keys change places.
The TPU kernel's exact cross-key order cannot be had from a grid of
parallel blocks: cross-key fingerprint aliasing within one batch is seen
in the route's order, not the batch's.

:func:`cuckoo_mixed_plain` is the literal sequential loop in batch order
(a port of ``cuckoo_mixed_ref``): on a batch without aliasing or a full
bucket it gives the route's result.
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


def key_values(keys: torch.Tensor) -> torch.Tensor:
    """int32[n, 2] (lo, hi) keys -> their 64-bit values as int64[n]."""
    return ((keys[:, 1].to(torch.int64) << 32)
            | (keys[:, 0].to(torch.int64) & MASK32))


def key_order(keys: torch.Tensor, positions: torch.Tensor):
    """``positions`` (ascending batch positions) sorted stably by their
    keys' 64-bit values -> (the sorted values, the permutation of
    ``positions``): each key's positions in a run, in batch order."""
    return torch.sort(key_values(keys[positions]), stable=True)


def scratch_slots(n: int) -> int:
    """Slots of the route's scratch table for ``n`` ops: the least power of
    two of at least 2n (linear probing at load <= 0.5)."""
    return 1 << max(1, (2 * n - 1).bit_length())


def cuckoo_mixed_launch(config: CuckooConfig, table: torch.Tensor,
                        keys: torch.Tensor, ops: torch.Tensor,
                        valid: torch.Tensor, scratch: torch.Tensor,
                        ok: torch.Tensor, state: torch.Tensor) -> None:
    """Clear ``scratch`` (int64[:func:`scratch_slots`]), mark the repeated
    keys and apply the once-only ops, on the current stream (arguments
    already checked). Afterwards ``state`` (uint8[n]) is 1 + the op's kind
    (0 query, 1 insert, 2 delete) where its key is repeated, its ``ok``
    left for :func:`cuckoo_mixed_walk_launch`, else 0."""
    rc = build.load("cuckoo_mixed").cuckoo_mixed_launch(
        table.data_ptr(), keys.data_ptr(), ops.data_ptr(), valid.data_ptr(),
        scratch.data_ptr(), scratch.shape[0].bit_length() - 1, keys.shape[0],
        ok.data_ptr(), state.data_ptr(), *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_mixed")


def cuckoo_mixed_walk_launch(config: CuckooConfig, table: torch.Tensor,
                             values: torch.Tensor, order: torch.Tensor,
                             scratch: torch.Tensor, counts: torch.Tensor,
                             ok: torch.Tensor) -> None:
    """Walk the repeated keys' runs on the current stream: ``values``, their
    keys sorted stably; ``order``, each one's batch position << 2 | its
    kind, in that order. ``scratch`` (at least 16 bytes an op walked) is
    reused; ``counts``: int32[4]."""
    rc = build.load("cuckoo_mixed").cuckoo_mixed_walk_launch(
        table.data_ptr(), values.data_ptr(), order.data_ptr(),
        order.shape[0], scratch.data_ptr(), counts.data_ptr(), ok.data_ptr(),
        *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_mixed_walk")


def cuckoo_mixed_route(config: CuckooConfig, table: torch.Tensor,
                       keys: torch.Tensor, ops: torch.Tensor,
                       valid: torch.Tensor, ok: torch.Tensor) -> int:
    """The whole route on ``n >= 1`` ops: scratch, the marks and the
    once-only ops, then (only where some key repeats) the sort and the
    walk. One host sync, the compaction of the repeated ops. Returns how
    many ops the walk took (0: it launched nothing and sorted nothing)."""
    n = keys.shape[0]
    scratch = torch.empty((scratch_slots(n),), dtype=torch.int64,
                          device=keys.device)
    state = torch.empty((n,), dtype=torch.uint8, device=keys.device)
    cuckoo_mixed_launch(config, table, keys, ops, valid, scratch, ok, state)
    repeated = state.nonzero().squeeze(1)
    if repeated.numel():
        values, perm = key_order(keys, repeated)
        tagged = (repeated << 2) | (state[repeated].to(torch.int64) - 1)
        counts = torch.empty((4,), dtype=torch.int32, device=keys.device)
        cuckoo_mixed_walk_launch(config, table, values, tagged[perm], scratch,
                                 counts, ok)
    return repeated.numel()
