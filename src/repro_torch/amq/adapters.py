"""The ``cuckoo`` and ``bloom`` backends behind the unified AMQ protocol.

Port of the ``CUCKOO`` and ``BLOOM`` adapters of ``repro.amq.adapters``.
Where the JAX adapters run XLA code, these run the hot operations on the
CUDA kernels (``kernels/ops.py``; on CPU tensors, their plain versions).

``bloom`` (the blocked Bloom filter, append-only): insert is the Bloom
insert kernel, query the Bloom query kernel; every valid insert is ``ok``
and reports no evictions and no rounds.

Each ``cuckoo`` insert entry point routes by ``core.resolve_engine(config,
bulk)``:

* ``frontier`` (``insert``'s ``auto`` under BFS eviction) and ``legacy``:
  an insert kernel over the whole batch — the direct-insert kernel for
  ``insert``, the bucket-major bulk kernel for ``insert_bulk`` (in place
  of the core's two sorted phases). The keys it could not place (both
  buckets full) are compacted in batch order and handed to the core's
  engine: the batched BFS frontier (``insert`` under ``frontier``) or the
  eviction round loop. ``ok`` and ``evictions`` are scattered back to
  batch order. ``rounds`` is the engine's rounds plus the kernel pass,
  counted as the phases it stands for: one for ``insert``, two for
  ``insert_bulk`` (the core's primary and alternate phases, as there).
  The kernel places keys in another order than the core's engines, so
  the table differs from the JAX adapter's by placement (it holds the
  same keys; core ``insert`` is the bit-exact one).
* ``orientation`` (``insert_bulk``'s ``auto``): the core's
  graph-orientation build, torch ops on the table's device, as the JAX
  adapter runs the XLA core there.
* ``query``: the query kernel.
* ``delete``: the mixed-op kernel with every op a DELETE.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from ..core import cuckoo_filter as CF
from ..filters import blocked_bloom as BB
from ..kernels import ops as K
from .protocol import (
    OP_DELETE,
    Capabilities,
    DeleteReport,
    InsertReport,
    QueryResult,
    all_routed,
    ensure_valid,
)


@dataclasses.dataclass(frozen=True)
class AMQAdapter:
    """One backend behind the AMQ protocol (plain callables, no state)."""

    name: str
    capabilities: Capabilities
    make_config: Callable[..., Any]      # (capacity, **kw) -> config
    init: Callable[..., Any]             # (config, device) -> fresh state
    insert: Callable[..., Any]
    query: Callable[..., Any]
    delete: Optional[Callable[..., Any]] = None
    insert_bulk: Optional[Callable[..., Any]] = None


def _cuckoo_insert(config, state, keys, *, valid=None,
                   dedup_within_batch=False, _bulk=False):
    engine = CF.resolve_engine(config, _bulk)
    if engine == "orientation":
        state, ok, stats = CF._insert_orient(
            config, state, keys, ensure_valid(keys, valid),
            dedup_within_batch=dedup_within_batch)
        return state, InsertReport(ok, stats.evictions, stats.rounds,
                                   all_routed(keys))
    # legacy / frontier: an insert kernel over the batch, the engine on its
    # residue (insert_bulk's frontier is the legacy bulk build, as in JAX).
    place_residue = (CF._insert_frontier if engine == "frontier" and not _bulk
                     else CF._insert_rounds)
    kernel = K.cuckoo_insert_bulk if _bulk else K.cuckoo_insert_direct
    n = keys.shape[0]
    valid0 = ensure_valid(keys, valid)
    pending = valid0
    if dedup_within_batch:
        first, rep = CF._batch_dedup(keys, valid0)
        pending = pending & first
    state, ok = kernel(config, state, keys, valid=pending)
    evictions = torch.zeros((n,), dtype=torch.int32, device=keys.device)
    rounds = torch.full((), 2 if _bulk else 1, dtype=torch.int32,
                        device=keys.device)
    residue = (pending & ~ok).nonzero().squeeze(1)
    if residue.numel():
        state, ok_res, stats = place_residue(config, state, keys[residue])
        ok[residue] = ok_res
        evictions[residue] = stats.evictions
        rounds = rounds + stats.rounds
    if dedup_within_batch:
        ok = torch.where(first, ok, ok[rep] & valid0)
    return state, InsertReport(ok, evictions, rounds, all_routed(keys))


def _cuckoo_query(config, state, keys, *, valid=None):
    hits = K.cuckoo_query(config, state, keys) & ensure_valid(keys, valid)
    return state, QueryResult(hits, all_routed(keys))


def _cuckoo_delete(config, state, keys, *, valid=None):
    ops = torch.full((keys.shape[0],), OP_DELETE, dtype=torch.int32,
                     device=keys.device)
    state, ok = K.cuckoo_apply_ops(config, state, keys, ops,
                                   ensure_valid(keys, valid))
    return state, DeleteReport(ok, all_routed(keys))


def _cuckoo_make_config(capacity, **kw):
    # Registry default: the fmix32 pair-hash, as in the JAX package (the
    # paper's xxhash64 stays available via hash_kind="xxhash64").
    kw.setdefault("hash_kind", "fmix32")
    return CF.CuckooConfig.for_capacity(capacity, **kw)


CUCKOO = AMQAdapter(
    name="cuckoo",
    capabilities=Capabilities(supports_delete=True, supports_bulk=True,
                              counting=True),
    make_config=_cuckoo_make_config,
    init=lambda cfg, device: cfg.init(device),
    insert=_cuckoo_insert,
    insert_bulk=functools.partial(_cuckoo_insert, _bulk=True),
    query=_cuckoo_query,
    delete=_cuckoo_delete,
)


def _bloom_insert(config, state, keys, *, valid=None,
                  dedup_within_batch=False):
    del dedup_within_batch  # idempotent by construction
    state, ok = K.bloom_insert(config, state, keys, ensure_valid(keys, valid))
    n = keys.shape[0]
    return state, InsertReport(
        ok, torch.zeros((n,), dtype=torch.int32, device=keys.device),
        torch.zeros((), dtype=torch.int32, device=keys.device),
        all_routed(keys))


def _bloom_query(config, state, keys, *, valid=None):
    hits = K.bloom_query(config, state, keys) & ensure_valid(keys, valid)
    return state, QueryResult(hits, all_routed(keys))


BLOOM = AMQAdapter(
    name="bloom",
    capabilities=Capabilities(supports_delete=False, counting=False),
    make_config=lambda capacity, **kw: BB.BloomConfig.for_capacity(
        capacity, **kw),
    init=lambda cfg, device: cfg.init(device),
    insert=_bloom_insert,
    query=_bloom_query,
)

DEFAULT_ADAPTERS = {CUCKOO.name: CUCKOO, BLOOM.name: BLOOM}
