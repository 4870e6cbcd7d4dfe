"""The ``cuckoo``, ``bloom`` and ``cpu-cuckoo`` backends behind the
unified AMQ protocol.

Port of the ``CUCKOO``, ``BLOOM`` and ``CPU_CUCKOO`` adapters of
``repro.amq.adapters``, and of ``segmented_apply_ops``. Where the JAX
adapters run XLA code, these run the hot operations on the CUDA kernels
(``kernels/ops.py``; on CPU tensors, their plain versions).

``bloom`` (the blocked Bloom filter, append-only): insert is the Bloom
insert kernel, query the Bloom query kernel; every valid insert is ``ok``
and reports no evictions and no rounds. It has no fused mixed path: the
handle serves its op batches with :func:`segmented_apply_ops`.

``cpu-cuckoo`` is the pure-Python sequential filter on the host
(``filters/cpu_reference.py``): one op at a time, in batch order. Its
``apply_ops`` is the literal sequential replay, the oracle the fused
paths are tested against.

Each ``cuckoo`` insert entry point routes by ``core.resolve_engine(config,
bulk)``:

* ``insert`` under ``auto``, ``legacy`` or ``frontier``, and
  ``insert_bulk`` under ``legacy`` (or a forced ``frontier``): an insert
  kernel over the whole batch — the direct-insert kernel for ``insert``,
  the bucket-major bulk kernel for ``insert_bulk`` (in place of the core's
  two sorted phases). The keys it could not place (both buckets full) are
  compacted in batch order and handed to the eviction round loop; only
  ``insert_engine="frontier"`` hands ``insert``'s residue to the batched
  BFS frontier instead (the loop is the faster of the two on the card,
  PERF.md §7, and the kernel's racing placement leaves the table unlike
  the JAX adapter's either way). ``ok`` and
  ``evictions`` are scattered back to batch order. ``rounds`` is the
  engine's rounds plus the kernel pass, counted as the phases it stands
  for: one for ``insert``, two for ``insert_bulk`` (the core's primary
  and alternate phases, as there). The kernel places keys in another
  order than the core's engines, so the table differs from the JAX
  adapter's by placement (it holds the same keys; core ``insert`` is the
  bit-exact one).
* ``orientation`` (``insert_bulk``'s ``auto``): the core's
  graph-orientation build, torch ops on the table's device, as the JAX
  adapter runs the XLA core there.
* ``query``: the query kernel.
* ``delete``: the mixed-op kernel with every op a DELETE.
* ``apply_ops``: the core's per-key algebra (``core.net_effects``: each
  key's stored copies, the segmented saturating counter, the net effect
  per key), which answers every query and delete; then the net deletes
  through ``delete`` (the mixed-op kernel) and the net inserts through
  the routes above — ``insert`` where they are sparse (at most ``max(8, n
  // 8)``, as core ``apply_ops`` decides), ``insert_bulk`` over the full
  width under their mask where they are dense. The answers are core
  ``apply_ops``'s; the table holds the same keys, placed by the kernels.
  The mixed-op kernel does not answer the batch itself: its inserts are
  direct only, and a key whose direct insert failed would leave later
  queries and deletes of it in the batch unlike the sequential replay.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import cuckoo_filter as CF
from ..core.hashing import keys_to_numpy
from ..filters import blocked_bloom as BB
from ..filters import cpu_reference as PYREF
from ..kernels import ops as K
from .protocol import (
    OP_DELETE,
    OP_INSERT,
    OP_QUERY,
    Capabilities,
    DeleteReport,
    InsertReport,
    MixedReport,
    OpBatch,
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
    # (config, state, keys, ops, *, valid) -> (state', MixedReport); None:
    # the handle serves op batches with segmented_apply_ops.
    apply_ops: Optional[Callable[..., Any]] = None
    # A host backend's one device (its state is not a tensor); None: the
    # handle's device, the GPU by default.
    device: Optional[str] = None


def _cuckoo_insert(config, state, keys, *, valid=None,
                   dedup_within_batch=False, _bulk=False):
    engine = CF.resolve_engine(config, _bulk)
    if engine == "orientation":
        state, ok, stats = CF._insert_orient(
            config, state, keys, ensure_valid(keys, valid),
            dedup_within_batch=dedup_within_batch)
        return state, InsertReport(ok, stats.evictions, stats.rounds,
                                   all_routed(keys))
    # An insert kernel over the batch, then the round loop on its residue;
    # only a forced "frontier" hands insert's residue to the frontier
    # (insert_bulk's frontier is the legacy bulk build, as in JAX).
    place_residue = (CF._insert_frontier
                     if config.insert_engine == "frontier" and not _bulk
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


def _cuckoo_apply_ops(config, state, keys, ops, *, valid=None):
    n = keys.shape[0]
    dev = keys.device
    evictions = torch.zeros((n,), dtype=torch.int32, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 0:
        return state, MixedReport(torch.zeros((0,), dtype=torch.bool,
                                              device=dev),
                                  all_routed(keys), evictions, rounds)
    e = CF.net_effects(config, state, keys, ops, ensure_valid(keys, valid))
    # Net deletes first (they free slots the net inserts may take).
    del_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    dels = e.net_del.nonzero().squeeze(1)
    if dels.numel():
        state, rep = _cuckoo_delete(config, state, keys[dels])
        del_ok[dels] = rep.ok
    ins_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    ins = e.net_ins.nonzero().squeeze(1)
    if ins.numel() > max(8, n // 8):
        state, rep = _cuckoo_insert(config, state, keys, valid=e.net_ins,
                                    _bulk=True)
        ins_ok, evictions, rounds = rep.ok, rep.evictions, rep.rounds
    elif ins.numel():
        state, rep = _cuckoo_insert(config, state, keys[ins])
        ins_ok[ins] = rep.ok
        evictions[ins] = rep.evictions
        rounds = rep.rounds
    return state, MixedReport(CF.mixed_ok(e, ins_ok, del_ok),
                              all_routed(keys), evictions, rounds)


def _cuckoo_make_config(capacity, **kw):
    # Registry default: the fmix32 pair-hash, as in the JAX package (the
    # paper's xxhash64 stays available via hash_kind="xxhash64").
    kw.setdefault("hash_kind", "fmix32")
    return CF.CuckooConfig.for_capacity(capacity, **kw)


CUCKOO = AMQAdapter(
    name="cuckoo",
    capabilities=Capabilities(supports_delete=True, supports_bulk=True,
                              counting=True, supports_mixed=True),
    make_config=_cuckoo_make_config,
    init=lambda cfg, device: cfg.init(device),
    insert=_cuckoo_insert,
    insert_bulk=functools.partial(_cuckoo_insert, _bulk=True),
    query=_cuckoo_query,
    delete=_cuckoo_delete,
    apply_ops=_cuckoo_apply_ops,
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

# ---------------------------------------------------------------------------
# Pure-Python oracle (host-side; the conformance reference).
# ---------------------------------------------------------------------------

def _py_mask(keys, valid) -> np.ndarray:
    if valid is None:
        return np.ones((keys.shape[0],), bool)
    return torch.as_tensor(valid).cpu().numpy().astype(bool)


def _host(ok: np.ndarray) -> tuple:
    """(ok, zero evictions, zero rounds, all routed) as CPU tensors."""
    n = ok.shape[0]
    return (torch.from_numpy(ok), torch.zeros((n,), dtype=torch.int32),
            torch.zeros((), dtype=torch.int32),
            torch.ones((n,), dtype=torch.bool))


def _py_insert(config, state, keys, *, valid=None, dedup_within_batch=False):
    raw = keys_to_numpy(keys)
    v = _py_mask(keys, valid)
    ok = np.zeros((raw.shape[0],), bool)
    seen = set()
    for i, k in enumerate(raw.tolist()):
        if not v[i]:
            continue
        if dedup_within_batch and k in seen:
            ok[i] = ok[np.flatnonzero((raw == k) & v)[0]]
            continue
        seen.add(k)
        ok[i] = state.insert(k)
    return state, InsertReport(*_host(ok))


def _py_query(config, state, keys, *, valid=None):
    hits = state.query_batch(keys_to_numpy(keys)) & _py_mask(keys, valid)
    return state, QueryResult(torch.from_numpy(hits),
                              torch.ones((hits.shape[0],), dtype=torch.bool))


def _py_delete(config, state, keys, *, valid=None):
    raw = keys_to_numpy(keys)
    v = _py_mask(keys, valid)
    ok = np.array([v[i] and state.delete(int(k))
                   for i, k in enumerate(raw)], bool)
    return state, DeleteReport(torch.from_numpy(ok),
                               torch.ones((raw.shape[0],), dtype=torch.bool))


def _py_apply_ops(config, state, keys, ops, *, valid=None):
    """The mixed-batch *definition*: a literal sequential replay, one op
    at a time in batch order — the oracle the fused paths are held to."""
    raw = keys_to_numpy(keys)
    ops = torch.as_tensor(ops).cpu().numpy()
    v = _py_mask(keys, valid)
    n = raw.shape[0]
    ok = np.zeros((n,), bool)
    for i in range(n):
        if not v[i]:
            continue
        k = int(raw[i])
        if ops[i] == OP_QUERY:
            ok[i] = state.query(k)
        elif ops[i] == OP_INSERT:
            ok[i] = state.insert(k)
        elif ops[i] == OP_DELETE:
            ok[i] = state.delete(k)
        else:
            raise ValueError(f"unknown op code {ops[i]} at slot {i}")
    ok, evictions, rounds, routed = _host(ok)
    return state, MixedReport(ok, routed, evictions, rounds)


# The JAX adapter also sets supports_expand and supports_snapshot; the
# cascade and snapshots are later port slices (ROADMAP queue A items 12
# and 9b), so make(auto_expand="auto") gives a plain handle here.
CPU_CUCKOO = AMQAdapter(
    name="cpu-cuckoo",
    capabilities=Capabilities(supports_delete=True, counting=True,
                              serial_insert=True, supports_mixed=True),
    make_config=lambda capacity, **kw: PYREF.PyCuckooConfig.for_capacity(
        capacity, **kw),
    init=lambda cfg, device: cfg.init(),
    insert=_py_insert,
    query=_py_query,
    delete=_py_delete,
    apply_ops=_py_apply_ops,
    device="cpu",
)


# ---------------------------------------------------------------------------
# Mixed batches on a backend without a fused path (DESIGN.md §9).
# ---------------------------------------------------------------------------

def segmented_apply_ops(target, batch: OpBatch) -> MixedReport:
    """Execute an :class:`OpBatch` on any handle by segmenting it.

    The fallback behind ``FilterHandle.apply_ops`` for backends without a
    fused path: the batch is split host-side into maximal same-op runs of
    its valid slots, and each run replays the per-op entry point as one
    full-width, ``valid``-masked call. Runs execute in batch order and
    duplicates within a run already serialise inside the per-op calls,
    so same-key operations resolve in batch order. ``target`` is anything
    with the handle op surface.
    """
    ops = batch.ops.cpu().numpy()
    v = batch.valid.cpu().numpy().astype(bool)
    n = ops.shape[0]
    dev = batch.keys.device
    ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    routed = torch.ones((n,), dtype=torch.bool, device=dev)
    evictions = torch.zeros((n,), dtype=torch.int32, device=dev)
    rounds = 0

    live = np.flatnonzero(v)
    if live.size == 0:  # all padding: a no-op
        return MixedReport(ok, routed, evictions,
                           torch.tensor(rounds, dtype=torch.int32, device=dev))
    if ((ops[live] == OP_DELETE).any()
            and not target.capabilities.supports_delete):
        raise NotImplementedError(
            f"{target.name}: mixed batch contains deletes but the backend "
            "is append-only (capabilities.supports_delete is False)")
    o = ops[live]
    bounds = np.flatnonzero(np.diff(o) != 0) + 1
    for s, e in zip(np.concatenate([[0], bounds]),
                    np.concatenate([bounds, [o.size]])):
        mask_np = np.zeros((n,), bool)
        mask_np[live[s:e]] = True
        mask = torch.from_numpy(mask_np).to(dev)
        if o[s] == OP_QUERY:
            r = target.query(batch.keys, valid=mask)
            r_ok = r.hits
        elif o[s] == OP_INSERT:
            r = target.insert(batch.keys, valid=mask)
            r_ok = r.ok
            evictions = torch.where(mask, r.evictions.to(dev), evictions)
            rounds += int(r.rounds)
        else:
            r = target.delete(batch.keys, valid=mask)
            r_ok = r.ok
        ok = torch.where(mask, r_ok.to(dev), ok)
        routed = torch.where(mask, r.routed.to(dev), routed)
    return MixedReport(ok, routed, evictions,
                       torch.tensor(rounds, dtype=torch.int32, device=dev))


DEFAULT_ADAPTERS = {CUCKOO.name: CUCKOO, BLOOM.name: BLOOM,
                    CPU_CUCKOO.name: CPU_CUCKOO}
