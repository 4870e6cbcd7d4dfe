"""The AMQ protocol subset the port's ``cuckoo`` and ``bloom`` backends need.

Port of the result types, capability model and helpers of
``repro.amq.protocol``:

    insert / insert_bulk :: (config, state, keys, *, opts) -> (state', InsertReport)
    query                :: (config, state, keys, *, opts) -> (state,  QueryResult)
    delete               :: (config, state, keys, *, opts) -> (state', DeleteReport)
    apply_ops            :: (config, state, keys, ops, *, valid) -> (state', MixedReport)

``keys`` are ``int32[n, 2]`` tensors holding (lo, hi) uint32 pairs
(``repro_torch.core.hashing.normalize_keys``). Results are tuples of
tensors on the keys' device. A mixed batch travels as an :class:`OpBatch`
of tensors. Snapshots, cascades and tiering come with later port slices.

This module imports only torch and numpy (and, inside ``OpBatch``'s
constructors, the port's key normalization), so every other module may
import it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can do — consumers branch on these, never on names.

    Same fields and defaults as the JAX package. The port's ``cuckoo``
    backend sets ``supports_expand``, ``supports_snapshot`` and
    ``supports_tiering`` to False: those surfaces are ported by later
    slices.
    """

    supports_delete: bool = True
    supports_bulk: bool = False
    supports_sharding: bool = False
    counting: bool = True
    exact: bool = False
    serial_insert: bool = False
    supports_expand: bool = False
    supports_mixed: bool = False
    supports_snapshot: bool = False
    supports_tiering: bool = False


# Per-key op codes (int32), as in the JAX package.
OP_QUERY = 0
OP_INSERT = 1
OP_DELETE = 2

OP_NAMES = {OP_QUERY: "query", OP_INSERT: "insert", OP_DELETE: "delete"}


def normalize_ops(ops, n: int, *, arg: str = "ops") -> torch.Tensor:
    """Validate an op-code channel against its ``n``-key batch.

    Integer dtype (bool is refused: a hits or valid mask passed as ops
    would otherwise become QUERY/INSERT codes), length ``n``, codes in
    ``{OP_QUERY, OP_INSERT, OP_DELETE}``, range-checked in the original
    dtype so that out-of-range values cannot wrap onto valid codes.
    Returns int32[n] on the input's device (the CPU for host input).
    Raises ``ValueError`` naming ``arg``.
    """
    if isinstance(ops, torch.Tensor):
        bad_dtype = (ops.dtype == torch.bool or ops.dtype.is_floating_point
                     or ops.dtype.is_complex)
        arr = ops
    else:
        arr = np.asarray(ops)
        bad_dtype = (arr.dtype == object
                     or not np.issubdtype(arr.dtype, np.integer))
    if bad_dtype:
        raise ValueError(
            f"{arg}: expected integer op codes, got dtype {arr.dtype}")
    if tuple(arr.shape) != (n,):
        raise ValueError(
            f"{arg}: shape {tuple(arr.shape)} — expected ({n},), one op "
            f"code per key")
    out_of_range = (arr < OP_QUERY) | (arr > OP_DELETE)
    if arr.shape[0] and bool(out_of_range.any()):
        bad = arr[out_of_range][0]
        raise ValueError(
            f"{arg}: unknown op code {int(bad)} (valid codes: "
            f"{OP_QUERY}=query, {OP_INSERT}=insert, {OP_DELETE}=delete)")
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.int32).contiguous()
    return torch.from_numpy(arr.astype(np.int32))


class InsertReport(NamedTuple):
    """Uniform insertion result.

    * ``ok`` — bool[n]; False means the structure was too full for that key.
    * ``evictions`` — int32[n] eviction-chain length.
    * ``rounds`` — int32[] rounds the batch ran (the kernel pass counts one).
    * ``routed`` — bool[n]; all True for unsharded backends.
    """

    ok: torch.Tensor
    evictions: torch.Tensor
    rounds: torch.Tensor
    routed: torch.Tensor


class QueryResult(NamedTuple):
    """Uniform membership-query result (``hits`` valid where ``routed``)."""

    hits: torch.Tensor
    routed: torch.Tensor


class DeleteReport(NamedTuple):
    """Uniform deletion result (``ok`` = a stored copy was removed)."""

    ok: torch.Tensor
    routed: torch.Tensor


class OpBatch(NamedTuple):
    """A mixed stream of filter operations — the unit of fused execution.

    * ``keys``  — int32[n, 2] (lo, hi) key pairs, like every other op.
    * ``ops``   — int32[n] op codes (:data:`OP_QUERY` / :data:`OP_INSERT` /
      :data:`OP_DELETE`).
    * ``valid`` — bool[n]; False marks padding slots.

    Semantics are positional: operations on the same 64-bit key resolve in
    batch order (a query at index i observes exactly the inserts and
    deletes of that key at indices j < i — DESIGN.md §9). The three
    tensors live on one device; ``FilterHandle.apply_ops`` moves a batch
    onto the handle's device (:meth:`to`).
    """

    keys: torch.Tensor
    ops: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def make(keys, ops, valid=None, *, device=None) -> "OpBatch":
        """Normalize (keys, ops[, valid]) into a well-typed batch.

        ``keys`` may be raw ``uint64[n]`` or packed ``[n, 2]`` pairs (see
        ``repro_torch.core.hashing.normalize_keys``); ``ops`` integer op
        codes; ``valid`` a bool-like ``[n]`` mask. The batch lives on
        ``device`` (default: where ``keys`` live; the CPU for host
        input). Malformed arguments raise ``ValueError`` naming the
        offending argument.
        """
        from ..core.hashing import normalize_keys

        keys = normalize_keys(keys, device=device, arg="keys")
        ops = normalize_ops(ops, keys.shape[0]).to(keys.device)
        return OpBatch(keys, ops, ensure_valid(keys, valid))

    @staticmethod
    def make_padded(keys, ops, n: int, *, device=None) -> "OpBatch":
        """An ``n``-slot batch: ``make(keys, ops).pad_to(n)``."""
        return OpBatch.make(keys, ops, device=device).pad_to(n)

    @property
    def size(self) -> int:
        """Number of slots in the batch (including padding)."""
        return self.keys.shape[0]

    def pad_to(self, n: int) -> "OpBatch":
        """Pad with invalid query slots up to ``n`` (static-shape batching)."""
        pad = n - self.size
        if pad < 0:
            raise ValueError(f"batch of {self.size} cannot pad to {n}")
        if pad == 0:
            return self
        dev = self.keys.device
        return OpBatch(
            torch.cat([self.keys, torch.zeros((pad, 2), dtype=torch.int32,
                                              device=dev)]),
            torch.cat([self.ops, torch.full((pad,), OP_QUERY,
                                            dtype=torch.int32, device=dev)]),
            torch.cat([self.valid, torch.zeros((pad,), dtype=torch.bool,
                                               device=dev)]))

    def to(self, device) -> "OpBatch":
        """The same batch on ``device``."""
        return OpBatch(*(t.to(device) for t in self))


class MixedReport(NamedTuple):
    """Result of executing an :class:`OpBatch` (one slot per operation).

    * ``ok`` — bool[n], interpreted by that slot's op code: query → hit,
      insert → landed, delete → a stored copy was removed. False on padding
      (invalid) slots.
    * ``routed`` — bool[n]; ``ok`` is only meaningful where ``routed``.
    * ``evictions`` — int32[n] eviction-chain lengths (insert slots only).
    * ``rounds`` — int32[] total rounds the batch's inserts ran.

    The per-op views slice this into the standard report types with
    op-masked ``routed``: a slot outside the view's op reports
    ``routed=False`` there.
    """

    ok: torch.Tensor
    routed: torch.Tensor
    evictions: torch.Tensor
    rounds: torch.Tensor

    def _view(self, batch: OpBatch, code: int):
        mask = batch.valid & (batch.ops == code)
        return self.ok & mask, self.routed & mask

    def insert_report(self, batch: OpBatch) -> InsertReport:
        """Sub-report for the batch's insert slots (routed-masked)."""
        ok, routed = self._view(batch, OP_INSERT)
        return InsertReport(ok, self.evictions, self.rounds, routed)

    def query_result(self, batch: OpBatch) -> QueryResult:
        """Sub-report for the batch's query slots (routed-masked)."""
        hits, routed = self._view(batch, OP_QUERY)
        return QueryResult(hits, routed)

    def delete_report(self, batch: OpBatch) -> DeleteReport:
        """Sub-report for the batch's delete slots (routed-masked)."""
        ok, routed = self._view(batch, OP_DELETE)
        return DeleteReport(ok, routed)


def stored_count(state) -> int:
    """A state's stored-key count (a tensor, or the host oracle's int)."""
    count = state.count
    return int(count.sum()) if isinstance(count, torch.Tensor) else int(count)


def load_factor(config, state) -> float:
    """Uniform occupancy: stored keys / nominal capacity."""
    return stored_count(state) / config.num_slots


def all_routed(keys: torch.Tensor) -> torch.Tensor:
    """The trivial ``routed`` mask for unsharded backends."""
    return torch.ones((keys.shape[0],), dtype=torch.bool, device=keys.device)


def ensure_valid(keys: torch.Tensor, valid: Optional[object]) -> torch.Tensor:
    """Normalize an optional validity mask to a bool[n] on the keys' device."""
    if valid is None:
        return all_routed(keys)
    valid = torch.as_tensor(valid, device=keys.device).to(torch.bool)
    if tuple(valid.shape) != (keys.shape[0],):
        raise ValueError(f"valid: shape {list(valid.shape)} does not match "
                         f"{keys.shape[0]} keys (want a bool[n] mask)")
    return valid.contiguous()


def fpr_tolerance(expected: float, n_probes: int,
                  factor: float = 5.0) -> tuple:
    """Acceptance band ``(lo, hi)`` for an empirically measured FPR.

    The analytic formulas are asymptotic, hence the multiplicative
    ``factor``; the additive slack keeps a few stray hits from failing
    low-FPR structures, and the lower bound only applies when the model
    predicts enough hits to rise above counting noise. Exact structures
    get (0, 0).
    """
    if expected == 0.0:
        return 0.0, 0.0
    hi = factor * expected + 8.0 / n_probes
    lo = expected / factor if expected * n_probes >= 30 else 0.0
    return lo, hi
