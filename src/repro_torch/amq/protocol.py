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
of tensors. The lifecycle types (cascade and tier reports, versioned
snapshots and their ``.npz`` files) are the JAX package's: a snapshot's
arrays are numpy in the same names and dtypes, so a file written by
either package restores on the other.

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

    Same fields and defaults as the JAX package. ``supports_expand``: the
    backend stacks into an auto-expanding cascade (``amq/cascade.py``);
    ``supports_snapshot``: its state round-trips through a versioned
    host-side :class:`Snapshot`; ``supports_tiering``: frozen levels can
    live in host RAM as snapshot arrays and still answer queries
    (``amq/tiering.py``).
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


# ---------------------------------------------------------------------------
# Cascade (auto-expansion) and tier reporting — host-side introspection.
# ---------------------------------------------------------------------------

class LevelStats(NamedTuple):
    """One cascade level (host-side Python values).

    ``fpr_share`` is the slice of the cascade's FPR budget this level was
    sized against (DESIGN.md §8); ``expected_fpr`` is the level's analytic
    FPR at its current load.
    """

    level: int
    num_slots: int
    count: int
    load_factor: float
    table_bytes: int
    expected_fpr: float
    fpr_share: float


class CascadeReport(NamedTuple):
    """Aggregate view of an auto-expanding cascade (DESIGN.md §8).

    ``expected_fpr`` is ``1 - prod(1 - eps_i)`` over live levels; the
    cascade keeps it under ``fpr_budget`` whenever every level met its
    share.
    """

    levels: tuple
    num_slots: int
    table_bytes: int
    count: int
    load_factor: float
    expected_fpr: float
    fpr_budget: float

    @property
    def num_levels(self) -> int:
        """Number of live levels in the cascade."""
        return len(self.levels)


class TierStats(NamedTuple):
    """One level of a tiered handle, annotated with its residency.

    ``residency`` is ``"hot"`` (on the device, write-absorbing) or
    ``"cold"`` (frozen in host RAM as snapshot arrays — DESIGN.md §12).
    Cold levels carry strictly smaller ``alloc_index`` values than hot
    ones (demotion is oldest-first).
    """

    residency: str
    alloc_index: int
    num_slots: int
    count: int
    load_factor: float
    table_bytes: int
    expected_fpr: float
    fpr_share: float


class TieredReport(NamedTuple):
    """Aggregate view of a GPU-hot / host-cold tiered handle (DESIGN.md §12).

    ``device_bytes`` counts the hot levels only (what the handle keeps
    under ``device_budget_bytes``); ``host_bytes`` is the cold tier's
    footprint. ``expected_fpr`` aggregates all levels: a query consults
    both tiers.
    """

    levels: tuple
    device_budget_bytes: int
    device_bytes: int
    host_bytes: int
    count: int
    expected_fpr: float
    fpr_budget: float
    demotions: int
    promotions: int
    cold_probes: int
    cold_hits: int

    @property
    def hot_levels(self) -> tuple:
        """The device-resident subset of ``levels``."""
        return tuple(s for s in self.levels if s.residency == "hot")

    @property
    def cold_levels(self) -> tuple:
        """The host-RAM subset of ``levels``."""
        return tuple(s for s in self.levels if s.residency == "cold")


def fpr_share(budget: float, level: int, ratio: float = 0.5) -> float:
    """Geometric FPR-budget split: level ``i`` gets ``budget*(1-r)*r^i``.

    The shares of an infinite cascade sum to ``budget`` (Bender et al.
    §3), so the aggregate analytic FPR stays under it however many levels
    an insert stream provokes.
    """
    if not 0.0 < ratio < 1.0:
        raise ValueError(f"fpr split ratio must be in (0, 1), got {ratio}")
    return budget * (1.0 - ratio) * ratio ** level


# ---------------------------------------------------------------------------
# Filter-state lifecycle: versioned host-side snapshots (DESIGN.md §10).
# ---------------------------------------------------------------------------

SNAPSHOT_VERSION = 1
"""Format version stamped into every :class:`Snapshot` (and snapshot file);
``restore`` refuses newer versions instead of misreading them."""


class SnapshotMismatchError(ValueError):
    """A snapshot does not fit its restore target: backend names, config
    fingerprints, format versions or array shapes/dtypes disagree."""


class Snapshot(NamedTuple):
    """Versioned host-side filter-state payload (DESIGN.md §10).

    * ``backend`` — registry name of the producing backend.
    * ``kind`` — ``"filter"``, ``"cascade"`` or ``"tiered"``.
    * ``fingerprint`` — the producing config's identity string
      (``repr(config)``); cascade and tiered snapshots keep per-level
      fingerprints in ``meta`` instead.
    * ``arrays`` — ``name -> numpy array``, the packed state on the host
      (cascade levels prefix names with ``level<i>/``).
    * ``meta`` — JSON-able descriptive payload (counts, level shares, ...).
    * ``configs`` — the in-memory configs the snapshot was taken under
      (empty for file-loaded snapshots, which restore onto a config the
      caller builds, after the fingerprint check).
    * ``version`` — :data:`SNAPSHOT_VERSION` at creation time.
    """

    backend: str
    kind: str
    fingerprint: str
    arrays: dict
    meta: dict
    configs: tuple = ()
    version: int = SNAPSHOT_VERSION

    @property
    def nbytes(self) -> int:
        """Total host-side payload size in bytes."""
        return int(sum(a.nbytes for a in self.arrays.values()))


def save_snapshot(path, snap: Snapshot) -> None:
    """Persist a snapshot as an ``.npz`` (arrays + a JSON header); the
    in-memory ``configs`` are not written (a file restore rebuilds them
    from code and checks the fingerprints)."""
    import json

    header = {"version": snap.version, "backend": snap.backend,
              "kind": snap.kind, "fingerprint": snap.fingerprint,
              "meta": snap.meta}
    np.savez(path, __header__=np.frombuffer(
        json.dumps(header).encode(), np.uint8),
        **{k: np.asarray(v) for k, v in snap.arrays.items()})


def load_snapshot(path) -> Snapshot:
    """Load a snapshot written by :func:`save_snapshot` (no ``configs``;
    restore it through a handle built with the matching config)."""
    import json

    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    if header["version"] > SNAPSHOT_VERSION:
        raise SnapshotMismatchError(
            f"snapshot format v{header['version']} is newer than this "
            f"library's v{SNAPSHOT_VERSION}; refusing to guess its layout")
    return Snapshot(header["backend"], header["kind"],
                    header["fingerprint"], arrays, header["meta"],
                    (), header["version"])
