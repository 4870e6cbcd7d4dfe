"""FilterHandle: the one stateful object every consumer programs against.

Port of ``repro.amq.handle.FilterHandle``: insert, query, delete, mixed
op batches (``apply_ops``), count, load factor, table bytes, expected FPR
and the lifecycle (``snapshot`` / ``restore`` / ``from_snapshot``,
DESIGN.md §10). The handle owns ``(adapter, config, state)`` on one
device; keys and op batches are moved onto that device.
"""

from __future__ import annotations

from typing import Any, Optional

from ..core.device import resolve_device
from ..core.hashing import normalize_keys
from .adapters import AMQAdapter, config_fingerprint, segmented_apply_ops
from .protocol import (
    Capabilities,
    DeleteReport,
    InsertReport,
    MixedReport,
    OpBatch,
    QueryResult,
    Snapshot,
    SnapshotMismatchError,
    load_factor as _load_factor,
    stored_count,
)


def handle_device(adapter: AMQAdapter, device=None, state=None,
                  config=None):
    """The device a handle of ``adapter`` runs on.

    A host backend (``adapter.device``) always runs on its own device; a
    config that places its state (``adapter.config_device``: the sharded
    backend's mesh) fixes the device to its own; a given state fixes it to
    its tensors'; else ``device``, the GPU by default (raising when there
    is none). A conflicting ``device`` raises ``ValueError``.
    """
    if adapter.config_device is not None and config is not None:
        where = adapter.config_device(config)
        if device is not None and resolve_device(device) != where:
            raise ValueError(f"{adapter.name}: the config places its state "
                             f"on {where}, not on device={device!r}")
        device = where
    if adapter.device is not None:
        if device is not None and resolve_device(device) != resolve_device(
                adapter.device):
            raise ValueError(f"{adapter.name} runs on {adapter.device}, "
                             f"not on device={device!r}")
        device = adapter.device
    elif state is not None:
        where = state[0].device   # every field of a state on one device
        if device is not None and resolve_device(device) != where:
            raise ValueError(f"state lives on {where}, not "
                             f"on device={device!r}")
        device = where
    return resolve_device(device)


def _check_snapshot_target(adapter: AMQAdapter, config: Any,
                           snap: Snapshot) -> None:
    """Validate that ``snap`` may restore onto (adapter, config) — loudly."""
    if snap.kind != "filter":
        raise SnapshotMismatchError(
            f"cannot restore a {snap.kind!r} snapshot onto a static "
            "FilterHandle (cascade snapshots restore onto cascades)")
    if snap.backend != adapter.name:
        raise SnapshotMismatchError(
            f"snapshot is from backend {snap.backend!r}, "
            f"this handle is {adapter.name!r}")
    fp = config_fingerprint(adapter, config)
    if snap.fingerprint != fp:
        raise SnapshotMismatchError(
            f"config fingerprint mismatch:\n  snapshot: "
            f"{snap.fingerprint}\n  target:   {fp}")


class FilterHandle:
    """Stateful AMQ handle with capability-driven, uniform ops.

    Obtain via :func:`repro_torch.amq.make`. Ops take raw ``uint64[n]``
    keys (numpy or Python ints), ``int64[n]`` key tensors, or ``int32[n,
    2]`` (lo, hi) tensors, and return the protocol's reports as tensors on
    the handle's device.
    """

    def __init__(self, adapter: AMQAdapter, config: Any, state: Any = None,
                 device=None):
        """Wrap (adapter, config, state); a fresh state is built if None.

        ``device`` defaults to the state's device, else the GPU (raising
        when there is none — pass ``device="cpu"`` for the plain versions).
        A host backend (``adapter.device``) always runs on its own device.
        """
        self.device = handle_device(adapter, device, state, config)
        self.adapter = adapter
        self.config = config
        self.state = adapter.init(config, self.device) if state is None else state

    # -- introspection -------------------------------------------------------

    @property
    def name(self) -> str:
        """Registry name of the wrapped backend (e.g. ``"cuckoo"``)."""
        return self.adapter.name

    @property
    def capabilities(self) -> Capabilities:
        """The backend's capability flags — branch on these, not on names."""
        return self.adapter.capabilities

    @property
    def load_factor(self) -> float:
        """Current occupancy: stored keys / nominal capacity."""
        return _load_factor(self.config, self.state)

    @property
    def table_bytes(self) -> int:
        """Device memory footprint of the filter state."""
        return self.config.table_bytes

    def expected_fpr(self, load_factor: Optional[float] = None) -> float:
        """Analytic FPR at ``load_factor`` (default: current occupancy)."""
        lf = self.load_factor if load_factor is None else load_factor
        return self.config.expected_fpr(lf)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        """Summarize backend, size, device and capabilities."""
        return (f"FilterHandle({self.adapter.name!r}, "
                f"slots={self.config.num_slots}, "
                f"bytes={self.config.table_bytes}, device={self.device}, "
                f"caps={self.adapter.capabilities})")

    # -- ops -----------------------------------------------------------------

    def _keys(self, keys):
        return normalize_keys(keys, device=self.device)

    def insert(self, keys, *, bulk: bool = False,
               dedup_within_batch: bool = False,
               valid=None) -> InsertReport:
        """Insert a batch of keys.

        ``bulk=True`` takes the backend's bulk path (requires
        ``supports_bulk``); ``dedup_within_batch`` degrades the batch to
        set semantics; ``valid`` masks caller padding.
        """
        op = self.adapter.insert
        if bulk:
            if not self.adapter.capabilities.supports_bulk:
                raise NotImplementedError(
                    f"{self.name}: no bulk-build path "
                    "(capabilities.supports_bulk is False)")
            op = self.adapter.insert_bulk
        self.state, report = op(self.config, self.state, self._keys(keys),
                                valid=valid,
                                dedup_within_batch=dedup_within_batch)
        return report

    def query(self, keys, *, valid=None) -> QueryResult:
        """Batch membership: no false negatives, FPR-bounded positives."""
        _, result = self.adapter.query(self.config, self.state,
                                       self._keys(keys), valid=valid)
        return result

    def delete(self, keys, *, valid=None) -> DeleteReport:
        """Remove one stored copy per key (requires ``supports_delete``)."""
        if not self.adapter.capabilities.supports_delete:
            raise NotImplementedError(
                f"{self.name}: append-only structure "
                "(capabilities.supports_delete is False)")
        self.state, report = self.adapter.delete(
            self.config, self.state, self._keys(keys), valid=valid)
        return report

    def apply_ops(self, batch: OpBatch) -> MixedReport:
        """Execute an interleaved query/insert/delete stream (one OpBatch).

        Backends with a fused path (``adapter.apply_ops``: ``cuckoo``,
        ``cpu-cuckoo``) run the batch as one pass; every other backend is
        served by :func:`repro_torch.amq.adapters.segmented_apply_ops`
        (one call per maximal same-op run). Same-key operations resolve in
        batch order either way (DESIGN.md §9). The batch is moved onto the
        handle's device.
        """
        if not isinstance(batch, OpBatch):
            raise TypeError(f"apply_ops takes an OpBatch (OpBatch.make), "
                            f"got {type(batch).__name__}")
        batch = batch.to(self.device)
        if self.adapter.apply_ops is None:
            return segmented_apply_ops(self, batch)
        self.state, report = self.adapter.apply_ops(
            self.config, self.state, batch.keys, batch.ops, valid=batch.valid)
        return report

    def count(self) -> int:
        """Stored-key count."""
        return stored_count(self.state)

    # -- lifecycle (DESIGN.md §10) -------------------------------------------

    @property
    def fingerprint(self) -> str:
        """This handle's config-identity string (snapshot compatibility)."""
        return config_fingerprint(self.adapter, self.config)

    def snapshot(self) -> Snapshot:
        """Pull the filter state to the host as a versioned :class:`Snapshot`.

        On the GPU the table crosses in one device-to-host copy; the
        arrays own their memory, so later ops on this handle leave the
        snapshot as it was. It restores onto any handle whose config
        fingerprint matches (in this package or the JAX package, also
        through :func:`~repro_torch.amq.save_snapshot`'s files) and feeds
        :meth:`repro_torch.amq.FilterService.hot_swap`.
        """
        if not self.adapter.capabilities.supports_snapshot:
            raise NotImplementedError(
                f"{self.name}: state cannot be snapshotted "
                "(capabilities.supports_snapshot is False)")
        arrays = self.adapter.snapshot(self.config, self.state)
        return Snapshot(
            backend=self.name, kind="filter", fingerprint=self.fingerprint,
            arrays=arrays,
            meta={"count": self.count(),
                  "num_slots": int(self.config.num_slots),
                  "table_bytes": int(self.config.table_bytes)},
            configs=(self.config,))

    def restore(self, snap: Snapshot) -> "FilterHandle":
        """Replace this handle's state with a snapshot's — validated.

        The snapshot must come from the same backend and a config with an
        identical fingerprint; anything else raises
        :class:`~repro_torch.amq.protocol.SnapshotMismatchError`. The
        restored table owns its memory (one host-to-device copy on the
        GPU). Returns ``self``.
        """
        _check_snapshot_target(self.adapter, self.config, snap)
        self.state = self.adapter.restore(self.config, snap.arrays,
                                          self.device)
        return self

    @classmethod
    def from_snapshot(cls, adapter: AMQAdapter, config: Any, snap: Snapshot,
                      device=None) -> "FilterHandle":
        """A handle whose initial state is the snapshot's: ``FilterHandle(
        adapter, config, device=device).restore(snap)`` without building a
        zero table first."""
        _check_snapshot_target(adapter, config, snap)
        device = handle_device(adapter, device, config=config)
        return cls(adapter, config, adapter.restore(config, snap.arrays,
                                                    device))

    def resharded(self, num_shards: Optional[int] = None,
                  **kw) -> "FilterHandle":
        """Exact reshard: the same filter on another shard layout.

        Only for backends whose config has a ``resharded`` hook (the
        mesh-sharded cuckoo filter): returns a *new* handle whose state
        holds the same partitions over ``num_shards`` shards (or an
        explicit ``mesh=``), every word moved verbatim and every answer
        the same — the config fingerprint excludes placement, so the
        snapshot round trip is legal by construction (DESIGN.md §10).

            >>> h2 = h.resharded(num_shards=2)     # K -> K' migration
            >>> svc.hot_swap(h2)                   # and into service
        """
        hook = getattr(self.config, "resharded", None)
        if hook is None:
            raise NotImplementedError(
                f"{self.name}: backend config has no resharding surface "
                "(only mesh-sharded backends relocate partitions)")
        return FilterHandle.from_snapshot(
            self.adapter, hook(num_shards, **kw), self.snapshot())
