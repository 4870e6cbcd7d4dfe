"""FilterHandle: the one stateful object every consumer programs against.

Port of ``repro.amq.handle.FilterHandle``: insert, query, delete, mixed
op batches (``apply_ops``), count, load factor, table bytes and expected
FPR. The handle owns ``(adapter, config, state)`` on one device; keys and
op batches are moved onto that device. Snapshots are ROADMAP queue A
item 9b and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional

from ..core.device import resolve_device
from ..core.hashing import normalize_keys
from .adapters import AMQAdapter, segmented_apply_ops
from .protocol import (
    Capabilities,
    DeleteReport,
    InsertReport,
    MixedReport,
    OpBatch,
    QueryResult,
    load_factor as _load_factor,
    stored_count,
)


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({slice_name})")


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
        if adapter.device is not None:
            if device is not None and resolve_device(device) != resolve_device(
                    adapter.device):
                raise ValueError(f"{adapter.name} runs on {adapter.device}, "
                                 f"not on device={device!r}")
            device = adapter.device
        elif state is not None:
            if device is not None and resolve_device(device) != state.table.device:
                raise ValueError(f"state lives on {state.table.device}, not "
                                 f"on device={device!r}")
            device = state.table.device
        self.device = resolve_device(device)
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

    # -- later port slices ---------------------------------------------------

    def snapshot(self):
        """Snapshots: ROADMAP queue A item 9b (``Snapshot``,
        ``save_snapshot``)."""
        raise _not_ported("FilterHandle.snapshot",
                          "ROADMAP queue A item 9b (snapshots)")

    def restore(self, snap):
        """Snapshots: ROADMAP queue A item 9b."""
        raise _not_ported("FilterHandle.restore",
                          "ROADMAP queue A item 9b (snapshots)")
