"""Unified AMQ API of the port: one protocol, one registry.

    from repro_torch import amq

    h = amq.make("cuckoo", capacity=1_000_000)    # device="cpu" for the CPU
    amq.names()    # cuckoo, bloom, tcf, gqf, bcht, sharded-cuckoo, cpu-cuckoo
    h.insert(keys, bulk=True)            # -> InsertReport(ok, evictions, ...)
    h.query(keys).hits                   # -> bool[n]
    h.delete(keys)
    h.apply_ops(amq.OpBatch.make(keys, ops))   # -> MixedReport(ok, ...)
    svc = amq.FilterService(h, batch_size=64)  # micro-batched op streams
    c = amq.make("cuckoo", capacity=1 << 20, auto_expand=True)  # a cascade
    amq.save_snapshot("f.npz", h.snapshot())   # restores in either package

Only :mod:`.protocol` is imported eagerly; the registry, its adapter and
the service, which import the kernels, load on first use so that
``repro_torch.core`` and ``repro_torch.kernels`` can import the protocol
without a cycle.
"""

from .protocol import (  # noqa: F401
    OP_DELETE,
    OP_INSERT,
    OP_QUERY,
    SNAPSHOT_VERSION,
    Capabilities,
    CascadeReport,
    DeleteReport,
    InsertReport,
    LevelStats,
    MixedReport,
    OpBatch,
    QueryResult,
    Snapshot,
    SnapshotMismatchError,
    TieredReport,
    TierStats,
    fpr_share,
    fpr_tolerance,
    load_factor,
    load_snapshot,
    save_snapshot,
)

_LAZY = ("make", "get", "names", "FilterHandle", "AMQAdapter",
         "segmented_apply_ops", "CascadeHandle", "TieredHandle", "ColdLevel",
         "FilterService", "Ticket", "ServiceMetrics", "QueueFullError")

__all__ = list(_LAZY) + [
    "Capabilities", "CascadeReport", "DeleteReport", "InsertReport",
    "LevelStats", "MixedReport", "OpBatch", "OP_DELETE", "OP_INSERT",
    "OP_QUERY", "QueryResult", "Snapshot", "SnapshotMismatchError",
    "SNAPSHOT_VERSION", "TieredReport", "TierStats", "fpr_share",
    "fpr_tolerance", "load_factor", "load_snapshot", "save_snapshot",
]


def __getattr__(name):
    """Resolve the registry/handle surface lazily (see module docstring)."""
    if name in ("make", "get", "names"):
        from . import registry

        return getattr(registry, name)
    if name == "FilterHandle":
        from .handle import FilterHandle

        return FilterHandle
    if name in ("AMQAdapter", "segmented_apply_ops"):
        from . import adapters

        return getattr(adapters, name)
    if name == "CascadeHandle":
        from .cascade import CascadeHandle

        return CascadeHandle
    if name in ("TieredHandle", "ColdLevel"):
        from . import tiering

        return getattr(tiering, name)
    if name in ("FilterService", "Ticket"):
        from . import service

        return getattr(service, name)
    if name in ("ServiceMetrics", "QueueFullError"):
        from . import dispatch

        return getattr(dispatch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
