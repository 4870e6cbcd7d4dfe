"""Unified AMQ API of the port: one protocol, one registry.

    from repro_torch import amq

    h = amq.make("cuckoo", capacity=1_000_000)    # device="cpu" for the CPU
    h.insert(keys, bulk=True)            # -> InsertReport(ok, evictions, ...)
    h.query(keys).hits                   # -> bool[n]
    h.delete(keys)
    h.apply_ops(amq.OpBatch.make(keys, ops))   # -> MixedReport(ok, ...)

Only :mod:`.protocol` is imported eagerly; the registry and its adapter,
which import the kernels, load on first use so that ``repro_torch.core``
and ``repro_torch.kernels`` can import the protocol without a cycle.
"""

from .protocol import (  # noqa: F401
    OP_DELETE,
    OP_INSERT,
    OP_QUERY,
    Capabilities,
    DeleteReport,
    InsertReport,
    MixedReport,
    OpBatch,
    QueryResult,
    fpr_tolerance,
    load_factor,
)

_LAZY = ("make", "get", "names", "FilterHandle", "AMQAdapter",
         "segmented_apply_ops")

__all__ = list(_LAZY) + [
    "Capabilities", "DeleteReport", "InsertReport", "MixedReport", "OpBatch",
    "OP_DELETE", "OP_INSERT", "OP_QUERY", "QueryResult", "fpr_tolerance",
    "load_factor",
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
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
