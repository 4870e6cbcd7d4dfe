"""The AMQ registry: name -> adapter, and the ``make`` front door.

    from repro_torch import amq

    handle = amq.make("cuckoo", capacity=1_000_000)     # on the GPU
    report = handle.insert(keys, bulk=True)
    hits = handle.query(keys).hits

The port registers the ``cuckoo`` backend, the blocked Bloom filter
``bloom``, the paper's dynamic baselines ``tcf`` (two-choice filter),
``gqf`` (quotient filter, its serial insert and delete CUDA kernels) and
``bcht`` (bucketed cuckoo hash table), the mesh-sharded filter
``sharded-cuckoo`` (its shards on one device) and the host oracle
``cpu-cuckoo``, in the JAX package's order. ``make`` also builds the
lifecycle handles: a restored handle (``snapshot=``), an auto-expanding
cascade (``auto_expand=``) and a GPU-hot / host-cold tiered handle
(``tiered=True``).
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from .adapters import DEFAULT_ADAPTERS, AMQAdapter, make_config
from .handle import FilterHandle

_REGISTRY = dict(DEFAULT_ADAPTERS)


def get(name: str) -> AMQAdapter:
    """Look up a backend adapter by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown AMQ backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> Iterable[str]:
    """Registered backend names, in registration order."""
    return tuple(_REGISTRY)


def make(name: str, capacity: Optional[int] = None, *,
         config: Any = None, state: Any = None, device=None,
         snapshot: Any = None, auto_expand=False, tiered: bool = False,
         **kw):
    """Build a ready-to-use filter handle.

    Pass ``capacity`` (+ backend sizing kwargs, forwarded to the adapter's
    ``make_config``) or a pre-built ``config``; ``state`` resumes from an
    existing state (see ``repro_torch.convert.state_from_numpy``);
    ``snapshot`` restores a :class:`~repro_torch.amq.protocol.Snapshot`
    (``handle.snapshot()`` or :func:`~repro_torch.amq.load_snapshot`)
    whose config fingerprint must match, else
    :class:`~repro_torch.amq.protocol.SnapshotMismatchError`.

    ``device`` defaults to the GPU: without a CUDA device, ``make`` raises
    unless the caller passes ``device="cpu"`` (the plain versions of the
    kernels). It never falls back silently. Every level of a cascade or a
    tiered handle lives on it.

    ``auto_expand=True`` returns a :class:`~repro_torch.amq.cascade.
    CascadeHandle`: ``capacity`` is the initial level's and the filter
    grows online as a geometric cascade (DESIGN.md §8); the cascade knobs
    (``growth``, ``watermark``, ``fpr_budget``, ``split_ratio``,
    ``max_levels``) ride in ``**kw`` beside the backend's sizing kwargs.
    ``auto_expand="auto"`` expands where the backend supports it and
    returns a static handle otherwise.

    ``tiered=True`` returns a :class:`~repro_torch.amq.tiering.TieredHandle`:
    a cascade whose device footprint stays under ``device_budget_bytes``
    (in ``**kw``, or from a tiered ``snapshot``), older levels frozen in
    host RAM (DESIGN.md §12). It already auto-expands, so it takes no
    ``auto_expand``.
    """
    adapter = get(name)
    if auto_expand == "auto":
        auto_expand = adapter.capabilities.supports_expand
    if snapshot is not None and state is not None:
        raise TypeError("pass state= or snapshot=, not both")
    if tiered:
        if auto_expand:
            raise TypeError(
                "tiered=True already auto-expands; drop auto_expand=")
        if config is not None or state is not None:
            raise TypeError(
                "tiered=True sizes and allocates levels itself; pass "
                "capacity=..., not config=/state=")
        if capacity is None:
            raise TypeError("make(tiered=True) needs capacity=...")
        if "device_budget_bytes" not in kw and snapshot is not None:
            kw["device_budget_bytes"] = snapshot.meta["device_budget_bytes"]
        if "device_budget_bytes" not in kw:
            raise TypeError("make(tiered=True) needs device_budget_bytes=...")
        from .tiering import TieredHandle

        handle = TieredHandle(adapter, capacity, device=device, **kw)
        if snapshot is not None:
            handle.restore(snapshot)
        return handle
    if auto_expand:
        if config is not None or state is not None:
            raise TypeError(
                "auto_expand=True sizes and allocates levels itself; pass "
                "capacity=..., not config=/state=")
        if capacity is None:
            raise TypeError("make(auto_expand=True) needs capacity=...")
        from .cascade import CascadeHandle

        handle = CascadeHandle(adapter, capacity, device=device, **kw)
        if snapshot is not None:
            handle.restore(snapshot)
        return handle
    if config is None:
        if capacity is None:
            raise TypeError("make() needs capacity=... or config=...")
        config = make_config(adapter, capacity, device, **kw)
    elif capacity is not None or kw:
        extra = (["capacity"] if capacity is not None else []) + sorted(kw)
        raise TypeError(f"config= given; conflicting arguments {extra}")
    if snapshot is not None:
        # Built straight from the snapshot: no zero table first.
        return FilterHandle.from_snapshot(adapter, config, snapshot, device)
    return FilterHandle(adapter, config, state, device=device)
