"""The AMQ registry: name -> adapter, and the ``make`` front door.

    from repro_torch import amq

    handle = amq.make("cuckoo", capacity=1_000_000)     # on the GPU
    report = handle.insert(keys, bulk=True)
    hits = handle.query(keys).hits

The port registers the ``cuckoo`` backend, the blocked Bloom filter
``bloom`` and the host oracle ``cpu-cuckoo``; the other baselines and the
sharded backend are later port slices.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from .adapters import DEFAULT_ADAPTERS, AMQAdapter
from .handle import FilterHandle, _not_ported

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
         **kw) -> FilterHandle:
    """Build a ready-to-use filter handle.

    Pass ``capacity`` (+ backend sizing kwargs, forwarded to the adapter's
    ``make_config``) or a pre-built ``config``; ``state`` resumes from an
    existing state (see ``repro_torch.convert.state_from_numpy``).

    ``device`` defaults to the GPU: without a CUDA device, ``make`` raises
    unless the caller passes ``device="cpu"`` (the plain versions of the
    kernels). It never falls back silently.

    ``auto_expand="auto"`` expands where the backend supports it
    (``capabilities.supports_expand``, False for every port backend) and
    returns a plain handle otherwise, as the JAX package does.
    ``snapshot=``, ``auto_expand=True`` and ``tiered=True`` are later port
    slices and raise ``NotImplementedError``.
    """
    adapter = get(name)
    if auto_expand == "auto":
        auto_expand = adapter.capabilities.supports_expand
    if snapshot is not None:
        raise _not_ported("make(snapshot=...)",
                          "ROADMAP queue A item 9b (snapshots)")
    if auto_expand:
        raise _not_ported("make(auto_expand=...) (the cascade)",
                          "ROADMAP queue A item 12")
    if tiered:
        raise _not_ported("make(tiered=True)", "ROADMAP queue A item 12")
    if config is None:
        if capacity is None:
            raise TypeError("make() needs capacity=... or config=...")
        config = adapter.make_config(capacity, **kw)
    elif capacity is not None or kw:
        extra = (["capacity"] if capacity is not None else []) + sorted(kw)
        raise TypeError(f"config= given; conflicting arguments {extra}")
    return FilterHandle(adapter, config, state, device=device)
