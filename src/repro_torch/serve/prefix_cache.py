"""Prefix-cache admission guarded by an AMQ filter (any registry backend).

Port of ``repro.serve.prefix_cache``. The KV prefix cache is expensive to
probe, so a filter sits in front of it as an AMQ: a negative lookup ("this
prefix hash was never cached") skips the probe. Cache *eviction* removes
the key from the filter too — deletion support, the paper's headline
capability vs Bloom filters, is what keeps the filter in sync with an LRU
cache instead of rotting toward 100% false positives. On backends without
deletion (``supports_delete`` False, e.g. ``bloom``) evicted keys go stale
in the filter, counted in ``stats["stale"]``.

All filter traffic flows through a :class:`repro_torch.amq.FilterService`
micro-batch (DESIGN.md §9): eviction deletes and admission inserts are
*enqueued* and only forced when a lookup needs an answer, so a burst of
cache churn costs one fused mixed-op dispatch.

Deviation from the JAX package: ``auto_expand=True`` asks for an
auto-expanding cascade where the backend supports one; no port backend
does yet (``supports_expand`` is False until the cascade is ported), so
the guard is a plain handle of ``4 * capacity_entries`` slots' capacity,
which the cache's keys never fill. Entries are whatever the caller
stores (the serving engine's hold device tensors): an LRU eviction drops
the cache's reference to its entry.
"""

from __future__ import annotations

import collections
from typing import Any, Optional

import numpy as np

from .. import amq
from ..core.hashing import fmix32_py


def prefix_key(tokens) -> int:
    """Order-sensitive 64-bit hash of a token prefix (host-side)."""
    h1, h2 = 0x9E3779B9, 0x85EBCA6B
    for i, t in enumerate(np.asarray(tokens).tolist()):
        h1 = fmix32_py(h1 ^ (t + i))
        h2 = fmix32_py(h2 + (t ^ (i * 0x27D4EB2F)))
    return (h2 << 32) | h1


class PrefixCache:
    """LRU prefix->cache-entry store with filter-guarded lookups.

    ``backend`` picks any AMQ registry backend for the guard filter;
    alternatively pass a ready-made ``filter_handle`` (sized by the caller)
    or a shared ``service`` (several caches coalescing into one filter's
    micro-batches). ``service_kw`` flows to the
    :class:`repro_torch.amq.FilterService` the cache builds; ``filter_kw``
    (e.g. ``device="cpu"``) to ``amq.make``.
    """

    def __init__(self, capacity_entries: int, filter_capacity: int = 0,
                 backend: str = "cuckoo",
                 filter_handle: Optional["amq.FilterHandle"] = None,
                 auto_expand: bool = True,
                 service: Optional["amq.FilterService"] = None,
                 service_batch: int = 64,
                 service_kw: Optional[dict] = None,
                 **filter_kw):
        self.capacity = capacity_entries
        self.entries: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()
        if service is None:
            if filter_handle is None:
                fcap = filter_capacity or capacity_entries * 4
                filter_handle = amq.make(
                    backend, capacity=fcap,
                    auto_expand="auto" if auto_expand else False, **filter_kw)
            service = amq.FilterService(filter_handle,
                                        batch_size=service_batch,
                                        **(service_kw or {}))
        elif filter_handle is not None:
            raise TypeError("pass filter_handle= or service=, not both")
        elif service_kw:
            raise TypeError("service_kw only applies when the cache builds "
                            "its own service; configure the shared service "
                            "directly instead")
        self.service = service
        self.stats = {"hits": 0, "misses": 0, "filtered": 0,
                      "evictions": 0, "stale": 0}

    @property
    def filter(self):
        """The live guard-filter handle — always the service's current one
        (a :meth:`~repro_torch.amq.FilterService.hot_swap` is observed at
        once)."""
        return self.service.handle

    def hot_swap_filter(self, new_handle, **kw) -> dict:
        """Swap the guard filter under live traffic: delegates to
        :meth:`repro_torch.amq.FilterService.hot_swap` (``migrate=False``
        until snapshots are ported)."""
        return self.service.hot_swap(new_handle, **kw)

    def slo_stats(self) -> dict:
        """Serving-SLO snapshot of the guard-filter service (the full
        :meth:`repro_torch.amq.FilterService.stats` payload)."""
        return self.service.stats()

    def _fkey(self, key: int):
        return np.asarray(
            [[key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF]], np.uint32)

    def lookup(self, tokens) -> Optional[Any]:
        key = prefix_key(tokens)
        # AMQ front door: definite-negative skips the (expensive) probe.
        # The ticket flushes any admissions/evictions queued ahead of it.
        if not bool(self.service.query(self._fkey(key)).result()[0]):
            self.stats["filtered"] += 1
            return None
        entry = self.entries.get(key)
        if entry is None:
            self.stats["misses"] += 1  # filter false positive (or stale key)
            return None
        self.entries.move_to_end(key)
        self.stats["hits"] += 1
        return entry

    def insert(self, tokens, entry: Any):
        key = prefix_key(tokens)
        if key in self.entries:
            self.entries.move_to_end(key)
            self.entries[key] = entry
            return
        while len(self.entries) >= self.capacity:
            old_key, _ = self.entries.popitem(last=False)   # LRU eviction
            if self.filter.capabilities.supports_delete:
                # Enqueued, not dispatched: the micro-batch keeps the AMQ
                # in sync at the next flush, before any lookup reads it.
                self.service.delete(self._fkey(old_key))
            else:
                self.stats["stale"] += 1  # append-only backend: key rots
            self.stats["evictions"] += 1
        self.entries[key] = entry
        self.service.insert(self._fkey(key))
