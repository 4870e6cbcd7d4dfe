"""Streaming training-data dedup backed by any registered AMQ backend.

Port of ``repro.data.dedup``. Every incoming sequence is hashed to a
64-bit key; a query and an insert against the filter decide whether the
sequence was seen before. Duplicate sequences get their loss mask zeroed
(shape-static: no dynamic batch filtering).

The filter is addressed through the AMQ protocol (``repro_torch.amq``), so
dedup runs unchanged on every backend: the default cuckoo filter, the
mesh-sharded one, or any baseline. Time-windowed dedup (``forget``)
removes expired keys, which an append-only Bloom filter cannot do
(``forget_keys`` is capability-gated).

Two surfaces:

* :func:`dedup_batch` — functional, over a static filter config (the
  in-pipeline path).
* :class:`StreamingDeduper` (via :func:`make_deduper`) — handle-based and
  auto-expanding by default (DESIGN.md §8), behind a
  :class:`~repro_torch.amq.FilterService`.

Keys are ``int32[n, 2]`` (lo, hi) bit views, on the tokens' device; the
hash is the JAX package's uint32 arithmetic, carried in int64 with masks,
so keys are equal bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import amq
from ..amq.adapters import make_config
from ..amq.handle import handle_device
from ..core import CuckooConfig
from ..core.bits64 import MASK32, from_i32, to_i32
from ..core.hashing import fmix32, normalize_keys


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    """Static dedup config: an AMQ backend name + that backend's config.

    ``filter`` stays the first field, as in the JAX package; ``backend``
    selects the adapter from the AMQ registry.
    """

    filter: Any                   # the backend's static config
    ngram: Optional[int] = None   # None = whole-sequence keys
    backend: str = "cuckoo"

    @property
    def adapter(self):
        return amq.get(self.backend)


def sequence_keys(tokens: torch.Tensor) -> torch.Tensor:
    """Hash int32[B, S] sequences to int32[B, 2] (lo, hi) keys
    (order-sensitive)."""
    t = tokens.to(torch.int64) & MASK32
    pos = torch.arange(t.shape[-1], dtype=torch.int64, device=t.device)
    mixed = fmix32(t + pos * 0x9E3779B9)        # fmix32 masks to uint32
    lo = fmix32(mixed.sum(-1))
    # Each product taken mod 2^32 first: the sum stays exact in int64.
    hi = fmix32(((mixed * (pos + 1)) & MASK32).sum(-1) ^ lo)
    return to_i32(torch.stack([lo, hi], dim=-1))


def intra_batch_duplicates(keys: torch.Tensor) -> torch.Tensor:
    """Mask non-first occurrences of each 64-bit key within a batch.

    Detection runs on the full 64-bit key values (backend-independent, so
    set semantics hold even for counting filters): a stable sort of the
    values keeps each key's copies in batch order.
    """
    k64 = (from_i32(keys[:, 1]) << 32) | from_i32(keys[:, 0])
    k_s, order = torch.sort(k64, stable=True)
    dup_s = torch.zeros_like(k_s, dtype=torch.bool)
    dup_s[1:] = k_s[1:] == k_s[:-1]
    out = torch.zeros_like(dup_s)
    out[order] = dup_s
    return out


def dedup_batch(cfg: DedupConfig, state: Any,
                batch: Dict[str, torch.Tensor]
                ) -> Tuple[Any, Dict[str, torch.Tensor], Dict]:
    """Mask duplicate sequences; insert fresh ones into the filter.

    Returns (filter_state', batch + {"mask"}, stats), the stats as
    tensors: ``duplicates`` (masked rows), ``insert_failures`` (fresh keys
    routed but not placed) and ``unrouted`` (fresh keys a sharded filter
    could not route this batch).
    """
    ad = cfg.adapter
    keys = sequence_keys(batch["tokens"])
    _, qres = ad.query(cfg.filter, state, keys)
    seen = qres.hits
    intra_dup = intra_batch_duplicates(keys)

    fresh = ~seen & ~intra_dup
    state, report = ad.insert(cfg.filter, state, keys, valid=fresh)
    mask = fresh  # duplicates (cross- or intra-batch) contribute no loss
    out = dict(batch)
    out["mask"] = mask
    stats = {"duplicates": (~mask).sum(),
             "insert_failures": (fresh & ~report.ok & report.routed).sum(),
             "unrouted": (fresh & ~report.routed).sum()}
    return state, out, stats


def make_dedup(capacity: int, backend: str = "cuckoo", *, device=None,
               **kw) -> Tuple[DedupConfig, Any]:
    """Size a dedup filter on any backend via the registry.

    Returns (cfg, fresh_state) for :func:`dedup_batch`, the state on
    ``device`` (default: the GPU; a host backend's own device).
    """
    ad = amq.get(backend)
    fcfg = make_config(ad, capacity, device, **kw)
    return (DedupConfig(fcfg, backend=backend),
            ad.init(fcfg, handle_device(ad, device, config=fcfg)))


def _state_device(state):
    """The device of a tensor state's fields; None for a host oracle."""
    return state[0].device if hasattr(state, "_fields") else None


def forget_keys(cfg: DedupConfig, state: Any, keys) -> Any:
    """Expire keys from the dedup window (needs deletion support — the
    capability Bloom filters lack, paper §1)."""
    ad = cfg.adapter
    if not ad.capabilities.supports_delete:
        raise NotImplementedError(
            f"{cfg.backend}: append-only backend cannot forget keys "
            "(capabilities.supports_delete is False)")
    state, _ = ad.delete(cfg.filter, state,
                         normalize_keys(keys, device=_state_device(state)))
    return state


def _host_keys(keys) -> np.ndarray:
    """Any accepted key batch -> packed uint32[n, 2] (lo, hi) on the host,
    the form the service's queue holds."""
    return normalize_keys(keys).cpu().numpy().view(np.uint32)


class StreamingDeduper:
    """Service-based dedup for unbounded streams (no a-priori sizing).

    Wraps any ``amq`` handle — by default an auto-expanding cascade
    (DESIGN.md §8) — behind a :class:`repro_torch.amq.FilterService`
    micro-batch (DESIGN.md §9): the membership probe and the fresh-key
    admission are *enqueued* op streams, so only the fresh slice of each
    batch is inserted (its width absorbed by the service's padding), and
    several dedupers can share one service. Host-driven: the cascade
    allocates levels between batches.
    """

    def __init__(self, handle, *, service_batch: int = 512,
                 service: Optional["amq.FilterService"] = None,
                 service_kw: Optional[dict] = None):
        if service is not None and service_kw:
            raise TypeError("service_kw only applies when the deduper builds "
                            "its own service")
        self.service = (amq.FilterService(handle, batch_size=service_batch,
                                          **(service_kw or {}))
                        if service is None else service)
        self.stats = {"duplicates": 0, "insert_failures": 0}
        self._admissions: list = []   # tickets whose failures aren't counted

    @property
    def handle(self):
        """The live filter handle — tracks ``FilterService.hot_swap``."""
        return self.service.handle

    def _drain_admissions(self) -> int:
        """Fold finished admission tickets into ``insert_failures``.

        Only tickets already dispatched are resolved — draining never
        forces a flush, so admissions stay lazy. Returns the failures
        counted by this drain.
        """
        drained = 0
        live = []
        for t in self._admissions:
            if not t.dispatched:
                live.append(t)
                continue
            drained += int((~t.result()).sum())
        self._admissions = live
        self.stats["insert_failures"] += drained
        return drained

    def dedup(self, batch: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """Mask duplicates in ``batch`` and insert fresh sequence keys.

        Returns ``(batch + {"mask"}, per_batch_stats)`` and accumulates
        totals in ``self.stats``. Admissions are *enqueued*: this batch's
        fresh keys ride the service's micro-batches and reach the filter
        with the next membership probe (or :meth:`flush`), so
        ``insert_failures`` trails the admissions by one flush.
        ``duplicates`` is always exact for the current batch. The keys are
        hashed on the tokens' device and cross to the host once.
        """
        tokens = batch["tokens"]
        keys = sequence_keys(tokens)
        intra_dup = intra_batch_duplicates(keys).cpu().numpy()
        keys = _host_keys(keys)
        seen = self.service.query(keys).result()
        failures = self._drain_admissions()   # prior admissions just flushed
        fresh = ~seen & ~intra_dup
        self._admissions.append(self.service.insert(keys[fresh]))
        out = dict(batch)
        out["mask"] = torch.from_numpy(fresh).to(tokens.device)
        stats = {"duplicates": int((~fresh).sum()),
                 "insert_failures": failures}
        self.stats["duplicates"] += stats["duplicates"]
        return out, stats

    def flush(self) -> None:
        """Force pending admissions onto the filter and settle stats."""
        self.service.flush()
        self._drain_admissions()

    def forget(self, keys) -> None:
        """Expire keys from the window (capability-gated, like forget_keys)."""
        if not self.handle.capabilities.supports_delete:
            raise NotImplementedError(
                f"{self.handle.name}: append-only backend cannot forget keys "
                "(capabilities.supports_delete is False)")
        self.service.delete(_host_keys(keys)).result()
        self._drain_admissions()


def make_deduper(capacity: int, backend: str = "cuckoo", *,
                 auto_expand: bool = True, service_batch: int = 512,
                 service_kw: Optional[dict] = None,
                 device_budget_bytes: Optional[int] = None, device=None,
                 **kw) -> StreamingDeduper:
    """Build a :class:`StreamingDeduper` on any registry backend.

    ``capacity`` is the initial window size; with ``auto_expand`` (the
    default, where the backend supports it) the filter grows online.
    ``device_budget_bytes`` upgrades the handle to a GPU-hot / host-cold
    :class:`~repro_torch.amq.TieredHandle` (DESIGN.md §12). ``service_kw``
    flows to the :class:`~repro_torch.amq.FilterService`; ``device`` to
    the handle (default: the GPU).
    """
    if device_budget_bytes is not None:
        handle = amq.make(backend, capacity=capacity, tiered=True,
                          device_budget_bytes=device_budget_bytes,
                          device=device, **kw)
    else:
        handle = amq.make(backend, capacity=capacity, device=device,
                          auto_expand="auto" if auto_expand else False, **kw)
    return StreamingDeduper(
        handle, service_batch=service_batch, service_kw=service_kw)


# The JAX package's convenience constructor (a cuckoo filter's config).
def default_config(capacity: int, **kw) -> DedupConfig:
    return DedupConfig(CuckooConfig.for_capacity(capacity, **kw))
