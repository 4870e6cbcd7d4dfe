"""Tiered storage: a GPU-hot / host-cold cascade for beyond-HBM capacity.

Port of ``repro.amq.tiering`` (DESIGN.md §12). Device memory caps the
keyspace of every handle; the cascade filter of Bender et al. ("Don't
Thrash", §3) keeps a small fast filter absorbing writes in front of
larger cold levels on cheaper storage. :class:`TieredHandle`:

* **Hot tier** — a :class:`~repro_torch.amq.cascade.CascadeHandle` whose
  levels live on the device. Inserts land only here.
* **Cold tier** — older levels demoted through the snapshot path into
  numpy arrays in host RAM (:class:`ColdLevel`), probed with the adapter's
  ``host_query``: the table gathers run in numpy over host memory; the
  keys' tags and buckets come from the backend's hashing on the device
  (the hash kernel on the GPU), so a cold probe answers as the level did
  there.
* **Hot-hit short-circuit** — a query runs the hot levels first; only the
  keys that missed every hot level go to the host, one batched probe a
  cold level.
* **Budget** — ``device_budget_bytes`` bounds the hot tier. Growth past it
  demotes the oldest hot level; :meth:`TieredHandle.maintain` does one
  bounded demote-or-promote step, :meth:`TieredHandle.promote` pulls the
  newest cold level back when it fits.
* **Deletes** go newest tier first: the hot cascade's pass, then a slot
  clear (``host_delete``) on the cold arrays.

Levels keep their FPR shares and allocation indices across tier moves, so
the aggregate false-positive budget and the snapshot order hold however
levels move. Reports are tensors on the handle's device.

Example::

    from repro_torch import amq

    h = amq.make("cuckoo", capacity=4096, tiered=True,
                 device_budget_bytes=256 * 1024)
    h.insert(keys_1m)                  # the hot tier spills old levels
    assert bool(h.query(keys_1m).hits.all())
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.hashing import normalize_keys
from .adapters import AMQAdapter, config_fingerprint
from .cascade import CascadeHandle, level_arrays
from .handle import FilterHandle
from .protocol import (
    OP_DELETE,
    OP_QUERY,
    DeleteReport,
    InsertReport,
    MixedReport,
    OpBatch,
    QueryResult,
    Snapshot,
    SnapshotMismatchError,
    TieredReport,
    TierStats,
    ensure_valid,
)

# Demotion loop backstop: one demotion per excess level, and a cascade
# cannot hold more levels than this in any realistic configuration.
_MAX_DEMOTE_ROUNDS = 256


def _max_capacity_under(adapter: AMQAdapter, budget: int, floor: int,
                        base_kwargs: dict) -> int:
    """Largest level capacity whose sized config fits ``budget`` bytes.

    Sized against the adapter's tightest growth sizing (the ladder's last
    overlay), so a level at the clamp fits whatever overlay the cascade
    picks for it. Binary search over ``make_config`` (monotone, not
    linear: cuckoo configs round buckets to powers of two), floored at
    the base capacity.
    """
    kw = {**base_kwargs, **(adapter.growth_sizings[-1]
                            if adapter.growth_sizings else {})}

    def _fits(capacity: int) -> bool:
        return adapter.make_config(capacity, **kw).table_bytes <= budget

    lo = hi = max(1, int(floor))
    if not _fits(lo):
        return lo  # even the base level overflows at its tightest sizing:
        # keep levels at base capacity (the overshoot shows in report()).
    while _fits(hi * 2):
        hi *= 2
    hi *= 2  # first known-too-big capacity
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if _fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


class ColdLevel:
    """One frozen cascade level in host RAM (DESIGN.md §12).

    Holds the level's config and writable numpy copies of its snapshot
    arrays; queries go through the adapter's ``host_query``, deletes clear
    slots in place through ``host_delete``. ``share`` and ``alloc_id``
    ride along for promotion and snapshots.
    """

    __slots__ = ("config", "arrays", "share", "alloc_id")

    def __init__(self, config, arrays: dict, share: float, alloc_id: int):
        """Wrap snapshot arrays; copies any that is not writable numpy."""
        self.config = config
        self.arrays = {
            k: (v if isinstance(v, np.ndarray) and v.flags.writeable
                else np.array(v))
            for k, v in arrays.items()}
        self.share = float(share)
        self.alloc_id = int(alloc_id)

    @property
    def count(self) -> int:
        """Stored-key count, read off the ``count`` array."""
        return int(np.asarray(self.arrays["count"]).sum())

    @property
    def table_bytes(self) -> int:
        """Host-RAM footprint of the packed table."""
        return self.config.table_bytes

    @property
    def num_slots(self) -> int:
        """Nominal slot capacity of the frozen level."""
        return self.config.num_slots

    @property
    def load_factor(self) -> float:
        """Occupancy of the frozen level."""
        return self.count / self.num_slots

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        """Summarize allocation index, occupancy, and footprint."""
        return (f"ColdLevel(alloc={self.alloc_id}, count={self.count}, "
                f"bytes={self.table_bytes})")


def _copied(arrays: dict) -> dict:
    """Fresh host copies: a snapshot and a live cold level never share a
    buffer (cold deletes clear slots in place)."""
    return {k: np.array(v) for k, v in arrays.items()}


class TieredHandle:
    """GPU-hot / host-cold tiered filter under a device-memory budget.

    Obtain via ``amq.make(name, capacity=..., tiered=True,
    device_budget_bytes=...)``. The surface mirrors
    :class:`~repro_torch.amq.cascade.CascadeHandle`, so consumers (the
    :class:`~repro_torch.amq.service.FilterService` among them) swap
    cascades for tiered handles without code changes.
    """

    def __init__(self, adapter: AMQAdapter, capacity: int, *,
                 device_budget_bytes: int,
                 growth: float = 2.0, watermark: float = 0.85,
                 fpr_budget: Optional[float] = None,
                 split_ratio: float = 0.5,
                 max_levels: Optional[int] = None,
                 device=None,
                 **base_kwargs: Any):
        """Build a one-level hot cascade under ``device_budget_bytes``."""
        caps = adapter.capabilities
        if not caps.supports_tiering or adapter.host_query is None:
            raise NotImplementedError(
                f"{adapter.name}: backend cannot tier "
                "(capabilities.supports_tiering is False / no host_query)")
        if not caps.supports_snapshot:
            raise NotImplementedError(
                f"{adapter.name}: tiering demotes levels through snapshots "
                "(capabilities.supports_snapshot is False)")
        budget = int(device_budget_bytes)
        if budget <= 0:
            raise ValueError(
                f"device_budget_bytes must be positive, got {budget}")
        self.adapter = adapter
        self.device_budget_bytes = budget
        base_bytes = adapter.make_config(int(capacity),
                                         **base_kwargs).table_bytes
        if base_bytes > budget:
            raise ValueError(
                f"device_budget_bytes={budget} cannot hold even the base "
                f"level ({base_bytes} bytes) — the active level never "
                "demotes; raise the budget or shrink capacity")
        # Clamp the ladder so that the active level alone fits the budget.
        clamp = _max_capacity_under(adapter, budget, int(capacity),
                                    base_kwargs)
        self.hot = CascadeHandle(
            adapter, capacity, growth=growth, watermark=watermark,
            fpr_budget=fpr_budget, split_ratio=split_ratio,
            max_levels=max_levels, max_level_capacity=clamp, device=device,
            **base_kwargs)
        self.device = self.hot.device
        self.cold: list[ColdLevel] = []
        self._counters = {"demotions": 0, "promotions": 0,
                          "cold_probes": 0, "cold_probe_keys": 0,
                          "cold_hits": 0}

    # -- introspection -------------------------------------------------------

    @property
    def name(self) -> str:
        """Registry name of the wrapped backend."""
        return self.adapter.name

    @property
    def capabilities(self):
        """The wrapped backend's capability flags."""
        return self.adapter.capabilities

    @property
    def config(self):
        """The hot tier's active (newest) level config."""
        return self.hot.config

    @property
    def state(self):
        """The hot tier's active (newest) level state."""
        return self.hot.state

    @property
    def levels(self) -> list:
        """The device-resident level handles (the hot cascade's levels)."""
        return self.hot.levels

    @property
    def fpr_budget(self) -> float:
        """Aggregate FPR budget shared across both tiers."""
        return self.hot.fpr_budget

    @property
    def base_capacity(self) -> int:
        """Level-0 design capacity (the geometric ladder's base)."""
        return self.hot.base_capacity

    @property
    def device_bytes(self) -> int:
        """Current device (hot-tier) footprint."""
        return self.hot.table_bytes

    @property
    def host_bytes(self) -> int:
        """Current host-RAM (cold-tier) footprint."""
        return sum(c.table_bytes for c in self.cold)

    @property
    def table_bytes(self) -> int:
        """Total footprint across both tiers."""
        return self.device_bytes + self.host_bytes

    @property
    def num_slots(self) -> int:
        """Aggregate nominal capacity across both tiers."""
        return self.hot.num_slots + sum(c.num_slots for c in self.cold)

    @property
    def load_factor(self) -> float:
        """Aggregate occupancy across both tiers."""
        return self.count() / self.num_slots

    def count(self) -> int:
        """Total stored-key count across both tiers."""
        return self.hot.count() + sum(c.count for c in self.cold)

    def expected_fpr(self, load_factor: Optional[float] = None) -> float:
        """Aggregate analytic FPR ``1 - prod(1 - eps_i)`` over both tiers."""
        miss = 1.0 - self.hot.expected_fpr(load_factor)
        for c in self.cold:
            lf = c.load_factor if load_factor is None else load_factor
            miss *= 1.0 - c.config.expected_fpr(lf)
        return 1.0 - miss

    def report(self) -> TieredReport:
        """Per-level residency-annotated stats (a :class:`TieredReport`)."""
        stats = []
        for c in self.cold:
            lf = c.load_factor
            stats.append(TierStats("cold", c.alloc_id, c.num_slots, c.count,
                                   lf, c.table_bytes,
                                   c.config.expected_fpr(lf), c.share))
        for lvl, share, aid in zip(self.hot.levels, self.hot.level_shares,
                                   self.hot.level_alloc_ids):
            cnt, lf = lvl.count(), lvl.load_factor
            stats.append(TierStats("hot", aid, lvl.config.num_slots, cnt,
                                   lf, lvl.config.table_bytes,
                                   lvl.config.expected_fpr(lf), share))
        c = self._counters
        return TieredReport(tuple(stats), self.device_budget_bytes,
                            self.device_bytes, self.host_bytes,
                            self.count(), self.expected_fpr(),
                            self.fpr_budget, c["demotions"],
                            c["promotions"], c["cold_probes"],
                            c["cold_hits"])

    def tier_stats(self) -> dict:
        """JSON-able tier summary (surfaced by ``FilterService.stats``)."""
        return {"device_budget_bytes": self.device_budget_bytes,
                "device_bytes": self.device_bytes,
                "host_bytes": self.host_bytes,
                "hot_levels": len(self.hot.levels),
                "cold_levels": len(self.cold),
                **self._counters}

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        """Summarize backend, tier shape, and budget utilisation."""
        return (f"TieredHandle({self.adapter.name!r}, "
                f"hot={len(self.hot.levels)}, cold={len(self.cold)}, "
                f"device={self.device_bytes}/{self.device_budget_bytes}B, "
                f"host={self.host_bytes}B)")

    # -- tier movement -------------------------------------------------------

    def demote(self) -> Optional[ColdLevel]:
        """Freeze the oldest hot level into host RAM; None if impossible.

        The level's state crosses through the snapshot hook (one
        device-to-host copy of its table; the arrays own their memory) and
        leaves the cascade with its FPR share and allocation index. The
        active level never demotes.
        """
        if len(self.hot.levels) <= 1:
            return None
        lvl, share, aid = self.hot.detach_oldest()
        cold = ColdLevel(lvl.config,
                         self.adapter.snapshot(lvl.config, lvl.state),
                         share, aid)
        self.cold.append(cold)
        self._counters["demotions"] += 1
        return cold

    def promote(self, *, force: bool = False) -> bool:
        """Move the newest cold level back on device; False if refused
        (without ``force``: when it would push the hot tier past the
        budget, exactly when :meth:`maintain` would demote it again)."""
        if not self.cold:
            return False
        lvl = self.cold[-1]
        if (not force and self.hot.table_bytes + lvl.table_bytes
                > self.device_budget_bytes):
            return False
        state = self.adapter.restore(lvl.config, lvl.arrays, self.device)
        self.hot.attach_oldest(
            FilterHandle(self.adapter, lvl.config, state, device=self.device),
            lvl.share, lvl.alloc_id)
        self.cold.pop()
        self._counters["promotions"] += 1
        return True

    def maintain(self) -> dict:
        """One bounded rebalance step, safe to call from a background loop:
        demote the oldest hot level when the hot tier exceeds the budget,
        else promote the newest cold level if it fits. Returns ``{"action":
        "demote" | "promote" | "none", ...}``."""
        if (self.hot.table_bytes > self.device_budget_bytes
                and len(self.hot.levels) > 1):
            cold = self.demote()
            return {"action": "demote", "alloc_index": cold.alloc_id,
                    "bytes": cold.table_bytes}
        if self.cold and (self.hot.table_bytes + self.cold[-1].table_bytes
                          <= self.device_budget_bytes):
            aid = self.cold[-1].alloc_id
            nbytes = self.cold[-1].table_bytes
            self.promote()
            return {"action": "promote", "alloc_index": aid, "bytes": nbytes}
        return {"action": "none"}

    def compact(self) -> TieredReport:
        """Reclaim drained levels in both tiers; returns the tier report.
        The hot cascade compacts without resetting while cold levels
        remain (the cross-tier allocation order must hold)."""
        self.cold = [c for c in self.cold if c.count > 0]
        self.hot.compact(reset_when_empty=not self.cold)
        return self.report()

    def _enforce_budget(self) -> None:
        """Demote oldest hot levels until the budget holds (or one left)."""
        for _ in range(_MAX_DEMOTE_ROUNDS):
            if (self.hot.table_bytes <= self.device_budget_bytes
                    or len(self.hot.levels) <= 1):
                return
            self.demote()

    # -- cold-tier probes ----------------------------------------------------

    def _cold_query(self, keys: torch.Tensor) -> np.ndarray:
        """One host probe a cold level, OR-reduced; keys on the device."""
        hits = np.zeros((keys.shape[0],), bool)
        for c in reversed(self.cold):
            hits |= self.adapter.host_query(c.config, c.arrays, keys,
                                            device=self.device)
        self._counters["cold_probes"] += 1
        self._counters["cold_probe_keys"] += int(keys.shape[0])
        self._counters["cold_hits"] += int(hits.sum())
        return hits

    def _cold_delete(self, keys: torch.Tensor,
                     pending: np.ndarray) -> np.ndarray:
        """Newest-first host-side slot clear across cold levels."""
        ok = np.zeros((keys.shape[0],), bool)
        for c in reversed(self.cold):
            if not pending.any():
                break
            done = self.adapter.host_delete(c.config, c.arrays, keys,
                                            pending, device=self.device)
            ok |= pending & done
            pending = pending & ~done
        return ok

    def _to_device(self, mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(mask).to(self.device)

    # -- ops -----------------------------------------------------------------

    def insert(self, keys, *, bulk: bool = False,
               dedup_within_batch: bool = False,
               valid=None) -> InsertReport:
        """Insert into the hot tier; growth past ``device_budget_bytes``
        demotes the oldest hot level(s) to host RAM at once."""
        report = self.hot.insert(keys, bulk=bulk,
                                 dedup_within_batch=dedup_within_batch,
                                 valid=valid)
        self._enforce_budget()
        return report

    def query(self, keys, *, valid=None) -> QueryResult:
        """Membership across both tiers, hot first: only the keys that
        missed every hot level are gathered (one host sync) and probed
        against the cold levels, one host probe each."""
        keys = normalize_keys(keys, device=self.device)
        qr = self.hot.query(keys, valid=valid)
        if not self.cold:
            return qr
        pend = (ensure_valid(keys, valid) & ~qr.hits).nonzero().squeeze(1)
        if not pend.numel():
            return qr
        hits = qr.hits.clone()
        hits[pend] = self._to_device(self._cold_query(keys[pend]))
        return QueryResult(hits, qr.routed)

    def delete(self, keys, *, valid=None) -> DeleteReport:
        """Delete one stored copy a key, newest tier first: the hot
        cascade's pass, then host-side slot clears of the keys it could
        not find, newest cold level first."""
        if not self.adapter.capabilities.supports_delete:
            raise NotImplementedError(
                f"{self.name}: append-only structure "
                "(capabilities.supports_delete is False)")
        keys = normalize_keys(keys, device=self.device)
        dr = self.hot.delete(keys, valid=valid)
        if not self.cold:
            return dr
        pend = (ensure_valid(keys, valid) & ~dr.ok).cpu().numpy()
        if not pend.any():
            return dr
        ok = dr.ok | self._to_device(self._cold_delete(keys, pend))
        return DeleteReport(ok, dr.routed)

    def apply_ops(self, batch: OpBatch) -> MixedReport:
        """Execute a mixed op stream across both tiers (DESIGN.md §9/§12).

        The hot cascade runs the whole batch first (inserts always resolve
        there). Query and delete slots it missed fall through to the cold
        tier: with no delete among them, one batched host probe; else the
        missed slots replay on the host in batch order, so that same-key
        query/delete interleavings keep their positional semantics.
        """
        if not isinstance(batch, OpBatch):
            raise TypeError(f"apply_ops takes an OpBatch (OpBatch.make), "
                            f"got {type(batch).__name__}")
        batch = batch.to(self.device)
        report = self.hot.apply_ops(batch)
        self._enforce_budget()
        if not self.cold:
            return report
        ok = report.ok
        miss_t = (batch.valid & ~ok
                  & ((batch.ops == OP_QUERY) | (batch.ops == OP_DELETE)))
        miss = miss_t.cpu().numpy()
        if not miss.any():
            return report
        ops = batch.ops.cpu().numpy()
        ok = ok.clone()
        if (miss & (ops == OP_DELETE)).any():
            ok |= self._to_device(self._cold_replay(batch.keys, ops, miss))
        else:
            idx = miss_t.nonzero().squeeze(1)
            ok[idx] = self._to_device(self._cold_query(batch.keys[idx]))
        return MixedReport(ok, report.routed, report.evictions,
                           report.rounds)

    def _cold_replay(self, keys: torch.Tensor, ops: np.ndarray,
                     miss: np.ndarray) -> np.ndarray:
        """Sequential host replay of hot-missed slots, in batch order: a
        later query of a key must observe an earlier cold delete of it."""
        ok = np.zeros((keys.shape[0],), bool)
        one = np.ones((1,), bool)
        for i in np.flatnonzero(miss):
            key = keys[i:i + 1]
            if ops[i] == OP_DELETE:
                ok[i] = bool(self._cold_delete(key, one.copy())[0])
            else:
                ok[i] = bool(self._cold_query(key)[0])
        return ok

    # -- lifecycle (DESIGN.md §10/§12) ---------------------------------------

    def snapshot(self) -> Snapshot:
        """Snapshot both tiers as one versioned host payload: hot level
        ``i``'s arrays under ``hot/level<i>/``, cold level ``i``'s (copied)
        under ``cold/level<i>/``; ``meta`` records each level's
        fingerprint, share, allocation index and residency, the cascade
        knobs and the device budget."""
        arrays, cold_meta, hot_meta = {}, [], []
        for i, c in enumerate(self.cold):
            for k, v in _copied(c.arrays).items():
                arrays[f"cold/level{i}/{k}"] = v
            cold_meta.append(self._level_meta(
                c.config, c.share, c.alloc_id, c.count, "cold"))
        for i, lvl in enumerate(self.hot.levels):
            for k, v in self.adapter.snapshot(lvl.config, lvl.state).items():
                arrays[f"hot/level{i}/{k}"] = v
            hot_meta.append(self._level_meta(
                lvl.config, self.hot.level_shares[i],
                self.hot.level_alloc_ids[i], lvl.count(), "hot"))
        hot = self.hot
        meta = {"hot_levels": hot_meta, "cold_levels": cold_meta,
                "device_budget_bytes": self.device_budget_bytes,
                "allocated": hot._allocated,
                "base_capacity": hot.base_capacity, "growth": hot.growth,
                "watermark": hot.watermark, "fpr_budget": hot.fpr_budget,
                "split_ratio": hot.split_ratio, "count": self.count()}
        configs = tuple(c.config for c in self.cold) + tuple(
            lvl.config for lvl in hot.levels)
        return Snapshot(backend=self.name, kind="tiered", fingerprint="",
                        arrays=arrays, meta=meta, configs=configs)

    def _level_meta(self, config, share: float, alloc_id: int,
                    count: int, residency: str) -> dict:
        """One level's snapshot metadata record."""
        return {"fingerprint": config_fingerprint(self.adapter, config),
                "share": share, "alloc_index": alloc_id, "count": count,
                "num_slots": config.num_slots,
                "table_bytes": config.table_bytes, "residency": residency}

    def restore(self, snap: Snapshot) -> "TieredHandle":
        """Rebuild both tiers from a tiered snapshot — validated.

        Level configs come from the snapshot when taken in this process;
        a file-loaded one replays the cascade's sizing over the combined
        allocation chain (cold, then hot) and checks every config against
        its recorded fingerprint, raising
        :class:`~repro_torch.amq.protocol.SnapshotMismatchError` on any
        drift. Cold arrays are copied. Returns ``self``.
        """
        if snap.kind != "tiered":
            raise SnapshotMismatchError(
                f"cannot restore a {snap.kind!r} snapshot onto a tiered "
                "handle (use auto_expand/static handles for those kinds)")
        if snap.backend != self.name:
            raise SnapshotMismatchError(
                f"snapshot is from backend {snap.backend!r}, "
                f"this handle is {self.name!r}")
        meta = snap.meta
        if meta["device_budget_bytes"] != self.device_budget_bytes:
            raise SnapshotMismatchError(
                f"device_budget_bytes mismatch: snapshot has "
                f"{meta['device_budget_bytes']}, this handle was built "
                f"with {self.device_budget_bytes}")
        hot = self.hot
        for knob in ("base_capacity", "growth", "split_ratio",
                     "watermark", "fpr_budget"):
            if getattr(hot, knob) != meta[knob]:
                raise SnapshotMismatchError(
                    f"cascade {knob} mismatch: snapshot has {meta[knob]}, "
                    f"this handle was built with {getattr(hot, knob)}")
        cold_meta, hot_meta = meta["cold_levels"], meta["hot_levels"]
        configs = hot._level_configs(snap.configs,
                                     list(cold_meta) + list(hot_meta))
        n_cold = len(cold_meta)
        cold = [ColdLevel(cfg, _copied(level_arrays(snap, f"cold/level{i}/")),
                          lm["share"], lm["alloc_index"])
                for i, (cfg, lm) in enumerate(zip(configs[:n_cold],
                                                  cold_meta))]
        levels = []
        for i, cfg in enumerate(configs[n_cold:]):
            state = self.adapter.restore(
                cfg, level_arrays(snap, f"hot/level{i}/"), self.device)
            levels.append(FilterHandle(self.adapter, cfg, state,
                                       device=self.device))
        self.cold = cold
        hot.levels = levels
        hot._shares = [lm["share"] for lm in hot_meta]
        hot._alloc_ids = [lm["alloc_index"] for lm in hot_meta]
        hot._allocated = meta["allocated"]
        return self
