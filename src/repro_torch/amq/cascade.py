"""Auto-expanding AMQ cascades: unbounded inserts over any registry backend.

Port of ``repro.amq.cascade``. A static filter is frozen at its
``make(capacity=...)`` size, and the paper's partial-key cuckoo filter
cannot rehash its way out (stored tags are fingerprints, not keys). The
cascade filter of Bender et al. ("Don't Thrash", §3) keeps a geometric
sequence of levels instead, inserts into the newest, queries them all, and
splits the false-positive budget across levels (DESIGN.md §8):

* **Levels** grow geometrically (``growth`` g, default 2): level ``i``
  holds ``capacity * g**i`` keys, sized by the adapter's
  ``growth_sizings`` ladder to meet its FPR share. A new level is
  allocated when the active one reaches the ``watermark`` or rejects keys.
* **Inserts** land in the active level, throttled to its watermark
  headroom (a 1-D ``cumsum`` of the pending mask on the device).
* **Queries** run one query a level on the device (one launch of the
  query kernel a level on the GPU) and OR the hits there, with no host
  sync between levels.
* **Deletes** go newest level first, a query-then-delete pass a level.
* **``compact()``** frees drained levels; a fully drained cascade resets
  to one fresh base-capacity level.

Every level is a :class:`~repro_torch.amq.handle.FilterHandle` on the
cascade's ``device``; reports are tensors there. The insert and delete
loops read counts and masks back to the host between levels, as the JAX
package's do.

Example::

    from repro_torch import amq

    h = amq.make("cuckoo", capacity=100_000, auto_expand=True)
    h.insert(keys_1m)                 # grows to ~4 levels, never refuses
    assert bool(h.query(keys_1m).hits.all())
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.hashing import normalize_keys
from .adapters import (AMQAdapter, config_fingerprint, make_config,
                       segmented_apply_ops)
from .handle import FilterHandle, handle_device
from .protocol import (
    OP_INSERT,
    CascadeReport,
    DeleteReport,
    InsertReport,
    LevelStats,
    MixedReport,
    OpBatch,
    QueryResult,
    Snapshot,
    SnapshotMismatchError,
    all_routed,
    ensure_valid,
    fpr_share,
)

# Per-level FPR shares are enforced at the structure's design load: a level
# is never filled past ``watermark``, so its analytic FPR at full load upper
# bounds anything it will exhibit in service.
_REF_LOAD = 1.0

# An insert batch provokes at most ~log_g(batch / capacity) growths; this
# backstop only trips if a backend keeps rejecting keys into fresh levels.
_MAX_GROW_ROUNDS = 64


class CascadeHandle:
    """Auto-expanding filter handle: a geometric cascade of level handles.

    Obtain via ``amq.make(name, capacity=..., auto_expand=True)``. The
    surface mirrors :class:`~repro_torch.amq.handle.FilterHandle`, so
    consumers swap static handles for cascades without code changes.
    Extra keyword arguments are the backend's sizing kwargs, forwarded to
    every level's ``make_config`` under the ladder's overlays.
    """

    def __init__(self, adapter: AMQAdapter, capacity: int, *,
                 growth: float = 2.0, watermark: float = 0.85,
                 fpr_budget: Optional[float] = None,
                 split_ratio: float = 0.5,
                 max_levels: Optional[int] = None,
                 max_level_capacity: Optional[int] = None,
                 device=None,
                 **base_kwargs: Any):
        """Build the cascade with a single fresh base-capacity level.

        ``max_level_capacity`` clamps the geometric ladder (the tiered
        wrapper derives it from ``device_budget_bytes``). ``device``: as
        for ``make``; every level lives there.
        """
        if not adapter.capabilities.supports_expand:
            raise NotImplementedError(
                f"{adapter.name}: backend cannot auto-expand "
                "(capabilities.supports_expand is False)")
        if not adapter.growth_sizings:
            raise ValueError(f"{adapter.name}: no growth_sizings hook")
        if growth <= 1.0:
            raise ValueError(f"growth factor must be > 1, got {growth}")
        if not 0.0 < watermark <= 1.0:
            raise ValueError(f"watermark must be in (0, 1], got {watermark}")
        if not 0.0 < split_ratio < 1.0:
            raise ValueError(
                f"split_ratio must be in (0, 1), got {split_ratio}")
        self.adapter = adapter
        self.device = handle_device(adapter, device)
        self.base_capacity = int(capacity)
        self.growth = float(growth)
        self.watermark = float(watermark)
        self.split_ratio = float(split_ratio)
        self.max_levels = max_levels
        self.max_level_capacity = (None if max_level_capacity is None
                                   else int(max_level_capacity))
        if (self.max_level_capacity is not None
                and self.max_level_capacity < int(capacity)):
            raise ValueError(
                f"max_level_capacity ({self.max_level_capacity}) is below "
                f"the base capacity ({int(capacity)})")
        self.base_kwargs = dict(base_kwargs)
        if fpr_budget is None:
            # Twice the base config's design FPR for level 0, decaying
            # geometrically: level 0's share admits the backend's default
            # sizing and the infinite sum stays bounded.
            probe = make_config(adapter, self.base_capacity, self.device,
                                **self.base_kwargs)
            fpr_budget = (2.0 * probe.expected_fpr(_REF_LOAD)
                          / (1.0 - self.split_ratio))
        self.fpr_budget = float(fpr_budget)
        self.levels: list = []
        self._shares: list = []
        self._alloc_ids: list = []  # allocation index per live level
        self._allocated = 0     # monotonic: shares keep decaying past churn
        self._grow()

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
        """The active (newest) level's config."""
        return self.levels[-1].config

    @property
    def state(self):
        """The active (newest) level's state."""
        return self.levels[-1].state

    @property
    def level_shares(self) -> tuple:
        """Per-live-level FPR shares (oldest first)."""
        return tuple(self._shares)

    @property
    def level_alloc_ids(self) -> tuple:
        """Per-live-level allocation indices (oldest first, monotonic)."""
        return tuple(self._alloc_ids)

    @property
    def num_slots(self) -> int:
        """Aggregate nominal capacity across live levels."""
        return sum(lvl.config.num_slots for lvl in self.levels)

    @property
    def table_bytes(self) -> int:
        """Aggregate memory footprint across live levels."""
        return sum(lvl.config.table_bytes for lvl in self.levels)

    @property
    def load_factor(self) -> float:
        """Aggregate occupancy: total stored keys / total slots."""
        return self.count() / self.num_slots

    def count(self) -> int:
        """Total stored-key count across all levels."""
        return sum(lvl.count() for lvl in self.levels)

    def expected_fpr(self, load_factor: Optional[float] = None) -> float:
        """Aggregate analytic FPR ``1 - prod(1 - eps_i)`` over levels, each
        at its current load (or every level at ``load_factor``)."""
        miss = 1.0
        for lvl in self.levels:
            lf = lvl.load_factor if load_factor is None else load_factor
            miss *= 1.0 - lvl.config.expected_fpr(lf)
        return 1.0 - miss

    def report(self) -> CascadeReport:
        """Per-level and aggregate statistics (a :class:`CascadeReport`)."""
        stats, miss = [], 1.0
        slots = bytes_ = total = 0
        for i, (lvl, share) in enumerate(zip(self.levels, self._shares)):
            c = lvl.count()
            lf = c / lvl.config.num_slots
            eps = lvl.config.expected_fpr(lf)
            stats.append(LevelStats(i, lvl.config.num_slots, c, lf,
                                    lvl.config.table_bytes, eps, share))
            slots += lvl.config.num_slots
            bytes_ += lvl.config.table_bytes
            total += c
            miss *= 1.0 - eps
        return CascadeReport(tuple(stats), slots, bytes_, total,
                             total / slots if slots else 0.0,
                             1.0 - miss, self.fpr_budget)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        """Summarize backend, level count, and aggregate size."""
        return (f"CascadeHandle({self.adapter.name!r}, "
                f"levels={len(self.levels)}, slots={self.num_slots}, "
                f"bytes={self.table_bytes}, device={self.device}, "
                f"budget={self.fpr_budget:.2e})")

    # -- growth --------------------------------------------------------------

    def _config_for(self, capacity: int, share: float, prev=None):
        """Cheapest sizing on the adapter's ladder meeting ``share``; the
        tightest when the ladder tops out (visible in ``report()``). With
        a ``grow_config`` hook and a previous level, derived from it."""
        cfg = None
        for overlay in self.adapter.growth_sizings:
            if prev is not None and self.adapter.grow_config is not None:
                cfg = self.adapter.grow_config(prev, self.growth, **overlay)
            else:
                cfg = make_config(self.adapter, capacity, self.device,
                                  **{**self.base_kwargs, **overlay})
            if cfg.expected_fpr(_REF_LOAD) <= share:
                break
        return cfg

    def _level_capacity(self, alloc_index: int) -> int:
        """Deterministic level sizing: geometric ladder, then the clamp."""
        capacity = max(1, int(round(
            self.base_capacity * self.growth ** alloc_index)))
        if self.max_level_capacity is not None:
            capacity = min(capacity, self.max_level_capacity)
        return capacity

    def _grow(self) -> bool:
        """Allocate the next level; False if ``max_levels`` forbids it."""
        if self.max_levels is not None and len(self.levels) >= self.max_levels:
            return False
        i = self._allocated
        capacity = self._level_capacity(i)
        share = fpr_share(self.fpr_budget, i, self.split_ratio)
        prev = self.levels[-1].config if self.levels else None
        self.levels.append(FilterHandle(
            self.adapter, self._config_for(capacity, share, prev),
            device=self.device))
        self._shares.append(share)
        self._alloc_ids.append(i)
        self._allocated += 1
        return True

    # -- tier surgery (DESIGN.md §12) ----------------------------------------

    def detach_oldest(self):
        """Remove and return the oldest level: ``(handle, share, alloc_id)``.

        The tiered wrapper's demotion primitive. The active (newest) level
        can never be detached: a cascade always has a write target.
        """
        if len(self.levels) <= 1:
            raise ValueError(
                "cannot detach the active level: a cascade needs at least "
                "one device-resident write target")
        return (self.levels.pop(0), self._shares.pop(0),
                self._alloc_ids.pop(0))

    def attach_oldest(self, handle: FilterHandle, share: float,
                      alloc_id: int) -> None:
        """Re-attach a detached level as the oldest (promotion); its
        ``alloc_id`` must predate every live level's."""
        if self._alloc_ids and alloc_id >= self._alloc_ids[0]:
            raise ValueError(
                f"attach_oldest: alloc_id {alloc_id} does not predate the "
                f"oldest live level's ({self._alloc_ids[0]})")
        self.levels.insert(0, handle)
        self._shares.insert(0, share)
        self._alloc_ids.insert(0, alloc_id)

    # -- lifecycle (DESIGN.md §10) -------------------------------------------

    def snapshot(self) -> Snapshot:
        """Snapshot all live levels as one versioned host-side payload:
        level ``i``'s arrays under ``level<i>/``, and in ``meta["levels"]``
        each level's fingerprint, FPR share and allocation index."""
        if not self.adapter.capabilities.supports_snapshot:
            raise NotImplementedError(
                f"{self.name}: state cannot be snapshotted "
                "(capabilities.supports_snapshot is False)")
        arrays, levels = {}, []
        for i, lvl in enumerate(self.levels):
            for k, v in self.adapter.snapshot(lvl.config, lvl.state).items():
                arrays[f"level{i}/{k}"] = v
            levels.append({
                "fingerprint": config_fingerprint(self.adapter, lvl.config),
                "share": self._shares[i],
                "alloc_index": self._alloc_ids[i],
                "count": lvl.count(),
            })
        meta = {"levels": levels, "allocated": self._allocated,
                "base_capacity": self.base_capacity, "growth": self.growth,
                "watermark": self.watermark, "fpr_budget": self.fpr_budget,
                "split_ratio": self.split_ratio,
                "max_level_capacity": self.max_level_capacity,
                "count": self.count()}
        return Snapshot(backend=self.name, kind="cascade", fingerprint="",
                        arrays=arrays, meta=meta,
                        configs=tuple(lvl.config for lvl in self.levels))

    def restore(self, snap: Snapshot) -> "CascadeHandle":
        """Rebuild every live level from a cascade snapshot — validated.

        Level configs come from the snapshot when it was taken in this
        process; a file-loaded one replays the cascade's deterministic
        level sizing and checks each config against its recorded
        fingerprint. Any disagreement raises
        :class:`~repro_torch.amq.protocol.SnapshotMismatchError`. Returns
        ``self``.
        """
        if snap.kind != "cascade":
            raise SnapshotMismatchError(
                f"cannot restore a {snap.kind!r} snapshot onto a cascade "
                "(static-filter snapshots restore onto FilterHandles)")
        if snap.backend != self.name:
            raise SnapshotMismatchError(
                f"snapshot is from backend {snap.backend!r}, "
                f"this cascade is {self.name!r}")
        meta = snap.meta
        for knob in ("base_capacity", "growth", "split_ratio",
                     "watermark", "fpr_budget", "max_level_capacity"):
            if getattr(self, knob) != meta.get(knob):
                raise SnapshotMismatchError(
                    f"cascade {knob} mismatch: snapshot has "
                    f"{meta.get(knob)}, this handle was built with "
                    f"{getattr(self, knob)}")
        levels_meta = meta["levels"]
        configs = self._level_configs(snap.configs, levels_meta)
        levels = []
        for i, cfg in enumerate(configs):
            state = self.adapter.restore(cfg, level_arrays(snap, f"level{i}/"),
                                         self.device)
            levels.append(FilterHandle(self.adapter, cfg, state,
                                       device=self.device))
        self.levels = levels
        self._shares = [lm["share"] for lm in levels_meta]
        self._alloc_ids = [lm["alloc_index"] for lm in levels_meta]
        self._allocated = meta["allocated"]
        return self

    def _level_configs(self, configs, levels_meta) -> list:
        """The snapshot's level configs (replayed from the sizing when it
        carries none), each checked against its recorded fingerprint."""
        if not configs:  # file-loaded: replay the deterministic sizing
            configs, prev = [], None
            for lm in levels_meta:
                cfg = self._config_for(self._level_capacity(lm["alloc_index"]),
                                       lm["share"], prev)
                configs.append(cfg)
                prev = cfg
        if len(configs) != len(levels_meta):
            raise SnapshotMismatchError(
                f"snapshot carries {len(configs)} level configs for "
                f"{len(levels_meta)} recorded levels")
        for i, (cfg, lm) in enumerate(zip(configs, levels_meta)):
            got = config_fingerprint(self.adapter, cfg)
            if got != lm["fingerprint"]:
                raise SnapshotMismatchError(
                    f"level {i} config fingerprint mismatch:\n"
                    f"  snapshot: {lm['fingerprint']}\n  rebuilt:  {got}")
        return list(configs)

    # -- ops -----------------------------------------------------------------

    def _keys(self, keys):
        return normalize_keys(keys, device=self.device)

    def insert(self, keys, *, bulk: bool = False,
               dedup_within_batch: bool = False,
               valid=None) -> InsertReport:
        """Insert a batch, growing the cascade as needed.

        Keys land in the active level, throttled to its watermark headroom;
        keys it rejects, or that overflow it, go to the next (``growth``
        times larger) level. ``ok`` is False only when growth is exhausted
        (``max_levels``, or the round backstop). Each round reads the
        pending mask, the level's count, its rounds and its rejects back to
        the host.
        """
        keys = self._keys(keys)
        n = int(keys.shape[0])
        pending = ensure_valid(keys, valid)
        ok = torch.zeros((n,), dtype=torch.bool, device=self.device)
        evictions = torch.zeros((n,), dtype=torch.int32, device=self.device)
        rounds = 0
        for _ in range(_MAX_GROW_ROUNDS):
            if not bool(pending.any()):
                break
            level = self.levels[-1]
            headroom = (int(self.watermark * level.config.num_slots)
                        - level.count())
            if headroom <= 0:
                if not self._grow():
                    break
                continue
            # Throttle to headroom so the level never exceeds its
            # watermark (keeps every level's FPR share honest, also for
            # Bloom, whose inserts never fail). A 1-D cumsum.
            take = pending & (torch.cumsum(pending, 0) <= headroom)
            rep = level.insert(keys, bulk=bulk,
                               dedup_within_batch=dedup_within_batch,
                               valid=take)
            landed = take & rep.ok & rep.routed
            ok |= landed
            evictions = torch.where(landed, rep.evictions, evictions)
            rounds += int(rep.rounds)
            pending = pending & ~landed
            if bool((take & ~landed).any()):
                # The level rejected keys: full for this workload.
                if not self._grow():
                    break
        return InsertReport(ok, evictions,
                            torch.tensor(rounds, dtype=torch.int32,
                                         device=self.device),
                            all_routed(keys))

    def query(self, keys, *, valid=None) -> QueryResult:
        """Membership across all levels: one query a level on the device,
        the hits ORed there (no host sync between levels)."""
        keys = self._keys(keys)
        vm = ensure_valid(keys, valid)
        hits = torch.zeros_like(vm)
        routed = all_routed(keys)
        for lvl in self.levels:
            qr = lvl.query(keys, valid=vm)
            hits |= qr.hits & qr.routed
            routed &= qr.routed
        return QueryResult(hits, routed)

    def delete(self, keys, *, valid=None) -> DeleteReport:
        """Delete one stored copy a key, at the newest level holding it.

        Levels are probed newest first with a query; the delete runs only
        where that level reports a hit, so aliasing false deletes are
        bounded by the levels' FPR shares. Two host syncs a level.
        """
        if not self.adapter.capabilities.supports_delete:
            raise NotImplementedError(
                f"{self.name}: append-only structure "
                "(capabilities.supports_delete is False)")
        keys = self._keys(keys)
        pending = ensure_valid(keys, valid)
        ok = torch.zeros_like(pending)
        for lvl in reversed(self.levels):
            if not bool(pending.any()):
                break
            qr = lvl.query(keys, valid=pending)
            target = pending & qr.hits & qr.routed
            if not bool(target.any()):
                continue
            dr = lvl.delete(keys, valid=target)
            done = target & dr.ok & dr.routed
            ok |= done
            pending = pending & ~done
        return DeleteReport(ok, all_routed(keys))

    def apply_ops(self, batch: OpBatch) -> MixedReport:
        """Execute a mixed op stream against the cascade (DESIGN.md §9).

        While the cascade is one level with watermark headroom for every
        insert of the batch, the batch runs as that level's fused pass;
        inserts it still rejected retry through the growing :meth:`insert`.
        Otherwise the batch is replayed in maximal same-op runs against the
        cascade's ops (:func:`segmented_apply_ops`).
        """
        if not isinstance(batch, OpBatch):
            raise TypeError(f"apply_ops takes an OpBatch (OpBatch.make), "
                            f"got {type(batch).__name__}")
        batch = batch.to(self.device)
        if len(self.levels) == 1 and self.adapter.apply_ops is not None:
            inserts = batch.valid & (batch.ops == OP_INSERT)
            level = self.levels[0]
            headroom = (int(self.watermark * level.config.num_slots)
                        - level.count())
            if int(inserts.sum()) <= headroom:
                report = level.apply_ops(batch)
                ok, routed = report.ok, report.routed
                failed = inserts & ~(ok & routed)
                if not bool(failed.any()):
                    return report
                retry = self.insert(batch.keys, valid=failed)
                # Only the retried insert slots become routed; unrouted
                # query/delete slots stay unanswered, never misses.
                return MixedReport(ok | (failed & retry.ok), routed | failed,
                                   report.evictions, report.rounds)
        return segmented_apply_ops(self, batch)

    def compact(self, *, reset_when_empty: bool = True) -> CascadeReport:
        """Free drained levels; returns the post-compaction report.

        Stored tags cannot move between levels (the partial-key constraint
        the cascade exists for), so levels whose count reached zero are
        freed, live ones kept. A fully drained cascade resets to one fresh
        base-capacity level, unless ``reset_when_empty=False`` (the tiered
        wrapper's mode: it keeps the drained active level so that the
        allocation order across tiers holds).
        """
        live = [(lvl, share, aid) for lvl, share, aid
                in zip(self.levels, self._shares, self._alloc_ids)
                if lvl.count() > 0]
        if live:
            self.levels = [lvl for lvl, _, _ in live]
            self._shares = [share for _, share, _ in live]
            self._alloc_ids = [aid for _, _, aid in live]
        elif reset_when_empty:
            self.levels, self._shares, self._alloc_ids = [], [], []
            self._allocated = 0
            self._grow()
        else:
            self.levels = self.levels[-1:]
            self._shares = self._shares[-1:]
            self._alloc_ids = self._alloc_ids[-1:]
        return self.report()


def level_arrays(snap: Snapshot, prefix: str) -> dict:
    """One level's arrays of a cascade or tiered snapshot, prefix removed."""
    return {k[len(prefix):]: v for k, v in snap.arrays.items()
            if k.startswith(prefix)}
