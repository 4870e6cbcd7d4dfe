"""The ``cuckoo``, ``bloom``, ``tcf``, ``gqf``, ``bcht``, ``sharded-cuckoo``
and ``cpu-cuckoo`` backends behind the unified AMQ protocol.

Port of the ``CUCKOO``, ``BLOOM``, ``TCF``, ``GQF``, ``BCHT``,
``SHARDED_CUCKOO`` and ``CPU_CUCKOO`` adapters of ``repro.amq.adapters``,
of their lifecycle
hooks (snapshots, the cascade's sizing ladders, the cold tier's host
probes) and of ``segmented_apply_ops``. Where the JAX
adapters run XLA code, these run the hot operations on the CUDA kernels
(``kernels/ops.py``; on CPU tensors, their plain versions).

``bloom`` (the blocked Bloom filter, append-only): insert is the Bloom
insert kernel, query the Bloom query kernel; every valid insert is ``ok``
and reports no evictions and no rounds. It has no fused mixed path: the
handle serves its op batches with :func:`segmented_apply_ops`.

``tcf``, ``gqf`` and ``bcht`` (the paper's dynamic baselines) call their
filter modules as the JAX adapters do, with the same capabilities; every
report's evictions and rounds are zero, and ``dedup_within_batch`` raises
``NotImplementedError``. The TCF's and BCHT's rounds are torch ops on the
table's device; the GQF's insert and delete are the serial kernels G1 and
G2 (``kernels/csrc/gqf_serial.cu``) on the card, and its query torch ops.
None has a fused mixed path.

``sharded-cuckoo`` is the mesh-sharded filter (``core/sharded_filter.py``:
fixed partitions, fixed-capacity routing, the exchange a transpose on the
one device every shard lives on). Each partition runs the ``cuckoo``
adapter's routes below on ``CuckooState(table[p], count[p])``, one
partition after another, so its tables hold the JAX adapter's keys in the
kernels' placement; ``routed`` and the answers on a given table are the
JAX adapter's bit for bit. Its config carries its mesh, which fixes the
handle's device (``config_device``).

``cpu-cuckoo`` is the pure-Python sequential filter on the host
(``filters/cpu_reference.py``): one op at a time, in batch order. Its
``apply_ops`` is the literal sequential replay, the oracle the fused
paths are tested against.

Each ``cuckoo`` insert entry point routes by ``core.resolve_engine(config,
bulk)``:

* ``insert`` under ``auto``, ``legacy`` or ``frontier``, and
  ``insert_bulk`` under ``legacy`` (or a forced ``frontier``): an insert
  kernel over the whole batch — the direct-insert kernel for ``insert``,
  the bucket-major bulk kernel for ``insert_bulk`` (in place of the core's
  two sorted phases). The keys it could not place (both buckets full) are
  compacted in batch order and handed to the eviction round loop; only
  ``insert_engine="frontier"`` hands ``insert``'s residue to the batched
  BFS frontier instead (the loop is the faster of the two on the card,
  PERF.md §7, and the kernel's racing placement leaves the table unlike
  the JAX adapter's either way). ``ok`` and
  ``evictions`` are scattered back to batch order. ``rounds`` is the
  engine's rounds plus the kernel pass, counted as the phases it stands
  for: one for ``insert``, two for ``insert_bulk`` (the core's primary
  and alternate phases, as there). The kernel places keys in another
  order than the core's engines, so the table differs from the JAX
  adapter's by placement (it holds the same keys; core ``insert`` is the
  bit-exact one).
* ``orientation`` (``insert_bulk``'s ``auto``): the core's
  graph-orientation build, torch ops on the table's device, as the JAX
  adapter runs the XLA core there.
* ``query``: the query kernel.
* ``delete``: the mixed-op kernel with every op a DELETE.
* ``apply_ops``: the core's per-key algebra (``core.net_effects``: each
  key's stored copies, the segmented saturating counter, the net effect
  per key), which answers every query and delete; then the net deletes
  through ``delete`` (the mixed-op kernel) and the net inserts through
  the routes above — ``insert`` where they are sparse (at most ``max(8, n
  // 8)``, as core ``apply_ops`` decides), ``insert_bulk`` over the full
  width under their mask where they are dense. The answers are core
  ``apply_ops``'s; the table holds the same keys, placed by the kernels.
  The mixed-op kernel does not answer the batch itself: its inserts are
  direct only, and a key whose direct insert failed would leave later
  queries and deletes of it in the batch unlike the sequential replay.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import convert
from ..core import cuckoo_filter as CF
from ..core import sharded_filter as SF
from ..core.device import resolve_device
from ..core.hashing import keys_to_numpy, normalize_keys
from ..filters import bcht as HT
from ..filters import blocked_bloom as BB
from ..filters import cpu_reference as PYREF
from ..filters import quotient as QF
from ..filters import two_choice as TC
from ..kernels import ops as K
from .protocol import (
    OP_DELETE,
    OP_INSERT,
    OP_QUERY,
    Capabilities,
    DeleteReport,
    InsertReport,
    MixedReport,
    OpBatch,
    QueryResult,
    SnapshotMismatchError,
    all_routed,
    ensure_valid,
)


@dataclasses.dataclass(frozen=True)
class AMQAdapter:
    """One backend behind the AMQ protocol (plain callables, no state).

    The lifecycle hooks are the JAX package's:

    * ``growth_sizings`` — the cascade's sizing ladder (DESIGN.md §8):
      sizing-kwarg overlays from loosest to tightest; a new level takes
      the first whose config meets its FPR share. ``grow_config``
      (``(prev_config, factor, **overlay) -> config``) derives a level
      from the one before; the sharded backend sets it, so that every
      level of a cascade of shards keeps one mesh.
    * ``config_device(config) -> torch.device`` — for a backend whose
      config places its state (the sharded backend's mesh): the device
      the handle runs on, and ``make_config`` then takes ``device=`` (see
      :func:`make_config`). None: the handle picks the device.
    * ``snapshot(config, state) -> {name: np.ndarray}`` pulls the packed
      state to the host; ``restore(config, arrays, device) -> state``
      places it back on ``device`` under the same config (the handle
      checks the fingerprint first). ``fingerprint`` overrides
      :func:`default_fingerprint`.
    * ``host_query(config, arrays, keys, *, device) -> bool[n]`` probes a
      cold level's snapshot arrays in host RAM with numpy gathers, the
      keys hashed on ``device`` by the backend's own hashing; and
      ``host_delete(config, arrays, keys, valid, *, device) -> ok
      bool[n]`` clears one matching slot a key in place (DESIGN.md §12).
    """

    name: str
    capabilities: Capabilities
    make_config: Callable[..., Any]      # (capacity, **kw) -> config
    init: Callable[..., Any]             # (config, device) -> fresh state
    insert: Callable[..., Any]
    query: Callable[..., Any]
    delete: Optional[Callable[..., Any]] = None
    insert_bulk: Optional[Callable[..., Any]] = None
    # (config, state, keys, ops, *, valid) -> (state', MixedReport); None:
    # the handle serves op batches with segmented_apply_ops.
    apply_ops: Optional[Callable[..., Any]] = None
    # A host backend's one device (its state is not a tensor); None: the
    # handle's device, the GPU by default.
    device: Optional[str] = None
    growth_sizings: Optional[tuple] = None
    grow_config: Optional[Callable[..., Any]] = None
    snapshot: Optional[Callable[..., Any]] = None
    restore: Optional[Callable[..., Any]] = None
    fingerprint: Optional[Callable[[Any], str]] = None
    host_query: Optional[Callable[..., Any]] = None
    host_delete: Optional[Callable[..., Any]] = None
    config_device: Optional[Callable[[Any], torch.device]] = None


def make_config(adapter: AMQAdapter, capacity, device=None, **kw):
    """``adapter.make_config(capacity, **kw)``, handed the handle's
    ``device`` where the adapter's config places its state on one."""
    if adapter.config_device is not None:
        kw["device"] = device
    return adapter.make_config(capacity, **kw)


# ---------------------------------------------------------------------------
# Lifecycle hooks (DESIGN.md §10): snapshot / restore / config fingerprints.
# ---------------------------------------------------------------------------

def default_fingerprint(config) -> str:
    """Config identity for snapshot validation: the frozen-dataclass repr
    (the port's configs keep the JAX package's class names, field order
    and defaults, so the strings are equal across the packages)."""
    return repr(config)


def config_fingerprint(adapter: AMQAdapter, config) -> str:
    """The adapter's fingerprint for ``config`` (custom hook or default)."""
    fn = adapter.fingerprint or default_fingerprint
    return fn(config)


def state_snapshot(config, state) -> dict:
    """Every field of the state on the host, in the JAX package's names and
    dtypes (``convert.state_to_numpy``: one device-to-host copy a field,
    owned)."""
    del config
    return convert.state_to_numpy(state)


# The snapshot dtype of each state field: tables, the TCF's stash and the
# BCHT's key words carry uint32 bits, which the port holds as int32.
_SNAPSHOT_DTYPES = {f: np.dtype(np.uint32) for f in convert.UINT32_FIELDS}


def _validated_state_arrays(config, arrays):
    """Check snapshot arrays against the config's state template.

    The template is ``config.init(device="meta")``: shapes and dtypes with
    no allocation (restore latency is a tracked metric). Returns
    ``(state_cls, host arrays in field order)``; any disagreement raises
    :class:`~repro_torch.amq.protocol.SnapshotMismatchError`.
    """
    template = config.init(device="meta")
    missing = set(template._fields) - set(arrays)
    if missing:
        raise SnapshotMismatchError(
            f"snapshot is missing state arrays {sorted(missing)} "
            f"(has {sorted(arrays)})")
    values = []
    for f in template._fields:
        t = getattr(template, f)
        want = _SNAPSHOT_DTYPES.get(
            f, np.dtype(str(t.dtype).removeprefix("torch.")))
        a = np.asarray(arrays[f])
        if tuple(a.shape) != tuple(t.shape) or a.dtype != want:
            raise SnapshotMismatchError(
                f"state array {f!r}: snapshot has {a.dtype}"
                f"{list(a.shape)}, config expects {want}{list(t.shape)}")
        values.append(a)
    return type(template), values


def state_restore(config, arrays, device):
    """Validate against the template, then place on ``device``: each array
    copied once into a tensor that owns its memory (``convert.owned_tensor``)."""
    state_cls, values = _validated_state_arrays(config, arrays)
    return state_cls(*(convert.owned_tensor(a, device) for a in values))


# ---------------------------------------------------------------------------
# Cold-tier host probes (DESIGN.md §12): numpy gathers over the packed
# snapshot arrays a demoted level left in host RAM. The per-key tags and
# buckets come from the backend's own hashing on the handle's device (the
# hash kernel on the GPU), so a cold probe answers as the level did there;
# only the [n]-sized results cross to the host.
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _host_mask(valid, n: int) -> np.ndarray:
    if valid is None:
        return np.ones((n,), bool)
    if isinstance(valid, torch.Tensor):
        valid = _np(valid)
    return np.asarray(valid, bool)


def _np_bucket_tags(table: np.ndarray, buckets: np.ndarray, lay) -> np.ndarray:
    """Numpy mirror of ``layout.bucket_tags``: -> uint32[n, bucket_size]."""
    words = table.reshape(-1, lay.words_per_bucket)[buckets]  # [n, wpb] rows
    shifts = np.arange(lay.tags_per_word, dtype=np.uint32) * np.uint32(
        lay.fp_bits)
    tags = (words[:, :, None] >> shifts) & np.uint32(lay.fp_mask)
    return tags.reshape(words.shape[0], lay.bucket_size)


def _cuckoo_host_prepare(config, keys, device):
    """Per-key probe scalars (match tags, candidate buckets) as numpy."""
    tag, i1, i2 = CF.prepare_keys(config, normalize_keys(keys, device=device))
    t1, t2 = config.placement.query_match_tags(tag)
    return tuple(_np(x).astype(np.uint32) for x in (t1, t2, i1, i2))


def _cuckoo_host_query(config, arrays, keys, *, device=None) -> np.ndarray:
    """Numpy membership probe over a cold level's snapshot arrays."""
    lay = config.layout
    table = np.asarray(arrays["table"])
    t1, t2, i1, i2 = _cuckoo_host_prepare(config, keys, device)
    hit1 = (_np_bucket_tags(table, i1, lay) == t1[:, None]).any(axis=-1)
    hit2 = (_np_bucket_tags(table, i2, lay) == t2[:, None]).any(axis=-1)
    return hit1 | hit2


def _cuckoo_host_delete(config, arrays, keys, valid=None, *,
                        device=None) -> np.ndarray:
    """Clear one matching slot a key in the host-RAM table, in place.

    Candidates come from the same probe as ``host_query``; the clears run
    key by key, so duplicate deletes of one key consume distinct stored
    copies. Cold deletes are the rare path (DESIGN.md §12): the loop runs
    only over keys whose buckets matched at all.
    """
    lay = config.layout
    table = arrays["table"]
    if not (isinstance(table, np.ndarray) and table.flags.writeable):
        table = arrays["table"] = np.array(table, np.uint32)
    n = int(keys.shape[0])
    v = _host_mask(valid, n)
    ok = np.zeros((n,), bool)
    if not v.any():
        return ok
    t1, t2, i1, i2 = _cuckoo_host_prepare(config, keys, device)
    cand1 = (_np_bucket_tags(table, i1, lay) == t1[:, None]).any(axis=-1)
    cand2 = (_np_bucket_tags(table, i2, lay) == t2[:, None]).any(axis=-1)
    wpb, tpw = lay.words_per_bucket, lay.tags_per_word
    fp_mask, fp_bits = np.uint32(lay.fp_mask), lay.fp_bits
    removed = 0
    for i in np.flatnonzero(v & (cand1 | cand2)):
        for bucket, t in ((int(i1[i]), int(t1[i])),
                          (int(i2[i]), int(t2[i]))):
            done = False
            for s in range(lay.bucket_size):
                widx = bucket * wpb + s // tpw
                shift = np.uint32((s % tpw) * fp_bits)
                if int((table[widx] >> shift) & fp_mask) == t:
                    table[widx] &= ~np.uint32(fp_mask << shift)
                    done = True
                    break
            if done:
                ok[i] = True
                removed += 1
                break
    if removed:
        count = arrays["count"]
        arrays["count"] = np.asarray(int(count) - removed,
                                     np.asarray(count).dtype)
    return ok


def _bloom_host_query(config, arrays, keys, *, device=None) -> np.ndarray:
    """Numpy probe of a blocked-Bloom snapshot (all k bits set)."""
    table = np.asarray(arrays["table"])
    block, word, mask = (_np(x) for x in BB._bit_positions(
        config, normalize_keys(keys, device=device)))
    addr = block[:, None].astype(np.int64) * config.words_per_block + word
    words = table[addr]                                  # [n, k]
    mask = mask.astype(np.uint32)
    return ((words & mask) == mask).all(axis=-1)


# ---------------------------------------------------------------------------
# Growth hooks (cascade level sizing, DESIGN.md §8): ordered loosest ->
# tightest sizing overlays; the cascade picks the first meeting a share.
# ---------------------------------------------------------------------------

# The packed bucket layout quantizes tag widths to 32-bit-word fractions,
# so the cuckoo ladder is the three hardware-friendly widths.
_CUCKOO_SIZINGS = tuple({"fp_bits": f} for f in (8, 16, 32))

# Blocked Bloom tightens by raising the per-key bit budget with the
# matching near-optimal hash count k ~= bits_per_key * ln 2.
_BLOOM_SIZINGS = tuple(
    {"bits_per_key": b, "k": max(1, round(b * 0.693))}
    for b in (8, 12, 16, 20, 24, 32, 40))

# The GQF's remainder is an arbitrary bit slice of a uint32 slot word.
_GQF_SIZINGS = tuple({"remainder_bits": r} for r in (8, 12, 16, 20, 24, 28))


def _cuckoo_insert(config, state, keys, *, valid=None,
                   dedup_within_batch=False, _bulk=False):
    engine = CF.resolve_engine(config, _bulk)
    if engine == "orientation":
        state, ok, stats = CF._insert_orient(
            config, state, keys, ensure_valid(keys, valid),
            dedup_within_batch=dedup_within_batch)
        return state, InsertReport(ok, stats.evictions, stats.rounds,
                                   all_routed(keys))
    # An insert kernel over the batch, then the round loop on its residue;
    # only a forced "frontier" hands insert's residue to the frontier
    # (insert_bulk's frontier is the legacy bulk build, as in JAX).
    place_residue = (CF._insert_frontier
                     if config.insert_engine == "frontier" and not _bulk
                     else CF._insert_rounds)
    kernel = K.cuckoo_insert_bulk if _bulk else K.cuckoo_insert_direct
    n = keys.shape[0]
    valid0 = ensure_valid(keys, valid)
    pending = valid0
    if dedup_within_batch:
        first, rep = CF._batch_dedup(keys, valid0)
        pending = pending & first
    state, ok = kernel(config, state, keys, valid=pending)
    evictions = torch.zeros((n,), dtype=torch.int32, device=keys.device)
    rounds = torch.full((), 2 if _bulk else 1, dtype=torch.int32,
                        device=keys.device)
    residue = (pending & ~ok).nonzero().squeeze(1)
    if residue.numel():
        state, ok_res, stats = place_residue(config, state, keys[residue])
        ok[residue] = ok_res
        evictions[residue] = stats.evictions
        rounds = rounds + stats.rounds
    if dedup_within_batch:
        ok = torch.where(first, ok, ok[rep] & valid0)
    return state, InsertReport(ok, evictions, rounds, all_routed(keys))


def _cuckoo_query(config, state, keys, *, valid=None):
    hits = K.cuckoo_query(config, state, keys) & ensure_valid(keys, valid)
    return state, QueryResult(hits, all_routed(keys))


def _cuckoo_delete(config, state, keys, *, valid=None):
    ops = torch.full((keys.shape[0],), OP_DELETE, dtype=torch.int32,
                     device=keys.device)
    state, ok = K.cuckoo_apply_ops(config, state, keys, ops,
                                   ensure_valid(keys, valid))
    return state, DeleteReport(ok, all_routed(keys))


def _cuckoo_apply_ops(config, state, keys, ops, *, valid=None):
    n = keys.shape[0]
    dev = keys.device
    evictions = torch.zeros((n,), dtype=torch.int32, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 0:
        return state, MixedReport(torch.zeros((0,), dtype=torch.bool,
                                              device=dev),
                                  all_routed(keys), evictions, rounds)
    e = CF.net_effects(config, state, keys, ops, ensure_valid(keys, valid))
    # Net deletes first (they free slots the net inserts may take).
    del_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    dels = e.net_del.nonzero().squeeze(1)
    if dels.numel():
        state, rep = _cuckoo_delete(config, state, keys[dels])
        del_ok[dels] = rep.ok
    ins_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    ins = e.net_ins.nonzero().squeeze(1)
    if ins.numel() > max(8, n // 8):
        state, rep = _cuckoo_insert(config, state, keys, valid=e.net_ins,
                                    _bulk=True)
        ins_ok, evictions, rounds = rep.ok, rep.evictions, rep.rounds
    elif ins.numel():
        state, rep = _cuckoo_insert(config, state, keys[ins])
        ins_ok[ins] = rep.ok
        evictions[ins] = rep.evictions
        rounds = rep.rounds
    return state, MixedReport(CF.mixed_ok(e, ins_ok, del_ok),
                              all_routed(keys), evictions, rounds)


def _cuckoo_make_config(capacity, **kw):
    # Registry default: the fmix32 pair-hash, as in the JAX package (the
    # paper's xxhash64 stays available via hash_kind="xxhash64").
    kw.setdefault("hash_kind", "fmix32")
    return CF.CuckooConfig.for_capacity(capacity, **kw)


CUCKOO = AMQAdapter(
    name="cuckoo",
    capabilities=Capabilities(supports_delete=True, supports_bulk=True,
                              counting=True, supports_expand=True,
                              supports_mixed=True, supports_snapshot=True,
                              supports_tiering=True),
    make_config=_cuckoo_make_config,
    init=lambda cfg, device: cfg.init(device),
    insert=_cuckoo_insert,
    insert_bulk=functools.partial(_cuckoo_insert, _bulk=True),
    query=_cuckoo_query,
    delete=_cuckoo_delete,
    apply_ops=_cuckoo_apply_ops,
    growth_sizings=_CUCKOO_SIZINGS,
    snapshot=state_snapshot,
    restore=state_restore,
    host_query=_cuckoo_host_query,
    host_delete=_cuckoo_host_delete,
)


def _bloom_insert(config, state, keys, *, valid=None,
                  dedup_within_batch=False):
    del dedup_within_batch  # idempotent by construction
    state, ok = K.bloom_insert(config, state, keys, ensure_valid(keys, valid))
    n = keys.shape[0]
    return state, InsertReport(
        ok, torch.zeros((n,), dtype=torch.int32, device=keys.device),
        torch.zeros((), dtype=torch.int32, device=keys.device),
        all_routed(keys))


def _bloom_query(config, state, keys, *, valid=None):
    hits = K.bloom_query(config, state, keys) & ensure_valid(keys, valid)
    return state, QueryResult(hits, all_routed(keys))


BLOOM = AMQAdapter(
    name="bloom",
    capabilities=Capabilities(supports_delete=False, counting=False,
                              supports_expand=True, supports_snapshot=True,
                              supports_tiering=True),
    make_config=lambda capacity, **kw: BB.BloomConfig.for_capacity(
        capacity, **kw),
    init=lambda cfg, device: cfg.init(device),
    insert=_bloom_insert,
    query=_bloom_query,
    growth_sizings=_BLOOM_SIZINGS,
    snapshot=state_snapshot,
    restore=state_restore,
    host_query=_bloom_host_query,
)


# ---------------------------------------------------------------------------
# The dynamic baselines (TCF, GQF, BCHT): the filter modules' masks wrapped
# in reports, as the JAX adapters wrap them.
# ---------------------------------------------------------------------------

def _zero_stats(keys: torch.Tensor) -> tuple:
    """Zero evictions and rounds on the keys' device (the baselines')."""
    return (torch.zeros((keys.shape[0],), dtype=torch.int32,
                        device=keys.device),
            torch.zeros((), dtype=torch.int32, device=keys.device))


def _baseline_ops(name: str, module) -> dict:
    """insert / query / delete of a baseline module, as the JAX adapters
    wrap it: bare masks to reports, no dedup within a batch."""

    def insert(config, state, keys, *, valid=None, dedup_within_batch=False):
        if dedup_within_batch:
            raise NotImplementedError(
                f"{name}: dedup_within_batch not supported")
        state, ok = module.insert(config, state, keys, valid)
        return state, InsertReport(ok, *_zero_stats(keys), all_routed(keys))

    def query(config, state, keys, *, valid=None):
        hits = module.query(config, state, keys) & ensure_valid(keys, valid)
        return state, QueryResult(hits, all_routed(keys))

    def delete(config, state, keys, *, valid=None):
        state, ok = module.delete(config, state, keys, valid)
        return state, DeleteReport(ok, all_routed(keys))

    return {"insert": insert, "query": query, "delete": delete}


TCF = AMQAdapter(
    name="tcf",
    capabilities=Capabilities(supports_delete=True, counting=True,
                              supports_snapshot=True),
    make_config=lambda capacity, **kw: TC.TCFConfig.for_capacity(
        capacity, **kw),
    init=lambda cfg, device: cfg.init(device),
    **_baseline_ops("tcf", TC),
    snapshot=state_snapshot,
    restore=state_restore,
)

GQF = AMQAdapter(
    name="gqf",
    capabilities=Capabilities(supports_delete=True, counting=True,
                              serial_insert=True, supports_expand=True,
                              supports_snapshot=True),
    make_config=lambda capacity, **kw: QF.GQFConfig.for_capacity(
        capacity, **kw),
    init=lambda cfg, device: cfg.init(device),
    **_baseline_ops("gqf", QF),
    growth_sizings=_GQF_SIZINGS,
    snapshot=state_snapshot,
    restore=state_restore,
)

BCHT = AMQAdapter(
    name="bcht",
    capabilities=Capabilities(supports_delete=True, counting=True,
                              exact=True, supports_expand=True,
                              supports_snapshot=True),
    make_config=lambda capacity, **kw: HT.BCHTConfig.for_capacity(
        capacity, **kw),
    init=lambda cfg, device: cfg.init(device),
    **_baseline_ops("bcht", HT),
    growth_sizings=({},),  # exact: any level trivially meets its FPR share
    snapshot=state_snapshot,
    restore=state_restore,
)


# ---------------------------------------------------------------------------
# Mesh-sharded cuckoo filter.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedAMQConfig:
    """Protocol config for the sharded backend: inner config + its mesh.

    The mesh's shard count must be the inner config's; its one device is
    where the state lives (``device``).
    """

    inner: SF.ShardedCuckooConfig
    mesh: SF.Mesh

    def __post_init__(self):
        k = self.mesh.shape.get(self.inner.axis_name)
        if k != self.inner.num_shards:
            raise ValueError(
                f"mesh axis {self.inner.axis_name} has size {k}, want "
                f"{self.inner.num_shards}")

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def num_slots(self) -> int:
        """Aggregate nominal capacity across all partitions."""
        return self.inner.num_slots

    @property
    def table_bytes(self) -> int:
        """Aggregate memory footprint across all partitions."""
        return self.inner.table_bytes

    def expected_fpr(self, load_factor: float) -> float:
        """The per-partition filter's FPR (paper Eq. 4): partitions are
        independent same-config cuckoo filters."""
        return self.inner.expected_fpr(load_factor)

    @property
    def batch_align(self) -> int:
        """Dispatch widths must divide across the shards (DESIGN.md §11)."""
        return self.inner.batch_align

    def init(self, device=None) -> SF.ShardedCuckooState:
        """Fresh empty sharded state on the mesh's device (``device``:
        ``"meta"`` for a shape template)."""
        return self.inner.init(self.mesh.device if device is None else device)

    def resharded(self, num_shards: Optional[int] = None, *,
                  mesh: Any = None,
                  axis_name: Optional[str] = None) -> "ShardedAMQConfig":
        """The same filter over another shard layout — exactly.

        Key→partition is fixed, so only the partition→shard placement
        changes: a state restored under the resharded config answers
        every query identically (DESIGN.md §10). Pass ``num_shards`` (a
        divisor of the partition count; that many shards on this mesh's
        device) and/or an explicit ``mesh``.
        """
        ax = axis_name or self.inner.axis_name
        if mesh is None and num_shards is None:
            mesh, num_shards = _default_mesh(ax, None, self.device)
        elif num_shards is None:
            num_shards = mesh.shape[ax]
        # Validate the partition math first: a divisibility error should
        # name partitions, not fail while deriving a default mesh.
        inner = self.inner.resharded(num_shards, axis_name=axis_name)
        if mesh is None:
            mesh, _ = _default_mesh(ax, num_shards, self.device)
        return ShardedAMQConfig(inner, mesh)


def _default_mesh(axis_name: str, num_shards: Optional[int], device):
    """``num_shards`` shards (default one) on ``device`` (default: the
    GPU), and their count."""
    n = num_shards or 1
    return SF.make_mesh(n, axis_name, device=device), n


def _sharded_make_config(capacity, *, num_shards=None, mesh=None,
                         axis_name="data", device=None, **kw):
    if mesh is None:
        mesh, num_shards = _default_mesh(axis_name, num_shards, device)
    elif num_shards is None:
        num_shards = mesh.shape[axis_name]
    kw.setdefault("hash_kind", "fmix32")
    inner = SF.ShardedCuckooConfig.for_capacity(
        capacity, num_shards, axis_name=axis_name, **kw)
    return ShardedAMQConfig(inner, mesh)


def _partition_route(op, config, state, keys, valid, ops, dedup):
    """One partition's op through the ``cuckoo`` adapter's kernel routes
    (``SF.PartitionOp``)."""
    if op == "apply_ops":
        state, rep = _cuckoo_apply_ops(config, state, keys, ops, valid=valid)
    elif op in ("insert", "insert_bulk"):
        state, rep = _cuckoo_insert(config, state, keys, valid=valid,
                                    dedup_within_batch=dedup,
                                    _bulk=op == "insert_bulk")
    elif op == "delete":
        state, rep = _cuckoo_delete(config, state, keys, valid=valid)
    else:
        _, res = _cuckoo_query(config, state, keys, valid=valid)
        return state, res.hits
    return state, rep.ok


def _sharded_run(config, state, keys, op, valid, dedup=False, ops=None):
    valid = ensure_valid(keys, valid)
    # The global batch splits across the shards; bin capacity is sized
    # from the per-shard slice, not the global batch.
    fn = SF._make_sharded_op(config.inner, op,
                             keys.shape[0] // config.inner.num_shards,
                             dedup_within_batch=dedup,
                             per_partition=_partition_route)
    table, count, result, routed = fn(state.table, state.count, keys, valid,
                                      ops)
    return SF.ShardedCuckooState(table, count), result, routed


def _sharded_insert(config, state, keys, *, valid=None,
                    dedup_within_batch=False, _op="insert"):
    state, ok, routed = _sharded_run(config, state, keys, _op, valid,
                                     dedup_within_batch)
    return state, InsertReport(ok, *_zero_stats(keys), routed)


def _sharded_query(config, state, keys, *, valid=None):
    state, hits, routed = _sharded_run(config, state, keys, "query", valid)
    return state, QueryResult(hits, routed)


def _sharded_delete(config, state, keys, *, valid=None):
    state, ok, routed = _sharded_run(config, state, keys, "delete", valid)
    return state, DeleteReport(ok, routed)


def _sharded_apply_ops(config, state, keys, ops, *, valid=None):
    state, ok, routed = _sharded_run(
        config, state, keys, "apply_ops", valid,
        ops=torch.as_tensor(ops, dtype=torch.int32, device=keys.device))
    return state, MixedReport(ok, routed, *_zero_stats(keys))


def _sharded_fingerprint(config: ShardedAMQConfig) -> str:
    """Sharded config identity: per-partition filter + partition count,
    letter for letter the JAX adapter's. Placement (mesh, shard count,
    axis name) and routing overprovision are excluded: they shape where
    partitions live, not what they hold, which is what lets a snapshot
    restore onto another shard count (DESIGN.md §10)."""
    inner = config.inner
    return f"sharded-cuckoo[P={inner.partitions}]:{inner.shard!r}"


def _sharded_grow_config(prev: ShardedAMQConfig, factor: float,
                         **overlay) -> ShardedAMQConfig:
    """Next cascade level: grow the per-partition filter, keep the *same*
    mesh, so every level routes over one topology (DESIGN.md §8 "cascade
    of shards")."""
    return ShardedAMQConfig(
        prev.inner.grown(factor, fp_bits=overlay.pop("fp_bits", None)),
        prev.mesh)


SHARDED_CUCKOO = AMQAdapter(
    name="sharded-cuckoo",
    capabilities=Capabilities(supports_delete=True, supports_bulk=True,
                              supports_sharding=True, counting=True,
                              supports_expand=True, supports_mixed=True,
                              supports_snapshot=True),
    make_config=_sharded_make_config,
    init=lambda cfg, device: cfg.init(device),
    insert=_sharded_insert,
    insert_bulk=functools.partial(_sharded_insert, _op="insert_bulk"),
    query=_sharded_query,
    delete=_sharded_delete,
    apply_ops=_sharded_apply_ops,
    growth_sizings=_CUCKOO_SIZINGS,  # fp_bits flows to the per-partition config
    grow_config=_sharded_grow_config,
    snapshot=state_snapshot,
    # A snapshot restores under another shard count (the fingerprint
    # excludes placement): the exact reshard path.
    restore=state_restore,
    fingerprint=_sharded_fingerprint,
    config_device=lambda cfg: cfg.device,
)


# ---------------------------------------------------------------------------
# Pure-Python oracle (host-side; the conformance reference).
# ---------------------------------------------------------------------------

def _py_mask(keys, valid) -> np.ndarray:
    if valid is None:
        return np.ones((keys.shape[0],), bool)
    return torch.as_tensor(valid).cpu().numpy().astype(bool)


def _host(ok: np.ndarray) -> tuple:
    """(ok, zero evictions, zero rounds, all routed) as CPU tensors."""
    n = ok.shape[0]
    return (torch.from_numpy(ok), torch.zeros((n,), dtype=torch.int32),
            torch.zeros((), dtype=torch.int32),
            torch.ones((n,), dtype=torch.bool))


def _py_insert(config, state, keys, *, valid=None, dedup_within_batch=False):
    raw = keys_to_numpy(keys)
    v = _py_mask(keys, valid)
    ok = np.zeros((raw.shape[0],), bool)
    seen = set()
    for i, k in enumerate(raw.tolist()):
        if not v[i]:
            continue
        if dedup_within_batch and k in seen:
            ok[i] = ok[np.flatnonzero((raw == k) & v)[0]]
            continue
        seen.add(k)
        ok[i] = state.insert(k)
    return state, InsertReport(*_host(ok))


def _py_query(config, state, keys, *, valid=None):
    hits = state.query_batch(keys_to_numpy(keys)) & _py_mask(keys, valid)
    return state, QueryResult(torch.from_numpy(hits),
                              torch.ones((hits.shape[0],), dtype=torch.bool))


def _py_delete(config, state, keys, *, valid=None):
    raw = keys_to_numpy(keys)
    v = _py_mask(keys, valid)
    ok = np.array([v[i] and state.delete(int(k))
                   for i, k in enumerate(raw)], bool)
    return state, DeleteReport(torch.from_numpy(ok),
                               torch.ones((raw.shape[0],), dtype=torch.bool))


def _py_apply_ops(config, state, keys, ops, *, valid=None):
    """The mixed-batch *definition*: a literal sequential replay, one op
    at a time in batch order — the oracle the fused paths are held to."""
    raw = keys_to_numpy(keys)
    ops = torch.as_tensor(ops).cpu().numpy()
    v = _py_mask(keys, valid)
    n = raw.shape[0]
    ok = np.zeros((n,), bool)
    for i in range(n):
        if not v[i]:
            continue
        k = int(raw[i])
        if ops[i] == OP_QUERY:
            ok[i] = state.query(k)
        elif ops[i] == OP_INSERT:
            ok[i] = state.insert(k)
        elif ops[i] == OP_DELETE:
            ok[i] = state.delete(k)
        else:
            raise ValueError(f"unknown op code {ops[i]} at slot {i}")
    ok, evictions, rounds, routed = _host(ok)
    return state, MixedReport(ok, routed, evictions, rounds)


def _py_snapshot(config, state) -> dict:
    """Oracle snapshot: the bucket grid and count (``convert.
    py_cuckoo_to_numpy``). The eviction generator's position is not
    kept: a snapshot carries membership, not future victim choices."""
    del config
    return convert.py_cuckoo_to_numpy(state)


def _py_restore(config, arrays, device=None):
    del device  # the oracle lives on the host
    want = (config.num_buckets, config.bucket_size)
    buckets = np.asarray(arrays.get("buckets"))
    if "buckets" not in arrays or tuple(buckets.shape) != want:
        raise SnapshotMismatchError(
            f"state array 'buckets': snapshot has "
            f"{None if 'buckets' not in arrays else list(buckets.shape)}, "
            f"config expects {list(want)}")
    if "count" not in arrays:
        raise SnapshotMismatchError(
            "snapshot is missing state array 'count' "
            f"(has {sorted(arrays)})")
    return convert.py_cuckoo_from_numpy(arrays, config)


CPU_CUCKOO = AMQAdapter(
    name="cpu-cuckoo",
    capabilities=Capabilities(supports_delete=True, counting=True,
                              serial_insert=True, supports_expand=True,
                              supports_mixed=True, supports_snapshot=True),
    make_config=lambda capacity, **kw: PYREF.PyCuckooConfig.for_capacity(
        capacity, **kw),
    init=lambda cfg, device: cfg.init(),
    insert=_py_insert,
    query=_py_query,
    delete=_py_delete,
    apply_ops=_py_apply_ops,
    device="cpu",
    growth_sizings=_CUCKOO_SIZINGS,
    snapshot=_py_snapshot,
    restore=_py_restore,
)


# ---------------------------------------------------------------------------
# Mixed batches on a backend without a fused path (DESIGN.md §9).
# ---------------------------------------------------------------------------

def segmented_apply_ops(target, batch: OpBatch) -> MixedReport:
    """Execute an :class:`OpBatch` on any handle by segmenting it.

    The fallback behind ``FilterHandle.apply_ops`` for backends without a
    fused path: the batch is split host-side into maximal same-op runs of
    its valid slots, and each run replays the per-op entry point as one
    full-width, ``valid``-masked call. Runs execute in batch order and
    duplicates within a run already serialise inside the per-op calls,
    so same-key operations resolve in batch order. ``target`` is anything
    with the handle op surface.
    """
    ops = batch.ops.cpu().numpy()
    v = batch.valid.cpu().numpy().astype(bool)
    n = ops.shape[0]
    dev = batch.keys.device
    ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    routed = torch.ones((n,), dtype=torch.bool, device=dev)
    evictions = torch.zeros((n,), dtype=torch.int32, device=dev)
    rounds = 0

    live = np.flatnonzero(v)
    if live.size == 0:  # all padding: a no-op
        return MixedReport(ok, routed, evictions,
                           torch.tensor(rounds, dtype=torch.int32, device=dev))
    if ((ops[live] == OP_DELETE).any()
            and not target.capabilities.supports_delete):
        raise NotImplementedError(
            f"{target.name}: mixed batch contains deletes but the backend "
            "is append-only (capabilities.supports_delete is False)")
    o = ops[live]
    bounds = np.flatnonzero(np.diff(o) != 0) + 1
    for s, e in zip(np.concatenate([[0], bounds]),
                    np.concatenate([bounds, [o.size]])):
        mask_np = np.zeros((n,), bool)
        mask_np[live[s:e]] = True
        mask = torch.from_numpy(mask_np).to(dev)
        if o[s] == OP_QUERY:
            r = target.query(batch.keys, valid=mask)
            r_ok = r.hits
        elif o[s] == OP_INSERT:
            r = target.insert(batch.keys, valid=mask)
            r_ok = r.ok
            evictions = torch.where(mask, r.evictions.to(dev), evictions)
            rounds += int(r.rounds)
        else:
            r = target.delete(batch.keys, valid=mask)
            r_ok = r.ok
        ok = torch.where(mask, r_ok.to(dev), ok)
        routed = torch.where(mask, r.routed.to(dev), routed)
    return MixedReport(ok, routed, evictions,
                       torch.tensor(rounds, dtype=torch.int32, device=dev))


DEFAULT_ADAPTERS = {a.name: a for a in
                    (CUCKOO, BLOOM, TCF, GQF, BCHT, SHARDED_CUCKOO,
                     CPU_CUCKOO)}
