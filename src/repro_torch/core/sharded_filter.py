"""Mesh-sharded Cuckoo filter: fixed partitions routed by a key hash.

Port of ``repro.core.sharded_filter``. The key space is hashed into a
*fixed* number of independent sub-filter **partitions**; each shard of a
mesh owns a contiguous block of whole partitions, and both candidate
buckets of a key live in its partition, so eviction chains never leave
it. Because key→partition never changes, a K→K′ reshard relocates whole
partitions: every packed word moves verbatim and every answer stays the
same (:meth:`ShardedCuckooConfig.resharded`,
:meth:`ShardedCuckooFilter.resharded`).

Routing is fixed-capacity, as in the JAX package: each shard's local batch
is sorted by destination partition into ``[num_partitions, cap]`` bins,
the bins are exchanged, every partition runs its filter op on its stream
under a validity mask, and the results route back by the inverse
exchange. Keys beyond a bin's capacity come back ``routed=False`` for the
caller to retry; none is dropped silently.

**One device, K shards.** The JAX package is single-controller: one
process drives the mesh, ``shard_map`` splits the global batch and
``all_to_all`` exchanges the bins. Here every shard of a :class:`Mesh`
lives on one device (the counterpart of the JAX package's forced host
devices, which its own multi-shard checks use), so the per-shard blocks
are stacked on a leading axis and the exchange is their transpose
``[K_src, K_dst, ...] -> [K_dst, K_src, ...]``: the block shard ``d``
receives from shard ``s`` is the one ``s`` binned for ``d``, as
``all_to_all(split_axis=0, concat_axis=0, tiled=False)`` gives. The K
local batches are routed by one batched stable sort. A mesh over distinct
devices raises ``NotImplementedError``.

:class:`ShardedCuckooFilter` runs the core ops (``core.cuckoo_filter``)
on each partition, one partition after another, so its tables, ``count``,
``ok`` and ``routed`` are the JAX driver's bit for bit. The
``sharded-cuckoo`` adapter (``amq/adapters.py``) runs the ``cuckoo``
adapter's kernel routes on each partition instead.

State tensors are updated in place, partition by partition.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..amq.protocol import ensure_valid
from .bits64 import from_i32
from .cuckoo_filter import CuckooConfig, CuckooState
from .cuckoo_filter import apply_ops as _apply_ops
from .cuckoo_filter import delete as _delete
from .cuckoo_filter import insert as _insert
from .cuckoo_filter import insert_bulk as _insert_bulk
from .cuckoo_filter import query as _query
from .device import resolve_device
from .hashing import fmix32, normalize_keys

_SHARD_SALT = 0x51ED270C


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards a sharded filter spreads over: one device per shard,
    along one named axis (``shape[axis_name]`` is the shard count, as on
    a JAX mesh).

    Every shard must be on the same device (see the module docstring);
    devices are normalized with :func:`~repro_torch.core.device.
    resolve_device`, so ``"cuda"`` names the current card.
    """

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"

    def __post_init__(self):
        devices = tuple(resolve_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(set(devices)) > 1:
            raise NotImplementedError(
                f"mesh over distinct devices {sorted(map(str, set(devices)))}:"
                " the port keeps every shard of a sharded filter on one "
                "device (ROADMAP queue A item 13); placement over distinct "
                "cards waits for a machine with more than one")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]


def make_mesh(num_shards: int, axis_name: str = "data", *,
              device=None) -> Mesh:
    """``num_shards`` shards on ``device`` (default: the GPU)."""
    return Mesh((resolve_device(device),) * num_shards, axis_name)


class ShardedCuckooState(NamedTuple):
    table: torch.Tensor  # int32[num_partitions, num_words] (uint32 bits)
    count: torch.Tensor  # int32[num_partitions]


@dataclasses.dataclass(frozen=True)
class ShardedCuckooConfig:
    """Sharded filter config: fixed partitions mapped onto shards.

    Class name, field order and defaults are the JAX package's, so the
    reprs are equal. ``shard`` is the per-partition :class:`CuckooConfig`;
    ``num_partitions`` (default: ``num_shards``) is fixed at creation and
    is what the routing hash is taken modulo; shard ``d`` owns partitions
    ``[d*P/K, (d+1)*P/K)``. Create with ``partitions_per_shard > 1`` to
    leave resharding headroom (K′ must divide ``num_partitions``).
    """

    shard: CuckooConfig          # per-partition filter config
    num_shards: int
    axis_name: str = "data"
    capacity_factor: float = 2.0  # bin capacity overprovision vs n/partitions
    num_partitions: Optional[int] = None  # default: one per shard

    def __post_init__(self):
        p, k = self.partitions, self.num_shards
        if p % k:
            raise ValueError(
                f"num_partitions={p} must be divisible by "
                f"num_shards={k} (each device owns P/K whole partitions)")

    @property
    def partitions(self) -> int:
        return self.num_partitions or self.num_shards

    @property
    def partitions_per_shard(self) -> int:
        return self.partitions // self.num_shards

    def bin_capacity(self, local_batch: int) -> int:
        cap = int(np.ceil(
            local_batch / self.partitions * self.capacity_factor))
        return max(8, cap)

    def init(self, device=None) -> ShardedCuckooState:
        """Empty state on ``device`` (default: the GPU; raises without one)."""
        device = resolve_device(device)
        return ShardedCuckooState(
            torch.zeros((self.partitions, self.shard.layout.num_words),
                        dtype=torch.int32, device=device),
            torch.zeros((self.partitions,), dtype=torch.int32, device=device))

    @property
    def total_slots(self) -> int:
        return self.partitions * self.shard.num_slots

    @property
    def batch_align(self) -> int:
        """Required batch-width divisor: ops split across ``num_shards``."""
        return self.num_shards

    # -- AMQ protocol surface -----------------------------------------------
    @property
    def num_slots(self) -> int:
        return self.total_slots

    @property
    def table_bytes(self) -> int:
        return self.partitions * self.shard.table_bytes

    def expected_fpr(self, load_factor: float) -> float:
        """Partitions are independent same-config filters: FPR is theirs."""
        return self.shard.expected_fpr(load_factor)

    @staticmethod
    def for_capacity(capacity: int, num_shards: int, load_factor: float = 0.95,
                     axis_name: str = "data", **kw) -> "ShardedCuckooConfig":
        cf = kw.pop("capacity_factor", 2.0)
        pps = kw.pop("partitions_per_shard", 1)
        partitions = num_shards * pps
        per_partition = int(np.ceil(capacity / partitions))
        return ShardedCuckooConfig(
            CuckooConfig.for_capacity(per_partition, load_factor, **kw),
            num_shards, axis_name, cf, partitions)

    def grown(self, factor: float, *, fp_bits: Optional[int] = None
              ) -> "ShardedCuckooConfig":
        """Next cascade level's config: ``factor``-times the capacity.

        Scales the per-partition filter and keeps the topology
        (``num_shards``, ``num_partitions``, ``axis_name``,
        ``capacity_factor``), so all levels of a cascade route alike;
        every other per-partition field is carried over verbatim.
        ``fp_bits`` optionally tightens the level's fingerprints.
        """
        sized = CuckooConfig.for_capacity(
            int(np.ceil(self.shard.num_slots * factor)),
            load_factor=1.0,  # num_slots is already post-load sizing
            fp_bits=self.shard.fp_bits if fp_bits is None else fp_bits,
            bucket_size=self.shard.bucket_size,
            policy=self.shard.policy)
        grown_shard = dataclasses.replace(
            self.shard, num_buckets=sized.num_buckets,
            fp_bits=sized.fp_bits)
        return ShardedCuckooConfig(
            grown_shard,
            self.num_shards, self.axis_name, self.capacity_factor,
            self.num_partitions)

    def resharded(self, num_shards: int, *,
                  axis_name: Optional[str] = None) -> "ShardedCuckooConfig":
        """The same filter spread over ``num_shards`` shards — exactly.

        Only the partition→shard mapping changes; the partition count and
        the per-partition filter, so every stored word, stay fixed.
        ``num_shards`` must divide ``num_partitions``.
        """
        p = self.partitions
        if p % num_shards:
            raise ValueError(
                f"cannot reshard {p} partitions onto {num_shards} shards: "
                "each device must own whole partitions (create the filter "
                "with partitions_per_shard > 1 for resharding headroom)")
        return ShardedCuckooConfig(
            self.shard, num_shards,
            self.axis_name if axis_name is None else axis_name,
            self.capacity_factor, p)


def partition_of(config: ShardedCuckooConfig,
                 keys: torch.Tensor) -> torch.Tensor:
    """Owner partition per key (int64) — a hash independent of the
    in-partition hashes, taken modulo the *fixed* partition count."""
    lo, hi = from_i32(keys[..., 0]), from_i32(keys[..., 1])
    mix = fmix32(lo ^ fmix32(hi ^ _SHARD_SALT))
    return mix % config.partitions


def shard_of(config: ShardedCuckooConfig, keys: torch.Tensor) -> torch.Tensor:
    """Owner shard per key: its partition's current home."""
    return partition_of(config, keys) // config.partitions_per_shard


def _scatter_bins(sorted_values: torch.Tensor, slot: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Bin per-key values (in routing order) at their ``slot``s.

    ``sorted_values`` is ``[..., L, *rest]``, ``slot`` ``[..., L]`` with
    ``width`` for an unrouted key. Returns ``[..., width, *rest]`` zeros
    but at the routed slots. Unrouted keys land in one extra row that is
    dropped (torch has no scatter ``mode="drop"``)."""
    lead, rest = slot.shape[:-1], sorted_values.shape[slot.ndim:]
    rows = math.prod(lead)
    offset = (torch.arange(rows, device=slot.device) * (width + 1)).view(
        lead + (1,))
    bins = torch.zeros((rows * (width + 1),) + rest,
                       dtype=sorted_values.dtype, device=slot.device)
    bins[(slot + offset).reshape(-1)] = sorted_values.reshape((-1,) + rest)
    return bins.view((rows, width + 1) + rest)[:, :width].reshape(
        lead + (width,) + rest)


def _route(config: ShardedCuckooConfig, keys: torch.Tensor, cap: int,
           valid: Optional[torch.Tensor] = None):
    """Local routing: sort keys into ``[num_partitions, cap]`` bins.

    ``keys`` is ``int32[..., L, 2]``: one local batch, or the K local
    batches stacked on a leading axis (each row routed on its own, all by
    one batched stable sort). ``valid`` masks padding keys: they take the
    ``P`` sentinel destination, sort past every partition and claim no
    bin slot.

    Returns (bins int32[..., P, cap, 2], bin_valid bool[..., P, cap],
    order, dest_sorted, idx_in_group, routed_sorted, slot), the last five
    ``[..., L]`` in routing order. ``slot`` is the flat bin address per
    sorted key (``P*cap`` = unrouted); extra per-key channels (the mixed
    batch's op codes) are binned at the same slots.
    """
    P = config.partitions
    L = keys.shape[-2]
    dest = partition_of(config, keys)
    if valid is not None:
        dest = torch.where(valid.to(torch.bool), dest, P)
    dest_s, order = torch.sort(dest, dim=-1, stable=True)
    keys_s = torch.gather(keys, -2, order[..., None].expand(order.shape + (2,)))
    first_of_group = torch.searchsorted(dest_s, dest_s, side="left")
    idx_in_group = torch.arange(L, device=keys.device) - first_of_group
    routed = (idx_in_group < cap) & (dest_s < P)
    slot = torch.where(routed, dest_s * cap + idx_in_group, P * cap)
    lead = keys.shape[:-2]
    bins = _scatter_bins(keys_s, slot, P * cap).view(lead + (P, cap, 2))
    bin_valid = _scatter_bins(routed, slot, P * cap).view(lead + (P, cap))
    return bins, bin_valid, order, dest_s, idx_in_group, routed, slot


def _unroute(order, dest_s, idx_in_group, routed, back, fill=False):
    """Inverse of :func:`_route` for a per-key result channel
    ``back[..., S, cap]``: each key's bin entry in batch order, ``fill``
    where it was not routed. Out-of-range bin addresses are clamped
    before the gather (JAX clamps them inside it)."""
    S, cap = back.shape[-2:]
    addr = dest_s.clamp(max=S - 1) * cap + idx_in_group.clamp(max=cap - 1)
    got = torch.gather(back.reshape(back.shape[:-2] + (S * cap,)), -1, addr)
    got = torch.where(routed, got, fill)
    return torch.zeros_like(got).scatter(-1, order, got)


# Per-partition op: (op, config, state, keys, valid, ops, dedup) ->
# (state', ok bool[m]).
PartitionOp = Callable[..., Tuple[CuckooState, torch.Tensor]]


def core_partition_op(op: str, config: CuckooConfig, state: CuckooState,
                      keys: torch.Tensor, valid: torch.Tensor,
                      ops: Optional[torch.Tensor], dedup: bool):
    """One partition's op through the core (bit-exact with ``repro``)."""
    if op == "apply_ops":
        state, ok, _ = _apply_ops(config, state, keys, ops, valid=valid)
    elif op == "insert":
        state, ok, _ = _insert(config, state, keys, valid=valid,
                               dedup_within_batch=dedup)
    elif op == "insert_bulk":
        state, ok, _ = _insert_bulk(config, state, keys, valid=valid,
                                    dedup_within_batch=dedup)
    elif op == "delete":
        state, ok = _delete(config, state, keys, valid=valid)
    elif op == "query":
        ok = _query(config, state, keys) & valid
    else:
        raise ValueError(f"unknown op {op!r}")
    return state, ok


def _make_sharded_op(config: ShardedCuckooConfig, op: str, local_batch: int,
                     dedup_within_batch: bool = False,
                     per_partition: PartitionOp = core_partition_op):
    """Build the function that runs one op over every shard.

    Returns ``fn(table, count, keys, valid, ops=None) -> (table, count,
    result, routed)`` over the stacked state and the global batch, which
    splits into ``num_shards`` contiguous local batches. Keys are binned
    per destination partition, the bins exchanged, and each partition's
    stream (``K*cap`` slots, source-shard-major) runs ``per_partition``.

    ``dedup_within_batch`` is whole-batch dedup, because duplicates of a
    key share its partition. For ``"apply_ops"`` the op codes are binned
    at the keys' slots and travel the same exchange; the routing sort is
    stable and the exchange concatenates source shards in mesh order, so
    same-key operations reach their partition in global batch order.
    """
    cap = config.bin_capacity(local_batch)
    K = config.num_shards
    p_local = config.partitions_per_shard
    P = config.partitions

    def regroup(x):
        # [K_dst, K_src, p_local*cap, ...] received blocks -> [P, K*cap,
        # ...] per-partition streams (source-shard-major).
        x = x.reshape((K, K, p_local, cap) + x.shape[3:]).transpose(1, 2)
        return x.reshape((P, K * cap) + x.shape[4:])

    def ungroup(x):
        # Inverse of regroup, for result channels.
        x = x.reshape((K, p_local, K, cap) + x.shape[2:]).transpose(1, 2)
        return x.reshape((K, K, p_local * cap) + x.shape[4:])

    def exchange(x):
        # [K_src, K_dst, ...] -> [K_dst, K_src, ...]: all_to_all on one
        # device.
        return x.transpose(0, 1)

    def fn(table, count, keys, valid, ops=None):
        n = keys.shape[0]
        if n % K:
            raise ValueError(f"batch size {n} not divisible by "
                             f"num_shards={K}")
        local, lvalid = keys.reshape(K, n // K, 2), valid.reshape(K, n // K)
        bins, bin_valid, order, dest_s, idxg, routed, slot = _route(
            config, local, cap, lvalid)
        part_keys = regroup(exchange(bins.reshape(K, K, p_local * cap, 2)))
        part_valid = regroup(exchange(bin_valid.reshape(K, K, p_local * cap)))
        part_ops = None
        if op == "apply_ops":
            ops_s = torch.gather(ops.to(torch.int32).reshape(K, n // K), -1,
                                 order)
            part_ops = regroup(exchange(_scatter_bins(ops_s, slot, P * cap)
                                        .reshape(K, K, p_local * cap)))

        count = count.clone()
        ok = torch.empty((P, K * cap), dtype=torch.bool, device=keys.device)
        for p in range(P):
            row = table[p]
            state, ok[p] = per_partition(
                op, config.shard, CuckooState(row, count[p].clone()),
                part_keys[p], part_valid[p],
                None if part_ops is None else part_ops[p],
                dedup_within_batch)
            if state.table.data_ptr() != row.data_ptr():
                row.copy_(state.table)
            count[p] = state.count

        back = exchange(ungroup(ok)).reshape(K, P, cap)
        result = _unroute(order, dest_s, idxg, routed, back).reshape(n)
        routed_out = torch.zeros_like(routed).scatter(-1, order, routed)
        return table, count, result, routed_out.reshape(n)

    return fn


class ShardedCuckooFilter:
    """Driver: owns the sharded state and runs the core ops over a mesh.

    ``mesh`` must have ``config.axis_name`` with size ``num_shards``. The
    global batch splits into ``num_shards`` local batches; results come
    back in batch order. Bin capacity is sized from ``local_batch``.
    """

    def __init__(self, config: ShardedCuckooConfig, mesh: Mesh,
                 local_batch: int,
                 state: Optional[ShardedCuckooState] = None):
        if mesh.shape[config.axis_name] != config.num_shards:
            raise ValueError(
                f"mesh axis {config.axis_name} has size "
                f"{mesh.shape[config.axis_name]}, want {config.num_shards}")
        self.config = config
        self.mesh = mesh
        self.local_batch = local_batch
        self._ops = {}  # (op, dedup) -> sharded op, built lazily
        device = mesh.device
        self.state = (config.init(device) if state is None else
                      ShardedCuckooState(*(t.to(device) for t in state)))

    def _op(self, op: str, dedup: bool = False):
        key = (op, dedup)
        if key not in self._ops:
            self._ops[key] = _make_sharded_op(self.config, op,
                                              self.local_batch,
                                              dedup_within_batch=dedup)
        return self._ops[key]

    def _run(self, op, keys, valid=None, dedup=False, ops=None):
        keys = normalize_keys(keys, device=self.mesh.device)
        valid = ensure_valid(keys, valid)
        if ops is not None:
            ops = torch.as_tensor(ops, dtype=torch.int32, device=keys.device)
        table, count, result, routed = self._op(op, dedup)(
            self.state.table, self.state.count, keys, valid, ops)
        if op != "query":
            self.state = ShardedCuckooState(table, count)
        return result, routed

    def insert(self, keys, bulk: bool = False, *,
               dedup_within_batch: bool = False,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (ok, routed): ok[i] requires routed[i]; retry ~routed keys.

        ``bulk=True`` runs core ``insert_bulk`` on every partition.
        ``valid`` masks caller padding (masked keys report
        ``routed=False``).
        """
        return self._run("insert_bulk" if bulk else "insert", keys,
                         valid, dedup_within_batch)

    def query(self, keys, valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._run("query", keys, valid)

    def delete(self, keys, valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._run("delete", keys, valid)

    def apply_ops(self, keys, ops, valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mixed-batch pass: -> (ok, routed), ok per that slot's op code;
        each partition replays its slice in global batch order."""
        return self._run("apply_ops", keys, valid, ops=ops)

    @property
    def total_count(self) -> int:
        return int(self.state.count.sum())

    def resharded(self, mesh: Mesh,
                  num_shards: Optional[int] = None) -> "ShardedCuckooFilter":
        """Exact K→K′ migration: the same partitions over ``mesh``.

        The new driver holds a copy of the state (the tables are updated
        in place, so the two drivers stay independent); key→partition is
        fixed, so every answer is the same. The global batch is kept:
        local batches scale inversely with K.
        """
        k = num_shards or mesh.shape[self.config.axis_name]
        return ShardedCuckooFilter(
            self.config.resharded(k), mesh,
            max(1, self.local_batch * self.config.num_shards // k),
            state=ShardedCuckooState(*(t.clone() for t in self.state)))
