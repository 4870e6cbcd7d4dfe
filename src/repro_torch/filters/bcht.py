"""Bucketed Cuckoo Hash Table (BCHT) — exact-membership baseline (Awad et al.).

Port of ``repro.filters.bcht``. Stores *full 64-bit keys* (as lo/hi uint32
pairs, held as int32) instead of fingerprints, so membership answers are
exact (zero FPR) — at ~8 bytes a slot against 2 for the 16-bit filter, the
paper's "order-of-magnitude more memory" point (§5.2).

The same batch-synchronous cuckoo machinery as the core filter, with
slot-granular claims (a slot spans two words in parallel arrays plus a
presence flag, all owned by the claim winner) and DFS eviction only. The
round loop runs on the host with one sync a round, as the core's does,
and each round computes only the keys still pending; the tables are
bit-exact with the JAX package's. The BCHT reads the key's raw words and
``fmix32``: it runs no hash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.bits64 import MASK32, from_i32, to_i32
from ..core.device import resolve_device
from ..core.hashing import fmix32, normalize_keys
from .common import resolve_claims_single

# Keys a chunk of a query's bucket gathers.
_CHUNK = 1 << 22

# While ``INSERT_RECORDS`` holds a list, each :func:`insert` appends a
# dict of its rounds (a host int) and, as device tensors, the keys that
# ran out of ``max_evictions`` (``expired``) and those still pending when
# ``max_rounds`` ran out (``unfinished``). ``None`` records nothing.
INSERT_RECORDS: Optional[list] = None


class BCHTState(NamedTuple):
    key_lo: torch.Tensor   # int32[num_buckets, bucket_size] (uint32 bits)
    key_hi: torch.Tensor   # int32[num_buckets, bucket_size] (uint32 bits)
    used: torch.Tensor     # bool[num_buckets, bucket_size]
    count: torch.Tensor    # int32[]


@dataclasses.dataclass(frozen=True)
class BCHTConfig:
    """Static configuration; class name, field order and defaults are the
    JAX package's, so ``repr(config)`` is identical in both."""

    num_buckets: int          # power of two
    bucket_size: int = 16
    seed: int = 0
    max_evictions: int = 64
    max_rounds: int = 320

    def __post_init__(self):
        if self.num_buckets & (self.num_buckets - 1):
            raise ValueError("BCHT requires power-of-two buckets")

    @property
    def mask(self) -> int:
        return self.num_buckets - 1

    @property
    def num_slots(self) -> int:
        return self.num_buckets * self.bucket_size

    @property
    def table_bytes(self) -> int:
        return self.num_slots * 9  # 8B key + 1b used (rounded up)

    def expected_fpr(self, load_factor: float) -> float:
        """Exact membership (full 64-bit keys stored): zero false
        positives — the "order-of-magnitude more memory" trade (§5.2)."""
        del load_factor
        return 0.0

    def init(self, device=None) -> BCHTState:
        """Empty state on ``device`` (default: the GPU; raises without one)."""
        device = resolve_device(device)
        shape = (self.num_buckets, self.bucket_size)
        return BCHTState(torch.zeros(shape, dtype=torch.int32, device=device),
                         torch.zeros(shape, dtype=torch.int32, device=device),
                         torch.zeros(shape, dtype=torch.bool, device=device),
                         torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def for_capacity(capacity: int, load_factor: float = 0.9,
                     bucket_size: int = 16, **kw) -> "BCHTConfig":
        buckets = max(2, int(np.ceil(capacity / (load_factor * bucket_size))))
        buckets = 1 << int(np.ceil(np.log2(buckets)))
        return BCHTConfig(num_buckets=buckets, bucket_size=bucket_size, **kw)


def _words(keys: torch.Tensor):
    """keys int32[n, 2] -> (lo, hi) uint32 held in int64."""
    return from_i32(keys[:, 0]), from_i32(keys[:, 1])


def _buckets(config: BCHTConfig, lo: torch.Tensor, hi: torch.Tensor):
    """Two bucket choices from the full key (involution via XOR of key mix)."""
    mixed = fmix32(lo ^ fmix32(hi ^ (config.seed & MASK32)))
    i1 = mixed & config.mask
    delta = fmix32(hi ^ fmix32(lo)) & config.mask
    delta = torch.where(delta == 0, 1, delta)
    return i1, i1 ^ delta, delta


def _alt(config: BCHTConfig, bucket, lo, hi):
    _, _, delta = _buckets(config, lo, hi)
    return bucket ^ delta


def _first_free(used_rows: torch.Tensor, start: torch.Tensor):
    """(any free slot, first free slot circularly from ``start``)."""
    b = used_rows.shape[-1]
    idx = (start[:, None] + torch.arange(b, device=start.device)) % b
    free = torch.gather(~used_rows, 1, idx)
    first = free.to(torch.uint8).argmax(dim=1, keepdim=True)
    return free.any(dim=1), torch.gather(idx, 1, first)[:, 0]


def insert(config: BCHTConfig, state: BCHTState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None
           ) -> Tuple[BCHTState, torch.Tensor]:
    """Insert keys int32[n, 2] -> (state', ok bool[n]), in place."""
    n = keys.shape[0]
    dev = keys.device
    b = config.bucket_size
    invalid = config.num_slots
    klo, khi = _words(keys)
    i1, i2, _ = _buckets(config, klo, khi)
    pending = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
               else valid.to(torch.bool).clone())
    key_lo, key_hi, used = state.key_lo, state.key_hi, state.used
    flat_lo, flat_hi, flat_used = (key_lo.view(-1), key_hi.view(-1),
                                   used.view(-1))
    count = state.count.clone()
    cur_lo, cur_hi, cur_bucket = klo.clone(), khi.clone(), i1.clone()
    evict_mode = torch.zeros((n,), dtype=torch.bool, device=dev)
    success = torch.zeros((n,), dtype=torch.bool, device=dev)
    expired = torch.zeros((n,), dtype=torch.bool, device=dev)
    n_evict = torch.zeros((n,), dtype=torch.int32, device=dev)

    rnd = 0
    while rnd < config.max_rounds and bool(pending.any()):
        failed = pending & (n_evict >= config.max_evictions) & evict_mode
        expired |= failed
        pending &= ~failed
        p = pending.nonzero().squeeze(1)
        em, cl, ch = evict_mode[p], cur_lo[p], cur_hi[p]
        j2 = i2[p]
        bucketA = torch.where(em, cur_bucket[p], i1[p])
        start = fmix32(cl) % b
        foundA, slotA = _first_free(used[bucketA], start)
        foundB, slotB = _first_free(used[j2], start)
        foundB &= ~em

        direct = foundA | foundB
        d_addr = (torch.where(foundA, bucketA, j2) * b
                  + torch.where(foundA, slotA, slotB))
        # Eviction action: a victim slot of bucket A chosen by the round.
        vic = fmix32(cl ^ ((rnd * 0x9E3779B9) & MASK32)) % b
        e_addr = bucketA * b + vic
        addr = torch.where(direct, d_addr, e_addr)
        commit = resolve_claims_single(addr, invalid)
        commit_direct = commit & direct
        commit_evict = commit & ~direct

        # Gather the evicted key before overwriting.
        ev_lo, ev_hi = from_i32(flat_lo[e_addr]), from_i32(flat_hi[e_addr])
        waddr = addr[commit]
        flat_lo[waddr] = to_i32(cl[commit])
        flat_hi[waddr] = to_i32(ch[commit])
        flat_used[waddr] = True

        success[p] = commit_direct
        pending[p] = ~commit_direct
        count += commit_direct.sum(dtype=torch.int32)

        new_bucket = _alt(config, bucketA, ev_lo, ev_hi)
        cur_lo[p] = torch.where(commit_evict, ev_lo, cl)
        cur_hi[p] = torch.where(commit_evict, ev_hi, ch)
        cur_bucket[p] = torch.where(commit_evict, new_bucket, cur_bucket[p])
        evict_mode[p] = em | commit_evict
        n_evict[p] += commit_evict.to(torch.int32)
        rnd += 1
    if INSERT_RECORDS is not None:
        INSERT_RECORDS.append({"rounds": rnd, "expired": expired.sum(),
                               "unfinished": pending.sum()})
    return BCHTState(key_lo, key_hi, used, count), success & ~pending


def _match(state: BCHTState, bucket, lo32, hi32):
    """(any slot of ``bucket`` holding the key, the first such slot)."""
    m = ((state.key_lo[bucket] == lo32[:, None])
         & (state.key_hi[bucket] == hi32[:, None]) & state.used[bucket])
    return m.any(dim=1), m.to(torch.uint8).argmax(dim=1)


def query(config: BCHTConfig, state: BCHTState, keys: torch.Tensor) -> torch.Tensor:
    """Exact membership: the key in either bucket -> bool[n]."""
    klo, khi = _words(keys)
    i1, i2, _ = _buckets(config, klo, khi)
    hits = []
    for s in range(0, keys.shape[0], _CHUNK):
        c = slice(s, s + _CHUNK)
        lo32, hi32 = keys[c, 0], keys[c, 1]
        hits.append(_match(state, i1[c], lo32, hi32)[0]
                    | _match(state, i2[c], lo32, hi32)[0])
    return torch.cat(hits) if hits else torch.zeros(
        (0,), dtype=torch.bool, device=keys.device)


def delete(config: BCHTConfig, state: BCHTState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None
           ) -> Tuple[BCHTState, torch.Tensor]:
    """Remove one stored copy a key -> (state', ok bool[n]), in place."""
    n = keys.shape[0]
    dev = keys.device
    b = config.bucket_size
    invalid = config.num_slots
    klo, khi = _words(keys)
    i1, i2, _ = _buckets(config, klo, khi)
    pending = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
               else valid.to(torch.bool).clone())
    success = torch.zeros((n,), dtype=torch.bool, device=dev)
    flat_used = state.used.view(-1)
    count = state.count.clone()
    max_rounds = b + 2

    rnd = 0
    while rnd < max_rounds and bool(pending.any()):
        p = pending.nonzero().squeeze(1)
        lo32, hi32, j1, j2 = keys[p, 0], keys[p, 1], i1[p], i2[p]
        f1, s1 = _match(state, j1, lo32, hi32)
        f2, s2 = _match(state, j2, lo32, hi32)
        found = f1 | f2
        addr = torch.where(f1, j1, j2) * b + torch.where(f1, s1, s2)
        commit = resolve_claims_single(torch.where(found, addr, invalid),
                                       invalid)
        flat_used[addr[commit]] = False
        success[p] = commit
        pending[p] = found & ~commit
        count -= commit.sum(dtype=torch.int32)
        rnd += 1
    return BCHTState(state.key_lo, state.key_hi, state.used, count), success


class BucketedCuckooHashTable:
    """Thin stateful wrapper over the functional ops; keys in any form
    ``normalize_keys`` takes."""

    def __init__(self, config: BCHTConfig, device=None):
        self.config = config
        self.state = config.init(device)

    def _keys(self, keys):
        return normalize_keys(keys, device=self.state.used.device)

    def insert(self, keys):
        self.state, ok = insert(self.config, self.state, self._keys(keys))
        return ok

    def query(self, keys):
        return query(self.config, self.state, self._keys(keys))

    def delete(self, keys):
        self.state, ok = delete(self.config, self.state, self._keys(keys))
        return ok
