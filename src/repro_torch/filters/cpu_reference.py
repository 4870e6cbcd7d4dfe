"""Pure-Python partitioned Cuckoo filter — PCF stand-in + differential oracle.

Port of ``repro.filters.cpu_reference``. The paper's CPU baseline is the
partitioned multi-threaded Cuckoo filter of Schmidt et al. (VLDB'21); this
sequential implementation mirrors the same partial-key algorithm with the
*identical* hash/tag/bucket derivation as the port's cuckoo filter (the
port's own ``fmix32_py`` and ``xxhash64_py``), so the two can be compared
slot for slot. It runs one op at a time on the host: the ``cpu-cuckoo``
backend and the sequential oracle of the mixed-op tests.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List

import numpy as np

from ..core.hashing import fmix32_py, keys_to_numpy, xxhash64_py  # noqa: F401

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PyCuckooConfig:
    """AMQ-protocol config for the sequential oracle (mirrors CuckooConfig)."""

    num_buckets: int
    fp_bits: int = 16
    bucket_size: int = 16
    hash_kind: str = "xxhash64"
    max_evictions: int = 64
    seed: int = 0

    @property
    def num_slots(self) -> int:
        return self.num_buckets * self.bucket_size

    @property
    def table_bytes(self) -> int:
        return (self.num_slots * self.fp_bits + 7) // 8

    def expected_fpr(self, load_factor: float) -> float:
        """Same partial-key analysis as CuckooConfig (paper Eq. 4)."""
        f = self.fp_bits
        return 1.0 - (1.0 - 2.0 ** -f) ** (2 * self.bucket_size * load_factor)

    def init(self) -> "PyCuckooFilter":
        return PyCuckooFilter(self.num_buckets, self.fp_bits,
                              self.bucket_size, self.hash_kind,
                              self.max_evictions, self.seed)

    @staticmethod
    def for_capacity(capacity: int, load_factor: float = 0.95,
                     fp_bits: int = 16, bucket_size: int = 16,
                     **kw) -> "PyCuckooConfig":
        buckets = max(2, int(np.ceil(capacity / (load_factor * bucket_size))))
        buckets = 1 << int(np.ceil(np.log2(buckets)))  # xor placement
        return PyCuckooConfig(num_buckets=buckets, fp_bits=fp_bits,
                              bucket_size=bucket_size, **kw)


class PyCuckooFilter:
    """Sequential reference with the same layout/derivation as CuckooConfig."""

    def __init__(self, num_buckets: int, fp_bits: int = 16, bucket_size: int = 16,
                 hash_kind: str = "xxhash64", max_evictions: int = 64, seed: int = 0):
        assert num_buckets & (num_buckets - 1) == 0, "xor policy: power of two"
        self.num_buckets = num_buckets
        self.fp_bits = fp_bits
        self.bucket_size = bucket_size
        self.hash_kind = hash_kind
        self.max_evictions = max_evictions
        self.seed = seed
        self.buckets: List[List[int]] = [[0] * bucket_size
                                         for _ in range(num_buckets)]
        self.count = 0
        self._rng = random.Random(12345)

    # -- identical derivation to core.cuckoo_filter.prepare_keys ------------
    def _hash(self, key: int):
        if self.hash_kind == "xxhash64":
            h = xxhash64_py(key, self.seed)
            return (h >> 32) & _M32, h & _M32
        # fmix32_pair
        hi_in, lo_in = (key >> 32) & _M32, key & _M32
        if self.seed:
            hi_in ^= (self.seed >> 32) & _M32
            lo_in ^= self.seed & _M32
        a = fmix32_py(lo_in ^ fmix32_py(hi_in ^ 0x9E3779B9))
        b = fmix32_py((hi_in ^ fmix32_py((lo_in + 0x85EBCA6B) & _M32) ^ a) & _M32)
        return b, a

    def _prepare(self, key: int):
        hi, lo = self._hash(key)
        tag = hi & ((1 << self.fp_bits) - 1)
        tag = tag or 1
        i1 = lo & (self.num_buckets - 1)
        i2 = self._alt(i1, tag)
        return tag, i1, i2

    def _alt(self, bucket: int, tag: int) -> int:
        return bucket ^ (fmix32_py(tag) & (self.num_buckets - 1))

    # -- operations ----------------------------------------------------------
    def insert(self, key: int) -> bool:
        tag, i1, i2 = self._prepare(key)
        for b in (i1, i2):
            bucket = self.buckets[b]
            for s in range(self.bucket_size):
                if bucket[s] == 0:
                    bucket[s] = tag
                    self.count += 1
                    return True
        b = self._rng.choice((i1, i2))
        for _ in range(self.max_evictions):
            s = self._rng.randrange(self.bucket_size)
            tag, self.buckets[b][s] = self.buckets[b][s], tag
            b = self._alt(b, tag)
            bucket = self.buckets[b]
            for s2 in range(self.bucket_size):
                if bucket[s2] == 0:
                    bucket[s2] = tag
                    self.count += 1
                    return True
        return False

    def query(self, key: int) -> bool:
        tag, i1, i2 = self._prepare(key)
        return tag in self.buckets[i1] or tag in self.buckets[i2]

    def delete(self, key: int) -> bool:
        tag, i1, i2 = self._prepare(key)
        for b in (i1, i2):
            bucket = self.buckets[b]
            for s in range(self.bucket_size):
                if bucket[s] == tag:
                    bucket[s] = 0
                    self.count -= 1
                    return True
        return False

    # -- batch conveniences (numpy uint64 in/out) ----------------------------
    def insert_batch(self, keys: np.ndarray) -> np.ndarray:
        return np.array([self.insert(int(k)) for k in keys], bool)

    def query_batch(self, keys: np.ndarray) -> np.ndarray:
        return np.array([self.query(int(k)) for k in keys], bool)

    def delete_batch(self, keys: np.ndarray) -> np.ndarray:
        return np.array([self.delete(int(k)) for k in keys], bool)
