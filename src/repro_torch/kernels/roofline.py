"""Minimal-bytes-per-op model for the cuckoo kernels (DESIGN.md §13).

The port's own copy of the cuckoo part of ``repro.kernels.roofline``: from
a config's layout alone it computes the least bytes each operation must
move, which over the card's memory rate gives each kernel's bound.

Two residency regimes, as in the JAX package:

* ``table_resident=False``: every per-key bucket probe is charged at word
  granularity (two bucket reads, one word write for a mutation);
* ``table_resident=True``: the table is read once (and written once for a
  mutating op) and the per-key probes are free.

:func:`least_batch_bytes` takes the smaller of the two — what a batch must
move at the very least, whichever way a kernel is built. All figures are
lower bounds: eviction re-reads, sorts and padding are excluded.

Differences from the JAX model: results are ``bool[n]`` (one byte per
key, not a uint32 lane), and ``hash`` (the standalone hash kernel: 8-byte
key in, 8-byte digest out) is an op.
"""

from __future__ import annotations

import dataclasses

# Bytes of one packed key on the stream (the 64-bit (lo, hi) pair).
KEY_BYTES = 8
# Bytes of one per-op result (bool[n]).
RESULT_BYTES = 1
# Bytes of one digest of the hash kernel ((hi, lo) uint32).
DIGEST_BYTES = 8

OPS = ("hash", "query", "insert", "delete")


@dataclasses.dataclass(frozen=True)
class OpTraffic:
    """Per-key minimal traffic, split by direction and residency tier."""

    stream_read: float
    stream_write: float
    table_read: float
    table_write: float

    def batch_bytes(self, n: int, table_bytes: int = 0,
                    table_resident: bool = False) -> float:
        """Minimal bytes for an ``n``-key batch (see the module docstring)."""
        stream = n * (self.stream_read + self.stream_write)
        if table_resident:
            return stream + table_bytes * (2 if self.table_write else 1)
        return stream + n * (self.table_read + self.table_write)


def cuckoo_op_traffic(config, op: str) -> OpTraffic:
    """Minimal per-key traffic for one cuckoo op, from the packed layout.

    * ``hash``: the key in, the digest out; no table.
    * ``query``: both candidate buckets (``2 * words_per_bucket`` words).
    * ``insert`` / ``delete``: the same two bucket reads plus one word
      read-modify-write.
    """
    bucket_bytes = config.layout.words_per_bucket * 4
    if op == "hash":
        return OpTraffic(KEY_BYTES, DIGEST_BYTES, 0.0, 0.0)
    if op == "query":
        return OpTraffic(KEY_BYTES, RESULT_BYTES, 2 * bucket_bytes, 0.0)
    if op in ("insert", "delete"):
        return OpTraffic(KEY_BYTES, RESULT_BYTES, 2 * bucket_bytes, 4.0)
    raise ValueError(f"unknown cuckoo op {op!r} (want one of {OPS})")


def min_batch_bytes(config, op: str, n: int, *,
                    table_resident: bool = False) -> float:
    """Minimal bytes an ``n``-key batch of ``op`` moves in one regime."""
    table = 0 if op == "hash" else int(config.table_bytes)
    return cuckoo_op_traffic(config, op).batch_bytes(
        n, table_bytes=table, table_resident=table_resident)


def least_batch_bytes(config, op: str, n: int) -> float:
    """The smaller of the two regimes: the least any kernel must move."""
    return min(min_batch_bytes(config, op, n, table_resident=False),
               min_batch_bytes(config, op, n, table_resident=True))


# The operations side of the bound: 32-bit integer instructions per key,
# counted from csrc/cuckoo_common.cuh with the fusions the compiler has (a
# three-input logic op, LOP3, and a multiply-add, IMAD, are one instruction
# each). Only work that every key must do is counted, so the count is a
# floor:
#   fmix32: three shift-xor pairs (SHF + LOP3) and two IMAD = 8;
#   fmix32 pair-hash: four fmix32 (the key/seed mixing is not counted);
#   xxhash64: five 64-bit multiplies of three IMAD each (rotates, shifts
#     and adds are not counted);
#   placement: the alternate bucket hashes the tag with fmix32 (both
#     policies);
#   SWAR test of one word: LOP3 (xor, and), IADD, LOP3 (or, not, and) = 3.
# Query tests both buckets; insert and delete always scan bucket i1 and
# bucket i2 only when i1 has no free (matching) slot, so only i1 counts.
FMIX32_INSTRUCTIONS = 8
HASH_INSTRUCTIONS = {"fmix32": 4 * FMIX32_INSTRUCTIONS, "xxhash64": 5 * 3}
SWAR_WORD_INSTRUCTIONS = 3
# 32-bit integer lanes of one Hopper SM (NVIDIA H100 architecture
# whitepaper: 64 INT32 units per SM).
INT32_LANES_PER_SM = 64


def int_ops_per_key(config, op: str) -> int:
    """The floor on 32-bit integer instructions one key of ``op`` takes."""
    hash_ops = HASH_INSTRUCTIONS[config.hash_kind]
    if op == "hash":
        return hash_ops
    words = config.layout.words_per_bucket
    probe = hash_ops + FMIX32_INSTRUCTIONS
    if op == "query":
        return probe + 2 * words * SWAR_WORD_INSTRUCTIONS
    if op in ("insert", "delete"):
        return probe + words * SWAR_WORD_INSTRUCTIONS
    raise ValueError(f"unknown cuckoo op {op!r} (want one of {OPS})")


def int32_ops_per_s(sm_count: int, sm_clock_hz: float) -> float:
    """The card's peak 32-bit integer instruction rate (lanes x clock)."""
    return sm_count * INT32_LANES_PER_SM * sm_clock_hz
