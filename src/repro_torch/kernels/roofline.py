"""Minimal-bytes-per-op model for the kernels (DESIGN.md §13).

The port's own copy of the cuckoo and blocked-Bloom parts of
``repro.kernels.roofline``, plus the k-mer pack: from a config's layout
alone it computes the least bytes each operation must move, which over
the card's memory rate gives each kernel's bound. Flash attention's bound
(at the end) is the larger of its bytes over the memory rate and its
FLOP over the dense bf16 tensor-core rate.

Two residency regimes:

* ``table_resident=False``: every per-key bucket probe is charged at word
  granularity (two bucket reads, one word write for a mutation), as in
  the JAX package;
* ``table_resident=True``: each bucket the batch touches is read once
  (and written once, if the op mutates) and the per-key probes are free.
  The JAX package charges the whole table here; a batch of ``n`` uniform
  keys touches only ``nb * (1 - (1 - 1/nb)^n)`` of its ``nb`` buckets
  (about 63 % when ``n == nb``), so the port charges those
  (:func:`expected_buckets`) or, given a batch's own data, the buckets it
  really needs (``touched``), and never more than the whole table.

:func:`least_batch_bytes` takes the smaller of the two — what a batch must
move at the very least, whichever way a kernel is built. All figures are
lower bounds: eviction re-reads, sorts and padding are excluded.

The bound is the least time for an op's work, not for a kernel's design:
the fused and unfused kernels of one function (query #2 and #3, direct
insert #4 and #5) take the same op's bound (``query``, ``insert``).

Differences from the JAX model: results are ``bool[n]`` (one byte per
key, not a uint32 lane), and ``hash`` (the standalone hash kernel: 8-byte
key in, 8-byte digest out) is an op.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .cuckoo_mixed import scratch_slots

# Bytes of one packed key on the stream (the 64-bit (lo, hi) pair).
KEY_BYTES = 8
# Bytes of one per-op result (bool[n]).
RESULT_BYTES = 1
# Bytes of one digest of the hash kernel ((hi, lo) uint32).
DIGEST_BYTES = 8

OPS = ("hash", "query", "insert", "bulk_insert", "orient_bulk_insert",
       "delete")


@dataclasses.dataclass(frozen=True)
class OpTraffic:
    """Per-key minimal traffic, split by direction and residency tier."""

    stream_read: float
    stream_write: float
    table_read: float
    table_write: float

    def batch_bytes(self, n: int, table_bytes: int = 0,
                    table_resident: bool = False,
                    touched_bytes: tuple = (0.0, 0.0)) -> float:
        """Minimal bytes for an ``n``-key batch (see the module docstring).
        ``touched_bytes``: the (read, written) table bytes of the resident
        regime; each is capped at ``table_bytes``."""
        stream = n * (self.stream_read + self.stream_write)
        if table_resident:
            read, written = touched_bytes
            return (stream + min(table_bytes, read)
                    + (min(table_bytes, written) if self.table_write else 0))
        return stream + n * (self.table_read + self.table_write)


def cuckoo_op_traffic(config, op: str, *, batch: int = None) -> OpTraffic:
    """Minimal per-key traffic for one cuckoo op, from the packed layout.

    * ``hash``: the key in, the digest out; no table.
    * ``query``: both candidate buckets (``2 * words_per_bucket`` words).
    * ``insert`` / ``delete``: the same two bucket reads plus one word
      read-modify-write.
    * ``bulk_insert``: the bucket-major stream loads and flushes the
      primary bucket once per segment, amortized over the expected run of
      keys per bucket (``batch / num_buckets``); the secondary bucket is
      read per key and one word written for a spilled key (charged fully).
      The sort is excluded.
    * ``orient_bulk_insert``: the orientation build streams the whole
      table once in and once out, amortized over the batch; sweep traffic
      and the residue are excluded.
    """
    bucket_bytes = config.layout.words_per_bucket * 4
    if op == "hash":
        return OpTraffic(KEY_BYTES, DIGEST_BYTES, 0.0, 0.0)
    if op == "query":
        return OpTraffic(KEY_BYTES, RESULT_BYTES, 2 * bucket_bytes, 0.0)
    if op in ("insert", "delete"):
        return OpTraffic(KEY_BYTES, RESULT_BYTES, 2 * bucket_bytes, 4.0)
    if op == "bulk_insert":
        seg = max(1.0, (batch or 1) / config.num_buckets)
        return OpTraffic(KEY_BYTES, RESULT_BYTES,
                         bucket_bytes / seg + bucket_bytes,
                         bucket_bytes / seg + 4.0)
    if op == "orient_bulk_insert":
        whole_table = float(config.table_bytes) / max(1, batch or 1)
        return OpTraffic(KEY_BYTES, RESULT_BYTES, whole_table, whole_table)
    raise ValueError(f"unknown cuckoo op {op!r} (want one of {OPS})")


def expected_buckets(num_buckets: int, draws: float) -> float:
    """Expected distinct buckets among ``draws`` uniform picks of
    ``num_buckets``: ``nb * (1 - (1 - 1/nb)^draws)``."""
    if num_buckets <= 1:
        return float(num_buckets)
    return -num_buckets * math.expm1(draws * math.log1p(-1.0 / num_buckets))


def expected_touched(config, op: str, n: int) -> tuple:
    """Expected (read, written) buckets of an ``n``-key batch of uniform
    keys: a query reads both candidate buckets of every key; a mutating op
    reads and writes one bucket per key (the secondary bucket is needed
    only where the primary cannot settle the key, which depends on the
    data, so it is not counted)."""
    nb = config.num_buckets
    if op == "hash":
        return 0.0, 0.0
    if op == "query":
        return expected_buckets(nb, 2 * n), 0.0
    touched = expected_buckets(nb, n)
    return touched, touched


def min_batch_bytes(config, op: str, n: int, *,
                    table_resident: bool = False, touched=None) -> float:
    """Minimal bytes an ``n``-key batch of ``op`` moves in one regime.
    ``touched``: the (read, written) buckets the batch's own data needs
    in the resident regime; by default :func:`expected_touched`."""
    traffic = cuckoo_op_traffic(config, op, batch=n)
    table = 0 if op == "hash" else int(config.table_bytes)
    read, written = touched or expected_touched(config, op, n)
    bucket_bytes = config.layout.words_per_bucket * 4
    return traffic.batch_bytes(
        n, table_bytes=table, table_resident=table_resident,
        touched_bytes=(read * bucket_bytes, written * bucket_bytes))


def least_batch_bytes(config, op: str, n: int, touched=None) -> float:
    """The smaller of the two regimes: the least any kernel must move."""
    return min(min_batch_bytes(config, op, n, table_resident=False),
               min_batch_bytes(config, op, n, table_resident=True,
                               touched=touched))


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
# Query tests both buckets; insert, bulk insert and delete always scan
# bucket i1 and bucket i2 only when i1 has no free (matching) slot, so only
# i1 counts.
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
    if op in ("insert", "bulk_insert", "delete"):
        return probe + words * SWAR_WORD_INSTRUCTIONS
    raise ValueError(f"unknown cuckoo op {op!r} (want one of {OPS})")


def int32_ops_per_s(sm_count: int, sm_clock_hz: float) -> float:
    """The card's peak 32-bit integer instruction rate (lanes x clock)."""
    return sm_count * INT32_LANES_PER_SM * sm_clock_hz


# ---------------------------------------------------------------------------
# Blocked Bloom: one 64-byte block per key.
# ---------------------------------------------------------------------------

BLOOM_OPS = ("query", "insert")


def bloom_op_traffic(config, op: str) -> OpTraffic:
    """Minimal per-key traffic of the blocked-Bloom baseline: every probe
    reads its one block (``words_per_block`` words); an insert also writes
    the <= k distinct words that carry its bits. Results are bool[n]."""
    block_bytes = config.words_per_block * 4
    if op == "query":
        return OpTraffic(KEY_BYTES, RESULT_BYTES, block_bytes, 0.0)
    if op == "insert":
        return OpTraffic(KEY_BYTES, RESULT_BYTES, block_bytes,
                         4.0 * min(config.k, config.words_per_block))
    raise ValueError(f"unknown bloom op {op!r} (want one of {BLOOM_OPS})")


def bloom_batch_bytes(config, op: str, n: int, touched=None) -> float:
    """The least bytes an ``n``-key batch of ``op`` moves: per-key block
    probes, or each block the batch touches read once (and, for an
    insert, written once), capped at the table; the smaller of the two.
    ``touched``: the distinct blocks of the batch's own keys, by default
    the expected number for uniform keys."""
    traffic = bloom_op_traffic(config, op)
    blocks = (expected_buckets(config.num_blocks, n) if touched is None
              else touched)
    touched_bytes = blocks * config.words_per_block * 4
    resident = traffic.batch_bytes(n, table_bytes=config.table_bytes,
                                   table_resident=True,
                                   touched_bytes=(touched_bytes,
                                                  touched_bytes))
    return min(traffic.batch_bytes(n), resident)


# Bytes a key the windowed Bloom query route (csrc/bloom_query.cu) streams:
# the count reads the key (8); the scatter reads it again and writes its
# (block, hash word) entry and its two-byte slot (8 + 8 + 2); the probe
# reads the entry and writes its answer (8 + 1); the un-permute reads the
# slot and the answer and writes the hit (2 + 1 + 1).
BLOOM_WINDOWED_BYTES_PER_KEY = 8 + 18 + 9 + 4


def bloom_windowed_bytes(config, n: int) -> float:
    """The least bytes of the windowed query route on ``n`` keys: its
    streamed bytes and the table read once (the counts, a few bytes a tile
    and window, left out). Over the memory rate, the route's own floor,
    beside the function's (:func:`bloom_batch_bytes`)."""
    return BLOOM_WINDOWED_BYTES_PER_KEY * n + config.table_bytes


# Kernel #6's windowed route (csrc/cuckoo_insert_bulk.cu), by its own
# passes. A key: the count reads it and its valid byte (8 + 1); the
# scatter reads them again and writes its (i1, tag) entry and its two-byte
# slot (9 + 8 + 2); the insert reads the entry and writes its answer
# (8 + 1); the un-permute reads the slot and the answer and writes ok
# (2 + 1 + 1).
BULK_ROUTE_BYTES_PER_KEY = 9 + 19 + 9 + 4


def bulk_route_bytes(config, n: int, written: int) -> float:
    """The least bytes of kernel #6's windowed route on ``n`` keys: its
    streamed bytes, the whole table read once (window by window into L2)
    and the ``written`` buckets the batch changes written back once. Over
    the memory rate, the route's own floor, beside the function's
    (:func:`least_batch_bytes` of ``"bulk_insert"``)."""
    return (BULK_ROUTE_BYTES_PER_KEY * n + config.table_bytes
            + config.layout.words_per_bucket * 4 * written)


# Kernel #7's route (csrc/cuckoo_mixed.cu), by its own passes. A valid op:
# the mark reads its key, valid byte and op (8 + 1 + 4), writes its state
# byte (1) and claims its 8-byte scratch slot (read and written, 16); the
# three apply launches each read the state byte (3); the op's own launch
# reads its key and slot again (8 + 8) and writes ok and the state byte
# (2); the compaction reads the state byte (1).
MIXED_BYTES_PER_OP = 8 + 1 + 4 + 1 + 16 + 3 + 8 + 8 + 2 + 1
# An op of a repeated key, through the walk: its position written and read
# (8 + 8), its key value gathered (8), sorted with its index (32 read and
# written), its place in the order written and read (8 + 8), its op and
# key read (4 + 8), its run's length and kind written and read (4 + 4),
# and ok (1).
MIXED_WALK_BYTES_PER_OP = 8 + 8 + 8 + 32 + 8 + 8 + 4 + 8 + 4 + 4 + 1


def mixed_route_bytes(config, n: int, touched: tuple,
                      repeated: int = 0) -> float:
    """The least bytes of kernel #7's route on ``n`` valid ops, ``repeated``
    of them on keys that occur more than once: its streamed bytes, the
    scratch table (:func:`cuckoo_mixed.scratch_slots` of 8 bytes) cleared
    once, and each touched bucket (``touched``: buckets read, written) once
    each way. Over the memory rate, the route's own floor, beside the
    function's (:func:`least_batch_bytes` of ``"delete"``)."""
    read, written = touched
    return (MIXED_BYTES_PER_OP * n + MIXED_WALK_BYTES_PER_OP * repeated
            + 8 * scratch_slots(n)
            + config.layout.words_per_bucket * 4 * (read + written))


def kmer_pack_bytes(n_codes: int, k: int) -> float:
    """The least bytes of packing ``n_codes`` one-byte codes into their
    ``n_codes - k + 1`` k-mers: every code read once, 8 bytes written a
    k-mer."""
    return n_codes + 8.0 * max(0, n_codes - k + 1)


# The operations side of the Bloom and k-mer bounds, counted as above:
#   a Bloom key hashes (HASH_INSTRUCTIONS), then per bit a shift of the
#   hash word, the in-block modulo, the mask shift and one test or OR
#   (4), and re-mixes the hash word with fmix32 + IADD every
#   ``32 // bit_length(block_bits - 1)`` bits;
#   the k-mer pack is a rolling pack at the least: each code enters a
#   64-bit accumulator once, ``(acc << 2 | code) & mask``, a funnel shift
#   of the upper word, a shift-add of the code into the lower word (LEA)
#   and the mask of the upper word (LOP3). Canonical keys add a rolling
#   reverse complement, ``rc >> 2 | (3 - code) << (2k - 2)``, three more a
#   code (a funnel shift of the lower word, a shift of the upper, a LOP3
#   that complements the code and ORs it in), and a 64-bit unsigned
#   compare and select a key (two ISETP, two SEL). (The kernel extracts
#   each position's window from a packed stream in shared memory; that is
#   its design, not the function's cost.)
BLOOM_BIT_INSTRUCTIONS = 4
KMER_CODE_INSTRUCTIONS = 3
KMER_REVCOMP_CODE_INSTRUCTIONS = 3
KMER_MIN_INSTRUCTIONS = 4


def bloom_int_ops_per_key(config) -> int:
    """The floor on 32-bit integer instructions of one Bloom query or
    insert key."""
    per_word = max(1, 32 // max(1, (config.block_bits - 1).bit_length()))
    remixes = (config.k - 1) // per_word
    return (HASH_INSTRUCTIONS[config.hash_kind]
            + config.k * BLOOM_BIT_INSTRUCTIONS
            + remixes * (FMIX32_INSTRUCTIONS + 1))


def kmer_pack_int_ops(n_codes: int, k: int = 31, *,
                      canonical: bool = False) -> int:
    """The floor on 32-bit integer instructions of packing ``n_codes``
    codes into k-mers: one rolling-pack step a code; ``canonical`` adds a
    rolling reverse-complement step a code and a 64-bit minimum a k-mer."""
    if not canonical:
        return n_codes * KMER_CODE_INSTRUCTIONS
    return (n_codes * (KMER_CODE_INSTRUCTIONS + KMER_REVCOMP_CODE_INSTRUCTIONS)
            + max(0, n_codes - k + 1) * KMER_MIN_INSTRUCTIONS)


# ---------------------------------------------------------------------------
# Flash attention: q, k, v read once, out written once; 4 FLOP a (query,
# key, head-dim) triple of every unmasked pair (2 for Q K^T, 2 for P V).
# ---------------------------------------------------------------------------

# Dense bf16 tensor-core FLOP a clock of one Hopper SM (NVIDIA H100
# data sheet: 989.4 TFLOP/s dense at 132 SMs and 1830 MHz).
BF16_FLOP_PER_CLOCK_PER_SM = 4096


def bf16_flops_per_s(sm_count: int, sm_clock_hz: float) -> float:
    """The card's peak dense bf16 tensor-core rate (SMs x FLOP a clock x
    clock), derived as :func:`int32_ops_per_s` is."""
    return sm_count * BF16_FLOP_PER_CLOCK_PER_SM * sm_clock_hz


def attention_pairs(sq: int, sk: int, *, causal: bool, window=None,
                    q_offset: int = 0) -> int:
    """Unmasked (query, key) pairs of one head: key j is seen by query
    position i = q_offset + row when j < sk, j <= i if causal, and
    i - j < window if a window is set."""
    i = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, i + 1) if causal else np.full_like(i, sk)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def attention_flops(rows: int, sq: int, sk: int, d: int, dv: int, *,
                    causal: bool, window=None, q_offset: int = 0) -> float:
    """FLOP of ``rows`` (= B * H) heads: 2 * pairs * (D + Dv)."""
    return 2.0 * rows * attention_pairs(sq, sk, causal=causal, window=window,
                                        q_offset=q_offset) * (d + dv)


def attention_bytes(q, k, v, out) -> int:
    """Each input read once and the output written once."""
    return sum(t.numel() * t.element_size() for t in (q, k, v, out))
