"""Oracles for the kernels (the ``ref.py`` contract of the JAX package).

Each ``*_ref`` function keeps the signature of its counterpart in
``repro.kernels.ref`` (separate ``keys_lo``/``keys_hi`` int32 tensors,
functional: the input table is not modified) and computes exactly what the
kernel must produce. :func:`apply_sequential` is the literal sequential op
loop behind the insert and mixed oracles and the plain versions of those
two kernels.
"""

from __future__ import annotations

import torch

from ..amq.protocol import OP_DELETE, OP_INSERT
from ..core import layout as L
from ..core.bits64 import MASK32, from_i32, to_i32
from ..core.cuckoo_filter import CuckooConfig, CuckooState, prepare_keys_plain
from ..core.cuckoo_filter import query as cuckoo_query_core
from ..core.hashing import xxhash64_u64
from ..filters import blocked_bloom as BB
from .kmer_pack import kmer_pack_plain


def _pack_keys(keys_lo: torch.Tensor, keys_hi: torch.Tensor) -> torch.Tensor:
    return torch.stack([keys_lo, keys_hi], dim=-1)


def apply_sequential(config: CuckooConfig, table: torch.Tensor,
                     keys: torch.Tensor, ops: torch.Tensor,
                     valid: torch.Tensor = None) -> torch.Tensor:
    """Apply an op stream one key at a time in batch order, in place.

    QUERY is a match scan over both buckets, INSERT a first-empty-slot
    claim, DELETE a first-match clear; each scans bucket i1 then i2
    circularly from the tag-derived start, and operation ``i`` observes
    every write of operations ``j < i``. No eviction: an insert with both
    buckets full reports False. Returns ok bool[n] on the table's device.

    The hashing and bucket gathers are vectorized; the loop itself runs on
    host integers over the gathered words, with this batch's writes kept
    in a dict and applied to the table at the end.
    """
    lay = config.layout
    pol = config.placement
    n = keys.shape[0]
    wpb, tpw, fp, b = (lay.words_per_bucket, lay.tags_per_word, lay.fp_bits,
                       lay.bucket_size)
    fmask = lay.fp_mask
    base_tag, i1, i2 = prepare_keys_plain(config, keys)
    t1, t2 = pol.query_match_tags(base_tag)
    cols = [x.tolist() for x in (
        i1, i2, pol.place_tag(base_tag, False), pol.place_tag(base_tag, True),
        t1, t2, L.scan_start(base_tag, lay), ops,
        torch.ones((n,), dtype=torch.bool) if valid is None else valid)]
    pre1 = L.gather_bucket_words(table, i1, lay).tolist()
    pre2 = L.gather_bucket_words(table, i2, lay).tolist()

    written = {}
    ok = [False] * n
    for i, (b1, b2, g1, g2, m1, m2, st, op, live) in enumerate(zip(*cols)):
        if not live:
            continue
        for bucket, pre, match, store in ((b1, pre1[i], m1, g1),
                                          (b2, pre2[i], m2, g2)):
            words = [written.get(bucket * wpb + w, pre[w]) for w in range(wpb)]
            target = 0 if op == OP_INSERT else match
            slot = next((s for s in ((st + k) % b for k in range(b))
                         if (words[s // tpw] >> (s % tpw * fp)) & fmask == target),
                        None)
            if slot is not None:
                break
        else:
            continue
        ok[i] = True
        if op in (OP_INSERT, OP_DELETE):
            w, shift = slot // tpw, slot % tpw * fp
            value = store if op == OP_INSERT else 0
            written[bucket * wpb + w] = (
                (words[w] & ~(fmask << shift) & MASK32) | (value << shift))
    if written:
        addr = torch.tensor(list(written), dtype=torch.int64, device=table.device)
        table[addr] = to_i32(torch.tensor(list(written.values()),
                                          dtype=torch.int64, device=table.device))
    return torch.tensor(ok, dtype=torch.bool, device=table.device)


def cuckoo_query_ref(config: CuckooConfig, table: torch.Tensor,
                     keys_lo: torch.Tensor, keys_hi: torch.Tensor) -> torch.Tensor:
    """Oracle for the query kernel — reuses the core query (Alg. 2)."""
    state = CuckooState(table, torch.zeros((), dtype=torch.int32,
                                           device=table.device))
    return cuckoo_query_core(config, state, _pack_keys(keys_lo, keys_hi))


def cuckoo_insert_ref(config: CuckooConfig, table: torch.Tensor,
                      keys_lo: torch.Tensor, keys_hi: torch.Tensor):
    """Oracle for the direct-insert kernel: sequential first-free-slot
    inserts in batch order, no eviction. Returns (table', ok bool[n])."""
    table = table.clone()
    keys = _pack_keys(keys_lo, keys_hi)
    ops = torch.full((keys.shape[0],), OP_INSERT, dtype=torch.int32)
    return table, apply_sequential(config, table, keys, ops)


def cuckoo_mixed_ref(config: CuckooConfig, table: torch.Tensor,
                     keys_lo: torch.Tensor, keys_hi: torch.Tensor,
                     ops: torch.Tensor, valid: torch.Tensor = None):
    """Oracle for the mixed kernel — exact sequential op-stream semantics.
    Returns (table', ok bool[n])."""
    table = table.clone()
    ok = apply_sequential(config, table, _pack_keys(keys_lo, keys_hi), ops,
                          valid)
    return table, ok


def hash64_ref(keys_lo: torch.Tensor, keys_hi: torch.Tensor, seed: int = 0):
    """Oracle for the hash kernel — xxHash64 -> (hi, lo) int32 bit views."""
    hi, lo = xxhash64_u64((from_i32(keys_hi), from_i32(keys_lo)), seed=seed)
    return to_i32(hi), to_i32(lo)


def bloom_query_ref(config: BB.BloomConfig, table: torch.Tensor,
                    keys_lo: torch.Tensor, keys_hi: torch.Tensor) -> torch.Tensor:
    """Oracle for the Bloom query kernel — the filter's own query."""
    state = BB.BloomState(table, torch.zeros((), dtype=torch.int32))
    return BB.query(config, state, _pack_keys(keys_lo, keys_hi))


def bloom_insert_ref(config: BB.BloomConfig, table: torch.Tensor,
                     keys_lo: torch.Tensor, keys_hi: torch.Tensor) -> torch.Tensor:
    """Oracle for the Bloom insert kernel — the filter's own insert on a
    copy of ``table``. Returns table'."""
    state = BB.BloomState(table.clone(), torch.zeros((), dtype=torch.int32))
    state, _ = BB.insert(config, state, _pack_keys(keys_lo, keys_hi))
    return state.table


def kmer_pack_ref(bases: torch.Tensor, k: int = 31):
    """Oracle for the k-mer pack kernel, on the JAX oracle's terms.

    bases: [n] 2-bit codes. Returns (hi, lo) int32[n] bit views where
    position i holds the 2k-bit k-mer starting at i, computed with zero
    padding past the end (positions past n - k are the padding's).
    """
    padded = torch.cat([bases.to(torch.int64),
                        torch.zeros((k - 1,), dtype=torch.int64,
                                    device=bases.device)])
    keys = kmer_pack_plain(padded, k)
    return keys[:, 1], keys[:, 0]


# ---------------------------------------------------------------------------
# The quotient filter's serial loops: the plain versions of G1 and G2
# (csrc/gqf_serial.cu). Each runs the JAX loop statement for statement on
# host integers in uint32 arithmetic, over a copy of the table, and writes
# the table back in place.
# ---------------------------------------------------------------------------

def _u32_shifts(r: int):
    """uint32 ``<<`` and ``>>`` by ``r`` as XLA computes them (0 past the
    width; ``<<`` wraps modulo 2^32)."""
    if r >= 32:
        return (lambda x: 0), (lambda x: 0), MASK32
    return (lambda x: (x << r) & MASK32), (lambda x: x >> r), (1 << r) - 1


def gqf_insert_plain(table: torch.Tensor, rem: torch.Tensor,
                     home: torch.Tensor, valid: torch.Tensor,
                     remainder_bits: int, max_probe: int) -> torch.Tensor:
    """G1's plain version (``repro/filters/quotient.py:108-141``): Robin
    Hood insertion, one key after another, in place. table int32[m]; rem,
    home int64[n] (uint32 values); valid bool[n]. Returns ok bool[n]."""
    shl, shr, rmask = _u32_shifts(remainder_bits)
    t = from_i32(table).tolist()
    m = len(t)
    ok = []
    for pos, cur, live in zip(home.tolist(), rem.tolist(), valid.tolist()):
        dist, placed = 0, False
        while live:
            slot = t[pos]
            empty = slot == 0
            s_dist = shr(slot)
            rich = s_dist < dist
            if empty or rich:
                t[pos] = shl(dist) | (cur & rmask)
            placed = placed or empty
            if rich and not empty:
                cur, dist = slot & rmask, s_dist
            live = not empty and dist < max_probe
            pos = (pos + 1) % m
            dist = (dist + 1) & MASK32
        ok.append(placed)
    table.copy_(to_i32(torch.tensor(t, dtype=torch.int64)))
    return torch.tensor(ok, dtype=torch.bool, device=table.device)


def gqf_delete_plain(table: torch.Tensor, rem: torch.Tensor,
                     home: torch.Tensor, valid: torch.Tensor,
                     remainder_bits: int, max_probe: int) -> torch.Tensor:
    """G2's plain version (``repro/filters/quotient.py:177-211``): the
    first match in the key's window of ``max_probe`` slots, then
    backward-shift compaction, in place. Arguments as
    :func:`gqf_insert_plain`; returns ok bool[n]."""
    shl, shr, rmask = _u32_shifts(remainder_bits)
    t = from_i32(table).tolist()
    m = len(t)
    ok = []
    for h, want, v in zip(home.tolist(), rem.tolist(), valid.tolist()):
        at = next((d for d in range(max_probe)
                   if (t[(h + d) % m] & rmask) == want
                   and shr(t[(h + d) % m]) == d), None)
        found = at is not None and v
        pos = (h + (at or 0)) % m
        live = found
        while live:
            nxt = (pos + 1) % m
            nslot = t[nxt]
            nd = shr(nslot)
            live = nslot != 0 and nd > 0
            t[pos] = shl(nd - 1) | (nslot & rmask) if live else 0
            pos = nxt
        ok.append(found)
    table.copy_(to_i32(torch.tensor(t, dtype=torch.int64)))
    return torch.tensor(ok, dtype=torch.bool, device=table.device)
