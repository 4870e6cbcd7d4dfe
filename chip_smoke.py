#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

From the repository root, on a machine with one NVIDIA H100 and the CUDA
toolkit. Phases, one JSON line each:

1. build — the eleven CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``nvcc``, ``sm_90a``, in parallel), with the build seconds and the
   card's name and power limit.
2. main path at 2^28 slots — ``repro_torch.amq.make("cuckoo",
   capacity=floor(0.95 * 2^28))`` (fp 16, bucket 16, XOR, fmix32: a
   512 MiB table, ten times the L2), filled to load 0.95 in 16 batches of
   at most 2^24 keys from a seeded CUDA generator: the first twelve
   incremental (``insert_engine="auto"``: the direct-insert kernel, then
   the round loop on the keys it turns down), the last four with
   ``bulk=True`` (the orientation build). Every key placed; ``count``
   equal to the keys placed; the table holds exactly the placed keys (see
   :func:`table_codes`); every inserted key found by the query kernel and
   by the plain query; the FPR of 2^24 fresh keys inside the Eq. 4 band;
   2^24 deletes all ``ok``, after which the table holds exactly the other
   keys. Launch counts are zeroed just before and read just after; every
   kernel the configuration routes to must have launched. Per batch:
   bulk or not, seconds, rounds, the keys handed to the frontier and to
   the round loop; per fill the peak of allocated device memory.
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: hash and query on 2^24 keys, bit-exact. The direct
   insert and the bucket-major bulk insert (2^24 keys into the table at
   load 0.5 and before the last batch) and the delete (2^24 stored keys)
   are held to what every sequential order gives — the plain loop's is
   one — on the whole batch, and exactly to the plain loop on a 2^12-key
   sub-batch (equal ``ok`` and equal tag multiset in every touched bucket;
   slots may differ by CAS order), as is a 2^12 mixed stream and a delete
   stream with duplicates.
3b. the fused-vs-unfused comparison (the JAX package's
   ``benchmarks/roofline_filters.py`` ``fused=False`` rows) through
   ``kernels.ops.cuckoo_query(fused=...)`` and
   ``cuckoo_insert_direct(fused=...)``, 2^24 keys against the 2^28-slot
   table at load 0.5 and at 0.95, launch counts zeroed just before and
   read just after: the unfused query's hits equal the fused query's; the
   unfused insert is held as the fused one is (no stored tag moves, the
   tags added are exactly the placed keys', a key turned down only with
   both buckets full; on a 2^12 sub-batch the plain loop's ``ok`` and tag
   multisets); the unfused query equals its plain version on 2^22 keys.
   Both timed beside the fused kernels at both loads.
4. timings at the main path's shapes (median of CUDA-event runs) beside
   each kernel's bound, whose bytes count the buckets the timed batch's
   own data touches (see :func:`touched_buckets`). Then the bulk kernel
   against the direct-insert kernel where segments are long: 2^27 keys
   into the empty 2^28-slot table (eight keys a primary bucket), both
   held to the order-free outcome first. A warm-up pass at 2^16 slots
   (both engines, and the k-mer and Bloom kernels) runs before anything
   is timed.
5. fills at 2^28 slots — five fresh handles at the main path's capacity,
   each filled to 0.95 in the main path's batches: bulk under ``auto``
   (orientation) and ``legacy`` (the bulk kernel, then the round loop),
   incremental under ``auto`` and ``legacy`` (the direct kernel, then the
   round loop) and ``frontier`` (the direct kernel, then the BFS
   frontier). The main path's
   gates on each, with its own launch counts. Then one orientation batch
   (load 0.5 -> 0.5625) under ``torch.profiler``: its wall and
   device-busy seconds and the operators that take the most device time.
6. the k-mer case study (paper §5.5, fig8) — ``synthetic_genome`` of
   248956422 bases (GRCh38 chromosome 1's length), made on the host, on
   the card: its canonical 31-mers by ``kmer_keys`` (the plain keys of a
   2^20-base prefix checked against Python integers); the distinct
   k-mers into ``make("cuckoo", capacity=n_distinct)`` in a seeded
   permutation, batches of 2^24 (the main path's gates, a query of every
   position, the FPR of a foreign genome's k-mers, the delete of a
   2^20-base region's k-mers: all ``ok``, ``count`` exact, their hits at
   most the FPR band's edge); the same keys into ``make("bloom",
   capacity=n_distinct)`` (every position found, FPR inside its band).
   The k-mer pack, Bloom insert and Bloom query kernels are then held
   exactly against their plain versions on the same inputs and timed.
   Keys/s of each step and the cuckoo/Bloom query ratio.
7. the mixed path at 2^28 slots — ``make("cuckoo")`` prefilled to load
   0.5, then three batches of 2^24 ops through ``FilterHandle.apply_ops``
   under each of the JAX package's ``benchmarks/mixed_workload.py`` mixes
   (``ycsb_50_40_10``: query / insert / delete 0.50 / 0.40 / 0.10;
   ``read_heavy_95_5``: 0.95 / 0.05 / 0), each from the prefilled table;
   queries and deletes draw stored keys (a key deleted once is not drawn
   again), inserts fresh ones, in a shuffled order. Every batch: ``ok``
   equal to core ``apply_ops``'s on a copy of the same table on the card,
   and all True; ``count`` equal to the stored non-zero tags; every key
   inserted by the batch found by a later query. Launch counts zeroed
   just before and read just after each ``apply_ops``; ops/s per mix and
   seconds per batch; one more batch under ``torch.profiler``. Then ``handle.delete`` and core ``delete`` of 2^24
   stored keys, each from the prefilled table: all ``ok``, ``count``
   exact, and the two tables holding the same (pair, tag) codes.
8. the serving path — ``qwen1_5_4b`` at full width (40 layers, d 2560,
   20 heads of 128, vocab 151936: 3.56e9 parameters, 7.1 GB of bf16)
   built on the card from a seeded CUDA generator, served through
   ``repro_torch.serve.ServeEngine`` (batch 4, prompts of 1024 tokens,
   32 greedy decode steps, a 4-entry prefix cache whose guard filter is a
   ``cuckoo`` handle behind ``FilterService``) on the request sequence of
   ``examples/serve_with_prefix_filter.py`` (prompt pools
   0,1,2,3,1,2,4,5,0,1 out of 6). Launch counts zeroed just before and
   read just after: the flash-attention kernel once a layer a prefill
   (40 x 8), the hash, direct-insert and mixed kernels (the guard's
   lookups, admissions and evictions). Gates: hits 2, evictions 4,
   filtered + misses 8, stale 0; a prompt served again (from the cache or
   after its eviction) gives the tokens of its first serve; the memory
   held after the run is the weights and four entries (evicted entries
   freed); the cached entries' logits and every timed prefill and decode
   logit finite. Then the model alone:
   prefill seconds and tokens/s, decode ms a step and tokens/s, one
   prefill and one decode step under ``torch.profiler``; the guard
   filter's lookups alone (wall and host syncs each).
8b. the flash-attention kernel against its plain version on the card:
   on layer 0's q/k/v captured from a full-width prefill, on the five
   shapes of ``tests/test_flash_kernel.py`` and on the head and tail rows
   of a unit-scale long prefill. Float32 output against the plain
   version: 1e-4 (that file's) for float32 inputs; for bf16 inputs (P
   rounded to bf16 on the tensor cores) 1e-2 in absolute error and in
   error over each row's largest |value|, so that a zeroed row or a
   dropped key fails. The bf16 output equals the float32 output rounded,
   bit for bit. Timed (kernel with the bf16 output the model path asks
   for and with float32, wrapper, model path, plain version,
   ``F.scaled_dot_product_attention`` as the library yardstick) at the
   serving prefill (B 4, S 1024, 20 heads, causal, bf16) and a long
   prefill (B 1, S 8192), each beside its bound.
9. the main path again at 2^22 slots (an 8 MiB table, resident in L2).

Before the last line: the ``nvidia-smi`` name and power limit, then the
``kernels`` line. The last line is ``{"ok": true, "device": {...}}``. Any
failed check raises and exits non-zero without it. Nothing here imports
JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import amq  # noqa: E402
from repro_torch.core import cuckoo_filter as CF  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core.bits64 import from_i32  # noqa: E402
from repro_torch.core.hashing import hash_key_plain, normalize_keys  # noqa: E402
from repro_torch.data.kmer import (  # noqa: E402
    canonicalize, kmer_keys, synthetic_genome)
from repro_torch.kernels import build, roofline  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels.cuckoo_insert import (  # noqa: E402
    cuckoo_insert_direct_plain, cuckoo_insert_launch,
    cuckoo_insert_unfused_launch)
from repro_torch.kernels.cuckoo_insert_bulk import (  # noqa: E402
    cuckoo_insert_bulk_launch, cuckoo_insert_bulk_plain)
from repro_torch.kernels.cuckoo_mixed import (  # noqa: E402
    cuckoo_mixed_launch, cuckoo_mixed_plain, segments, sorted_runs)
from repro_torch.kernels.cuckoo_query import (  # noqa: E402
    cuckoo_query_plain, cuckoo_query_unfused_launch,
    cuckoo_query_unfused_plain)
from repro_torch.kernels.hash64 import hash64_plain  # noqa: E402
from repro_torch.kernels.bloom import (  # noqa: E402
    bloom_insert_launch, bloom_insert_plain, bloom_query_launch,
    bloom_query_plain)
from repro_torch.kernels.kmer_pack import (  # noqa: E402
    kmer_pack_launch, kmer_pack_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_launch, flash_attention_plain)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.serve import PrefixCache, ServeEngine  # noqa: E402

SEED = 20260316
FULL_CAPACITY = 255_013_683      # floor(0.95 * 2**28)
L2_CAPACITY = 3_984_588          # floor(0.95 * 2**22)
BATCHES = 16
PROBES = 1 << 24
SUB = 1 << 12
CHUNK = 1 << 20                  # buckets unpacked at a time
GENOME_BASES = 248_956_422       # GRCh38 chromosome 1
FOREIGN_BASES = 1 << 24          # a foreign genome for the FPR
REGION_BASES = 1 << 20           # the deleted region; the checked prefix
KMER_K = 31
KMER_BATCH = 1 << 24
PY_CHECKS = 300
MIXED_BATCH = 1 << 24
MIXED_BATCHES = 3
# The JAX package's benchmarks/mixed_workload.py mixes: (query, insert,
# delete) fractions.
MIXES = {"ycsb_50_40_10": (0.50, 0.40, 0.10),
         "read_heavy_95_5": (0.95, 0.05, 0.0)}
# The serving path: qwen1_5_4b at full width through ServeEngine, the
# request sequence of examples/serve_with_prefix_filter.py (pool indices).
SERVE_ARCH = "qwen1_5_4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 1024, 32
SERVE_ENTRIES = 4
SERVE_POOLS = 6
SERVE_SEQUENCE = [0, 1, 2, 3, 1, 2, 4, 5, 0, 1]
LONG_PREFILL = 8192
# tests/test_flash_kernel.py's shapes: (B, KVH, g, Sq, Sk, D, Dv, causal,
# window, dtype).
FLASH_SHAPES = [
    (2, 2, 3, 192, 256, 64, 32, True, None, torch.float32),
    (2, 2, 3, 192, 256, 64, 32, True, 64, torch.float32),
    (1, 4, 1, 256, 256, 128, 128, False, None, torch.float32),
    (1, 1, 8, 100, 130, 32, 32, True, None, torch.float32),
    (2, 2, 2, 128, 128, 64, 64, True, None, torch.bfloat16),
]
# H100 SXM HBM3 rate (NVIDIA data sheet, at the full 700 W).
HBM_BYTES_PER_S = 3.35e12
TPU_KERNELS = {
    "hash64": "src/repro/kernels/hash64.py:25",
    "cuckoo_query": "src/repro/kernels/cuckoo_query.py:131",
    "cuckoo_query_unfused": "src/repro/kernels/cuckoo_query.py:118",
    "cuckoo_insert_direct": "src/repro/kernels/cuckoo_insert.py:187",
    "cuckoo_insert_unfused": "src/repro/kernels/cuckoo_insert.py:85",
    "cuckoo_insert_bulk": "src/repro/kernels/cuckoo_insert.py:308",
    "cuckoo_mixed": "src/repro/kernels/cuckoo_mixed.py:129",
    "bloom_query": "src/repro/kernels/bloom.py:35",
    "bloom_insert": "src/repro/kernels/bloom.py:81",
    "kmer_pack": "src/repro/kernels/kmer_pack.py:39",
    "flash_attention": "src/repro/kernels/flash_attention.py:91",
}
SOURCES = {
    "hash64": "src/repro_torch/kernels/csrc/hash64.cu",
    "cuckoo_query": "src/repro_torch/kernels/csrc/cuckoo_query.cu",
    "cuckoo_query_unfused": "src/repro_torch/kernels/csrc/cuckoo_query_unfused.cu",
    "cuckoo_insert_direct": "src/repro_torch/kernels/csrc/cuckoo_insert.cu",
    "cuckoo_insert_unfused": "src/repro_torch/kernels/csrc/cuckoo_insert_unfused.cu",
    "cuckoo_insert_bulk": "src/repro_torch/kernels/csrc/cuckoo_insert_bulk.cu",
    "cuckoo_mixed": "src/repro_torch/kernels/csrc/cuckoo_mixed.cu",
    "bloom_query": "src/repro_torch/kernels/csrc/bloom_query.cu",
    "bloom_insert": "src/repro_torch/kernels/csrc/bloom_insert.cu",
    "kmer_pack": "src/repro_torch/kernels/csrc/kmer_pack.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# The insert kernel an entry point runs under the legacy engine; the
# orientation build runs torch ops (and the hash kernel).
INSERT_KERNEL = {False: "cuckoo_insert_direct", True: "cuckoo_insert_bulk"}


class CheckFailed(RuntimeError):
    """A check of the run failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, setup=None) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up;
    ``setup`` runs before each, outside the timed window."""
    times = []
    for _ in range(reps + 1):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def random_keys(gen, n: int, top_half: bool = False):
    """n uint64 keys (int64 bits) in [0, 2^63), or in [2^63, 2^64)."""
    keys = torch.randint(0, 2**63 - 1, (n,), generator=gen, device="cuda")
    return keys | -(1 << 63) if top_half else keys


# ---------------------------------------------------------------------------
# Order-free checks of a whole table. Under the XOR policy a key's tag sits
# in one of its two buckets {i1, i1 ^ H(tag)}, and a stored tag's pair
# follows from (bucket, tag), so the code min(i1, i2) << fp | tag names
# where one key's tag may sit. The table holds exactly a set of keys iff
# the sorted codes of its stored tags equal those of the keys: a lost CAS
# update, a tag dropped or doubled by an eviction, or a stray write breaks
# the equality. The codes of keys use the plain hash, not the kernel.
# ---------------------------------------------------------------------------

def key_codes(cfg, batches):
    """Sorted (pair, tag) codes of the keys in ``batches``."""
    codes = []
    for keys in batches:
        tag, i1, i2 = CF.prepare_keys_plain(cfg, normalize_keys(keys))
        codes.append((torch.minimum(i1, i2) << cfg.fp_bits) | tag)
    return torch.sort(torch.cat(codes)).values


def bucket_lanes(cfg, table, b0: int, b1: int):
    """Tags of buckets [b0, b1) -> int64[b1 - b0, bucket_size]."""
    wpb = cfg.layout.words_per_bucket
    words = from_i32(table[b0 * wpb:b1 * wpb]).view(b1 - b0, wpb)
    return L.unpack_words(words, cfg.fp_bits)


def table_codes(cfg, table):
    """Sorted (pair, tag) codes of every tag stored in ``table``."""
    codes = []
    for b0 in range(0, cfg.num_buckets, CHUNK):
        b1 = min(b0 + CHUNK, cfg.num_buckets)
        tags = bucket_lanes(cfg, table, b0, b1)
        live = tags != 0
        bucket = torch.arange(b0, b1, device=table.device)[:, None].expand_as(tags)[live]
        tag = tags[live]
        alt = cfg.placement.alt_bucket(bucket, tag)
        codes.append((torch.minimum(bucket, alt) << cfg.fp_bits) | tag)
    return torch.sort(torch.cat(codes)).values


def check_codes(label: str, got, want) -> None:
    check(got.shape == want.shape,
          f"{label}: {got.shape[0]} tags stored, {want.shape[0]} expected")
    bad = int((got != want).sum())
    check(bad == 0, f"{label}: {bad} stored (bucket pair, tag) codes differ "
                    "from the keys'")


def moved_lanes(cfg, before, after, fills: bool) -> int:
    """Lanes an insert (``fills``) or a delete may not change: a lane that
    held a tag before (insert) or holds one after (delete), yet differs."""
    bad = 0
    for b0 in range(0, cfg.num_buckets, CHUNK):
        b1 = min(b0 + CHUNK, cfg.num_buckets)
        tb, ta = bucket_lanes(cfg, before, b0, b1), bucket_lanes(cfg, after, b0, b1)
        bad += int((((tb if fills else ta) != 0) & (ta != tb)).sum())
    return bad


def check_direct_insert(cfg, state, base, keys, label: str,
                        kernel=K.cuckoo_insert_direct) -> int:
    """An insert kernel without eviction (direct or bulk) on a whole batch,
    against what the plain loop gives in every order: no stored tag moves;
    the tags added are exactly the placed keys'; a key is turned down only
    if both its buckets are full. Returns the keys turned down."""
    table = base.clone()
    _, ok = kernel(cfg, state._replace(table=table), keys)
    check(moved_lanes(cfg, base, table, fills=True) == 0,
          f"{label}: a stored tag changed")
    check_codes(label, table_codes(cfg, table),
                torch.sort(torch.cat([table_codes(cfg, base),
                                      key_codes(cfg, [keys[ok]])])).values)
    _, i1, i2 = CF.prepare_keys_plain(cfg, keys[~ok])
    full = ((L.bucket_tags(table, i1, cfg.layout) != 0).all(-1)
            & (L.bucket_tags(table, i2, cfg.layout) != 0).all(-1))
    check(bool(full.all()), f"{label}: {int((~full).sum())} keys turned "
                            "down with a free slot left")
    return int((~ok).sum())


def check_delete(cfg, state, base, keys, label: str) -> None:
    """The delete on a whole batch of stored keys, against what the plain
    loop gives in every order: every delete ``ok`` (each key's code is
    stored at least as often as keys carry it); only lanes are cleared; the
    tags removed are exactly the deleted keys'."""
    table = base.clone()
    ops = torch.full((keys.shape[0],), amq.OP_DELETE, dtype=torch.int32,
                     device=keys.device)
    _, ok = K.cuckoo_apply_ops(cfg, state._replace(table=table), keys, ops)
    check(bool(ok.all()), f"{label}: {int((~ok).sum())} deletes failed")
    check(moved_lanes(cfg, base, table, fills=False) == 0,
          f"{label}: a lane other than a cleared one changed")
    check_codes(label, torch.sort(torch.cat([table_codes(cfg, table),
                                             key_codes(cfg, [keys])])).values,
                table_codes(cfg, base))


def touched_buckets(cfg, base, keys, after=None, insert=False):
    """The distinct buckets a batch of ``keys`` needs at least, from this
    run's data -> (read, written). Read: every key's primary bucket; its
    alternate where ``base`` cannot settle the key at the primary (no free
    slot for an insert, no matching tag for a query or delete); every
    bucket whose words differ between ``base`` and ``after``. Written:
    those changed buckets. The bound charges each once (roofline)."""
    lay = cfg.layout
    tag, i1, i2 = CF.prepare_keys_plain(cfg, keys)
    want = (torch.zeros_like(tag) if insert
            else cfg.placement.place_tag(tag, False))
    settled = torch.cat([
        (L.bucket_tags(base, b, lay) == w[:, None]).any(-1)
        for b, w in zip(i1.split(CHUNK), want.split(CHUNK))])
    need, written = [i1, i2[~settled]], 0
    if after is not None:
        changed = (after != base).view(-1, lay.words_per_bucket).any(1)
        need.append(changed.nonzero().squeeze(1))
        written = int(changed.sum())
    return torch.unique(torch.cat(need)).numel(), written


def bucket_tags(cfg, table, buckets):
    """Sorted tags of each bucket in ``buckets`` (order-free multisets)."""
    return torch.sort(L.bucket_tags(table, buckets, cfg.layout), dim=-1).values


def same_outcome(cfg, base, keys, run_kernel, run_plain):
    """Run both on clones of ``base``; equal ok, equal tag multisets in the
    touched buckets, and no other word changed. Returns the ok mismatches."""
    t_kernel, t_plain = base.clone(), base.clone()
    ok_k = run_kernel(t_kernel)
    ok_p = run_plain(t_plain)
    torch.cuda.synchronize()
    check(torch.equal(ok_k, ok_p),
          f"ok differs on {int((ok_k != ok_p).sum())} of {ok_k.shape[0]}")
    _, i1, i2 = CF.prepare_keys_plain(cfg, keys)
    buckets = torch.unique(torch.cat([i1, i2]))
    check(torch.equal(bucket_tags(cfg, t_kernel, buckets),
                      bucket_tags(cfg, t_plain, buckets)),
          "bucket tag multisets differ")
    words = (buckets[:, None] * cfg.layout.words_per_bucket
             + torch.arange(cfg.layout.words_per_bucket, device=base.device))
    outside = torch.ones_like(base, dtype=torch.bool)
    outside[words.reshape(-1)] = False
    check(torch.equal(t_kernel[outside], base[outside])
          and torch.equal(t_plain[outside], base[outside]),
          "a word outside the touched buckets changed")
    return int((ok_k != ok_p).sum())


# ---------------------------------------------------------------------------
# The main path.
# ---------------------------------------------------------------------------

def batch_sizes(capacity: int):
    """The main path's batches: at most 2^24 keys, ``BATCHES`` of them."""
    batch = min(1 << 24, -(-capacity // (BATCHES - 1)))
    return [m for m in (min(batch, capacity - b * batch)
                        for b in range(BATCHES)) if m > 0]


def fill(h, label: str, batches, bulk, on_batch=None):
    """Insert ``batches`` into handle ``h``; batch b with ``bulk[b]``.
    Every key must be placed and ``count`` must equal the keys placed; the
    table must hold exactly those keys. Returns (seconds, per-batch
    records). ``on_batch(b)`` runs before batch b, outside the clock."""
    insert_s, per_batch = 0.0, []
    torch.cuda.reset_peak_memory_stats()
    for b, keys in enumerate(batches):
        if on_batch is not None:
            on_batch(b)
        m = keys.shape[0]
        # The kernel routes hand their residue (keys with both buckets
        # full) to the frontier or to the round loop, and the frontier its
        # stragglers to the loop; the core records each hand-off's size on
        # the device, read after the clock stops.
        CF.FRONTIER_KEYS, CF.LOOP_KEYS = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = h.insert(keys, bulk=bulk[b])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        insert_s += dt
        frontier, residue = int(sum(CF.FRONTIER_KEYS)), int(sum(CF.LOOP_KEYS))
        CF.FRONTIER_KEYS = CF.LOOP_KEYS = None
        placed = int(rep.ok.sum())
        check(placed == m, f"{label}: batch {b}: {m - placed} of {m} keys "
                           f"not placed at load {h.load_factor:.4f}")
        per_batch.append({"keys": m, "bulk": bulk[b], "s": dt,
                          "rounds": int(rep.rounds),
                          "frontier_keys": frontier, "residue": residue,
                          "load": h.load_factor})
    peak = torch.cuda.max_memory_allocated()
    inserted = sum(k.shape[0] for k in batches)
    check(h.count() == inserted,
          f"{label}: count {h.count()} != {inserted} keys placed")
    check_codes(f"{label}: table after the fill",
                table_codes(h.config, h.state.table),
                key_codes(h.config, batches))
    return insert_s, per_batch, peak


def check_no_false_negatives(h, label: str, batches):
    """Query every inserted key with the kernel and the plain query; both
    must find all. Returns the median seconds of a full-size batch's query
    and the misses (kernel, plain)."""
    query_s, misses, plain_misses = [], 0, 0
    full = max(k.shape[0] for k in batches)
    for keys in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = h.query(keys).hits
        torch.cuda.synchronize()
        if keys.shape[0] == full:
            query_s.append(time.perf_counter() - t0)
        misses += int((~hits).sum())
        plain = cuckoo_query_plain(h.config, h.state.table,
                                   normalize_keys(keys))
        plain_misses += int((~plain).sum())
    check(misses == 0, f"{label}: {misses} false negatives (query kernel)")
    check(plain_misses == 0, f"{label}: {plain_misses} false negatives "
                             "(plain query)")
    return statistics.median(query_s), misses, plain_misses


def routed_kernels(cfg, bulk_flags, deletes: bool):
    """The kernels a run must launch: the hash and query kernels always;
    the insert kernel of each entry point its engine runs on a kernel (the
    legacy loop and the frontier take a kernel's residue); the mixed
    kernel for deletes."""
    names = {"hash64", "cuckoo_query"}
    for bulk in set(bulk_flags):
        if CF.resolve_engine(cfg, bulk) in ("legacy", "frontier"):
            names.add(INSERT_KERNEL[bulk])
    if deletes:
        names.add("cuckoo_mixed")
    return sorted(names)


def check_launches(label: str, expect):
    launches = dict(K.LAUNCHES)
    for name in expect:
        check(launches[name] > 0,
              f"{label}: kernel {name} was not launched on its path")
    return launches


def main_path(capacity: int, gen, label: str):
    """Fill, query, measure the FPR and delete through ``amq.make``.

    Returns the handle, clones of the table at load 0.5, before the last
    batch and after the fill (load 0.95), every batch's keys and the
    launch counts."""
    K.reset_launches()
    h = amq.make("cuckoo", capacity=capacity)
    cfg = h.config
    check(cfg.policy == "xor", "the table checks need the XOR policy")
    sizes = batch_sizes(capacity)
    batches = [random_keys(gen, m) for m in sizes]
    bulk = [b >= BATCHES - 4 for b in range(len(sizes))]
    snaps = {}

    def snapshot(b):
        if b == len(sizes) - 1:
            snaps["high"] = h.state.table.clone()
        if "half" not in snaps and h.count() >= cfg.num_slots // 2:
            snaps["half"] = h.state.table.clone()

    insert_s, per_batch, peak = fill(h, label, batches, bulk, snapshot)
    snaps["full"] = h.state.table.clone()
    inserted = sum(sizes)
    load = h.load_factor
    query_s, misses, plain_misses = check_no_false_negatives(h, label,
                                                             batches)

    fresh = random_keys(gen, PROBES, top_half=True)
    fpr = int(h.query(fresh).hits.sum()) / PROBES
    expected = h.expected_fpr()
    lo, hi = amq.fpr_tolerance(expected, PROBES)
    check(lo <= fpr <= hi, f"{label}: FPR {fpr} outside [{lo}, {hi}] "
                           f"(Eq. 4: {expected})")

    first = batches[0]
    before = h.count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = h.delete(first)
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    check(bool(rep.ok.all()), f"{label}: {int((~rep.ok).sum())} deletes failed")
    check(before - h.count() == first.shape[0],
          f"{label}: count fell by {before - h.count()}, not {first.shape[0]}")
    check_codes(f"{label}: table after the delete",
                table_codes(cfg, h.state.table), key_codes(cfg, batches[1:]))

    expect = routed_kernels(cfg, bulk, True)
    launches = check_launches(label, expect)
    emit({"phase": f"main_path_{label}", "slots": cfg.num_slots,
          "table_bytes": cfg.table_bytes, "config": repr(cfg),
          "keys_inserted": inserted, "load": load, "batches": per_batch,
          "false_negatives": misses, "plain_false_negatives": plain_misses,
          "keys_queried": inserted, "fpr": fpr, "fpr_expected": expected,
          "fpr_band": [lo, hi], "deleted": first.shape[0],
          "count_after_delete": h.count(),
          "table_checks": "stored (pair, tag) codes == keys' after fill "
                          "and after delete",
          "launches": launches, "kernels_routed": expect,
          "insert_keys_per_s": inserted / insert_s,
          "frontier_keys": sum(r["frontier_keys"] for r in per_batch),
          "residue_keys": sum(r["residue"] for r in per_batch),
          "max_memory_allocated": peak,
          "query_keys_per_s": max(sizes) / query_s,
          "delete_keys_per_s": first.shape[0] / delete_s})
    return h, snaps, batches, launches


def warm_up(gen) -> float:
    """The main path once at 2^16 slots, the legacy bulk route, a mixed
    batch, the unfused kernels, and the k-mer and Bloom kernels, so that
    library loading and first calls are paid before anything is timed.
    Returns its seconds."""
    t0 = time.perf_counter()
    keys = random_keys(gen, 62_259)             # floor(0.95 * 2**16)
    for engine in ("auto", "legacy"):
        h = amq.make("cuckoo", capacity=62_259, insert_engine=engine)
        for b, part in enumerate(keys.chunk(BATCHES)):
            h.insert(part, bulk=b % 2 == 0)
        h.query(keys)
        h.delete(keys[:1000])
        h.apply_ops(amq.OpBatch.make(keys[:4096], torch.randint(
            0, 3, (4096,), generator=gen, device="cuda")))
        K.cuckoo_query(h.config, h.state, normalize_keys(keys), fused=False)
        K.cuckoo_insert_direct(h.config, h.state, normalize_keys(keys[:1000]),
                               fused=False)
    codes = torch.randint(0, 4, (1 << 16,), generator=gen, device="cuda",
                          dtype=torch.uint8)
    hb = amq.make("bloom", capacity=62_259)
    hb.insert(kmer_keys(codes, KMER_K))
    hb.query(keys)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_orientation(gen, batches_like, at: int = 8, top: int = 15):
    """One orientation batch under ``torch.profiler``: a fresh 2^28-slot
    handle takes the main path's batches 0..at-1 with ``bulk=True``
    unprofiled, then batch ``at`` profiled (:func:`profiled`)."""
    h = amq.make("cuckoo", capacity=FULL_CAPACITY)
    for k in batches_like[:at]:
        h.insert(random_keys(gen, k.shape[0]), bulk=True)
    keys = random_keys(gen, batches_like[at].shape[0])
    rep, record = profiled(lambda: h.insert(keys, bulk=True), top)
    check(bool(rep.ok.all()), "profiled orientation batch: keys not placed")
    del h
    torch.cuda.empty_cache()
    return {"batch": at, "load_after": (at + 1) / BATCHES, **record}


def profiled(fn, top: int = 15):
    """``fn()`` once under ``torch.profiler`` -> (its result, {wall
    seconds, device-busy seconds (sum of kernel self times), idle share,
    the ``top`` operators by self device time})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events are the kernels (their sum is the busy time);
    # host-side operators carry the device time of the kernels they launch.
    cuda = torch.autograd.DeviceType.CUDA
    stats = prof.key_averages()
    busy = sum(e.self_device_time_total for e in stats
               if e.device_type == cuda) * 1e-6
    events = sorted((e for e in stats if e.device_type != cuda
                     and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    return out, {"wall_s": wall, "device_busy_s": busy,
                 "device_idle_share": 1 - busy / wall,
                 "top_ops": [{"op": e.key, "calls": e.count,
                              "device_ms": e.self_device_time_total * 1e-3,
                              "cpu_ms": e.cpu_time_total * 1e-3}
                             for e in events[:top]]}


def adapter_route(cfg, bulk: bool) -> str:
    """The route the ``cuckoo`` adapter takes for an entry point."""
    if CF.resolve_engine(cfg, bulk) == "orientation":
        return "orientation"
    kernel = "bulk kernel" if bulk else "direct kernel"
    residue = ("frontier" if cfg.insert_engine == "frontier" and not bulk
               else "round loop")
    return f"{kernel} + {residue}"


def fills_2_28(gen, batches_like):
    """Phase 5: fill fresh 2^28-slot handles to 0.95 in the main path's
    batch sizes, under each engine: bulk under ``auto`` (orientation) and
    ``legacy`` (bulk kernel + loop), incremental under ``auto`` and
    ``legacy`` (direct kernel + loop) and ``frontier`` (direct kernel +
    frontier). The main path's gates on each. Returns {label: launch
    counts}."""
    batches = [random_keys(gen, k.shape[0]) for k in batches_like]
    inserted = sum(k.shape[0] for k in batches)
    out = {}
    for bulk, engine in ((True, "auto"), (True, "legacy"), (False, "auto"),
                         (False, "legacy"), (False, "frontier")):
        label = f"{'bulk_build' if bulk else 'incremental'}_{engine}"
        t0 = time.perf_counter()
        K.reset_launches()
        h = amq.make("cuckoo", capacity=FULL_CAPACITY, insert_engine=engine)
        insert_s, per_batch, peak = fill(h, label, batches,
                                         [bulk] * len(batches))
        _, misses, plain_misses = check_no_false_negatives(h, label, batches)
        expect = routed_kernels(h.config, [bulk], False)
        out[label] = check_launches(label, expect)
        emit({"phase": label, "route": adapter_route(h.config, bulk),
              "slots": h.config.num_slots, "keys_inserted": inserted,
              "load": h.load_factor, "insert_keys_per_s": inserted / insert_s,
              "insert_s": insert_s, "batches": per_batch,
              "frontier_keys": sum(r["frontier_keys"] for r in per_batch),
              "residue_keys": sum(r["residue"] for r in per_batch),
              "max_memory_allocated": peak,
              "false_negatives": misses,
              "plain_false_negatives": plain_misses,
              "table_checks": "stored (pair, tag) codes == keys' after fill",
              "launches": out[label], "kernels_routed": expect,
              "seconds": time.perf_counter() - t0})
        del h
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The k-mer case study (paper §5.5, fig8): a chromosome's k-mer set in the
# cuckoo filter and in the blocked Bloom filter.
# ---------------------------------------------------------------------------

def u64_bits(keys):
    """int32[n, 2] (lo, hi) keys -> int64[n] holding each key's 64 bits."""
    return (from_i32(keys[:, 1]) << 32) | from_i32(keys[:, 0])


def py_canonical(codes, i: int, k: int):
    """The canonical k-mer at position ``i`` with Python ints -> (lo, hi)."""
    fwd = rev = 0
    for j in range(k):
        fwd = (fwd << 2) | codes[i + j]
        rev = (rev << 2) | (3 - codes[i + k - 1 - j])
    c = min(fwd, rev)
    return c & 0xFFFFFFFF, c >> 32


def timed(fn):
    """(result, seconds) of ``fn`` between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fpr_of(label, hits, expected):
    """The measured FPR of ``hits`` (probes not in the set), held to the
    band of ``expected``."""
    n = hits.shape[0]
    fpr = int(hits.sum()) / n
    lo, hi = amq.fpr_tolerance(expected, n)
    check(lo <= fpr <= hi, f"{label}: FPR {fpr} outside [{lo}, {hi}] "
                           f"(expected {expected})")
    return {"fpr": fpr, "fpr_expected": expected, "fpr_band": [lo, hi],
            "probes": n}


def kmer_case_study(gen):
    """The k-mer set of a synthetic chromosome 1 through ``kmer_keys``,
    the cuckoo filter and the blocked Bloom filter (see the module
    docstring). Returns (timing records, launch counts)."""
    secs = {}
    t0 = time.perf_counter()
    genome = synthetic_genome(GENOME_BASES, SEED)
    foreign_codes = synthetic_genome(FOREIGN_BASES, SEED + 1)
    secs["genome_on_host"] = time.perf_counter() - t0
    codes = torch.from_numpy(genome).cuda()

    # The plain canonical keys of a prefix against Python integers.
    prefix = genome[:REGION_BASES].tolist()
    plain = canonicalize(kmer_pack_plain(codes[:REGION_BASES], KMER_K),
                         KMER_K).cpu()
    last = REGION_BASES - KMER_K
    picks = torch.randint(0, last + 1, (PY_CHECKS,), generator=gen,
                          device="cuda").tolist() + [0, last]
    for i in picks:
        lo, hi = py_canonical(prefix, i, KMER_K)
        got = (int(plain[i, 0]) & 0xFFFFFFFF, int(plain[i, 1]) & 0xFFFFFFFF)
        check(got == (lo, hi), f"kmer: plain canonical key at {i} is {got}, "
                               f"Python ints give {(lo, hi)}")

    # --- the path: kmer_keys, then both filters ---------------------------
    K.reset_launches()
    keys, secs["kmer_keys"] = timed(lambda: kmer_keys(codes, KMER_K))
    n_pos = keys.shape[0]
    check(keys.shape == (GENOME_BASES - KMER_K + 1, 2),
          f"kmer: keys of shape {list(keys.shape)}")
    distinct = torch.unique(u64_bits(keys))                  # sorted
    n_distinct = distinct.numel()
    order = distinct[torch.randperm(n_distinct, generator=gen,
                                    device="cuda")]
    batches = list(order.split(KMER_BATCH))

    h = amq.make("cuckoo", capacity=n_distinct)
    cfg = h.config
    insert_s, per_batch, peak = fill(h, "kmer_cuckoo", batches,
                                     [False] * len(batches))
    hits, query_s = timed(lambda: h.query(keys).hits)
    misses = int((~hits).sum())
    check(misses == 0, f"kmer_cuckoo: {misses} of {n_pos} positions missed")

    foreign = torch.unique(u64_bits(kmer_keys(
        torch.from_numpy(foreign_codes).cuda(), KMER_K)))
    at = torch.searchsorted(distinct, foreign).clamp(max=n_distinct - 1)
    probes = foreign[distinct[at] != foreign]
    cuckoo_fpr = fpr_of("kmer_cuckoo", h.query(probes).hits,
                        h.expected_fpr())

    r0 = GENOME_BASES // 2
    region = torch.unique(u64_bits(kmer_keys(codes[r0:r0 + REGION_BASES],
                                             KMER_K)))
    before = h.count()
    rep, delete_s = timed(lambda: h.delete(region))
    check(bool(rep.ok.all()),
          f"kmer_cuckoo: {int((~rep.ok).sum())} deletes failed")
    check(before - h.count() == region.numel(),
          f"kmer_cuckoo: count fell by {before - h.count()}, not "
          f"{region.numel()}")
    at = torch.searchsorted(region, distinct).clamp(max=region.numel() - 1)
    check_codes("kmer_cuckoo: table after the delete",
                table_codes(cfg, h.state.table),
                key_codes(cfg, [distinct[region[at] != distinct]]))
    # A deleted k-mer hits only as a false positive: at most the band's
    # upper edge.
    gone = int(h.query(region).hits.sum()) / region.numel()
    gone_hi = amq.fpr_tolerance(h.expected_fpr(), region.numel())[1]
    check(gone <= gone_hi, f"kmer_cuckoo: deleted k-mers hit at {gone} > "
                           f"{gone_hi}")

    hb = amq.make("bloom", capacity=n_distinct)
    bcfg = hb.config
    bloom_insert_s = 0.0
    for b in batches:
        _, dt = timed(lambda b=b: hb.insert(b))
        bloom_insert_s += dt
    check(hb.count() == n_distinct, f"kmer_bloom: count {hb.count()}")
    bhits, bloom_query_s = timed(lambda: hb.query(keys).hits)
    bmisses = int((~bhits).sum())
    check(bmisses == 0, f"kmer_bloom: {bmisses} of {n_pos} positions missed")
    bloom_fpr = fpr_of("kmer_bloom", hb.query(probes).hits,
                       bcfg.expected_fpr(1.0))
    launches = check_launches("kmer_case_study", [
        "kmer_pack", "hash64", "cuckoo_insert_direct", "cuckoo_query",
        "cuckoo_mixed", "bloom_insert", "bloom_query"])

    # --- the three kernels against their plain versions ------------------
    # Each count is of differing elements (keys, table words, hits).
    t0 = time.perf_counter()
    packed, want = K.kmer_pack(codes, KMER_K), kmer_pack_plain(codes, KMER_K)
    errs = {"kmer_pack": int((packed != want).sum())}
    del packed, want
    table = bcfg.init("cuda").table
    bloom_insert_plain(bcfg, table, normalize_keys(order),
                       torch.ones(n_distinct, dtype=torch.bool, device="cuda"))
    errs["bloom_insert"] = int((table != hb.state.table).sum())
    errs["bloom_query"] = sum(
        int((got != bloom_query_plain(bcfg, table, part)).sum())
        for part, got in zip(keys.split(KMER_BATCH), bhits.split(KMER_BATCH)))
    for name, err in errs.items():
        check(err == 0, f"{name}: {err} elements differ from its plain "
                        "version's")
    secs["kernels_vs_plain"] = time.perf_counter() - t0

    # --- timings at the case study's shapes --------------------------------
    t0 = time.perf_counter()
    timing, wrapper = {}, {}
    out = torch.empty_like(keys)
    timing["kmer_pack"] = (
        cuda_ms(lambda: kmer_pack_launch(codes, KMER_K, out)),
        cuda_ms(lambda: kmer_pack_plain(codes, KMER_K), reps=3),
        n_pos, n_pos, roofline.kmer_pack_bytes(GENOME_BASES, KMER_K),
        roofline.kmer_pack_int_ops(GENOME_BASES), None)
    wrapper["kmer_pack"] = cuda_ms(lambda: K.kmer_pack(codes, KMER_K))
    del out

    def blocks_of(k):
        return torch.unique(hash_key_plain(k, bcfg.hash_kind, bcfg.seed)[1]
                            % bcfg.num_blocks).numel()

    sub = keys[:KMER_BATCH]
    hit = torch.empty(n_pos, dtype=torch.bool, device="cuda")
    touched = blocks_of(normalize_keys(distinct))   # every position's block
    timing["bloom_query"] = (
        cuda_ms(lambda: bloom_query_launch(bcfg, table, keys, hit)),
        cuda_ms(lambda: bloom_query_plain(bcfg, table, sub), reps=3),
        n_pos, sub.shape[0],
        roofline.bloom_batch_bytes(bcfg, "query", n_pos, touched),
        roofline.bloom_int_ops_per_key(bcfg) * n_pos, touched)
    wrapper["bloom_query"] = cuda_ms(
        lambda: K.bloom_query(bcfg, hb.state, keys))
    first = normalize_keys(batches[0])
    m = first.shape[0]
    valid = torch.ones(m, dtype=torch.bool, device="cuda")
    touched = blocks_of(first)
    timing["bloom_insert"] = (
        cuda_ms(lambda: bloom_insert_launch(bcfg, table, first, valid),
                setup=table.zero_),
        cuda_ms(lambda: bloom_insert_plain(bcfg, table, first, valid),
                reps=3, setup=table.zero_),
        m, m, roofline.bloom_batch_bytes(bcfg, "insert", m, touched),
        roofline.bloom_int_ops_per_key(bcfg) * m, touched)
    wrapper["bloom_insert"] = cuda_ms(
        lambda: K.bloom_insert(bcfg, hb.state._replace(table=table), first,
                               valid), setup=table.zero_)
    secs["timings"] = time.perf_counter() - t0

    emit({"phase": "kmer_case_study", "bases": GENOME_BASES, "k": KMER_K,
          "positions": n_pos, "n_distinct": n_distinct,
          "python_int_checks": len(picks),
          "cuckoo": {"config": repr(cfg), "table_bytes": cfg.table_bytes,
                     "load": h.load_factor, "batches": per_batch,
                     "frontier_keys": sum(r["frontier_keys"] for r in per_batch),
                     "residue_keys": sum(r["residue"] for r in per_batch),
                     "max_memory_allocated": peak,
                     "false_negatives": misses, **cuckoo_fpr,
                     "deleted": region.numel(),
                     "count_after_delete": h.count(),
                     "deleted_hit_rate": gone,
                     "deleted_hit_rate_max": gone_hi},
          "bloom": {"config": repr(bcfg), "table_bytes": bcfg.table_bytes,
                    "load": hb.load_factor, "false_negatives": bmisses,
                    **bloom_fpr},
          "keys_per_s": {
              "kmer_keys": n_pos / secs["kmer_keys"],
              "cuckoo_insert": n_distinct / insert_s,
              "cuckoo_query": n_pos / query_s,
              "cuckoo_delete": region.numel() / delete_s,
              "bloom_insert": n_distinct / bloom_insert_s,
              "bloom_query": n_pos / bloom_query_s},
          "cuckoo_query_over_bloom_query": bloom_query_s / query_s,
          "launches": launches, "max_abs_err": errs, "seconds": secs})
    del h, hb, keys, distinct, order, batches, codes, table, hit
    torch.cuda.empty_cache()
    return timing, wrapper, launches, errs


# ---------------------------------------------------------------------------
# The fused-vs-unfused comparison (kernels #2/#3 and #4/#5).
# ---------------------------------------------------------------------------

def unfused_comparison(h, snaps, stored, ins_keys, gen):
    """Phase 3b (see the module docstring). ``stored``: 2^24 keys stored in
    every snapshot (those the fused query is timed on); ``ins_keys``: the
    2^24 fresh keys the fused insert is timed with. Returns (launch counts
    of the comparison, errors against the plain versions, records for the
    ``kernels`` line)."""
    cfg = h.config
    n = stored.shape[0]
    t0 = time.perf_counter()
    probe = torch.cat([stored[:n // 2], normalize_keys(
        random_keys(gen, n - n // 2, top_half=True))])
    tables = {"load_0.5": snaps["half"], "load_0.95": snaps["full"]}

    # --- the comparison itself, through the wrappers a caller uses.
    K.reset_launches()
    hits, placed = {}, {}
    for where, table in tables.items():
        st = h.state._replace(table=table)
        hits[where] = (K.cuckoo_query(cfg, st, probe),
                       K.cuckoo_query(cfg, st, probe, fused=False))
        placed[where] = tuple(
            K.cuckoo_insert_direct(cfg, st._replace(table=table.clone()),
                                   ins_keys, fused=fused)[1]
            for fused in (True, False))
    torch.cuda.synchronize()
    launches = check_launches("unfused_comparison", [
        "cuckoo_query", "cuckoo_query_unfused", "cuckoo_insert_direct",
        "cuckoo_insert_unfused"])
    for where, (fused, unfused) in hits.items():
        check(torch.equal(fused, unfused),
              f"{where}: the unfused query differs from the fused on "
              f"{int((fused != unfused).sum())} keys")
        check(bool(fused[:n // 2].all()), f"{where}: a stored key missed")

    # --- each unfused kernel against its plain version (not counted).
    unfused_insert = functools.partial(K.cuckoo_insert_direct, fused=False)
    errs, turned_down = {"cuckoo_query_unfused": 0}, {}
    part = probe[::4].contiguous()
    for where, table in tables.items():
        got = K.cuckoo_query(cfg, h.state._replace(table=table), part,
                             fused=False)
        want = cuckoo_query_unfused_plain(cfg, table, part)
        errs["cuckoo_query_unfused"] += int((got != want).sum())
        turned_down[where] = [int((~ok).sum()) for ok in placed[where]]
        turned_down[where].append(check_direct_insert(
            cfg, h.state, table, ins_keys, f"cuckoo_insert_unfused {where}",
            unfused_insert))
    check(errs["cuckoo_query_unfused"] == 0,
          "cuckoo_query_unfused differs from its plain version")
    sub = ins_keys[:SUB]
    valid = torch.rand(SUB, device="cuda", generator=gen) < 0.9
    errs["cuckoo_insert_unfused"] = same_outcome(
        cfg, snaps["half"], sub,
        lambda t: unfused_insert(cfg, h.state._replace(table=t), sub, valid)[1],
        lambda t: cuckoo_insert_direct_plain(cfg, t, sub, valid))

    # --- fused against unfused at both loads (kernel times).
    ms = {}
    work = torch.empty_like(snaps["full"])
    ins_valid = torch.ones(n, dtype=torch.bool, device="cuda")
    ins_ok = torch.empty(n, dtype=torch.bool, device="cuda")
    for where, table in tables.items():
        st = h.state._replace(table=table)
        ms[where] = {
            "query_fused": cuda_ms(lambda: K.cuckoo_query(cfg, st, probe)),
            "query_unfused": cuda_ms(
                lambda: K.cuckoo_query(cfg, st, probe, fused=False)),
            "insert_fused": cuda_ms(
                lambda: cuckoo_insert_launch(cfg, work, ins_keys, ins_valid,
                                             ins_ok),
                reps=3, setup=lambda: work.copy_(table)),
            "insert_unfused": cuda_ms(
                lambda: cuckoo_insert_unfused_launch(cfg, work, ins_keys,
                                                     ins_valid, ins_ok),
                reps=3, setup=lambda: work.copy_(table))}
        ms[where]["query_unfused_over_fused"] = (
            ms[where]["query_unfused"] / ms[where]["query_fused"])
        ms[where]["insert_unfused_over_fused"] = (
            ms[where]["insert_unfused"] / ms[where]["insert_fused"])

    # --- the records of the kernels line: the main path's shapes (the
    # query on the table after the main path, the insert into load 0.5),
    # with the fused kernels' bounds (the same function).
    query_keys = stored
    touched = touched_buckets(cfg, h.state.table, query_keys)
    # Kernel times are launches alone; wrapper times add the wrapper's
    # checks, allocations and count.
    hit = torch.empty(n, dtype=torch.bool, device="cuda")
    records = {"cuckoo_query_unfused": (
        cuda_ms(lambda: cuckoo_query_unfused_launch(cfg, h.state.table,
                                                    query_keys, hit)),
        cuda_ms(lambda: cuckoo_query_unfused_plain(cfg, h.state.table,
                                                   query_keys), reps=3),
        n, n, "query", touched)}
    wrapper = {"cuckoo_query_unfused": cuda_ms(
        lambda: K.cuckoo_query(cfg, h.state, query_keys, fused=False))}
    half = snaps["half"]
    t_ms = cuda_ms(lambda: cuckoo_insert_unfused_launch(
        cfg, work, ins_keys, ins_valid, ins_ok), reps=3,
        setup=lambda: work.copy_(half))
    touched = touched_buckets(cfg, half, ins_keys, work, insert=True)
    sub_valid = torch.ones(SUB, dtype=torch.bool, device="cuda")
    records["cuckoo_insert_unfused"] = (
        t_ms, cuda_ms(lambda: cuckoo_insert_direct_plain(cfg, work, sub,
                                                         sub_valid),
                      reps=3, setup=lambda: work.copy_(half)),
        n, SUB, "insert", touched)
    wrapper["cuckoo_insert_unfused"] = cuda_ms(
        lambda: K.cuckoo_insert_direct(cfg, h.state._replace(table=work),
                                       ins_keys, ins_valid, fused=False),
        reps=3, setup=lambda: work.copy_(half))
    emit({"phase": "unfused_comparison", "keys": n, "launches": launches,
          "max_abs_err": errs,
          "turned_down_fused_unfused_checked": turned_down, "ms": ms,
          "tolerance": "exact (0): unfused query hits == fused query hits "
                       "at 2^24 keys, == its plain version at 2^22; "
                       "unfused insert: the order-free outcome at 2^24 "
                       "keys, equal ok and tag multisets at 2^12",
          "seconds": time.perf_counter() - t0})
    del work, hit
    return launches, errs, records, wrapper


# ---------------------------------------------------------------------------
# The mixed path: op batches through FilterHandle.apply_ops.
# ---------------------------------------------------------------------------

def stored_tags(cfg, table) -> int:
    """Non-zero lanes of ``table`` (stored fingerprints)."""
    return sum(int((bucket_lanes(cfg, table, b0, min(b0 + CHUNK,
                                                     cfg.num_buckets)) != 0)
                   .sum())
               for b0 in range(0, cfg.num_buckets, CHUNK))


def mixed_path(gen):
    """Phase 7 (see the module docstring). Returns {mix: launch counts}."""
    t_start = time.perf_counter()
    h = amq.make("cuckoo", capacity=FULL_CAPACITY)
    cfg = h.config
    pool = random_keys(gen, cfg.num_slots // 2)        # prefill: load 0.5
    for part in pool.split(1 << 24):
        check(bool(h.insert(part).ok.all()), "mixed: prefill keys not placed")
    base = CF.CuckooState(h.state.table.clone(), h.state.count.clone())
    check(h.count() == pool.shape[0], "mixed: prefill count")
    out = {}
    for mix, fractions in MIXES.items():
        h.state = CF.CuckooState(base.table.clone(), base.count.clone())
        n_q, n_i = (round(f * MIXED_BATCH) for f in fractions[:2])
        n_d = MIXED_BATCH - n_q - n_i
        perm = torch.randperm(pool.shape[0], generator=gen, device="cuda")
        # One more batch of deletes for the profiled batch after the timed.
        n_del = (MIXED_BATCHES + 1) * n_d
        del_pool, qry_pool = perm[:n_del], perm[n_del:]
        acc = dict.fromkeys(K.LAUNCHES, 0)
        per_batch, ops_s = [], 0.0
        def make_batch(dels):
            """Stored keys to query, fresh keys to insert, ``dels`` (pool
            indices) to delete, in a shuffled order."""
            fresh = random_keys(gen, n_i, top_half=True)
            raw = torch.cat([
                pool[qry_pool[torch.randint(0, qry_pool.shape[0], (n_q,),
                                            generator=gen, device="cuda")]],
                fresh, pool[dels]])
            ops = torch.cat([torch.full((n,), code, dtype=torch.int32,
                                        device="cuda")
                             for n, code in ((n_q, amq.OP_QUERY),
                                             (n_i, amq.OP_INSERT),
                                             (n_d, amq.OP_DELETE))])
            shuffle = torch.randperm(MIXED_BATCH, generator=gen, device="cuda")
            return amq.OpBatch.make(raw[shuffle], ops[shuffle]), fresh

        for b in range(MIXED_BATCHES):
            batch, fresh = make_batch(del_pool[b * n_d:(b + 1) * n_d])
            # Core apply_ops on a copy of the same table (not counted).
            copy = CF.CuckooState(h.state.table.clone(), h.state.count.clone())
            _, ok_core, _ = CF.apply_ops(cfg, copy, batch.keys, batch.ops)
            del copy
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = h.apply_ops(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            for name, count in K.LAUNCHES.items():
                acc[name] += count
            ops_s += dt
            check(torch.equal(rep.ok, ok_core),
                  f"mixed {mix} batch {b}: ok differs from core apply_ops on "
                  f"{int((rep.ok != ok_core).sum())} ops")
            check(bool(rep.ok.all()), f"mixed {mix} batch {b}: "
                  f"{int((~rep.ok).sum())} ops not ok (stored queries and "
                  "deletes, fresh inserts, below the design load)")
            tags = stored_tags(cfg, h.state.table)
            check(h.count() == tags, f"mixed {mix} batch {b}: count "
                                     f"{h.count()} != {tags} stored tags")
            check(bool(h.query(fresh).hits.all()),
                  f"mixed {mix} batch {b}: an inserted key is not found")
            per_batch.append({"s": dt, "ops_per_s": MIXED_BATCH / dt,
                              "load": h.load_factor,
                              "rounds": int(rep.rounds)})
        expect = ["hash64"] + (["cuckoo_mixed"] if n_d else []) + (
            ["cuckoo_insert_direct"] if n_i <= max(8, MIXED_BATCH // 8) else [])
        for name in expect:
            check(acc[name] > 0, f"mixed {mix}: kernel {name} was not "
                                 "launched on its path")
        out[mix] = acc
        # One more batch under the profiler (not in ops/s): where it goes.
        batch, _ = make_batch(del_pool[MIXED_BATCHES * n_d:])
        rep, prof = profiled(lambda: h.apply_ops(batch))
        check(bool(rep.ok.all()), f"mixed {mix}: profiled batch not all ok")
        emit({"phase": f"mixed_{mix}", "slots": cfg.num_slots,
              "prefill_load": float(base.count) / cfg.num_slots,
              "fractions": fractions, "ops_per_batch": MIXED_BATCH,
              "batches": per_batch, "ops_per_s": MIXED_BATCHES * MIXED_BATCH / ops_s,
              "launches": acc, "kernels_routed": expect,
              "checks": "ok == core apply_ops on a copy; all ok; count == "
                        "stored tags; every inserted key found",
              "profiled_batch": prof})

    # --- handle.delete and core delete of 2^24 stored keys.
    keys = normalize_keys(pool[perm[:MIXED_BATCH]])
    tables, dels = {}, {}
    for route in ("handle", "core"):
        state = CF.CuckooState(base.table.clone(), base.count.clone())
        K.reset_launches()
        if route == "handle":
            h.state = state
            rep, dt = timed(lambda: h.delete(keys))
            ok, state = rep.ok, h.state
        else:
            (state, ok), dt = timed(lambda: CF.delete(cfg, state, keys))
        launches = dict(K.LAUNCHES)
        check(bool(ok.all()), f"{route} delete: {int((~ok).sum())} failed")
        check(int(state.count) == int(base.count) - MIXED_BATCH,
              f"{route} delete: count {int(state.count)}")
        tables[route] = table_codes(cfg, state.table)
        dels[route] = {"s": dt, "keys_per_s": MIXED_BATCH / dt,
                       "launches": launches}
    check(launches["hash64"] > 0, "core delete: the hash kernel was not "
                                  "launched")
    check(dels["handle"]["launches"]["cuckoo_mixed"] > 0,
          "handle delete: the mixed-op kernel was not launched")
    check_codes("delete: handle against core", tables["handle"],
                tables["core"])
    emit({"phase": "mixed_delete", "keys": MIXED_BATCH, **dels,
          "checks": "all ok; count exact; handle and core tables hold the "
                    "same (pair, tag) codes",
          "seconds": time.perf_counter() - t_start})
    del h, base, pool, tables
    torch.cuda.empty_cache()
    return out


# Kernel #11 against its plain version (float32 output): 1e-4 for float32
# inputs (tests/test_flash_kernel.py's). For bf16 inputs the tensor cores
# take P rounded to bf16, about 2^-9 of each weight; on an H100 this
# phase reads 1.5e-4 to 4.2e-3 in the two measures below, so 1e-2 leaves
# room on both sides.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def flash_errors(got, want) -> tuple:
    """(max |got - want|, max |got - want| over its row's max |want|):
    the second sees a row whose values are small, as long rows' are."""
    d = (got.float() - want).abs()
    row = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(d.max()), float((d / row).max())


def flash_cases(gen):
    """The five shapes of tests/test_flash_kernel.py in the kernel layout
    (GQA g = 3 with Dv != D, a window of 64, non-causal, the ragged 100 x
    130, bf16): (label, q, k, v, causal, window, q_offset)."""
    cases = []
    for (B, KVH, g, Sq, Sk, D, Dv, causal, window, dtype) in FLASH_SHAPES:
        def rnd(*shape):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * 0.3).to(dtype)
        cases.append((f"{B}x{KVH}x{g} {Sq}x{Sk} D{D}/{Dv} causal={causal} "
                      f"window={window} {str(dtype)[6:]}",
                      rnd(B * KVH, g, Sq, D), rnd(B * KVH, Sk, D),
                      rnd(B * KVH, Sk, Dv), causal, window, 0))
    return cases


def flash_check(label, q, k, v, causal, window, q_offset) -> dict:
    """Kernel #11 against its plain version on one input (see
    ``FLASH_TOL``), and its bf16 output against its float32 output
    rounded (equal)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = K.flash_attention(q, k, v, **kw)
    got_bf16 = K.flash_attention(q, k, v, out_dtype=torch.bfloat16, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"flash {label}: not finite")
    check(torch.equal(got_bf16, got.to(torch.bfloat16)),
          f"flash {label}: the bf16 output is not the float32 one rounded")
    err, row_err = flash_errors(got, want)
    tol = FLASH_TOL[q.dtype]
    if q.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=tol, atol=tol)
    else:
        ok = err <= tol and row_err <= tol
    check(ok, f"flash {label}: differs from its plain version (max abs err "
              f"{err}, over the row's max {row_err}, tolerance {tol})")
    return {"max_abs_err": err, "row_rel_err": row_err,
            "max_abs_want": float(want.abs().max()), "tolerance": tol}


def flash_record(q, k, v, causal, bf16_rate, sdpa_layout):
    """Kernel #11 at one shape: its time with the output in q's dtype
    (what the model path asks for, and what the Pallas kernel writes) and
    with a float32 output, through the wrapper, its plain version's,
    ``F.scaled_dot_product_attention``'s on the same values
    (``sdpa_layout``: q, k, v as [B, H, S, D]) and the bound: bytes
    (inputs read once, the output in q's dtype written once) over the HBM
    rate, FLOP (4 a query-key pair a head dimension, unmasked pairs only)
    over the dense bf16 rate."""
    import torch.nn.functional as F

    out = torch.empty(q.shape[:3] + (v.shape[-1],), dtype=q.dtype,
                      device="cuda")
    out32 = torch.empty(out.shape, dtype=torch.float32, device="cuda")
    variant = K.check_flash_kernel(q, k, v)
    scale = 1.0 / q.shape[-1] ** 0.5
    ms, ms_out_float32 = (cuda_ms(lambda: flash_attention_launch(
        q, k, v, o, causal=causal, window=None, scale=scale, q_offset=0,
        variant=variant), reps=10) for o in (out, out32))
    del out32
    wrapper_ms = cuda_ms(lambda: K.flash_attention(
        q, k, v, causal=causal, out_dtype=q.dtype), reps=10)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                       reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *sdpa_layout, is_causal=causal), reps=10)
    nbytes = roofline.attention_bytes(q, k, v, out)
    flops = roofline.attention_flops(q.shape[0] * q.shape[1], q.shape[2],
                                     k.shape[1], q.shape[3], v.shape[-1],
                                     causal=causal)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / bf16_rate * 1e3
    return {"shape": [list(q.shape), list(k.shape), list(v.shape)],
            "dtype": str(q.dtype), "out_dtype": str(out.dtype),
            "causal": causal, "variant": variant, "ms": ms,
            "ms_out_float32": ms_out_float32,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_flops": flops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "tflops_per_s": flops / (ms * 1e-3) / 1e12}


def flash_attention_vs_plain(gen, layer0, bf16_rate):
    """Phase 8b (see the module docstring). Returns the kernel's record
    for the ``kernels`` line (without its launches)."""
    t0 = time.perf_counter()
    errs = {}
    cases = [("serving layer 0 (captured)", *layer0, True, None, 0)]
    cases += flash_cases(gen)
    for label, *args in cases:
        errs[label] = flash_check(label, *args)
    q, k, v = layer0
    B, H = SERVE_BATCH, q.shape[0] * q.shape[1] // SERVE_BATCH
    serving = flash_record(q, k, v, True, bf16_rate,
                           [t.reshape(B, H, -1, t.shape[-1]) for t in layer0])
    # The model path's call: [B, S, H, D] in, transposes included.
    qm, km, vm = (t.reshape(B, H, -1, t.shape[-1]).transpose(1, 2).contiguous()
                  for t in layer0)
    serving["model_path_ms"] = cuda_ms(
        lambda: attention.flash_attention(qm, km, vm, causal=True,
                                          out_dtype=torch.bfloat16), reps=10)
    del qm, km, vm
    # The long prefill at unit scale: its first 512 rows over their keys,
    # and its last 256 rows over all 8192 keys (a long row's values are
    # small; the row measure still sees a dropped key).
    S = LONG_PREFILL
    lq, lk, lv = (torch.randn((H, 1, S, 128) if i == 0 else (H, S, 128),
                              generator=gen, device="cuda")
                  .to(torch.bfloat16) for i in range(3))
    errs["long prefill, first 512 rows"] = flash_check(
        "long prefill, first 512 rows", lq[:, :, :512].contiguous(),
        lk[:, :512].contiguous(), lv[:, :512].contiguous(), True, None, 0)
    errs["long prefill, last 256 rows"] = flash_check(
        "long prefill, last 256 rows", lq[:, :, S - 256:].contiguous(), lk,
        lv, True, None, S - 256)
    long = flash_record(lq, lk, lv, True, bf16_rate,
                        [lq.reshape(1, H, S, 128), lk.reshape(1, H, S, 128),
                         lv.reshape(1, H, S, 128)])
    del lq, lk, lv
    torch.cuda.empty_cache()
    emit({"phase": "flash_attention_vs_plain", "errors": errs,
          "tolerance": "float32 output vs plain: 1e-4 for float32 inputs "
                       "(tests/test_flash_kernel.py); 1e-2 absolute and "
                       "over the row's max for bf16 inputs; bf16 output "
                       "equal to the float32 output rounded",
          "serving_prefill": serving, "long_prefill": long,
          "bf16_flops_per_s": bf16_rate,
          "seconds": time.perf_counter() - t0})
    return {**{k: serving[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by", "wrapper_ms",
                                       "model_path_ms", "variant")},
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "n": serving["shape"],
            "bound_bytes": serving["bound_bytes"],
            "bound_flops": serving["bound_flops"], "long_prefill": long}


def timed_sync(fn):
    """(result, host seconds) of ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_qwen(gen, bf16_rate):
    """Phase 8 (see the module docstring). Returns (launch counts of the
    engine run, layer 0's kernel-layout q/k/v from a full-width
    prefill)."""
    t_start = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, build_s = timed_sync(lambda: build_model(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED)))
    params = sum(p.numel() for p in model.parameters())
    params_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    check(len(model.layers) == cfg.num_layers == 40, "qwen: 40 layers")
    check(params == cfg.param_count() + cfg.num_layers * (
        (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim_()
        + 2 * cfg.d_model) + cfg.d_model,
          "qwen: parameter count (param_count + qkv biases + norm scales)")
    max_len = SERVE_PROMPT + SERVE_STEPS
    entry_bytes = (cfg.num_layers * 2 * SERVE_BATCH * max_len
                   * cfg.num_kv_heads * cfg.head_dim_() * 2)
    pool = torch.randint(0, cfg.vocab_size,
                         (SERVE_POOLS, SERVE_BATCH, SERVE_PROMPT),
                         generator=gen, device="cuda").cpu().numpy()
    pool = pool.astype(np.int32)
    engine = ServeEngine(model, batch=SERVE_BATCH, max_len=max_len,
                         prefix_cache_entries=SERVE_ENTRIES)

    # --- the main path: the request sequence through the engine ----------
    K.reset_launches()
    first, requests = {}, []
    for i in SERVE_SEQUENCE:
        hits = engine.prefix_cache.stats["hits"]
        (tokens, stats), sec = timed_sync(
            lambda: engine.generate(pool[i], steps=SERVE_STEPS))
        check(tokens.shape == (SERVE_BATCH, SERVE_STEPS + 1)
              and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
              f"serve: request {i} tokens malformed")
        check(np.array_equal(first.setdefault(i, tokens), tokens),
              f"serve: prompt {i} served again gave other tokens")
        requests.append({"pool": i, "seconds": sec,
                         "hit": stats["hits"] > hits})
    launches = dict(K.LAUNCHES)
    for logits, _ in engine.prefix_cache.entries.values():
        check(bool(torch.isfinite(logits).all()), "serve: cached logits")
    stats = dict(stats)
    slo = stats.pop("filter_service")
    check(stats["hits"] == 2 and stats["evictions"] == 4
          and stats["filtered"] + stats["misses"] == 8 and stats["stale"] == 0,
          f"serve: prefix-cache stats {stats}")
    prefills = len(SERVE_SEQUENCE) - stats["hits"]
    check(launches["flash_attention"] == cfg.num_layers * prefills,
          f"serve: flash kernel launched {launches['flash_attention']} "
          f"times, not {cfg.num_layers} x {prefills}")
    check_launches("serve", ("hash64", "cuckoo_insert_direct",
                             "cuckoo_mixed", "flash_attention"))
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    check(held <= params_bytes + SERVE_ENTRIES * entry_bytes + (1 << 29),
          f"serve: {held} bytes held after the run: evicted entries were "
          f"not freed (params {params_bytes}, entry {entry_bytes})")
    check(peak <= params_bytes + (SERVE_ENTRIES + 3) * entry_bytes + (1 << 31),
          f"serve: peak {peak} bytes")

    # --- timings of the model alone, and every logit finite ---------------
    tokens = torch.as_tensor(pool[0], device="cuda")
    prefill_s = []
    for _ in range(3):
        (logits, caches), sec = timed_sync(lambda: model.prefill(tokens))
        prefill_s.append(sec)
    check(bool(torch.isfinite(logits).all()), "serve: prefill logits")
    caches = engine._grow_caches(caches, SERVE_PROMPT)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    decode_s = []
    for t in range(SERVE_STEPS):
        (logits, caches), sec = timed_sync(
            lambda: model.decode_step(tok, caches, SERVE_PROMPT + t))
        check(bool(torch.isfinite(logits).all()), f"serve: decode {t} logits")
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        decode_s.append(sec)
    _, prefill_profile = profiled(lambda: model.prefill(tokens))
    _, decode_profile = profiled(
        lambda: model.decode_step(tok, caches, SERVE_PROMPT + SERVE_STEPS - 1))
    del caches, logits

    # --- the guard filter's lookups alone: wall and host syncs ------------
    pc = PrefixCache(SERVE_ENTRIES, device="cuda")
    lookup_s, syncs = [], []
    for i in SERVE_SEQUENCE:
        flat = pool[i].reshape(-1)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                hit = pc.lookup(flat)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        lookup_s.append(time.perf_counter() - t0)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        if hit is None:
            pc.insert(flat, i)
    check(pc.stats == stats, f"serve: guard-filter replay {pc.stats}")

    # --- layer 0's q/k/v for the kernel phase: the first call of one
    # prefill, through a wrapper around the kernel's entry point ----------
    captured, calls = [], [0]
    kernel = K.flash_attention

    def capture(q, k, v, **kw):
        calls[0] += 1
        if not captured:
            captured.append((q, k, v))
        return kernel(q, k, v, **kw)

    K.flash_attention = capture
    try:
        model.prefill(tokens)
    finally:
        K.flash_attention = kernel
    check(calls[0] == cfg.num_layers, "serve: capture prefill")
    layer0 = captured[0]
    del engine, model, pc
    torch.cuda.empty_cache()
    decode_med = statistics.median(decode_s)
    prefill_med = statistics.median(prefill_s)
    emit({"phase": "serve_qwen1_5_4b", "arch": SERVE_ARCH,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "params": params, "param_bytes": params_bytes,
          "build_seconds": build_s, "batch": SERVE_BATCH,
          "prompt_len": SERVE_PROMPT, "steps": SERVE_STEPS,
          "prefix_cache_entries": SERVE_ENTRIES,
          "sequence": SERVE_SEQUENCE, "stats": stats,
          "requests": requests, "launches": launches,
          "prefill_seconds": prefill_med,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_med,
          "decode_ms_per_step": decode_med * 1e3,
          "decode_tokens_per_s": SERVE_BATCH / decode_med,
          "prefill_seconds_all": prefill_s, "decode_ms_all":
              [x * 1e3 for x in decode_s],
          "filter_slo": slo, "guard_lookup_seconds": lookup_s,
          "guard_lookup_host_syncs": syncs,
          "cache_entry_bytes": entry_bytes,
          "max_memory_allocated": peak, "memory_held_after": held,
          "bf16_flops_per_s": bf16_rate,
          "profile_prefill": prefill_profile,
          "profile_decode_step": decode_profile,
          "seconds": time.perf_counter() - t_start})
    return launches, layer0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = roofline.int32_ops_per_s(sm_count, sm_clock_hz)
    bf16_rate = roofline.bf16_flops_per_s(sm_count, sm_clock_hz)
    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs), "gpu": smi, "sm_count": sm_count,
          "sm_clock_max_hz": sm_clock_hz, "int32_ops_per_s": int_ops_per_s,
          "bf16_flops_per_s": bf16_rate,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    for name in build.SOURCES:
        build.load(name)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    emit({"phase": "warm_up", "seconds": warm_up(gen)})

    # --- the main path at full size -------------------------------------
    t0 = time.perf_counter()
    h, snaps, batches, launches = main_path(FULL_CAPACITY, gen, "2^28")
    half, high = snaps["half"], snaps["high"]
    cfg = h.config
    first, second = (normalize_keys(k) for k in batches[:2])
    main_s = time.perf_counter() - t0

    # --- kernels against their plain versions -----------------------------
    t0 = time.perf_counter()
    n = 1 << 24
    errs = {}
    for kind in ("fmix32", "xxhash64"):
        got, want = K.hash64(second, cfg.seed, kind), hash64_plain(second, cfg.seed, kind)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"hash64 ({kind}) differs from its plain version")
    errs["hash64"] = 0

    fresh = normalize_keys(random_keys(gen, PROBES // 2, top_half=True))
    probe = torch.cat([second[:PROBES // 2], fresh])
    for kind in ("fmix32", "xxhash64"):
        c = dataclasses.replace(cfg, hash_kind=kind)
        got = K.cuckoo_query(c, h.state, probe)
        want = cuckoo_query_plain(c, h.state.table, probe)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"cuckoo_query ({kind}) differs on {int((got != want).sum())} keys")
    errs["cuckoo_query"] = 0

    ins_keys = normalize_keys(random_keys(gen, n))
    turned_down = {}
    for name in ("cuckoo_insert_direct", "cuckoo_insert_bulk"):
        kernel = getattr(K, name)
        for where, base in (("load_0.5", half), ("before_last_batch", high)):
            turned_down[f"{name} {where}"] = check_direct_insert(
                cfg, h.state, base, ins_keys, f"{name} {where}", kernel)
    sub = ins_keys[:SUB]
    valid = torch.rand(SUB, device="cuda", generator=gen) < 0.9
    errs["cuckoo_insert_direct"] = same_outcome(
        cfg, half, sub,
        lambda t: K.cuckoo_insert_direct(cfg, h.state._replace(table=t), sub,
                                          valid)[1],
        lambda t: cuckoo_insert_direct_plain(cfg, t, sub, valid))
    errs["cuckoo_insert_bulk"] = same_outcome(
        cfg, half, sub,
        lambda t: K.cuckoo_insert_bulk(cfg, h.state._replace(table=t), sub,
                                        valid)[1],
        lambda t: cuckoo_insert_bulk_plain(cfg, t, sub, valid))

    check_delete(cfg, h.state, h.state.table, second, "cuckoo_mixed delete")
    universe = torch.cat([first[:SUB // 8], sub[:SUB // 8]])
    picks = torch.randint(0, universe.shape[0], (SUB,), device="cuda",
                          generator=gen)
    mixed_ops = torch.randint(0, 3, (SUB,), device="cuda", generator=gen,
                              dtype=torch.int32)
    deletes = torch.full((SUB,), amq.OP_DELETE, dtype=torch.int32, device="cuda")
    dup = first[torch.randint(0, SUB // 4, (SUB,), device="cuda", generator=gen)]
    errs["cuckoo_mixed"] = 0
    for keys, ops in ((universe[picks], mixed_ops), (dup, deletes)):
        errs["cuckoo_mixed"] = max(errs["cuckoo_mixed"], same_outcome(
            cfg, half, keys,
            lambda t, k=keys, o=ops: K.cuckoo_apply_ops(
                cfg, h.state._replace(table=t), k, o)[1],
            lambda t, k=keys, o=ops: cuckoo_mixed_plain(cfg, t, k, o)))
    emit({"phase": "kernels_vs_plain", "max_abs_err": errs,
          "direct_insert_turned_down": turned_down,
          "seconds": time.perf_counter() - t0,
          "tolerance": "exact (0). hash, query: bit-exact at 2^24 keys. "
                       "direct and bulk insert, delete at 2^24 keys: the "
                       "order-free outcome of the plain loop (stored "
                       "codes, lanes, ok); at 2^12 keys: equal ok and "
                       "equal tag multisets per touched bucket"})

    # --- the fused-vs-unfused comparison ----------------------------------
    (unfused_launches, unfused_errs, unfused_records,
     unfused_wrapper) = unfused_comparison(h, snaps, second, ins_keys, gen)
    errs.update(unfused_errs)

    # --- timings at the main path's shapes ---------------------------------
    keys = second
    full_table = h.state.table.clone()
    work = torch.empty_like(full_table)
    timing = {}

    def restore(src):
        return lambda: work.copy_(src)

    # timing[name] = (ms, plain_ms, n, plain_n, roofline op, touched
    # buckets (read, written) of the timed batch, None for no table).
    timing["hash64"] = (
        cuda_ms(lambda: K.hash64(keys, cfg.seed, cfg.hash_kind)),
        cuda_ms(lambda: hash64_plain(keys, cfg.seed, cfg.hash_kind)),
        n, n, "hash", None)
    timing["cuckoo_query"] = (
        cuda_ms(lambda: K.cuckoo_query(cfg, h.state, keys)),
        cuda_ms(lambda: cuckoo_query_plain(cfg, h.state.table, keys), reps=3),
        n, n, "query", touched_buckets(cfg, h.state.table, keys))
    ins_valid = torch.ones(n, dtype=torch.bool, device="cuda")
    ins_ok = torch.empty(n, dtype=torch.bool, device="cuda")
    sub_valid = torch.ones(SUB, dtype=torch.bool, device="cuda")
    # Each kernel's touched buckets are read from ``work`` as its last
    # timed run left it, before the plain version overwrites it.
    ms = cuda_ms(lambda: cuckoo_insert_launch(cfg, work, ins_keys, ins_valid,
                                              ins_ok),
                 reps=3, setup=restore(half))
    touched = touched_buckets(cfg, half, ins_keys, work, insert=True)
    timing["cuckoo_insert_direct"] = (
        ms, cuda_ms(lambda: cuckoo_insert_direct_plain(cfg, work, sub,
                                                       sub_valid),
                    reps=3, setup=restore(half)),
        n, SUB, "insert", touched)
    _, i1, _ = CF.prepare_keys(cfg, ins_keys)
    bulk_order, bulk_seg = sorted_runs(i1)
    # Wrapper times include the sort that precedes the launch.
    wrapper_ms = {"cuckoo_insert_bulk": cuda_ms(
        lambda: K.cuckoo_insert_bulk(cfg, h.state._replace(table=work),
                                     ins_keys, ins_valid),
        reps=3, setup=restore(half))}
    ms = cuda_ms(lambda: cuckoo_insert_bulk_launch(cfg, work, ins_keys,
                                                   ins_valid, bulk_order,
                                                   bulk_seg, ins_ok),
                 reps=3, setup=restore(half))
    touched = touched_buckets(cfg, half, ins_keys, work, insert=True)
    timing["cuckoo_insert_bulk"] = (
        ms, cuda_ms(lambda: cuckoo_insert_bulk_plain(cfg, work, sub,
                                                     sub_valid),
                    reps=3, setup=restore(half)),
        n, SUB, "bulk_insert", touched)
    del_ops = torch.full((n,), amq.OP_DELETE, dtype=torch.int32, device="cuda")
    order, seg_start = segments(keys)
    del_ok = torch.empty(n, dtype=torch.bool, device="cuda")
    wrapper_ms["cuckoo_mixed"] = cuda_ms(
        lambda: K.cuckoo_apply_ops(cfg, h.state._replace(table=work), keys,
                                   del_ops, ins_valid),
        reps=3, setup=restore(full_table))
    ms = cuda_ms(lambda: cuckoo_mixed_launch(cfg, work, keys, del_ops,
                                             ins_valid, order, seg_start,
                                             del_ok),
                 reps=3, setup=restore(full_table))
    touched = touched_buckets(cfg, full_table, keys, work)
    timing["cuckoo_mixed"] = (
        ms, cuda_ms(lambda: cuckoo_mixed_plain(cfg, work, dup, deletes),
                    reps=3, setup=restore(full_table)),
        n, SUB, "delete", touched)
    timing.update(unfused_records)

    # Kernel #6 against kernel #4 where segments are long: 2^27 keys into
    # the empty table, eight keys a primary bucket on average (load 0.5).
    # Both held to the order-free outcome first; times are kernel only,
    # plus #6's wrapper (hash and sort).
    t1 = time.perf_counter()
    long_n = 1 << 27
    long_keys = normalize_keys(random_keys(gen, long_n))
    empty = torch.zeros_like(work)
    long_turned_down = {
        name: check_direct_insert(cfg, h.state, empty, long_keys,
                                  f"{name} long segments", getattr(K, name))
        for name in ("cuckoo_insert_direct", "cuckoo_insert_bulk")}
    long_valid = torch.ones(long_n, dtype=torch.bool, device="cuda")
    long_ok = torch.empty(long_n, dtype=torch.bool, device="cuda")
    _, long_i1, _ = CF.prepare_keys(cfg, long_keys)
    long_order, long_seg = sorted_runs(long_i1)
    long_ms = {
        "cuckoo_insert_direct": cuda_ms(
            lambda: cuckoo_insert_launch(cfg, work, long_keys, long_valid,
                                         long_ok),
            reps=3, setup=restore(empty)),
        "cuckoo_insert_bulk": cuda_ms(
            lambda: cuckoo_insert_bulk_launch(cfg, work, long_keys,
                                              long_valid, long_order,
                                              long_seg, long_ok),
            reps=3, setup=restore(empty)),
        "cuckoo_insert_bulk_wrapper": cuda_ms(
            lambda: K.cuckoo_insert_bulk(cfg, h.state._replace(table=work),
                                         long_keys, long_valid),
            reps=3, setup=restore(empty))}
    long_touched = touched_buckets(cfg, empty, long_keys, work, insert=True)
    long_bytes = roofline.least_batch_bytes(cfg, "bulk_insert", long_n,
                                            long_touched)
    emit({"phase": "long_segments", "keys": long_n,
          "buckets": cfg.num_buckets, "segments": long_seg.numel(),
          "keys_per_segment": long_n / long_seg.numel(),
          "turned_down": long_turned_down, "ms": long_ms,
          "touched_buckets": long_touched, "bound_bytes": long_bytes,
          "bytes_bound_ms": long_bytes / HBM_BYTES_PER_S * 1e3,
          "seconds": time.perf_counter() - t1})
    del long_keys, empty, long_valid, long_ok, long_i1, long_order, long_seg
    torch.cuda.empty_cache()

    copy_src = torch.empty(1 << 28, dtype=torch.int32, device="cuda")
    copy_dst = torch.empty_like(copy_src)
    copy_ms = cuda_ms(lambda: copy_dst.copy_(copy_src))
    copy_bytes_per_s = 2 * copy_src.numel() * 4 / (copy_ms * 1e-3)
    emit({"phase": "timings", "copy_bytes_per_s": copy_bytes_per_s,
          "table_load": h.load_factor, "main_path_2^28_seconds": main_s})
    del work, full_table, half, high, snaps, copy_src, copy_dst, h
    torch.cuda.empty_cache()

    # --- the bulk build at full size ---------------------------------------
    t0 = time.perf_counter()
    fill_launches = fills_2_28(gen, batches)
    emit({"phase": "fills_2^28_seconds", "seconds": time.perf_counter() - t0})
    emit({"phase": "profile_orientation_batch",
          **profile_orientation(gen, batches)})
    del batches
    torch.cuda.empty_cache()

    # --- the k-mer case study -------------------------------------------
    t0 = time.perf_counter()
    kmer_timing, kmer_wrapper, kmer_launches, kmer_errs = kmer_case_study(gen)
    emit({"phase": "kmer_case_study_seconds",
          "seconds": time.perf_counter() - t0})

    # --- the mixed path ---------------------------------------------------
    t0 = time.perf_counter()
    mixed_path(gen)
    emit({"phase": "mixed_path_seconds", "seconds": time.perf_counter() - t0})

    # --- the serving path, then kernel #11 against its plain version -------
    serve_launches, layer0 = serve_qwen(gen, bf16_rate)
    flash = flash_attention_vs_plain(gen, layer0, bf16_rate)
    del layer0
    torch.cuda.empty_cache()

    # Each kernel's launches come from the path that routes to it: the main
    # path, the legacy bulk fill (the bulk kernel), the fused-vs-unfused
    # comparison (the unfused kernels) or the k-mer case study.
    path_launches = {name: ("main_path_2^28", launches[name])
                     for name in launches}
    for name in unfused_records:
        path_launches[name] = ("unfused_comparison", unfused_launches[name])
    path_launches["cuckoo_insert_bulk"] = (
        "bulk_build_legacy",
        fill_launches["bulk_build_legacy"]["cuckoo_insert_bulk"])
    for name in kmer_timing:
        path_launches[name] = ("kmer_case_study", kmer_launches[name])
    wrapper_ms.update(kmer_wrapper)
    wrapper_ms.update(unfused_wrapper)
    errs.update(kmer_errs)
    # Every record: (ms, plain ms, n, plain n, bound bytes, bound int32
    # instructions, touched buckets or blocks).
    records = {}
    for name, (ms, plain_ms, kn, plain_n, op, touched) in timing.items():
        records[name] = (ms, plain_ms, kn, plain_n,
                         roofline.least_batch_bytes(cfg, op, kn, touched),
                         roofline.int_ops_per_key(cfg, op) * kn, touched)
    records.update(kmer_timing)
    kernels = []
    for name, (ms, plain_ms, kn, plain_n, nbytes, nops, touched) in records.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / int_ops_per_s * 1e3
        path, count = path_launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": count,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "n": kn, "plain_n": plain_n,
            "launches_path": path,
            "bound_bytes": nbytes, "bound_int32_ops": nops,
            "touched": touched,
            "ops_ms": ops_ms,
            "bytes_ms_at_measured_copy": nbytes / copy_bytes_per_s * 1e3})
        if name in wrapper_ms:
            kernels[-1]["wrapper_ms"] = wrapper_ms[name]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": SOURCES["flash_attention"],
                    "replaces": TPU_KERNELS["flash_attention"],
                    "launches": serve_launches["flash_attention"],
                    "launches_path": "serve_qwen1_5_4b", **flash})

    # --- the main path at 2^22 slots --------------------------------------
    t0 = time.perf_counter()
    main_path(L2_CAPACITY, gen, "2^22")
    emit({"phase": "main_path_2^22_seconds",
          "seconds": time.perf_counter() - t0})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
