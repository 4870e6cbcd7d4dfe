#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

From the repository root, on a machine with one NVIDIA H100 and the CUDA
toolkit. Phases, one JSON line each:

1. build — the twelve CUDA sources from ``src/repro_torch/kernels/csrc``
   (``nvcc``, ``sm_90a``, in parallel), with the build seconds and the
   card's name and power limit; then the registers and spills that
   ``ptxas -v`` gives the flash-attention kernels (``flash_ptxas``) and
   the Bloom insert kernels (``bloom_insert_ptxas``, with each one's
   instructions, shuffles and reductions in its SASS), and the
   direct-insert, query (fused and unfused), unfused direct-insert, Bloom
   query and mixed-op kernels (``cuckoo_insert_ptxas``,
   ``cuckoo_query_ptxas``, ``cuckoo_query_unfused_ptxas``,
   ``cuckoo_insert_unfused_ptxas``, ``bloom_query_ptxas``,
   ``cuckoo_mixed_ptxas``, with the threads an SM holds at each one's
   registers), both instantiations of the k-mer pack
   (``kmer_pack_ptxas``), the bulk insert's route
   (``cuckoo_insert_bulk_ptxas``) and the GQF's serial kernels
   (``gqf_serial_ptxas``): no spill allowed. Where ``cuobjdump``
   is there, both query kernels' SASS must hold bucket i2's loads behind
   the branch on bucket i1's match.
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
   slots may differ by CAS order), as are a 2^12 mixed stream, a delete
   stream with duplicates and one with every key twice.
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
   Both timed beside the fused kernels at both loads. Each unfused kernel
   is its fused sibling's design with the lane-by-lane scan (bucket i2
   read only where i1 does not settle the key), so the pair measures the
   scan. The same comparison on two tables that stay in the L2 follows
   the 2^22 main path (phase 9).
4. timings at the main path's shapes (median of CUDA-event runs) beside
   each kernel's bound, whose bytes count the buckets the timed batch's
   own data touches (see :func:`touched_buckets`); the bulk insert (#6)
   as its route from its first launch to its last (partitioned by table
   window: five launches) and as its wrapper, beside the function's bound
   and the route's own floor, with one wrapper call's host syncs counted
   and one profiled (gates: no host sync, no sort kernel). Then the bulk
   insert against the direct-insert kernels (#4, and #5 beside it) where
   segments are long: 2^27 keys into the empty 2^28-slot table (eight
   keys a primary bucket), each held to the order-free outcome first. The direct-insert kernel
   also at the main path's first batch (2^24 keys into the empty table) and past
   full buckets (2^24 keys into the table at load 0.95), each held to the
   order-free outcome at 2^24 keys and exactly to the plain loop at 2^12,
   then timed beside a bound from its own touched buckets (its row's
   ``shapes``). The fused query kernel also at load 0.5 and right after
   the fill (the row's stored keys) and on 2^24 fresh keys (all negative),
   each equal to its plain version under both hashes and timed beside a
   bound from the buckets it needs and the share of keys that bucket i1
   settles (its row's ``shapes``, with the case study's query); the
   unfused query (#3) at the same shapes and at its row's, each beside
   #2's time there (``cuckoo_query_unfused_shapes``, #3's ``shapes``). The
   mixed-op route (#7) at four shapes (``cuckoo_mixed_route``, its row's
   ``shapes``): the main path's delete, 2^23 stored keys each deleted
   twice, a 2^24-op YCSB 50/40/10 stream on the table at load 0.5 whose
   universe leaves 1/8 of its ops repeated, and the 2^12 stream; each
   through one gated call (tags added equal inserts less deletes ``ok``;
   for the delete-only shape with repeats, each (pair, tag) code deleted
   min(copies, deletes) times and the cleared lanes exactly the removed
   keys' codes; every repeated key
   marked, the false repeats counted; at most one host sync; the walk
   launched only where some key repeats; the call's peak of allocated
   memory), then the route's time from its first launch to its last and
   the wrapper's, beside the function's bound and the route's own floor;
   at the main path's delete each kernel under ``torch.profiler``, with
   no sort among them. A warm-up
   pass at 2^16 slots
   (both engines, and the k-mer and Bloom kernels) runs before anything
   is timed.
4b. the lifecycle (``lifecycle``, DESIGN.md §8, §10, §12) — the main
   path's handle (2^28 slots, 512 MiB) through ``snapshot()``,
   ``save_snapshot`` into a temporary directory (removed after),
   ``load_snapshot`` and ``make(snapshot=...)``, each step timed with its
   GB/s: the twin's table equal word for word, both answering 2^24 stored
   and 2^24 fresh keys alike, an insert into the twin leaving the original
   and the snapshot's arrays as they were, a snapshot under another
   fingerprint refused. That handle under a ``FilterService``, 2^20
   acknowledged inserts, then ``hot_swap`` (migration) to a fresh handle
   of its config: every acknowledged key found there. A cascade,
   ``make("cuckoo", capacity=floor(0.95 * 2^24), auto_expand=True)``,
   filled with 2^27 seeded keys in 8 batches of 2^24 (keys/s and host
   syncs a batch): four levels of 2^24, 2^25 (fp 16), 2^26 and 2^27 slots
   (fp 32, 64-byte buckets), every key placed, ``count`` exact, no level
   past its watermark, each level's table holding exactly its run of keys,
   no false negatives, the FPR of 2^24 fresh keys inside its band; one
   query call of 2^24 stored keys (one launch of the query kernel a
   level, timed, host syncs, each level's kernel time), 2^24 deletes drawn
   from all four levels (all ``ok``, timed, host syncs; only lanes
   cleared, each a deleted key's code, 2^24 in all; the deleted keys then
   hit at the FPR), ``compact()`` after level 0's drain dropping it, a
   snapshot round trip through a file answering as the cascade. A tiered
   handle, ``make("cuckoo", capacity=floor(0.95 * 2^24), tiered=True,
   device_budget_bytes=2^28)``, filled with the same keys: levels clamped
   at 2^26 slots, levels 0–2 demoted (352 MiB in host RAM), each level's
   answers on a 2^20-key probe (half stored, half fresh) recorded just
   before its demotion and equal, bit for bit, to its ``host_query``
   after; 2^22 stored keys from both tiers all found (the hot part and the
   whole query timed apart, ``tier_stats()`` counting the keys probed
   cold); 2^10 deletes of cold keys all ``ok`` and gone; the budget held,
   broken by ``promote(force=True)`` and restored by ``maintain()``; a
   snapshot round trip through a file. A Bloom cascade,
   ``make("bloom", capacity=floor(0.95 * 2^24), auto_expand=True)``, of
   2^26 keys (levels' k from the sizing ladder): no false negatives, the
   FPR inside its band, kernels #8 and #9 launched.
4c. the baselines (``baselines``, the paper's §5.1 dynamic baselines, each
   at its configuration's defaults). First the kernels beyond the TPU's
   against their plain versions: G1 (the GQF's serial insert) and G2 (its
   serial delete) on 2^12 keys into a 2^14-slot table at load 0.9 and at
   0.99, the plain loops on a CPU copy (deterministic): table, ``ok`` and
   ``count`` equal word for word; the TCF's and BCHT's rounds on
   2^16-slot tables, the card's tables equal the CPU's after the same
   insert and delete batches. Then ``make("tcf", capacity=floor(0.95 *
   2^28))`` (2^23 blocks of 32 fp-16 tags: 512 MiB) filled in the main
   path's 16 batches (per batch: seconds, keys/s, rounds, host syncs, peak
   memory, the keys turned down with both blocks and the stash full and
   those out of ``max_rounds``, which must account for every key turned
   down); no false negatives among ``ok``; the FPR of 2^24 fresh keys in
   its band; 2^24 stored keys deleted, ``count`` exact, a failed delete
   only where a deleted key of the same tag and block took its copy (the
   TCF's false delete). ``make("bcht", capacity=floor(0.9 * 2^28))`` (2^24
   buckets of 16: 2^28 slots) in 15 batches: false negatives among ``ok``
   at most the keys turned down (R7), no false positive on 2^24 fresh
   keys, 2^24 deletes of keys that answer True all ``ok`` and gone after.
   ``make("gqf", capacity=floor(0.95 * 2^24))`` (2^24 slots, 64 MiB)
   through G1 in batches of 2^20, per batch seconds and keys/s (the 2^24
   slots are fixed: no batch time switches the table): false negatives among
   ``ok`` at most the keys turned down plus the slots at distance >=
   ``max_probe`` (R5); the FPR of 2^24 fresh keys in its band; 2^20
   deletes through G2 of keys that answer True, all ``ok``, ``count``
   exact. Launch counts zeroed just before the TCF's and the GQF's runs
   and read just after (the hash kernel; G1 and G2). G1 and G2 each timed
   alone through its wrapper at its batch (the fill's last full batch, the
   delete) beside a bound from the slots its probe runs touch; CPU copies
   of those launches are held to the plain loops in phase 10. Beside the
   BCHT and the GQF
   a ``cuckoo`` handle of the same capacity, filled, probed and deleted
   the same way (the TCF's is phase 2's); the cuckoo-over-baseline ratios
   of insert, query and delete keys/s.
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
   the card: its canonical 31-mers by ``kmer_keys`` (one launch of the
   k-mer pack kernel's canonical instantiation; its seconds, keys/s and
   peak of allocated device memory, later three more calls' seconds and
   three under ``torch.profiler``; the plain keys of a 2^20-base prefix
   checked against Python integers); the distinct
   k-mers into ``make("cuckoo", capacity=n_distinct)`` in a seeded
   permutation, batches of 2^24 (the main path's gates, a query of every
   position, the FPR of a foreign genome's k-mers, the delete of a
   2^20-base region's k-mers: all ``ok``, ``count`` exact, their hits at
   most the FPR band's edge); the same keys into ``make("bloom",
   capacity=n_distinct)`` (every position found, FPR inside its band).
   The k-mer pack, Bloom insert and Bloom query kernels are then held
   exactly against their plain versions on the same inputs and timed: the
   k-mer pack forward and canonical, on the genome, the foreign genome and
   the deleted region's slice (its first code not 16-byte aligned), each
   instantiation timed at the genome's shape beside its bound (its row's
   ``shapes``);
   the Bloom insert at two shapes: the first batch into the empty table
   and the last batch into the table that holds all the others (the
   kernel's result there equal to the case study's table), each beside a
   bound from its own batch's blocks. The Bloom query at four shapes, by
   the route its rule gives each and by the other one where the table
   spans two windows or more, both bit for bit against the plain version:
   every position (the windowed route), the FPR probe's foreign k-mers
   and the first batch on the case study's table, the first batch on a
   2^18-block table in L2; at the first, each kernel's device time under
   ``torch.profiler``, the route's own floor and the call's peak of
   allocated device memory. The fused query kernel on every
   position against the table after the fill, as at the main path's
   shapes. Keys/s of each step and the cuckoo/Bloom query ratio.
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
   32 greedy decode steps, a 4-entry prefix cache whose guard filter is an
   auto-expanding ``cuckoo`` cascade behind ``FilterService``, as in the
   JAX package: a gate) on the request sequence of
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
   on layer 0's q/k/v captured from a full-width prefill (as the model
   hands them over, [B, S, H, D]), on ``FLASH_SHAPES`` (the five shapes
   of ``tests/test_flash_kernel.py``, then the bf16 cases of
   ``tests/test_torch_gpu.py``: every wgmma head size, a window with a
   query offset, rows that see no key, g = 8, ragged Sq and Sk) and on
   the head and tail rows of a unit-scale long prefill. Float32 output
   against the plain version: 1e-4 (that file's) for float32 inputs; for
   bf16 inputs (P rounded to bf16 on the tensor cores) 1e-2 in absolute
   error and in error over each row's largest |value|, so that a zeroed
   row or a dropped key fails. The bf16 output equals the float32 output
   rounded, bit for bit, and for bf16 inputs the model-layout entry
   (``kernels.ops.flash_attention_bshd``) on strided [B, S, H, D] views
   of the same values gives the kernel layout's bits. Timed one call
   between two events, as every kernel is, and over calls back to back,
   the timings in rotated order (kernel on the model's layout with the
   bf16 output the model path asks for and with float32, on the kernel
   layout, the kernel-layout wrapper, the model's call,
   ``F.scaled_dot_product_attention`` as the library yardstick; then the
   plain version) at the serving prefill (B 4, S 1024, 20 heads, causal,
   bf16) and a long prefill (B 1, S 8192), each beside its bound. The wgmma kernels'
   registers and spills from ``ptxas -v`` are printed after the build
   (no spill allowed).
9. the main path again at 2^22 slots (an 8 MiB table, resident in L2);
   then phase 3b's comparison on two tables of 2^22 slots that stay in
   the L2 (``unfused_comparison_l2``): that fill's table at load 0.5 (fp
   16 x bucket 16) and an fp 8 x bucket 16 table filled to load 0.5 by
   the direct-insert kernel. On each, 2^22 keys (half stored, half
   fresh) through both query kernels (the unfused hits equal the fused)
   and 2^21 fresh keys through both insert kernels on copies of the
   table (the unfused insert held to the order-free outcome), launch
   counts zeroed just before and read just after; each pair timed beside
   each other.
9b. the mesh-sharded filter (``sharded``) — ``make("sharded-cuckoo",
   capacity=8 * floor(0.95 * 2^25), num_shards=4, partitions_per_shard=2)``
   on the card (see ``SHARDED_CAPACITY``): fp 16, bucket 16, XOR, fmix32;
   8 partitions of 2^25 slots
   (64 MiB each, past the L2), 2^28 slots and 512 MiB in all, the four
   shards on the one card (the exchange a transpose). Filled to load 0.95
   in the main path's 16 batches (12 incremental, 4 ``bulk=True``), each
   padded to a multiple of 4 under a valid mask, unrouted keys retried
   until none is left. Gates: every key placed; each partition's
   ``count`` equal to the keys its hash gives it; no false negatives; the
   FPR of 2^24 fresh keys inside the Eq. 4 band; 2^24 deletes all ``ok``,
   ``count`` exact; one ``ycsb_50_40_10`` batch of 2^24 ops through
   ``FilterHandle.apply_ops`` whose ``ok`` and ``routed`` equal the core
   driver's (``ShardedCuckooFilter.apply_ops``) on a copy of the state.
   Launch counts zeroed just before the fill and read just after the
   mixed batch: the hash, query, direct-insert and mixed-op kernels must
   have launched. Then kernel #2 on partition 0 held answer for answer to
   its plain version on the streams the path gives it from the 2^24 fresh
   and 2^24 stored probes (each shard's local batch binned, ``K*cap``
   slots); partition 0's direct insert held to the order-free
   outcome on 2^22 keys and exactly to the plain loop on 2^12; reshards
   4→2, 4→8 and 4→1, each with equal table words and identical answers
   to 2^24 stored and 2^24 fresh probes (seconds of each); a snapshot
   through a ``.npz`` file restored under a 2-shard config, answering
   alike. Reported: keys/s of each op, the routed share, launches, the
   peak of allocated device memory.
9c. filter-backed dedup (``dedup``) — ``data_iterator``'s batches of
   ``DataConfig(vocab_size=151936, batch=2^14, seq_len=1024,
   duplicate_fraction=0.2)`` (Qwen1.5's vocabulary), 32 of them (2^19
   sequences, made on the host by 8 threads), through
   ``make_deduper(capacity=2^17, service_batch=2^14)`` on ``cuckoo`` and
   on ``sharded-cuckoo`` over 4 shards (auto-expanding cascades behind a
   ``FilterService``), each against a host set of the sequences' 64-bit
   keys: every repeated sequence masked, the fresh sequences masked no
   more often than the cascade's FPR band allows, the ``duplicates``
   stat equal to the masked count, no insert failure after the flush,
   then ``forget`` of 2^14 stored keys (``count`` falls by 2^14). Launch
   counts zeroed just before each stream and read just after (the hash,
   query and direct-insert kernels; the mixed-op kernel in ``forget``);
   after the flush kernel #2 on the active level (partition 0 on
   ``sharded-cuckoo``) held answer for answer to its plain version on the
   last batch's keys. Then one ``dedup_batch`` on a static ``sharded-cuckoo`` filter.
   Reported: sequences/s, levels grown, host syncs a batch.
10. G1 and G2 against their plain loops at the GQF path's own shapes
   (``gqf_serial_vs_plain_at_path_shape``): the timed launches of phase
   4c (2^20 keys into the table before the fill's last batch; the 2^20
   deletes) replayed by the host loops on CPU copies of the same tables
   and keys; table, ``ok`` and ``count`` equal word for word. Last, so
   the loops (tens of seconds each) run after every host-bound phase.

Before the last line: the ``nvidia-smi`` name and power limit, then the
``kernels`` line (the 11 TPU kernels, then G1 and G2). The last line is
``{"ok": true, "device": {...}}``. Any
failed check raises and exits non-zero without it. Nothing here imports
JAX or the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import inspect
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import amq  # noqa: E402
from repro_torch.core import cuckoo_filter as CF  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core.bits64 import from_i32, to_i32  # noqa: E402
from repro_torch.core.hashing import (  # noqa: E402
    hash_key_plain, keys_to_numpy, normalize_keys)
from repro_torch.filters import bcht as HTm  # noqa: E402
from repro_torch.filters import quotient as QFm  # noqa: E402
from repro_torch.filters import two_choice as TCm  # noqa: E402
from repro_torch.core import sharded_filter as SF  # noqa: E402
from repro_torch.data import dedup as DD  # noqa: E402
from repro_torch.data.kmer import (  # noqa: E402
    canonicalize, kmer_keys, synthetic_genome)
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels import bloom as bloom_kernels  # noqa: E402
from repro_torch.kernels import build, roofline  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels.cuckoo_insert import (  # noqa: E402
    cuckoo_insert_direct_plain, cuckoo_insert_launch,
    cuckoo_insert_unfused_launch)
from repro_torch.kernels import cuckoo_insert_bulk as BULK  # noqa: E402
from repro_torch.kernels.cuckoo_insert_bulk import (  # noqa: E402
    cuckoo_insert_bulk_plain)
from repro_torch.kernels import cuckoo_mixed as CM  # noqa: E402
from repro_torch.kernels.cuckoo_mixed import cuckoo_mixed_plain  # noqa: E402
from repro_torch.kernels.cuckoo_query import (  # noqa: E402
    cuckoo_query_plain, cuckoo_query_unfused_launch,
    cuckoo_query_unfused_plain)
from repro_torch.kernels.hash64 import hash64_plain  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    gqf_delete_plain, gqf_insert_plain)
from repro_torch.kernels.bloom import (  # noqa: E402
    bloom_insert_launch, bloom_insert_plain, bloom_query_launch,
    bloom_query_plain)
from repro_torch.kernels.kmer_pack import (  # noqa: E402
    kmer_pack_launch, kmer_pack_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bshd_views, flash_attention_launch, flash_attention_plain,
    to_kernel_layout)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.serve import PrefixCache, ServeEngine  # noqa: E402

SEED = 20260316
FULL_CAPACITY = 255_013_683      # floor(0.95 * 2**28)
L2_CAPACITY = 3_984_588          # floor(0.95 * 2**22)
L2_PROBES = 1 << 22              # the L2 tables' query probe
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
# The lifecycle phase: a cascade and a tiered handle grown from a base of
# floor(0.95 * 2^24) keys (2^24 slots) by 2^27 keys in batches of 2^24, a
# 2^28-byte device budget for the tiered one, a Bloom cascade of 2^26 keys;
# the cold tier's host probes and deletes kept to 2^22 and 2^10 keys.
LIFE_CAPACITY = 15_938_355       # floor(0.95 * 2**24)
LIFE_KEYS = 1 << 27
LIFE_BATCH = 1 << 24
LIFE_BUDGET = 1 << 28
LIFE_COLD_PROBES = 1 << 22
LIFE_COLD_DELETES = 1 << 10
LIFE_RECORD_PROBES = 1 << 20
LIFE_BLOOM_KEYS = 1 << 26
# The baselines phase: the TCF at floor(0.95 * 2^28) keys (2^23 blocks of
# 32 tags, 512 MiB) in the main path's batches; the BCHT at floor(0.9 *
# 2^28) (2^24 buckets of 16 slots, key words 1 GiB each) in 15 batches of
# at most 2^24; the GQF at floor(0.95 * 2^24) (2^24 slots, 64 MiB) through
# G1 in batches of 2^20; G1 and G2 held to their plain loops on 2^14-slot
# tables and at the GQF's own shapes.
BCHT_CAPACITY = 241_591_910      # floor(0.9 * 2**28)
GQF_CAPACITY = LIFE_CAPACITY     # floor(0.95 * 2**24)
GQF_BATCH = 1 << 20
SERIAL_SLOTS = 1 << 14
# The mesh-sharded filter (phase 9b): the main path's size over 4 shards
# of 2 partitions, all on the one card. Each partition is sized for
# ceil(capacity / 8) keys, and ceil(floor(0.95 * 2^28) / 8) is one key past
# 2^21 buckets of 16 at load 0.95 (it would double every partition), so the
# capacity is 8 x floor(0.95 * 2^25): 3 keys fewer than the main path's.
SHARDS = 4
SHARDED_PPS = 2
SHARDED_CAPACITY = 255_013_680
# Filter-backed dedup (phase 9c): Qwen1.5's vocabulary.
DEDUP_DATA = dict(vocab_size=151936, batch=1 << 14, seq_len=1024,
                  duplicate_fraction=0.2)
DEDUP_BATCHES = 32
DEDUP_CAPACITY = 1 << 17
DEDUP_THREADS = 8
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
FLASH_BATCH = 20                 # calls a back-to-back sample of #11
FLASH_ROUNDS = 10                # samples of each of #11's timings
# tests/test_flash_kernel.py's shapes, then the bf16 cases of
# tests/test_torch_gpu.py's FLASH_CASES (every wgmma head size, a window
# with a query offset, rows that see no key, g = 8, ragged Sq and Sk):
# (B, KVH, g, Sq, Sk, D, Dv, causal, window, q_offset, dtype).
FLASH_SHAPES = [
    (2, 2, 3, 192, 256, 64, 32, True, None, 0, torch.float32),
    (2, 2, 3, 192, 256, 64, 32, True, 64, 0, torch.float32),
    (1, 4, 1, 256, 256, 128, 128, False, None, 0, torch.float32),
    (1, 1, 8, 100, 130, 32, 32, True, None, 0, torch.float32),
    (2, 2, 2, 128, 128, 64, 64, True, None, 0, torch.bfloat16),
    (3, 1, 2, 300, 300, 128, 128, True, None, 0, torch.bfloat16),
    (2, 1, 1, 77, 200, 32, 32, False, None, 0, torch.bfloat16),
    (1, 2, 3, 130, 130, 64, 32, True, None, 0, torch.bfloat16),
    (1, 2, 2, 96, 224, 128, 128, True, 50, 128, torch.bfloat16),
    (2, 1, 1, 64, 64, 64, 64, True, 0, 0, torch.bfloat16),
    (1, 1, 8, 100, 130, 32, 32, True, None, 0, torch.bfloat16),
    (1, 2, 3, 333, 517, 64, 64, True, None, 0, torch.bfloat16),
    (2, 2, 2, 1000, 1000, 128, 128, True, 300, 0, torch.bfloat16),
    (1, 2, 2, 200, 389, 128, 128, False, None, 0, torch.bfloat16),
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
# The kernels beyond the TPU's: the compiled device loops they replace.
LOOP_KERNELS = {
    "gqf_insert_serial": "src/repro/filters/quotient.py:97",
    "gqf_delete_serial": "src/repro/filters/quotient.py:165",
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
    "gqf_insert_serial": "src/repro_torch/kernels/csrc/gqf_serial.cu",
    "gqf_delete_serial": "src/repro_torch/kernels/csrc/gqf_serial.cu",
}
# Kernel #10's instantiations in the package under test: forward and, where
# ``ops.kmer_pack`` takes ``canonical`` (the kernel canonicalizes in the same
# pass), canonical. An older package's ``kmer_keys`` packed forward, then ran
# torch's ``canonicalize``; its only instantiation is timed beside this one.
KMER_CANONICAL = "canonical" in inspect.signature(K.kmer_pack).parameters
KMER_INSTANTIATIONS = (False, True) if KMER_CANONICAL else (False,)
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


def settled_at_i1(cfg, base, tag, i1, insert=False):
    """Whether ``base`` settles each key (its tag and primary bucket) at
    the primary: a free slot for an insert, a matching tag for a query or
    delete. ``insert``: a bool, or a bool tensor, one a key."""
    want = cfg.placement.place_tag(tag, False)
    if isinstance(insert, torch.Tensor):
        want = torch.where(insert, torch.zeros_like(tag), want)
    elif insert:
        want = torch.zeros_like(tag)
    return torch.cat([
        (L.bucket_tags(base, b, cfg.layout) == w[:, None]).any(-1)
        for b, w in zip(i1.split(CHUNK), want.split(CHUNK))])


def touched_buckets(cfg, base, keys, after=None, insert=False):
    """The distinct buckets a batch of ``keys`` needs at least, from this
    run's data -> (read, written). Read: every key's primary bucket; its
    alternate where ``base`` cannot settle the key at the primary (no free
    slot for an insert, no matching tag for a query or delete); every
    bucket whose words differ between ``base`` and ``after``. Written:
    those changed buckets. The bound charges each once (roofline)."""
    lay = cfg.layout
    tag, i1, i2 = CF.prepare_keys_plain(cfg, keys)
    settled = settled_at_i1(cfg, base, tag, i1, insert)
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
    batch and after the fill (load 0.95), every batch's keys, the launch
    counts and the record it emitted."""
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
    record = {
          "phase": f"main_path_{label}", "slots": cfg.num_slots,
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
          "delete_keys_per_s": first.shape[0] / delete_s}
    emit(record)
    return h, snaps, batches, launches, record


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
    the ``top`` operators and the ``top`` kernels by self device time})."""
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
    kernels = sorted((e for e in stats if e.device_type == cuda),
                     key=lambda e: -e.self_device_time_total)
    return out, {"wall_s": wall, "device_busy_s": busy,
                 "device_idle_share": 1 - busy / wall,
                 "top_ops": [{"op": e.key, "calls": e.count,
                              "device_ms": e.self_device_time_total * 1e-3,
                              "cpu_ms": e.cpu_time_total * 1e-3}
                             for e in events[:top]],
                 "top_kernels": [{"kernel": e.key[:160], "calls": e.count,
                                  "device_ms": e.self_device_time_total * 1e-3}
                                 for e in kernels[:top]]}


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


def bloom_route(c, n: int):
    """The query plan kernel #8's wrapper takes for ``n`` keys on ``c``
    (``kernels.bloom.query_plan`` on this card's L2), or None where the
    package has one route only (an older commit's, timed beside this
    tree's)."""
    plan = getattr(bloom_kernels, "query_plan", None)
    if plan is None:
        return None
    return plan(c, n, bloom_kernels.l2_bytes(torch.device("cuda")))


def route_name(plan) -> str:
    return "windowed" if plan is not None and plan.windowed else "direct"


def bloom_query_via(c, table, keys, hit, plan) -> None:
    """Kernel #8 by ``plan``'s route (None: the package's only one)."""
    if plan is None:
        bloom_query_launch(c, table, keys, hit)
    else:
        bloom_query_launch(c, table, keys, hit, plan)


def short_kernel_name(key: str) -> str:
    """A profiler's kernel name without its namespace and arguments."""
    m = re.search(r"\w+_kernel(<[^>]*>)?", key)
    return m.group(0) if m else key


def bloom_query_shape(c, table, keys, blocks_of, **rec) -> tuple:
    """Kernel #8 on ``keys`` against ``table`` by the route the rule gives
    it, and by the other route where the table spans two to 256 windows:
    both equal bit for bit to the plain version (in parts of 2^24 keys),
    each timed, the plain version on the first part, beside a bound from
    the batch's own blocks. Returns (shape record, keys that differ)."""
    n = keys.shape[0]
    plan = bloom_route(c, n)
    hit = torch.empty(n, dtype=torch.bool, device="cuda")
    bloom_query_via(c, table, keys, hit, plan)
    parts = keys.split(KMER_BATCH)
    bad = sum(int((h != bloom_query_plain(c, table, p)).sum())
              for h, p in zip(hit.split(KMER_BATCH), parts))
    touched = blocks_of(keys, c)
    rec.update(n=n, table_bytes=c.table_bytes, query_route=route_name(plan),
               ms=cuda_ms(lambda: bloom_query_via(c, table, keys, hit, plan)),
               plain_ms=cuda_ms(lambda: bloom_query_plain(c, table, parts[0]),
                                reps=3),
               plain_n=parts[0].shape[0], touched=touched,
               bound_bytes=roofline.bloom_batch_bytes(c, "query", n, touched),
               bound_int32_ops=roofline.bloom_int_ops_per_key(c) * n)
    if plan is not None:
        rec.update(log2_window=plan.log2_window, windows=plan.windows)
        other = plan._replace(windowed=not plan.windowed)
        if 2 <= plan.windows <= bloom_kernels.MAX_WINDOWS:
            got = torch.empty_like(hit)
            bloom_query_via(c, table, keys, got, other)
            bad += int((got != hit).sum())
            rec.update(other_route=route_name(other), other_route_ms=cuda_ms(
                lambda: bloom_query_via(c, table, keys, got, other)))
    return rec, bad


def query_rule_sweep(c, table, keys, want, plan) -> dict:
    """The evidence for kernel #8's route rule on this card: the windowed
    route on ``keys`` with windows of 2^16 to 2^19 blocks, and both routes
    on the first r x num_blocks keys for r about the crossover; each
    result equal to ``want`` (the plain version's)."""
    out = {}
    hit = torch.empty_like(want)

    def timed_route(p, k, h, w):
        bloom_query_via(c, table, k, h, p)
        check(torch.equal(h, w), f"bloom_query: {p} differs from the plain "
                                 "version")
        return cuda_ms(lambda: bloom_query_via(c, table, k, h, p))

    for s in (16, 17, 18, 19):
        p = plan._replace(windowed=True, log2_window=s,
                          windows=-(-c.num_blocks >> s))
        out[f"windowed_2^{s}_blocks_ms"] = timed_route(p, keys, hit, want)
    for r in (4, 8, 12, 16):
        m = r * c.num_blocks
        out[f"{r}_keys_a_block"] = {
            route_name(p): timed_route(p, keys[:m], hit[:m], want[:m])
            for p in (plan._replace(windowed=False),
                      plan._replace(windowed=True))}
    return out


def kmer_pack_of(codes, canonical: bool, plain: bool = False):
    """Kernel #10's wrapper (or its plain version) on ``codes``, forward
    or canonical (the latter only where the package has it)."""
    fn = kmer_pack_plain if plain else K.kmer_pack
    if canonical:
        return fn(codes, KMER_K, canonical=True)
    return fn(codes, KMER_K)


def kmer_pack_launch_of(codes, out, canonical: bool) -> None:
    """One launch of kernel #10's instantiation into ``out``."""
    if KMER_CANONICAL:
        kmer_pack_launch(codes, KMER_K, out, canonical)
    else:
        kmer_pack_launch(codes, KMER_K, out)


def kmer_case_study(gen):
    """The k-mer set of a synthetic chromosome 1 through ``kmer_keys``,
    the cuckoo filter and the blocked Bloom filter (see the module
    docstring). Returns (timing records, wrapper times, launch counts,
    errors, #9's shapes, #8's shapes, #2's shape, #10's instantiations)."""
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    keys, secs["kmer_keys"] = timed(lambda: kmer_keys(codes, KMER_K))
    kmer_keys_peak = torch.cuda.max_memory_allocated() - held
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
    filled = h.state.table.clone()
    hits, query_s = timed(lambda: h.query(keys).hits)
    misses = int((~hits).sum())
    check(misses == 0, f"kmer_cuckoo: {misses} of {n_pos} positions missed")

    foreign_codes = torch.from_numpy(foreign_codes).cuda()
    foreign = torch.unique(u64_bits(kmer_keys(foreign_codes, KMER_K)))
    at = torch.searchsorted(distinct, foreign).clamp(max=n_distinct - 1)
    probes = foreign[distinct[at] != foreign]
    cuckoo_fpr = fpr_of("kmer_cuckoo", h.query(probes).hits,
                        h.expected_fpr())

    r0 = GENOME_BASES // 2
    region_codes = codes[r0:r0 + REGION_BASES]
    check(region_codes.data_ptr() % 16, "kmer: the region's slice is "
          "16-byte aligned, so it does not test an unaligned start")
    region = torch.unique(u64_bits(kmer_keys(region_codes, KMER_K)))
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
    # Each count is of differing elements (keys, table words, hits). #10's
    # instantiations on the genome, the foreign genome and the deleted
    # region's slice, whose first code is not 16-byte aligned.
    t0 = time.perf_counter()
    errs = {"kmer_pack": 0}
    kmer_checked = {}
    for label, c in (("genome", codes), ("foreign", foreign_codes),
                     ("region", region_codes)):
        for canonical in KMER_INSTANTIATIONS:
            err = int((kmer_pack_of(c, canonical)
                       != kmer_pack_of(c, canonical, plain=True)).sum())
            errs["kmer_pack"] += err
            kind = "canonical" if canonical else "forward"
            kmer_checked[f"{label}_{kind}"] = {
                "codes": c.shape[0], "ptr_mod_16": c.data_ptr() % 16,
                "differ": err}
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
    # #10 at the genome's shape, each instantiation beside its bound; the
    # row's own numbers are those of the instantiation ``kmer_keys`` runs.
    out = torch.empty_like(keys)
    kmer_shapes = {}
    for canonical in KMER_INSTANTIATIONS:
        kmer_shapes["canonical" if canonical else "forward"] = {
            "n": n_pos,
            "ms": cuda_ms(lambda: kmer_pack_launch_of(codes, out, canonical)),
            "plain_ms": cuda_ms(
                lambda: kmer_pack_of(codes, canonical, plain=True), reps=3),
            "wrapper_ms": cuda_ms(lambda: kmer_pack_of(codes, canonical)),
            "bound_bytes": roofline.kmer_pack_bytes(GENOME_BASES, KMER_K),
            "bound_int32_ops": (roofline.kmer_pack_int_ops(
                GENOME_BASES, KMER_K, canonical=True) if canonical
                else roofline.kmer_pack_int_ops(GENOME_BASES))}
    ran = kmer_shapes["canonical" if KMER_CANONICAL else "forward"]
    timing["kmer_pack"] = (ran["ms"], ran["plain_ms"], n_pos, n_pos,
                           ran["bound_bytes"], ran["bound_int32_ops"], None)
    wrapper["kmer_pack"] = ran["wrapper_ms"]
    del out
    # ``kmer_keys`` again, its output freed each time (the first call above
    # found no free block of its size after the main path's caches were
    # emptied); then three calls under the profiler: their kernels and the
    # device's idle share.
    kmer_keys_calls = {"repeat_s": [
        timed(lambda: kmer_keys(codes, KMER_K))[1] for _ in range(3)]}
    _, kmer_keys_calls["profiled_3_calls"] = profiled(
        lambda: [kmer_keys(codes, KMER_K).shape for _ in range(3)], top=8)

    def blocks_of(k, c=bcfg):
        """The distinct blocks of keys ``k`` (hashed 2^24 at a time)."""
        return torch.unique(torch.cat([
            torch.unique(hash_key_plain(p, c.hash_kind, c.seed)[1]
                         % c.num_blocks) for p in k.split(KMER_BATCH)])).numel()

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
    # Two more shapes of #9, each against a bound from its own batch's
    # blocks: the last batch into the table that holds all the others (the
    # fullest table the case study inserts into), and the first batch into
    # a table of 2^18 blocks (16 MiB), which stays in L2: the kernel's cost
    # without the table's device-memory traffic. At each, the table the
    # kernel's last timed run left equals the one the plain version's left.
    def shape(c, work, batch, setup, **rec):
        m = batch.shape[0]
        valid = torch.ones(m, dtype=torch.bool, device="cuda")
        touched = blocks_of(batch, c)
        rec.update(n=m, table_bytes=c.table_bytes, ms=cuda_ms(
            lambda: bloom_insert_launch(c, work, batch, valid), setup=setup))
        got = work.clone()
        rec["plain_ms"] = cuda_ms(
            lambda: bloom_insert_plain(c, work, batch, valid), reps=3,
            setup=setup)
        errs["bloom_insert"] += int((got != work).sum())
        return {**rec, "bound_bytes": roofline.bloom_batch_bytes(
                    c, "insert", m, touched),
                "bound_int32_ops": roofline.bloom_int_ops_per_key(c) * m,
                "touched": touched}

    before = bcfg.init("cuda").table
    for b in batches[:-1]:
        b = normalize_keys(b)
        bloom_insert_launch(bcfg, before, b,
                            torch.ones(b.shape[0], dtype=torch.bool,
                                       device="cuda"))
    last = normalize_keys(batches[-1])
    bloom_shapes = {"last_batch_into_the_others": shape(
        bcfg, table, last, lambda: table.copy_(before), batch_no=len(batches),
        keys_before=n_distinct - last.shape[0])}
    check(torch.equal(table, hb.state.table),
          "bloom_insert: the last batch into the others' table does not "
          "give the case study's table")
    del before
    small = dataclasses.replace(bcfg, num_blocks=1 << 18)
    small_table = small.init("cuda").table
    bloom_shapes["table_in_l2"] = shape(small, small_table, first,
                                        small_table.zero_, batch_no=1,
                                        num_blocks=small.num_blocks)
    check(errs["bloom_insert"] == 0, f"bloom_insert: {errs['bloom_insert']} "
          "table words differ from the plain version's at the extra shapes")
    # Kernel #8 at four shapes, each by the route the rule gives it (and by
    # the other where it can run), equal to the plain version: every
    # position; the FPR probe's foreign k-mers and the first batch (2^24
    # stored keys) on the case study's table; the first batch on the 2^18-
    # block table that holds it, in L2. At the case study's shape also the
    # device time of each kernel of the route, the route's own floor, and
    # the peak of device memory the call allocates.
    query_shapes, bad = {}, 0
    for label, c, t, k in (
            ("case_study", bcfg, table, keys),
            ("fpr_probe", bcfg, table, normalize_keys(probes)),
            ("first_batch", bcfg, table, first),
            ("table_in_l2", small, small_table, first)):
        query_shapes[label], b = bloom_query_shape(c, t, k, blocks_of)
        bad += b
    errs["bloom_query"] += bad
    check(bad == 0, f"bloom_query: {bad} keys differ from the plain "
                    "version's at the four shapes")
    plan = bloom_route(bcfg, n_pos)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    bloom_query_via(bcfg, table, keys, hit, plan)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    _, prof = profiled(lambda: [bloom_query_via(bcfg, table, keys, hit, plan)
                                for _ in range(3)])
    query_shapes["case_study"].update(
        passes_ms={short_kernel_name(k["kernel"]): k["device_ms"] / k["calls"]
                   for k in prof["top_kernels"]},
        max_memory_allocated_by_the_call=peak)
    if plan is not None:
        query_shapes["case_study"]["route_floor_ms"] = (
            roofline.bloom_windowed_bytes(bcfg, n_pos) / HBM_BYTES_PER_S * 1e3)
        query_shapes["case_study"]["rule_sweep"] = query_rule_sweep(
            bcfg, table, keys, bhits, plan)
    del small_table
    # Kernel #2 on every position against the table after the fill.
    query_rec = query_shape(cfg, h.state._replace(table=filled), keys)
    del filled
    secs["timings"] = time.perf_counter() - t0

    emit({"phase": "kmer_case_study", "bases": GENOME_BASES, "k": KMER_K,
          "positions": n_pos, "n_distinct": n_distinct,
          "python_int_checks": len(picks),
          "kmer_keys_max_memory_allocated": kmer_keys_peak,
          "kmer_keys_calls": kmer_keys_calls,
          "kmer_pack_checked": kmer_checked,
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
          "bloom_insert_shapes": bloom_shapes,
          "bloom_query_shapes": query_shapes,
          "launches": launches, "max_abs_err": errs, "seconds": secs})
    del h, hb, keys, distinct, order, batches, codes, table, hit
    del foreign_codes, region_codes
    torch.cuda.empty_cache()
    return (timing, wrapper, launches, errs, bloom_shapes, query_shapes,
            query_rec, kmer_shapes)


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


def unfused_comparison_l2(h, snaps, batches, gen) -> None:
    """Phase 3b on two tables of 2^22 slots that stay in the L2, where a
    random bucket read costs less and the scans' instructions can show:
    the registry default layout (fp 16 x bucket 16) at load 0.5 from the
    2^22 main path's fill (``h``, ``snaps``, ``batches``), and fp 8 x
    bucket 16 filled to load 0.5 by #4. On each, through the wrappers a
    caller uses (launch counts zeroed just before and read just after):
    the probe of ``L2_PROBES`` keys, half stored, half fresh, through both
    query kernels (the unfused hits equal the fused; every stored key
    found), and ``L2_PROBES / 2`` fresh keys through both insert kernels
    on copies of the table (the unfused insert held to the order-free
    outcome). Each pair then timed beside each other."""
    t0 = time.perf_counter()
    cfg = h.config
    # The half snapshot holds the batches before the first at which the
    # count (every key placed: ``fill``'s gate) reached half the slots.
    sizes = np.cumsum([0] + [b.shape[0] for b in batches])
    held = int(np.argmax(sizes >= cfg.num_slots // 2))
    stored16 = normalize_keys(torch.cat(batches[:held]))
    cfg8 = dataclasses.replace(cfg, fp_bits=8)
    keys8 = normalize_keys(random_keys(gen, cfg8.num_slots // 2))
    state8, ok8 = K.cuckoo_insert_direct(cfg8, cfg8.init("cuda"), keys8)
    layouts = {"fp16_b16": (cfg, snaps["half"], stored16),
               "fp8_b16": (cfg8, state8.table, keys8[ok8])}
    half = L2_PROBES // 2
    K.reset_launches()
    runs = {}
    for label, (c, table, stored) in layouts.items():
        # Half the probe stored keys (#4 may turn a few of the fp 8 fill's
        # keys down, with both buckets full), the rest fresh.
        m = min(half, stored.shape[0])
        check(m >= 0.99 * half, f"{label}: {m} stored keys")
        probe = torch.cat([stored[:m], normalize_keys(
            random_keys(gen, L2_PROBES - m, top_half=True))])
        ins_keys = normalize_keys(random_keys(gen, half))
        st = CF.CuckooState(table, torch.zeros((), dtype=torch.int32,
                                               device="cuda"))
        hits = [K.cuckoo_query(c, st, probe, fused=f) for f in (True, False)]
        placed = [K.cuckoo_insert_direct(c, st._replace(table=table.clone()),
                                         ins_keys, fused=f)[1]
                  for f in (True, False)]
        runs[label] = (c, st, probe, m, ins_keys, hits, placed)
    torch.cuda.synchronize()
    launches = check_launches("unfused_comparison_l2", [
        "cuckoo_query", "cuckoo_query_unfused", "cuckoo_insert_direct",
        "cuckoo_insert_unfused"])

    out = {}
    for label, (c, st, probe, m, ins_keys, hits, placed) in runs.items():
        check(torch.equal(hits[0], hits[1]),
              f"{label}: the unfused query differs from the fused on "
              f"{int((hits[0] != hits[1]).sum())} keys")
        check(bool(hits[0][:m].all()), f"{label}: a stored key missed")
        turned_down = [int((~ok).sum()) for ok in placed]
        turned_down.append(check_direct_insert(
            c, st, st.table, ins_keys, f"cuckoo_insert_unfused {label}",
            functools.partial(K.cuckoo_insert_direct, fused=False)))
        work = torch.empty_like(st.table)
        valid = torch.ones(half, dtype=torch.bool, device="cuda")
        ok = torch.empty(half, dtype=torch.bool, device="cuda")
        ms = {"query_fused": cuda_ms(lambda: K.cuckoo_query(c, st, probe)),
              "query_unfused": cuda_ms(
                  lambda: K.cuckoo_query(c, st, probe, fused=False)),
              "insert_fused": cuda_ms(
                  lambda: cuckoo_insert_launch(c, work, ins_keys, valid, ok),
                  setup=lambda: work.copy_(st.table)),
              "insert_unfused": cuda_ms(
                  lambda: cuckoo_insert_unfused_launch(c, work, ins_keys,
                                                       valid, ok),
                  setup=lambda: work.copy_(st.table))}
        ms["query_unfused_over_fused"] = ms["query_unfused"] / ms["query_fused"]
        ms["insert_unfused_over_fused"] = (ms["insert_unfused"]
                                           / ms["insert_fused"])
        out[label] = {"table_bytes": c.table_bytes,
                      "load": int((bucket_lanes(c, st.table, 0, c.num_buckets)
                                   != 0).sum()) / c.num_slots,
                      "probe_keys": probe.shape[0], "probe_stored": m,
                      "insert_keys": ins_keys.shape[0],
                      "turned_down_fused_unfused_checked": turned_down,
                      "ms": ms}
    emit({"phase": "unfused_comparison_l2", "launches": launches,
          "tables": out,
          "tolerance": "exact (0): unfused query hits == fused query hits; "
                       "unfused insert: the order-free outcome",
          "seconds": time.perf_counter() - t0})


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
    """``FLASH_SHAPES`` in the kernel layout: (label, q, k, v, causal,
    window, q_offset, KVH)."""
    cases = []
    for (B, KVH, g, Sq, Sk, D, Dv, causal, window, q_offset,
         dtype) in FLASH_SHAPES:
        def rnd(*shape):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * 0.3).to(dtype)
        cases.append((f"{B}x{KVH}x{g} {Sq}x{Sk} D{D}/{Dv} causal={causal} "
                      f"window={window} q_offset={q_offset} "
                      f"{str(dtype)[6:]}",
                      rnd(B * KVH, g, Sq, D), rnd(B * KVH, Sk, D),
                      rnd(B * KVH, Sk, Dv), causal, window, q_offset, KVH))
    return cases


def model_view(t, kv_heads: int):
    """A kernel-layout tensor ([BK, g, S, D] or [BK, S, D]) as the model's
    [B, S, H, D] (B = BK / kv_heads): a strided view into a buffer with 8
    more columns a row, as a fused projection's output would be."""
    if t.ndim == 3:
        t = t[:, None]
    BK, g, S, D = t.shape
    t = t.reshape(BK // kv_heads, kv_heads * g, S, D).transpose(1, 2)
    buf = torch.zeros(t.shape[:3] + (D + 8,), dtype=t.dtype, device="cuda")
    buf[..., :D] = t
    return buf[..., :D]


def ptxas_report(log: str, stem: str) -> dict:
    """Registers, stack and spill bytes of each kernel instantiation whose
    name starts with ``stem``, from ``nvcc -Xptxas -v``'s output (empty
    where the library was not compiled in this run)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            name = re.sub(rf"^_ZN\w*?_GLOBAL__N__\w+?\d+({stem}\w*?_kernel)",
                          r"\1", name)
            continue
        if name is None:
            continue
        rec = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
    return out


def sass_listing(name: str, stem: str):
    """Each kernel instantiation of library ``name`` whose name starts with
    ``stem`` -> its instructions in order as (opcode, guarded) pairs, where
    ``guarded`` says a predicate other than PT guards it, from ``cuobjdump
    -sass`` (None without the tool)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", build.load(name)._name],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out, listing = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = re.sub(rf"^_ZN\w*?_GLOBAL__N__\w+?\d+({stem}\w*?_kernel)",
                        r"\1", m.group(1))
            listing = out.setdefault(fn, [])
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P(\w+)\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if listing is not None and m and m.group(3) != "NOP":
            listing.append((m.group(3), bool(m.group(1)) and m.group(2) != "T"))
    return out


def sass_census(name: str, stem: str):
    """Instructions of each kernel instantiation of library ``name`` whose
    name starts with ``stem``, of them the shuffles (SHFL) and global
    reductions (RED), and the median count from one reduction to the next
    (a round of #9's group, one reduction each, where blocks are narrow),
    from ``cuobjdump -sass`` (None without the tool)."""
    listings = sass_listing(name, stem)
    if listings is None:
        return None
    out = {}
    for fn, listing in listings.items():
        ops = [op for op, _ in listing]
        at = [k + 1 for k, op in enumerate(ops) if op in ("RED", "REDG")]
        out[fn] = {"instructions": len(ops), "SHFL": ops.count("SHFL"),
                   "RED": len(at),
                   "between_reds": (statistics.median(np.diff(at).tolist())
                                    if len(at) > 1 else None)}
    return out


def query_loads(name: str = "cuckoo_query"):
    """Where each instantiation of the query kernel issues its global loads
    (``cuobjdump -sass``; None without the tool): the LDGs, and whether
    bucket i2's (the last ``W / 4`` 16-byte loads of a bucket of W words,
    one load below four words) sit behind a branch: guarded themselves, or
    after a guarded BRA or EXIT that follows every earlier LDG."""
    listings = sass_listing(name, name)
    if listings is None:
        return None
    out = {}
    for fn, listing in listings.items():
        words = int(re.search(r"ILi(\d+)ELi\d+E", fn).group(1))
        per_bucket = max(1, words // 4)
        loads = [k for k, (op, _) in enumerate(listing) if op == "LDG"]
        i2, before = loads[-per_bucket:], loads[:-per_bucket]
        behind = bool(before) and (
            all(listing[k][1] for k in i2)
            or any(op in ("BRA", "EXIT") and guarded
                   for op, guarded in listing[before[-1] + 1:i2[0]]))
        out[fn] = {"LDG": len(loads), "LDG_expected": 1 + 2 * per_bucket,
                   "i2_behind_branch": behind}
    return out


def resident_threads(registers: int, threads: int = 256) -> int:
    """Threads an SM holds of a kernel at ``registers`` a thread in blocks
    of ``threads``: 65536 registers, given a warp 256 at a time; at most
    2048 threads and 32 blocks."""
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(32, 2048 // threads, 65536 // (per_warp * (threads // 32)))
    return blocks * threads


def ptxas_threads(log: str, stem: str) -> dict:
    """``ptxas_report`` with each instantiation's resident threads an SM."""
    report = ptxas_report(log, stem)
    for rec in report.values():
        if "registers" in rec:
            rec["resident_threads_per_sm"] = resident_threads(rec["registers"])
    return report


# ---------------------------------------------------------------------------
# Kernel #7's route (kernels/cuckoo_mixed.py). The phase also runs beside an
# older package whose #7 is one kernel over the key-sorted batch, so that
# one call can time both; there the route's time is that kernel's alone,
# its sort outside, as its row was timed.
# ---------------------------------------------------------------------------

MIXED_ROUTE = hasattr(CM, "cuckoo_mixed_route")


def mixed_route_ms(cfg, work, keys, ops, valid, setup) -> float:
    """#7's route on ``work`` from its first launch to its last."""
    ok = torch.empty(keys.shape[0], dtype=torch.bool, device="cuda")
    if MIXED_ROUTE:
        return cuda_ms(lambda: CM.cuckoo_mixed_route(cfg, work, keys, ops,
                                                     valid, ok),
                       reps=3, setup=setup)
    order, seg_start = CM.segments(keys)
    return cuda_ms(lambda: CM.cuckoo_mixed_launch(
        cfg, work, keys, ops, valid, order, seg_start, ok), reps=3,
        setup=setup)


def repeat_marks(cfg, base, keys, ops, valid) -> dict:
    """#7's marks (steps 1-3 on a copy of ``base``) against the repeats
    that ``torch.unique`` counts among the valid ops: no repeated key
    unmarked (a gate); the false repeats (different keys with one scratch
    value) counted; and the ops that 31-bit values (a scratch of 32-bit
    slots) would mark falsely, from the hash kernel's digests."""
    n = keys.shape[0]
    scratch = torch.empty(CM.scratch_slots(n), dtype=torch.int64,
                          device="cuda")
    state = torch.empty(n, dtype=torch.uint8, device="cuda")
    ok = torch.empty(n, dtype=torch.bool, device="cuda")
    CM.cuckoo_mixed_launch(cfg, base.clone(), keys, ops, valid, scratch, ok,
                           state)
    values = u64_bits(keys)
    distinct, inverse, counts = torch.unique(
        values[valid], return_inverse=True, return_counts=True)
    real = torch.zeros(n, dtype=torch.bool, device="cuda")
    real[valid] = counts[inverse] > 1
    marked = state != 0
    missed = int((real & ~marked).sum())
    check(missed == 0, f"cuckoo_mixed: {missed} ops of repeated keys not "
                       "marked")
    _, lo = K.hash64(torch.stack([distinct.to(torch.int32),
                                  (distinct >> 32).to(torch.int32)], 1),
                     cfg.seed, cfg.hash_kind)
    _, v31, c31 = torch.unique(lo & 0x7FFFFFFF, return_inverse=True,
                               return_counts=True)
    shared = torch.zeros(n, dtype=torch.bool, device="cuda")
    shared[valid] = (c31[v31] > 1)[inverse]
    return {"repeated_ops": int(real.sum()), "marked_ops": int(marked.sum()),
            "missed_repeats": missed,
            "false_repeats": int((marked & ~real).sum()),
            "false_repeats_at_31_bit_values": int((shared & ~real).sum())}


def cleared_codes_check(cfg, base, after, keys, label: str) -> None:
    """A delete-only batch on ``base`` that removed ``keys`` (its ``ok``
    ones): no lane but a cleared one changed, and the cleared lanes held
    exactly those keys' (pair, tag) codes."""
    codes = []
    for b0 in range(0, cfg.num_buckets, CHUNK):
        b1 = min(b0 + CHUNK, cfg.num_buckets)
        tb, ta = bucket_lanes(cfg, base, b0, b1), bucket_lanes(cfg, after, b0, b1)
        cleared = (tb != 0) & (ta == 0)
        check(not bool(((ta != tb) & ~cleared).any()),
              f"{label}: a lane other than a cleared one changed")
        bucket = torch.arange(b0, b1, device=base.device)[:, None].expand_as(
            tb)[cleared]
        tag = tb[cleared]
        alt = cfg.placement.alt_bucket(bucket, tag)
        codes.append((torch.minimum(bucket, alt) << cfg.fp_bits) | tag)
    check_codes(label, torch.sort(torch.cat(codes)).values,
                key_codes(cfg, [keys]))


def host_syncs(fn):
    """(``fn()``, the warnings of torch's sync debug mode it raised, those
    warnings' distinct first lines)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # The mode's own notice (once a process, "a prototype feature") is
    # not a sync.
    said = [str(w.message).splitlines()[0] for w in caught
            if "synchroniz" in str(w.message)
            and "prototype feature" not in str(w.message)]
    return out, len(said), sorted(set(said))


def code_counts_check(cfg, stored, keys, ok, label: str) -> None:
    """A delete-only batch on a table whose sorted codes are ``stored``: for
    every (pair, tag) code the ops carry, the deletes ``ok`` number
    min(copies of the code the table holds, deletes of it), whatever the
    order (aliasing keys share copies)."""
    tag, i1, i2 = CF.prepare_keys_plain(cfg, keys)
    codes, inverse, asked = torch.unique(
        (torch.minimum(i1, i2) << cfg.fp_bits) | tag, return_inverse=True,
        return_counts=True)
    copies = (torch.searchsorted(stored, codes, right=True)
              - torch.searchsorted(stored, codes))
    done = torch.zeros_like(asked).index_add_(0, inverse, ok.long())
    bad = int((done != torch.minimum(copies, asked)).sum())
    check(bad == 0, f"{label}: {bad} codes deleted other than min(copies, "
                    "deletes) times")


def mixed_route_shapes(cfg, state, work, bases, shapes, profile) -> dict:
    """Kernel #7 through ``ops.cuckoo_apply_ops`` at each of ``shapes``
    ({label: (base label, keys, ops)}), all ops valid: one gated call
    (launch counts zeroed just before and read just after, host syncs
    counted, the call's peak of allocated device memory), then the route's
    time from its first launch to its last (``ms``) and the whole wrapper's
    (``wrapper_ms``), each from a copy of its base table, beside the
    function's bound and the route's own floor from the buckets the gated
    call touched; at the shapes in ``profile`` one more call under
    ``torch.profiler`` (each kernel's device ms and calls). Returns
    {label: shape record}."""
    # What one host sync (a nonzero) raises in torch's sync debug mode.
    _, one_sync, _ = host_syncs(
        lambda: torch.ones(8, device="cuda").nonzero())
    tags_of = {b: stored_tags(cfg, t) for b, t in bases.items()}
    codes_of = {}
    recs = {}
    for label, (base_label, keys, ops) in shapes.items():
        t0 = time.perf_counter()
        base = bases[base_label]
        n = keys.shape[0]
        valid = torch.ones(n, dtype=torch.bool, device="cuda")

        def setup(base=base):
            work.copy_(base)

        setup()
        K.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        (_, ok), syncs, said = host_syncs(lambda: K.cuckoo_apply_ops(
            cfg, state._replace(table=work), keys, ops, valid))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        launches = {k: v for k, v in K.LAUNCHES.items()
                    if k.startswith("cuckoo_mixed")}
        touched = touched_buckets(cfg, base, keys, work,
                                  insert=ops == amq.OP_INSERT)
        inserted = int((ok & (ops == amq.OP_INSERT)).sum())
        deleted = int((ok & (ops == amq.OP_DELETE)).sum())
        tags = stored_tags(cfg, work) - tags_of[base_label]
        check(tags == inserted - deleted,
              f"cuckoo_mixed {label}: {tags} tags added, {inserted} inserts "
              f"and {deleted} deletes ok")
        # Delete-only shapes with repeated keys (the main path's delete is
        # held by check_delete above).
        if bool((ops == amq.OP_DELETE).all()) and (
                torch.unique(u64_bits(keys)).numel() < n):
            cleared_codes_check(cfg, base, work, keys[ok],
                                f"cuckoo_mixed {label}")
            if base_label not in codes_of:
                codes_of[base_label] = table_codes(cfg, base)
            code_counts_check(cfg, codes_of[base_label], keys, ok,
                              f"cuckoo_mixed {label}")
        rec = {"n": n, "base": base_label, "ok": int(ok.sum()),
               "launches": launches,
               "host_syncs": syncs, "host_sync_warnings": said,
               "max_memory_allocated_by_the_call": peak, "touched": touched,
               "bound_bytes": roofline.least_batch_bytes(cfg, "delete", n,
                                                         touched),
               "bound_int32_ops": roofline.int_ops_per_key(cfg, "delete") * n}
        if MIXED_ROUTE:
            rec["marks"] = repeat_marks(cfg, base, keys, ops, valid)
            check(syncs <= one_sync, f"cuckoo_mixed {label}: {syncs} sync "
                  f"warnings in one call, one nonzero's {one_sync}")
            check(launches["cuckoo_mixed_walk"]
                  == int(rec["marks"]["marked_ops"] > 0),
                  f"cuckoo_mixed {label}: walk launches {launches}")
            rec["route_floor_bytes"] = roofline.mixed_route_bytes(
                cfg, n, touched, rec["marks"]["marked_ops"])
            rec["route_floor_ms"] = (rec["route_floor_bytes"]
                                     / HBM_BYTES_PER_S * 1e3)
        t1 = time.perf_counter()
        rec["ms"] = mixed_route_ms(cfg, work, keys, ops, valid, setup)
        rec["wrapper_ms"] = cuda_ms(
            lambda: K.cuckoo_apply_ops(cfg, state._replace(table=work), keys,
                                       ops, valid), reps=3, setup=setup)
        t2 = time.perf_counter()
        if label in profile:
            setup()
            _, prof = profiled(lambda: K.cuckoo_apply_ops(
                cfg, state._replace(table=work), keys, ops, valid))
            rec["passes"] = {}
            for k in prof["top_kernels"]:
                p = rec["passes"].setdefault(short_kernel_name(k["kernel"]),
                                             {"device_ms": 0.0, "calls": 0})
                p["device_ms"] += k["device_ms"]
                p["calls"] += k["calls"]
            rec["profiled_call"] = {k: prof[k] for k in (
                "wall_s", "device_busy_s", "device_idle_share")}
        t3 = time.perf_counter()
        rec["seconds"] = {"checks": t1 - t0, "timing": t2 - t1,
                          "profile": t3 - t2}
        recs[label] = rec
    return recs


# ---------------------------------------------------------------------------
# Kernel #6's route (kernels/cuckoo_insert_bulk.py). The phase also runs
# beside an older package whose #6 is one kernel over the i1-sorted batch,
# so that one call can time both; there the route's time is that kernel's
# alone, its hash and sort outside, as its row was timed.
# ---------------------------------------------------------------------------

BULK_ROUTE = hasattr(BULK, "bulk_plan")


def bulk_route_ms(cfg, work, keys, setup) -> float:
    """#6's route on ``work`` from its first launch to its last."""
    n = keys.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    ok = torch.empty(n, dtype=torch.bool, device="cuda")
    if BULK_ROUTE:
        return cuda_ms(lambda: BULK.cuckoo_insert_bulk_launch(
            cfg, work, keys, valid, ok), setup=setup)
    _, i1, _ = CF.prepare_keys(cfg, keys)
    order, seg_start = CM.sorted_runs(i1)
    return cuda_ms(lambda: BULK.cuckoo_insert_bulk_launch(
        cfg, work, keys, valid, order, seg_start, ok), setup=setup)


def bulk_rule_sweep(cfg, work, base, keys) -> dict:
    """The evidence for kernel #6's route rule on this card, each run from
    a copy of ``base``: the windowed route on ``keys`` with windows of
    2^17 to 2^19 buckets, and both routes on the first r x num_buckets
    keys for r about the crossover."""
    plan = BULK.bulk_plan(cfg, keys.shape[0],
                          bloom_kernels.l2_bytes(work.device))
    valid = torch.ones(keys.shape[0], dtype=torch.bool, device="cuda")
    ok = torch.empty_like(valid)

    def timed(p, m):
        return cuda_ms(lambda: BULK.cuckoo_insert_bulk_launch(
            cfg, work, keys[:m], valid[:m], ok[:m], p),
            setup=lambda: work.copy_(base))

    out = {}
    for s in (17, 18, 19):
        p = plan._replace(windowed=True, log2_window=s,
                          windows=-(-cfg.num_buckets >> s))
        out[f"windowed_2^{s}_buckets_ms"] = timed(p, keys.shape[0])
    for r in (0.25, 0.375, 0.5, 1.0):
        m = int(r * cfg.num_buckets)
        out[f"{r}_keys_a_bucket"] = {
            "one_window": timed(plan._replace(windowed=False), m),
            "windowed": timed(plan._replace(windowed=True), m)}
    return out


def bulk_shape(cfg, state, work, base, keys, profile=False) -> dict:
    """Kernel #6 through ``ops.cuckoo_insert_bulk`` on ``keys`` into a copy
    of ``base``: one call with its host syncs counted, then the route's
    time from its first launch to its last (``ms``) and the whole
    wrapper's (``wrapper_ms``), each from a copy of ``base``, beside the
    function's bound and the route's own floor from the buckets the
    route's last timed run touched; with ``profile``, one more call under
    ``torch.profiler`` (each kernel's device ms and calls) and the rule's
    sweep (:func:`bulk_rule_sweep`). The route's gates: no host sync in
    the call and no sort among its kernels."""
    n = keys.shape[0]

    def setup():
        work.copy_(base)

    setup()
    _, syncs, said = host_syncs(lambda: K.cuckoo_insert_bulk(
        cfg, state._replace(table=work), keys))
    torch.cuda.synchronize()
    rec = {"n": n, "host_syncs": syncs, "host_sync_warnings": said,
           "ms": bulk_route_ms(cfg, work, keys, setup)}
    touched = touched_buckets(cfg, base, keys, work, insert=True)
    rec.update(
        wrapper_ms=cuda_ms(lambda: K.cuckoo_insert_bulk(
            cfg, state._replace(table=work), keys), setup=setup),
        touched=touched,
        bound_bytes=roofline.least_batch_bytes(cfg, "bulk_insert", n, touched),
        bound_int32_ops=roofline.int_ops_per_key(cfg, "bulk_insert") * n)
    if BULK_ROUTE:
        plan = BULK.bulk_plan(cfg, n, bloom_kernels.l2_bytes(work.device))
        rec["plan"] = plan._asdict()
        check(syncs == 0, f"cuckoo_insert_bulk n={n}: {syncs} host syncs "
                          f"in the wrapper: {said}")
        if plan.windowed:
            rec["route_floor_bytes"] = roofline.bulk_route_bytes(cfg, n,
                                                                 touched[1])
            rec["route_floor_ms"] = (rec["route_floor_bytes"]
                                     / HBM_BYTES_PER_S * 1e3)
    if profile:
        setup()
        _, prof = profiled(lambda: K.cuckoo_insert_bulk(
            cfg, state._replace(table=work), keys))
        rec["passes"] = {}
        for k in prof["top_kernels"]:
            p = rec["passes"].setdefault(short_kernel_name(k["kernel"]),
                                         {"device_ms": 0.0, "calls": 0})
            p["device_ms"] += k["device_ms"]
            p["calls"] += k["calls"]
        rec["profiled_call"] = {k: prof[k] for k in (
            "wall_s", "device_busy_s", "device_idle_share")}
        check(not BULK_ROUTE or not any("sort" in k.lower()
                                        for k in rec["passes"]),
              f"cuckoo_insert_bulk n={n}: a sort among the wrapper's "
              f"kernels: {sorted(rec['passes'])}")
        if BULK_ROUTE:
            rec["rule_sweep"] = bulk_rule_sweep(cfg, work, base, keys)
    return rec


def insert_shapes(h, bases, keys, sub, work) -> dict:
    """Kernel #4 at its other shapes (``bases``: {label: table}), each
    held first to the order-free outcome of the plain loop at 2^24 keys
    and exactly to it at 2^12, then timed beside the plain version with
    the buckets the kernel's last timed run touched. Returns {label:
    shape record}."""
    cfg = h.config
    n = keys.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    ok = torch.empty(n, dtype=torch.bool, device="cuda")
    sub_valid = torch.ones(sub.shape[0], dtype=torch.bool, device="cuda")
    shapes = {}
    for label, base in bases.items():
        def setup(base=base):
            work.copy_(base)
        turned_down = check_direct_insert(cfg, h.state, base, keys,
                                          f"cuckoo_insert_direct {label}")
        err = same_outcome(
            cfg, base, sub,
            lambda t: K.cuckoo_insert_direct(
                cfg, h.state._replace(table=t), sub, sub_valid)[1],
            lambda t: cuckoo_insert_direct_plain(cfg, t, sub, sub_valid))
        check(err == 0, f"cuckoo_insert_direct {label}: ok differs")
        ms = cuda_ms(lambda: cuckoo_insert_launch(cfg, work, keys, valid, ok),
                     reps=3, setup=setup)
        touched = touched_buckets(cfg, base, keys, work, insert=True)
        shapes[label] = {
            "n": n, "turned_down": turned_down, "ms": ms,
            "plain_ms": cuda_ms(lambda: cuckoo_insert_direct_plain(
                cfg, work, sub, sub_valid), reps=3, setup=setup),
            "plain_n": sub.shape[0], "touched": touched,
            "bound_bytes": roofline.least_batch_bytes(cfg, "insert", n,
                                                      touched),
            "bound_int32_ops": roofline.int_ops_per_key(cfg, "insert") * n}
    return shapes


def query_shape(cfg, state, keys, fused=True, **rec) -> dict:
    """Kernel #2 (#3 where not ``fused``) on ``keys`` against ``state``'s
    table: equal to its plain version bit for bit under both hashes (in
    parts of 2^24 keys), then timed beside it (the plain version on the
    first part), with the share of keys whose bucket i1 holds a matching
    tag (the keys that skip bucket i2) and the work the query needs: as
    buckets, every key's i1 and its i2 where i1 holds no matching tag; as
    operations, the op's floor less bucket i2's SWAR test for each key
    that i1 settles (the op's bound, the same for both kernels)."""
    n = keys.shape[0]
    parts = keys.split(PROBES)
    name = "cuckoo_query" if fused else "cuckoo_query_unfused"
    plain = cuckoo_query_plain if fused else cuckoo_query_unfused_plain
    for kind in ("fmix32", "xxhash64"):
        c = dataclasses.replace(cfg, hash_kind=kind)
        got = K.cuckoo_query(c, state, keys, fused=fused).split(PROBES)
        bad = sum(int((g != plain(c, state.table, p)).sum())
                  for g, p in zip(got, parts))
        check(bad == 0, f"{name} {rec}: {bad} keys differ from the "
                        f"plain version's ({kind})")
    settled = 0
    need = torch.zeros(cfg.num_buckets, dtype=torch.bool, device=keys.device)
    for part in parts:
        tag, i1, i2 = CF.prepare_keys_plain(cfg, part)
        at_i1 = settled_at_i1(cfg, state.table, tag, i1)
        settled += int(at_i1.sum())
        need[i1] = True
        need[i2[~at_i1]] = True
    touched = (int(need.sum()), 0)
    return {**rec, "n": n,
            "ms": cuda_ms(lambda: K.cuckoo_query(cfg, state, keys, fused=fused)),
            "plain_ms": cuda_ms(lambda: plain(cfg, state.table, parts[0]),
                                reps=3),
            "plain_n": parts[0].shape[0], "i1_hit_share": settled / n,
            "touched": touched,
            "bound_bytes": roofline.least_batch_bytes(cfg, "query", n, touched),
            "bound_int32_ops": roofline.int_ops_per_key(cfg, "query") * n
            - cfg.layout.words_per_bucket * roofline.SWAR_WORD_INSTRUCTIONS
            * settled}


def flash_check(label, q, k, v, causal, window, q_offset, kv_heads) -> dict:
    """Kernel #11 against its plain version on one input (see
    ``FLASH_TOL``), its bf16 output against its float32 output rounded
    (equal), and, for bf16 inputs, the model-layout entry on strided
    [B, S, H, D] views of the same values (``kv_heads`` KV heads a batch
    row) against the kernel layout's outputs (equal, both dtypes)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = K.flash_attention(q, k, v, **kw)
    got_bf16 = K.flash_attention(q, k, v, out_dtype=torch.bfloat16, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"flash {label}: not finite")
    check(torch.equal(got_bf16, got.to(torch.bfloat16)),
          f"flash {label}: the bf16 output is not the float32 one rounded")
    if q.dtype == torch.bfloat16:
        views = [model_view(t, kv_heads) for t in (q, k, v)]
        B, Sq, H, Dv = views[0].shape[:3] + (v.shape[-1],)
        for ref in (got, got_bf16):
            out = K.flash_attention_bshd(*views, out_dtype=ref.dtype, **kw)
            check(torch.equal(out, ref.reshape(B, H, Sq, Dv).transpose(1, 2)),
                  f"flash {label}: the model-layout entry on strided views "
                  f"differs from the kernel layout ({ref.dtype})")
        del views
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


def rotated_ms(timers: dict, rounds: int) -> dict:
    """The median of each timer's samples (a timer: a function returning
    one sample in ms) over ``rounds`` rounds of one sample each, the order
    rotated by one a round, so that no timer always runs first."""
    names = list(timers)
    samples = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            samples[n].append(timers[n]())
    return {n: statistics.median(x) for n, x in samples.items()}


def flash_record(qkv, causal, bf16_rate):
    """Kernel #11 at one shape, q, k, v in the model's layout ([B, S, H,
    D], as the serving path hands them over): the kernel's time on them
    with the bf16 output the model path asks for (``ms``) and with a
    float32 output, on their kernel-layout copies, through the
    kernel-layout wrapper, through the model's call
    (``models.attention.flash_attention``, ``model_layout_ms``),
    ``F.scaled_dot_product_attention``'s on the same tensors as [B, H, S,
    D] views (``library_ms``) and on contiguous [B, H, S, D] copies, its
    plain version's, and the bound: bytes (inputs read once, the bf16
    output written once) over the HBM rate, FLOP (4 a query-key pair a head
    dimension, unmasked pairs only) over the dense bf16 rate. Each time is
    one call between two events after a warm-up, as every row of the
    ``kernels`` line is timed; ``back_to_back`` holds the same calls'
    share of ``FLASH_BATCH`` calls back to back (the card's time, as a
    prefill's 40 layers see it, without the host's launch gap);
    ``host_issue`` the host's ms to issue one call of the kernel, the
    model's call and the library's (its clock over ``FLASH_BATCH`` calls,
    the card behind it), what a host-paced prefill pays for each. The
    timings run in rotated order (:func:`rotated_ms`), the median of
    ``FLASH_ROUNDS`` samples each."""
    import torch.nn.functional as F

    q, k, v = qkv
    B, S, H, D = q.shape
    views = bshd_views(q, k, v)
    qk, kk, vk = to_kernel_layout(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device="cuda")
    out32 = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    kl_out = torch.empty(qk.shape, dtype=q.dtype, device="cuda")
    contiguous = [t.transpose(1, 2).contiguous() for t in qkv]
    variant = K.check_flash_kernel(q, k, v)
    scale = 1.0 / D ** 0.5

    def launch(args, o):
        return lambda: flash_attention_launch(
            *args, o, causal=causal, window=None, scale=scale, q_offset=0,
            variant=variant)

    def out_view(o):
        return o.unflatten(2, views[0].shape[1:3]).permute(0, 2, 3, 1, 4)

    calls = {
        "ms": launch(views, out_view(out)),
        "ms_out_float32": launch(views, out_view(out32)),
        "ms_kernel_layout": launch((qk[:, None], kk[:, None], vk[:, None]),
                                   kl_out[:, None]),
        "wrapper_ms": lambda: K.flash_attention(qk, kk, vk, causal=causal,
                                                out_dtype=q.dtype),
        "model_layout_ms": lambda: attention.flash_attention(
            q, k, v, causal=causal, out_dtype=q.dtype),
        "library_ms": lambda: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in qkv), is_causal=causal),
        "library_contiguous_ms": lambda: F.scaled_dot_product_attention(
            *contiguous, is_causal=causal),
    }

    def single(fn):
        return lambda: cuda_ms(fn, reps=1)

    def back_to_back(fn):
        return lambda: cuda_ms(lambda: [fn() for _ in range(FLASH_BATCH)],
                               reps=1) / FLASH_BATCH

    def host(fn):
        def sample():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FLASH_BATCH):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / FLASH_BATCH
            torch.cuda.synchronize()
            return ms
        return sample

    issued = ("ms", "model_layout_ms", "library_ms")
    timers = {n: single(fn) for n, fn in calls.items()}
    timers.update({"back_to_back " + n: back_to_back(fn)
                   for n, fn in calls.items()})
    timers.update({"host " + n: host(calls[n]) for n in issued})
    times = rotated_ms(timers, FLASH_ROUNDS)
    plain_ms = cuda_ms(lambda: flash_attention_plain(qk, kk, vk, causal=causal),
                       reps=3)
    del out32, kl_out, contiguous, qk, kk, vk
    nbytes = roofline.attention_bytes(q, k, v, out)
    flops = roofline.attention_flops(B * H, S, k.shape[1], D, v.shape[-1],
                                     causal=causal)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / bf16_rate * 1e3
    b2b = {n: times["back_to_back " + n] for n in calls}
    return {"shape": [list(q.shape), list(k.shape), list(v.shape)],
            "dtype": str(q.dtype), "out_dtype": str(out.dtype),
            "causal": causal, "variant": variant,
            **{n: times[n] for n in calls}, "back_to_back": b2b,
            "host_issue": {n: times["host " + n] for n in issued},
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_flops": flops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "tflops_per_s": flops / (times["ms"] * 1e-3) / 1e12,
            "tflops_per_s_back_to_back": flops / (b2b["ms"] * 1e-3) / 1e12}


def flash_attention_vs_plain(gen, layer0, bf16_rate):
    """Phase 8b (see the module docstring). Returns the kernel's record
    for the ``kernels`` line (without its launches)."""
    t0 = time.perf_counter()
    errs = {}
    H = layer0[0].shape[2]
    cases = [("serving layer 0 (captured)", *to_kernel_layout(*layer0), True,
              None, 0, layer0[1].shape[2])]
    cases += flash_cases(gen)
    for label, *args in cases:
        errs[label] = flash_check(label, *args)
    del cases
    serving = flash_record(layer0, True, bf16_rate)
    # The long prefill at unit scale: its first 512 rows over their keys,
    # and its last 256 rows over all 8192 keys (a long row's values are
    # small; the row measure still sees a dropped key).
    S = LONG_PREFILL
    lq, lk, lv = (torch.randn((H, 1, S, 128) if i == 0 else (H, S, 128),
                              generator=gen, device="cuda")
                  .to(torch.bfloat16) for i in range(3))
    errs["long prefill, first 512 rows"] = flash_check(
        "long prefill, first 512 rows", lq[:, :, :512].contiguous(),
        lk[:, :512].contiguous(), lv[:, :512].contiguous(), True, None, 0, H)
    errs["long prefill, last 256 rows"] = flash_check(
        "long prefill, last 256 rows", lq[:, :, S - 256:].contiguous(), lk,
        lv, True, None, S - 256, H)
    long = flash_record([t.reshape(1, H, S, 128).transpose(1, 2).contiguous()
                         for t in (lq, lk, lv)], True, bf16_rate)
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
                                       "model_layout_ms", "ms_kernel_layout",
                                       "library_contiguous_ms",
                                       "back_to_back", "host_issue",
                                       "variant")},
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
    engine run, layer 0's q/k/v from a full-width prefill, [B, S, H, D]
    as the model hands them to the kernel)."""
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
    guard = engine.prefix_cache.filter
    check(isinstance(guard, amq.CascadeHandle),
          f"serve: the guard filter is a {type(guard).__name__}, not the "
          "auto-expanding cascade")
    guard_levels = level_rows(guard.report())
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
    _, prefill_profile = profiled(lambda: model.prefill(tokens), top=25)
    # Kernel #11's share of the profiled prefill, from the kernel table.
    flash_rows = [r for r in prefill_profile["top_kernels"]
                  if "flash_" in r["kernel"]]
    prefill_profile["flash_attention"] = {
        "calls": sum(r["calls"] for r in flash_rows),
        "device_ms": sum(r["device_ms"] for r in flash_rows)}
    _, decode_profile = profiled(
        lambda: model.decode_step(tok, caches, SERVE_PROMPT + SERVE_STEPS - 1))
    del caches, logits

    # --- the guard filter's lookups alone: wall and host syncs ------------
    pc = PrefixCache(SERVE_ENTRIES, device="cuda")
    lookup_s, syncs = [], []
    for i in SERVE_SEQUENCE:
        flat = pool[i].reshape(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit, n_syncs, _ = host_syncs(lambda: pc.lookup(flat))
        torch.cuda.synchronize()
        lookup_s.append(time.perf_counter() - t0)
        syncs.append(n_syncs)
        if hit is None:
            pc.insert(flat, i)
    check(pc.stats == stats, f"serve: guard-filter replay {pc.stats}")

    # --- layer 0's q/k/v for the kernel phase: the first call of one
    # prefill, through a wrapper around the model's entry point ------------
    captured, calls = [], [0]
    kernel = K.flash_attention_bshd

    def capture(q, k, v, **kw):
        calls[0] += 1
        if not captured:
            captured.append((q, k, v))
        return kernel(q, k, v, **kw)

    K.flash_attention_bshd = capture
    try:
        model.prefill(tokens)
    finally:
        K.flash_attention_bshd = kernel
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
          "filter_slo": slo, "guard_levels": guard_levels,
          "guard_lookup_seconds": lookup_s,
          "guard_lookup_host_syncs": syncs,
          "cache_entry_bytes": entry_bytes,
          "max_memory_allocated": peak, "memory_held_after": held,
          "bf16_flops_per_s": bf16_rate,
          "profile_prefill": prefill_profile,
          "profile_decode_step": decode_profile,
          "seconds": time.perf_counter() - t_start})
    return launches, layer0


# ---------------------------------------------------------------------------
# The lifecycle: snapshots, the auto-expanding cascade, the GPU-hot /
# host-cold tiered handle, hot swap with migration (DESIGN.md §8, §10, §12).
# ---------------------------------------------------------------------------

def synced(fn):
    """(``fn()``, its wall seconds between two device synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def level_ranges(levels):
    """Each level's [lo, hi) slice of the key stream: a cascade fed in
    order, every key placed, holds contiguous runs, oldest first."""
    lo, out = 0, []
    for lv in levels:
        out.append((lo, lo + lv.count()))
        lo += lv.count()
    return out


def cleared_codes(cfg, before, after, label: str):
    """Sorted (pair, tag) codes of the lanes a delete cleared; any other
    changed lane fails."""
    codes = []
    for b0 in range(0, cfg.num_buckets, CHUNK):
        b1 = min(b0 + CHUNK, cfg.num_buckets)
        tb = bucket_lanes(cfg, before, b0, b1)
        ta = bucket_lanes(cfg, after, b0, b1)
        cleared = (tb != 0) & (ta == 0)
        check(not bool(((ta != tb) & ~cleared).any()),
              f"{label}: a lane other than a cleared one changed")
        bucket = torch.arange(b0, b1, device=before.device)[:, None].expand_as(
            tb)[cleared]
        tag = tb[cleared]
        alt = cfg.placement.alt_bucket(bucket, tag)
        codes.append((torch.minimum(bucket, alt) << cfg.fp_bits) | tag)
    return torch.sort(torch.cat(codes)).values


def snapshot_part(h, stored, gen, tmp) -> dict:
    """The main path's handle through ``snapshot`` -> ``save_snapshot`` ->
    ``load_snapshot`` -> ``make(snapshot=)``, each step timed."""
    snap, snap_s = synced(h.snapshot)
    nbytes = snap.nbytes
    path = os.path.join(tmp, "filter.npz")
    _, save_s = synced(lambda: amq.save_snapshot(path, snap))
    loaded, load_s = synced(lambda: amq.load_snapshot(path))
    os.remove(path)
    twin, restore_s = synced(lambda: amq.make("cuckoo", config=h.config,
                                              snapshot=loaded))
    _, memory_restore_s = synced(lambda: amq.make("cuckoo", config=h.config,
                                                  snapshot=snap))
    check(torch.equal(twin.state.table, h.state.table),
          "lifecycle: the restored table differs from the original")
    check(twin.count() == h.count(), "lifecycle: the restored count")
    fresh = normalize_keys(random_keys(gen, PROBES, top_half=True))
    for label, keys in (("stored", stored), ("fresh", fresh)):
        hits = h.query(keys).hits
        check(torch.equal(twin.query(keys).hits, hits),
              f"lifecycle: the twin answers {label} keys otherwise")
        if label == "stored":
            check(bool(hits.all()), "lifecycle: stored keys missed")
    kept = snap.arrays["table"].copy()
    before = h.state.table.clone()
    check(bool(twin.insert(fresh[:1 << 20]).ok.all()),
          "lifecycle: the twin's insert")
    torch.cuda.synchronize()
    check(torch.equal(h.state.table, before)
          and np.array_equal(snap.arrays["table"], kept)
          and np.array_equal(loaded.arrays["table"], kept),
          "lifecycle: an insert into the twin reached the original or the "
          "snapshot")
    other = dataclasses.replace(h.config, seed=h.config.seed + 1)
    try:
        amq.make("cuckoo", config=other, snapshot=snap)
        check(False, "lifecycle: a snapshot restored under another "
                     "fingerprint")
    except amq.SnapshotMismatchError:
        pass
    del twin, before, kept
    return {"bytes": nbytes, "snapshot_s": snap_s,
            "snapshot_gb_per_s": nbytes / snap_s / 1e9,
            "save_s": save_s, "load_s": load_s, "restore_s": restore_s,
            "restore_gb_per_s": nbytes / restore_s / 1e9,
            "restore_from_memory_s": memory_restore_s,
            "restore_from_memory_gb_per_s": nbytes / memory_restore_s / 1e9}


def hot_swap_part(h, stored, gen) -> dict:
    """The main path's handle under a FilterService: acknowledged inserts,
    then ``hot_swap`` to a fresh handle of its config (migration)."""
    svc = amq.FilterService(h, batch_size=LIFE_RECORD_PROBES)
    acked = normalize_keys(random_keys(gen, LIFE_RECORD_PROBES,
                                       top_half=True))
    ticket = svc.insert(acked)
    new = amq.make("cuckoo", config=h.config)
    rec = svc.hot_swap(new)
    check(rec["migrated"] and svc.handle is new and bool(ticket.result().all()),
          f"lifecycle: hot swap {rec}")
    check(bool(new.query(acked).hits.all())
          and bool(new.query(stored).hits.all())
          and torch.equal(new.state.table, h.state.table),
          "lifecycle: an acknowledged key is missing after the hot swap")
    after = svc.query(acked[:LIFE_RECORD_PROBES // 16]).result()
    check(bool(after.all()), "lifecycle: the service after the swap")
    del new
    return {"acknowledged_keys": acked.shape[0], **rec}


def fill_levels(h, keys, label: str) -> list:
    """``keys`` into cascade ``h`` in batches of LIFE_BATCH: each batch's
    seconds, keys/s, host syncs and levels; every key placed."""
    per_batch = []
    for b0 in range(0, keys.shape[0], LIFE_BATCH):
        batch = keys[b0:b0 + LIFE_BATCH]
        (rep, syncs, _), dt = synced(lambda: host_syncs(
            lambda: h.insert(batch)))
        check(bool(rep.ok.all()), f"{label}: batch at {b0}: "
                                  f"{int((~rep.ok).sum())} keys not placed")
        per_batch.append({"keys": batch.shape[0], "s": dt,
                          "keys_per_s": batch.shape[0] / dt,
                          "host_syncs": syncs, "levels": len(h.levels)})
    check(h.count() == keys.shape[0], f"{label}: count {h.count()}")
    return per_batch


def level_rows(report) -> list:
    return [dict(s._asdict()) for s in report.levels]


def cascade_part(keys, gen, tmp) -> dict:
    """``make("cuckoo", auto_expand=True)`` at the lifecycle's sizes."""
    c = amq.make("cuckoo", capacity=LIFE_CAPACITY, auto_expand=True)
    per_batch = fill_levels(c, keys, "cascade")
    report = c.report()
    slots = [lv.config.num_slots for lv in c.levels]
    check(slots == [LIFE_BATCH << i for i in range(4)]
          and [lv.config.fp_bits for lv in c.levels] == [16, 16, 32, 32],
          f"cascade: levels {level_rows(report)}")
    for lv in c.levels:
        check(lv.count() <= int(c.watermark * lv.config.num_slots),
              f"cascade: a level past its watermark: {level_rows(report)}")
    ranges = level_ranges(c.levels)
    for i, (lv, (lo, hi)) in enumerate(zip(c.levels, ranges)):
        check_codes(f"cascade: level {i} after the fill",
                    table_codes(lv.config, lv.state.table),
                    key_codes(lv.config, [keys[lo:hi]]))
    misses = sum(int((~c.query(keys[b0:b0 + LIFE_BATCH]).hits).sum())
                 for b0 in range(0, keys.shape[0], LIFE_BATCH))
    check(misses == 0, f"cascade: {misses} false negatives")
    fresh = normalize_keys(random_keys(gen, PROBES, top_half=True))
    fpr = fpr_of("cascade", c.query(fresh).hits, report.expected_fpr)

    # One query call of 2^24 stored keys: one #2 launch a live level.
    probe = keys[torch.randperm(keys.shape[0], device=keys.device,
                                generator=gen)[:PROBES]]
    c.query(probe)
    K.reset_launches()
    (qr, q_syncs, _), q_s = synced(lambda: host_syncs(lambda: c.query(probe)))
    q_launches = dict(K.LAUNCHES)
    check(bool(qr.hits.all()) and q_launches["cuckoo_query"] == len(c.levels),
          f"cascade: query launches {q_launches}")
    level_ms = [cuda_ms(lambda lv=lv: K.cuckoo_query(lv.config, lv.state,
                                                     probe))
                for lv in c.levels]

    # 2^24 deletes drawn from all four levels.
    gone = torch.randperm(keys.shape[0], device=keys.device,
                          generator=gen)[:LIFE_BATCH]
    dkeys = keys[gone]
    befores = [lv.state.table.clone() for lv in c.levels]
    counts = [lv.count() for lv in c.levels]
    (dr, d_syncs, _), d_s = synced(lambda: host_syncs(lambda: c.delete(dkeys)))
    check(bool(dr.ok.all()), f"cascade: {int((~dr.ok).sum())} deletes failed")
    check(c.count() == keys.shape[0] - LIFE_BATCH, "cascade: count after "
                                                   "the deletes")
    removed = 0
    for i, (lv, before) in enumerate(zip(c.levels, befores)):
        codes = cleared_codes(lv.config, before, lv.state.table,
                              f"cascade: level {i} delete")
        removed += codes.shape[0]
        check(codes.shape[0] == counts[i] - lv.count(),
              f"cascade: level {i}'s count and its cleared lanes")
        # Every cleared lane held a deleted key's code under the level's
        # config (a delete routed by a false positive of a newer level
        # clears a tag of the same code there).
        want = key_codes(lv.config, [dkeys])
        at = torch.searchsorted(want, codes).clamp(max=want.shape[0] - 1)
        check(bool((want[at] == codes).all()),
              f"cascade: level {i} cleared a tag no deleted key carries")
    check(removed == LIFE_BATCH, f"cascade: {removed} lanes cleared")
    del befores
    left = c.query(dkeys).hits
    gone_fpr = fpr_of("cascade: deleted keys", left, c.expected_fpr())
    # compact() after draining level 0 drops it.
    lo, hi = ranges[0]
    rest = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    rest[gone] = False
    drain = keys[lo:hi][rest[lo:hi]]
    n0 = c.levels[0].count()
    dr0 = c.delete(drain)
    check(bool(dr0.ok.all()), "cascade: draining level 0")
    # Keys of level 0 lost to deletes routed by false positives elsewhere.
    leftover = c.levels[0].count()
    if leftover:
        c.levels[0].delete(keys[lo:hi])
    check(c.levels[0].count() == 0, f"cascade: level 0 holds {leftover} "
                                    "tags after its drain")
    compacted = c.compact()
    check(compacted.num_levels == 3 and c.level_alloc_ids == (1, 2, 3),
          f"cascade: compact {level_rows(compacted)}")
    # A cascade snapshot round trip through a file.
    snap, snap_s = synced(c.snapshot)
    path = os.path.join(tmp, "cascade.npz")
    _, save_s = synced(lambda: amq.save_snapshot(path, snap))
    loaded, load_s = synced(lambda: amq.load_snapshot(path))
    os.remove(path)
    twin, restore_s = synced(lambda: amq.make(
        "cuckoo", capacity=LIFE_CAPACITY, auto_expand=True, snapshot=loaded))
    mixed = torch.cat([keys[hi:hi + PROBES // 2], fresh[:PROBES // 2]])
    check(torch.equal(twin.query(mixed).hits, c.query(mixed).hits)
          and twin.count() == c.count(),
          "cascade: the snapshot's twin answers otherwise")
    out = {"levels": level_rows(report), "insert_batches": per_batch,
           "insert_keys_per_s": keys.shape[0] / sum(
               r["s"] for r in per_batch),
           "query_keys": PROBES, "query_s": q_s,
           "query_keys_per_s": PROBES / q_s, "query_host_syncs": q_syncs,
           "query_launches": q_launches, "query_kernel_ms_by_level": level_ms,
           "delete_keys": LIFE_BATCH, "delete_s": d_s,
           "delete_keys_per_s": LIFE_BATCH / d_s,
           "delete_host_syncs": d_syncs, "deleted_keys_hit_after": gone_fpr,
           "level0_drained": n0, "level0_leftover_tags": leftover,
           "fpr": fpr, "snapshot_bytes": snap.nbytes,
           "snapshot_s": snap_s, "save_s": save_s, "load_s": load_s,
           "restore_s": restore_s,
           "levels_after_compact": level_rows(compacted)}
    del c, twin, snap, loaded
    return out


def tiered_part(keys, gen, tmp) -> dict:
    """``make("cuckoo", tiered=True, device_budget_bytes=2^28)``."""
    t = amq.make("cuckoo", capacity=LIFE_CAPACITY, tiered=True,
                 device_budget_bytes=LIFE_BUDGET)
    fresh = normalize_keys(random_keys(gen, LIFE_RECORD_PROBES // 2,
                                       top_half=True))
    probe = torch.cat([keys[::keys.shape[0] // (LIFE_RECORD_PROBES // 2)],
                       fresh])
    answers = {}
    demote = t.demote

    def recording_demote():
        """Each level's device answers on ``probe``, just before it goes."""
        if len(t.hot.levels) > 1:
            answers[t.hot.level_alloc_ids[0]] = t.hot.levels[0].query(
                probe).hits.cpu().numpy()
        return demote()

    t.demote = recording_demote
    per_batch = fill_levels(t, keys, "tiered")
    del t.demote
    stats = t.tier_stats()
    check(stats["cold_levels"] == 3 and stats["hot_levels"] == 1
          # 2^24 slots at fp 16, 2^25 at fp 16, 2^26 at fp 32: 352 MiB.
          and stats["host_bytes"] == 22 * LIFE_BATCH
          and t.device_bytes <= t.device_budget_bytes,
          f"tiered: tiers after the fill {stats}")
    check(all(lv.config.num_slots <= 4 * LIFE_BATCH for lv in t.hot.levels)
          and all(c.config.num_slots <= 4 * LIFE_BATCH for c in t.cold),
          "tiered: a level above the clamp")
    host_ms = []
    for c in t.cold:
        got, dt = synced(lambda c=c: amq.get("cuckoo").host_query(
            c.config, c.arrays, probe, device=t.device))
        host_ms.append(dt * 1e3)
        check(np.array_equal(got, answers[c.alloc_id]),
              f"tiered: level {c.alloc_id}'s host probe differs from its "
              "device answers")
    # 2^22 stored keys from both tiers, the hot and cold parts timed apart.
    draw = keys[torch.randperm(keys.shape[0], device=keys.device,
                               generator=gen)[:LIFE_COLD_PROBES]]
    hot, hot_s = synced(lambda: t.hot.query(draw))
    missed_hot = int((~hot.hits).sum())
    probes_before = t.tier_stats()["cold_probe_keys"]
    (qr, q_syncs, _), q_s = synced(lambda: host_syncs(lambda: t.query(draw)))
    check(bool(qr.hits.all()), f"tiered: {int((~qr.hits).sum())} of "
                               f"{LIFE_COLD_PROBES} stored keys missed")
    cold_probed = t.tier_stats()["cold_probe_keys"] - probes_before
    check(cold_probed == missed_hot,
          f"tiered: {cold_probed} keys probed cold, {missed_hot} missed "
          "the hot tier")
    # 2^10 deletes of cold keys (level 0's, the oldest).
    cold_keys = keys[:LIFE_COLD_DELETES]
    cold_before = sum(c.count for c in t.cold)
    (dr, d_syncs, _), d_s = synced(lambda: host_syncs(
        lambda: t.delete(cold_keys)))
    check(bool(dr.ok.all()) and t.count() == keys.shape[0] - LIFE_COLD_DELETES
          and sum(c.count for c in t.cold) == cold_before - LIFE_COLD_DELETES,
          "tiered: cold deletes")
    gone = fpr_of("tiered: deleted cold keys", t.query(cold_keys).hits,
                  t.expected_fpr())
    check(t.device_bytes <= t.device_budget_bytes, "tiered: over budget")
    check(t.promote(force=True) and t.device_bytes > t.device_budget_bytes,
          "tiered: promote(force=True)")
    action = t.maintain()
    check(action["action"] == "demote"
          and t.device_bytes <= t.device_budget_bytes,
          f"tiered: maintain after promote {action}")
    snap, snap_s = synced(t.snapshot)
    path = os.path.join(tmp, "tiered.npz")
    _, save_s = synced(lambda: amq.save_snapshot(path, snap))
    loaded, load_s = synced(lambda: amq.load_snapshot(path))
    os.remove(path)
    twin, restore_s = synced(lambda: amq.make(
        "cuckoo", capacity=LIFE_CAPACITY, tiered=True, snapshot=loaded))
    few = probe[::16]            # half stored, half fresh: cold probes
    check(twin.count() == t.count()
          and torch.equal(twin.query(few).hits, t.query(few).hits),
          "tiered: the snapshot's twin answers otherwise")
    out = {"insert_batches": per_batch,
           "insert_keys_per_s": keys.shape[0] / sum(
               r["s"] for r in per_batch),
           "tiers": level_rows(t.report()), "tier_stats": t.tier_stats(),
           "recorded_levels": sorted(answers),
           "host_probe_ms_by_cold_level": host_ms,
           "host_probe_keys": probe.shape[0],
           "query_keys": LIFE_COLD_PROBES, "query_s": q_s,
           "query_host_syncs": q_syncs, "hot_query_s": hot_s,
           "cold_probe_keys": missed_hot, "cold_part_s": q_s - hot_s,
           "delete_keys": LIFE_COLD_DELETES, "delete_s": d_s,
           "delete_host_syncs": d_syncs, "deleted_keys_hit_after": gone,
           "snapshot_bytes": snap.nbytes, "snapshot_s": snap_s,
           "save_s": save_s, "load_s": load_s, "restore_s": restore_s}
    del t, twin, snap, loaded
    return out


def bloom_cascade_part(gen) -> dict:
    """``make("bloom", auto_expand=True)`` filled with 2^26 keys."""
    b = amq.make("bloom", capacity=LIFE_CAPACITY, auto_expand=True)
    keys = normalize_keys(random_keys(gen, LIFE_BLOOM_KEYS))
    K.reset_launches()
    per_batch = fill_levels(b, keys, "bloom cascade")
    misses = sum(int((~b.query(keys[b0:b0 + LIFE_BATCH]).hits).sum())
                 for b0 in range(0, keys.shape[0], LIFE_BATCH))
    check(misses == 0, f"bloom cascade: {misses} false negatives")
    launches = dict(K.LAUNCHES)
    check(launches["bloom_insert"] > 0 and launches["bloom_query"] > 0,
          f"bloom cascade: launches {launches}")
    report = b.report()
    fresh = normalize_keys(random_keys(gen, PROBES, top_half=True))
    return {"levels": level_rows(report),
            "sizings": [{"bits_per_key": lv.config.bits_per_key,
                         "k": lv.config.k} for lv in b.levels],
            "insert_batches": per_batch, "launches": launches,
            **fpr_of("bloom cascade", b.query(fresh).hits,
                     report.expected_fpr)}


def lifecycle(h, stored, gen) -> None:
    """The lifecycle phase on the main path's handle and on fresh cascades;
    see the module docstring."""
    t_start = time.perf_counter()
    rec, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, part in (
                ("snapshots", lambda: snapshot_part(h, stored, gen, tmp)),
                ("hot_swap", lambda: hot_swap_part(h, stored, gen))):
            t0 = time.perf_counter()
            rec[name] = part()
            seconds[name] = time.perf_counter() - t0
        keys = normalize_keys(random_keys(gen, LIFE_KEYS))
        for name, part in (("cascade", lambda: cascade_part(keys, gen, tmp)),
                           ("tiered", lambda: tiered_part(keys, gen, tmp)),
                           ("bloom_cascade", lambda: bloom_cascade_part(gen))):
            t0 = time.perf_counter()
            rec[name] = part()
            seconds[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    del keys
    emit({"phase": "lifecycle", **rec, "seconds_by_part": seconds,
          "seconds": time.perf_counter() - t_start})


# ---------------------------------------------------------------------------
# The baselines (paper §5.1): the two-choice filter (TCF), the quotient
# filter (GQF, its serial insert and delete kernels G1 / G2) and the
# bucketed cuckoo hash table (BCHT) at the card's sizes, each beside a
# cuckoo handle of its capacity filled and probed the same way.
# ---------------------------------------------------------------------------

def sizes_of(total: int, batch: int):
    return [min(batch, total - s) for s in range(0, total, batch)]


def rates(insert_s, inserted, query_s, queried, delete_s, deleted) -> dict:
    return {"insert_keys_per_s": inserted / insert_s,
            "query_keys_per_s": queried / query_s,
            "delete_keys_per_s": deleted / delete_s}


def fill_baseline(h, label, batches, module=None, on_batch=None):
    """Insert ``batches`` through ``h.insert``: per batch seconds, keys/s,
    host syncs, the peak of allocated memory and, where ``module`` records
    them, rounds and the keys turned down by cause. Returns (ok of every
    key, seconds, per-batch records). ``on_batch(b)`` runs before batch b,
    outside the clock."""
    oks, per_batch, insert_s = [], [], 0.0
    for b, keys in enumerate(batches):
        if on_batch is not None:
            on_batch(b)
        recs = []
        if module is not None:
            module.INSERT_RECORDS = recs
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rep, syncs, _ = host_syncs(lambda: h.insert(keys))
            torch.cuda.synchronize()
        finally:
            if module is not None:
                module.INSERT_RECORDS = None
        dt = time.perf_counter() - t0
        insert_s += dt
        oks.append(rep.ok)
        m = keys.shape[0]
        row = {"keys": m, "s": dt, "keys_per_s": m / dt, "host_syncs": syncs,
               "placed": int(rep.ok.sum()), "load": h.load_factor,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        for r in recs:
            row.update({k: int(v) for k, v in r.items()})
        per_batch.append(row)
    ok = torch.cat(oks)
    check(h.count() == int(ok.sum()),
          f"{label}: count {h.count()} != {int(ok.sum())} keys placed")
    return ok, insert_s, per_batch


def query_batches(h, batches):
    """Hits of every batch and the median seconds of a full-size batch."""
    full = max(k.shape[0] for k in batches)
    hits, secs = [], []
    for keys in batches:
        out, dt = synced(lambda: h.query(keys).hits)
        hits.append(out)
        if keys.shape[0] == full:
            secs.append(dt)
    return torch.cat(hits), statistics.median(secs)


def stored_delete(h, keys, label):
    """Delete ``keys`` in one call -> (ok, seconds); ``count`` must fall by
    the keys deleted ``ok``."""
    before = h.count()
    rep, dt = synced(lambda: h.delete(keys))
    check(before - h.count() == int(rep.ok.sum()),
          f"{label}: count fell by {before - h.count()}, not "
          f"{int(rep.ok.sum())}")
    return rep.ok, dt


def fpr_band(h, gen, label):
    fresh = random_keys(gen, PROBES, top_half=True)
    fpr = int(h.query(fresh).hits.sum()) / PROBES
    expected = h.expected_fpr()
    lo, hi = amq.fpr_tolerance(expected, PROBES)
    check(lo <= fpr <= hi, f"{label}: FPR {fpr} outside [{lo}, {hi}] "
                           f"(expected {expected})")
    return {"fpr": fpr, "fpr_expected": expected, "fpr_band": [lo, hi]}


def cuckoo_beside(capacity, batches, delete_keys, label):
    """A ``cuckoo`` handle of ``capacity`` filled, queried and deleted as a
    baseline is: every key placed."""
    h = amq.make("cuckoo", capacity=capacity)
    ok, insert_s, _ = fill_baseline(h, label, batches)
    load = h.load_factor
    check(bool(ok.all()), f"{label}: {int((~ok).sum())} keys not placed")
    hits, query_s = query_batches(h, batches)
    check(bool(hits.all()), f"{label}: false negatives")
    del_ok, delete_s = stored_delete(h, delete_keys, label)
    check(bool(del_ok.all()), f"{label}: deletes failed")
    full = max(k.shape[0] for k in batches)
    return {"config": repr(h.config), "load": load,
            **rates(insert_s, ok.shape[0], query_s, full, delete_s,
                    delete_keys.shape[0])}


def tcf_part(gen, cuckoo_rates) -> dict:
    """The TCF at 2^28 slots (its defaults: fp 16, blocks of 32, a stash of
    128), filled in the main path's batches; its cuckoo is phase 2's."""
    K.reset_launches()
    h = amq.make("tcf", capacity=FULL_CAPACITY)
    cfg = h.config
    batches = [normalize_keys(random_keys(gen, m))
               for m in batch_sizes(FULL_CAPACITY)]
    ok, insert_s, per_batch = fill_baseline(h, "tcf", batches, TCm)
    load = h.load_factor
    failed = int((~ok).sum())
    dead = sum(r["dead"] for r in per_batch)
    expired = sum(r["expired"] for r in per_batch)
    check(failed == dead + expired,
          f"tcf: {failed} keys turned down, {dead} with both blocks and the "
          f"stash full, {expired} out of max_rounds")
    check(all(r["expired"] == 0 or r["rounds"] == cfg.max_rounds
              for r in per_batch), "tcf: keys expired before max_rounds")
    hits, query_s = query_batches(h, batches)
    fn = int((ok & ~hits).sum())
    check(fn == 0, f"tcf: {fn} false negatives among ok keys")
    band = fpr_band(h, gen, "tcf")
    # 2^24 stored keys deleted. A delete takes the first copy of its tag
    # in its first block, which may be a key's of the same tag and block
    # (the TCF's false delete, the JAX package's tests allow it); a delete
    # then fails only where another deleted key took its copy.
    stored = batches[0][ok[:batches[0].shape[0]]]
    del_ok, delete_s = stored_delete(h, stored, "tcf")
    tag, b1, b2 = TCm._prepare(cfg, stored)
    codes = torch.cat([(b1 << 32) | tag, (b2 << 32) | tag])
    took = torch.cat([del_ok, del_ok])
    taken = torch.isin(codes[:stored.shape[0]][~del_ok], codes[took]) | \
        torch.isin(codes[stored.shape[0]:][~del_ok], codes[took])
    check(bool(taken.all()),
          f"tcf: {int((~taken).sum())} failed deletes no deleted key of the "
          "same tag and block explains")
    launches = check_launches("tcf", ["hash64"])
    return {"config": repr(cfg), "slots": cfg.num_slots,
            "table_bytes": cfg.table_bytes, "load": load,
            "batches": per_batch, "failed": failed, "dead": dead,
            "expired": expired, "false_negatives": fn, **band,
            "deleted": stored.shape[0], "delete_failed": int((~del_ok).sum()),
            "count_after_delete": h.count(), "launches": launches,
            **rates(insert_s, ok.shape[0], query_s, batches[0].shape[0],
                    delete_s, stored.shape[0]),
            "cuckoo": cuckoo_rates}


def bcht_part(gen) -> dict:
    """The BCHT at 2^28 slots (2^24 buckets of 16, load 0.9) in 15 batches,
    and a ``cuckoo`` handle of its capacity beside it."""
    h = amq.make("bcht", capacity=BCHT_CAPACITY)
    cfg = h.config
    batches = [normalize_keys(random_keys(gen, m))
               for m in sizes_of(BCHT_CAPACITY, 1 << 24)]
    ok, insert_s, per_batch = fill_baseline(h, "bcht", batches, HTm)
    load = h.load_factor
    failed = int((~ok).sum())
    hits, query_s = query_batches(h, batches)
    fn = int((ok & ~hits).sum())
    check(fn <= failed, f"bcht: {fn} false negatives among ok keys, more "
                        f"than the {failed} failed (R7)")
    fresh = random_keys(gen, PROBES, top_half=True)
    fp = int(h.query(fresh).hits.sum())
    check(fp == 0, f"bcht: {fp} false positives (exact membership)")
    first = batches[0]
    keep = (ok & hits)[:first.shape[0]]
    stored = first[keep]
    del_ok, delete_s = stored_delete(h, stored, "bcht")
    check(bool(del_ok.all()), f"bcht: {int((~del_ok).sum())} deletes failed")
    gone = int(h.query(stored).hits.sum())
    check(gone == 0, f"bcht: {gone} deleted keys still answer True")
    rec = {"config": repr(cfg), "slots": cfg.num_slots,
           "table_bytes": cfg.table_bytes, "load": load,
           "batches": per_batch, "failed": failed, "false_negatives": fn,
           "false_positives": fp, "deleted": stored.shape[0],
           **rates(insert_s, ok.shape[0], query_s, first.shape[0], delete_s,
                   stored.shape[0])}
    del h
    torch.cuda.empty_cache()
    rec["cuckoo"] = cuckoo_beside(BCHT_CAPACITY, batches, stored,
                                  "bcht: cuckoo")
    return rec


def serial_spans(cfg, before, home, rem, insert: bool):
    """The slots each key of a serial batch scans at least, from ``home``:
    an insert up to the first empty slot of the table as the batch found
    it (the batch only fills slots), a delete up to its match in the
    window (its whole window where none)."""
    m = cfg.num_slots
    if insert:
        empty = (before == 0).nonzero().squeeze(1)
        if empty.numel() == 0:
            return torch.full_like(home, cfg.max_probe)
        ext = torch.cat([empty, empty[:1] + m])
        nxt = ext[torch.searchsorted(ext, home).clamp_(max=ext.shape[0] - 1)]
        return (nxt - home).clamp_(max=cfg.max_probe)
    offs = torch.arange(cfg.max_probe, device=home.device)
    spans = []
    for s in range(0, home.shape[0], 1 << 20):
        window = from_i32(before[(home[s:s + (1 << 20), None] + offs) % m])
        match = (((window & cfg.rmask) == rem[s:s + (1 << 20), None])
                 & ((window >> cfg.remainder_bits) == offs))
        spans.append(torch.where(match.any(dim=1),
                                 match.to(torch.uint8).argmax(dim=1),
                                 cfg.max_probe - 1))
    return torch.cat(spans)


def serial_bound(cfg, before, after, home, rem, insert: bool) -> dict:
    """A bytes bound of a serial batch: each slot its probe runs scan at
    least (:func:`serial_spans`) and each slot it changed read once, each
    changed slot written once, and the keys' rem, home, valid and ok."""
    m = cfg.num_slots
    span = serial_spans(cfg, before, home, rem, insert)
    cover = torch.zeros(2 * m + 1, dtype=torch.int32, device=home.device)
    cover.index_add_(0, home, torch.ones_like(home, dtype=torch.int32))
    cover.index_add_(0, home + span + 1,
                     -torch.ones_like(home, dtype=torch.int32))
    covered = torch.cumsum(cover, 0, dtype=torch.int32)[:2 * m] > 0
    changed = before != after
    read = int((covered[:m] | covered[m:] | changed).sum())
    written = int(changed.sum())
    n = home.shape[0]
    nbytes = 4 * read + 4 * written + 10 * n
    return {"slots_read": read, "slots_written": written,
            "mean_span": float(span.float().mean()) + 1, "bound_bytes": nbytes,
            # ~8 integer instructions a slot a probe step reads.
            "bound_int32_ops": 8 * read}


def time_serial(op, cfg, before, keys, valid=None):
    """One call of the wrapper of G1 (``op`` "insert") or G2 ("delete") on
    a copy of ``before`` between two CUDA events -> (ms, the state and ok
    it left, rem, home)."""
    rem, home = QFm._prepare(cfg, keys)
    state = QFm.GQFState(before.clone(), torch.zeros(
        (), dtype=torch.int32, device=before.device))
    wrapper = K.gqf_insert if op == "insert" else K.gqf_delete
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, ok = wrapper(cfg, state, rem, home, valid)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), state, ok, rem, home


def plain_case(op, cfg, before, rem, home, state, ok) -> dict:
    """CPU copies of one timed G1 ("insert") or G2 ("delete") launch: the
    table it started from, the keys' rem and home, and what it left."""
    return {"op": op, "cfg": cfg, "before": before.cpu(), "rem": rem.cpu(),
            "home": home.cpu(), "table": state.table.cpu(),
            "count": int(state.count), "ok": ok.cpu()}


def serial_plain_at_shape(case, label) -> float:
    """The plain loop of G1 or G2 on the CPU copy of the table a timed
    launch started from, with its keys: table, ok and count (from 0) must
    equal the launch's word for word. Returns the loop's ms."""
    op, cfg = case["op"], case["cfg"]
    plain = gqf_insert_plain if op == "insert" else gqf_delete_plain
    table = case["before"]
    valid = torch.ones(case["rem"].shape[0], dtype=torch.bool)
    t0 = time.perf_counter()
    want = plain(table, case["rem"], case["home"], valid, cfg.remainder_bits,
                 cfg.max_probe)
    plain_ms = (time.perf_counter() - t0) * 1e3
    placed = int(want.sum())
    check(torch.equal(case["ok"], want) and torch.equal(case["table"], table)
          and case["count"] == (placed if op == "insert" else -placed),
          f"{label}: differs from its plain loop at the GQF's shape")
    return plain_ms


def gqf_part(gen) -> tuple:
    """The GQF at 2^24 slots, filled through G1 in batches of 2^20 (the JAX
    suites' batch for serial structures). Returns (its record, G1's and
    G2's records, CPU copies of their timed launches for
    :func:`serial_plain_at_shape`)."""
    K.reset_launches()
    h = amq.make("gqf", capacity=GQF_CAPACITY)
    batches = [normalize_keys(random_keys(gen, m))
               for m in sizes_of(GQF_CAPACITY, GQF_BATCH)]
    kept = {}

    def keep(b):
        if b == len(batches) - 2:
            kept["table"] = h.state.table.clone()

    ok, insert_s, per_batch = fill_baseline(h, "gqf", batches, on_batch=keep)
    before_last = kept.pop("table")
    cfg = h.config
    load = h.load_factor
    failed = int((~ok).sum())
    hits, query_s = query_batches(h, batches)
    fn = int((ok & ~hits).sum())
    table = from_i32(h.state.table)
    far = int(((table >> cfg.remainder_bits) >= cfg.max_probe).sum())
    check(fn <= failed + far,
          f"gqf: {fn} false negatives among ok keys, more than {failed} "
          f"failed + {far} slots at distance >= max_probe (R5)")
    band = fpr_band(h, gen, "gqf")
    stored = batches[0][(ok & hits)[:batches[0].shape[0]]]
    before_delete = h.state.table.clone()
    del_ok, delete_s = stored_delete(h, stored, "gqf")
    check(bool(del_ok.all()), f"gqf: {int((~del_ok).sum())} deletes failed")
    launches = check_launches("gqf", ["hash64", "gqf_insert_serial",
                                      "gqf_delete_serial"])
    rec = {"config": repr(cfg), "slots": cfg.num_slots,
           "table_bytes": cfg.table_bytes, "load": load,
           "batches": per_batch, "failed": failed,
           "false_negatives": fn, "slots_at_max_probe_or_more": far, **band,
           "deleted": stored.shape[0], "count_after_delete": h.count(),
           "launches": launches,
           **rates(insert_s, ok.shape[0], query_s, GQF_BATCH, delete_s,
                   stored.shape[0])}

    # G1 and G2 timed alone at the fill's last full batch and at the
    # delete, each beside a bound from the slots its runs touch; CPU copies
    # of each launch are held to the plain loop at the end of the script.
    last = batches[-2]
    ins_ms, after, ins_ok, rem, home = time_serial("insert", cfg,
                                                   before_last, last)
    g1 = {"ms": ins_ms, "n": last.shape[0],
          **serial_bound(cfg, before_last, after.table, home, rem, True)}
    cases = {"gqf_insert_serial": plain_case("insert", cfg, before_last, rem,
                                             home, after, ins_ok)}
    del_ms, after, timed_ok, rem, home = time_serial("delete", cfg,
                                                    before_delete, stored)
    check(torch.equal(after.table, h.state.table)
          and torch.equal(timed_ok, del_ok),
          "gqf: G2 timed alone left another table or ok than the delete")
    g2 = {"ms": del_ms, "n": stored.shape[0],
          **serial_bound(cfg, before_delete, after.table, home, rem, False)}
    cases["gqf_delete_serial"] = plain_case("delete", cfg, before_delete, rem,
                                            home, after, timed_ok)
    for g in (g1, g2):
        g["keys_per_s"] = g["n"] / g["ms"] * 1e3
    rec["g1"], rec["g2"] = g1, g2
    del h, before_last, before_delete, after, table
    torch.cuda.empty_cache()
    rec["cuckoo"] = cuckoo_beside(GQF_CAPACITY, batches, stored,
                                  "gqf: cuckoo")
    serial = {name: (g, launches[name]) for name, g in
              (("gqf_insert_serial", g1), ("gqf_delete_serial", g2))}
    return rec, serial, cases


def serial_vs_plain(gen) -> dict:
    """G1 and G2 against their plain loops: 2^12 keys into a 2^14-slot
    table filled (by G1) to the load less those keys, then 2^12 deletes
    (stored keys, some twice, under a mask); table, ok and count equal
    word for word. The plain loop runs on a CPU copy (deterministic).
    Each kernel is also timed alone at this shape."""
    out = {}
    for load in (0.9, 0.99):
        cfg = QFm.GQFConfig(num_slots=SERIAL_SLOTS)
        dev = cfg.init("cuda")
        base = normalize_keys(random_keys(
            gen, int(load * SERIAL_SLOTS) - SUB))
        dev, _ = QFm.insert(cfg, dev, base)
        host = QFm.GQFState(dev.table.to("cpu", copy=True),
                            dev.count.to("cpu", copy=True))
        keys = normalize_keys(random_keys(gen, SUB))
        dels = torch.cat([base[:SUB // 2], keys[:SUB // 4],
                          base[:SUB // 4]])[torch.randperm(
                              SUB, device="cuda", generator=gen)]
        valid = torch.rand(SUB, device="cuda", generator=gen) < 0.9
        rec = {}
        for op, k, v in (("insert", keys, None), ("delete", dels, valid)):
            before = dev.table.clone()
            dev, ok = getattr(QFm, op)(cfg, dev, k, v)
            # The kernel timed alone at this shape, beside its plain loop.
            rec[f"{op}_kernel_ms"] = time_serial(op, cfg, before, k, v)[0]
            t0 = time.perf_counter()
            host, want = getattr(QFm, op)(cfg, host, k.cpu(),
                                          None if v is None else v.cpu())
            rec[f"{op}_plain_ms"] = (time.perf_counter() - t0) * 1e3
            check(torch.equal(ok.cpu(), want)
                  and torch.equal(dev.table.cpu(), host.table)
                  and int(dev.count) == int(host.count),
                  f"gqf_{op}_serial differs from its plain loop at load "
                  f"{load}")
            rec[f"{op}_ok"] = int(want.sum())
        out[f"load_{load}"] = rec
    return out


def rounds_vs_cpu(gen) -> dict:
    """The TCF's and BCHT's rounds on 2^16-slot tables: after the same
    insert and delete batches the card's tables equal the CPU's word for
    word (stable-sort claims, unique winners)."""
    out = {}
    for name, mod, cfg in (("tcf", TCm, TCm.TCFConfig(num_blocks=1 << 11)),
                           ("bcht", HTm, HTm.BCHTConfig(num_buckets=1 << 12))):
        dev, host = cfg.init("cuda"), cfg.init("cpu")
        keys = normalize_keys(random_keys(gen, int(0.95 * cfg.num_slots)))
        half = keys.shape[0] // 2
        for op, k in (("insert", keys[:half]), ("insert", keys[half:]),
                      ("delete", keys[::3])):
            dev, ok = getattr(mod, op)(cfg, dev, k)
            host, want = getattr(mod, op)(cfg, host, k.cpu())
            check(torch.equal(ok.cpu(), want), f"{name} {op}: ok differs "
                                               "between the card and the CPU")
            for f in dev._fields:
                check(torch.equal(getattr(dev, f).cpu(), getattr(host, f)),
                      f"{name} {op}: {f} differs between the card and the CPU")
        out[name] = {"slots": cfg.num_slots, "count": int(dev.count)}
    return out


def baselines(gen, main_rates) -> dict:
    """The baselines phase; see the module docstring. Returns the kernel
    records of G1 and G2 with their launches, and the CPU copies of their
    timed launches (:func:`plain_case`)."""
    t_start = time.perf_counter()
    rec, seconds = {}, {}
    t0 = time.perf_counter()
    rec["serial_vs_plain"] = serial_vs_plain(gen)
    rec["rounds_vs_cpu"] = rounds_vs_cpu(gen)
    seconds["vs_plain"] = time.perf_counter() - t0
    for name, part in (("tcf", lambda: tcf_part(gen, main_rates)),
                       ("bcht", lambda: bcht_part(gen))):
        t0 = time.perf_counter()
        rec[name] = part()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["gqf"], serial, cases = gqf_part(gen)
    seconds["gqf"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # The paper's ratios, as measured on this card: cuckoo keys/s over the
    # baseline's, for each op.
    rec["cuckoo_over"] = {
        name: {op: rec[name]["cuckoo"][f"{op}_keys_per_s"]
               / rec[name][f"{op}_keys_per_s"]
               for op in ("insert", "query", "delete")}
        for name in ("tcf", "gqf", "bcht")}
    emit({"phase": "baselines", **rec, "seconds_by_part": seconds,
          "seconds": time.perf_counter() - t_start})
    plain = rec["serial_vs_plain"]["load_0.9"]
    return {name: (g, launches, plain[f"{op}_plain_ms"],
                   plain[f"{op}_kernel_ms"])
            for (name, (g, launches)), op in zip(serial.items(),
                                                 ("insert", "delete"))}, cases


# ---------------------------------------------------------------------------
# The mesh-sharded filter and filter-backed dedup (phases 9b, 9c).
# ---------------------------------------------------------------------------

def until_routed(h, keys, call, label: str):
    """``call(batch, valid)`` over ``keys`` (padded to the handle's
    ``batch_align`` under a valid mask), then again over the keys it did
    not route, until none is left. Returns (each key's ``ok`` or ``hits``,
    the first pass's routed share, the passes)."""
    n, align = keys.shape[0], h.config.batch_align
    out = torch.zeros(n, dtype=torch.bool, device=keys.device)
    pending = torch.arange(n, device=keys.device)
    share, passes = None, 0
    while pending.numel():
        check(passes < 8, f"{label}: {pending.numel()} keys still unrouted "
                          "after 8 passes")
        m = pending.numel()
        batch = torch.cat([keys[pending],
                           keys.new_zeros(((-m) % align, 2))])
        valid = torch.arange(batch.shape[0], device=keys.device) < m
        rep = call(batch, valid)
        routed = rep.routed[:m]
        got = (rep.hits if isinstance(rep, amq.QueryResult) else rep.ok)[:m]
        if share is None:
            share = float(routed.float().mean())
        out[pending[routed]] = got[routed]
        pending = pending[~routed]
        passes += 1
    return out, share, passes


def sharded_query(h, keys, label: str):
    return until_routed(h, keys, lambda k, v: h.query(k, valid=v), label)[0]


def query_vs_plain(level, keys, label: str) -> int:
    """Kernel #2 against its plain version, answer for answer, on ``keys``
    as ``level``'s query path hands them to it. A sharded level is held on
    partition 0: its stream of the keys binned from every shard's local
    batch (``K*cap`` slots, padding zeros). Returns the keys checked. Not
    the path's launches."""
    cfg, state = level.config, level.state
    if isinstance(state, SF.ShardedCuckooState):
        inner = cfg.inner
        local = keys.view(inner.num_shards, -1, 2)
        bins = SF._route(inner, local, inner.bin_capacity(local.shape[1]))[0]
        keys = bins[:, 0].reshape(-1, 2).contiguous()
        cfg, state = inner.shard, CF.CuckooState(state.table[0],
                                                 state.count[0])
    got = K.cuckoo_query(cfg, state, keys)
    want = cuckoo_query_plain(cfg, state.table, keys)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"{label}: cuckoo_query differs from its plain version on "
          f"{int((got != want).sum())} of {keys.shape[0]} keys")
    return keys.shape[0]


def sharded_phase(gen) -> dict:
    """Phase 9b (see the module docstring). Returns the phase's record."""
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    h = amq.make("sharded-cuckoo", capacity=SHARDED_CAPACITY,
                 num_shards=SHARDS, partitions_per_shard=SHARDED_PPS)
    inner, part_cfg = h.config.inner, h.config.inner.shard
    check(inner.partitions == SHARDS * SHARDED_PPS
          and part_cfg.num_slots == 1 << 25 and h.config.num_slots == 1 << 28
          and (part_cfg.fp_bits, part_cfg.bucket_size, part_cfg.policy,
               part_cfg.hash_kind) == (16, 16, "xor", "fmix32"),
          f"sharded: config {inner!r}")
    sizes = batch_sizes(SHARDED_CAPACITY)
    batches = [normalize_keys(random_keys(gen, m)) for m in sizes]
    bulk = [b >= BATCHES - 4 for b in range(len(sizes))]

    K.reset_launches()
    per_batch, insert_s = [], 0.0
    expect = torch.zeros(inner.partitions, dtype=torch.int64, device="cuda")
    for b, keys in enumerate(batches):
        (ok, share, passes), dt = timed(lambda: until_routed(
            h, keys, lambda k, v: h.insert(k, bulk=bulk[b], valid=v),
            f"sharded: batch {b}"))
        insert_s += dt
        placed = int(ok.sum())
        check(placed == keys.shape[0], f"sharded: batch {b}: "
              f"{keys.shape[0] - placed} keys not placed at load "
              f"{h.load_factor:.4f}")
        expect += torch.bincount(SF.partition_of(inner, keys),
                                 minlength=inner.partitions)
        per_batch.append({"keys": keys.shape[0], "bulk": bulk[b], "s": dt,
                          "routed_share": share, "passes": passes,
                          "load": h.load_factor})
    inserted = sum(sizes)
    check(torch.equal(h.state.count.long(), expect),
          f"sharded: partition counts {h.state.count.tolist()} != the keys' "
          f"{expect.tolist()}")
    check(h.count() == inserted, f"sharded: count {h.count()} != {inserted}")
    load = h.load_factor

    query_s, misses = [], 0
    for keys in batches:
        hits, dt = timed(lambda: sharded_query(h, keys, "sharded: query"))
        if keys.shape[0] == sizes[0]:
            query_s.append(dt)
        misses += int((~hits).sum())
    check(misses == 0, f"sharded: {misses} false negatives")
    fresh = normalize_keys(random_keys(gen, PROBES, top_half=True))
    fpr = fpr_of("sharded", sharded_query(h, fresh, "sharded: FPR"),
                 h.expected_fpr())

    before = h.count()
    (dok, delete_share, _), delete_s = timed(lambda: until_routed(
        h, batches[0], lambda k, v: h.delete(k, valid=v), "sharded: delete"))
    check(bool(dok.all()), f"sharded: {int((~dok).sum())} deletes failed")
    check(before - h.count() == sizes[0], "sharded: count after the deletes")

    # One ycsb_50_40_10 batch: stored keys queried and deleted, fresh keys
    # inserted, shuffled; against the core driver on a copy of the state.
    n = MIXED_BATCH
    n_q, n_i = (round(f * n) for f in MIXES["ycsb_50_40_10"][:2])
    n_d = n - n_q - n_i
    stored = torch.cat(batches[1:])
    pick = torch.randperm(stored.shape[0], generator=gen,
                          device="cuda")[:n_q + n_d]
    raw = torch.cat([stored[pick[:n_q]],
                     normalize_keys(random_keys(gen, n_i, top_half=True)),
                     stored[pick[n_q:]]])
    del stored, pick
    ops = torch.cat([torch.full((m,), code, dtype=torch.int32, device="cuda")
                     for m, code in ((n_q, amq.OP_QUERY), (n_i, amq.OP_INSERT),
                                     (n_d, amq.OP_DELETE))])
    shuffle = torch.randperm(n, generator=gen, device="cuda")
    batch = amq.OpBatch.make(raw[shuffle], ops[shuffle])
    del raw, ops, shuffle
    copy = SF.ShardedCuckooState(h.state.table.clone(), h.state.count.clone())
    rep, mixed_s = timed(lambda: h.apply_ops(batch))
    launches = check_launches("sharded", ("hash64", "cuckoo_query",
                                          "cuckoo_insert_direct",
                                          "cuckoo_mixed"))
    core = SF.ShardedCuckooFilter(inner, h.config.mesh, n // SHARDS,
                                  state=copy)
    core_ok, core_routed = core.apply_ops(batch.keys, batch.ops,
                                          valid=batch.valid)
    check(torch.equal(rep.routed, core_routed)
          and torch.equal(rep.ok, core_ok),
          f"sharded: apply_ops differs from the core driver on "
          f"{int((rep.ok != core_ok).sum())} ok, "
          f"{int((rep.routed != core_routed).sum())} routed")
    check(bool(rep.ok[rep.routed].all()),
          f"sharded: {int((~rep.ok & rep.routed).sum())} routed ops not ok")
    mixed_routed = float(rep.routed.float().mean())
    del core, copy, batch, rep, core_ok, core_routed
    peak = torch.cuda.max_memory_allocated()

    query_checked = {name: query_vs_plain(h, p, f"sharded: {name} probe")
                     for name, p in (("fresh", fresh),
                                     ("stored", batches[1]))}

    # Partition 0's direct insert: order-free on its share of the fresh
    # keys, exactly the plain loop's on 2^12 keys of which no two share a
    # bucket (at load 0.9 two keys racing for a bucket's last free slot
    # would make the outcome order's). Not the path's launches.
    base, count0 = h.state.table[0], h.state.count[0]
    keys0 = fresh[SF.partition_of(inner, fresh) == 0]
    turned_down = check_direct_insert(
        part_cfg, CF.CuckooState(base, count0), base, keys0,
        "sharded: partition 0 direct insert")
    _, i1, i2 = CF.prepare_keys_plain(part_cfg, keys0[:4 * SUB])
    uses = torch.bincount(torch.cat([i1, i2]),
                          minlength=part_cfg.num_buckets)
    sub = keys0[:4 * SUB][(uses[i1] == 1) & (uses[i2] == 1)][:SUB]
    check(sub.shape[0] == SUB, "sharded: too few bucket-disjoint keys")
    valid = torch.rand(sub.shape[0], device="cuda", generator=gen) < 0.9
    direct_err = same_outcome(
        part_cfg, base, sub,
        lambda t: K.cuckoo_insert_direct(part_cfg, CF.CuckooState(t, count0),
                                         sub, valid)[1],
        lambda t: cuckoo_insert_direct_plain(part_cfg, t, sub, valid))

    # Exact reshards, then a snapshot through a file onto 2 shards.
    probes = {"stored": batches[1], "fresh": fresh}
    want = {name: sharded_query(h, p, "sharded: reshard probe")
            for name, p in probes.items()}
    reshards = {}
    for k2 in (2, 8, 1):
        moved, dt = timed(lambda: h.resharded(num_shards=k2))
        check(moved.config.inner.num_shards == k2
              and torch.equal(moved.state.table, h.state.table)
              and torch.equal(moved.state.count, h.state.count),
              f"sharded: 4->{k2} moved the words")
        for name, p in probes.items():
            check(torch.equal(sharded_query(moved, p, "sharded: resharded"),
                              want[name]),
                  f"sharded: 4->{k2} answers {name} probes otherwise")
        reshards[f"4->{k2}"] = {"s": dt}
        del moved
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        path = os.path.join(tmp, "sharded.npz")
        snap, snap_s = timed(h.snapshot)
        _, save_s = timed(lambda: amq.save_snapshot(path, snap))
        loaded, load_s = timed(lambda: amq.load_snapshot(path))
        twin, restore_s = timed(lambda: amq.make(
            "sharded-cuckoo", config=h.config.resharded(2), snapshot=loaded))
        snapshot_bytes = snap.nbytes
    finally:
        shutil.rmtree(tmp)
    check(torch.equal(twin.state.table, h.state.table)
          and all(torch.equal(sharded_query(twin, p, "sharded: twin"),
                              want[name]) for name, p in probes.items()),
          "sharded: the snapshot's 2-shard twin answers otherwise")
    del twin, snap, loaded
    record = {
        "phase": "sharded", "config": repr(h.config.inner),
        "fingerprint": h.fingerprint, "shards": SHARDS,
        "partitions": inner.partitions, "slots": h.config.num_slots,
        "table_bytes": h.config.table_bytes, "keys_inserted": inserted,
        "load": load, "batches": per_batch,
        "insert_keys_per_s": inserted / insert_s,
        "routed_share_min": min(r["routed_share"] for r in per_batch),
        "query_keys_per_s": sizes[0] / statistics.median(query_s),
        "false_negatives": misses, "fpr": fpr,
        "delete_keys": sizes[0], "delete_keys_per_s": sizes[0] / delete_s,
        "delete_routed_share": delete_share,
        "mixed_ops": n, "mixed_ops_per_s": n / mixed_s,
        "mixed_routed_share": mixed_routed,
        "mixed_checks": "ok and routed == ShardedCuckooFilter.apply_ops "
                        "(core) on a copy of the state",
        "launches": launches, "max_memory_allocated": peak,
        "partition0_query_vs_plain_keys": query_checked,
        "partition0_direct_insert": {
            "keys": keys0.shape[0], "turned_down": turned_down,
            "ok_mismatches_at_2^12": direct_err},
        "reshards": reshards,
        "snapshot": {"bytes": snapshot_bytes, "snapshot_s": snap_s, "save_s": save_s,
                     "load_s": load_s, "restore_2_shards_s": restore_s},
        "seconds": time.perf_counter() - t_start}
    emit(record)
    del h, batches, fresh, probes, want
    torch.cuda.empty_cache()
    return record


def dedup_stream(backend: str, tokens, kw) -> dict:
    """One ``StreamingDeduper`` over ``tokens`` against a host set of the
    sequences' keys (phase 9c)."""
    d = DD.make_deduper(DEDUP_CAPACITY, backend=backend,
                        service_batch=DEDUP_DATA["batch"], **kw)
    seen = np.zeros(0, np.uint64)
    fresh_total = masked_fresh = 0
    admitted, dedup_s, syncs = [], 0.0, None
    K.reset_launches()
    for b, t in enumerate(tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if b == len(tokens) // 2:
            (out, stats), syncs, _ = host_syncs(lambda: d.dedup({"tokens": t}))
        else:
            out, stats = d.dedup({"tokens": t})
        torch.cuda.synchronize()
        dedup_s += time.perf_counter() - t0
        keys = keys_to_numpy(DD.sequence_keys(t))
        mask = out["mask"].cpu().numpy()
        first = np.zeros(keys.shape[0], bool)
        first[np.unique(keys, return_index=True)[1]] = True
        repeat = np.isin(keys, seen) | ~first
        check(not mask[repeat].any(), f"dedup {backend}: batch {b}: "
              f"{int(mask[repeat].sum())} repeated sequences kept")
        check(stats["duplicates"] == int((~mask).sum()),
              f"dedup {backend}: batch {b}: duplicates stat")
        fresh_total += int((~repeat).sum())
        masked_fresh += int((~repeat & ~mask).sum())
        admitted.append(keys[mask])
        seen = np.union1d(seen, keys)
    d.flush()
    launches = check_launches(f"dedup {backend}", (
        "hash64", "cuckoo_query", "cuckoo_insert_direct"))
    query_checked = query_vs_plain(d.handle.levels[-1],
                                   DD.sequence_keys(tokens[-1]),
                                   f"dedup {backend}: active level")
    check(d.stats["insert_failures"] == 0,
          f"dedup {backend}: {d.stats['insert_failures']} insert failures")
    report = d.handle.report()
    lo, hi = amq.fpr_tolerance(report.expected_fpr, fresh_total)
    check(masked_fresh <= hi * fresh_total,
          f"dedup {backend}: {masked_fresh} of {fresh_total} fresh sequences "
          f"masked, above the FPR band's {hi}")
    check(d.handle.count() == fresh_total - masked_fresh,
          f"dedup {backend}: count {d.handle.count()} != "
          f"{fresh_total - masked_fresh} admitted")
    # Forget 2^14 admitted keys: each delete ``ok`` drops the count by one.
    forget = np.concatenate(admitted)[:DEDUP_DATA["batch"]]
    before = d.handle.count()
    K.reset_launches()
    _, forget_s = timed(lambda: d.forget(forget))
    forget_launches = check_launches(f"dedup {backend}: forget",
                                     ("cuckoo_mixed",))
    check(before - d.handle.count() == forget.shape[0],
          f"dedup {backend}: forget dropped {before - d.handle.count()} of "
          f"{forget.shape[0]}")
    sequences = sum(t.shape[0] for t in tokens)
    return {"backend": backend, "sequences": sequences,
            "sequences_per_s": sequences / dedup_s,
            "levels": len(d.handle.levels),
            "level_slots": [lv.config.num_slots for lv in d.handle.levels],
            "host_syncs_a_batch": syncs, "fresh": fresh_total,
            "fresh_masked": masked_fresh, "fpr_band": [lo, hi],
            "expected_fpr": report.expected_fpr, "count": d.handle.count(),
            "launches": launches, "query_vs_plain_keys": query_checked,
            "forget_keys": forget.shape[0],
            "forget_s": forget_s, "forget_launches": forget_launches}


def dedup_phase() -> dict:
    """Phase 9c (see the module docstring). Returns the phase's record."""
    t_start = time.perf_counter()
    cfg = DataConfig(**DEDUP_DATA)
    t0 = time.perf_counter()
    # numpy's generators release the GIL: a batch a thread.
    with concurrent.futures.ThreadPoolExecutor(DEDUP_THREADS) as pool:
        host = list(pool.map(
            lambda step: make_batch(cfg, step, device="cpu")["tokens"],
            range(DEDUP_BATCHES)))
    tokens = [t.to("cuda") for t in host]
    del host
    make_s = time.perf_counter() - t0
    streams = {name: dedup_stream(name, tokens, kw) for name, kw in (
        ("cuckoo", {}), ("sharded-cuckoo", {"num_shards": SHARDS}))}
    torch.cuda.empty_cache()

    # One dedup_batch on a static sharded filter.
    fcfg, state = DD.make_dedup(DEDUP_CAPACITY, backend="sharded-cuckoo",
                                num_shards=SHARDS)
    K.reset_launches()
    (state, out, stats), static_s = timed(
        lambda: DD.dedup_batch(fcfg, state, {"tokens": tokens[0]}))
    # The query and direct-insert kernels hash in place: on an empty
    # filter no key reaches the round loop, so the hash kernel need not run.
    static_launches = check_launches("dedup_batch sharded-cuckoo", (
        "cuckoo_query", "cuckoo_insert_direct"))
    # On the empty filter the mask is each sequence's first occurrence.
    keys = keys_to_numpy(DD.sequence_keys(tokens[0]))
    first = np.zeros(keys.shape[0], bool)
    first[np.unique(keys, return_index=True)[1]] = True
    mask = out["mask"].cpu().numpy()
    check(np.array_equal(mask, first)
          and int(stats["duplicates"]) == int((~mask).sum())
          and int(stats["insert_failures"]) == 0
          and int(stats["unrouted"]) == 0
          and int(state.count.sum()) == int(mask.sum()),
          f"dedup_batch sharded-cuckoo: {({k: int(v) for k, v in stats.items()})}")
    record = {"phase": "dedup", "data": DEDUP_DATA, "batches": DEDUP_BATCHES,
              "capacity": DEDUP_CAPACITY, "make_batches_s": make_s,
              "streams": streams,
              "static_sharded_dedup_batch": {
                  "s": static_s, "launches": static_launches,
                  **{k: int(v) for k, v in stats.items()}},
              "seconds": time.perf_counter() - t_start}
    emit(record)
    del tokens
    torch.cuda.empty_cache()
    return record


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
    ptxas = ptxas_report(logs.get("flash_attention", ""), "flash_")
    emit({"phase": "flash_ptxas", "compiled": "flash_attention" in logs,
          "kernels": ptxas})
    wgmma = [r for n, r in ptxas.items() if "wgmma" in n]
    check("flash_attention" not in logs or (
        len(wgmma) == 3 and all(r.get("spill_stores") == 0 for r in wgmma)),
          f"flash: the wgmma kernels' ptxas report {ptxas}")
    ptxas = ptxas_report(logs.get("bloom_insert", ""), "bloom_insert")
    emit({"phase": "bloom_insert_ptxas", "compiled": "bloom_insert" in logs,
          "kernels": ptxas, "sass": sass_census("bloom_insert",
                                                "bloom_insert")})
    check("bloom_insert" not in logs or (
        len(ptxas) == 2 and all(r.get("spill_stores") == 0
                                for r in ptxas.values())),
          f"bloom_insert: the kernels' ptxas report {ptxas}")
    ptxas = ptxas_threads(logs.get("cuckoo_insert", ""), "cuckoo_insert")
    emit({"phase": "cuckoo_insert_ptxas", "compiled": "cuckoo_insert" in logs,
          "kernels": ptxas})
    check(all(r.get("spill_stores") == 0 for r in ptxas.values()),
          f"cuckoo_insert: the kernels' ptxas report {ptxas}")
    ptxas = ptxas_threads(logs.get("bloom_query", ""), "(?:bloom|window)")
    emit({"phase": "bloom_query_ptxas", "compiled": "bloom_query" in logs,
          "kernels": ptxas})
    check("bloom_query" not in logs or (ptxas and all(
        r.get("spill_stores") == 0 for r in ptxas.values())),
          f"bloom_query: the kernels' ptxas report {ptxas}")
    ptxas = ptxas_threads(logs.get("cuckoo_query", ""), "cuckoo_query")
    loads = query_loads()
    emit({"phase": "cuckoo_query_ptxas", "compiled": "cuckoo_query" in logs,
          "kernels": ptxas, "sass": loads})
    check(all(r.get("spill_stores") == 0 for r in ptxas.values()),
          f"cuckoo_query: the kernels' ptxas report {ptxas}")
    check(loads is None or all(r["i2_behind_branch"] for r in loads.values()),
          f"cuckoo_query: bucket i2's loads not behind the branch: {loads}")
    ptxas = ptxas_threads(logs.get("cuckoo_query_unfused", ""),
                          "cuckoo_query_unfused")
    loads = query_loads("cuckoo_query_unfused")
    emit({"phase": "cuckoo_query_unfused_ptxas",
          "compiled": "cuckoo_query_unfused" in logs, "kernels": ptxas,
          "sass": loads})
    check(all(r.get("spill_stores") == 0 for r in ptxas.values()),
          f"cuckoo_query_unfused: the kernels' ptxas report {ptxas}")
    check(loads is None or all(r["i2_behind_branch"] for r in loads.values()),
          f"cuckoo_query_unfused: bucket i2's loads not behind the branch: "
          f"{loads}")
    ptxas = ptxas_threads(logs.get("cuckoo_insert_unfused", ""),
                          "cuckoo_insert_unfused")
    emit({"phase": "cuckoo_insert_unfused_ptxas",
          "compiled": "cuckoo_insert_unfused" in logs, "kernels": ptxas})
    check(all(r.get("spill_stores") == 0 for r in ptxas.values()),
          f"cuckoo_insert_unfused: the kernels' ptxas report {ptxas}")
    ptxas = ptxas_threads(logs.get("cuckoo_mixed", ""), "cuckoo_mixed")
    emit({"phase": "cuckoo_mixed_ptxas", "compiled": "cuckoo_mixed" in logs,
          "kernels": ptxas})
    check("cuckoo_mixed" not in logs or (ptxas and all(
        r.get("spill_stores") == 0 for r in ptxas.values())),
          f"cuckoo_mixed: the kernels' ptxas report {ptxas}")
    ptxas = ptxas_threads(logs.get("kmer_pack", ""), "kmer_pack")
    emit({"phase": "kmer_pack_ptxas", "compiled": "kmer_pack" in logs,
          "kernels": ptxas})
    check("kmer_pack" not in logs or (ptxas and all(
        r.get("spill_stores") == 0 for r in ptxas.values())),
          f"kmer_pack: the kernels' ptxas report {ptxas}")
    ptxas = ptxas_threads(logs.get("cuckoo_insert_bulk", ""),
                          "(?:bulk|window)")
    emit({"phase": "cuckoo_insert_bulk_ptxas",
          "compiled": "cuckoo_insert_bulk" in logs, "kernels": ptxas})
    check("cuckoo_insert_bulk" not in logs or (ptxas and all(
        r.get("spill_stores") == 0 for r in ptxas.values())),
          f"cuckoo_insert_bulk: the kernels' ptxas report {ptxas}")
    ptxas = ptxas_threads(logs.get("gqf_serial", ""), "gqf")
    emit({"phase": "gqf_serial_ptxas", "compiled": "gqf_serial" in logs,
          "kernels": ptxas})
    check("gqf_serial" not in logs or (len(ptxas) == 2 and all(
        r.get("spill_stores") == 0 for r in ptxas.values())),
          f"gqf_serial: the kernels' ptxas report {ptxas}")
    for name in build.SOURCES:
        build.load(name)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    emit({"phase": "warm_up", "seconds": warm_up(gen)})

    # --- the main path at full size -------------------------------------
    t0 = time.perf_counter()
    h, snaps, batches, launches, main_record = main_path(FULL_CAPACITY,
                                                         gen, "2^28")
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
    twice = first[:SUB // 2].repeat(2, 1)[torch.randperm(
        SUB, device="cuda", generator=gen)]
    errs["cuckoo_mixed"] = 0
    for keys, ops in ((universe[picks], mixed_ops), (dup, deletes),
                      (twice, deletes)):
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
    # Kernel #2 at more shapes: the row's stored keys on the table at load
    # 0.5 and on the table right after the fill, and 2^24 fresh keys from
    # the disjoint half of the key space (all negative) on the latter.
    negative = normalize_keys(random_keys(gen, PROBES, top_half=True))
    query_tables = {"load_0.5": (half, keys), "load_0.95": (snaps["full"], keys),
                    "load_0.95_negative": (snaps["full"], negative)}
    query_shape_recs = {
        label: query_shape(cfg, h.state._replace(table=table), qkeys)
        for label, (table, qkeys) in query_tables.items()}
    # Kernel #3 at the same shapes and at its row's (the stored keys on the
    # table after the main path), each beside #2's time there.
    query_tables["stored"] = (h.state.table, keys)
    unfused_query_shapes = {}
    for label, (table, qkeys) in query_tables.items():
        rec = query_shape(cfg, h.state._replace(table=table), qkeys,
                          fused=False)
        rec["fused_ms"] = (query_shape_recs[label]["ms"]
                           if label in query_shape_recs
                           else timing["cuckoo_query"][0])
        rec["unfused_over_fused"] = rec["ms"] / rec["fused_ms"]
        unfused_query_shapes[label] = rec
    emit({"phase": "cuckoo_query_unfused_shapes",
          "shapes": unfused_query_shapes})
    del negative, query_tables
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
    # Kernel #4 at the main path's first batch (the empty table) and past
    # full buckets (the table at load 0.95).
    insert_shape_recs = insert_shapes(
        h, {"empty": torch.zeros_like(half), "load_0.95": snaps["full"]},
        ins_keys, sub, work)
    # Kernel #6 at its row's shape (2^24 keys into the table at load 0.5):
    # the route, the wrapper and, profiled, each of the wrapper's kernels.
    bulk_shapes = {"load_0.5": bulk_shape(cfg, h.state, work, half, ins_keys,
                                          profile=True)}
    bulk_row = bulk_shapes["load_0.5"]
    wrapper_ms = {"cuckoo_insert_bulk": bulk_row["wrapper_ms"]}
    timing["cuckoo_insert_bulk"] = (
        bulk_row["ms"], cuda_ms(lambda: cuckoo_insert_bulk_plain(
            cfg, work, sub, sub_valid), reps=3, setup=restore(half)),
        n, SUB, "bulk_insert", bulk_row["touched"])
    # Kernel #7 at four shapes: the main path's delete (2^24 stored keys,
    # each once); the same table, 2^23 stored keys each deleted twice; a
    # 2^24-op stream of the YCSB 50/40/10 mix on the table at load 0.5 over
    # a universe of about 7.49 x 2^24 keys (half stored, half fresh), so
    # that 1 - exp(-1/7.49) = 1/8 of the ops meet their key again; the 2^12
    # mixed stream above. The row's time is the main path's delete.
    del_ops = torch.full((n,), amq.OP_DELETE, dtype=torch.int32, device="cuda")
    t1 = time.perf_counter()
    u = round(n / -np.log(7 / 8))
    stored_half = torch.cat([normalize_keys(b) for b in batches[:4]])
    check(stored_half.shape[0] >= u // 2, "mixed universe: stored keys")
    mix_universe = torch.cat([stored_half[:u // 2], normalize_keys(
        random_keys(gen, u - u // 2, top_half=True))])
    del stored_half
    draw = torch.rand(n, device="cuda", generator=gen)
    mixed_shapes = mixed_route_shapes(
        cfg, h.state, work, {"load_0.95": full_table, "load_0.5": half},
        {"main_path_delete": ("load_0.95", keys, del_ops),
         "every_key_twice": ("load_0.95", keys[:n // 2].repeat(2, 1)[
             torch.randperm(n, device="cuda", generator=gen)], del_ops),
         "mixed_one_eighth_repeated": (
             "load_0.5", mix_universe[torch.randint(
                 0, u, (n,), device="cuda", generator=gen)],
             ((draw >= 0.5).int() + (draw >= 0.9).int()).to(torch.int32)),
         "stream_2^12": ("load_0.5", universe[picks], mixed_ops)},
        profile=("main_path_delete", "every_key_twice"))
    del mix_universe, draw
    main_delete = mixed_shapes["main_path_delete"]
    if MIXED_ROUTE:    # the main path's delete: no walk and no sort
        check(main_delete["launches"]["cuckoo_mixed_walk"] == 0
              and not any("sort" in k.lower() for k in main_delete["passes"]),
              f"cuckoo_mixed: the main path's delete walked or sorted: "
              f"{main_delete['launches']}, {sorted(main_delete['passes'])}")
    emit({"phase": "cuckoo_mixed_route", "shapes": mixed_shapes,
          "universe_keys": u, "seconds": time.perf_counter() - t1})
    wrapper_ms["cuckoo_mixed"] = main_delete["wrapper_ms"]
    timing["cuckoo_mixed"] = (
        main_delete["ms"],
        cuda_ms(lambda: cuckoo_mixed_plain(cfg, work, dup, deletes),
                reps=3, setup=restore(full_table)),
        n, SUB, "delete", main_delete["touched"])
    timing.update(unfused_records)

    # Kernel #6 against kernel #4 where segments are long: 2^27 keys into
    # the empty table, eight keys a primary bucket on average (load 0.5),
    # and #5 beside #4, where keys share buckets and CASes collide. Each
    # held to the order-free outcome first; #4 and #5 timed as one kernel,
    # #6 as its route and its wrapper (bulk_shape).
    t1 = time.perf_counter()
    long_n = 1 << 27
    long_keys = normalize_keys(random_keys(gen, long_n))
    empty = torch.zeros_like(work)
    long_kernels = {
        "cuckoo_insert_direct": K.cuckoo_insert_direct,
        "cuckoo_insert_unfused": functools.partial(K.cuckoo_insert_direct,
                                                   fused=False),
        "cuckoo_insert_bulk": K.cuckoo_insert_bulk}
    long_turned_down = {
        name: check_direct_insert(cfg, h.state, empty, long_keys,
                                  f"{name} long segments", kernel)
        for name, kernel in long_kernels.items()}
    long_valid = torch.ones(long_n, dtype=torch.bool, device="cuda")
    long_ok = torch.empty(long_n, dtype=torch.bool, device="cuda")
    bulk_shapes["long_segments"] = bulk_shape(cfg, h.state, work, empty,
                                              long_keys)
    long_ms = {
        "cuckoo_insert_direct": cuda_ms(
            lambda: cuckoo_insert_launch(cfg, work, long_keys, long_valid,
                                         long_ok),
            reps=3, setup=restore(empty)),
        "cuckoo_insert_unfused": cuda_ms(
            lambda: cuckoo_insert_unfused_launch(cfg, work, long_keys,
                                                 long_valid, long_ok),
            reps=3, setup=restore(empty)),
        "cuckoo_insert_bulk": bulk_shapes["long_segments"]["ms"],
        "cuckoo_insert_bulk_wrapper":
            bulk_shapes["long_segments"]["wrapper_ms"]}
    long_ms["insert_unfused_over_fused"] = (
        long_ms["cuckoo_insert_unfused"] / long_ms["cuckoo_insert_direct"])
    long_touched = bulk_shapes["long_segments"]["touched"]
    long_bytes = bulk_shapes["long_segments"]["bound_bytes"]
    emit({"phase": "long_segments", "keys": long_n,
          "buckets": cfg.num_buckets,
          "keys_per_bucket": long_n / cfg.num_buckets,
          "turned_down": long_turned_down, "ms": long_ms,
          "touched_buckets": long_touched, "bound_bytes": long_bytes,
          "bytes_bound_ms": long_bytes / HBM_BYTES_PER_S * 1e3,
          "route_floor_ms": bulk_shapes["long_segments"].get(
              "route_floor_ms"),
          "seconds": time.perf_counter() - t1})
    del long_keys, empty, long_valid, long_ok
    torch.cuda.empty_cache()

    copy_src = torch.empty(1 << 28, dtype=torch.int32, device="cuda")
    copy_dst = torch.empty_like(copy_src)
    copy_ms = cuda_ms(lambda: copy_dst.copy_(copy_src))
    copy_bytes_per_s = 2 * copy_src.numel() * 4 / (copy_ms * 1e-3)
    emit({"phase": "timings", "copy_bytes_per_s": copy_bytes_per_s,
          "table_load": h.load_factor, "main_path_2^28_seconds": main_s})
    del copy_src, copy_dst
    torch.cuda.empty_cache()

    # --- the lifecycle ---------------------------------------------------
    lifecycle(h, second, gen)
    del work, full_table, half, high, snaps, h
    torch.cuda.empty_cache()

    # --- the baselines ------------------------------------------------------
    main_rates = {k: main_record[k] for k in (
        "config", "load", "insert_keys_per_s", "query_keys_per_s",
        "delete_keys_per_s")}
    # Its own generator: the phases after it draw the same keys as without
    # it, so their figures compare with an older tree's.
    serial, serial_cases = baselines(
        torch.Generator(device="cuda").manual_seed(SEED + 29), main_rates)

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
    (kmer_timing, kmer_wrapper, kmer_launches, kmer_errs, bloom_shapes,
     bloom_query_shapes, query_shape_recs["kmer_case_study"],
     kmer_shapes) = kmer_case_study(gen)
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
    # The other shapes of #9 (see kmer_case_study), #4 (insert_shapes) and
    # #2 (query_shape), each beside its bound.
    def bounded(recs):
        out = {}
        for label, b in recs.items():
            bytes_ms = b["bound_bytes"] / HBM_BYTES_PER_S * 1e3
            ops_ms = b["bound_int32_ops"] / int_ops_per_s * 1e3
            out[label] = {
                **b, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        return out

    by_name = {r["name"]: r for r in kernels}
    by_name["bloom_insert"]["shapes"] = bounded(bloom_shapes)
    # #8's row: its time at the case study's shape is the whole route's,
    # from its first launch to its last.
    by_name["bloom_query"]["shapes"] = bounded(bloom_query_shapes)
    for key in ("query_route", "passes_ms", "route_floor_ms",
                "max_memory_allocated_by_the_call"):
        if key in bloom_query_shapes["case_study"]:
            by_name["bloom_query"][key] = bloom_query_shapes["case_study"][key]
    by_name["cuckoo_insert_direct"]["shapes"] = bounded(insert_shape_recs)
    # #6's row: its time is the route's, from its first launch to its last.
    by_name["cuckoo_insert_bulk"]["shapes"] = bounded(bulk_shapes)
    for key in ("plan", "passes", "route_floor_ms", "rule_sweep"):
        if key in bulk_row:
            by_name["cuckoo_insert_bulk"][key] = bulk_row[key]
    # #7's row: its time is the route's, from its first launch to its last.
    by_name["cuckoo_mixed"]["shapes"] = bounded(mixed_shapes)
    for key in ("passes", "route_floor_ms",
                "max_memory_allocated_by_the_call"):
        if key in mixed_shapes["main_path_delete"]:
            by_name["cuckoo_mixed"][key] = mixed_shapes["main_path_delete"][key]
    by_name["cuckoo_query"]["shapes"] = bounded(query_shape_recs)
    by_name["cuckoo_query_unfused"]["shapes"] = bounded(unfused_query_shapes)
    # #10's row: the canonical instantiation's numbers (what ``kmer_keys``
    # runs), both instantiations in ``shapes``.
    by_name["kmer_pack"]["shapes"] = bounded(kmer_shapes)
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": SOURCES["flash_attention"],
                    "replaces": TPU_KERNELS["flash_attention"],
                    "launches": serve_launches["flash_attention"],
                    "launches_path": "serve_qwen1_5_4b", **flash})
    # --- the main path at 2^22 slots --------------------------------------
    t0 = time.perf_counter()
    h, snaps, batches, _, _ = main_path(L2_CAPACITY, gen, "2^22")
    emit({"phase": "main_path_2^22_seconds",
          "seconds": time.perf_counter() - t0})
    unfused_comparison_l2(h, snaps, batches, gen)
    del h, snaps, batches

    # --- the mesh-sharded filter and filter-backed dedup ------------------
    # Their own generator: the phases before them draw the same keys as an
    # older tree's. Each path's launches, counted from zero, stand beside
    # the main path's in its kernels' rows.
    sharded = sharded_phase(
        torch.Generator(device="cuda").manual_seed(SEED + 30))
    dedup = dedup_phase()
    phase_launches = {"sharded": sharded["launches"]}
    for name, stream in dedup["streams"].items():
        phase_launches[f"dedup_{name}"] = stream["launches"]
        phase_launches[f"dedup_{name}_forget"] = stream["forget_launches"]
    phase_launches["dedup_batch_sharded-cuckoo"] = dedup[
        "static_sharded_dedup_batch"]["launches"]
    for name in ("hash64", "cuckoo_query", "cuckoo_insert_direct",
                 "cuckoo_mixed"):
        by_name[name]["launches_by_phase"] = {
            phase: counts[name] for phase, counts in phase_launches.items()}

    # --- G1 and G2 against their plain loops at the GQF path's shapes -----
    # Last: the host loops (tens of seconds each) then cannot disturb the
    # host-bound phases above, which compare with an older tree's.
    t0 = time.perf_counter()
    plain_at_shape = {name: serial_plain_at_shape(case, name)
                      for name, case in serial_cases.items()}
    del serial_cases
    emit({"phase": "gqf_serial_vs_plain_at_path_shape",
          "plain_ms": plain_at_shape,
          "checks": "table, ok and count of the timed launch == the plain "
                    "loop's on a CPU copy, word for word",
          "seconds": time.perf_counter() - t0})
    # G1 and G2, each launched by the GQF's path in the baselines phase:
    # timed at its batch there (2^20 keys) beside its plain loop on the
    # same inputs; both also at 2^12 keys into a 2^14-slot table
    # (``at_2^12_keys``).
    for name, (g, count, small_plain_ms, small_ms) in serial.items():
        bytes_ms = g["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = g["bound_int32_ops"] / int_ops_per_s * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": LOOP_KERNELS[name], "launches": count,
            "max_abs_err": 0, "ms": g["ms"],
            "plain_ms": plain_at_shape[name],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "n": g["n"],
            "at_2^12_keys": {"ms": small_ms, "plain_ms": small_plain_ms},
            "launches_path": "baselines_gqf",
            "keys_per_s": g["keys_per_s"], "bound_bytes": g["bound_bytes"],
            "bound_int32_ops": g["bound_int32_ops"],
            "slots_read": g["slots_read"],
            "slots_written": g["slots_written"], "ops_ms": ops_ms,
            "bytes_ms_at_measured_copy":
                g["bound_bytes"] / copy_bytes_per_s * 1e3,
            "note": "one thread, latency-bound by design: the bound is "
                    "printed, not a target"})

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
