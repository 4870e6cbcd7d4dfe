"""Batch-parallel Cuckoo filter core (paper Alg. 1-2), in torch.

Port of the part of ``repro.core.cuckoo_filter`` that the ``cuckoo``
backend's main path needs: the config and state types, key preparation,
the word-claim elections, the legacy lock-step eviction round loop
(``_insert_rounds``, DFS and BFS eviction), the batched BFS frontier
(``_insert_frontier``), the bulk build (``insert_bulk``: two sorted
whole-bucket phases, or the graph-orientation engine ``_insert_orient``),
engine routing, ``insert``, ``query``, ``delete`` (claim rounds) and
the fused mixed-op pass ``apply_ops`` (DESIGN.md §9).

Every insert engine here is the bit-exact bridge to the JAX package:
claims are elected per table word by a stable sort (lowest batch index
wins) and the bulk phases sort stably by bucket, so the tables, ``ok``
masks and statistics match ``repro.core`` word for word. On the GPU the
frontier and the round loop are the residue paths behind the insert
kernels: the ``cuckoo`` adapter hands them only the keys a kernel could
not place.

State tensors are updated in place: the engines write into
``state.table`` and return a state holding the same tensor.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..amq.protocol import OP_DELETE, OP_INSERT, OP_QUERY
from . import layout as L
from .bits64 import MASK32, from_i32, to_i32
from .device import resolve_device
from .hashing import fmix32, hash_key, hash_key_plain, normalize_keys
from .policies import make_policy

_GOLDEN = 0x9E3779B9


class CuckooState(NamedTuple):
    """Filter state: the packed table and the stored-fingerprint count."""

    table: torch.Tensor   # int32[num_words] packed fingerprints (uint32 bits)
    count: torch.Tensor   # int32[] stored-fingerprint count


class InsertStats(NamedTuple):
    """Per-key insertion statistics (feeds the Fig. 5/6 benchmarks).

    ``failed``/``load`` are the loud failure report: the count of valid
    keys the engine could not place and the post-batch load factor.
    """

    evictions: torch.Tensor  # int32[n] eviction-chain length per key
    rounds: torch.Tensor     # int32[]  rounds the batch loop ran
    failed: torch.Tensor     # int32[]  valid keys left unplaced (failures)
    load: torch.Tensor       # float32[] post-batch load factor


@dataclasses.dataclass(frozen=True)
class CuckooConfig:
    """Static filter configuration.

    Class name, field order and defaults are the JAX package's, so
    ``repr(config)`` — the snapshot fingerprint — is identical in both.
    Defaults follow the paper's GPU configuration: 16-bit fingerprints,
    bucket size 16, XOR placement, xxHash64, BFS eviction.
    """

    num_buckets: int
    fp_bits: int = 16
    bucket_size: int = 16
    policy: str = "xor"          # "xor" | "offset"   (§4.6.2)
    hash_kind: str = "xxhash64"  # "xxhash64" | "fmix32"
    eviction: str = "bfs"        # "bfs" | "dfs"      (§4.6.1)
    max_evictions: int = 64
    max_rounds: Optional[int] = None
    seed: int = 0
    # Insertion engine (see resolve_engine): "auto", "legacy",
    # "frontier" or "orientation".
    insert_engine: str = "auto"
    frontier_depth: int = 2
    orient_sweeps: int = 4

    @property
    def layout(self) -> L.BucketLayout:
        return L.BucketLayout(self.num_buckets, self.bucket_size, self.fp_bits)

    @property
    def placement(self):
        return make_policy(self.policy, self.num_buckets, self.fp_bits)

    @property
    def num_slots(self) -> int:
        return self.layout.num_slots

    @property
    def table_bytes(self) -> int:
        return self.layout.table_bytes

    @property
    def effective_fp_bits(self) -> int:
        return self.placement.effective_fp_bits

    def expected_fpr(self, load_factor: float) -> float:
        """Paper Eq. (4): eps ~= 1 - (1 - 2^-f)^(2 b alpha)."""
        f = self.effective_fp_bits
        return 1.0 - (1.0 - 2.0 ** -f) ** (2 * self.bucket_size * load_factor)

    def init(self, device=None) -> CuckooState:
        """Empty state on ``device`` (default: the GPU; raises without one)."""
        device = resolve_device(device)
        return CuckooState(self.layout.empty_table(device),
                           torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def for_capacity(
        capacity: int,
        load_factor: float = 0.95,
        fp_bits: int = 16,
        bucket_size: int = 16,
        policy: str = "xor",
        **kw,
    ) -> "CuckooConfig":
        """Size a filter for ``capacity`` items at a target load factor.

        With the XOR policy the bucket count is rounded up to a power of
        two; the OFFSET policy sizes exactly (§4.6.2).
        """
        buckets = max(2, int(np.ceil(capacity / (load_factor * bucket_size))))
        if policy == "xor":
            buckets = 1 << int(np.ceil(np.log2(buckets)))
        return CuckooConfig(
            num_buckets=buckets, fp_bits=fp_bits, bucket_size=bucket_size,
            policy=policy, **kw)


# ---------------------------------------------------------------------------
# Key preparation (Alg. 1 lines 2-5).
# ---------------------------------------------------------------------------

def _probe(config: CuckooConfig, hi: torch.Tensor, lo: torch.Tensor):
    pol = config.placement
    tag = pol.make_tag(hi)                 # fingerprint from the upper hash word
    i1, i2 = pol.initial_buckets(lo, tag)  # bucket index from the lower word
    return tag, i1, i2


def prepare_keys(config: CuckooConfig, keys: torch.Tensor):
    """keys int32[n, 2] -> (base_tag, i1, i2), uint32 values held in int64.

    On the GPU the hash kernel hashes the keys (see ``hashing.hash_key``).
    """
    return _probe(config, *hash_key(keys, config.hash_kind, config.seed))


def prepare_keys_plain(config: CuckooConfig, keys: torch.Tensor):
    """:func:`prepare_keys` in torch arithmetic alone (the plain versions)."""
    return _probe(config, *hash_key_plain(keys, config.hash_kind, config.seed))


def _prng(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Deterministic per-key pseudo-randomness, salted by the round."""
    return fmix32(x ^ ((salt * _GOLDEN + 1) & MASK32))


# ---------------------------------------------------------------------------
# Word-claim resolution: the batch-synchronous CAS.
# ---------------------------------------------------------------------------

def _resolve_claims(addr1: torch.Tensor, addr2: torch.Tensor, invalid: int):
    """Per-word winner election.

    addr1/addr2: int64[n] flat word addresses (``invalid`` = no claim).
    Returns (win1, win2): bool[n]. Winner of an address = lowest
    (batch index, claim slot) touching it, so the lowest pending key wins
    all of its claims.
    """
    n = addr1.shape[0]
    flat = torch.stack([addr1, addr2], dim=1).reshape(-1)       # interleaved
    sa, order = torch.sort(flat, stable=True)
    first = torch.ones_like(sa, dtype=torch.bool)
    first[1:] = sa[1:] != sa[:-1]
    win_flat = torch.zeros((2 * n,), dtype=torch.bool, device=flat.device)
    win_flat[order] = first & (sa != invalid)
    return win_flat[0::2], win_flat[1::2]


def _resolve_claims_multi(addrs: torch.Tensor, invalid: int) -> torch.Tensor:
    """K-column generalisation of :func:`_resolve_claims`.

    addrs: int64[n, K] flat word addresses (``invalid`` = no claim).
    Returns win: bool[n, K]. The flat priority of key ``i``'s column ``k``
    is ``i * K + k``, so the lowest pending key with any action wins all
    of its claims (the progress guarantee of multi-word chains).
    """
    flat = addrs.reshape(-1)
    sa, order = torch.sort(flat, stable=True)
    first = torch.ones_like(sa, dtype=torch.bool)
    first[1:] = sa[1:] != sa[:-1]
    win = torch.zeros_like(first)
    win[order] = first & (sa != invalid)
    return win.view(addrs.shape)


def _masked_write(table: torch.Tensor, addr: torch.Tensor,
                  desired: torch.Tensor, mask: torch.Tensor) -> None:
    """Write ``desired`` (uint32 in int64) at ``addr`` where ``mask``, in
    place. Claim winners own distinct words, so no two writes collide."""
    table[addr[mask]] = to_i32(desired[mask])


def _lexsort(columns) -> torch.Tensor:
    """Stable lexicographic argsort; the last column is the primary key
    (``numpy.lexsort`` order)."""
    order = torch.arange(columns[0].shape[0], device=columns[0].device)
    for col in columns:
        order = order[torch.sort(col[order], stable=True).indices]
    return order


def _batch_dedup(keys: torch.Tensor, valid: torch.Tensor):
    """First-occurrence mask + representative index for duplicated batches.

    Returns (first: bool[n], rep: int64[n]): ``first[i]`` marks the earliest
    occurrence of key i's 64-bit value among *valid* entries (``rep[i]`` is
    that occurrence's batch index). Valid keys sort ahead of invalid ones
    within a value run, so a padding key never represents a live duplicate.
    """
    n = keys.shape[0]
    lo, hi = from_i32(keys[:, 0]), from_i32(keys[:, 1])
    order = _lexsort(((~valid).to(torch.uint8), lo, hi))  # (hi, lo), valid first
    lo_s, hi_s = lo[order], hi[order]
    first_s = torch.ones((n,), dtype=torch.bool, device=keys.device)
    first_s[1:] = (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])
    idx = torch.arange(n, device=keys.device)
    head_pos = torch.cummax(torch.where(first_s, idx, 0), dim=0).values
    first = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    first[order] = first_s
    rep = torch.zeros((n,), dtype=torch.int64, device=keys.device)
    rep[order] = order[head_pos]
    return first, rep


# ---------------------------------------------------------------------------
# Insertion (Alg. 1 + §4.6.1 BFS): the legacy lock-step round loop.
# ---------------------------------------------------------------------------

def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[k, idx[k]]`` along the last axis."""
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _evictions(config, table, e_bucket, e_tag, e_words, e_tags, rnd):
    """Eviction actions for the keys whose candidate buckets are full.

    Returns (has_viable, src_addr, src_desired, dst_addr, dst_desired,
    v_addr, v_desired, v_evicted), one entry per key; ``dst_addr`` is -1
    where a relocation needs no second word.
    """
    lay = config.layout
    pol = config.placement
    b = config.bucket_size
    fp = lay.fp_bits
    n_cand = max(1, b // 2)  # BFS inspects up to half the bucket (§4.6.1)
    dev = table.device

    # DFS victim (also the BFS fallback): pseudo-random occupied slot.
    vic = _prng(e_tag ^ e_bucket, rnd) % b
    has_viable = torch.zeros_like(e_tag, dtype=torch.bool)
    src_addr = src_desired = dst_addr = dst_desired = None

    if config.eviction == "bfs":
        # §4.6.1: inspect n_cand candidates starting at a prng offset;
        # relocate the first whose alternate bucket has a free slot.
        cstart = _prng(e_tag, rnd + 1) % b
        cslots = (cstart[:, None] + torch.arange(n_cand, device=dev)) % b
        ctags = torch.gather(e_tags, 1, cslots)                    # [m, c]
        calt = pol.alt_bucket(e_bucket[:, None], ctags)            # [m, c]
        cwords = L.gather_bucket_words(table, calt, lay)           # [m, c, wpb]
        cfree = L.unpack_words(cwords, fp) == 0                    # [m, c, b]
        reloc_tag = pol.on_relocate(ctags)
        cfound, cslot_dst = L.first_true_circular(
            cfree, L.scan_start(reloc_tag, lay))
        has_viable = cfound.any(dim=1)
        jstar = cfound.to(torch.uint8).argmax(dim=1)

        r_src_slot = _take(cslots, jstar)
        r_reloc = _take(reloc_tag, jstar)
        r_dst_bucket = _take(calt, jstar)
        r_dst_slot = _take(cslot_dst, jstar)
        r_dst_words = cwords[torch.arange(jstar.shape[0], device=dev), jstar]

        dst_widx, dst_sw = L.slot_to_word(r_dst_slot, lay)
        dst_word = _take(r_dst_words, dst_widx)
        dst_desired = L.replace_tag(dst_word, dst_sw, r_reloc, fp)
        dst_addr = L.word_addr(r_dst_bucket, dst_widx, lay)

        src_widx, src_sw = L.slot_to_word(r_src_slot, lay)
        src_word = _take(e_words, src_widx)
        src_desired = L.replace_tag(src_word, src_sw, e_tag, fp)
        src_addr = L.word_addr(e_bucket, src_widx, lay)

        # Same-word transaction: compose both lane updates into one write.
        same = src_addr == dst_addr
        merged = L.replace_tag(L.replace_tag(src_word, dst_sw, r_reloc, fp),
                               src_sw, e_tag, fp)
        src_desired = torch.where(same, merged, src_desired)
        dst_addr = torch.where(same, -1, dst_addr)

        # Fall back to DFS-evicting the last inspected candidate.
        vic = torch.where(has_viable, vic, (cstart + (n_cand - 1)) % b)

    # DFS eviction action (Alg. 1 lines 10-21).
    v_widx, v_sw = L.slot_to_word(vic, lay)
    v_word = _take(e_words, v_widx)
    v_desired = L.replace_tag(v_word, v_sw, e_tag, fp)
    v_evicted = L.extract_tag(v_word, v_sw, fp)
    v_addr = L.word_addr(e_bucket, v_widx, lay)
    if src_addr is None:
        src_addr = src_desired = dst_desired = torch.zeros_like(v_addr)
        dst_addr = torch.full_like(v_addr, -1)
    return (has_viable, src_addr, src_desired, dst_addr, dst_desired,
            v_addr, v_desired, v_evicted)


def _pending_keys(keys, valid, dedup_within_batch):
    """(valid0, pending, first, rep): the valid mask, the keys to insert,
    and the batch-dedup mapping (``first``/``rep`` None without dedup)."""
    n = keys.shape[0]
    valid0 = (torch.ones((n,), dtype=torch.bool, device=keys.device)
              if valid is None else valid.to(keys.device, torch.bool))
    if not dedup_within_batch:
        return valid0, valid0.clone(), None, None
    first, rep = _batch_dedup(keys, valid0)
    return valid0, valid0 & first, first, rep


# Keys handed to the round loop. While ``LOOP_KEYS`` holds a list, each
# call of :func:`_insert_rounds` appends its count of pending keys as a
# device tensor (no host sync); a reader sums the entries after its clock
# stops. ``None`` (the default) records nothing.
LOOP_KEYS: Optional[list] = None


def _insert_rounds(
    config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *, dedup_within_batch: bool = False,
):
    """The legacy lock-step eviction round loop (Alg. 1 + §4.6.1 BFS).

    Same rounds, claims and writes as the JAX loop. Each round runs only
    on the keys still pending, in batch order: a key that is not pending
    claims nothing, so dropping it changes no election, and every other
    step is per key. Returns (state', ok bool[n], InsertStats); the table
    tensor is updated in place.
    """
    lay = config.layout
    pol = config.placement
    n = keys.shape[0]
    dev = keys.device
    fp = lay.fp_bits
    max_rounds = config.max_rounds or (4 * config.max_evictions + 64)
    table, count = state.table, state.count.clone()
    invalid = lay.num_words

    base_tag, i1, i2 = prepare_keys(config, keys)
    tag1 = pol.place_tag(base_tag, False)   # stored form @ i1
    tag2 = pol.place_tag(base_tag, True)    # stored form @ i2

    valid0, pending, first, rep = _pending_keys(keys, valid,
                                                dedup_within_batch)
    if LOOP_KEYS is not None:
        LOOP_KEYS.append(pending.sum())
    cur_tag = base_tag.clone()
    cur_bucket = i1.clone()
    evict_mode = torch.zeros((n,), dtype=torch.bool, device=dev)
    success = torch.zeros((n,), dtype=torch.bool, device=dev)
    n_evict = torch.zeros((n,), dtype=torch.int32, device=dev)

    rnd = 0
    while rnd < max_rounds and bool(pending.any()):
        # --- expire keys whose eviction budget ran out (Alg. 1 line 24).
        pending &= ~((n_evict >= config.max_evictions) & evict_mode)
        p = pending.nonzero().squeeze(1)
        if p.numel() == 0:
            rnd += 1
            continue
        em, cb, ct = evict_mode[p], cur_bucket[p], cur_tag[p]
        bt, j1, j2, t1, t2 = base_tag[p], i1[p], i2[p], tag1[p], tag2[p]

        # --- scan phase: fresh keys look at (i1, i2); evicting keys look
        #     at their current bucket only (Alg. 1 line 22).
        bucketA = torch.where(em, cb, j1)
        wordsA = L.gather_bucket_words(table, bucketA, lay)      # [m, wpb]
        wordsB = L.gather_bucket_words(table, j2, lay)
        tagsA = L.unpack_words(wordsA, fp)                       # [m, b]
        tagsB = L.unpack_words(wordsB, fp)

        start = L.scan_start(torch.where(em, ct, bt), lay)
        foundA, slotA = L.first_true_circular(tagsA == 0, start)
        foundB, slotB = L.first_true_circular(tagsB == 0, start)
        foundB &= ~em

        direct_found = foundA | foundB
        d_bucket = torch.where(foundA, bucketA, j2)
        d_tag = torch.where(em, ct, torch.where(foundA, t1, t2))
        d_widx, d_sw = L.slot_to_word(torch.where(foundA, slotA, slotB), lay)
        d_word = _take(torch.where(foundA[:, None], wordsA, wordsB), d_widx)
        d_desired = L.replace_tag(d_word, d_sw, d_tag, fp)
        d_addr = L.word_addr(d_bucket, d_widx, lay)

        # --- eviction phase for keys whose candidate bucket(s) are full;
        #     fresh keys choose a random bucket to evict from (Alg. 1 l. 8).
        coin = (_prng(bt, rnd) & 1).bool()
        e_bucket = torch.where(em, cb, torch.where(coin, j2, j1))
        e_tag = torch.where(em, ct, torch.where(coin, t2, t1))
        use_a = (em | ~coin)[:, None]
        e_words = torch.where(use_a, wordsA, wordsB)
        e_tags = torch.where(use_a, tagsA, tagsB)

        is_direct = direct_found
        is_reloc = torch.zeros_like(direct_found)
        is_evict = torch.zeros_like(direct_found)
        addr1 = d_addr.clone()
        desired1 = d_desired.clone()
        addr2 = torch.full_like(d_addr, invalid)
        desired2 = torch.zeros_like(d_desired)
        evicted = torch.zeros_like(d_desired)
        ev = (~direct_found).nonzero().squeeze(1)
        if ev.numel():
            (has_viable, r_src_addr, r_src_desired, r_dst_addr, r_dst_desired,
             v_addr, v_desired, v_evicted) = _evictions(
                config, table, e_bucket[ev], e_tag[ev], e_words[ev],
                e_tags[ev], rnd)
            is_reloc[ev] = has_viable
            is_evict[ev] = ~has_viable
            addr1[ev] = torch.where(has_viable, r_src_addr, v_addr)
            desired1[ev] = torch.where(has_viable, r_src_desired, v_desired)
            addr2[ev] = torch.where(has_viable & (r_dst_addr >= 0),
                                    r_dst_addr, invalid)
            desired2[ev] = r_dst_desired
            evicted[ev] = v_evicted

        win1, win2 = _resolve_claims(addr1, addr2, invalid)
        has2 = addr2 != invalid
        commit = win1 & (win2 | ~has2)

        # --- apply winning writes.
        _masked_write(table, addr1, desired1, commit)
        _masked_write(table, addr2, desired2, commit & has2)

        # --- state transitions.
        done = commit & (is_direct | is_reloc)
        pd = p[done]
        success[pd] = True
        pending[pd] = False
        count += done.sum().to(torch.int32)

        did_evict = commit & is_evict
        pe = p[did_evict]
        v_ev = evicted[did_evict]
        cur_tag[pe] = pol.on_relocate(v_ev)
        cur_bucket[pe] = pol.alt_bucket(e_bucket[did_evict], v_ev)
        evict_mode[pe] = True
        n_evict[pe] += 1
        rnd += 1

    # Keys still pending at max_rounds are reported as failures.
    ok = success & ~pending
    if dedup_within_batch:
        ok = torch.where(first, ok, ok[rep] & valid0)
    failed = (valid0 & ~ok).sum().to(torch.int32)
    load = count.to(torch.float32) / lay.num_slots
    stats = InsertStats(n_evict, torch.tensor(rnd, dtype=torch.int32,
                                              device=dev), failed, load)
    return CuckooState(table, count), ok, stats


# ---------------------------------------------------------------------------
# Batched BFS frontier insertion (DESIGN.md §14).
# ---------------------------------------------------------------------------

# Keys handed to the frontier engine, recorded as ``LOOP_KEYS`` is.
FRONTIER_KEYS: Optional[list] = None

# Rounds in a row without a commit before the frontier hands its
# stragglers to the round loop (JAX's ``stall_limit``).
_STALL_LIMIT = 8

# Working set of the chain search, which runs over chunks of keys. Each
# level keeps [b, wpb] words and per-branch bucket, slot, tag and victim
# (int64) for every key, and unpacking a level's b buckets and scanning
# them circularly takes about six [b, b] int64 temporaries. The chunk
# keeps that under about 8 GiB (b = 16, depth 2: 559240 keys a chunk).
_CHAIN_BYTES = 8 << 30


def _chain_chunk(config: CuckooConfig) -> int:
    b, wpb = config.bucket_size, config.layout.words_per_bucket
    depth = max(1, config.frontier_depth)
    per_key = 8 * b * (depth * (wpb + 4) + 6 * b)
    return max(1024, _CHAIN_BYTES // per_key)


def _chain_actions(config, table, rnd, base_tag, i1, i2, tag1, tag2,
                   words1, words2, tags1, tags2):
    """Frontier chain actions of keys whose both buckets are full.

    The body of JAX's ``frontier_actions`` for these keys only: a salted
    coin picks the root bucket, each of its ``b`` slots seeds a branch,
    and each depth level gathers every branch's next bucket at once. The
    shortest free path becomes up to ``depth + 1`` word writes (column 0
    writes the key's own tag into the root). Reads only the round-start
    table and the keys' own data, so any chunking of the keys is exact.
    Returns (has_chain bool[m], addrs int64[m, K], desired int64[m, K],
    depth_star int64[m]); duplicate addresses of one chain are folded
    into their last column and the others set to ``invalid``.
    """
    lay = config.layout
    pol = config.placement
    b = config.bucket_size
    fp = lay.fp_bits
    depth = max(1, config.frontier_depth)
    invalid = lay.num_words
    m = base_tag.shape[0]
    dev = base_tag.device

    coin = (_prng(base_tag, rnd) & 1).bool()
    e_bucket = torch.where(coin, i2, i1)
    e_tag = torch.where(coin, tag2, tag1)
    e_words = torch.where(coin[:, None], words2, words1)
    e_tags = torch.where(coin[:, None], tags2, tags1)

    # Lanes the chain displaces so far: the cycle guard kills a branch
    # whose next victim revisits one.
    pos = [(e_bucket[:, None].expand(m, b),
            torch.arange(b, device=dev).expand(m, b))]
    move = pol.on_relocate(e_tags)                  # tag entering level 1
    nxt = pol.alt_bucket(e_bucket[:, None], e_tags)            # [m, b]
    alive = torch.ones((m, b), dtype=torch.bool, device=dev)
    levels = []          # (bucket, words, found, free slot, move, victim)
    for d in range(1, depth + 1):
        wds = L.gather_bucket_words(table, nxt, lay)           # [m, b, wpb]
        tgs = L.unpack_words(wds, fp)                          # [m, b, b]
        fnd, fslot = L.first_true_circular(tgs == 0, L.scan_start(move, lay))
        vic = None
        if d < depth:
            vic = _prng(move ^ nxt, rnd + d) % b                # [m, b]
        levels.append((nxt, wds, fnd & alive, fslot, move, vic))
        if d < depth:
            clash = torch.zeros_like(alive)
            for pb, ps in pos:
                clash |= (pb == nxt) & (ps == vic)
            alive = alive & ~clash
            pos.append((nxt, vic))
            vtag = _take(tgs, vic)
            move = pol.on_relocate(vtag)
            nxt = pol.alt_bucket(nxt, vtag)

    # Shortest free path: the first level with any live branch found.
    taken = torch.zeros((m,), dtype=torch.bool, device=dev)
    use_lv = []
    for lv in levels:
        fa = lv[2].any(dim=1)
        use_lv.append(fa & ~taken)
        taken = taken | fa
    has_chain = taken
    jstar = torch.zeros((m,), dtype=torch.int64, device=dev)
    depth_star = torch.zeros((m,), dtype=torch.int64, device=dev)
    for d in reversed(range(depth)):
        jd = levels[d][2].to(torch.uint8).argmax(dim=1)
        jstar = torch.where(use_lv[d], jd, jstar)
        depth_star = torch.where(use_lv[d], d + 1, depth_star)
    rows = torch.arange(m, device=dev)

    # Column 0: the root slot receives the key's own tag.
    r_widx, r_sw = L.slot_to_word(jstar, lay)
    addrs = [torch.where(has_chain, L.word_addr(e_bucket, r_widx, lay),
                         invalid)]
    sws, wtags, cwords = [r_sw], [e_tag], [_take(e_words, r_widx)]
    # Columns 1..depth: hop t shifts the displaced tag one level deeper;
    # the last hop lands it in the free slot found there.
    for t in range(1, depth + 1):
        bkt, wds, _, fslot, mv, vic = levels[t - 1]
        lane_vic = (_take(vic, jstar) if t < depth
                    else torch.zeros_like(jstar))
        lane = torch.where(depth_star == t, _take(fslot, jstar), lane_vic)
        used = has_chain & (depth_star >= t)
        widx, sw = L.slot_to_word(lane, lay)
        addrs.append(torch.where(
            used, L.word_addr(_take(bkt, jstar), widx, lay), invalid))
        sws.append(sw)
        wtags.append(_take(mv, jstar))
        cwords.append(_take(wds[rows, jstar], widx))

    A = torch.stack(addrs, dim=1)                              # [m, K]
    K = depth + 1
    # Same-word composition: every write of the chain that targets this
    # address folds into one desired word (lanes are distinct by the
    # cycle guard, so the fold order is immaterial). Only the last claim
    # of a duplicated address scatters.
    desired, scat = [], []
    for k in range(K):
        w = cwords[k]
        for j in range(K):
            hit = (A[:, j] == A[:, k]) & (A[:, j] != invalid)
            w = torch.where(hit, L.replace_tag(w, sws[j], wtags[j], fp), w)
        desired.append(w)
        superseded = torch.zeros_like(has_chain)
        for j in range(k + 1, K):
            superseded |= A[:, j] == A[:, k]
        scat.append(torch.where(superseded, invalid, A[:, k]))
    return (has_chain, torch.stack(scat, dim=1), torch.stack(desired, dim=1),
            depth_star)


def _insert_frontier(
    config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *, dedup_within_batch: bool = False,
):
    """Fixed-depth, width-``bucket_size`` frontier search per round.

    A round gives every pending key its direct placement (first free slot
    of i1, then i2) or, when both buckets are full, the shortest eviction
    chain of at most ``frontier_depth`` hops found by a breadth-first
    search over the root bucket's slots (:func:`_chain_actions`), won
    all-or-nothing through one claim election over the whole batch. After
    ``_STALL_LIMIT`` rounds in a row without a commit (or at
    ``max_rounds``) the stragglers take the legacy round loop. Same
    rounds, claims and writes as the JAX engine, bit for bit: the JAX
    ``while_loop`` is a host loop with one device read a round, and only
    pending keys are computed (the others claim nothing). Returns
    (state', ok bool[n], InsertStats); the table is updated in place.
    """
    lay = config.layout
    pol = config.placement
    n = keys.shape[0]
    dev = keys.device
    fp = lay.fp_bits
    invalid = lay.num_words
    K = max(1, config.frontier_depth) + 1
    max_rounds = config.max_rounds or (4 * config.max_evictions + 64)
    chunk = _chain_chunk(config)
    table, count = state.table, state.count.clone()

    base_tag, i1, i2 = prepare_keys(config, keys)
    tag1 = pol.place_tag(base_tag, False)
    tag2 = pol.place_tag(base_tag, True)
    valid0, pending, first, rep = _pending_keys(keys, valid,
                                                dedup_within_batch)
    if FRONTIER_KEYS is not None:
        FRONTIER_KEYS.append(pending.sum())
    success = torch.zeros((n,), dtype=torch.bool, device=dev)
    n_evict = torch.zeros((n,), dtype=torch.int32, device=dev)

    rnd = stall = 0
    live = bool(pending.any())
    while live and rnd < max_rounds and stall < _STALL_LIMIT:
        p = pending.nonzero().squeeze(1)
        bt, j1, j2, g1, g2 = base_tag[p], i1[p], i2[p], tag1[p], tag2[p]

        # --- direct phase: the legacy scan of (i1, i2).
        words1 = L.gather_bucket_words(table, j1, lay)         # [m, wpb]
        words2 = L.gather_bucket_words(table, j2, lay)
        tags1 = L.unpack_words(words1, fp)                     # [m, b]
        tags2 = L.unpack_words(words2, fp)
        start = L.scan_start(bt, lay)
        found1, slot1 = L.first_true_circular(tags1 == 0, start)
        found2, slot2 = L.first_true_circular(tags2 == 0, start)
        direct = found1 | found2
        d_widx, d_sw = L.slot_to_word(torch.where(found1, slot1, slot2), lay)
        d_word = _take(torch.where(found1[:, None], words1, words2), d_widx)

        m = p.shape[0]
        addrs = torch.full((m, K), invalid, dtype=torch.int64, device=dev)
        desired = torch.zeros((m, K), dtype=torch.int64, device=dev)
        depth_star = torch.zeros((m,), dtype=torch.int64, device=dev)
        addrs[:, 0] = torch.where(
            direct, L.word_addr(torch.where(found1, j1, j2), d_widx, lay),
            invalid)
        desired[:, 0] = L.replace_tag(d_word, d_sw,
                                      torch.where(found1, g1, g2), fp)
        has_action = direct.clone()

        # --- chain phase for the keys with both buckets full, in chunks.
        chained = (~direct).nonzero().squeeze(1)
        for c in chained.split(chunk) if chained.numel() else ():
            hc, ac, dc, ds = _chain_actions(
                config, table, rnd, bt[c], j1[c], j2[c], g1[c], g2[c],
                words1[c], words2[c], tags1[c], tags2[c])
            addrs[c], desired[c], depth_star[c], has_action[c] = ac, dc, ds, hc
        del words1, words2, tags1, tags2

        # --- one claim election over the batch; a key commits all of its
        #     writes or none.
        win = _resolve_claims_multi(addrs, invalid)
        claims = addrs != invalid
        commit = has_action & (win | ~claims).all(dim=1)
        for k in range(K):
            _masked_write(table, addrs[:, k], desired[:, k],
                          commit & claims[:, k])

        pc = p[commit]
        success[pc] = True
        pending[pc] = False
        count += commit.sum().to(torch.int32)
        n_evict[p] += torch.where(commit, depth_star, 0).to(torch.int32)
        live, moved = torch.stack([pending.any(), commit.any()]).tolist()
        stall = 0 if moved else stall + 1
        rnd += 1

    # Residue: chains longer than ``frontier_depth`` (or claim-starved
    # stragglers) take the legacy round loop; a no-op when none is pending.
    state2, ok_res, res_stats = _insert_rounds(
        config, CuckooState(table, count), keys, valid=pending)

    ok = (success & ~pending) | ok_res
    if dedup_within_batch:
        ok = torch.where(first, ok, ok[rep] & valid0)
    failed = (valid0 & ~ok).sum().to(torch.int32)
    load = state2.count.to(torch.float32) / lay.num_slots
    stats = InsertStats(n_evict + res_stats.evictions,
                        res_stats.rounds + rnd, failed, load)
    return state2, ok, stats


# ---------------------------------------------------------------------------
# Bulk-build insertion (paper §4.6.3 sorted insertion; DESIGN.md §6) and
# the graph-orientation build (DESIGN.md §14).
# ---------------------------------------------------------------------------

def _bulk_place_phase(config: CuckooConfig, tags_flat: torch.Tensor,
                      bucket: torch.Tensor, stored_tag: torch.Tensor,
                      pend: torch.Tensor):
    """One whole-bucket placement round over the unpacked per-slot table.

    Sorts the pending keys by destination bucket (masked keys go past
    every real segment via the ``num_buckets`` sentinel), ranks each key
    within its bucket segment, and commits the rank-th free slot of every
    bucket in one scatter: each key owns a distinct slot by construction,
    so no claim election is needed.

    ``tags_flat`` (int64[num_slots]) is updated in place. Returns
    (tags_flat, placed: bool[n] in batch order).
    """
    n = bucket.shape[0]
    b = config.bucket_size
    nb = config.num_buckets

    sort_key = torch.where(pend, bucket, nb)
    sb, order = torch.sort(sort_key, stable=True)
    rank = L.segment_ranks(sb)

    safe_b = torch.clamp(sb, max=nb - 1)
    btags = tags_flat.view(nb, b)[safe_b]                      # [n, b]
    placed_s, slot_s = L.nth_free_slot(btags, rank)
    placed_s &= sb < nb
    dest = safe_b * b + slot_s
    tags_flat[dest[placed_s]] = stored_tag[order][placed_s]

    placed = torch.zeros((n,), dtype=torch.bool, device=bucket.device)
    placed[order] = placed_s
    return tags_flat, placed


def _unpack_table(config: CuckooConfig, state: CuckooState) -> torch.Tensor:
    """The per-slot view of the table: int64[num_slots] tags."""
    return L.unpack_words(from_i32(state.table), config.fp_bits)


def _place_and_spill(config, state, keys, tags_flat, phases, pending,
                     valid0, first, rep):
    """The two sorted commits, then the residue through the round loop.

    ``phases``: two (bucket, stored tag) pairs, one per commit; a key the
    first leaves pending gets the second. The packed result is written
    into ``state.table`` in place. Keys still pending after both (both
    buckets full) take the eviction-capable round loop. Returns (state',
    ok, InsertStats) with ``rounds`` = the loop's rounds + 2, as in JAX.
    """
    placed = torch.zeros_like(pending)
    for bucket, stored in phases:
        tags_flat, got = _bulk_place_phase(config, tags_flat, bucket, stored,
                                           pending)
        pending = pending & ~got
        placed |= got
    table = state.table
    table.copy_(to_i32(L.pack_tags(tags_flat, config.fp_bits)))
    count = state.count + placed.sum().to(torch.int32)

    # Residue: both candidate buckets full; only the round loop can evict.
    state2, ok_res, res_stats = _insert_rounds(
        config, CuckooState(table, count), keys, valid=pending)

    ok = placed | ok_res
    if first is not None:
        ok = torch.where(first, ok, ok[rep] & valid0)
    failed = (valid0 & ~ok).sum().to(torch.int32)
    load = state2.count.to(torch.float32) / config.num_slots
    stats = InsertStats(res_stats.evictions, res_stats.rounds + 2, failed,
                        load)
    return state2, ok, stats


def _insert_orient(
    config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *, dedup_within_batch: bool = False,
):
    """Orient the batch's bucket-graph edges, then commit conflict-free.

    Each key is an edge ``i1 -> i2``; its orientation picks the bucket it
    will occupy. Sweeps flip edges into over-full buckets (indegree
    against each bucket's free capacity; edges whose other end has room
    flip first, ties broken by a per-sweep salted hash) until every
    indegree fits or no productive flip is left. Two sorted commits then
    place the keys, and the keys with both buckets already full (which
    orientation never moves) take the round loop. Same result as the JAX
    ``_insert_orient``, bit for bit.
    """
    pol = config.placement
    b = config.bucket_size
    nb = config.num_buckets
    valid0, pending, first, rep = _pending_keys(keys, valid,
                                                dedup_within_batch)

    base_tag, i1, i2 = prepare_keys(config, keys)
    aliased = i1 == i2  # XOR degenerate: both endpoints coincide

    tags_flat = _unpack_table(config, state)
    free = b - (tags_flat.view(nb, b) != 0).sum(dim=1)            # [nb]

    # Edges with both buckets full can never be placed by orientation;
    # they go straight to the residue. Active edges start at an endpoint
    # with headroom.
    active = pending & ((free[i1] > 0) | (free[i2] > 0))
    orient = active & (free[i1] == 0) & ~aliased

    # The JAX while_loop becomes a host loop: one device-to-host read per
    # sweep decides the exit (feasible, or a fixed point with no flips).
    for s in range(max(1, config.orient_sweeps)):
        dest = torch.where(orient, i2, i1)
        other = torch.where(orient, i1, i2)
        dkey = torch.where(active, dest, nb)
        indeg = torch.bincount(dkey, minlength=nb + 1)[:nb]
        done = ~(indeg > free).any()

        # Flip priority within an over-full bucket: other endpoint with
        # headroom net of its inflow (bit 31), then other endpoint not
        # full (bit 30); ties by a salted hash. The uint32 score is held
        # in int64, under the bucket in one stable sort key.
        flippable = free[other] > 0
        spare = (free[other] - indeg[other]) > 0
        score = ((_prng(base_tag, s) >> 2)
                 | torch.where(spare, 0x80000000, 0)
                 | torch.where(flippable, 0x40000000, 0))
        sd, order = torch.sort((dkey << 32) | score, stable=True)
        sd = sd >> 32
        rank = L.segment_ranks(sd)
        cap = free[torch.clamp(sd, max=nb - 1)]
        flip = torch.zeros_like(orient)
        flip[order] = (rank >= cap) & (sd < nb)
        # A flip into a full bucket is pointless; masking it makes "no
        # flips" a true, salt-independent fixed point.
        flip &= ~aliased & flippable
        orient = orient ^ flip
        if bool(done | ~flip.any()):
            break

    phases = ((torch.where(orient, i2, i1), pol.place_tag(base_tag, orient)),
              (torch.where(orient, i1, i2), pol.place_tag(base_tag, ~orient)))
    return _place_and_spill(config, state, keys, tags_flat, phases, pending,
                            valid0, first, rep)


def insert_bulk(
    config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *, dedup_within_batch: bool = False,
):
    """Bulk-build insertion. Same contract as :func:`insert`.

    ``insert_engine`` ``"auto"`` and ``"orientation"`` run the
    graph-orientation build (:func:`_insert_orient`). ``"legacy"`` sorts
    the batch by primary bucket and commits whole buckets (each key takes
    the rank-th free slot of its bucket segment), re-sorts the overflow by
    alternate bucket and commits again, and spills the residue (both
    buckets full) into the round loop. ``stats.rounds`` counts the two
    phases plus the loop's rounds.
    """
    if resolve_engine(config, bulk=True) == "orientation":
        return _insert_orient(config, state, keys, valid,
                              dedup_within_batch=dedup_within_batch)
    pol = config.placement
    valid0, pending, first, rep = _pending_keys(keys, valid,
                                                dedup_within_batch)
    base_tag, i1, i2 = prepare_keys(config, keys)
    phases = ((i1, pol.place_tag(base_tag, False)),
              (i2, pol.place_tag(base_tag, True)))
    return _place_and_spill(config, state, keys,
                            _unpack_table(config, state), phases, pending,
                            valid0, first, rep)


# ---------------------------------------------------------------------------
# Engine routing.
# ---------------------------------------------------------------------------

INSERT_ENGINES = ("auto", "legacy", "frontier", "orientation")


def resolve_engine(config: CuckooConfig, bulk: bool) -> str:
    """The concrete engine a (config, entry point) pair routes to.

    As in the JAX package: ``"auto"`` means the orientation build for
    ``insert_bulk``, and for ``insert`` the batched BFS frontier under BFS
    eviction and the legacy round loop under DFS; the other values force
    one engine.
    """
    eng = config.insert_engine
    if eng not in INSERT_ENGINES:
        raise ValueError(f"unknown insert_engine {eng!r} "
                         f"(want one of {INSERT_ENGINES})")
    if eng == "auto":
        if bulk:
            return "orientation"
        return "frontier" if config.eviction == "bfs" else "legacy"
    return eng


_ENGINE_FNS = {"legacy": _insert_rounds, "frontier": _insert_frontier,
               "orientation": _insert_orient}


def insert(
    config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *, dedup_within_batch: bool = False,
):
    """Insert a batch of keys. Returns (state', ok[n], stats).

    ``ok[i]`` False means the table was too full for key i; the same
    information is in ``stats.failed`` and ``stats.load``. ``valid`` masks
    padding keys. By default the filter is a multiset (two equal keys in
    one batch store two copies); ``dedup_within_batch=True`` inserts only
    the first occurrence of each 64-bit key value and later copies report
    the first copy's ``ok``. The engine is ``resolve_engine(config,
    bulk=False)``'s.
    """
    fn = _ENGINE_FNS[resolve_engine(config, bulk=False)]
    return fn(config, state, keys, valid,
              dedup_within_batch=dedup_within_batch)


# ---------------------------------------------------------------------------
# Query (Alg. 2) — read-only, trivially parallel.
# ---------------------------------------------------------------------------

def query(config: CuckooConfig, state: CuckooState, keys: torch.Tensor) -> torch.Tensor:
    """Membership test for a batch of keys -> bool[n]."""
    lay = config.layout
    base_tag, i1, i2 = prepare_keys(config, keys)
    t1, t2 = config.placement.query_match_tags(base_tag)
    hit1 = (L.bucket_tags(state.table, i1, lay) == t1[:, None]).any(dim=-1)
    hit2 = (L.bucket_tags(state.table, i2, lay) == t2[:, None]).any(dim=-1)
    return hit1 | hit2


# ---------------------------------------------------------------------------
# Deletion (Alg. 3).
# ---------------------------------------------------------------------------

def delete(config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None):
    """Delete one stored copy per key. Returns (state', ok bool[n]).

    Claim rounds, as in the JAX package: every pending key clears the
    first matching lane of bucket i1, else of bucket i2, scanning
    circularly from its tag-derived start; one election per table word
    (lowest batch index wins) decides which clears commit, and the losers
    rescan next round. A key with no matching lane left fails out. Same
    rounds, claims and writes as JAX's ``while_loop``, bit for bit: the
    loop is a host loop with one device read a round, and only pending
    keys are computed (the others claim nothing). At most ``2 *
    bucket_size + 2`` rounds, so duplicate deleters serialise. The table
    is updated in place.
    """
    lay = config.layout
    pol = config.placement
    n = keys.shape[0]
    dev = keys.device
    invalid = lay.num_words
    max_rounds = 2 * config.bucket_size + 2
    table, count = state.table, state.count.clone()

    base_tag, i1, i2 = prepare_keys(config, keys)
    t1, t2 = pol.query_match_tags(base_tag)
    start = L.scan_start(base_tag, lay)
    pending = (torch.ones((n,), dtype=torch.bool, device=dev)
               if valid is None else valid.to(dev, torch.bool).clone())
    success = torch.zeros((n,), dtype=torch.bool, device=dev)

    rnd = 0
    while rnd < max_rounds and bool(pending.any()):
        p = pending.nonzero().squeeze(1)
        j1, j2 = i1[p], i2[p]
        words1 = L.gather_bucket_words(table, j1, lay)
        words2 = L.gather_bucket_words(table, j2, lay)
        st = start[p]
        f1, s1 = L.first_true_circular(
            L.unpack_words(words1, lay.fp_bits) == t1[p][:, None], st)
        f2, s2 = L.first_true_circular(
            L.unpack_words(words2, lay.fp_bits) == t2[p][:, None], st)
        found = f1 | f2
        widx, sw = L.slot_to_word(torch.where(f1, s1, s2), lay)
        word = _take(torch.where(f1[:, None], words1, words2), widx)
        desired = L.replace_tag(word, sw, torch.zeros_like(word), lay.fp_bits)
        # Keys with no remaining match fail out (Alg. 3 line 21).
        addr = torch.where(found, L.word_addr(torch.where(f1, j1, j2), widx,
                                              lay), invalid)
        win, _ = _resolve_claims(addr, torch.full_like(addr, invalid), invalid)
        commit = found & win
        _masked_write(table, addr, desired, commit)
        success[p[commit]] = True
        pending[p[~found | commit]] = False
        count -= commit.sum().to(torch.int32)
        rnd += 1
    return CuckooState(table, count), success


# ---------------------------------------------------------------------------
# Fused mixed-operation execution (DESIGN.md §9).
# ---------------------------------------------------------------------------

def _count_matches(config: CuckooConfig, state: CuckooState,
                   keys: torch.Tensor) -> torch.Tensor:
    """Stored copies matching each key across its two candidate buckets.

    Returns int32[n]. When XOR placement degenerates to ``i1 == i2`` (and
    the match tags coincide), the single bucket is counted once — exactly
    the pool of copies a sequential delete chain could consume.
    """
    lay = config.layout
    base_tag, i1, i2 = prepare_keys(config, keys)
    t1, t2 = config.placement.query_match_tags(base_tag)
    cnt1 = (L.bucket_tags(state.table, i1, lay) == t1[:, None]).sum(
        dim=-1, dtype=torch.int32)
    cnt2 = (L.bucket_tags(state.table, i2, lay) == t2[:, None]).sum(
        dim=-1, dtype=torch.int32)
    aliased = (i1 == i2) & (t1 == t2)
    return torch.where(aliased, cnt1, cnt1 + cnt2)


class NetEffects(NamedTuple):
    """The per-key algebra of a mixed batch (bool[n] each, batch order).

    ``net_ins`` / ``net_del`` mark the insert and delete slots whose
    effect survives the batch (the only ones that touch the table);
    ``q_ok`` answers every query, ``d_ok`` every delete before the table
    writes (a net delete must also commit).
    """

    is_qry: torch.Tensor
    is_ins: torch.Tensor
    is_del: torch.Tensor
    net_ins: torch.Tensor
    net_del: torch.Tensor
    q_ok: torch.Tensor
    d_ok: torch.Tensor


def _segmented_cummin(x: torch.Tensor, seg_id: torch.Tensor,
                      longest: int) -> torch.Tensor:
    """Running minimum of ``x`` within each run of equal ``seg_id`` (runs
    contiguous, at most ``longest`` long), by doubling: after the step of
    offset k each element holds the minimum of its last 2k elements in
    its run, so ceil(log2(longest)) steps suffice. (Torch's CUDA
    ``cummin`` takes about 50 ms for 2^24 int64 on an H100; a batch whose
    keys are mostly distinct needs two or three steps here.)"""
    out = x.clone()
    k = 1
    while k < longest:
        same = seg_id[k:] == seg_id[:-k]
        out[k:] = torch.where(same, torch.minimum(out[k:], out[:-k]), out[k:])
        k *= 2
    return out


def net_effects(config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
                ops: torch.Tensor, valid: Optional[torch.Tensor] = None
                ) -> NetEffects:
    """Steps 1 and 2 of :func:`apply_ops`, shared with the ``cuckoo``
    adapter: each key's stored copies ``c0``, then the segmented
    saturating counter over the batch grouped by key (batch order within
    a group) and each group's net effect. Needs ``n >= 1``.

    Each op is the map ``c -> max(c + a, 0)`` (+1 insert, -1 delete, 0
    query). From a group's head to slot t the maps compose to ``c ->
    max(c + A_t, M_t)`` with ``A_t`` the group's inclusive sum of ``a`` and
    ``M_t = A_t - min(A_head..A_t)`` — the closed form of JAX's
    associative scan of ``(A, M)`` with the segment-start reset, computed
    here by a cumulative sum and a segmented running minimum. The group
    order differs from JAX's lexsort (signed, not unsigned 64-bit key
    order), which changes no group and no value.
    """
    n = keys.shape[0]
    dev = keys.device
    v = (torch.ones((n,), dtype=torch.bool, device=dev)
         if valid is None else valid.to(dev, torch.bool))
    ops = ops.to(dev, torch.int32)
    is_ins = v & (ops == OP_INSERT)
    is_del = v & (ops == OP_DELETE)
    is_qry = v & (ops == OP_QUERY)

    c0 = _count_matches(config, state, keys).to(torch.int64)

    # --- group by 64-bit key value; batch order within groups (stable).
    k64 = (from_i32(keys[:, 1]) << 32) | from_i32(keys[:, 0])
    k_s, order = torch.sort(k64, stable=True)
    seg_start = torch.ones((n,), dtype=torch.bool, device=dev)
    seg_start[1:] = k_s[1:] != k_s[:-1]
    seg_end = torch.ones_like(seg_start)
    seg_end[:-1] = seg_start[1:]
    seg_id = torch.cumsum(seg_start, 0) - 1
    heads = seg_start.nonzero().squeeze(1)
    head_pos = heads[seg_id]
    last_pos = seg_end.nonzero().squeeze(1)[seg_id]

    def seg_cumsum(x_s):
        c = torch.cumsum(x_s, 0)
        return c - (c[head_pos] - x_s[head_pos])

    # --- the segmented saturating counter.
    ins_s, del_s = is_ins[order].long(), is_del[order].long()
    A = seg_cumsum(ins_s - del_s)
    longest = int((last_pos - head_pos).max()) + 1
    M = A - _segmented_cummin(A, seg_id, longest)
    c0_s = c0[order]
    c_incl = torch.maximum(c0_s + A, M)
    c_before = torch.where(seg_start, c0_s, torch.roll(c_incl, 1))

    # --- net effect per key group: surplus inserts / deficit deletes.
    d = c_incl[last_pos] - c0_s            # net copies to add (+) / drop (-)
    ins_rank = seg_cumsum(ins_s)            # 1-based
    del_rank = seg_cumsum(del_s)
    net_ins_s = (ins_s > 0) & (ins_rank > ins_rank[last_pos] - d.clamp(min=0))
    net_del_s = (del_s > 0) & (del_rank <= (-d).clamp(min=0))

    def unsort(x_s):
        out = torch.zeros((n,), dtype=torch.bool, device=dev)
        out[order] = x_s
        return out

    return NetEffects(is_qry, is_ins, is_del, unsort(net_ins_s),
                      unsort(net_del_s), unsort(c_incl > 0),
                      unsort(c_before > 0))


def _compact(keys: torch.Tensor, mask: torch.Tensor, width: int):
    """The keys under ``mask``, in batch order, in a ``width``-slot batch.

    Returns (pos, sub_keys, sub_valid): ``pos[i]`` is key i's slot (clamped
    into the batch; meaningful where ``mask``). Same slots as JAX's
    cumsum scatter."""
    pos = torch.cumsum(mask, 0) - 1
    sub_keys = torch.zeros((width, 2), dtype=keys.dtype, device=keys.device)
    sub_valid = torch.zeros((width,), dtype=torch.bool, device=keys.device)
    sub_keys[pos[mask]] = keys[mask]
    sub_valid[pos[mask]] = True
    return pos.clamp(0, width - 1), sub_keys, sub_valid


def mixed_ok(e: NetEffects, ins_ok: torch.Tensor,
             del_ok: torch.Tensor) -> torch.Tensor:
    """Each slot's outcome under its op code, from the algebra and the
    outcomes of the net writes (a cancelled insert reports True)."""
    return torch.where(
        e.is_qry, e.q_ok,
        torch.where(e.is_ins, torch.where(e.net_ins, ins_ok, True),
                    e.is_del & e.d_ok & torch.where(e.net_del, del_ok, True)))


def apply_ops(config: CuckooConfig, state: CuckooState, keys: torch.Tensor,
              ops: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Execute an interleaved QUERY/INSERT/DELETE stream in one fused pass.

    ``ops`` is int32[n] of op codes; returns ``(state', ok[n], stats)``
    where ``ok[i]`` is that slot's outcome under its op code (query → hit,
    insert → landed, delete → removed a stored copy). Operations on the
    same 64-bit key resolve in batch order (DESIGN.md §9):
    :func:`net_effects` answers every query and delete algebraically, and
    only each key's net effect touches the table — net deletes first,
    then net inserts. A net slice of at most ``max(8, n // 8)`` keys is
    compacted to that width in batch order and runs :func:`delete` or
    :func:`insert`; a denser one runs :func:`delete` or
    :func:`insert_bulk` over the full width under its mask. Same widths,
    slots and engines as JAX's ``lax.cond`` branches (here a host
    ``if``), so the table, ``ok`` and stats are bit-exact with JAX's.

    The documented deviations from the sequential oracle are JAX's: a
    cancelled insert reports ``ok=True`` even where a sequential run
    would have failed it against a full table, and cross-key fingerprint
    aliasing within one batch is observed as if reordered. Neither can
    give a key's own inserts a false negative; both vanish below the
    design load.
    """
    n = keys.shape[0]
    dev = keys.device
    if n == 0:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return state, torch.zeros((0,), dtype=torch.bool, device=dev), \
            InsertStats(torch.zeros((0,), dtype=torch.int32, device=dev),
                        zero, zero.clone(),
                        state.count.to(torch.float32) / config.num_slots)
    e = net_effects(config, state, keys, ops, valid)
    sub = max(8, n // 8)

    if int(e.net_del.sum()) <= sub:
        pos, skeys, svalid = _compact(keys, e.net_del, sub)
        state, ok_sub = delete(config, state, skeys, svalid)
        del_ok = e.net_del & ok_sub[pos]
    else:
        state, del_ok = delete(config, state, keys, e.net_del)

    if int(e.net_ins.sum()) <= sub:
        pos, skeys, svalid = _compact(keys, e.net_ins, sub)
        state, ok_sub, st = insert(config, state, skeys, svalid)
        ins_ok = e.net_ins & ok_sub[pos]
        evictions = torch.where(e.net_ins, st.evictions[pos], 0)
    else:
        state, ins_ok, st = insert_bulk(config, state, keys, valid=e.net_ins)
        evictions = st.evictions

    ok = mixed_ok(e, ins_ok, del_ok)
    failed = (e.net_ins & ~ins_ok).sum().to(torch.int32)
    load = state.count.to(torch.float32) / config.num_slots
    return state, ok, InsertStats(evictions.to(torch.int32), st.rounds,
                                  failed, load)


# ---------------------------------------------------------------------------
# Convenience object API.
# ---------------------------------------------------------------------------

class CuckooFilter:
    """Thin object wrapper over the functional core.

    New code should prefer :func:`repro_torch.amq.make`\\ ("cuckoo", ...),
    whose hot operations run on the CUDA kernels. This wrapper runs the
    torch core directly: insert, query, delete and mixed batches.
    """

    def __init__(self, config: CuckooConfig, state: Optional[CuckooState] = None,
                 dedup_within_batch: bool = False, device=None):
        self.config = config
        self.state = config.init(device) if state is None else state
        self._default_dedup = dedup_within_batch

    def insert(self, keys, *, bulk: bool = False,
               dedup_within_batch: Optional[bool] = None):
        """Insert a batch; ``bulk=True`` takes :func:`insert_bulk`.

        Warns loudly (``RuntimeWarning``) when keys were left unplaced.
        """
        import warnings

        dd = (self._default_dedup if dedup_within_batch is None
              else dedup_within_batch)
        keys = normalize_keys(keys, device=self.state.table.device)
        fn = insert_bulk if bulk else insert
        self.state, ok, stats = fn(self.config, self.state, keys,
                                   dedup_within_batch=dd)
        failed = int(stats.failed)
        if failed:
            warnings.warn(
                f"cuckoo insert left {failed} of {ok.shape[0]} keys "
                f"unplaced at load factor {float(stats.load):.3f} — the "
                f"filter is effectively full; grow it "
                f"(CuckooConfig.for_capacity) or rebuild",
                RuntimeWarning, stacklevel=2)
        return ok, stats

    def insert_bulk(self, keys):
        """Deprecated alias for ``insert(keys, bulk=True)``."""
        import warnings

        warnings.warn("CuckooFilter.insert_bulk is deprecated; use "
                      "insert(keys, bulk=True)", DeprecationWarning,
                      stacklevel=2)
        return self.insert(keys, bulk=True)

    def query(self, keys) -> torch.Tensor:
        return query(self.config, self.state,
                     normalize_keys(keys, device=self.state.table.device))

    def delete(self, keys) -> torch.Tensor:
        """Delete one stored copy per key (:func:`delete`) -> ok bool[n]."""
        self.state, ok = delete(
            self.config, self.state,
            normalize_keys(keys, device=self.state.table.device))
        return ok

    def apply_ops(self, keys, ops, valid=None):
        """Run an interleaved query/insert/delete stream in one fused pass
        (:func:`apply_ops`) -> (ok bool[n], InsertStats)."""
        dev = self.state.table.device
        keys = normalize_keys(keys, device=dev)
        ops = torch.as_tensor(ops, device=dev)
        if valid is not None:
            valid = torch.as_tensor(valid, device=dev)
        self.state, ok, stats = apply_ops(self.config, self.state, keys, ops,
                                          valid)
        return ok, stats

    @property
    def load_factor(self) -> float:
        return float(self.state.count) / self.config.num_slots
