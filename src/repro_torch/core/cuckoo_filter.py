"""Batch-parallel Cuckoo filter core (paper Alg. 1-2), in torch.

Port of the part of ``repro.core.cuckoo_filter`` that the ``cuckoo``
backend's main path needs: the config and state types, key preparation,
the word-claim election, the legacy lock-step eviction round loop
(``_insert_rounds``, DFS and BFS eviction), ``insert`` and ``query``.

The round loop is the bit-exact bridge to the JAX package: claims are
elected per table word by a stable sort (lowest batch index wins), so the
tables, ``ok`` masks and statistics match ``repro.core`` word for word.
On the GPU it is the residue path behind the direct-insert kernel: the
``cuckoo`` adapter hands it only the keys the kernel could not place.

State tensors are updated in place: ``insert`` writes into
``state.table`` and returns a state holding the same tensor, so a
512 MiB table is never copied.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

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
    # Insertion engine. This port has the legacy round loop only: "auto"
    # and "legacy" route to it, "frontier" and "orientation" raise (see
    # resolve_engine).
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

    valid0 = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
              else valid.to(dev, torch.bool))
    pending = valid0.clone()
    if dedup_within_batch:
        first, rep = _batch_dedup(keys, valid0)
        pending &= first
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
# Engine routing.
# ---------------------------------------------------------------------------

INSERT_ENGINES = ("auto", "legacy", "frontier", "orientation")


def resolve_engine(config: CuckooConfig) -> str:
    """The concrete engine ``config`` routes inserts to: always ``"legacy"``.

    Deviation from the JAX package: there ``"auto"`` means the batched BFS
    frontier for ``insert`` (under BFS eviction) and the graph-orientation
    build for ``insert_bulk``. Those engines are not ported yet, so here
    ``"auto"`` routes both entry points to the legacy round loop, and
    ``"frontier"``/``"orientation"`` raise.
    """
    eng = config.insert_engine
    if eng not in INSERT_ENGINES:
        raise ValueError(f"unknown insert_engine {eng!r} "
                         f"(want one of {INSERT_ENGINES})")
    if eng in ("frontier", "orientation"):
        raise NotImplementedError(
            f"insert_engine={eng!r} is not ported yet (port slice 2); use "
            "'auto' or 'legacy'")
    return "legacy"


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
    the first copy's ``ok``.
    """
    resolve_engine(config)
    return _insert_rounds(config, state, keys, valid,
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
# Convenience object API.
# ---------------------------------------------------------------------------

class CuckooFilter:
    """Thin object wrapper over the functional core.

    New code should prefer :func:`repro_torch.amq.make`\\ ("cuckoo", ...),
    whose hot operations run on the CUDA kernels. This wrapper runs the
    torch core directly. Deletes and mixed batches are not ported to the
    core yet (port slice 2) and raise.
    """

    def __init__(self, config: CuckooConfig, state: Optional[CuckooState] = None,
                 dedup_within_batch: bool = False, device=None):
        self.config = config
        self.state = config.init(device) if state is None else state
        self._default_dedup = dedup_within_batch

    def insert(self, keys, *, bulk: bool = False,
               dedup_within_batch: Optional[bool] = None):
        """Insert a batch; warns loudly when keys were left unplaced."""
        import warnings

        dd = (self._default_dedup if dedup_within_batch is None
              else dedup_within_batch)
        keys = normalize_keys(keys, device=self.state.table.device)
        del bulk  # both entry points take the legacy loop (resolve_engine)
        self.state, ok, stats = insert(self.config, self.state, keys,
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

    def query(self, keys) -> torch.Tensor:
        return query(self.config, self.state,
                     normalize_keys(keys, device=self.state.table.device))

    def delete(self, keys):
        raise NotImplementedError(
            "CuckooFilter.delete: the core delete is not ported yet (port "
            "slice 2); repro_torch.amq.make('cuckoo').delete runs the "
            "mixed-op kernel")

    def apply_ops(self, keys, ops, valid=None):
        raise NotImplementedError(
            "CuckooFilter.apply_ops: not ported yet (port slice 2)")

    @property
    def load_factor(self) -> float:
        return float(self.state.count) / self.config.num_slots
