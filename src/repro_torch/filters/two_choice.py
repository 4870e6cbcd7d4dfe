"""Two-Choice Filter (TCF) — dynamic GPU baseline (McCoy et al., PPoPP'23).

Port of ``repro.filters.two_choice``. Power-of-two-choices: each key has
two candidate blocks and goes into the *emptier* one. No eviction chains:
when both blocks are full the key overflows into a small stash. Deletion
removes a matching tag from either block or the stash.

The rounds are batch-synchronous, as in the JAX package: each round every
pending key picks its slot, a stable-sort claim election
(``resolve_claims_single``) lets the lowest batch index win each word or
stash slot, and the winners write. The round loop runs on the host with
one sync a round (``any(pending)``), as the core's round loop does, and
each round computes only the keys still pending (a key that is not
pending claims nothing, so dropping it changes no election). The tables
are bit-exact with the JAX package's.

The per-key work of a round and of a query runs in chunks of
``_CHUNK`` keys: an unpacked ``[n, 32]`` block is 4 GiB at n = 2^24. The
stash lookups never form the ``[n, stash_size]`` comparison: a first free
stash slot depends only on the key's start, and a match is a lookup in
the sorted stash. The answers are the same.

Tables hold uint32 bits as int32 and are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import layout as L
from ..core.bits64 import MASK32, from_i32, to_i32
from ..core.device import resolve_device
from ..core.hashing import fmix32, hash_key, normalize_keys
from .common import resolve_claims_single

# Keys a chunk of a round's or a query's per-key work.
_CHUNK = 1 << 21

# While ``INSERT_RECORDS`` holds a list, each :func:`insert` appends a
# dict of its rounds (a host int) and, as device tensors (no host sync),
# the keys turned down with both blocks and the stash full (``dead``) and
# those still pending when ``max_rounds`` ran out (``expired``). ``None``
# (the default) records nothing.
INSERT_RECORDS: Optional[list] = None


class TCFState(NamedTuple):
    table: torch.Tensor   # int32[num_blocks * words_per_block] packed tags
    stash: torch.Tensor   # int32[stash_size] packed (block << fp_bits | tag)
    count: torch.Tensor   # int32[]


@dataclasses.dataclass(frozen=True)
class TCFConfig:
    """Static configuration; class name, field order and defaults are the
    JAX package's, so ``repr(config)`` is identical in both."""

    num_blocks: int
    fp_bits: int = 16
    block_size: int = 32          # tags per block (TCF favours large blocks)
    stash_size: int = 128
    hash_kind: str = "fmix32"
    seed: int = 0
    max_rounds: int = 16

    @property
    def layout(self) -> L.BucketLayout:
        return L.BucketLayout(self.num_blocks, self.block_size, self.fp_bits)

    @property
    def num_slots(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def table_bytes(self) -> int:
        return self.layout.table_bytes + self.stash_size * 4

    def expected_fpr(self, load_factor: float) -> float:
        """Two candidate blocks of ``block_size`` tags each scanned per
        query: eps ~= 1 - (1 - 2^-f)^(2 b alpha) (the paper's Fig. 4
        point: load balancing needs big blocks, costing FPR)."""
        f = self.fp_bits
        return 1.0 - (1.0 - 2.0 ** -f) ** (2 * self.block_size * load_factor)

    def init(self, device=None) -> TCFState:
        """Empty state on ``device`` (default: the GPU; raises without one)."""
        device = resolve_device(device)
        return TCFState(
            self.layout.empty_table(device),
            torch.zeros((self.stash_size,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def for_capacity(capacity: int, load_factor: float = 0.95,
                     fp_bits: int = 16, block_size: int = 32,
                     **kw) -> "TCFConfig":
        blocks = max(2, int(np.ceil(capacity / (load_factor * block_size))))
        return TCFConfig(num_blocks=blocks, fp_bits=fp_bits,
                         block_size=block_size, **kw)


def _prepare(config: TCFConfig, keys: torch.Tensor):
    """keys int32[n, 2] -> (tag, block 1, block 2), uint32 held in int64."""
    hi, lo = hash_key(keys, config.hash_kind, config.seed)
    fp = hi & ((1 << config.fp_bits) - 1)
    tag = torch.where(fp == 0, 1, fp)
    b1 = lo % config.num_blocks
    b2 = fmix32(lo ^ 0xB5297A4D) % config.num_blocks
    return tag, b1, b2


def _stash_entry(config: TCFConfig, block: torch.Tensor,
                 tag: torch.Tensor) -> torch.Tensor:
    """(block << fp_bits | tag) with bit 31 (occupied) set, modulo 2^32 as
    the JAX package's uint32 shift wraps."""
    return (((block << config.fp_bits) | tag) | (1 << 31)) & MASK32


def _chunks(n: int):
    for s in range(0, n, _CHUNK):
        yield slice(s, min(s + _CHUNK, n))


def _first_free_stash(stash: torch.Tensor):
    """(any free slot, first free slot circularly from each start
    int64[stash_size]): the free-slot scan depends only on its start."""
    size = stash.shape[0]
    starts = torch.arange(size, device=stash.device)
    found, slot = L.first_true_circular(
        (stash == 0)[None, :].expand(size, size), starts)
    return found[0], slot


def _stash_lookup(stash: torch.Tensor, entries: torch.Tensor):
    """(entry in the stash, its first index) for each of ``entries``;
    the index is ``stash_size`` where absent."""
    values, order = torch.sort(from_i32(stash), stable=True)
    pos = torch.searchsorted(values, entries).clamp_(max=values.shape[0] - 1)
    found = values[pos] == entries
    return found, torch.where(found, order[pos], values.shape[0])


def _insert_choice(config: TCFConfig, table, tag, b1, b2):
    """Per key of one round: (has_room, found, block, word address, the
    desired word), chunk by chunk."""
    lay = config.layout
    out = []
    for c in _chunks(tag.shape[0]):
        t, j1, j2 = tag[c], b1[c], b2[c]
        tags1 = L.bucket_tags(table, j1, lay)
        tags2 = L.bucket_tags(table, j2, lay)
        n_free1 = (tags1 == 0).sum(dim=-1)
        n_free2 = (tags2 == 0).sum(dim=-1)
        # Power of two choices: pick the emptier block.
        pick2 = n_free2 > n_free1
        blk = torch.where(pick2, j2, j1)
        tags = torch.where(pick2[:, None], tags2, tags1)
        del tags1, tags2
        has_room = torch.maximum(n_free1, n_free2) > 0
        found, slot = L.first_true_circular(tags == 0, L.scan_start(t, lay))
        widx, sw = L.slot_to_word(slot, lay)
        addr = L.word_addr(blk, widx, lay)
        desired = L.replace_tag(from_i32(table[addr]), sw, t, lay.fp_bits)
        out.append((has_room, found, blk, addr, desired))
    return [torch.cat(parts) for parts in zip(*out)]


def insert(config: TCFConfig, state: TCFState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None
           ) -> Tuple[TCFState, torch.Tensor]:
    """Insert keys int32[n, 2] -> (state', ok bool[n]), in place."""
    lay = config.layout
    n = keys.shape[0]
    dev = keys.device
    size = config.stash_size
    invalid = lay.num_words + size
    tag, b1, b2 = _prepare(config, keys)
    pending = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
               else valid.to(torch.bool).clone())
    success = torch.zeros((n,), dtype=torch.bool, device=dev)
    dead_all = torch.zeros((n,), dtype=torch.bool, device=dev)
    table, stash, count = state.table, state.stash, state.count.clone()

    rnd = 0
    while rnd < config.max_rounds and bool(pending.any()):
        p = pending.nonzero().squeeze(1)
        t, j1, j2 = tag[p], b1[p], b2[p]
        has_room, found, blk, addr, desired = _insert_choice(
            config, table, t, j1, j2)
        # Both blocks full -> claim a stash slot instead.
        sfound, first_free = _first_free_stash(stash)
        sslot = first_free[fmix32((t + rnd) & MASK32) % size]
        use_stash = ~has_room & sfound
        use_table = has_room & found
        claim = torch.where(use_table, addr,
                            torch.where(use_stash, lay.num_words + sslot,
                                        invalid))
        win = resolve_claims_single(claim, invalid)
        commit_t = use_table & win
        commit_s = use_stash & win
        table[addr[commit_t]] = to_i32(desired[commit_t])
        stash[sslot[commit_s]] = to_i32(
            _stash_entry(config, blk[commit_s], t[commit_s]))
        done = commit_t | commit_s
        # Keys with no room anywhere (stash full) fail out.
        dead = ~has_room & ~sfound
        pending[p] = ~done & ~dead
        success[p] = done
        dead_all[p] = dead
        count += done.sum(dtype=torch.int32)
        rnd += 1
    if INSERT_RECORDS is not None:
        INSERT_RECORDS.append({"rounds": rnd, "dead": dead_all.sum(),
                               "expired": pending.sum()})
    return TCFState(table, stash, count), success & ~pending


def query(config: TCFConfig, state: TCFState, keys: torch.Tensor) -> torch.Tensor:
    """Membership: the tag in either block, or its entry in the stash."""
    lay = config.layout
    tag, b1, b2 = _prepare(config, keys)
    hits = []
    for c in _chunks(tag.shape[0]):
        t = tag[c, None]
        hit = (L.bucket_tags(state.table, b1[c], lay) == t).any(dim=-1)
        hit |= (L.bucket_tags(state.table, b2[c], lay) == t).any(dim=-1)
        # Stash: compare against both candidate blocks' entries.
        hit |= _stash_lookup(state.stash, _stash_entry(config, b1[c], tag[c]))[0]
        hit |= _stash_lookup(state.stash, _stash_entry(config, b2[c], tag[c]))[0]
        hits.append(hit)
    return torch.cat(hits) if hits else torch.zeros(
        (0,), dtype=torch.bool, device=keys.device)


def _delete_choice(config: TCFConfig, table, tag, b1, b2):
    """Per key of one delete round: (found, word address, desired word)."""
    lay = config.layout
    out = []
    for c in _chunks(tag.shape[0]):
        t, j1, j2 = tag[c], b1[c], b2[c]
        start = L.scan_start(t, lay)
        f1, s1 = L.first_true_circular(
            L.bucket_tags(table, j1, lay) == t[:, None], start)
        f2, s2 = L.first_true_circular(
            L.bucket_tags(table, j2, lay) == t[:, None], start)
        blk = torch.where(f1, j1, j2)
        widx, sw = L.slot_to_word(torch.where(f1, s1, s2), lay)
        addr = L.word_addr(blk, widx, lay)
        desired = L.replace_tag(from_i32(table[addr]), sw,
                                torch.zeros_like(t), lay.fp_bits)
        out.append((f1 | f2, addr, desired))
    return [torch.cat(parts) for parts in zip(*out)]


def delete(config: TCFConfig, state: TCFState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None
           ) -> Tuple[TCFState, torch.Tensor]:
    """Remove one stored copy a key -> (state', ok bool[n]), in place."""
    lay = config.layout
    n = keys.shape[0]
    dev = keys.device
    size = config.stash_size
    invalid = lay.num_words + size
    tag, b1, b2 = _prepare(config, keys)
    pending = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
               else valid.to(torch.bool).clone())
    success = torch.zeros((n,), dtype=torch.bool, device=dev)
    table, stash, count = state.table, state.stash, state.count.clone()
    max_rounds = 2 * config.block_size + 2

    rnd = 0
    while rnd < max_rounds and bool(pending.any()):
        p = pending.nonzero().squeeze(1)
        t, j1, j2 = tag[p], b1[p], b2[p]
        found, addr, desired = _delete_choice(config, table, t, j1, j2)
        # Stash fallback: the first slot holding either block's entry.
        sf1, at1 = _stash_lookup(stash, _stash_entry(config, j1, t))
        sf2, at2 = _stash_lookup(stash, _stash_entry(config, j2, t))
        sfound = sf1 | sf2
        sslot = torch.where(sfound, torch.minimum(at1, at2), 0)

        use_table = found
        use_stash = ~found & sfound
        claim = torch.where(use_table, addr,
                            torch.where(use_stash, lay.num_words + sslot,
                                        invalid))
        win = resolve_claims_single(claim, invalid)
        commit_t = use_table & win
        commit_s = use_stash & win
        table[addr[commit_t]] = to_i32(desired[commit_t])
        stash[sslot[commit_s]] = 0
        done = commit_t | commit_s
        success[p] = done
        pending[p] = (found | sfound) & ~done
        count -= done.sum(dtype=torch.int32)
        rnd += 1
    return TCFState(table, stash, count), success


class TwoChoiceFilter:
    """Thin stateful wrapper over the functional ops; keys in any form
    ``normalize_keys`` takes."""

    def __init__(self, config: TCFConfig, device=None):
        self.config = config
        self.state = config.init(device)

    def _keys(self, keys):
        return normalize_keys(keys, device=self.state.table.device)

    def insert(self, keys):
        self.state, ok = insert(self.config, self.state, self._keys(keys))
        return ok

    def query(self, keys):
        return query(self.config, self.state, self._keys(keys))

    def delete(self, keys):
        self.state, ok = delete(self.config, self.state, self._keys(keys))
        return ok
