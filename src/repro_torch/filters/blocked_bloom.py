"""Blocked Bloom filter — the paper's append-only GPU baseline (GBBF).

Port of ``repro.filters.blocked_bloom``. One block of ``words_per_block``
uint32 words per key (16 words: a 64-byte line), ``k`` bits set inside
it. Insert-only; a query is one block's bit tests. This is the structure
whose query throughput the paper's cuckoo filter "rivals".

The k bit positions come from the key's 64-bit hash: the block from the
lower word, the in-block bits peeled from the upper word in
``bit_length(block_bits - 1)``-bit chunks and re-mixed with fmix32 when
more are needed (:func:`_bit_positions`).

:func:`insert` and :func:`query` are plain torch functions (the JAX
package's XLA code); the ``bloom`` registry backend runs the CUDA kernels
(``kernels/csrc/bloom_{query,insert}.cu``). Uint32 ``%`` and ``>>`` run in
int64 (torch on the CPU has neither for uint32). The table tensor is
updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.bits64 import MASK32, from_i32
from ..core.device import resolve_device
from ..core.hashing import fmix32, hash_key, hash_key_plain, normalize_keys
from .common import scatter_or


class BloomState(NamedTuple):
    table: torch.Tensor  # int32[num_blocks * words_per_block] (uint32 bits)
    count: torch.Tensor  # int32[] inserted keys (for load accounting)


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """Static configuration; class name, field order and defaults are the
    JAX package's, so ``repr(config)`` is identical in both."""

    num_blocks: int
    words_per_block: int = 16   # 512-bit blocks (GPU cache-line style)
    k: int = 8                  # bits set per key
    hash_kind: str = "fmix32"
    seed: int = 0
    bits_per_key: int = 16      # nominal budget (defines num_slots/FPR math)

    @property
    def block_bits(self) -> int:
        return self.words_per_block * 32

    @property
    def num_words(self) -> int:
        return self.num_blocks * self.words_per_block

    @property
    def table_bytes(self) -> int:
        return self.num_words * 4

    @property
    def num_slots(self) -> int:
        """Nominal key capacity: total bits / the per-key bit budget."""
        return max(1, (self.num_blocks * self.block_bits) // self.bits_per_key)

    def expected_fpr(self, load_factor: float) -> float:
        """Standard Bloom estimate at ``load_factor`` of nominal capacity,
        ``(1 - e^(-k * alpha / bits_per_key))^k``; blocking adds a small
        penalty that the tolerance bands absorb."""
        ratio = self.k * load_factor / self.bits_per_key
        return (1.0 - math.exp(-ratio)) ** self.k

    def init(self, device=None) -> BloomState:
        """Empty state on ``device`` (default: the GPU; raises without one)."""
        device = resolve_device(device)
        return BloomState(
            torch.zeros((self.num_words,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def for_capacity(capacity: int, bits_per_key: int = 16, **kw) -> "BloomConfig":
        words_per_block = kw.pop("words_per_block", 16)
        total_bits = capacity * bits_per_key
        blocks = max(1, int(np.ceil(total_bits / (words_per_block * 32))))
        return BloomConfig(num_blocks=blocks, words_per_block=words_per_block,
                           bits_per_key=bits_per_key, **kw)


def _bit_positions(config: BloomConfig, keys: torch.Tensor, plain=False):
    """keys int32[n, 2] -> (block int64[n], word_in_block int64[n, k],
    bit mask int64[n, k] holding uint32 values). ``plain`` hashes with
    torch arithmetic even on the GPU (the kernels' plain versions)."""
    hi, lo = (hash_key_plain if plain else hash_key)(
        keys, config.hash_kind, config.seed)
    block = lo % config.num_blocks
    # k in-block bit indices, peeled from the upper hash word and re-mixed.
    bits_needed = max(1, (config.block_bits - 1).bit_length())
    per_word = max(32 // bits_needed, 1)
    idx = []
    h = hi
    for j in range(config.k):
        if j % per_word == 0 and j > 0:
            h = fmix32((h + j) & MASK32)
        idx.append((h >> ((j % per_word) * bits_needed)) % config.block_bits)
    pos = torch.stack(idx, dim=-1)                      # [n, k]
    return block, pos >> 5, 1 << (pos & 31)


def insert(config: BloomConfig, state: BloomState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None, *, plain: bool = False):
    """Set each valid key's k bits -> (state', ok bool[n] == valid)."""
    block, word, mask = _bit_positions(config, keys, plain)
    addr = (block[:, None] * config.words_per_block + word).reshape(-1)
    n = keys.shape[0]
    ok = (torch.ones((n,), dtype=torch.bool, device=keys.device)
          if valid is None else valid.to(torch.bool))
    vmask = None if valid is None else ok.repeat_interleave(config.k)
    scatter_or(state.table, addr, mask.reshape(-1), vmask)
    # Append-only: every valid key succeeds.
    return BloomState(state.table, state.count + ok.sum().to(torch.int32)), ok


def query(config: BloomConfig, state: BloomState, keys: torch.Tensor,
          *, plain: bool = False) -> torch.Tensor:
    """Membership: all k bits of the key's block set -> bool[n]."""
    block, word, mask = _bit_positions(config, keys, plain)
    words = from_i32(state.table[block[:, None] * config.words_per_block + word])
    return ((words & mask) == mask).all(dim=-1)


class BlockedBloomFilter:
    """Thin stateful wrapper over the functional ops (no deletion); keys
    in any form ``normalize_keys`` takes."""

    def __init__(self, config: BloomConfig, device=None):
        self.config = config
        self.state = config.init(device)

    def _keys(self, keys):
        return normalize_keys(keys, device=self.state.table.device)

    def insert(self, keys):
        self.state, ok = insert(self.config, self.state, self._keys(keys))
        return ok

    def query(self, keys):
        return query(self.config, self.state, self._keys(keys))
