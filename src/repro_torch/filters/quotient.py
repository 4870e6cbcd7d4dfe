"""GPU Counting Quotient Filter analogue — Robin Hood remainder table.

Port of ``repro.filters.quotient``. The GQF (McCoy et al.) stores r-bit
remainders in sorted, contiguous runs via Robin Hood hashing; keeping runs
contiguous requires *shifting elements* on update, which "creates strict
serial dependencies between threads, making the GQF fundamentally
latency-bound" (paper §3). The table stores, per slot, the remainder plus
its probe distance:

    slot = [dist : DIST_BITS | remainder : r]      (0 == empty)

* insert: probe from the home slot; displace any richer (smaller-dist)
  entry and carry it forward — a shift chain, one key after another. On a
  CUDA table it is kernel G1 (``kernels/csrc/gqf_serial.cu``, one thread,
  the JAX loop statement for statement); on a CPU table its plain version.
* query: the bounded window probe, vectorized in torch, in chunks of keys
  (a ``[2^24, 64]`` window is 4 GiB).
* delete: the first match in the window, then backward-shift compaction:
  kernel G2, or its plain version.

Bit-exact with the JAX package, faults included: ``_pack`` wraps modulo
2^32 as its uint32 shift does, so a distance loses its high bits when r >
24 (R6), and an insert that runs past ``max_probe`` drops the entry it
carries (R5). The table holds uint32 bits as int32 and is updated in
place. ``_prepare`` hashes with the hash kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.bits64 import MASK32, from_i32
from ..core.device import resolve_device
from ..core.hashing import hash_key, normalize_keys

DIST_BITS = 8  # max probe distance 255 (insert fails beyond)

# Keys a chunk of a query's window.
_CHUNK = 1 << 20


class GQFState(NamedTuple):
    table: torch.Tensor  # int32[num_slots]: dist<<r | remainder, 0 = empty
    count: torch.Tensor  # int32[]


@dataclasses.dataclass(frozen=True)
class GQFConfig:
    """Static configuration; class name, field order and defaults are the
    JAX package's, so ``repr(config)`` is identical in both."""

    num_slots: int
    remainder_bits: int = 16
    hash_kind: str = "fmix32"
    seed: int = 0
    max_probe: int = 64  # also the query window size

    @property
    def rmask(self) -> int:
        return (1 << self.remainder_bits) - 1

    @property
    def table_bytes(self) -> int:
        return self.num_slots * 4

    def expected_fpr(self, load_factor: float) -> float:
        """Quotient-filter estimate: a negative key collides iff some stored
        key shares its home slot *and* its r-bit remainder; eps ~= 1 - (1 -
        2^-r)^alpha ~= alpha * 2^-r — the lowest of the pack (Fig. 4)."""
        return 1.0 - (1.0 - 2.0 ** -self.remainder_bits) ** load_factor

    def init(self, device=None) -> GQFState:
        """Empty state on ``device`` (default: the GPU; raises without one)."""
        device = resolve_device(device)
        return GQFState(
            torch.zeros((self.num_slots,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def for_capacity(capacity: int, load_factor: float = 0.95,
                     remainder_bits: int = 16, **kw) -> "GQFConfig":
        return GQFConfig(num_slots=max(4, int(np.ceil(capacity / load_factor))),
                         remainder_bits=remainder_bits, **kw)


def _prepare(config: GQFConfig, keys: torch.Tensor):
    """keys int32[n, 2] -> (remainder, home slot), int64 (uint32 values)."""
    hi, lo = hash_key(keys, config.hash_kind, config.seed)
    rem = hi & (config.rmask & MASK32)
    rem = torch.where(rem == 0, 1, rem)        # 0 reserved for EMPTY
    home = lo % config.num_slots
    return rem, home


def _dist(config: GQFConfig, slotval: torch.Tensor) -> torch.Tensor:
    """The distance field of uint32 slot values held in int64."""
    if config.remainder_bits >= 32:
        return torch.zeros_like(slotval)
    return slotval >> config.remainder_bits


def _pack(config: GQFConfig, rem: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """``dist << r | rem`` modulo 2^32, as the uint32 shift wraps (R6)."""
    if config.remainder_bits >= 32:
        return rem & MASK32
    return ((dist << config.remainder_bits) | rem) & MASK32


def _mask(valid):
    return None if valid is None else valid.to(torch.bool).contiguous()


def insert(config: GQFConfig, state: GQFState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None
           ) -> Tuple[GQFState, torch.Tensor]:
    """Sequential Robin Hood insertion (the GQF's serial shifting) ->
    (state', ok bool[n]); G1 on a CUDA table."""
    from ..kernels import ops

    rem, home = _prepare(config, keys)
    return ops.gqf_insert(config, state, rem, home, _mask(valid))


def query(config: GQFConfig, state: GQFState, keys: torch.Tensor) -> torch.Tensor:
    """Vectorized bounded-window probe using the Robin Hood invariant."""
    rem, home = _prepare(config, keys)
    w = config.max_probe
    dev = keys.device
    offs = torch.arange(w, device=dev)
    hits = []
    for s in range(0, keys.shape[0], _CHUNK):
        c = slice(s, s + _CHUNK)
        window = from_i32(state.table[(home[c, None] + offs) % config.num_slots])
        d = _dist(config, window)
        match = ((window & config.rmask) == rem[c, None]) & (d == offs)
        # Stop scanning at the first slot that is empty or poorer than our
        # distance: slot j is alive iff no slot before it stopped the scan.
        stop = (window == 0) | (d < offs)
        first_stop = torch.where(stop.any(dim=1),
                                 stop.to(torch.uint8).argmax(dim=1), w)
        hits.append((match & (offs <= first_stop[:, None])).any(dim=1))
    return torch.cat(hits) if hits else torch.zeros(
        (0,), dtype=torch.bool, device=dev)


def delete(config: GQFConfig, state: GQFState, keys: torch.Tensor,
           valid: Optional[torch.Tensor] = None
           ) -> Tuple[GQFState, torch.Tensor]:
    """Sequential delete + backward-shift compaction -> (state', ok
    bool[n]); G2 on a CUDA table."""
    from ..kernels import ops

    rem, home = _prepare(config, keys)
    return ops.gqf_delete(config, state, rem, home, _mask(valid))


class QuotientFilter:
    """Thin stateful wrapper over the functional ops; keys in any form
    ``normalize_keys`` takes."""

    def __init__(self, config: GQFConfig, device=None):
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
