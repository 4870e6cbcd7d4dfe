"""Shared machinery for the baseline filters: the batched OR scatter and
the single-address claim election.

Port of ``scatter_or`` and ``resolve_claims_single`` from
``repro.filters.common``. The JAX package
merges duplicate addresses with a segmented OR-scan, the TPU-functional
stand-in for the GPU baselines' ``atomicOr``. Here no scan is needed: the
OR of distinct bits equals their sum, so each value is split into its set
bits, the (word, bit) pairs are deduplicated, and each word's bits are
summed in int64 and ORed into the table.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.bits64 import from_i32, to_i32


def scatter_or(table: torch.Tensor, addr: torch.Tensor, val: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[addr] |= val`` with duplicate addresses merged, in place.

    table: int32[w] (uint32 bits); addr: int64[m] flat word indices (may
    repeat); val: uint32 values held in int64[m]; valid: optional bool[m]
    mask. Returns ``table``.
    """
    if valid is not None:
        addr, val = addr[valid], val[valid]
    # Split every value into (word, bit) codes. A single-bit value (the
    # Bloom filters' masks) is one code, its bit the exponent of
    # ``frexp`` (exact for powers of two); others expand over 32 lanes.
    single = (val & (val - 1)) == 0            # no bit or one bit set
    one = val[single]
    keep = one != 0
    bit = torch.frexp(one[keep].double()).exponent.long() - 1
    lanes = torch.arange(32, device=addr.device)
    multi = ((val[~single, None] >> lanes) & 1).bool()
    codes = torch.cat([addr[single][keep] * 32 + bit,
                       (addr[~single, None] * 32 + lanes)[multi]])
    codes = torch.unique(codes)                          # sorted, distinct
    words, inv = torch.unique_consecutive(codes >> 5, return_inverse=True)
    bits = torch.zeros(words.shape, dtype=torch.int64, device=addr.device)
    bits.index_add_(0, inv, torch.ones_like(codes) << (codes & 31))
    table[words] = to_i32(from_i32(table[words]) | bits)
    return table


def resolve_claims_single(addr: torch.Tensor, invalid: int) -> torch.Tensor:
    """Single-address claim election: True where this entry owns ``addr``.

    addr: int64[n] flat addresses (``invalid`` = no claim). Lowest batch
    index wins, by a stable sort (the core's ``_resolve_claims`` rule).
    """
    sa, order = torch.sort(addr, stable=True)
    first = torch.ones_like(sa, dtype=torch.bool)
    first[1:] = sa[1:] != sa[:-1]
    win = torch.zeros(addr.shape, dtype=torch.bool, device=addr.device)
    win[order] = first & (sa != invalid)
    return win
