"""K-mer pack, forward or canonical: the CUDA kernel's binding and its plain
version.

The kernel (``csrc/kmer_pack.cu``) replaces ``repro/kernels/kmer_pack.py:
kmer_pack_pallas``; its canonical instantiation also does the work of
:func:`canonicalize` in the same pass. :func:`kmer_pack_plain` computes both
with torch int64 shifts; ``kernels.ops.kmer_pack`` picks one by the device
the codes live on.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.bits64 import from_i32, join64, s64, shr64, split64, to_i32
from . import build


def kmer_pack_plain(bases: torch.Tensor, k: int,
                    canonical: bool = False) -> torch.Tensor:
    """Codes [n] (n >= k) -> int32[n - k + 1, 2] (lo, hi) packed k-mers:
    position i holds bases[i:i+k], the first base most significant; with
    ``canonical``, the smaller of that and its reverse complement."""
    m = bases.shape[0] - k + 1
    codes = bases.to(torch.int64) & 3
    acc = torch.zeros((m,), dtype=torch.int64, device=bases.device)
    for j in range(k):
        acc = (acc << 2) | codes[j:j + m]
    hi, lo = split64(acc)
    keys = to_i32(torch.stack([lo, hi], dim=-1))
    return canonicalize(keys, k) if canonical else keys


def canonicalize(keys: torch.Tensor, k: int) -> torch.Tensor:
    """min(kmer, revcomp(kmer)) per key — strand-independent identity."""
    hi, lo = from_i32(keys[:, 1]), from_i32(keys[:, 0])
    rh, rl = _revcomp((hi, lo), k)
    less = (rh < hi) | ((rh == hi) & (rl < lo))
    return to_i32(torch.stack([torch.where(less, rl, lo),
                               torch.where(less, rh, hi)], dim=-1))


# Masks of the 2-, 4-, 8- and 16-bit group swaps of a 64-bit reversal.
_SWAPS = ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
          (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF))


def _revcomp(x: Tuple[torch.Tensor, torch.Tensor], k: int):
    """Reverse complement of a 2-bit-packed k-mer, (hi, lo) uint32 held
    in int64 -> the same. Runs on the 64-bit value as one int64; every
    right shift is masked (``bits64.shr64``)."""
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    # Complement: A<->T (00<->11), C<->G (01<->10) is NOT of each 2 bits.
    v = ~join64(*x)
    # Reverse the 32 two-bit groups: swap ever larger groups, then halves.
    for shift, mask in _SWAPS:
        v = ((v & s64(mask)) << shift) | (shr64(v, shift) & s64(mask))
    v = (v << 32) | shr64(v, 32)
    # The k-mer occupies the low 2k bits; shift the reversed value down.
    return split64(shr64(v, 64 - 2 * k))


def kmer_pack_launch(bases: torch.Tensor, k: int, out: torch.Tensor,
                     canonical: bool) -> None:
    """Launch the kernel on the current stream (arguments already checked:
    ``bases`` uint8 and contiguous, ``out`` int32[n - k + 1, 2])."""
    rc = build.load("kmer_pack").kmer_pack_launch(
        bases.data_ptr(), out.data_ptr(), out.shape[0], k, int(canonical),
        torch.cuda.current_stream(bases.device).cuda_stream)
    build.check(rc, "kmer_pack")
