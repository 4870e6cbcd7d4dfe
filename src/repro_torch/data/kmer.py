"""Genomic k-mer tooling (paper §5.5 case study), on torch tensors.

Port of ``repro.data.kmer``. Pipeline: ACGT string -> 2-bit codes
(A 0, C 1, G 2, T 3) -> rolling k-mers (the k-mer pack kernel,
``kernels/csrc/kmer_pack.cu``) -> optional canonicalization (the smaller
of a k-mer and its reverse complement, the KMC3 convention) -> filter
keys in the port's ``int32[n, 2]`` (lo, hi) layout.

A k-mer of k <= 31 bases is packed big-endian by base into the low 2k
bits of a 64-bit value: the first base is the most significant.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.bits64 import from_i32, join64, s64, shr64, split64, to_i32
from ..core.device import resolve_device

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


def synthetic_genome(n_bases: int, seed: int = 0) -> np.ndarray:
    """Random ACGT codes with mild repeat structure (uint8[n]).

    The JAX package's generator, bit for bit: uniform codes, then one
    512-base segment pasted every 8192 bases on average so that the k-mer
    multiset is skewed as real genomes are.
    """
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    seg = rng.integers(0, 4, size=512).astype(np.uint8)
    for _ in range(max(1, n_bases // 8192)):
        at = int(rng.integers(0, max(1, n_bases - 512)))
        bases[at:at + 512] = seg[: max(0, min(512, n_bases - at))]
    return bases


def encode_bases(seq: str) -> np.ndarray:
    """ACGT string -> 2-bit codes; raises on non-ACGT (split reads on N)."""
    codes = _CODE[np.frombuffer(seq.encode(), np.uint8)]
    if (codes == 255).any():
        raise ValueError("non-ACGT base; split reads on N first")
    return codes


def kmer_keys(bases, k: int = 31, canonical: bool = True, *,
              device=None) -> torch.Tensor:
    """Base codes -> ``int32[n-k+1, 2]`` (lo, hi) filter keys.

    ``bases``: a 1-D numpy array or tensor of 2-bit codes (uint8, the
    genome's own form, or any integer type; only the low two bits count).
    A tensor stays on its device; a numpy array goes to ``device`` (default:
    the GPU, raising without one; ``device="cpu"`` for the plain version).
    The keys are computed by ``kernels.ops.kmer_pack`` on that device.
    """
    from ..kernels.ops import kmer_pack

    if isinstance(bases, torch.Tensor):
        if device is not None and resolve_device(device) != bases.device:
            raise ValueError(f"bases live on {bases.device}, not on "
                             f"device={device!r}")
    else:
        bases = torch.from_numpy(np.ascontiguousarray(bases)).to(
            resolve_device(device))
    keys = kmer_pack(bases, k=k)
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
