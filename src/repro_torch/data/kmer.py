"""Genomic k-mer tooling (paper §5.5 case study), on torch tensors.

Port of ``repro.data.kmer``. Pipeline: ACGT string -> 2-bit codes
(A 0, C 1, G 2, T 3) -> k-mers, optionally canonical (the smaller of a
k-mer and its reverse complement, the KMC3 convention), in one pass of the
k-mer pack kernel (``kernels/csrc/kmer_pack.cu``) on the GPU -> filter
keys in the port's ``int32[n, 2]`` (lo, hi) layout.

A k-mer of k <= 31 bases is packed big-endian by base into the low 2k
bits of a 64-bit value: the first base is the most significant.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.kmer_pack import canonicalize  # noqa: F401 (public name)

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
    The keys are computed by ``kernels.ops.kmer_pack`` on that device: on
    the GPU one launch of the k-mer pack kernel, which canonicalizes in the
    same pass; on the CPU its plain version (``canonicalize`` of the packed
    k-mers).
    """
    from ..kernels.ops import kmer_pack

    if isinstance(bases, torch.Tensor):
        if device is not None and resolve_device(device) != bases.device:
            raise ValueError(f"bases live on {bases.device}, not on "
                             f"device={device!r}")
    else:
        bases = torch.from_numpy(np.ascontiguousarray(bases)).to(
            resolve_device(device))
    return kmer_pack(bases, k=k, canonical=canonical)
