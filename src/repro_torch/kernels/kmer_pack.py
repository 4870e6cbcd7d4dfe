"""Rolling k-mer pack: the CUDA kernel's binding and its plain version.

The kernel (``csrc/kmer_pack.cu``) replaces ``repro/kernels/kmer_pack.py:
kmer_pack_pallas``. :func:`kmer_pack_plain` computes the same function
with torch int64 shifts; ``kernels.ops.kmer_pack`` picks one by the device
the codes live on.
"""

from __future__ import annotations

import torch

from ..core.bits64 import split64, to_i32
from . import build


def kmer_pack_plain(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Codes [n] (n >= k) -> int32[n - k + 1, 2] (lo, hi) packed k-mers:
    position i holds bases[i:i+k], the first base most significant."""
    m = bases.shape[0] - k + 1
    codes = bases.to(torch.int64) & 3
    acc = torch.zeros((m,), dtype=torch.int64, device=bases.device)
    for j in range(k):
        acc = (acc << 2) | codes[j:j + m]
    hi, lo = split64(acc)
    return to_i32(torch.stack([lo, hi], dim=-1))


def kmer_pack_launch(bases: torch.Tensor, k: int, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream (arguments already checked:
    ``bases`` uint8, ``out`` int32[n - k + 1, 2])."""
    rc = build.load("kmer_pack").kmer_pack_launch(
        bases.data_ptr(), out.data_ptr(), out.shape[0], k,
        torch.cuda.current_stream(bases.device).cuda_stream)
    build.check(rc, "kmer_pack")
