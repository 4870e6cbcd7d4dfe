"""Batched key hash: the CUDA kernel's binding and its plain version.

The kernel (``csrc/hash64.cu``) replaces ``repro/kernels/hash64.py:
hash64_pallas`` (xxHash64) and also computes the fmix32 pair-hash, so it
serves every ``hash_key`` of GPU keys. :func:`hash64_plain` computes the
same function with vectorized torch int64 arithmetic; ``kernels.ops.
hash64`` picks one by the device the keys live on.
"""

from __future__ import annotations

import torch

from ..core.bits64 import MASK64, to_i32
from ..core.hashing import hash_key_plain
from . import build

HASH_KINDS = {"xxhash64": 0, "fmix32": 1}


def hash64_plain(keys: torch.Tensor, seed: int = 0, kind: str = "xxhash64"):
    """Hash int32[n, 2] (lo, hi) keys -> (hi, lo) int32[n] bit views."""
    hi, lo = hash_key_plain(keys, kind, seed)
    return to_i32(hi), to_i32(lo)


def hash64_launch(keys: torch.Tensor, seed: int, kind: str,
                  out_hi: torch.Tensor, out_lo: torch.Tensor) -> None:
    """Launch the kernel on the current stream (arguments already checked)."""
    rc = build.load("hash64").hash64_launch(
        keys.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(), keys.shape[0],
        HASH_KINDS[kind], seed & MASK64,
        torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(rc, "hash64")
