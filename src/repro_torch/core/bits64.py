"""Unsigned 32- and 64-bit arithmetic on signed torch integers.

PyTorch on the CPU has no ``>>``, ``<<``, ``+``, ``%`` or ``where`` for
uint32/uint64, so the port carries

* a uint32 value (hash word, tag, bucket index) as an int64 in [0, 2**32);
* a uint64 value (xxHash64 state) as the int64 with the same 64 bits;
* a stored table word as the int32 with the same 32 bits (the table's own
  dtype, which CUDA reads as ``uint32_t``).

Int64 multiply wraps modulo 2**64, so products are exact. ``>>`` is
arithmetic on signed types, so every right shift that can see the sign bit
is masked (:func:`shr64`).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1


def s64(value: int) -> int:
    """Python uint64 constant -> the int64 with the same bits."""
    value &= MASK64
    return value - (1 << 64) if value >> 63 else value


def shr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 bits by a static 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64-held uint64 bits left by a static 0 < r < 64."""
    return (x << r) | shr64(x, 64 - r)


def join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 held in int64 -> the int64 with those 64 bits."""
    return (hi << 32) | lo


def split64(x: torch.Tensor):
    """int64-held uint64 bits -> (hi, lo) uint32 held in int64."""
    return shr64(x, 32), x & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 held in int64 -> the int32 with the same bits (table words)."""
    return x.to(torch.int32)


def from_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit view -> uint32 value held in int64."""
    return x.to(torch.int64) & MASK32
