"""Key hashing for the Cuckoo filter (paper §4.3 step 1), on torch tensors.

Port of ``repro.core.hashing``. The digest is bit-exact with the JAX
package: ``hash_key`` returns the ``(hi, lo)`` uint32 halves (held in
int64, see :mod:`.bits64`); the upper half derives the fingerprint, the
lower half the primary bucket.

* ``xxhash64_u64`` — xxHash64 of one 8-byte key; on torch the uint64 state
  is a native int64 (the TPU emulated it in 16-bit limbs).
* ``fmix32_pair`` — two chained murmur3 finalizers over the (hi, lo) words,
  the registry's default hash.

``hash_key`` hashes GPU tensors with the hash kernel and CPU tensors with
``hash_key_plain``, this module's torch arithmetic.

Keys are ``int32[n, 2]`` tensors holding the bits of ``(lo, hi)`` uint32
pairs — the JAX package's ``uint32[n, 2]`` layout in a dtype PyTorch can
shift on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bits64 as b64
from .bits64 import MASK32

# xxHash64 primes.
PRIME64_1 = 0x9E3779B185EBCA87
PRIME64_2 = 0xC2B2AE3D4F118CB1
PRIME64_3 = 0x165667B19E3779F9
PRIME64_4 = 0x85EBCA77C2B2AE63
PRIME64_5 = 0x27D4EB2F165667C5


def keys_to_u64(keys: torch.Tensor):
    """int32[..., 2] (lo, hi) key tensor -> (hi, lo) uint32 held in int64."""
    if not isinstance(keys, torch.Tensor) or keys.ndim < 1 or keys.shape[-1] != 2:
        raise ValueError(
            f"keys must be an int32[..., 2] (lo, hi) tensor, got "
            f"{getattr(keys, 'dtype', type(keys))}"
            f"{list(getattr(keys, 'shape', []))}; raw uint64 keys are "
            "accepted at the FilterHandle boundary (normalize_keys)")
    if keys.dtype != torch.int32:
        raise ValueError(
            f"keys must be int32 (lo, hi) bit views, got {keys.dtype}: "
            "split 64-bit keys with repro_torch.core.hashing.normalize_keys")
    return b64.from_i32(keys[..., 1]), b64.from_i32(keys[..., 0])


def keys_from_numpy(arr, device=None) -> torch.Tensor:
    """uint64 numpy array -> int32[..., 2] (lo, hi) tensor on ``device``."""
    arr = np.asarray(arr, np.uint64)
    out = np.empty(arr.shape + (2,), np.uint32)
    out[..., 0] = (arr & np.uint64(MASK32)).astype(np.uint32)
    out[..., 1] = (arr >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(out.view(np.int32)).to(device or "cpu")


def keys_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """int32[..., 2] (lo, hi) tensor -> uint64 numpy array (exact inverse)."""
    arr = keys.detach().cpu().numpy().view(np.uint32)
    return (arr[..., 0].astype(np.uint64)
            | (arr[..., 1].astype(np.uint64) << np.uint64(32)))


def _split_u64_tensor(x: torch.Tensor) -> torch.Tensor:
    """int64[n] tensor (uint64 bits) -> int32[n, 2] (lo, hi), on its device."""
    hi, lo = b64.split64(x)
    return b64.to_i32(torch.stack([lo, hi], dim=-1)).contiguous()


def normalize_keys(keys, *, device=None, arg: str = "keys") -> torch.Tensor:
    """Normalize any accepted key batch to ``int32[n, 2]`` (lo, hi) bits.

    Accepted forms:

    * raw ``uint64[n]`` keys as numpy arrays or Python int lists;
    * packed ``uint32[n, 2]`` (lo, hi) numpy arrays;
    * torch tensors already in the port's layout, ``int32[n, 2]``;
    * torch ``int64[n]`` tensors holding the uint64 bits of each key — split
      on their own device, so a key stream made on the GPU never visits
      the host.

    The result lives on ``device`` (default: where the input lives; the
    CPU for host inputs). Malformed input raises ``ValueError`` naming
    ``arg``.
    """
    if isinstance(keys, torch.Tensor):
        if keys.ndim == 2 and keys.shape[-1] == 2 and keys.dtype == torch.int32:
            out = keys
        elif keys.ndim == 1 and keys.dtype == torch.int64:
            out = _split_u64_tensor(keys)
        elif keys.ndim == 1 and keys.dtype == torch.int32:
            out = _split_u64_tensor(b64.from_i32(keys))
        else:
            raise ValueError(
                f"{arg}: expected an int32[n, 2] (lo, hi) or int64[n] key "
                f"tensor, got {keys.dtype}{list(keys.shape)}")
        return out.to(device or out.device).contiguous()
    if isinstance(keys, (list, tuple)):
        try:
            keys = np.asarray(keys, np.uint64)
        except (OverflowError, TypeError, ValueError) as e:
            raise ValueError(
                f"{arg}: key values must fit uint64 ({e})") from None
    arr = np.asarray(keys)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{arg}: expected an integer key batch (uint64[n] or "
            f"uint32[n, 2]), got dtype {arr.dtype}")
    if arr.ndim == 1:
        if arr.dtype.itemsize <= 4:  # widen 32-bit scalars losslessly
            arr = arr.astype(np.uint32).astype(np.uint64)
        return keys_from_numpy(arr, device)
    if arr.ndim == 2 and arr.shape[-1] == 2:
        if arr.dtype.itemsize > 4:
            if (arr >> 32).any():
                raise ValueError(
                    f"{arg}: [n, 2] key pairs carry 64-bit lane values — "
                    "lanes must be 32-bit (lo, hi) halves")
        arr = np.ascontiguousarray(arr.astype(np.uint32)).view(np.int32)
        return torch.from_numpy(arr).to(device or "cpu")
    raise ValueError(
        f"{arg}: expected uint64[n] keys or uint32[n, 2] (lo, hi) pairs, "
        f"got shape {list(arr.shape)} dtype {arr.dtype}")


def xxhash64_u64(key, seed: int = 0):
    """xxHash64 of a (hi, lo) uint32 pair (length-8 input), bit exact.

    Specialised to len == 8:
        h  = seed + PRIME64_5 + 8
        k1 = rotl(key * PRIME64_2, 31) * PRIME64_1
        h ^= k1
        h  = rotl(h, 27) * PRIME64_1 + PRIME64_4
        avalanche(h)
    Returns the (hi, lo) halves of the digest, uint32 held in int64.
    """
    hi, lo = key
    k = (hi << 32) | lo
    h = torch.full_like(k, b64.s64(seed + PRIME64_5 + 8))
    k1 = b64.rotl64(k * b64.s64(PRIME64_2), 31) * b64.s64(PRIME64_1)
    h = h ^ k1
    h = b64.rotl64(h, 27) * b64.s64(PRIME64_1) + b64.s64(PRIME64_4)
    h = h ^ b64.shr64(h, 33)
    h = h * b64.s64(PRIME64_2)
    h = h ^ b64.shr64(h, 29)
    h = h * b64.s64(PRIME64_3)
    h = h ^ b64.shr64(h, 32)
    return b64.shr64(h, 32), h & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on uint32 values held in int64."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK32
    x = x ^ (x >> 16)
    return x


def fmix32_pair(key):
    """Two dependent fmix32 passes over (hi, lo) -> (hi, lo) digest."""
    hi_in, lo_in = key
    a = fmix32(lo_in ^ fmix32(hi_in ^ 0x9E3779B9))
    b = fmix32(hi_in ^ fmix32((lo_in + 0x85EBCA6B) & MASK32) ^ a)
    return b, a


def hash_key(keys: torch.Tensor, kind: str = "xxhash64", seed: int = 0):
    """Hash int32[..., 2] keys -> (hi, lo) digest, uint32 held in int64.

    Keys on the GPU are hashed by the hash kernel (``kernels/csrc/
    hash64.cu``), keys on the CPU by :func:`hash_key_plain`.
    """
    if keys.is_cuda:
        from ..kernels.ops import hash64

        hi, lo = hash64(keys.reshape(-1, 2).contiguous(), seed, kind)
        return (b64.from_i32(hi).reshape(keys.shape[:-1]),
                b64.from_i32(lo).reshape(keys.shape[:-1]))
    return hash_key_plain(keys, kind, seed)


def hash_key_plain(keys: torch.Tensor, kind: str = "xxhash64", seed: int = 0):
    """:func:`hash_key` in torch arithmetic alone, on any device."""
    k = keys_to_u64(keys)
    if kind == "xxhash64":
        return xxhash64_u64(k, seed=seed)
    if kind == "fmix32":
        if seed:
            # Same word pairing as the JAX package: the seed's low word
            # goes into the key's hi half and its high word into lo.
            k = (k[0] ^ (seed & MASK32), k[1] ^ ((seed >> 32) & MASK32))
        return fmix32_pair(k)
    raise ValueError(f"unknown hash kind: {kind!r}")


# ---------------------------------------------------------------------------
# Pure-Python oracles (used by tests; operate on Python ints).
# ---------------------------------------------------------------------------

def _rotl64_py(x: int, r: int) -> int:
    x &= b64.MASK64
    return ((x << r) | (x >> (64 - r))) & b64.MASK64


def xxhash64_py(key: int, seed: int = 0) -> int:
    """Reference xxHash64 for an 8-byte little-endian input (Python ints)."""
    mask = b64.MASK64
    h = (seed + PRIME64_5 + 8) & mask
    k1 = (key * PRIME64_2) & mask
    k1 = _rotl64_py(k1, 31)
    k1 = (k1 * PRIME64_1) & mask
    h ^= k1
    h = (_rotl64_py(h, 27) * PRIME64_1 + PRIME64_4) & mask
    h ^= h >> 33
    h = (h * PRIME64_2) & mask
    h ^= h >> 29
    h = (h * PRIME64_3) & mask
    h ^= h >> 32
    return h


def fmix32_py(x: int) -> int:
    m = MASK32
    x &= m
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & m
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & m
    x ^= x >> 16
    return x
