"""Public wrappers around the CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. Where the tensors live decides the route: CPU
tensors take the kernel's plain PyTorch version; CUDA tensors launch the
kernel on the current stream (outputs allocated with ``torch.empty``, no
padding — the kernels bound-check ``n``) or raise. A launch adds one to
:data:`LAUNCHES`, so a run can show that its path went through the
kernels; the plain versions count nothing.

Mutating wrappers update ``state.table`` in place and return a state that
holds the same table tensor with the new count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..amq.protocol import OP_DELETE, OP_INSERT
from ..core.cuckoo_filter import CuckooConfig, CuckooState, prepare_keys
from ..filters.blocked_bloom import BloomConfig, BloomState
from .bloom import (bloom_insert_launch, bloom_insert_plain,
                    bloom_query_launch, bloom_query_plain)
from .cuckoo_insert import (cuckoo_insert_direct_plain, cuckoo_insert_launch,
                            cuckoo_insert_unfused_launch)
from .cuckoo_insert_bulk import cuckoo_insert_bulk_launch, cuckoo_insert_bulk_plain
from .cuckoo_mixed import (cuckoo_mixed_launch, cuckoo_mixed_plain, segments,
                           sorted_runs)
from .cuckoo_query import (cuckoo_query_launch, cuckoo_query_plain,
                           cuckoo_query_unfused_launch,
                           cuckoo_query_unfused_plain)
from .flash_attention import (DTYPES as FLASH_DTYPES, flash_attention_launch,
                              flash_attention_plain, flash_variant)
from .hash64 import HASH_KINDS, hash64_launch, hash64_plain
from .kmer_pack import kmer_pack_launch, kmer_pack_plain

LAUNCHES = {"hash64": 0, "cuckoo_query": 0, "cuckoo_query_unfused": 0,
            "cuckoo_insert_direct": 0, "cuckoo_insert_unfused": 0,
            "cuckoo_insert_bulk": 0, "cuckoo_mixed": 0, "bloom_query": 0,
            "bloom_insert": 0, "kmer_pack": 0, "flash_attention": 0}

_KERNEL_WPB = (1, 2, 4, 8, 16, 32)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel, False for the plain version."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def _check(t, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {list(shape)}, got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_keys(keys) -> int:
    n = keys.shape[0] if isinstance(keys, torch.Tensor) and keys.ndim else -1
    _check(keys, "keys", torch.int32, (n, 2))
    return n


def _check_state(config: CuckooConfig, state: CuckooState) -> None:
    _check(state.table, "state.table", torch.int32, (config.layout.num_words,))


def _check_kernel_layout(config: CuckooConfig, table: torch.Tensor,
                         keys: torch.Tensor) -> None:
    """Layouts and alignment the CUDA kernels are built for."""
    lay = config.layout
    if lay.bucket_size > 32 or lay.words_per_bucket not in _KERNEL_WPB:
        raise ValueError(
            f"the CUDA kernels take at most 32 slots per bucket in 1, 2, 4, "
            f"8, 16 or 32 words; got bucket_size={lay.bucket_size}, "
            f"fp_bits={lay.fp_bits}")
    if not 2 <= config.num_buckets < 2 ** 32:
        raise ValueError(f"num_buckets={config.num_buckets} out of range")
    if table.data_ptr() % 16 or keys.data_ptr() % 8:
        raise ValueError("table must be 16-byte and keys 8-byte aligned")


def _valid_mask(valid, n: int, device) -> torch.Tensor:
    if valid is None:
        return torch.ones((n,), dtype=torch.bool, device=device)
    _check(valid, "valid", torch.bool, (n,))
    return valid


def hash64(keys: torch.Tensor, seed: int = 0, kind: str = "xxhash64"):
    """Hash int32[n, 2] (lo, hi) keys -> (hi, lo) int32[n] bit views.

    ``kind`` is ``"xxhash64"`` (the JAX kernel's function, the default) or
    ``"fmix32"``.
    """
    n = _check_keys(keys)
    if kind not in HASH_KINDS:
        raise ValueError(f"unknown hash kind: {kind!r}")
    if not _on_cuda(keys):
        return hash64_plain(keys, seed, kind)
    if keys.data_ptr() % 8:
        raise ValueError("keys must be 8-byte aligned")
    hi = torch.empty((n,), dtype=torch.int32, device=keys.device)
    lo = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n:
        with torch.cuda.device(keys.device):
            hash64_launch(keys, seed, kind, hi, lo)
        LAUNCHES["hash64"] += 1
    return hi, lo


def cuckoo_query(config: CuckooConfig, state: CuckooState,
                 keys: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """Kernel-backed batch query. keys int32[n, 2] -> bool[n].

    ``fused=True`` (default) runs the one-gather SWAR kernel;
    ``fused=False`` the unpack-based kernel (the roofline suite's
    pre-fusion comparison). Both give the same answers.
    """
    n = _check_keys(keys)
    _check_state(config, state)
    if not _on_cuda(state.table, keys):
        plain = cuckoo_query_plain if fused else cuckoo_query_unfused_plain
        return plain(config, state.table, keys)
    _check_kernel_layout(config, state.table, keys)
    hit = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n:
        launch, name = ((cuckoo_query_launch, "cuckoo_query") if fused else
                        (cuckoo_query_unfused_launch, "cuckoo_query_unfused"))
        with torch.cuda.device(keys.device):
            launch(config, state.table, keys, hit)
        LAUNCHES[name] += 1
    return hit


def cuckoo_insert_direct(config: CuckooConfig, state: CuckooState,
                         keys: torch.Tensor, valid: torch.Tensor = None,
                         fused: bool = True):
    """Kernel-backed direct insert, no eviction -> (state', ok bool[n]).

    Keys with ``ok`` False (both buckets full) need the eviction-capable
    core (``core.cuckoo_filter.insert``). ``valid`` (bool[n]) masks keys
    out; masked keys report False. ``fused=True`` (default) runs the SWAR
    free-slot kernel; ``fused=False`` the unpack-based kernel (the
    roofline suite's pre-fusion comparison). Both compute one function,
    so both have one plain version.
    """
    n = _check_keys(keys)
    _check_state(config, state)
    valid = _valid_mask(valid, n, keys.device)
    if not _on_cuda(state.table, keys, valid):
        ok = cuckoo_insert_direct_plain(config, state.table, keys, valid)
    else:
        _check_kernel_layout(config, state.table, keys)
        ok = torch.empty((n,), dtype=torch.bool, device=keys.device)
        if n:
            launch, name = (
                (cuckoo_insert_launch, "cuckoo_insert_direct") if fused else
                (cuckoo_insert_unfused_launch, "cuckoo_insert_unfused"))
            with torch.cuda.device(keys.device):
                launch(config, state.table, keys, valid, ok)
            LAUNCHES[name] += 1
    count = state.count + ok.sum().to(torch.int32)
    return CuckooState(state.table, count), ok


def cuckoo_insert_bulk(config: CuckooConfig, state: CuckooState,
                       keys: torch.Tensor, valid: torch.Tensor = None):
    """Kernel-backed bucket-major direct insert, no eviction -> (state',
    ok bool[n]).

    Sorts the batch stably by primary bucket (the bulk-build order; on the
    GPU the keys are hashed by the hash kernel), inserts the sorted stream
    and returns ``ok`` in batch order. Keys with ``ok`` False (both buckets
    full) need the eviction-capable core. ``valid`` (bool[n]) masks keys
    out; masked keys report False.
    """
    n = _check_keys(keys)
    _check_state(config, state)
    valid = _valid_mask(valid, n, keys.device)
    if not _on_cuda(state.table, keys, valid):
        ok = cuckoo_insert_bulk_plain(config, state.table, keys, valid)
    else:
        _check_kernel_layout(config, state.table, keys)
        _, i1, _ = prepare_keys(config, keys)        # the hash kernel
        order, seg_start = sorted_runs(i1)
        ok = torch.empty((n,), dtype=torch.bool, device=keys.device)
        if n:
            with torch.cuda.device(keys.device):
                cuckoo_insert_bulk_launch(config, state.table, keys, valid,
                                          order, seg_start, ok)
            LAUNCHES["cuckoo_insert_bulk"] += 1
    count = state.count + ok.sum().to(torch.int32)
    return CuckooState(state.table, count), ok


def cuckoo_apply_ops(config: CuckooConfig, state: CuckooState,
                     keys: torch.Tensor, ops: torch.Tensor,
                     valid: torch.Tensor = None):
    """Kernel-backed mixed-op pass -> (state', ok bool[n]).

    ``ops``: int32[n] op codes (0 query / 1 insert / 2 delete); ``ok`` is
    each op's outcome (hit / landed / removed). Operations on the same key
    resolve in batch order (DESIGN.md §9). Inserts are direct only: an
    insert with ``ok`` False needs the eviction-capable core.
    """
    n = _check_keys(keys)
    _check_state(config, state)
    _check(ops, "ops", torch.int32, (n,))
    valid = _valid_mask(valid, n, keys.device)
    if not _on_cuda(state.table, keys, ops, valid):
        ok = cuckoo_mixed_plain(config, state.table, keys, ops, valid)
    else:
        _check_kernel_layout(config, state.table, keys)
        ok = torch.empty((n,), dtype=torch.bool, device=keys.device)
        if n:
            order, seg_start = segments(keys)
            with torch.cuda.device(keys.device):
                cuckoo_mixed_launch(config, state.table, keys, ops, valid,
                                    order, seg_start, ok)
            LAUNCHES["cuckoo_mixed"] += 1
    delta = (ok & (ops == OP_INSERT)).sum() - (ok & (ops == OP_DELETE)).sum()
    return CuckooState(state.table, state.count + delta.to(torch.int32)), ok


def _check_bloom(config: BloomConfig, state: BloomState, keys) -> int:
    n = _check_keys(keys)
    _check(state.table, "state.table", torch.int32, (config.num_words,))
    return n


def _check_bloom_kernel(config: BloomConfig, table: torch.Tensor,
                        keys: torch.Tensor) -> None:
    """Sizes and alignment the Bloom kernels are built for."""
    if not 1 <= config.num_blocks < 2 ** 32 or config.block_bits > 2 ** 31:
        raise ValueError(f"num_blocks={config.num_blocks}, words_per_block="
                         f"{config.words_per_block} out of range")
    if config.hash_kind not in HASH_KINDS:
        raise ValueError(f"unknown hash kind: {config.hash_kind!r}")
    if keys.data_ptr() % 8:
        raise ValueError("keys must be 8-byte aligned")


def bloom_query(config: BloomConfig, state: BloomState,
                keys: torch.Tensor) -> torch.Tensor:
    """Kernel-backed blocked-Bloom query. keys int32[n, 2] -> bool[n]."""
    n = _check_bloom(config, state, keys)
    if not _on_cuda(state.table, keys):
        return bloom_query_plain(config, state.table, keys)
    _check_bloom_kernel(config, state.table, keys)
    hit = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n:
        with torch.cuda.device(keys.device):
            bloom_query_launch(config, state.table, keys, hit)
        LAUNCHES["bloom_query"] += 1
    return hit


def bloom_insert(config: BloomConfig, state: BloomState, keys: torch.Tensor,
                 valid: torch.Tensor = None):
    """Kernel-backed blocked-Bloom insert -> (state', ok bool[n]).

    Append-only: every valid key succeeds, so ``ok`` is ``valid`` (all
    True without one) and ``count`` grows by the valid keys.
    """
    n = _check_bloom(config, state, keys)
    valid = _valid_mask(valid, n, keys.device)
    if not _on_cuda(state.table, keys, valid):
        bloom_insert_plain(config, state.table, keys, valid)
    else:
        _check_bloom_kernel(config, state.table, keys)
        if n:
            with torch.cuda.device(keys.device):
                bloom_insert_launch(config, state.table, keys, valid)
            LAUNCHES["bloom_insert"] += 1
    count = state.count + valid.sum().to(torch.int32)
    return BloomState(state.table, count), valid.clone()


def kmer_pack(bases: torch.Tensor, k: int = 31) -> torch.Tensor:
    """2-bit base codes [n] -> packed k-mer keys int32[n - k + 1, 2] (lo,
    hi): key i holds bases[i:i+k], the first base most significant.

    ``bases`` is 1-D of any integer type; only the low two bits of each
    code count. The kernel reads uint8 codes (other types are narrowed
    first); a batch shorter than ``k`` gives no keys.
    """
    if not isinstance(bases, torch.Tensor) or bases.ndim != 1:
        raise ValueError("bases: expected a 1-D tensor of base codes")
    if bases.dtype.is_floating_point or bases.dtype.is_complex:
        raise TypeError(f"bases: expected integer codes, got {bases.dtype}")
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    m = max(0, bases.shape[0] - k + 1)
    if not _on_cuda(bases):
        if not m:
            return torch.empty((0, 2), dtype=torch.int32)
        return kmer_pack_plain(bases, k)
    if bases.dtype != torch.uint8:
        bases = (bases & 3).to(torch.uint8)
    out = torch.empty((m, 2), dtype=torch.int32, device=bases.device)
    if m:
        with torch.cuda.device(bases.device):
            kmer_pack_launch(bases.contiguous(), k, out)
        LAUNCHES["kmer_pack"] += 1
    return out


def _check_flash(q, k, v) -> None:
    """Shapes and dtypes both routes take: q [BK, g, Sq, D], k [BK, Sk,
    D], v [BK, Sk, Dv], all float32 or all bfloat16."""
    for name, t, ndim in (("q", q, 4), ("k", k, 3), ("v", v, 3)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
        if t.ndim != ndim:
            raise ValueError(f"{name}: expected {ndim} dimensions, got {list(t.shape)}")
        if t.dtype not in FLASH_DTYPES:
            raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.shape[0] == k.shape[0] == v.shape[0] and q.shape[3] == k.shape[2]
            and k.shape[1] == v.shape[1]):
        raise ValueError(f"expected q [BK, g, Sq, D], k [BK, Sk, D], v [BK, Sk, "
                         f"Dv]; got {list(q.shape)}, {list(k.shape)}, {list(v.shape)}")


def check_flash_kernel(q, k, v, attn_softcap=None) -> str:
    """What the kernel takes beyond :func:`_check_flash`; returns its
    variant. Raises on a softcap (the kernel has none, as the Pallas one
    has none), on non-contiguous or misaligned inputs and on head sizes no
    variant takes."""
    _check_flash(q, k, v)
    if attn_softcap:
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no attention softcap "
            "(neither has the Pallas kernel); softcap runs only on CPU "
            "tensors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    variant = flash_variant(q.dtype, q.shape[3], v.shape[2])
    if variant is None:
        raise ValueError(f"flash_attention: head sizes D={q.shape[3]}, "
                         f"Dv={v.shape[2]} exceed the kernel's 128")
    if q.shape[2] > 65535 * 16 or q.shape[0] * q.shape[1] >= 2**31:
        raise ValueError(f"flash_attention: grid too large for {list(q.shape)}")
    return variant


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None, q_offset: int = 0, attn_softcap=None,
                    chunk_q: int = 512, chunk_k: int = 1024,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Attention forward in the kernel layout (see
    :mod:`.flash_attention`): ``[BK, g, Sq, Dv]`` of ``out_dtype``
    (float32, the accumulator's type, or bfloat16: the float32 result
    rounded once). CPU tensors take the plain version (``chunk_q`` x
    ``chunk_k`` tiles, softcap allowed); CUDA tensors launch the kernel
    or raise."""
    _check_flash(q, k, v)
    if out_dtype not in FLASH_DTYPES:
        raise TypeError(f"out_dtype: expected float32 or bfloat16, got "
                        f"{out_dtype}")
    if not _on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset,
                                     attn_softcap=attn_softcap,
                                     chunk_q=chunk_q,
                                     chunk_k=chunk_k).to(out_dtype)
    variant = check_flash_kernel(q, k, v, attn_softcap)
    BK, g, Sq, D = q.shape
    out = torch.empty((BK, g, Sq, v.shape[2]), dtype=out_dtype,
                      device=q.device)
    if out.numel():
        scale = scale if scale is not None else 1.0 / float(np.sqrt(D))
        flash_attention_launch(q, k, v, out, causal=causal, window=window,
                               scale=scale, q_offset=q_offset, variant=variant)
        LAUNCHES["flash_attention"] += 1
    return out
