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

The four cuckoo wrappers take ``block_keys`` (keyword only): the keys a
block of their kernels owns (:mod:`.autotune`). ``None`` asks
:func:`.autotune.resolve_block_keys` for this (op, device, geometry) cell,
outside the launch: a recorded sweep's tile, else the default, which
launches what the kernels launched before the tile could be tuned. A tile
is one of ``autotune.CANDIDATES`` (256 to 2048); the plain versions ignore
it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..amq.protocol import OP_DELETE, OP_INSERT
from ..core.bits64 import to_i32
from ..core.cuckoo_filter import CuckooConfig, CuckooState
from ..filters.blocked_bloom import BloomConfig, BloomState
from ..filters.quotient import GQFConfig, GQFState
from . import autotune
from .bloom import (bloom_insert_launch, bloom_insert_plain,
                    bloom_query_launch, bloom_query_plain)
from .cuckoo_insert import (cuckoo_insert_direct_plain, cuckoo_insert_launch,
                            cuckoo_insert_unfused_launch)
from .cuckoo_insert_bulk import cuckoo_insert_bulk_launch, cuckoo_insert_bulk_plain
from .cuckoo_mixed import cuckoo_mixed_plain, cuckoo_mixed_route
from .cuckoo_query import (cuckoo_query_launch, cuckoo_query_plain,
                           cuckoo_query_unfused_launch,
                           cuckoo_query_unfused_plain)
from .flash_attention import (DTYPES as FLASH_DTYPES, FMA_DMAX, bshd_views,
                              flash_attention_launch, flash_attention_plain,
                              flash_variant, from_kernel_layout,
                              kernel_strides, to_kernel_layout)
from .gqf import gqf_delete_launch, gqf_insert_launch
from .hash64 import HASH_KINDS, hash64_launch, hash64_plain
from .kmer_pack import kmer_pack_launch, kmer_pack_plain
from .ref import gqf_delete_plain, gqf_insert_plain

LAUNCHES = {"hash64": 0, "cuckoo_query": 0, "cuckoo_query_unfused": 0,
            "cuckoo_insert_direct": 0, "cuckoo_insert_unfused": 0,
            "cuckoo_insert_bulk": 0, "cuckoo_mixed": 0, "cuckoo_mixed_walk": 0,
            "bloom_query": 0, "bloom_insert": 0, "kmer_pack": 0,
            "flash_attention": 0, "gqf_insert_serial": 0,
            "gqf_delete_serial": 0}

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


def _block_keys(config: CuckooConfig, op: str, block_keys,
                device) -> int:
    """The tile a wrapper launches with: ``block_keys``, or for ``None``
    the autotuner's for this cell; raises on one no kernel takes."""
    if block_keys is None:
        block_keys = autotune.resolve_block_keys(config, op, device)
    if block_keys not in autotune.CANDIDATES:
        raise ValueError(f"block_keys={block_keys}: the kernels take "
                         f"{autotune.CANDIDATES}")
    return int(block_keys)


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
                 keys: torch.Tensor, fused: bool = True, *,
                 block_keys: int = None) -> torch.Tensor:
    """Kernel-backed batch query. keys int32[n, 2] -> bool[n].

    Both kernels read bucket i2 only where bucket i1 holds no matching
    tag. ``fused=True`` (default) matches tags with SWAR masks on the
    packed words; ``fused=False`` unpacks each lane and compares it on its
    own (the roofline suite's pre-fusion comparison). Both give the same
    answers, at every ``block_keys``.
    """
    n = _check_keys(keys)
    _check_state(config, state)
    bk = _block_keys(config, "query", block_keys, keys.device)
    if not _on_cuda(state.table, keys):
        plain = cuckoo_query_plain if fused else cuckoo_query_unfused_plain
        return plain(config, state.table, keys)
    _check_kernel_layout(config, state.table, keys)
    hit = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n:
        launch, name = ((cuckoo_query_launch, "cuckoo_query") if fused else
                        (cuckoo_query_unfused_launch, "cuckoo_query_unfused"))
        with torch.cuda.device(keys.device):
            launch(config, state.table, keys, hit, bk)
        LAUNCHES[name] += 1
    return hit


def cuckoo_insert_direct(config: CuckooConfig, state: CuckooState,
                         keys: torch.Tensor, valid: torch.Tensor = None,
                         fused: bool = True, *, block_keys: int = None):
    """Kernel-backed direct insert, no eviction -> (state', ok bool[n]).

    Keys with ``ok`` False (both buckets full) need the eviction-capable
    core (``core.cuckoo_filter.insert``). ``valid`` (bool[n]) masks keys
    out; masked keys report False. ``fused=True`` (default) finds free
    slots with SWAR masks; ``fused=False`` unpacks each lane and tests it
    on its own (the roofline suite's pre-fusion comparison); the reads
    and the CAS loop are the same. Both compute one function, so both
    have one plain version.
    """
    n = _check_keys(keys)
    _check_state(config, state)
    bk = _block_keys(config, "insert", block_keys, keys.device)
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
                launch(config, state.table, keys, valid, ok, bk)
            LAUNCHES[name] += 1
    count = state.count + ok.sum().to(torch.int32)
    return CuckooState(state.table, count), ok


def cuckoo_insert_bulk(config: CuckooConfig, state: CuckooState,
                       keys: torch.Tensor, valid: torch.Tensor = None, *,
                       block_keys: int = None):
    """Kernel-backed bucket-major direct insert, no eviction -> (state',
    ok bool[n]).

    On the CPU the plain version sorts the batch stably by primary bucket
    and inserts the sorted stream; on the GPU the route partitions the
    batch by table window, hashing as it goes (no hash kernel, no sort, no
    host sync; ``kernels/cuckoo_insert_bulk.py``). ``ok`` comes back in
    batch order. Keys with ``ok`` False (both buckets full) need the
    eviction-capable core. ``valid`` (bool[n]) masks keys out; masked keys
    report False. ``block_keys`` is the insert pass's tile (a block owns
    half of it where the pass runs alone).
    """
    n = _check_keys(keys)
    _check_state(config, state)
    bk = _block_keys(config, "bulk_insert", block_keys, keys.device)
    valid = _valid_mask(valid, n, keys.device)
    if not _on_cuda(state.table, keys, valid):
        ok = cuckoo_insert_bulk_plain(config, state.table, keys, valid)
    else:
        _check_kernel_layout(config, state.table, keys)
        ok = torch.empty((n,), dtype=torch.bool, device=keys.device)
        if n:
            with torch.cuda.device(keys.device):
                cuckoo_insert_bulk_launch(config, state.table, keys, valid,
                                          ok, block_keys=bk)
            LAUNCHES["cuckoo_insert_bulk"] += 1
    count = state.count + ok.sum().to(torch.int32)
    return CuckooState(state.table, count), ok


def cuckoo_apply_ops(config: CuckooConfig, state: CuckooState,
                     keys: torch.Tensor, ops: torch.Tensor,
                     valid: torch.Tensor = None, *, block_keys: int = None):
    """Kernel-backed mixed-op pass -> (state', ok bool[n]).

    ``ops``: int32[n] op codes (0 query / 1 insert / 2 delete); ``ok`` is
    each op's outcome (hit / landed / removed). Operations on the same key
    resolve in batch order (DESIGN.md §9); on the GPU ops of different keys
    may take another order (``kernels/cuckoo_mixed.py``). Inserts are
    direct only: an insert with ``ok`` False needs the eviction-capable
    core. On the GPU at most ``2**31 - 1`` ops a call. ``block_keys`` is
    the tile of the route's mark and once-only launches (its walk keeps its
    own grid).
    """
    n = _check_keys(keys)
    _check_state(config, state)
    _check(ops, "ops", torch.int32, (n,))
    bk = _block_keys(config, "apply_ops", block_keys, keys.device)
    valid = _valid_mask(valid, n, keys.device)
    if not _on_cuda(state.table, keys, ops, valid):
        ok = cuckoo_mixed_plain(config, state.table, keys, ops, valid)
    else:
        _check_kernel_layout(config, state.table, keys)
        if n >= 1 << 31:
            raise ValueError(f"{n} ops: the mixed-op kernel takes fewer than "
                             "2**31 a call")
        ok = torch.empty((n,), dtype=torch.bool, device=keys.device)
        if n:
            with torch.cuda.device(keys.device):
                walked = cuckoo_mixed_route(config, state.table, keys, ops,
                                            valid, ok, block_keys=bk)
            LAUNCHES["cuckoo_mixed"] += 1
            LAUNCHES["cuckoo_mixed_walk"] += bool(walked)
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


def _gqf_serial(config: GQFConfig, state: GQFState, rem: torch.Tensor,
                home: torch.Tensor, valid, insert: bool):
    n = rem.shape[0] if isinstance(rem, torch.Tensor) and rem.ndim == 1 else -1
    _check(state.table, "state.table", torch.int32, (config.num_slots,))
    _check(rem, "rem", torch.int64, (n,))
    _check(home, "home", torch.int64, (n,))
    valid = _valid_mask(valid, n, rem.device)
    # R6: with r > 24 the stored distance wraps, so an insert carried round
    # a full table never ends (the JAX loop too; on the card G1 would hold
    # the GPU). Occupied slots equal count, and an insert that finds an
    # empty slot ends, so only a batch that would overfill can hang.
    if insert and config.remainder_bits > 24 and (
            int(state.count) + int(valid.sum()) > config.num_slots):
        raise ValueError(
            f"gqf insert: {int(valid.sum())} keys into {config.num_slots} "
            f"slots holding {int(state.count)} would never end with "
            f"remainder_bits={config.remainder_bits} > 24 (R6)")
    if not _on_cuda(state.table, rem, home, valid):
        plain = gqf_insert_plain if insert else gqf_delete_plain
        ok = plain(state.table, rem, home, valid, config.remainder_bits,
                   config.max_probe)
        placed = ok.sum(dtype=torch.int32)
        return GQFState(state.table, state.count + (placed if insert
                                                    else -placed)), ok
    if not 1 <= config.num_slots < 2 ** 32:
        raise ValueError(f"num_slots={config.num_slots} out of range")
    ok = torch.empty((n,), dtype=torch.bool, device=rem.device)
    count = state.count.clone()
    if n:
        launch, name = ((gqf_insert_launch, "gqf_insert_serial") if insert
                        else (gqf_delete_launch, "gqf_delete_serial"))
        with torch.cuda.device(rem.device):
            launch(state.table, to_i32(rem), to_i32(home), valid, ok, count,
                   config.remainder_bits, config.max_probe)
        LAUNCHES[name] += 1
    return GQFState(state.table, count), ok


def gqf_insert(config: GQFConfig, state: GQFState, rem: torch.Tensor,
               home: torch.Tensor, valid: torch.Tensor = None):
    """The quotient filter's serial Robin Hood insert (G1) -> (state', ok
    bool[n]).

    ``rem`` and ``home`` are ``quotient._prepare``'s int64[n] (uint32
    values). Keys go in batch order, one after another, as in the JAX
    package's loop; the table is updated in place and ``count`` grows by
    the keys placed. On a CUDA table G1 runs in one thread; on a CPU table
    its plain version.
    """
    return _gqf_serial(config, state, rem, home, valid, True)


def gqf_delete(config: GQFConfig, state: GQFState, rem: torch.Tensor,
               home: torch.Tensor, valid: torch.Tensor = None):
    """The quotient filter's serial delete with backward-shift compaction
    (G2) -> (state', ok bool[n]); arguments and routes as
    :func:`gqf_insert`, ``count`` falls by the keys removed."""
    return _gqf_serial(config, state, rem, home, valid, False)


def kmer_pack(bases: torch.Tensor, k: int = 31, *,
              canonical: bool = False) -> torch.Tensor:
    """2-bit base codes [n] -> packed k-mer keys int32[n - k + 1, 2] (lo,
    hi): key i holds bases[i:i+k], the first base most significant; with
    ``canonical``, the smaller (as unsigned 64-bit values) of that and its
    reverse complement, computed in the same launch.

    ``bases`` is 1-D of any integer type; only the low two bits of each
    code count. The kernel reads uint8 codes at any address (other types
    are narrowed first); a batch shorter than ``k`` gives no keys.
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
        return kmer_pack_plain(bases, k, canonical)
    if bases.dtype != torch.uint8:
        bases = (bases & 3).to(torch.uint8)
    out = torch.empty((m, 2), dtype=torch.int32, device=bases.device)
    if m:
        with torch.cuda.device(bases.device):
            kmer_pack_launch(bases.contiguous(), k, out, canonical)
        LAUNCHES["kmer_pack"] += 1
    return out


def _check_flash_types(q, k, v, ndims) -> None:
    for name, t, ndim in (("q", q, ndims[0]), ("k", k, ndims[1]),
                          ("v", v, ndims[1])):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
        if t.ndim != ndim:
            raise ValueError(f"{name}: expected {ndim} dimensions, got {list(t.shape)}")
        if t.dtype not in FLASH_DTYPES:
            raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def _check_flash(q, k, v) -> None:
    """Shapes and dtypes both routes take, all float32 or all bfloat16, in
    the model's layout: q [B, Sq, H, D], k [B, Sk, KVH, D], v [B, Sk, KVH,
    Dv] with H a multiple of KVH."""
    _check_flash_types(q, k, v, (4, 4))
    if not (q.shape[0] == k.shape[0] == v.shape[0] and q.shape[3] == k.shape[3]
            and k.shape[1:3] == v.shape[1:3] and k.shape[2] > 0
            and q.shape[2] % k.shape[2] == 0):
        raise ValueError(f"expected q [B, Sq, H, D], k [B, Sk, KVH, D], v [B, "
                         f"Sk, KVH, Dv] with H % KVH == 0; got {list(q.shape)}, "
                         f"{list(k.shape)}, {list(v.shape)}")


def _as_bshd(q, k, v) -> tuple:
    """The kernel layout's q [BK, g, Sq, D], k [BK, Sk, D], v [BK, Sk, Dv]
    as model-layout views (B = BK, KVH = 1), without a copy."""
    _check_flash_types(q, k, v, (4, 3))
    return q.transpose(1, 2), k[:, :, None], v[:, :, None]


def check_flash_kernel(q, k, v, attn_softcap=None) -> str:
    """What the kernel takes beyond the shape and dtype checks, for either
    layout (a k of three dimensions is the kernel layout's); returns its
    variant. Raises on a softcap (the kernel has none, as the Pallas one
    has none), on head sizes no variant takes, and on data the variant
    cannot read: ``"wgmma"`` reads strided views (D contiguous, every other
    stride a multiple of 16 bytes, 16-byte-aligned data); ``"fma"`` reads
    contiguous copies in the kernel layout (16-byte-aligned data)."""
    if isinstance(k, torch.Tensor) and k.ndim == 3:
        q, k, v = _as_bshd(q, k, v)
    _check_flash(q, k, v)
    return _kernel_variant(q, k, v, attn_softcap)


def _kernel_variant(q, k, v, attn_softcap) -> str:
    """:func:`check_flash_kernel` past the shape and dtype checks."""
    if attn_softcap:
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no attention softcap "
            "(neither has the Pallas kernel); softcap runs only on CPU "
            "tensors")
    variant = flash_variant(q.dtype, q.shape[3], v.shape[3])
    if variant is None:
        raise ValueError(f"flash_attention: head sizes D={q.shape[3]}, "
                         f"Dv={v.shape[3]} exceed the kernel's {FMA_DMAX}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if variant == "wgmma":
            if t.stride(-1) != 1:
                raise ValueError(f"{name}: the head dimension must be "
                                 f"contiguous (stride 1), got {t.stride()}")
            if any(st * t.element_size() % 16 for st in kernel_strides(t)):
                raise ValueError(f"{name}: every stride must be a multiple of "
                                 f"16 bytes, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    if q.shape[1] > 65535 * (128 if variant == "wgmma" else 16) or \
            q.shape[0] * q.shape[2] >= 2**31:
        raise ValueError(f"flash_attention: grid too large for {list(q.shape)}")
    return variant


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    """Attention forward in the kernel layout (see
    :mod:`.flash_attention`): q ``[BK, g, Sq, D]``, k ``[BK, Sk, D]``, v
    ``[BK, Sk, Dv]`` -> ``[BK, g, Sq, Dv]``. The same call as
    :func:`flash_attention_bshd` (its keywords) on these tensors' model-layout
    views with B = BK, KVH = 1: no copy on either side."""
    return flash_attention_bshd(*_as_bshd(q, k, v), **kw).transpose(1, 2)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window=None,
                         scale=None, q_offset: int = 0, attn_softcap=None,
                         chunk_q: int = 512, chunk_k: int = 1024,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Attention forward in the model's layout: q ``[B, Sq, H, D]``, k
    ``[B, Sk, KVH, D]``, v ``[B, Sk, KVH, Dv]`` (query head ``h`` reads KV
    head ``h // (H // KVH)``) -> ``[B, Sq, H, Dv]`` of ``out_dtype``
    (float32, the accumulator's type, or bfloat16: the float32 result
    rounded once).

    CPU tensors take the plain version on kernel-layout copies (``chunk_q``
    x ``chunk_k`` tiles, softcap allowed). CUDA tensors launch the kernel or
    raise: the ``wgmma`` variant (bf16, D == Dv in {32, 64, 128}) reads q,
    k and v where they lie, strided views included, and writes a result
    with q's dimension order: no copy on either side. A float32 call (or
    bf16 at other head sizes), the ``fma`` variant, copies q, k and v into
    the contiguous kernel layout (a no-op for :func:`flash_attention`'s
    views) and views its result back."""
    _check_flash(q, k, v)
    _check_out_dtype(out_dtype)
    B = q.shape[0]
    if not _on_cuda(q, k, v):
        return from_kernel_layout(flash_attention_plain(
            *to_kernel_layout(q, k, v), causal=causal, window=window,
            scale=scale, q_offset=q_offset, attn_softcap=attn_softcap,
            chunk_q=chunk_q, chunk_k=chunk_k).to(out_dtype), B)
    variant = _kernel_variant(q, k, v, attn_softcap)
    if variant == "wgmma":
        out = torch.empty_like(q, dtype=out_dtype)
        views = (*bshd_views(q, k, v), bshd_views(out, k, v)[0])
    else:
        qk, kk, vk = to_kernel_layout(q, k, v)
        out = torch.empty(qk.shape[:3] + (vk.shape[2],), dtype=out_dtype,
                          device=q.device)
        views = (qk[:, None], kk[:, None], vk[:, None], out[:, None])
    if out.numel():
        scale = scale if scale is not None else 1.0 / float(np.sqrt(q.shape[3]))
        flash_attention_launch(*views, causal=causal, window=window,
                               scale=scale, q_offset=q_offset, variant=variant)
        LAUNCHES["flash_attention"] += 1
    return out if variant == "wgmma" else from_kernel_layout(out, B)


def _check_out_dtype(out_dtype) -> None:
    if out_dtype not in FLASH_DTYPES:
        raise TypeError(f"out_dtype: expected float32 or bfloat16, got "
                        f"{out_dtype}")
