"""Cached tile autotuning for the cuckoo kernels: the counterpart of the JAX
package's ``kernels/autotune.py``, with the same names and protocol.

On the card ``block_keys`` is the number of keys one block of the per-key
kernels owns (``csrc/cuckoo_common.cuh``: ``block_tile``): a block keeps
256 threads, each taking ``block_keys / 256`` keys in block-strided rounds,
over a grid of ``ceil(n / block_keys)`` blocks with a tail guard (no
padding). It reaches the query kernels (#2, #3), the direct-insert kernels
(#4, #5), the mixed-op route's mark and once-only launches (#7; its walk
keeps its own grid) and the bulk insert's insert pass (#6: the entries a
ticket of the windowed route, half of them a block where the pass runs
alone). The right tile trades blocks in flight against keys a thread, and
shifts with the device, the op and the table's geometry. The plain
versions that CPU tensors take ignore it.

Two levels, so that hot paths never pay for tuning:

* :func:`resolve_block_keys` — O(1): the tile a sweep recorded for this
  (op, device, geometry) cell, else :data:`DEFAULT_BLOCK_KEYS`. The
  wrappers in ``ops.py`` call it when ``block_keys=None``, outside the
  launch, so a later sweep takes effect on the next call.
* :func:`autotune` — the timed sweep over :data:`CANDIDATES` on synthetic
  keys that fills the cache.

The cache lives in the process; set ``REPRO_TORCH_AUTOTUNE_CACHE=<path>``
to keep sweeps as JSON across runs. It is the port's own variable, so a
sweep of one package never feeds the other's.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import statistics
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

# Per-op tile with no sweep: the launches the kernels made before the tile
# could be tuned (a key a thread; the bulk route's two entries a thread).
# The JAX package's query default is 1024; the port keeps 256 so that an
# untuned call launches what it launched before.
DEFAULT_BLOCK_KEYS: Dict[str, int] = {
    "query": 256,
    "insert": 256,
    "bulk_insert": 512,
    "apply_ops": 256,
}

# Candidate tiles, the JAX package's; each is a launch of every op.
CANDIDATES: Tuple[int, ...] = (256, 512, 1024, 2048)

ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

_cache: Dict[str, int] = {}
_loaded_from: Optional[str] = None


def backend_name(device=None) -> str:
    """The cache key's backend field: the CUDA device's name, else "cpu".
    ``None`` is the current CUDA device where there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return _cuda_name(device.index)
    return device.type


@functools.lru_cache(maxsize=None)
def _cuda_name(index) -> str:
    """A CUDA device's name, read once (every wrapper call asks)."""
    return torch.cuda.get_device_name(index)


def cache_key(config, op: str, device=None) -> str:
    """Stable cell id: op x device x the geometry that moves the optimum."""
    lay = config.layout
    return (f"{op}|{backend_name(device)}|fp{lay.fp_bits}"
            f"|b{lay.bucket_size}|nb{lay.num_buckets}")


def _cache_path() -> Optional[pathlib.Path]:
    p = os.environ.get(ENV)
    return pathlib.Path(p) if p else None


def _load_persistent() -> None:
    global _loaded_from
    path = _cache_path()
    if path is None or _loaded_from == str(path):
        return
    _loaded_from = str(path)
    if path.exists():
        try:
            stored = json.loads(path.read_text())
        except (OSError, ValueError):
            return
        for k, v in stored.items():
            _cache.setdefault(k, int(v))


def _store_persistent() -> None:
    path = _cache_path()
    if path is None:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(_cache, indent=2, sort_keys=True))


def resolve_block_keys(config, op: str, device=None) -> int:
    """Tuned tile for this cell if known, else the per-op default. O(1)."""
    _load_persistent()
    got = _cache.get(cache_key(config, op, device))
    if got is not None:
        return got
    return DEFAULT_BLOCK_KEYS[op]


def record(config, op: str, block_keys: int, device=None) -> None:
    """Pin a tile for a cell without sweeping (tests, explicit overrides)."""
    _cache[cache_key(config, op, device)] = int(block_keys)
    _store_persistent()


def clear() -> None:
    """Drop the in-process cache (tests)."""
    global _loaded_from
    _cache.clear()
    _loaded_from = None


def _median_ms(fn, setup, iters: int, device: torch.device) -> float:
    """Median time of ``fn()`` over ``iters`` runs after a warm-up, each
    after ``setup()``, which stays outside the timed interval: CUDA events
    on the card, the host clock on the CPU."""
    times = []
    for _ in range(iters + 1):
        setup()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def synthetic_cell(config, n: int, device) -> tuple:
    """The JAX package's synthetic sweep state on ``device``: (the state of
    a filter holding ``n // 2`` keys from seed 0, put in by the bulk insert
    at its default tile; ``n`` probe keys of the same stream; ``n`` op
    codes for ``apply_ops``)."""
    from . import ops  # local import: ops imports this module

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    opcodes = rng.integers(0, 3, size=(n,), dtype=np.int32)
    fill = rng.integers(0, 2**32, size=(n // 2, 2), dtype=np.uint32)
    keys, fill = (torch.from_numpy(a.view(np.int32)).to(device)
                  for a in (keys, fill))
    state, _ = ops.cuckoo_insert_bulk(
        config, config.init(device), fill,
        block_keys=DEFAULT_BLOCK_KEYS["bulk_insert"])
    return state, keys, torch.from_numpy(opcodes).to(device)


def run_op(config, op: str, state, keys, opcodes, block_keys: int):
    """One call of ``op``'s public wrapper at ``block_keys`` (the mutating
    ones update ``state.table`` in place)."""
    from . import ops

    if op == "query":
        return ops.cuckoo_query(config, state, keys, block_keys=block_keys)
    if op == "insert":
        return ops.cuckoo_insert_direct(config, state, keys,
                                        block_keys=block_keys)
    if op == "bulk_insert":
        return ops.cuckoo_insert_bulk(config, state, keys,
                                      block_keys=block_keys)
    if op == "apply_ops":
        return ops.cuckoo_apply_ops(config, state, keys, opcodes,
                                    block_keys=block_keys)
    raise ValueError(f"unknown op {op!r}")


def sweep(config, op: str, *, n: int = 4096,
          candidates: Sequence[int] = CANDIDATES, iters: int = 3,
          device=None) -> Dict[int, float]:
    """The sweep's timings, ``{block_keys: ms}``, for one (op, config) cell:
    the public wrapper at each candidate on :func:`synthetic_cell`'s state,
    each call on a fresh copy of its table made outside the timed interval
    (the wrappers update tables in place)."""
    if op not in DEFAULT_BLOCK_KEYS:
        raise ValueError(f"unknown op {op!r}")
    device = resolve_device(device)
    state0, keys, opcodes = synthetic_cell(config, n, device)
    work = state0._replace(table=state0.table.clone())
    return {int(bk): _median_ms(
                lambda bk=bk: run_op(config, op, work, keys, opcodes, bk),
                lambda: work.table.copy_(state0.table), iters, device)
            for bk in candidates}


def autotune(config, op: str, *, n: int = 4096,
             candidates: Sequence[int] = CANDIDATES, iters: int = 3,
             device=None) -> int:
    """Timed sweep over ``candidates`` for one (op, config) cell on
    ``device`` (default: the GPU; ``device="cpu"`` times the plain
    versions, which ignore the tile). The winner is recorded in the cache
    (and the ``REPRO_TORCH_AUTOTUNE_CACHE`` file when set) and returned. A
    second call is a cache hit; call :func:`clear` first to sweep again.
    No candidate is skipped for not dividing ``n``: the port pads nothing,
    its grids end in a guarded tile."""
    _load_persistent()
    device = resolve_device(device)
    key = cache_key(config, op, device)
    if key in _cache:
        return _cache[key]
    times = sweep(config, op, n=n, candidates=candidates, iters=iters,
                  device=device)
    best = min(times, key=times.get) if times else DEFAULT_BLOCK_KEYS[op]
    _cache[key] = int(best)
    _store_persistent()
    return int(best)
