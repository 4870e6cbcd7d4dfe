"""Carry filter state and config between the JAX package and the port.

* :func:`state_from_numpy` / :func:`state_to_numpy` use the dict format of
  the JAX package's snapshots (``{"table": uint32[num_words], "count":
  int32[]}``), so ``jax_handle.snapshot().arrays`` loads straight into the
  port and back.
* :func:`config_from_reference` rebuilds the port's ``CuckooConfig`` from
  a JAX ``CuckooConfig``'s field values (duck-typed: this module imports
  nothing of the JAX package) and checks that the two reprs — the
  snapshot fingerprint — are equal.
* :func:`bloom_state_from_numpy` and :func:`bloom_config_from_reference`
  are their counterparts for the blocked Bloom filter.
* :func:`py_cuckoo_from_numpy` / :func:`py_cuckoo_to_numpy` carry the
  ``cpu-cuckoo`` oracle's state in the JAX adapter's snapshot format
  (``{"buckets": uint32[num_buckets, bucket_size], "count": int64[]}``);
  ``config_from_reference(cfg, PyCuckooConfig)`` carries its config.
* :func:`op_batch_from_reference` carries a JAX ``OpBatch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .amq.protocol import OpBatch
from .core.cuckoo_filter import CuckooConfig, CuckooState
from .filters.blocked_bloom import BloomConfig, BloomState
from .filters.cpu_reference import PyCuckooConfig, PyCuckooFilter


def _table_and_count(arrays: dict, device):
    table = np.array(arrays["table"], np.uint32)  # a writable copy
    count = np.asarray(arrays["count"], np.int32)
    if table.ndim != 1 or count.shape != ():
        raise ValueError(
            f"expected table uint32[num_words] and count int32[], got "
            f"{list(table.shape)} and {list(count.shape)}")
    return (torch.from_numpy(table.view(np.int32)).to(device),
            torch.tensor(int(count), dtype=torch.int32, device=device))


def state_from_numpy(arrays: dict, device) -> CuckooState:
    """``{"table": uint32[num_words], "count": int32[]}`` -> CuckooState."""
    return CuckooState(*_table_and_count(arrays, device))


def bloom_state_from_numpy(arrays: dict, device) -> BloomState:
    """``{"table": uint32[num_words], "count": int32[]}`` -> BloomState."""
    return BloomState(*_table_and_count(arrays, device))


def state_to_numpy(state: CuckooState) -> dict:
    """CuckooState -> ``{"table": uint32[num_words], "count": int32[]}``."""
    return {"table": state.table.detach().cpu().numpy().view(np.uint32),
            "count": np.asarray(int(state.count), np.int32)}


def config_from_reference(cfg, cls=CuckooConfig):
    """The port's ``cls`` config with the same field values as ``cfg``."""
    port = cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})
    if repr(port) != repr(cfg):
        raise ValueError(f"config fingerprints differ:\n  reference: {cfg!r}"
                         f"\n  port:      {port!r}")
    return port


def bloom_config_from_reference(cfg) -> BloomConfig:
    """The port's BloomConfig with the same field values as ``cfg``."""
    return config_from_reference(cfg, BloomConfig)


def py_cuckoo_from_numpy(arrays: dict, config: PyCuckooConfig) -> PyCuckooFilter:
    """``{"buckets": uint32[num_buckets, bucket_size], "count"}`` -> the
    oracle's filter (its eviction generator starts afresh, as on a JAX
    restore: membership is carried, not future victim choices)."""
    want = (config.num_buckets, config.bucket_size)
    buckets = np.asarray(arrays["buckets"], np.uint32)
    if buckets.shape != want:
        raise ValueError(f"buckets: expected {list(want)}, got "
                         f"{list(buckets.shape)}")
    filt = config.init()
    filt.buckets = [[int(t) for t in row] for row in buckets]
    filt.count = int(arrays["count"])
    return filt


def py_cuckoo_to_numpy(filt: PyCuckooFilter) -> dict:
    """The oracle's filter -> ``{"buckets": uint32[nb, b], "count": int64[]}``."""
    return {"buckets": np.asarray(filt.buckets, np.uint32),
            "count": np.asarray(filt.count, np.int64)}


def op_batch_from_reference(batch, device) -> OpBatch:
    """A JAX ``OpBatch`` (keys uint32[n, 2], ops int32[n], valid bool[n])
    -> the port's, on ``device``."""
    keys = np.array(batch.keys, np.uint32)                # writable copies
    return OpBatch(torch.from_numpy(keys.view(np.int32)).to(device),
                   torch.from_numpy(np.array(batch.ops, np.int32)).to(device),
                   torch.from_numpy(np.array(batch.valid, bool)).to(device))
