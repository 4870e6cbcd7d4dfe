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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.cuckoo_filter import CuckooConfig, CuckooState
from .filters.blocked_bloom import BloomConfig, BloomState


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
