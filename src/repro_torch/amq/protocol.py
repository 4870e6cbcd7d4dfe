"""The AMQ protocol subset the port's ``cuckoo`` and ``bloom`` backends need.

Port of the result types, capability model and helpers of
``repro.amq.protocol``:

    insert / insert_bulk :: (config, state, keys, *, opts) -> (state', InsertReport)
    query                :: (config, state, keys, *, opts) -> (state,  QueryResult)
    delete               :: (config, state, keys, *, opts) -> (state', DeleteReport)

``keys`` are ``int32[n, 2]`` tensors holding (lo, hi) uint32 pairs
(``repro_torch.core.hashing.normalize_keys``). Results are tuples of
tensors on the keys' device. Mixed batches, snapshots, cascades and
tiering come with later port slices.

This module imports only torch, so every other module may import it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can do — consumers branch on these, never on names.

    Same fields and defaults as the JAX package. In this port slice the
    ``cuckoo`` backend sets ``supports_mixed``, ``supports_expand``,
    ``supports_snapshot`` and ``supports_tiering`` to False: those
    surfaces are ported by later slices.
    """

    supports_delete: bool = True
    supports_bulk: bool = False
    supports_sharding: bool = False
    counting: bool = True
    exact: bool = False
    serial_insert: bool = False
    supports_expand: bool = False
    supports_mixed: bool = False
    supports_snapshot: bool = False
    supports_tiering: bool = False


# Per-key op codes (int32), as in the JAX package.
OP_QUERY = 0
OP_INSERT = 1
OP_DELETE = 2


class InsertReport(NamedTuple):
    """Uniform insertion result.

    * ``ok`` — bool[n]; False means the structure was too full for that key.
    * ``evictions`` — int32[n] eviction-chain length.
    * ``rounds`` — int32[] rounds the batch ran (the kernel pass counts one).
    * ``routed`` — bool[n]; all True for unsharded backends.
    """

    ok: torch.Tensor
    evictions: torch.Tensor
    rounds: torch.Tensor
    routed: torch.Tensor


class QueryResult(NamedTuple):
    """Uniform membership-query result (``hits`` valid where ``routed``)."""

    hits: torch.Tensor
    routed: torch.Tensor


class DeleteReport(NamedTuple):
    """Uniform deletion result (``ok`` = a stored copy was removed)."""

    ok: torch.Tensor
    routed: torch.Tensor


def load_factor(config, state) -> float:
    """Uniform occupancy: stored keys / nominal capacity."""
    return float(state.count.sum()) / config.num_slots


def all_routed(keys: torch.Tensor) -> torch.Tensor:
    """The trivial ``routed`` mask for unsharded backends."""
    return torch.ones((keys.shape[0],), dtype=torch.bool, device=keys.device)


def ensure_valid(keys: torch.Tensor, valid: Optional[object]) -> torch.Tensor:
    """Normalize an optional validity mask to a bool[n] on the keys' device."""
    if valid is None:
        return all_routed(keys)
    valid = torch.as_tensor(valid, device=keys.device).to(torch.bool)
    if tuple(valid.shape) != (keys.shape[0],):
        raise ValueError(f"valid: shape {list(valid.shape)} does not match "
                         f"{keys.shape[0]} keys (want a bool[n] mask)")
    return valid.contiguous()


def fpr_tolerance(expected: float, n_probes: int,
                  factor: float = 5.0) -> tuple:
    """Acceptance band ``(lo, hi)`` for an empirically measured FPR.

    The analytic formulas are asymptotic, hence the multiplicative
    ``factor``; the additive slack keeps a few stray hits from failing
    low-FPR structures, and the lower bound only applies when the model
    predicts enough hits to rise above counting noise. Exact structures
    get (0, 0).
    """
    if expected == 0.0:
        return 0.0, 0.0
    hi = factor * expected + 8.0 / n_probes
    lo = expected / factor if expected * n_probes >= 30 else 0.0
    return lo, hi
