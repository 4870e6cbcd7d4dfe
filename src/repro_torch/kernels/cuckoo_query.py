"""Batched cuckoo-filter query: the two CUDA kernels' bindings and their
plain versions.

* Fused (``csrc/cuckoo_query.cu``) replaces ``repro/kernels/
  cuckoo_query.py: cuckoo_query_fused_pallas``: hash, bucket i1, SWAR
  match, and bucket i2 only where i1 holds no matching tag, hit.
  :func:`cuckoo_query_plain` is the same function in vectorized torch
  (it gathers both buckets of every key).
* Unfused (``csrc/cuckoo_query_unfused.cu``) replaces ``cuckoo_query_pallas``:
  the fused kernel's reads (bucket i1, and bucket i2 only where i1 holds
  no matching tag), each bucket's words unpacked to lanes and compared
  lane by lane. :func:`cuckoo_query_unfused_plain` follows the same route
  (``layout.unpack_words``, then a lane compare, i2 only for the keys i1
  does not settle).

Both compute one function; ``kernels.ops.cuckoo_query(fused=...)`` picks
the kernel, and the device the table lives on picks kernel or plain
version.
"""

from __future__ import annotations

import torch

from ..core import layout as L
from ..core.cuckoo_filter import CuckooConfig, prepare_keys_plain
from . import build


def cuckoo_query_plain(config: CuckooConfig, table: torch.Tensor,
                       keys: torch.Tensor) -> torch.Tensor:
    """Membership of int32[n, 2] keys in the packed table -> bool[n]."""
    lay = config.layout
    base_tag, i1, i2 = prepare_keys_plain(config, keys)
    t1, t2 = config.placement.query_match_tags(base_tag)
    words = L.gather_bucket_words(table, torch.stack([i1, i2], dim=-1), lay)
    m1 = L.swar_match_mask(words[:, 0], t1[:, None], lay.fp_bits)
    m2 = L.swar_match_mask(words[:, 1], t2[:, None], lay.fp_bits)
    return ((m1 | m2) != 0).any(dim=-1)


def cuckoo_query_unfused_plain(config: CuckooConfig, table: torch.Tensor,
                               keys: torch.Tensor) -> torch.Tensor:
    """The unfused route: bucket i1's lanes, then bucket i2's for the keys
    whose i1 holds no lane equal to t1 -> bool[n]."""
    lay = config.layout
    base_tag, i1, i2 = prepare_keys_plain(config, keys)
    t1, t2 = config.placement.query_match_tags(base_tag)

    def lanes_hold(bucket, tag):
        lanes = L.unpack_words(L.gather_bucket_words(table, bucket, lay),
                               lay.fp_bits)
        return (lanes == tag[:, None]).any(dim=-1)

    hit = lanes_hold(i1, t1)
    rest = (~hit).nonzero().squeeze(1)
    hit[rest] = lanes_hold(i2[rest], t2[rest])
    return hit


def cuckoo_query_launch(config: CuckooConfig, table: torch.Tensor,
                        keys: torch.Tensor, hit: torch.Tensor) -> None:
    """Launch the kernel on the current stream (arguments already checked)."""
    rc = build.load("cuckoo_query").cuckoo_query_launch(
        table.data_ptr(), keys.data_ptr(), hit.data_ptr(), keys.shape[0],
        *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_query")


def cuckoo_query_unfused_launch(config: CuckooConfig, table: torch.Tensor,
                                keys: torch.Tensor, hit: torch.Tensor) -> None:
    """Launch the unfused kernel on the current stream (arguments already
    checked)."""
    rc = build.load("cuckoo_query_unfused").cuckoo_query_unfused_launch(
        table.data_ptr(), keys.data_ptr(), hit.data_ptr(), keys.shape[0],
        *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_query_unfused")
