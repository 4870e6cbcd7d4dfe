"""Batched cuckoo-filter query: the CUDA kernel's binding and its plain version.

The kernel (``csrc/cuckoo_query.cu``) replaces ``repro/kernels/
cuckoo_query.py: cuckoo_query_fused_pallas``: hash, one gather of both
candidate buckets, SWAR match, hit. :func:`cuckoo_query_plain` is the same
computation in vectorized torch; ``kernels.ops.cuckoo_query`` picks one by
the device the table lives on.
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


def cuckoo_query_launch(config: CuckooConfig, table: torch.Tensor,
                        keys: torch.Tensor, hit: torch.Tensor) -> None:
    """Launch the kernel on the current stream (arguments already checked)."""
    rc = build.load("cuckoo_query").cuckoo_query_launch(
        table.data_ptr(), keys.data_ptr(), hit.data_ptr(), keys.shape[0],
        *build.geometry(config),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "cuckoo_query")
