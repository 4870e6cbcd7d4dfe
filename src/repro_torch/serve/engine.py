"""Batched serving engine: prefill + decode with prefix-cache reuse.

Port of ``repro.serve.engine``: the engine allocates ``max_len`` bf16
caches after each prefill and decodes greedily one token a step; the
:class:`~.prefix_cache.PrefixCache` (cuckoo-filter-guarded)
short-circuits prefill for previously seen prompts. On the GPU the
prefill's attention runs the flash-attention kernel, and the guard
filter's admissions and evictions the cuckoo kernels.

Cache entries are (logits, caches) on the model's device. Decode writes
into its caches in place (``models.attention``), so each request decodes
on a copy of its entry's caches and the entry stays as its prefill left
it; an LRU eviction drops the cache's reference to an entry, which frees
it once the request that evicted it returns.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import Model
from ..models.attention import KVCache
from .prefix_cache import PrefixCache


class ServeEngine:
    def __init__(self, model: Model, *, batch: int, max_len: int,
                 prefix_cache_entries: int = 64,
                 prefix_cache_backend: str = "cuckoo",
                 prefix_cache_auto_expand: bool = True,
                 prefix_cache_kw: Optional[Dict[str, Any]] = None,
                 prefix_cache_service_kw: Optional[Dict[str, Any]] = None):
        """``prefix_cache_backend`` / ``prefix_cache_auto_expand`` /
        ``prefix_cache_kw`` flow to :class:`PrefixCache` (the guard filter
        lives on the model's device unless ``prefix_cache_kw`` names
        another); ``prefix_cache_service_kw`` configures the guard
        filter's micro-batching service, whose SLO snapshot rides the
        stats returned by :meth:`generate` under ``"filter_service"``."""
        self.model = model
        self.batch = batch
        self.max_len = max_len
        filter_kw = {"device": model.device, **(prefix_cache_kw or {})}
        self.prefix_cache = PrefixCache(
            prefix_cache_entries,
            backend=prefix_cache_backend,
            auto_expand=prefix_cache_auto_expand,
            service_kw=prefix_cache_service_kw,
            **filter_kw)

    def _grow_caches(self, caches, prompt_len: int):
        big = self.model.init_caches(self.batch, self.max_len)
        for dst, src in zip(big, caches):
            for d, s in zip(dst, src):
                d[:, :s.shape[1]] = s
        return big

    def generate(self, prompts: np.ndarray, steps: int, *,
                 greedy: bool = True, reuse_prefix: bool = True
                 ) -> Tuple[np.ndarray, Dict]:
        """prompts: int32[batch, prompt_len]. Returns (tokens, stats)."""
        assert prompts.shape[0] == self.batch
        prompt_len = prompts.shape[1]
        assert prompt_len + steps <= self.max_len

        cached = self.prefix_cache.lookup(prompts.reshape(-1)) \
            if reuse_prefix else None
        if cached is not None:
            logits, caches = cached
        else:
            logits, caches = self.model.prefill(
                torch.as_tensor(np.asarray(prompts, np.int32)))
            caches = self._grow_caches(caches, prompt_len)
            if reuse_prefix:
                self.prefix_cache.insert(prompts.reshape(-1),
                                         (logits, caches))
        if reuse_prefix:  # the entry keeps its caches; decode on a copy
            caches = [KVCache(c.k.clone(), c.v.clone()) for c in caches]

        out = []
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for t in range(steps):
            out.append(tok.cpu().numpy())
            logits, caches = self.model.decode_step(tok, caches,
                                                    prompt_len + t)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok.cpu().numpy())
        tokens = np.stack(out, axis=1)
        stats = dict(self.prefix_cache.stats)
        stats["filter_service"] = self.prefix_cache.slo_stats()
        return tokens, stats
