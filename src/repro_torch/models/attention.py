"""Attention: GQA with RoPE, sliding windows and the KV cache.

Port of ``repro.models.attention`` for the dense GQA mixer. Prefill runs
:func:`flash_attention`: on CUDA tensors the hand-written kernel
(``kernels/csrc/flash_attention.cu``), on CPU tensors its plain version,
both through ``kernels.ops.flash_attention``. Decode (one query token) is
:func:`decode_attention`, plain torch ops over the valid part of the
cache, as in the JAX package no Pallas kernel computes it.

The KV cache is the port's mutable buffer: a decode step writes its token
into ``cache.k`` / ``cache.v`` in place and returns the same
:class:`KVCache` (the JAX package returns a new one), so a step moves no
more than a token's worth of cache. A caller that keeps a cache for
later (the serving engine's prefix cache) decodes on a copy.

Attention-logit softcap runs only on the CPU (the kernel has none, nor
has the Pallas one); MLA waits with the other mixers (ROADMAP queue A
item 16).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..kernels import ops
from .layers import (Dense, RMSNorm, apply_rope, dense_apply, dense_init,
                     rmsnorm_apply, rmsnorm_init, softcap)

def flash_attention(q, k, v, *, causal=True, window=None, attn_softcap=None,
                    q_offset=0, chunk_q=512, chunk_k=1024, scale=None,
                    out_dtype=torch.float32):
    """Online-softmax attention.

    q: [B, Sq, H, D]; k, v: [B, Sk, KVH, D] with H % KVH == 0; query head
    ``h`` reads KV head ``h // g`` (``g = H // KVH``), as the JAX package's
    ``q.reshape(B, S, KVH, g, D)``. Returns [B, Sq, H, Dv] in float32, as
    the JAX function does, unless ``out_dtype`` asks for the float32
    result rounded to bfloat16 (the kernel then writes half the bytes).
    ``chunk_q`` / ``chunk_k`` tile the plain version's loop; the kernel
    has its own tiles.
    """
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = H // KVH
    qk = q.reshape(B, Sq, KVH, g, D).permute(0, 2, 3, 1, 4) \
        .reshape(B * KVH, g, Sq, D)
    kk = k.permute(0, 2, 1, 3).reshape(B * KVH, Sk, D)
    vk = v.permute(0, 2, 1, 3).reshape(B * KVH, Sk, Dv)
    if q.is_cuda:
        qk, kk, vk = qk.contiguous(), kk.contiguous(), vk.contiguous()
    out = ops.flash_attention(qk, kk, vk, causal=causal, window=window,
                              scale=scale, q_offset=q_offset,
                              attn_softcap=attn_softcap, chunk_q=chunk_q,
                              chunk_k=chunk_k, out_dtype=out_dtype)
    return out.reshape(B, KVH, g, Sq, Dv).permute(0, 3, 1, 2, 4) \
        .reshape(B, Sq, H, Dv)


def decode_attention(q, k_cache, v_cache, cur_len: int, *, window=None,
                     attn_softcap=None, scale=None):
    """Single-token attention over a (padded) cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, S, KVH, D]; cur_len: number of
    valid cache positions *including* the new token (at least 1). Only the
    valid positions are computed: a masked one would contribute exp(-1e30
    - max) = 0. Scores and the output accumulate in float32 from the
    cache's bf16 values, as JAX's ``preferred_element_type=float32``; the
    probabilities are rounded to the cache's dtype first, as there.
    """
    B, _, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    g = H // KVH
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    hi = min(int(cur_len), S)
    lo = max(0, int(cur_len) - window) if window is not None else 0
    qr = q.reshape(B, KVH, g, D).to(k_cache.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache[:, lo:hi].float()) * scale
    s = softcap(s, attn_softcap) if attn_softcap else s
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache[:, lo:hi].float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # [B, S, KVH, D] (S = window for SWA ring buffers)
    v: torch.Tensor


class GQA(nn.Module):
    """Projections of one GQA layer (``qnorm`` / ``knorm`` with QK-norm)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense,
                 qnorm: Optional[RMSNorm] = None,
                 knorm: Optional[RMSNorm] = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.qnorm, self.knorm = qnorm, knorm


def gqa_init(gen, cfg, layer_cfg, dtype=torch.bfloat16, device=None) -> GQA:
    """cfg: ModelConfig; layer_cfg: dict(window=..., softcap=...)."""
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_()
    kw = dict(dtype=dtype, device=device)
    p = GQA(dense_init(gen, d, H * hd, bias=cfg.qkv_bias, **kw),
            dense_init(gen, d, KVH * hd, bias=cfg.qkv_bias, **kw),
            dense_init(gen, d, KVH * hd, bias=cfg.qkv_bias, **kw),
            dense_init(gen, H * hd, d, **kw))
    if cfg.qk_norm:
        p.qnorm = rmsnorm_init(hd, device)
        p.knorm = rmsnorm_init(hd, device)
    return p


def gqa_apply(p: GQA, cfg, x, *, positions, window=None,
              cache: Optional[KVCache] = None, cache_pos=None, causal=True,
              attn_softcap=None, update_cache=False):
    """Returns (out, new_cache | None).

    Prefill: cache is None (``update_cache=True`` builds one). Decode: x
    is [B, 1, d]; cache holds past KV, and the new token is written into
    it in place at ``cache_pos`` (an int).
    """
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_()
    q = dense_apply(p.wq, x).reshape(B, S, H, hd)
    k = dense_apply(p.wk, x).reshape(B, S, KVH, hd)
    v = dense_apply(p.wv, x).reshape(B, S, KVH, hd)
    if p.qnorm is not None:
        q = rmsnorm_apply(p.qnorm, q)
        k = rmsnorm_apply(p.knorm, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and S == 1:
        # decode: write into the cache (ring-buffer slot for SWA layers)
        Sc = cache.k.shape[1]
        write = cache_pos % Sc if window is not None else cache_pos
        cache.k[:, write] = k[:, 0].to(cache.k.dtype)
        cache.v[:, write] = v[:, 0].to(cache.v.dtype)
        new_cache = cache
        # ring buffer: all Sc slots valid once cache_pos >= Sc; masking by
        # recency is positional — cur_len=min(pos+1, Sc), window=None
        cur = min(cache_pos + 1, Sc) if window is not None else cache_pos + 1
        out = decode_attention(q, cache.k, cache.v, cur, window=None,
                               attn_softcap=attn_softcap)
    else:
        # JAX returns float32 and casts it to x's dtype here; the port asks
        # for x's dtype, the same values (one rounding of the float32).
        out = flash_attention(q, k, v, causal=causal, window=window,
                              attn_softcap=attn_softcap,
                              chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k,
                              out_dtype=x.dtype)
        if update_cache:
            if window is not None and k.shape[1] >= window:
                # SWA ring buffer: token t lives at slot t % window, so roll
                # the kept tail to align the decode-time write phase.
                shift = k.shape[1] % window
                new_cache = KVCache(
                    torch.roll(k[:, -window:], shift, dims=1).to(torch.bfloat16),
                    torch.roll(v[:, -window:], shift, dims=1).to(torch.bfloat16))
            else:
                new_cache = KVCache(k.to(torch.bfloat16), v.to(torch.bfloat16))
    out = out.reshape(B, S, H * hd).to(x.dtype)
    return dense_apply(p.wo, out), new_cache
