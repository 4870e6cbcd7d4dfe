"""Attention: GQA with RoPE, sliding windows, softcap, QK-norm, and MLA.

Port of ``repro.models.attention``. Prefill runs :func:`flash_attention`:
on CUDA tensors the hand-written kernel (``kernels/csrc/
flash_attention.cu``), on CPU tensors its plain version, both through
``kernels.ops.flash_attention_bshd``; both take the attention-logit
softcap (gemma2's 50). Decode (one query token) is
:func:`decode_attention`, plain torch ops over the valid part of the
cache, as in the JAX package no Pallas kernel computes it.

MLA (DeepSeek-V3's multi-head latent attention, :func:`mla_apply`)
caches the compressed latent and the shared rope key (:class:`MLACache`);
its prefill expands them to per-head keys (D 192) and values (Dv 128)
for :func:`flash_attention`, and its decode runs the absorbed einsums
(``cfg.mla_absorb``) or the naive expansion, plain torch ops as in JAX.

The caches are the port's mutable buffers: a decode step writes its token
into the cache in place and returns the same cache object (the JAX
package returns a new one), so a step moves no more than a token's worth
of cache. A caller that keeps a cache for later (the serving engine's
prefix cache) decodes on a copy.
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
    has its own tiles. On the card, bf16 at head sizes 32/64/128 reads q,
    k and v where they lie and writes [B, Sq, H, Dv] directly
    (``kernels.ops.flash_attention_bshd``).
    """
    return ops.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset,
                                    attn_softcap=attn_softcap,
                                    chunk_q=chunk_q, chunk_k=chunk_k,
                                    out_dtype=out_dtype)


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 Multi-head Latent Attention)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor     # [B, S, kv_lora_rank]   compressed latent
    k_rope: torch.Tensor   # [B, S, qk_rope_dim]    shared rope key


class MLA(nn.Module):
    """Projections and norms of one MLA layer."""

    def __init__(self, wdq: Dense, q_norm: RMSNorm, wuq: Dense, wdkv: Dense,
                 kv_norm: RMSNorm, wkr: Dense, wuk: Dense, wuv: Dense,
                 wo: Dense):
        super().__init__()
        self.wdq, self.q_norm, self.wuq = wdq, q_norm, wuq
        self.wdkv, self.kv_norm, self.wkr = wdkv, kv_norm, wkr
        self.wuk, self.wuv, self.wo = wuk, wuv, wo


def mla_init(gen, cfg, dtype=torch.bfloat16, device=None) -> MLA:
    d = cfg.d_model
    H = cfg.num_heads
    rq, rkv = cfg.mla_q_lora_rank, cfg.mla_kv_lora_rank
    dn, dr, dv = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_dim
    kw = dict(dtype=dtype, device=device)
    return MLA(dense_init(gen, d, rq, **kw), rmsnorm_init(rq, device),
               dense_init(gen, rq, H * (dn + dr), **kw),
               dense_init(gen, d, rkv, **kw), rmsnorm_init(rkv, device),
               dense_init(gen, d, dr, **kw),
               dense_init(gen, rkv, H * dn, **kw),
               dense_init(gen, rkv, H * dv, **kw),
               dense_init(gen, H * dv, d, **kw))


def _mla_expand(p: MLA, cfg, c_kv, k_rope):
    """Per-head keys [B, S, H, dn + dr] and values [B, S, H, dv] from the
    latent and the shared rope key."""
    B, Sk = c_kv.shape[:2]
    H = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_dim
    k_nope = dense_apply(p.wuk, c_kv).reshape(B, Sk, H, dn)
    vfull = dense_apply(p.wuv, c_kv).reshape(B, Sk, H, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sk, H, dr)], dim=-1)
    return k, vfull


def mla_apply(p: MLA, cfg, x, *, positions, cache: Optional[MLACache] = None,
              cache_pos=None, update_cache=False):
    """Returns (out, new_cache | None), as :func:`gqa_apply`: decode (x
    [B, 1, d] with a cache) writes the token's latent and rope key into
    the cache in place at ``cache_pos`` (an int)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_dim

    q = dense_apply(p.wuq, rmsnorm_apply(p.q_norm, dense_apply(p.wdq, x)))
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rmsnorm_apply(p.kv_norm, dense_apply(p.wdkv, x))      # [B,S,rkv]
    k_rope = apply_rope(dense_apply(p.wkr, x)[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0]      # [B,S,dr]

    decode = cache is not None and S == 1
    new_cache = None
    if decode:
        cache.c_kv[:, cache_pos] = c_kv[:, 0].to(cache.c_kv.dtype)
        cache.k_rope[:, cache_pos] = k_rope[:, 0].to(cache.k_rope.dtype)
        new_cache = cache
        # the valid part of the cache, the new token included
        c_kv = cache.c_kv[:, :cache_pos + 1]
        k_rope = cache.k_rope[:, :cache_pos + 1]
    elif update_cache:
        new_cache = MLACache(c_kv.to(torch.bfloat16), k_rope.to(torch.bfloat16))

    scale = 1.0 / np.sqrt(dn + dr)
    if decode and cfg.mla_absorb:
        # Absorbed decode: W_uk folded into q and W_uv into the output, so
        # attention runs in the rank-rkv latent space. The bf16 operands'
        # float32 copies multiplied in float32: JAX's bf16 operands with
        # preferred_element_type=float32, with the copies it avoids
        # (ROADMAP queue C).
        rkv = cfg.mla_kv_lora_rank
        f32 = torch.float32
        wuk = p.wuk.w.reshape(rkv, H, dn)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32),
                             wuk.to(f32))                        # [B,H,rkv]
        s = (torch.einsum("bhr,bsr->bhs", q_lat.to(c_kv.dtype).to(f32),
                          c_kv.to(f32))
             + torch.einsum("bhp,bsp->bhs", q_rope[:, 0].to(f32),
                            k_rope.to(f32))) * scale
        pr = torch.softmax(s, dim=-1).to(c_kv.dtype)
        ctx = torch.einsum("bhs,bsr->bhr", pr.to(f32), c_kv.to(f32))
        wuv = p.wuv.w.reshape(rkv, H, dv)
        out = torch.einsum("bhr,rhv->bhv", ctx.to(wuv.dtype).to(f32),
                           wuv.to(f32))[:, None]
    elif decode:
        # naive decode: expand the cached latents to per-head K/V
        k, vfull = _mla_expand(p, cfg, c_kv, k_rope)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = decode_attention(qfull, k, vfull, cache_pos + 1, scale=scale)
    else:
        # prefill: the expanded form through the flash kernel (D dn + dr
        # against Dv dv: the kernel's FMA variant on the card)
        k, vfull = _mla_expand(p, cfg, c_kv, k_rope)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(qfull, k, vfull, causal=True, scale=scale,
                              chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k,
                              out_dtype=x.dtype)
    out = out.reshape(B, S, H * dv).to(x.dtype)
    return dense_apply(p.wo, out), new_cache
