"""Block assembly + layer stacks.

Port of ``repro.models.transformer`` for the ``attn`` and ``attn_local``
mixers with the ``mlp`` FFN. A *block* = pre-norm mixer + pre-norm FFN,
both residual. The JAX package scans stacked parameters of repeating
segments with ``lax.scan``; here a Python loop runs one module per layer
(:func:`stack_prefill`, :func:`stack_decode`). MLA, SSM, RG-LRU and MoE
blocks, ``stack_apply``, remat and the loss wait (ROADMAP queue A item
16).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from . import attention as A
from .layers import mlp_apply, mlp_init, rmsnorm_apply, rmsnorm_init


def _mixer_kind(kind: str) -> str:
    return kind.split("+")[0]


def _ffn_kind(kind: str) -> str:
    parts = kind.split("+")
    return parts[1] if len(parts) > 1 else "none"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue A item 16)")


class Block(nn.Module):
    """One layer: ``ln1``, ``mixer``, and (with an FFN) ``ln2``, ``ffn``."""

    def __init__(self, kind: str, ln1, mixer, ln2=None, ffn=None):
        super().__init__()
        self.kind = kind
        self.ln1, self.mixer, self.ln2, self.ffn = ln1, mixer, ln2, ffn


def block_init(gen, cfg, kind: str, device=None) -> Block:
    mixer, ffn = _mixer_kind(kind), _ffn_kind(kind)
    if mixer not in ("attn", "attn_local"):
        raise _not_ported(f"the {mixer!r} mixer")
    if ffn not in ("mlp", "none"):
        raise _not_ported(f"the {ffn!r} FFN")
    p = Block(kind, rmsnorm_init(cfg.d_model, device),
              A.gqa_init(gen, cfg, {}, device=device))
    if ffn == "mlp":
        p.ln2 = rmsnorm_init(cfg.d_model, device)
        p.ffn = mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                         device=device)
    return p


def block_apply(p: Block, cfg, kind: str, x, *, positions, cache=None,
                cache_pos=None, update_cache=False):
    mixer, ffn = _mixer_kind(kind), _ffn_kind(kind)
    h = rmsnorm_apply(p.ln1, x, cfg.norm_eps)
    kw = dict(cache=cache, cache_pos=cache_pos, update_cache=update_cache)
    if mixer == "attn":
        out, new_cache = A.gqa_apply(
            p.mixer, cfg, h, positions=positions, window=None,
            causal=cfg.causal, attn_softcap=cfg.attn_softcap, **kw)
    elif mixer == "attn_local":
        out, new_cache = A.gqa_apply(
            p.mixer, cfg, h, positions=positions,
            window=cfg.sliding_window, causal=cfg.causal,
            attn_softcap=cfg.attn_softcap, **kw)
    else:
        raise _not_ported(f"the {mixer!r} mixer")
    x = x + out

    if ffn == "mlp":
        x = x + mlp_apply(p.ffn, rmsnorm_apply(p.ln2, x, cfg.norm_eps),
                          act=cfg.act)
    elif ffn != "none":
        raise _not_ported(f"the {ffn!r} FFN")
    return x, new_cache


def _empty_cache(cfg, kind: str, batch: int, max_len: int, device=None):
    """Empty (zero) bf16 cache of one layer, for decode."""
    mixer = _mixer_kind(kind)
    hd = cfg.head_dim_()
    if mixer == "attn":
        length = max_len
    elif mixer == "attn_local":
        length = min(cfg.sliding_window, max_len)
    else:
        raise _not_ported(f"the {mixer!r} cache")
    shape = (batch, length, cfg.num_kv_heads, hd)
    return A.KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                     torch.zeros(shape, dtype=torch.bfloat16, device=device))


# ---------------------------------------------------------------------------
# Stack: one module a layer
# ---------------------------------------------------------------------------

def stack_init(gen, cfg, device=None) -> nn.ModuleList:
    """One :class:`Block` per layer, in ``cfg.layer_kinds()`` order."""
    return nn.ModuleList(block_init(gen, cfg, kind, device)
                         for kind in cfg.layer_kinds())


def stack_prefill(layers, cfg, x, *, positions):
    """Forward + build per-layer caches. Returns (x, caches)."""
    caches: List[A.KVCache] = []
    for p in layers:
        x, c = block_apply(p, cfg, p.kind, x, positions=positions,
                           update_cache=True)
        caches.append(c)
    return x, caches


def stack_decode(layers, cfg, x, caches, *, positions, cache_pos: int):
    """Single-token step updating caches (in place). Returns (x, caches)."""
    new_caches = []
    for p, cache in zip(layers, caches):
        x, c = block_apply(p, cfg, p.kind, x, positions=positions,
                           cache=cache, cache_pos=cache_pos)
        new_caches.append(c)
    return x, new_caches


def init_caches(cfg, batch: int, max_len: int, device=None):
    """Empty decode caches, one :class:`~.attention.KVCache` a layer."""
    return [_empty_cache(cfg, kind, batch, max_len, device)
            for kind in cfg.layer_kinds()]
