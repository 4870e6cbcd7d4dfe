"""Block assembly + layer stacks.

Port of ``repro.models.transformer`` for every mixer (``attn``,
``attn_local``, ``mla``, ``ssm``, ``rglru``) with an ``mlp``, ``moe`` or
no FFN. A *block* = pre-norm mixer + pre-norm FFN, both residual. The
JAX package scans stacked parameters of repeating segments with
``lax.scan``; here a Python loop runs one module per layer:
:func:`stack_apply` (the forward without caches: the encoder's path),
:func:`stack_prefill` and :func:`stack_decode`. With ``remat``,
:func:`stack_apply` recomputes each layer in the backward, as the JAX
package's ``jax.checkpoint`` of its scanned period does
(``cfg.remat_policy``: ``"full"`` saves only each layer's input,
``"dots"`` also the outputs of the non-batched matmuls, ``"none"``
nothing more than without remat).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as A
from . import moe as M
from . import rglru as R
from . import ssm as SSM
from .layers import mlp_apply, mlp_init, rmsnorm_apply, rmsnorm_init


def _mixer_kind(kind: str) -> str:
    return kind.split("+")[0]


def _ffn_kind(kind: str) -> str:
    parts = kind.split("+")
    return parts[1] if len(parts) > 1 else "none"


class Block(nn.Module):
    """One layer: ``ln1``, ``mixer``, and (with an FFN) ``ln2``, ``ffn``."""

    def __init__(self, kind: str, ln1, mixer, ln2=None, ffn=None):
        super().__init__()
        self.kind = kind
        self.ln1, self.mixer, self.ln2, self.ffn = ln1, mixer, ln2, ffn


def block_init(gen, cfg, kind: str, device=None) -> Block:
    mixer, ffn = _mixer_kind(kind), _ffn_kind(kind)
    if mixer in ("attn", "attn_local"):
        p = Block(kind, rmsnorm_init(cfg.d_model, device),
                  A.gqa_init(gen, cfg, {}, device=device))
    elif mixer == "mla":
        p = Block(kind, rmsnorm_init(cfg.d_model, device),
                  A.mla_init(gen, cfg, device=device))
    elif mixer == "ssm":
        p = Block(kind, rmsnorm_init(cfg.d_model, device),
                  SSM.ssm_init(gen, cfg, device=device))
    elif mixer == "rglru":
        p = Block(kind, rmsnorm_init(cfg.d_model, device),
                  R.rglru_init(gen, cfg, device=device))
    else:  # pragma: no cover
        raise ValueError(mixer)
    if ffn == "mlp":
        p.ln2 = rmsnorm_init(cfg.d_model, device)
        p.ffn = mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                         device=device)
    elif ffn == "moe":
        p.ln2 = rmsnorm_init(cfg.d_model, device)
        p.ffn = M.moe_init(gen, cfg, device=device)
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
    elif mixer == "mla":
        out, new_cache = A.mla_apply(p.mixer, cfg, h, positions=positions,
                                     **kw)
    elif mixer == "ssm":
        out, new_cache = SSM.ssm_apply(p.mixer, cfg, h, cache=cache,
                                       update_cache=update_cache)
    elif mixer == "rglru":
        out, new_cache = R.rglru_apply(p.mixer, cfg, h, cache=cache,
                                       update_cache=update_cache)
    else:  # pragma: no cover
        raise ValueError(mixer)
    x = x + out

    if ffn == "mlp":
        x = x + mlp_apply(p.ffn, rmsnorm_apply(p.ln2, x, cfg.norm_eps),
                          act=cfg.act)
    elif ffn == "moe":
        x = x + M.moe_apply(p.ffn, cfg,
                            rmsnorm_apply(p.ln2, x, cfg.norm_eps),
                            capacity_factor=cfg.capacity_factor)
    elif ffn != "none":  # pragma: no cover
        raise ValueError(ffn)
    return x, new_cache


def _empty_cache(cfg, kind: str, batch: int, max_len: int, device=None):
    """Empty (zero) cache of one layer, for decode: bf16, but for the
    float32 recurrent states (the SSM's ``state``, the RG-LRU's ``h``),
    which have no sequence axis."""
    mixer = _mixer_kind(kind)
    hd = cfg.head_dim_()
    kw = dict(dtype=torch.bfloat16, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if mixer == "ssm":
        conv_dim = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
        return SSM.SSMCache(
            torch.zeros((batch, cfg.conv1d_width - 1, conv_dim), **kw),
            torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), **f32))
    if mixer == "rglru":
        W = cfg.rglru_width or cfg.d_model
        return R.RGLRUCache(
            torch.zeros((batch, W), **f32),
            torch.zeros((batch, cfg.conv1d_width - 1, W), **kw))
    if mixer == "attn":
        length = max_len
    elif mixer == "attn_local":
        length = min(cfg.sliding_window, max_len)
    elif mixer == "mla":
        return A.MLACache(
            torch.zeros((batch, max_len, cfg.mla_kv_lora_rank), **kw),
            torch.zeros((batch, max_len, cfg.mla_qk_rope_dim), **kw))
    else:  # pragma: no cover
        raise ValueError(mixer)
    shape = (batch, length, cfg.num_kv_heads, hd)
    return A.KVCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw))


# ---------------------------------------------------------------------------
# Stack: one module a layer
# ---------------------------------------------------------------------------

def stack_init(gen, cfg, device=None) -> nn.ModuleList:
    """One :class:`Block` per layer, in ``cfg.layer_kinds()`` order."""
    return nn.ModuleList(block_init(gen, cfg, kind, device)
                         for kind in cfg.layer_kinds())


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the non-batched matmuls
    (``x @ w`` reaches ``aten.mm``; JAX's
    ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXT = {
    # "full": recompute the whole layer in the backward; only its input
    # stays resident.
    "full": None,
    # "dots": save the matmul outputs as well: a faster backward, much
    # higher residency.
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots),
}


def stack_apply(layers, cfg, x, *, positions, remat: bool = False):
    """Forward through every layer, no caches. With ``remat`` (and grad
    mode on) each layer runs under ``torch.utils.checkpoint`` by
    ``cfg.remat_policy`` (``"none"``: no checkpoint)."""
    policy = cfg.remat_policy if remat and torch.is_grad_enabled() else "none"
    if policy not in ("none", *_REMAT_CONTEXT):
        raise ValueError(f"remat_policy: expected full, dots or none, got "
                         f"{policy!r}")
    for p in layers:
        if policy == "none":
            x, _ = block_apply(p, cfg, p.kind, x, positions=positions)
            continue
        kw = {} if _REMAT_CONTEXT[policy] is None else {
            "context_fn": _REMAT_CONTEXT[policy]}
        x = checkpoint(_block_out, p, cfg, x, positions, use_reentrant=False,
                       preserve_rng_state=False, **kw)
    return x


def _block_out(p, cfg, x, positions):
    return block_apply(p, cfg, p.kind, x, positions=positions)[0]


def stack_prefill(layers, cfg, x, *, positions):
    """Forward + build per-layer caches. Returns (x, caches)."""
    caches: list = []
    for p in layers:
        x, c = block_apply(p, cfg, p.kind, x, positions=positions,
                           update_cache=True)
        caches.append(c)
    return x, caches


def stack_decode(layers, cfg, x, caches, *, positions, cache_pos: int):
    """Single-token step. Attention caches are updated in place; an SSM or
    RG-LRU layer returns a new cache. Returns (x, caches)."""
    new_caches = []
    for p, cache in zip(layers, caches):
        x, c = block_apply(p, cfg, p.kind, x, positions=positions,
                           cache=cache, cache_pos=cache_pos)
        new_caches.append(c)
    return x, new_caches


def init_caches(cfg, batch: int, max_len: int, device=None):
    """Empty decode caches, one a layer (:class:`~.attention.KVCache`;
    :class:`~.attention.MLACache`, :class:`~.ssm.SSMCache` or
    :class:`~.rglru.RGLRUCache` for an MLA, SSM or RG-LRU layer)."""
    return [_empty_cache(cfg, kind, batch, max_len, device)
            for kind in cfg.layer_kinds()]
