"""Mixture-of-Experts: top-k routing with capacity-bounded sort dispatch.

Port of ``repro.models.moe`` for both MoE architectures:
* Mixtral-8x22B — 8 experts, top-2, softmax routing over selected experts.
* DeepSeek-V3   — 256 routed experts top-8 (sigmoid scores, normalized over
  the selected set) + 1 shared expert.

The dispatch is the JAX package's, step for step (:func:`moe_dispatch`):
flatten the (token, choice) assignments, sort them by expert (stable),
rank each within its expert, keep the first ``cap`` of each, pack the kept
ones into an ``[E, cap, d]`` buffer, run the expert GLU as grouped
products (``torch.einsum``, as JAX computes it outside any Pallas kernel)
and add each kept assignment's output, times its routing weight, back
into its token's row. The top-k breaks ties by the lower expert index, as
``jax.lax.top_k`` does (a stable descending sort). The combine adds in
``x.dtype`` (bf16) as JAX's ``.at[t_s].add`` does, a token's
contributions one at a time in ascending expert order (the order of the
expert-sorted assignments, in which the JAX package's CPU scatter adds
them), so the sum is the same on every device and in every run: atomic
adds (``index_add_`` on the card) would round a token's k bf16 partial
sums in whatever order they land, and greedy decoding then drifts between
two serves of one prompt.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .layers import _ACTS, MLP, _normal, _param, dense_init, mlp_apply


class MoE(nn.Module):
    """``router`` float32 ``[d, E]``; ``wgate`` / ``wup`` ``[E, d, ff]``,
    ``wdown`` ``[E, ff, d]`` bf16; ``shared`` (an :class:`~.layers.MLP`
    of width ``moe_d_ff * num_shared_experts``) where the config has
    shared experts."""

    def __init__(self, router, wgate, wup, wdown, shared: Optional[MLP]):
        super().__init__()
        self.router = _param(router)
        self.wgate, self.wup, self.wdown = (_param(wgate), _param(wup),
                                            _param(wdown))
        self.shared = shared


def moe_init(gen, cfg, dtype=torch.bfloat16, device=None) -> MoE:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    scale = 1.0 / np.sqrt(d)
    router = _normal(gen, (d, E), device) * scale
    wgate = (_normal(gen, (E, d, ff), device) * scale).to(dtype)
    wup = (_normal(gen, (E, d, ff), device) * scale).to(dtype)
    wdown = (_normal(gen, (E, ff, d), device) / np.sqrt(ff)).to(dtype)
    shared = None
    if cfg.num_shared_experts:
        sff = cfg.moe_d_ff * cfg.num_shared_experts
        kw = dict(dtype=dtype, device=device)
        shared = MLP(dense_init(gen, d, sff, **kw), dense_init(gen, sff, d, **kw),
                     dense_init(gen, d, sff, **kw))
    return MoE(router, wgate, wup, wdown, shared)


class Dispatch(NamedTuple):
    """One batch's routing, in the sorted (by expert) assignment order."""
    cap: int                 # slots an expert
    order: torch.Tensor      # int64[T*k]: flat assignment of each position
    token: torch.Tensor      # int64[T*k]: its token (t_s)
    weight: torch.Tensor     # float32[T*k]: its routing weight
    kept: torch.Tensor       # bool[T*k]: within its expert's capacity
    slot: torch.Tensor       # int64[T*k]: e * cap + rank, E * cap if dropped


def top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(router: torch.Tensor, cfg, tokens: torch.Tensor, *,
                 capacity_factor: float = 1.25) -> Dispatch:
    """Route ``tokens`` [T, d]: float32 logits against ``router``, top-k
    (softmax over the chosen logits, or sigmoid scores normalized over the
    chosen ones), then the stable sort by expert and each assignment's
    rank within its expert."""
    T = tokens.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = tokens.float() @ router                            # [T, E]
    if cfg.router_fn == "sigmoid":                              # deepseek
        vals, idx = top_k(torch.sigmoid(logits), k)
        weights = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    else:                                                       # mixtral
        vals, idx = top_k(logits, k)
        weights = torch.softmax(vals, dim=-1)
    # Slots an expert; the floor min(T, 8) keeps decode-sized batches
    # dropless, so decode agrees with the full forward.
    cap = max(int(np.ceil(T * k / E * capacity_factor)), min(T, 8))
    e_flat = idx.reshape(-1)
    t_flat = torch.arange(T, device=tokens.device).repeat_interleave(k)
    e_s, order = torch.sort(e_flat, stable=True)
    first = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(T * k, device=tokens.device) - first
    kept = rank < cap
    slot = torch.where(kept, e_s * cap + rank, torch.full_like(e_s, E * cap))
    return Dispatch(cap, order, t_flat[order], weights.reshape(-1)[order],
                    kept, slot)


def moe_apply(p: MoE, cfg, x, *, capacity_factor: float = 1.25):
    """x: [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    E, k, T = cfg.num_experts, cfg.experts_per_token, B * S
    tokens = x.reshape(T, d)
    r = moe_dispatch(p.router, cfg, tokens, capacity_factor=capacity_factor)
    cap = r.cap

    # Pack: one row more than the slots, the dropped assignments' sink.
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[r.slot] = tokens[r.token]
    buf = buf[:E * cap].reshape(E, cap, d)

    act = _ACTS[cfg.act]
    h = act(torch.einsum("ecd,edf->ecf", buf, p.wgate)) * torch.einsum(
        "ecd,edf->ecf", buf, p.wup)
    y = torch.einsum("ecf,efd->ecd", h, p.wdown).reshape(E * cap, d)

    # Combine: each kept assignment's output times its weight (0 for a
    # dropped one), added into its token's row in x's dtype, a token's k
    # contributions in ascending expert order.
    per_assign = y[torch.clamp_max(r.slot, E * cap - 1)]
    per_assign = torch.where(r.kept[:, None], per_assign,
                             torch.zeros_like(per_assign))
    contrib = per_assign * r.weight[:, None].to(per_assign.dtype)
    # A stable sort by token keeps each token's k in the expert order.
    by_token = torch.sort(r.token, stable=True).indices
    parts = contrib[by_token].reshape(T, k, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + parts[:, j]

    if p.shared is not None:
        out = out + mlp_apply(p.shared, tokens, act=cfg.act)
    return out.reshape(B, S, d)
