"""Mamba-2 (SSD — state-space duality) block, chunked-parallel form.

Port of ``repro.models.ssm`` (the minimal SSD reference of Dao & Gu,
arXiv:2405.21060): scalar per-head decay ``a``, shared B/C projections,
a short causal depthwise conv on the (x, B, C) stream, and the chunked
prefill:

  1. intra-chunk (quadratic in the chunk length L, "attention-like"):
     ``Y_diag = (C Bᵀ ⊙ decay) X``;
  2. the incoming state's contribution ``Y_off = C h_prev ⊙ decay_out``;
  3. the state update, a linear recurrence over the chunks.

The JAX package scans the chunks with ``lax.scan``; here a Python loop
runs them (a handful a prompt: 4 at 1024 tokens), so one chunk's
``[B, H, L, L]`` decay matrix is live at a time. Chunk length: the
largest divisor of S not above ``cfg.ssm_chunk``, as JAX's. Decode is
the O(1) recurrent step on the float32 ``[B, H, P, N]`` state. JAX's
roundings are kept: each chunk's output rounded to bf16, the ``D`` skip
term rounded to bf16 before it is added, and the depthwise conv's
products and sums in the activations' dtype. No Pallas kernel computes
any of this in the JAX package (the scan is an XLA op), so it is torch
ops here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Dense, RMSNorm, _normal, _param, dense_apply,
                     dense_init, rmsnorm_apply, rmsnorm_init)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # [B, conv_w - 1, conv_dim] bf16 rolling conv window
    state: torch.Tensor   # [B, H, P, N] float32       SSM state


class SSM(nn.Module):
    """Parameters of one Mamba-2 mixer: ``in_proj`` (fused [z, x, B, C,
    dt]), the conv's ``conv_w`` [W, conv_dim] and ``conv_b``, float32
    ``A_log`` / ``dt_bias`` / ``D`` [H], the gated ``norm`` and
    ``out_proj``."""

    def __init__(self, in_proj: Dense, conv_w, conv_b, A_log, dt_bias, D,
                 norm: RMSNorm, out_proj: Dense):
        super().__init__()
        self.in_proj, self.norm, self.out_proj = in_proj, norm, out_proj
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.A_log, self.dt_bias, self.D = (_param(A_log), _param(dt_bias),
                                            _param(D))


def _segsum(x):
    """log-space segment sums: out[..., i, j] = sum_{j<k<=i} x[..., k]."""
    L = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    ii = torch.arange(L, device=x.device)
    return diff.masked_fill(ii[:, None] < ii[None, :], float("-inf"))


def ssm_init(gen, cfg, dtype=torch.bfloat16, device=None) -> SSM:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H, N = cfg.ssm_heads, cfg.ssm_state
    conv_dim = d_in + 2 * N
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return SSM(
        dense_init(gen, d, 2 * d_in + 2 * N + H, **kw),
        (_normal(gen, (cfg.conv1d_width, conv_dim), device) * 0.2).to(dtype),
        torch.zeros((conv_dim,), **kw),
        torch.zeros((H,), **f32),                     # a = -exp(A_log)
        torch.zeros((H,), **f32),
        torch.ones((H,), **f32),
        rmsnorm_init(d_in, device),
        dense_init(gen, d_in, d, **kw))


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width W: xBC [B, S, C]; each product and
    each partial sum in xBC's dtype, in JAX's order."""
    W, S = w.shape[0], xBC.shape[1]
    pads = F.pad(xBC, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pads[:, i:i + S] * w[i]
    return F.silu(out + b)


def _chunk_step(h, xh, Bc, Cc, dt, dA):
    """One chunk of the SSD prefill (JAX's ``chunk_step``): h [B, H, P, N]
    float32; xh [B, L, H, P], Bc / Cc [B, L, N] (bf16), dt / dA [B, L, H]
    float32. Returns (the state after the chunk, y [B, L, H, P] bf16)."""
    xh, Bc, Cc = xh.float(), Bc.float(), Cc.float()
    # 1. intra-chunk (quadratic in L)
    Lmat = torch.exp(_segsum(dA.transpose(1, 2)))              # [B,H,L,L]
    scores = torch.einsum("bln,bmn->blm", Cc, Bc)              # [B,L,L]
    y = torch.einsum("bhlm,bmhp->blhp", Lmat * scores[:, None],
                     xh * dt[..., None])
    # 2. contribution of the incoming state
    decay_out = torch.exp(torch.cumsum(dA, dim=1))             # [B,L,H]
    y = y + torch.einsum("bln,bhpn->blhp", Cc, h) * decay_out[..., None]
    # 3. state update
    decay_states = torch.exp(
        torch.flip(torch.cumsum(torch.flip(dA, (1,)), dim=1), (1,)) - dA)
    states = torch.einsum("blh,bln,blhp->bhpn", decay_states * dt, Bc, xh)
    chunk_decay = torch.exp(torch.sum(dA, dim=1))              # [B,H]
    return h * chunk_decay[..., None, None] + states, y.to(torch.bfloat16)


def ssm_apply(p: SSM, cfg, x, *, cache: Optional[SSMCache] = None,
              update_cache: bool = False):
    """x: [B, S, d]. Returns (y, new_cache | None). S == 1 with a cache is
    the decode step; it returns a new cache and leaves ``cache`` as it
    was."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    L = min(cfg.ssm_chunk, S)
    while S % L:  # largest divisor of S not exceeding the chunk size
        L -= 1

    zxbcdt = dense_apply(p.in_proj, x)
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)                    # [B,S,H]
    a = -torch.exp(p.A_log)                                    # [H]

    xBC = torch.cat([xs, Bc, Cc], dim=-1)
    new_cache = None
    if cache is not None and S == 1:
        # decode: conv over the rolling window, then one recurrent step
        window = torch.cat([cache.conv, xBC], dim=1)           # [B, W, C]
        conv = F.silu(torch.sum(window * p.conv_w, dim=1, keepdim=True)
                      + p.conv_b)
        xs_c, B_c, C_c = torch.split(conv, [d_in, N, N], dim=-1)
        xh = xs_c.reshape(B, H, P)                             # [B,H,P]
        dA = torch.exp(dt[:, 0] * a)                           # [B,H]
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], B_c[:, 0].float(),
                           xh.float())
        state = cache.state * dA[..., None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", state, C_c[:, 0].float())
        y = y + p.D[None, :, None] * xh.float()
        y = y.reshape(B, 1, d_in)
        new_cache = SSMCache(window[:, 1:], state)
    else:
        conv = _causal_conv(xBC, p.conv_w, p.conv_b)
        xs_c, B_c, C_c = torch.split(conv, [d_in, N, N], dim=-1)
        xh = xs_c.reshape(B, S, H, P)
        dA = dt * a                                            # [B,S,H]
        h = (cache.state if cache is not None else
             torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
        ys = []
        for c0 in range(0, S, L):
            c = slice(c0, c0 + L)
            h, y = _chunk_step(h, xh[:, c], B_c[:, c], C_c[:, c], dt[:, c],
                               dA[:, c])
            ys.append(y)
        Y = torch.cat(ys, dim=1)                               # [B,S,H,P]
        y = (Y + (p.D[:, None] * xh.float()).to(torch.bfloat16)
             ).reshape(B, S, d_in)
        if update_cache:
            W = cfg.conv1d_width
            keep = (xBC[:, -(W - 1):] if S >= W - 1 else
                    F.pad(xBC, (0, 0, W - 1 - S, 0)))
            new_cache = SSMCache(keep.to(torch.bfloat16), h)

    # gated RMSNorm + output projection (Mamba-2 block epilogue)
    y = rmsnorm_apply(p.norm, y.to(x.dtype) * F.silu(z))
    return dense_apply(p.out_proj, y), new_cache
