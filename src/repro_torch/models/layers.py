"""Shared model layers: norms, GLU MLPs, embeddings, RoPE, softcap.

Port of ``repro.models.layers``. ``<layer>_init(gen, ..., device)`` builds
an ``nn.Module`` holding the layer's parameters (where the JAX package
builds a dict), drawn from the explicit ``torch.Generator`` ``gen`` on
``device``; ``<layer>_apply(p, x, ...)`` computes the layer. Weights are bf16 and norm
scales fp32, as in the JAX package; dense weights are kept ``[in, out]``
and applied as ``x @ w``, so the two packages' parameters carry across
unchanged (``repro_torch.convert.model_params_from_reference``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Rows of the tied embedding table turned to float32 at a time by
# :func:`embed_logits`: a 168 MB slab at d_model 2560, where the whole
# table of a 151936-row vocabulary would be 1.56 GB.
LOGITS_CHUNK = 16384


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` ``[in, out]``."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


def dense_init(gen, in_dim, out_dim, *, dtype=torch.bfloat16, bias=False,
               scale=None, device=None) -> Dense:
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    w = (_normal(gen, (in_dim, out_dim), device) * scale).to(dtype)
    b = torch.zeros((out_dim,), dtype=dtype, device=device) if bias else None
    return Dense(w, b)


def dense_apply(p: Dense, x):
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


class RMSNorm(nn.Module):
    """``(1 + scale) * x / rms(x)``, computed in float32."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


def rmsnorm_init(dim, device=None) -> RMSNorm:
    return RMSNorm(torch.zeros((dim,), dtype=torch.float32, device=device))


def rmsnorm_apply(p: RMSNorm, x, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p.scale)
    return y.to(dt)


def softcap(x, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


class MLP(nn.Module):
    """Gated (``gate`` set) or plain two-layer MLP."""

    def __init__(self, up: Dense, down: Dense, gate: Optional[Dense]):
        super().__init__()
        self.up, self.down, self.gate = up, down, gate


def mlp_init(gen, d_model, d_ff, *, act="silu", gated=True,
             dtype=torch.bfloat16, device=None) -> MLP:
    up = dense_init(gen, d_model, d_ff, dtype=dtype, device=device)
    down = dense_init(gen, d_ff, d_model, dtype=dtype, device=device)
    gate = (dense_init(gen, d_model, d_ff, dtype=dtype, device=device)
            if gated else None)
    return MLP(up, down, gate)


def mlp_apply(p: MLP, x, *, act="silu"):
    up = dense_apply(p.up, x)
    if p.gate is not None:
        up = _ACTS[act](dense_apply(p.gate, x)) * up
    else:
        up = _ACTS[act](up)
    return dense_apply(p.down, up)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """Token table ``[vocab, d_model]``; also the tied readout."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)


def embed_init(gen, vocab, d_model, dtype=torch.bfloat16, device=None) -> Embed:
    return Embed((_normal(gen, (vocab, d_model), device) * 1.0).to(dtype))


def embed_apply(p: Embed, tokens):
    return p.table[tokens.long()]


def embed_logits(p: Embed, x, *, scale=None):
    """Tied-readout logits ``x.f32 @ table.f32^T`` (fp32, as the JAX
    package computes them). The table is turned to float32
    :data:`LOGITS_CHUNK` rows at a time, so no float32 copy of the whole
    table is ever made; each slab's product is a plain ``torch.matmul``."""
    xf = x.float()
    table = p.table
    logits = torch.empty(x.shape[:-1] + (table.shape[0],), dtype=torch.float32,
                         device=x.device)
    for v0 in range(0, table.shape[0], LOGITS_CHUNK):
        rows = table[v0:v0 + LOGITS_CHUNK].float()
        logits[..., v0:v0 + rows.shape[0]] = xf @ rows.T
    if scale is not None:
        logits = logits * scale
    return logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. Rotates the
    split halves ``(x[:D/2], x[D/2:])``, not interleaved pairs."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(x.device)
    ang = positions[..., None].float() * freqs              # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
