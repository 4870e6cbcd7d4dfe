"""Gradient compression for cross-pod reduction.

Port of ``repro.train.grad_compression``: blockwise int8 with error
feedback (the quantization residual is carried into the next step,
keeping the accumulated update unbiased). Gradients, residuals and
payloads are ``{name: tensor}`` dicts (the JAX package's pytrees).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the
payloads are the JAX package's bit for bit on the same inputs.

Usage (train loop):
    residual = zero_residual(grads)
    q, residual = compress(grads, residual)     # int8 payload (+ scales)
    # ... all-reduce q across pods ...
    grads = decompress(q, grads)

The compressed payload is 4x smaller than fp32 (2x vs bf16).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

_BLOCK = 256


class CompressedGrads(NamedTuple):
    q: Dict[str, torch.Tensor]        # int8 [nblocks, _BLOCK]
    scale: Dict[str, torch.Tensor]    # float32 [nblocks]


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % _BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale[:, None], 1e-12)
                    ).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n] \
        .reshape(shape)


def zero_residual(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def compress(grads: Dict[str, torch.Tensor], residual: Dict[str, torch.Tensor]
             ) -> Tuple[CompressedGrads, Dict[str, torch.Tensor]]:
    """-> (compressed, new_residual). Error feedback: the residual carries
    the quantization error into the next step."""
    qs, scales, res = {}, {}, {}
    for n, g in grads.items():
        x = g.to(torch.float32) + residual[n]
        q, scale = _quant_leaf(x)
        qs[n], scales[n] = q, scale
        res[n] = x - _dequant_leaf(q, scale, g.shape)
    return CompressedGrads(qs, scales), res


def decompress(c: CompressedGrads, grads_template: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Dequantize to float32 (the optimizer's input precision): casting
    back down to bf16 would break the error feedback's telescoping."""
    return {n: _dequant_leaf(c.q[n], c.scale[n], g.shape)
            for n, g in grads_template.items()}
