"""AdamW with optional int8-quantized moments + LR schedules.

Port of ``repro.train.optimizer``. Parameters are a ``Model`` (or any
``nn.Module``) or a ``{name: tensor}`` dict; the moments are
``{name: tensor}`` dicts keyed by parameter name (``named_parameters``
order). The JAX package returns new arrays; :func:`adamw_update` updates
the parameters and moments in place, so a step holds one copy of the
state (at qwen1_5_4b's width the fp32 moments alone are 28.5 GB), and
returns them. The int8 path (blockwise-scaled, a la 8-bit Adam) stores m
and v in 1 byte a parameter: blockwise symmetric (m) / blockwise max (v,
kept in the sqrt domain) over flattened 256-element blocks, padded to a
multiple of 512 blocks, as in the JAX package. ``torch.round`` rounds
half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import nn

_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_state: bool = False   # int8 m/v (671B config)
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, float32 (the JAX
    package's arithmetic, op for op)."""
    step = _f32(step)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * t))
    return cfg.lr * warm * cos


# --- blockwise int8 quantization -------------------------------------------

class QTensor(NamedTuple):
    q: torch.Tensor           # int8[nblocks, _BLOCK]  (nblocks % 512 == 0)
    scale: torch.Tensor       # float32[nblocks]
    shape: Tuple[int, ...]    # the dequantized shape


def _quantize(x: torch.Tensor) -> QTensor:
    shape = tuple(x.shape)
    flat = x.reshape(-1)
    # pad so nblocks is a multiple of 512 (shardable over any production
    # mesh axis combination, as in the JAX package)
    pad = (-flat.shape[0]) % (_BLOCK * 512)
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale[:, None], 1e-12)
                    ).to(torch.int8)
    return QTensor(q, scale, shape)


def _dequantize(t: QTensor) -> torch.Tensor:
    blocks = t.q.to(torch.float32) * t.scale[:, None]
    n = math.prod(t.shape)
    return blocks.reshape(-1)[:n].reshape(t.shape)


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32[]
    m: Dict[str, Any]    # name -> float32 tensor or QTensor
    v: Dict[str, Any]


def named_params(params) -> Dict[str, torch.Tensor]:
    """A module's parameters by name (or a ``{name: tensor}`` dict as it
    is)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments beside each parameter (on its device). v is stored in
    the sqrt domain when quantized: v = q^2. Squaring halves the dynamic
    range the int8 grid must span: a linear-domain int8 flushes small v to
    0 and the eps-divided update explodes (the 8-bit Adam lesson)."""

    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if cfg.quantize_state else z

    named = named_params(params)
    device = next(iter(named.values())).device if named else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      {n: zero_like(p) for n, p in named.items()},
                      {n: zero_like(p) for n, p in named.items()})


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (leaves in
    the dict's order)."""
    sq = None
    for g in tree.values():
        s = torch.sum(torch.square(g.to(torch.float32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq if sq is not None else torch.zeros(()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor],
                 state: AdamWState, params):
    """-> (params, new_state, metrics). The parameters and float32 moments
    are updated in place; ``grads`` maps every parameter name to its
    gradient (any float dtype). The update is the JAX package's: the
    gradient clipped by the global norm, bias-corrected moments, decoupled
    weight decay on matrices only (``ndim > 1``), the new parameter
    rounded once to its dtype."""
    named = named_params(params)
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm({n: grads[n] for n in named})
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, stepf.device), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, stepf.device), stepf)
    new_m, new_v = {}, {}
    for name, p in named.items():
        g = grads[name].to(torch.float32) * clip
        m, v = state.m[name], state.v[name]
        quant = isinstance(m, QTensor)
        mf = _dequantize(m) if quant else m
        vf = torch.square(_dequantize(v)) if quant else v
        mf.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        vf.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if p.ndim > 1:   # decoupled weight decay on matrices only
            delta += cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        if quant:
            new_m[name], new_v[name] = _quantize(mf), _quantize(torch.sqrt(vf))
        else:
            new_m[name], new_v[name] = mf, vf
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, new_m, new_v), metrics
