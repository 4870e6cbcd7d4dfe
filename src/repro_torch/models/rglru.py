"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of ``repro.models.rglru``. Recurrence (per channel):

    r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          # input gate
    a_t = a ** (c * r_t),  a = sigmoid(Lambda)  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full block is Griffin's: a (gelu gate) branch times a (conv1d ->
RG-LRU) branch, merged by an output projection. Prefill runs the linear
recurrence ``h_t = a_t h_{t-1} + b_t`` as a log-depth doubling scan of
torch ops over the ``(a, b)`` pairs (:func:`_rglru_scan`; JAX's
``lax.associative_scan``, an XLA op: no Pallas kernel computes it), not
a loop over the sequence; decode is one step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _normal, _param, dense_apply, dense_init

_C = 8.0


class RGLRUCache(NamedTuple):
    h: torch.Tensor      # [B, W] float32 recurrent state
    conv: torch.Tensor   # [B, conv_w - 1, W] bf16 conv window


class RGLRU(nn.Module):
    """Parameters of one RG-LRU mixer: ``gate_proj``, ``x_proj``, the
    conv's ``conv_w`` [W_conv, W] and ``conv_b``, the gates ``wa`` /
    ``wx`` (with biases), float32 ``lambda`` [W] and ``out_proj``.
    ``lambda`` is a keyword in Python: read it as ``p.lam``."""

    def __init__(self, gate_proj: Dense, x_proj: Dense, conv_w, conv_b,
                 wa: Dense, wx: Dense, lam, out_proj: Dense):
        super().__init__()
        self.gate_proj, self.x_proj = gate_proj, x_proj
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.wa, self.wx = wa, wx
        # The JAX tree's name, so the two packages' parameters carry
        # across unchanged (``convert.model_params_from_reference``).
        self.register_parameter("lambda", _param(lam))
        self.out_proj = out_proj

    @property
    def lam(self) -> torch.Tensor:
        return getattr(self, "lambda")


def rglru_init(gen, cfg, dtype=torch.bfloat16, device=None) -> RGLRU:
    d = cfg.d_model
    W = cfg.rglru_width or d
    kw = dict(dtype=dtype, device=device)
    # Lambda drawn so that a is in (0.9, 0.999) (Griffin appendix)
    lam = 2.2 + (6.9 - 2.2) * torch.rand(
        (W,), generator=gen, dtype=torch.float32, device=device)
    return RGLRU(dense_init(gen, d, W, **kw), dense_init(gen, d, W, **kw),
                 (_normal(gen, (cfg.conv1d_width, W), device) * 0.2).to(dtype),
                 torch.zeros((W,), **kw),
                 dense_init(gen, W, W, bias=True, **kw),
                 dense_init(gen, W, W, bias=True, **kw),
                 lam, dense_init(gen, W, d, **kw))


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_0 = 0 along dim 1 of [B, S, W]
    float32 tensors: Hillis-Steele doubling, ceil(log2 S) rounds of torch
    ops; round k composes each pair with the one 2^k steps before it.
    Returns h [B, S, W]."""
    S = a.shape[1]
    step = 1
    while step < S:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]], 1)
        a = torch.cat([a[:, :step], a[:, step:] * a_prev], 1)
        step *= 2
    return b


def _rglru_scan(x, a_gate, i_gate, lam, h0):
    """x, gates: [B, S, W] float32; h0: [B, W]. Returns (y [B, S, W],
    h_last). The products are composed in another order than JAX's
    ``associative_scan`` (ROADMAP queue C): float32 rounding apart."""
    log_a_max = torch.log(torch.sigmoid(lam))              # [W], < 0
    a = torch.exp(_C * a_gate * log_a_max)                 # [B,S,W]
    gated_x = i_gate * x
    b = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * gated_x
    # fold h0 into the first step: h_1 = a_1 h_0 + b_1
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    hh = _linear_scan(a, b)
    return hh, hh[:, -1]


def rglru_apply(p: RGLRU, cfg, x, *, cache: Optional[RGLRUCache] = None,
                update_cache: bool = False):
    """x: [B, S, d] -> (y, cache'). S == 1 with a cache is the decode step;
    it returns a new cache and leaves ``cache`` as it was."""
    B, S, d = x.shape
    W = cfg.rglru_width or d
    Wc = cfg.conv1d_width

    gate = F.gelu(dense_apply(p.gate_proj, x), approximate="tanh")  # branch 1
    xb = dense_apply(p.x_proj, x)                                   # branch 2

    new_cache = None
    if cache is not None and S == 1:
        window = torch.cat([cache.conv, xb], dim=1)             # [B, Wc, W]
        conv = torch.sum(window * p.conv_w, dim=1, keepdim=True) + p.conv_b
        cf = conv.float()
        r = torch.sigmoid(dense_apply(p.wa, conv).float())
        i = torch.sigmoid(dense_apply(p.wx, conv).float())
        a = torch.exp(_C * r * torch.log(torch.sigmoid(p.lam)))
        h = a[:, 0] * cache.h + (
            torch.sqrt(torch.clamp_min(1 - torch.square(a[:, 0]), 1e-12))
            * (i[:, 0] * cf[:, 0]))
        y = h[:, None]
        new_cache = RGLRUCache(h, window[:, 1:])
    else:
        # each product and partial sum in xb's dtype, in JAX's order
        pads = F.pad(xb, (0, 0, Wc - 1, 0))
        conv = 0
        for j in range(Wc):
            conv = conv + pads[:, j:j + S] * p.conv_w[j]
        conv = conv + p.conv_b
        r = torch.sigmoid(dense_apply(p.wa, conv).float())
        i = torch.sigmoid(dense_apply(p.wx, conv).float())
        h0 = (cache.h if cache is not None else
              torch.zeros((B, W), dtype=torch.float32, device=x.device))
        y, h_last = _rglru_scan(conv.float(), r, i, p.lam, h0)
        if update_cache:
            keep = (xb[:, -(Wc - 1):] if S >= Wc - 1 else
                    F.pad(xb, (0, 0, Wc - 1 - S, 0)))
            new_cache = RGLRUCache(h_last, keep.to(torch.bfloat16))

    out = y.to(x.dtype) * gate
    return dense_apply(p.out_proj, out), new_cache
