"""Flash attention forward: the CUDA kernel's binding and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces ``repro/kernels/
flash_attention.py: flash_attention_pallas``. :func:`flash_attention_plain`
computes the same function with torch ops: the online-softmax loop of
``repro/models/attention.py: flash_attention`` in the kernel's layout.
``kernels.ops.flash_attention`` picks one by the device the tensors live
on; ``models.attention.flash_attention`` reaches both through it.

Layout: q ``[BK, g, Sq, D]``, k ``[BK, Sk, D]``, v ``[BK, Sk, Dv]`` with
``BK = B * KVH`` (query head ``h`` of KV head ``h // g``); the result is
``[BK, g, Sq, Dv]`` in float32, the accumulator's type, or rounded once
to bfloat16. (The Pallas kernel casts its result to q's dtype; the JAX
model path returns float32, and its attention layer casts that to the
activations' dtype at once, so the port's layer asks for that dtype.)
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Head sizes of the tensor-core variant (bf16, D == Dv); the FMA variant
# takes D and Dv up to FMA_DMAX.
MMA_HEAD_DIMS = (32, 64, 128)
FMA_DMAX = 128


def _softcap(s: torch.Tensor, cap):
    return cap * torch.tanh(s / cap) if cap else s


def key_range(sk: int, qp_first: int, qp_last: int, *, causal: bool,
              window) -> tuple:
    """The keys ``[lo, hi)`` any query position in ``[qp_first, qp_last]``
    may see: the loop bounds that skip fully masked tiles."""
    lo, hi = 0, sk
    if causal:
        hi = min(hi, qp_last + 1)
    if window is not None:
        lo = max(lo, qp_first - window + 1)
    return lo, hi


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                          q_offset=0, attn_softcap=None, chunk_q=512,
                          chunk_k=1024) -> torch.Tensor:
    """Online-softmax attention in float32, ``chunk_q`` query rows by
    ``chunk_k`` keys at a time; chunks the mask hides entirely are skipped
    (they would leave the accumulators as they are)."""
    BK, g, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    chunk_q, chunk_k = max(1, min(chunk_q, Sq)), max(1, min(chunk_k, Sk))
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((BK, g, Sq, Dv), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq)
        qpos = q_offset + torch.arange(q0, q1, device=dev)
        acc = torch.zeros((BK, g, q1 - q0, Dv), dtype=torch.float32, device=dev)
        m = torch.full((BK, g, q1 - q0), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        lo, hi = key_range(Sk, q_offset + q0, q_offset + q1 - 1,
                           causal=causal, window=window)
        for k0 in range((lo // chunk_k) * chunk_k, hi, chunk_k):
            k1 = min(k0 + chunk_k, Sk)
            kpos = torch.arange(k0, k1, device=dev)
            s = torch.einsum("bgqd,bcd->bgqc", qf[:, :, q0:q1],
                             kf[:, k0:k1]) * scale
            s = _softcap(s, attn_softcap)
            allowed = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                allowed &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                allowed &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(allowed, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.clamp_min(m_new, NEG_INF * 1e-10)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.clamp_max(m - m_new, 0.0))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bgqc,bcd->bgqd", p,
                                                       vf[:, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out


def flash_variant(dtype: torch.dtype, d: int, dv: int):
    """The kernel variant for these inputs: ``"mma"`` (tensor cores),
    ``"fma"``, or None where no variant takes them."""
    if dtype == torch.bfloat16 and d == dv and d in MMA_HEAD_DIMS:
        return "mma"
    if d <= FMA_DMAX and dv <= FMA_DMAX:
        return "fma"
    return None


def flash_attention_launch(q, k, v, out, *, causal: bool, window,
                           scale: float, q_offset: int, variant: str) -> None:
    """Launch the kernel on the current stream (arguments already checked:
    contiguous, one dtype, 16-byte aligned; ``out`` float32 or bfloat16
    ``[BK, g, Sq, Dv]``)."""
    BK, g, Sq, D = q.shape
    rc = build.load("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BK * g, g,
        Sq, k.shape[1], D, v.shape[-1], DTYPES[q.dtype], DTYPES[out.dtype],
        int(variant == "mma"), int(bool(causal)),
        -1 if window is None else int(window), int(q_offset),
        float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
