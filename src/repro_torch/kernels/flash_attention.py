"""Flash attention, forward and backward: the CUDA kernels' bindings and
their plain versions.

The forward kernel (``csrc/flash_attention.cu``) replaces ``repro/kernels/
flash_attention.py: flash_attention_pallas``. :func:`flash_attention_plain`
computes the same function with torch ops: the online-softmax loop of
``repro/models/attention.py: flash_attention`` in the kernel layout.
``kernels.ops.flash_attention`` (kernel layout) and
``kernels.ops.flash_attention_bshd`` (the model's layout) pick one by the
device the tensors live on; ``models.attention.flash_attention`` reaches
both through the second.

The backward kernel (``csrc/flash_attention_bwd.cu``) replaces no TPU
kernel: the JAX package differentiates its XLA attention scan. It takes
the forward's row log-sum-exp (:func:`flash_attention_plain` with
``return_lse``; the forward kernel writes it when given ``lse``), and
:func:`flash_attention_bwd_plain` is its plain version: the same
gradients from P recomputed chunk by chunk. ``kernels.ops``'s autograd
function joins the two.

Kernel layout: q ``[BK, g, Sq, D]``, k ``[BK, Sk, D]``, v ``[BK, Sk,
Dv]`` with ``BK = B * KVH`` (query head ``h`` of KV head ``h // g``); the
result is ``[BK, g, Sq, Dv]`` in float32, the accumulator's type, or
rounded once to bfloat16. (The Pallas kernel casts its result to q's
dtype; the JAX model path returns float32, and its attention layer casts
that to the activations' dtype at once, so the port's layer asks for that
dtype.) The ``wgmma`` variant reads both layouts in place, as strided
views ``(B, KVH, g, S, D)`` of q and out and ``(B, KVH, S, D)`` of k and v
(:func:`bshd_views`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Head sizes of the tensor-core variant (bf16, D == Dv); the FMA variant
# takes D and Dv up to FMA_DMAX, in any combination (gemma's 256, MLA's
# 192 against 128), as the Pallas kernel takes them.
WGMMA_HEAD_DIMS = (32, 64, 128)
FMA_DMAX = 256


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


def _allowed(qpos, kpos, causal, window):
    allowed = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                         device=qpos.device)
    if causal:
        allowed &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        allowed &= (qpos[:, None] - kpos[None, :]) < window
    return allowed


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                          q_offset=0, attn_softcap=None, chunk_q=512,
                          chunk_k=1024, return_lse=False):
    """Online-softmax attention in float32, ``chunk_q`` query rows by
    ``chunk_k`` keys at a time; chunks the mask hides entirely are skipped
    (they would leave the accumulators as they are). With ``return_lse``
    also each query row's log-sum-exp of its scaled (capped) scores,
    float32 ``[BK, g, Sq]``: ``max(m, -1e20) + log(max(l, 1e-30))``, the
    backward's input (a row that sees no key gets about -1e20)."""
    BK, g, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    chunk_q, chunk_k = max(1, min(chunk_q, Sq)), max(1, min(chunk_k, Sk))
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((BK, g, Sq, Dv), dtype=torch.float32, device=dev)
    lse = torch.empty((BK, g, Sq), dtype=torch.float32, device=dev)
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
            s = torch.where(_allowed(qpos, kpos, causal, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.clamp_min(m_new, NEG_INF * 1e-10)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.clamp_max(m - m_new, 0.0))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bgqc,bcd->bgqd", p,
                                                       vf[:, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
        lse[:, :, q0:q1] = (torch.clamp_min(m, NEG_INF * 1e-10)
                            + torch.log(torch.clamp_min(l, 1e-30)))
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal=True,
                              window=None, scale=None, q_offset=0,
                              attn_softcap=None, chunk_q=512,
                              chunk_k=1024) -> tuple:
    """The gradients (dq, dk, dv), float32 in q's, k's and v's kernel-layout
    shapes, of :func:`flash_attention_plain`'s function given the forward's
    ``out`` and row log-sum-exp ``lse`` and the cotangent ``dout``: chunk
    by chunk, P = exp(capped score - lse) recomputed, dS = P (dP - delta)
    with delta = rowsum(dout * out), times the softcap's derivative ``1 -
    (capped / cap)^2`` and the scale; dk and dv sum over the g query heads
    of a KV head. Masked pairs give nothing; fully masked chunks are
    skipped."""
    BK, g, Sq, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    chunk_q, chunk_k = max(1, min(chunk_q, Sq)), max(1, min(chunk_k, Sk))
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    do = dout.float()
    delta = (do * out.float()).sum(-1)                        # [BK, g, Sq]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq)
        qpos = q_offset + torch.arange(q0, q1, device=dev)
        lo, hi = key_range(Sk, q_offset + q0, q_offset + q1 - 1,
                           causal=causal, window=window)
        for k0 in range((lo // chunk_k) * chunk_k, hi, chunk_k):
            k1 = min(k0 + chunk_k, Sk)
            kpos = torch.arange(k0, k1, device=dev)
            s = torch.einsum("bgqd,bcd->bgqc", qf[:, :, q0:q1],
                             kf[:, k0:k1]) * scale
            if attn_softcap:
                t = torch.tanh(s / attn_softcap)
                s = attn_softcap * t
            allowed = _allowed(qpos, kpos, causal, window)
            p = torch.where(allowed, torch.exp(s - lse[:, :, q0:q1, None]),
                            0.0)
            dov = do[:, :, q0:q1]
            dv[:, k0:k1] += torch.einsum("bgqc,bgqd->bcd", p, dov)
            dp = torch.einsum("bgqd,bcd->bgqc", dov, vf[:, k0:k1])
            ds = p * (dp - delta[:, :, q0:q1, None])
            if attn_softcap:
                ds = ds * (1.0 - t * t)
            ds = ds * scale
            dq[:, :, q0:q1] += torch.einsum("bgqc,bcd->bgqd", ds, kf[:, k0:k1])
            dk[:, k0:k1] += torch.einsum("bgqc,bgqd->bcd", ds, qf[:, :, q0:q1])
    return dq, dk, dv


def bshd_views(q, k, v) -> tuple:
    """The model layout's q ``[B, Sq, H, D]``, k ``[B, Sk, KVH, D]`` and v
    ``[B, Sk, KVH, Dv]`` as the kernel's views, without a copy: q ``(B,
    KVH, g, Sq, D)``, k and v ``(B, KVH, Sk, D)``."""
    kvh = k.shape[2]
    return (q.unflatten(2, (kvh, q.shape[2] // kvh)).permute(0, 2, 3, 1, 4),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


def to_kernel_layout(q, k, v) -> tuple:
    """The model layout's q, k, v as contiguous kernel-layout copies."""
    return tuple(t.flatten(0, 1).contiguous() for t in bshd_views(q, k, v))


def from_kernel_layout(out, batch: int) -> torch.Tensor:
    """A kernel-layout result ``[BK, g, Sq, Dv]`` as ``[B, Sq, H, Dv]``."""
    BK, g, Sq, Dv = out.shape
    return out.reshape(batch, BK // batch, g, Sq, Dv).permute(0, 3, 1, 2, 4) \
        .reshape(batch, Sq, BK // batch * g, Dv)


def kernel_strides(t: torch.Tensor) -> list:
    """Element strides of every dimension but the innermost, outermost
    first, as the kernel's tensor maps take them: a dimension of size 1
    gets the stride it would have in a contiguous tensor (its own is never
    used, and a view may carry any)."""
    st = list(t.stride())
    for i in range(t.ndim - 2, -1, -1):
        if t.shape[i] == 1:
            st[i] = st[i + 1] * t.shape[i + 1]
    return st[:-1]


def flash_variant(dtype: torch.dtype, d: int, dv: int):
    """The kernel variant for these inputs: ``"wgmma"`` (tensor cores),
    ``"fma"``, or None where no variant takes them."""
    if dtype == torch.bfloat16 and d == dv and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    if d <= FMA_DMAX and dv <= FMA_DMAX:
        return "fma"
    return None


def flash_attention_launch(q, k, v, out, *, causal: bool, window,
                           scale: float, q_offset: int, variant: str,
                           attn_softcap=None, lse=None) -> None:
    """Launch the kernel on the current stream. q and out are ``(B, KVH,
    g, Sq, D)`` views, k and v ``(B, KVH, Sk, D)`` views (arguments already
    checked: one dtype; for ``"wgmma"`` D contiguous, strides of 16-byte
    multiples, 16-byte aligned; for ``"fma"`` the contiguous kernel layout
    with KVH folded into B); out float32 or bfloat16. ``attn_softcap``
    (None or 0: none) caps each scaled score, ``cap * tanh(s / cap)``,
    before the mask, as :func:`flash_attention_plain` does. ``lse``
    (contiguous float32 ``[B * KVH, g, Sq]``, or None) receives the rows'
    log-sum-exp, as :func:`flash_attention_plain` returns it."""
    B, KVH, g, Sq, D = q.shape

    def strides(t):
        return (ctypes.c_int64 * (t.ndim - 1))(*kernel_strides(t))

    rc = build.load("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, KVH, g,
        Sq, k.shape[2], D, v.shape[-1], strides(q), strides(k), strides(v),
        strides(out), DTYPES[q.dtype], DTYPES[out.dtype],
        int(variant == "wgmma"), int(bool(causal)),
        -1 if window is None else int(window), int(q_offset), float(scale),
        float(attn_softcap or 0.0), None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")


def flash_attention_bwd_launch(q, k, v, out, dout, lse, dq, dk, dv, *,
                               causal: bool, window, scale: float,
                               q_offset: int, attn_softcap=None) -> None:
    """Launch the backward kernel on the current stream: q, k, v (one
    dtype, float32 or bfloat16), ``out``, ``dout`` (float32) and ``lse``
    contiguous in the kernel layout, ``dq``, ``dk``, ``dv`` contiguous
    float32 of q's, k's and v's shapes (arguments already checked). The
    ``delta`` scratch (float32 ``[BK, g, Sq]``) is allocated here."""
    BK, g, Sq, D = q.shape
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    rc = build.load("flash_attention_bwd").flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), BK, g, Sq, k.shape[1], D, v.shape[-1],
        DTYPES[q.dtype], int(bool(causal)),
        -1 if window is None else int(window), int(q_offset), float(scale),
        float(attn_softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_bwd")
