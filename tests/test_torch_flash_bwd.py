"""Kernel #11's backward (its plain version, the CPU route) vs the JAX
package's gradient of its attention.

On five small shapes (S <= 32, D <= 32), inputs made from a seed with
numpy: causal GQA (g = 2), a sliding window with a query offset, the
attention softcap (scores large enough for the cap to bend them),
non-causal with Sq != Sk, and D != Dv (MLA's shape, scaled down):

* ``kernels.ops.flash_attention_bwd`` on the CPU (the plain backward,
  given the plain forward's output and row log-sum-exp) against
  ``jax.vjp`` of ``repro.models.attention.flash_attention``, float32, at
  1e-4 of each gradient's largest value (the same sums in other orders);
* the same against torch autograd through ``flash_attention_plain``'s own
  ops, at 1e-5 (one framework, other orders);
* ``kernels.ops.flash_attention_bshd`` under autograd (the
  ``FlashAttentionFunction``): its gradients equal ``flash_attention_bwd``
  on the forward's own output and log-sum-exp bit for bit, in float32 and
  in bf16 (gradients in the inputs' dtype), the forward unchanged;
* the row log-sum-exp against ``torch.logsumexp`` of the masked, capped,
  scaled scores, and the argument checks.

The backward kernel itself is held to this plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.kernels import ops as K
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 from_kernel_layout,
                                                 to_kernel_layout)

torch.set_num_threads(1)

CASES = {
    # (B, Sq, Sk, H, KVH, D, Dv, causal, window, q_offset, cap, qk_scale)
    "causal_gqa": (2, 24, 24, 4, 2, 16, 16, True, None, 0, None, 1.0),
    "window": (1, 20, 28, 2, 1, 16, 16, True, 8, 8, None, 1.0),
    "softcap": (2, 20, 20, 2, 2, 32, 32, True, None, 0, 5.0, 3.0),
    "noncausal": (2, 17, 29, 3, 3, 8, 8, False, None, 0, None, 1.0),
    "d_ne_dv": (1, 24, 24, 4, 4, 24, 16, True, None, 0, None, 1.0),
}
CHUNKS = dict(chunk_q=8, chunk_k=8)


def _inputs(case):
    B, Sq, Sk, H, KVH, D, Dv, causal, window, q_offset, cap, s = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = (rng.normal(size=(B, Sq, H, D)) * s).astype(np.float32)
    k = (rng.normal(size=(B, Sk, KVH, D)) * s).astype(np.float32)
    v = rng.normal(size=(B, Sk, KVH, Dv)).astype(np.float32)
    dout = rng.normal(size=(B, Sq, H, Dv)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              attn_softcap=cap)
    return q, k, v, dout, kw


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """JAX's (out, dq, dk, dv) of ``case``: one jitted vjp a case."""
    q, k, v, dout, kw = _inputs(case)

    def fwd(q, k, v):
        return RA.flash_attention(q, k, v, **kw, **CHUNKS)

    def run(q, k, v, dout):
        out, vjp = jax.vjp(fwd, q, k, v)
        return (out,) + vjp(dout)

    return tuple(np.asarray(x) for x in jax.jit(run)(q, k, v, dout))


def _port_grads(case, dtype=torch.float32):
    q, k, v, dout, kw = _inputs(case)
    q, k, v, dout = (torch.from_numpy(x).to(dtype) for x in (q, k, v, dout))
    out, lse = K.flash_attention_bshd(q, k, v, return_lse=True, **kw,
                                      **CHUNKS)
    return (out,) + K.flash_attention_bwd(q, k, v, out, dout, lse, **kw,
                                          **CHUNKS)


def _close(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad(case):
    want = _jax_grads(case)
    got = _port_grads(case)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        _close(g.numpy(), w, 1e-4, f"{case} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_torch_autograd(case):
    q, k, v, dout, kw = _inputs(case)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = from_kernel_layout(flash_attention_plain(
        *to_kernel_layout(q, k, v), **kw, **CHUNKS), q.shape[0])
    want = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dout))
    got = _port_grads(case)[1:]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w.numpy(), 1e-5, f"{case} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["causal_gqa", "softcap", "d_ne_dv"])
def test_autograd_function(case, dtype):
    q, k, v, dout, kw = _inputs(case)
    q, k, v, dout = (torch.from_numpy(x).to(dtype) for x in (q, k, v, dout))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = K.flash_attention_bshd(*leaves, out_dtype=dtype, **kw, **CHUNKS)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, dout)
    ref_out, lse = K.flash_attention_bshd(q, k, v, out_dtype=dtype,
                                          return_lse=True, **kw, **CHUNKS)
    want = K.flash_attention_bwd(q, k, v, ref_out, dout, lse, **kw, **CHUNKS)
    assert torch.equal(out.detach(), ref_out)
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.equal(g, w)
    with torch.no_grad():
        assert K.flash_attention_bshd(*leaves, out_dtype=dtype, **kw,
                                      **CHUNKS).grad_fn is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_is_the_rows_logsumexp(case):
    q, k, v, _, kw = _inputs(case)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = K.flash_attention_bshd(q, k, v, return_lse=True, **kw, **CHUNKS)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qk, kk, _ = to_kernel_layout(q, k, v)
    s = torch.einsum("bgqd,bcd->bgqc", qk, kk) / np.sqrt(D)
    if kw["attn_softcap"]:
        s = kw["attn_softcap"] * torch.tanh(s / kw["attn_softcap"])
    qpos = kw["q_offset"] + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    allowed = torch.ones((Sq, Sk), dtype=torch.bool)
    if kw["causal"]:
        allowed &= kpos <= qpos
    if kw["window"] is not None:
        allowed &= qpos - kpos < kw["window"]
    want = torch.logsumexp(s.masked_fill(~allowed, -torch.inf), dim=-1)
    assert lse.shape == (B * KVH, H // KVH, Sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_backward_argument_checks():
    q, k, v, dout, kw = _inputs("causal_gqa")
    q, k, v, dout = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = K.flash_attention_bshd(q, k, v, return_lse=True, **kw)
    with pytest.raises(ValueError, match="lse"):
        K.flash_attention_bwd(q, k, v, out, dout, lse[:, :, :-1], **kw)
    with pytest.raises(ValueError, match="lse"):
        K.flash_attention_bwd(q, k, v, out, dout, lse.double(), **kw)
    with pytest.raises(ValueError, match="dout"):
        K.flash_attention_bwd(q, k, v, out, dout[:, :-1], lse, **kw)
