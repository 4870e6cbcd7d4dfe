"""The port's flash attention (kernel #11's plain version and the model
path) vs the JAX package's.

On the five shapes of ``tests/test_flash_kernel.py`` (GQA g = 3 with
Dv != D, a window of 64, non-causal, the ragged 100 x 130, and bf16),
inputs made from a seed with numpy:

* the port's plain ``kernels.ops.flash_attention`` (CPU route) against
  ``flash_attention_pallas`` in interpret mode, in the kernel layout;
* the port's ``models.attention.flash_attention`` against
  ``repro.models.attention.flash_attention``, in the model layout;
* ``kernels.ops.flash_attention_bshd`` (the model-layout entry, on
  contiguous and strided views) against ``kernels.ops.flash_attention`` on
  the permuted contiguous tensors, bit for bit.

Tolerances are that file's: 1e-4 in float32 (the sums run in another
order) and 2e-2 in bf16 (the Pallas kernel rounds its output to bf16).
``decode_attention`` is held against the JAX package's at 1e-5 (float32
products of the same bf16 values). The kernel route's checks (dtype,
strides, alignment, a negative softcap; a softcap itself is taken by
both variants) raise before any launch, so they run here on CPU tensors;
the kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as RA
from repro_torch.kernels import ops as K
from repro_torch.models import attention as TA

torch.set_num_threads(1)

SWEEP = [
    # (B, KVH, g, Sq, Sk, D, Dv, causal, window, blk_q, blk_k, dtype)
    (2, 2, 3, 192, 256, 64, 32, True, None, 64, 64, "float32"),
    (2, 2, 3, 192, 256, 64, 32, True, 64, 64, 64, "float32"),
    (1, 4, 1, 256, 256, 128, 128, False, None, 128, 128, "float32"),
    (1, 1, 8, 100, 130, 32, 32, True, None, 64, 64, "float32"),  # ragged
    (2, 2, 2, 128, 128, 64, 64, True, None, 128, 64, "bfloat16"),
    # Head sizes past 128, which the Pallas kernel takes (gemma's 256;
    # MLA's D 192 against Dv 128), at small B, H and S.
    (1, 1, 2, 40, 48, 256, 256, True, None, 64, 64, "float32"),
    (1, 1, 2, 40, 48, 192, 128, True, None, 64, 64, "bfloat16"),
]
IDS = ["gqa3", "window64", "noncausal", "ragged", "bf16", "d256",
       "d192dv128"]


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 2e-2


@functools.lru_cache(maxsize=None)
def _inputs(i):
    """(q, k, v) in the model layout as JAX arrays of the case's dtype."""
    B, KVH, g, Sq, Sk, D, Dv, *_, dtype = SWEEP[i]
    rng = np.random.default_rng(Sq + Sk)
    dt = getattr(jnp, dtype)
    q = jnp.asarray(rng.normal(size=(B, Sq, KVH * g, D)), dt) * 0.3
    k = jnp.asarray(rng.normal(size=(B, Sk, KVH, D)), dt) * 0.3
    v = jnp.asarray(rng.normal(size=(B, Sk, KVH, Dv)), dt) * 0.3
    return q, k, v


def _torch(a):
    """A JAX array -> a CPU tensor of the same dtype and values."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _kernel_layout(q, k, v):
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    g = H // KVH
    Sk, Dv = k.shape[1], v.shape[-1]
    qk = q.reshape(B, Sq, KVH, g, D).transpose(0, 2, 3, 1, 4) \
        .reshape(B * KVH, g, Sq, D)
    kk = k.transpose(0, 2, 1, 3).reshape(B * KVH, Sk, D)
    vk = v.transpose(0, 2, 1, 3).reshape(B * KVH, Sk, Dv)
    return qk, kk, vk


@pytest.mark.parametrize("i", range(len(SWEEP)), ids=IDS)
def test_plain_kernel_matches_pallas(i):
    *_, causal, window, bq, bk, dtype = SWEEP[i]
    qk, kk, vk = _kernel_layout(*_inputs(i))
    want = flash_attention_pallas(qk, kk, vk, causal=causal, window=window,
                                  blk_q=bq, blk_k=bk)
    got = K.flash_attention(_torch(qk), _torch(kk), _torch(vk),
                            causal=causal, window=window, chunk_q=bq,
                            chunk_k=bk)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("i", range(len(SWEEP)), ids=IDS)
def test_model_flash_attention_matches_reference(i):
    *_, causal, window, _bq, _bk, dtype = SWEEP[i]
    q, k, v = _inputs(i)
    want = RA.flash_attention(q, k, v, causal=causal, window=window,
                              chunk_q=64, chunk_k=64)
    got = TA.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                             window=window, chunk_q=64, chunk_k=64)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("i", [0, 4], ids=[IDS[0], IDS[4]])
def test_out_dtype_rounds_the_float32_result_once(i):
    """``out_dtype=bfloat16`` gives the float32 result rounded, on both
    entry points; the model's attention layer asks for it, where the JAX
    layer casts the float32 result at once."""
    *_, causal, window, _bq, _bk, _dtype = SWEEP[i]
    q, k, v = (_torch(a) for a in _inputs(i))
    kq, kk, kv = (_torch(a) for a in _kernel_layout(*_inputs(i)))
    for fn, args in ((K.flash_attention, (kq, kk, kv)),
                     (TA.flash_attention, (q, k, v))):
        full = fn(*args, causal=causal, window=window)
        got = fn(*args, causal=causal, window=window,
                 out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, full.to(torch.bfloat16))
    with pytest.raises(TypeError, match="out_dtype"):
        K.flash_attention(kq, kk, kv, out_dtype=torch.float16)


def test_softcap_and_offset_on_the_cpu():
    """The plain version takes a softcap and a query offset, as the JAX
    function does (the kernel takes both too: tests/test_torch_gpu.py)."""
    q, k, v = _inputs(0)
    want = RA.flash_attention(q, k, v, causal=True, attn_softcap=5.0,
                              q_offset=64, chunk_q=64, chunk_k=64)
    got = TA.flash_attention(_torch(q), _torch(k), _torch(v), causal=True,
                             attn_softcap=5.0, q_offset=64, chunk_q=64,
                             chunk_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("window", [None, 24])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(size=(2, 1, 6, 32)), jnp.bfloat16)
    kc = jnp.asarray(rng.normal(size=(2, 40, 2, 32)), jnp.bfloat16)
    vc = jnp.asarray(rng.normal(size=(2, 40, 2, 32)), jnp.bfloat16)
    for cur in (1, 29, 40):
        want = RA.decode_attention(q, kc, vc, jnp.int32(cur), window=window)
        got = TA.decode_attention(_torch(q), _torch(kc), _torch(vc), cur,
                                  window=window)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-5)


def test_kernel_route_checks_raise_before_launch():
    qk, kk, vk = (_torch(a) for a in _kernel_layout(*_inputs(4)))
    assert K.check_flash_kernel(qk, kk, vk) == "wgmma"
    assert K.check_flash_kernel(qk.float(), kk.float(), vk.float()) == "fma"
    # A softcap keeps the variant (it was refused before the kernel had
    # one); a negative cap is refused.
    assert K.check_flash_kernel(qk, kk, vk, attn_softcap=50.0) == "wgmma"
    assert K.check_flash_kernel(qk.float(), kk.float(), vk.float(),
                                attn_softcap=50.0) == "fma"
    with pytest.raises(ValueError, match="softcap"):
        K.check_flash_kernel(qk, kk, vk, attn_softcap=-1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.check_flash_kernel(qk.half(), kk.half(), vk.half())
    with pytest.raises(TypeError, match="dtypes differ"):
        K.check_flash_kernel(qk, kk.float(), vk)
    with pytest.raises(ValueError, match="contiguous"):
        K.check_flash_kernel(qk.transpose(2, 3).contiguous().transpose(2, 3),
                             kk, vk)
    with pytest.raises(ValueError, match="exceed"):
        wide = torch.zeros(qk.shape[:3] + (257,), dtype=torch.bfloat16)
        K.check_flash_kernel(wide, torch.zeros(kk.shape[:2] + (257,),
                                               dtype=torch.bfloat16), vk)
    # Dtype and shape checks hold on both routes.
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.flash_attention(qk.half(), kk.half(), vk.half())
    with pytest.raises(ValueError, match="expected q"):
        K.flash_attention(qk, kk[:, :5], vk)


@pytest.mark.parametrize("d,dv,variant", [
    (256, 256, "fma"), (192, 128, "fma"), (128, 256, "fma"),
    (128, 128, "wgmma"), (257, 128, None), (128, 257, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_flash_kernel_takes_head_sizes_up_to_256(d, dv, variant, dtype):
    """The kernel takes D and Dv up to 256 in any combination, as the
    Pallas kernel does: the FMA variant beyond the tensor cores' sizes;
    past 256 it raises before any launch."""
    q = torch.zeros((2, 3, 16, d), dtype=dtype)
    k = torch.zeros((2, 16, d), dtype=dtype)
    v = torch.zeros((2, 16, dv), dtype=dtype)
    if variant is None:
        with pytest.raises(ValueError, match="exceed the kernel's 256"):
            K.check_flash_kernel(q, k, v)
        return
    if variant == "wgmma" and dtype == torch.float32:
        variant = "fma"
    assert K.check_flash_kernel(q, k, v) == variant


def _padded(t, pad=8):
    """``t`` as a view into a buffer with ``pad`` more columns: the head
    dimension contiguous, every outer stride padded."""
    buf = torch.zeros(t.shape[:-1] + (t.shape[-1] + pad,), dtype=t.dtype)
    buf[..., :t.shape[-1]] = t
    return buf[..., :t.shape[-1]]


@pytest.mark.parametrize("view", ["contiguous", "padded"])
@pytest.mark.parametrize("i", range(len(SWEEP)), ids=IDS)
def test_bshd_entry_equals_kernel_layout(i, view):
    """The model-layout entry on [B, S, H, D] views gives, bit for bit,
    the kernel-layout entry's result on the permuted contiguous tensors
    (padded views with a query offset)."""
    B, *_, causal, window, bq, bk, _dtype = SWEEP[i]
    q, k, v = (_torch(a) for a in _inputs(i))
    q_offset = 64 if view == "padded" else 0
    if view == "padded":
        q, k, v = _padded(q), _padded(k), _padded(v)
        assert not q.is_contiguous() and q.stride(-1) == 1
    qk, kk, vk = (_torch(a) for a in _kernel_layout(*_inputs(i)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk_q=bq,
              chunk_k=bk)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = K.flash_attention_bshd(q, k, v, out_dtype=out_dtype, **kw)
        want = K.flash_attention(qk, kk, vk, out_dtype=out_dtype, **kw)
        H, Sq, Dv = q.shape[2], q.shape[1], v.shape[-1]
        want = want.reshape(B, H, Sq, Dv).transpose(1, 2)
        assert got.shape == (B, Sq, H, Dv) and got.dtype == out_dtype
        assert torch.equal(got, want)


def _fault(t, fault):
    """``t`` with one layout fault the wgmma variant cannot read."""
    if fault == "innermost":
        return t.transpose(-2, -1).contiguous().transpose(-2, -1)
    if fault == "stride":
        return _padded(t, pad=1)
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("fault,match", [
    ("innermost", "contiguous"), ("stride", "multiple of 16 bytes"),
    ("pointer", "16-byte aligned")])
def test_strided_kernel_checks_raise_before_launch(fault, match):
    """The wgmma variant reads strided views: D contiguous, every other
    stride a multiple of 16 bytes, 16-byte-aligned data; anything else
    raises before a launch (the checks run on CPU tensors too), in both
    layouts and for each of q, k and v."""
    q, k, v = (_torch(a) for a in _inputs(4))          # bf16, D 64
    qk, kk, vk = (_torch(a) for a in _kernel_layout(*_inputs(4)))
    assert K.check_flash_kernel(q, k, v) == "wgmma"
    assert K.check_flash_kernel(_padded(q), _padded(k), _padded(v)) == "wgmma"
    # A size-1 dimension's stride is never used: a view may carry any.
    odd = q[:1, :1].as_strided((1, 1) + q.shape[2:], (3, 5) + q.stride()[2:])
    assert K.check_flash_kernel(odd, k[:1], v[:1]) == "wgmma"
    for args in ((q, k, v), (qk, kk, vk)):
        for j in range(3):
            bad = list(args)
            bad[j] = _fault(bad[j], fault)
            with pytest.raises(ValueError, match=match):
                K.check_flash_kernel(*bad)
    with pytest.raises(ValueError, match="H % KVH"):
        K.flash_attention_bshd(q[:, :, :3], k, v)
