"""The port's MoE and MLA layers, and the attention softcap, vs the JAX
package's, at reduced widths on the CPU.

* ``models.moe``: for Mixtral's router (softmax over the top-2 logits),
  DeepSeek's (sigmoid scores normalized over the top-k, a shared expert)
  and DeepSeek's at top-4 of 16 experts (four contributions a token, so
  the order of the bf16 combine matters), with ``capacity_factor`` 0.5 so
  that tokens drop: the dispatch (capacity, the stable sort's order, each
  assignment's token, kept / dropped, slot) equals the lines of
  ``repro.models.moe.moe_apply`` exactly, the routing weights to float32
  rounding, and ``moe_apply``'s output is within bf16 rounding of JAX's
  (atol 2e-2 max|ref|: each expert's GLU and the combine round to bf16 in
  another order). A decode-sized batch is dropless.
* ``models.attention`` MLA (DeepSeek-V3 reduced: q rank 64, kv rank 32,
  qk 16 + 8 against v 32): prefill output and cache, then three decode
  steps in both forms (absorbed and naive), against
  ``repro.models.attention.mla_apply`` at ``tests/test_torch_serve.py``'s
  tolerance (rtol 5e-2, atol max(5e-2, 2e-2 max|ref|)).
* ``flash_attention`` with ``attn_softcap`` against
  ``repro.models.attention.flash_attention`` at head sizes 256 and 64,
  causal, with and without a window, on scores the cap bends (1e-4 in
  float32, ``tests/test_torch_flash.py``'s tolerance).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import moe as RM
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM

torch.set_num_threads(1)

# JAX's layers, jitted (op by op they take seconds a call to compile).
_MOE = jax.jit(RM.moe_apply, static_argnames=("cfg", "capacity_factor"))
_MLA = jax.jit(RA.mla_apply, static_argnames=("cfg", "update_cache"))
_FLASH = jax.jit(RA.flash_attention, static_argnames=(
    "causal", "window", "attn_softcap", "chunk_q", "chunk_k"))

MOE_CASES = {
    "mixtral": ("mixtral_8x22b", {}),
    "deepseek": ("deepseek_v3_671b", {}),
    "deepseek_top4_of_16": ("deepseek_v3_671b",
                            {"num_experts": 16, "experts_per_token": 4}),
}


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _tree(module: torch.nn.Module) -> dict:
    """A module's parameters as the JAX package's nested dict."""
    out = {}
    for name, t in module.state_dict().items():
        *path, leaf = name.split(".")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[leaf] = jnp.asarray(_numpy(t))
    return out


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    atol = max(5e-2, 2e-2 * float(np.abs(ref).max()))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=5e-2, atol=atol,
                               err_msg=what)


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                            * scale).to(torch.bfloat16)


@functools.partial(jax.jit, static_argnames=("cfg", "cap"))
def _jax_dispatch(router, cfg, tokens, cap):
    """The dispatch lines of ``repro.models.moe.moe_apply`` (which returns
    only its output) past its capacity ``cap``: order, t_s, w_s, kept,
    slot."""
    T = tokens.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = tokens.astype(jnp.float32) @ router
    if cfg.router_fn == "sigmoid":
        vals, idx = jax.lax.top_k(jax.nn.sigmoid(logits), k)
        weights = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
    else:
        vals, idx = jax.lax.top_k(logits, k)
        weights = jax.nn.softmax(vals, axis=-1)
    e_flat = idx.reshape(-1)
    t_flat = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)
    order = jnp.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    first = jnp.searchsorted(e_s, e_s, side="left")
    rank = jnp.arange(T * k, dtype=jnp.int32) - first
    kept = rank < cap
    slot = jnp.where(kept, e_s * cap + rank, E * cap)
    return order, t_flat[order], weights.reshape(-1)[order], kept, slot


def _moe(case):
    arch, over = MOE_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    gen = torch.Generator().manual_seed(len(case))
    return cfg, TM.moe_init(gen, cfg)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    cfg, p = _moe(case)
    x = _bf16(np.random.default_rng(3), (2, 32, cfg.d_model))
    ref_p = _tree(p)
    cf = 0.5
    got = TM.moe_dispatch(p.router, cfg, x.reshape(-1, cfg.d_model),
                          capacity_factor=cf)
    T = x.shape[0] * x.shape[1]
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = max(int(np.ceil(T * k / E * cf)), min(T, 8))       # JAX's line
    order, token, weight, kept, slot = (np.asarray(a) for a in _jax_dispatch(
        ref_p["router"], cfg, jnp.asarray(_numpy(x)).reshape(-1, cfg.d_model),
        cap))
    assert got.cap == cap
    np.testing.assert_array_equal(got.order.numpy(), order)
    np.testing.assert_array_equal(got.token.numpy(), token)
    np.testing.assert_array_equal(got.kept.numpy(), kept)
    np.testing.assert_array_equal(got.slot.numpy(), slot)
    np.testing.assert_allclose(got.weight.numpy(), weight, rtol=1e-6,
                               atol=1e-7)
    assert kept.any() and not kept.all()      # the capacity drops tokens

    out = TM.moe_apply(p, cfg, x, capacity_factor=cf)
    want = np.asarray(_MOE(ref_p, cfg, jnp.asarray(_numpy(x)),
                           capacity_factor=cf), np.float32)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))


def test_moe_decode_batch_is_dropless():
    cfg, p = _moe("deepseek")
    tokens = _bf16(np.random.default_rng(4), (4, cfg.d_model))
    r = TM.moe_dispatch(p.router, cfg, tokens, capacity_factor=0.01)
    assert r.cap == 4 and bool(r.kept.all())


@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed", "naive"])
def test_mla_matches_reference(absorb):
    cfg = dataclasses.replace(get_config("deepseek_v3_671b").reduced(),
                              mla_absorb=absorb)
    p = TA.mla_init(torch.Generator().manual_seed(5), cfg)
    ref_p = _tree(p)
    B, S, steps = 2, 24, 3
    rng = np.random.default_rng(6)
    x = _bf16(rng, (B, S + steps, cfg.d_model))
    pos = np.tile(np.arange(S), (B, 1))
    out, cache = TA.mla_apply(p, cfg, x[:, :S],
                              positions=torch.as_tensor(pos),
                              update_cache=True)
    want, ref_cache = _MLA(ref_p, cfg, jnp.asarray(_numpy(x[:, :S])),
                           positions=jnp.asarray(pos), update_cache=True)
    _close(out, want, "prefill")
    for name in ("c_kv", "k_rope"):
        assert getattr(cache, name).dtype == torch.bfloat16
        _close(getattr(cache, name), getattr(ref_cache, name), name)

    grown = TA.MLACache(*(torch.zeros((B, S + steps) + t.shape[2:],
                                      dtype=t.dtype) for t in cache))
    ref_grown = RA.MLACache(*(jnp.zeros((B, S + steps) + t.shape[2:], t.dtype)
                              .at[:, :S].set(t) for t in ref_cache))
    for d, s in zip(grown, cache):
        d[:, :S] = s
    for t in range(steps):
        at = S + t
        tok = x[:, at:at + 1]
        out, grown = TA.mla_apply(p, cfg, tok,
                                  positions=torch.full((B, 1), at),
                                  cache=grown, cache_pos=at)
        want, ref_grown = _MLA(ref_p, cfg, jnp.asarray(_numpy(tok)),
                               positions=jnp.full((B, 1), at),
                               cache=ref_grown,
                               cache_pos=jnp.asarray(at, jnp.int32))
        _close(out, want, f"decode step {t}")


@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window24"])
@pytest.mark.parametrize("D", [256, 64])
def test_flash_softcap_matches_reference(D, window):
    rng = np.random.default_rng(D + (window or 0))
    B, S, H, KVH, cap = 1, 96, 4, 2, 20.0
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32) * 3
               for h in (H, KVH, KVH))
    want = _FLASH(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=window, attn_softcap=cap, chunk_q=32,
                  chunk_k=64)
    got = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, window=window, attn_softcap=cap,
                             chunk_q=32, chunk_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # The cap bends these scores: without it the output is another.
    plain = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=window)
    assert float((plain - got).abs().max()) > 1e-2
