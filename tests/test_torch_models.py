"""The port's dense, MoE and MLA architectures vs the JAX package's.

For each of ``gemma2_2b`` (alternating local / global layers, attention
and final softcaps, head size 256 at full width), ``gemma3_4b`` (5:1
local / global, QK-norm), ``h2o_danube3_4b`` (sliding window, untied
head), ``chameleon_34b`` (QK-norm), ``mixtral_8x22b`` (top-2 softmax
MoE, sliding window) and ``deepseek_v3_671b`` (MLA, three dense layers,
then sigmoid top-k MoE with a shared expert):

* the configs: ``dataclasses.asdict`` of the full config and of
  ``reduced()``, ``layer_kinds``, ``segments`` and ``param_count`` equal
  (the config's count holds no MTP block in either package);
* ``convert.model_params_from_reference`` round trip at the cut size
  below: the port's weights laid out as JAX's ``Model.init`` tree (its
  shapes and dtypes from ``jax.eval_shape``) convert back to the port's
  state dict, bit for bit (every leaf but DeepSeek's ``mtp`` block, which
  the serving port does not build);
* prefill logits and per-layer caches, then three teacher-forced decode
  steps, against JAX's jitted ``prefill`` / ``decode_step`` at
  ``tests/test_torch_serve.py``'s tolerance (rtol 5e-2, atol max(5e-2,
  2e-2 max|ref|): bf16 matmuls round in another order). The prompt (80
  tokens) is longer than the reduced window (64), so the local layers'
  windows bite in prefill and their ring buffers wrap in decode;
* ``examples/serve_with_prefix_filter_torch.py`` at the JAX example's size
  on the CPU.

Sizes: each config's ``reduced()`` widths with the layers cut to one
period of its pattern (gemma2 2 layers, gemma3 6, danube / chameleon /
mixtral 1, deepseek 4: its three dense layers and one MoE layer). One JAX
model, its parameters and its jitted prefill / decode are shared per
config (``functools.lru_cache``); the weights are the port's (JAX's
``init`` runs op by op, seconds a config).
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.attention import KVCache, MLACache

torch.set_num_threads(1)

ARCHS = ["gemma2_2b", "gemma3_4b", "h2o_danube3_4b", "chameleon_34b",
         "mixtral_8x22b", "deepseek_v3_671b"]
B, PROMPT, STEPS = 2, 80, 3
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cut(cfg):
    """``cfg.reduced()`` with one period of its layer pattern (and, after
    dense layers, one MoE layer)."""
    small = cfg.reduced()
    layers = max(len(small.local_global_pattern or (1,)),
                 small.first_dense_layers + 1)
    return dataclasses.replace(small, num_layers=layers)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor -> numpy of the same dtype (bf16 as ml_dtypes')."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _reference_params(cfg, shapes, state):
    """The port's state dict as the JAX ``Model.init`` tree of ``shapes``
    (its ``jax.eval_shape``): the inverse of
    ``convert.model_params_from_reference``. Segment leaves stack their
    layers over ``reps``; DeepSeek's ``mtp`` block is zeros (the port has
    none)."""
    first = np.cumsum([0] + [len(p) * r for p, r in cfg.segments()])

    def leaf(path, sd):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "mtp":
            return np.zeros(sd.shape, sd.dtype)
        if keys[0] != "stack":
            got = _numpy(state[".".join(keys)])
        else:
            seg, j, rest = keys[1], keys[2], ".".join(keys[3:])
            period = len(cfg.segments()[seg][0])
            got = np.stack([
                _numpy(state[f"layers.{first[seg] + r * period + j}.{rest}"])
                for r in range(sd.shape[0])])
        assert got.shape == sd.shape and got.dtype == sd.dtype, keys
        return got

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX model, its params: the port model's weights, jitted prefill,
    jitted decode, the port model on the CPU). The weights are drawn by
    the port (seed 0) and carried into JAX's tree, which
    ``jax.eval_shape`` gives without running JAX's init."""
    cfg = _cut(get_config(arch))
    port = build_model(cfg, device="cpu", seed=0)
    model = r_build_model(_cut(r_get_config(arch)))
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    params = _reference_params(cfg, shapes, port.state_dict())
    return (model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step), port)


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    atol = max(5e-2, 2e-2 * float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=atol, err_msg=what)


def _grown(big, cache):
    """``cache`` written at the start of a zero cache of ``big``'s shape
    (in numpy: op by op, JAX compiles each leaf's update)."""
    out = np.zeros(big.shape, cache.dtype)
    out[tuple(slice(0, n) for n in cache.shape)] = np.asarray(cache)
    return out


def _jax_layer_caches(cfg, caches):
    """JAX's caches (per segment, a tuple over the period of [reps, ...]
    leaves) as one tuple of arrays a layer, in layer order."""
    out = []
    for (period, reps), seg in zip(cfg.segments(), caches):
        for r in range(reps):
            for j in range(len(period)):
                out.append(tuple(np.asarray(a)[r] for a in seg[j]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch):
    port, ref = get_config(arch), r_get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.segments() == ref.segments()
    assert port.param_count() == ref.param_count()
    assert port.param_count(active_only=True) == ref.param_count(active_only=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_params_from_reference(arch):
    cfg = _cut(get_config(arch))
    _, params, _, _, port = _models(arch)
    state = convert.model_params_from_reference(cfg, params)
    port = port.state_dict()
    assert sorted(state) == sorted(port)
    for name, t in port.items():
        assert t.dtype == state[name].dtype, name
        assert torch.equal(t, state[name]), name
    served = {k: v for k, v in params.items() if k != "mtp"}
    assert ("mtp" in params) == bool(cfg.mtp_heads)
    assert sum(x.size for x in jax.tree.leaves(served)) == sum(
        t.numel() for t in port.values())
    # The config's count is the matrices': the port's parameters less the
    # norm scales and biases.
    vectors = sum(t.numel() for t in port.values() if t.ndim == 1)
    assert sum(t.numel() for t in port.values()) - vectors == cfg.param_count()
    if cfg.moe:
        moe = port[f"layers.{cfg.num_layers - 1}.ffn.router"]
        assert moe.dtype == torch.float32
        assert port[f"layers.{cfg.num_layers - 1}.ffn.wgate"].shape == (
            cfg.num_experts, cfg.d_model, cfg.moe_d_ff)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    model, params, prefill, decode, port = _models(arch)
    cfg = port.cfg
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
    logits, caches = prefill(params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    t_logits, t_caches = port.prefill(torch.as_tensor(tokens[:, :PROMPT]))
    assert t_logits.dtype == torch.float32 and t_logits.shape == (B, cfg.vocab_size)
    _close(t_logits.numpy(), logits, "prefill logits")
    ref_caches = _jax_layer_caches(cfg, caches)
    assert len(t_caches) == len(ref_caches) == cfg.num_layers
    for i, (c, rc) in enumerate(zip(t_caches, ref_caches)):
        assert isinstance(c, MLACache if cfg.attention == "mla" else KVCache)
        for name, t, r in zip(c._fields, c, rc):
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == r.shape
            _close(t.float().numpy(), r.astype(np.float32),
                   f"layer {i} {name} cache")

    max_len = PROMPT + STEPS
    caches = jax.tree.map(_grown, jax.eval_shape(
        lambda: model.init_caches(B, max_len)), caches)
    grown = port.init_caches(B, max_len)
    for dst, src in zip(grown, t_caches):
        for d, s in zip(dst, src):
            d[:, :s.shape[1]] = s
    for t in range(STEPS):
        pos = PROMPT + t
        tok = tokens[:, pos]
        logits, caches = decode(params, jnp.asarray(tok), caches,
                                jnp.asarray(pos, jnp.int32))
        t_logits, grown = port.decode_step(torch.as_tensor(tok), grown, pos)
        assert torch.isfinite(t_logits).all()
        _close(t_logits.numpy(), logits, f"decode step {t}")


def test_serve_example_on_the_cpu():
    """The serving example at the JAX example's sizes (gemma2_2b reduced,
    batch 2, 24-token prompts, 8 steps, the ten requests), its asserts
    and the prefix cache's counters."""
    spec = importlib.util.spec_from_file_location(
        "serve_with_prefix_filter_torch",
        ROOT / "examples" / "serve_with_prefix_filter_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.main("cpu")
    assert stats["hits"] == 2 and stats["evictions"] == 4
    assert stats["filtered"] + stats["misses"] == 8 and stats["stale"] == 0
