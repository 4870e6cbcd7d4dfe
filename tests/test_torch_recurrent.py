"""The port's recurrent architectures and encoder vs the JAX package's.

``mamba2_130m`` (attention-free SSD), ``recurrentgemma_9b`` (RG-LRU
blocks with local MQA, 2:1) and ``hubert_xlarge`` (a bidirectional
encoder on precomputed frames), at each config's ``reduced()`` widths
with the layers cut to one period (mamba2 and hubert 1, recurrentgemma 3:
``rglru``, ``rglru``, ``attn_local``):

* the configs: ``dataclasses.asdict`` of the full config and of
  ``reduced()``, ``layer_kinds``, ``segments`` and ``param_count`` equal;
  ``get_config`` resolves all ten architectures and raises ``KeyError``
  for another name;
* ``convert.model_params_from_reference`` round trip, bit for bit (the
  port's weights laid out as JAX's ``Model.init`` tree through
  ``jax.eval_shape``, as ``tests/test_torch_models.py`` does);
* ``ssm_apply`` and ``rglru_apply`` against JAX's jitted layers: a
  prefill of 80 tokens (past the SSD chunk of 32, not a multiple of it:
  chunks of 20 by the largest-divisor rule) and of 2 tokens (shorter than
  ``conv1d_width - 1``: the conv window is padded), each with its cache,
  then three decode steps from it; the port's RG-LRU scan also against a
  sequential loop;
* prefill and three teacher-forced decode steps of the two decoders, the
  prompt (80) past the reduced window (64), so the local layers' ring
  buffers wrap; ``encode`` of hubert (non-causal attention);
* ``ServeEngine``'s prefix-cache counters on the reduced mamba2;
  ``launch.serve`` on the two decoders on the CPU.

Tolerances: the model tolerance of ``tests/test_torch_serve.py`` (rtol
5e-2, atol max(5e-2, 2e-2 max|ref|): bf16 matmuls round in another order)
for every output, cache and state against JAX; the scan against the loop
rtol 1e-5, atol 1e-6 (float32 products composed in another order). JAX's
objects are built once a config and jitted (op by op they compile for
seconds).
"""

import dataclasses
import functools
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.models import rglru as RR
from repro.models import ssm as RS
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models.attention import KVCache
from repro_torch.serve import ServeEngine

from test_torch_models import (_close, _grown, _jax_layer_caches, _numpy,
                               _reference_params)
from test_torch_moe_mla import _tree

torch.set_num_threads(1)

RECURRENT = ["mamba2_130m", "recurrentgemma_9b"]
B, PROMPT, STEPS = 2, 80, 3
CACHE_TYPE = {"ssm": TS.SSMCache, "rglru": TR.RGLRUCache,
              "attn_local": KVCache}

_SSM = jax.jit(RS.ssm_apply, static_argnames=("cfg", "update_cache"))
_RGLRU = jax.jit(RR.rglru_apply, static_argnames=("cfg", "update_cache"))


def _cut(arch):
    """``reduced()`` with one period of its layer pattern."""
    small = get_config(arch).reduced()
    return dataclasses.replace(small, num_layers=len(small.block_pattern
                                                     or (1,)))


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX model, its params: the port model's weights, the port model on
    the CPU). ``jax.eval_shape`` lays the port's weights out as JAX's tree
    without running JAX's init."""
    cfg = _cut(arch)
    port = build_model(cfg, device="cpu", seed=0)
    model = r_build_model(dataclasses.replace(
        r_get_config(arch).reduced(), num_layers=cfg.num_layers))
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    return model, _reference_params(cfg, shapes, port.state_dict()), port


def _uncounted(cfg, state):
    """The parameters ``param_count`` leaves out: every 1-D one (norm
    scales, biases, the mixers' vectors), the 2-D conv weights, and for
    the ``frames`` frontend the embedding it counts but the model lacks
    (a negative count)."""
    n = sum(t.numel() for name, t in state.items()
            if t.ndim == 1 or name.endswith("conv_w"))
    if cfg.frontend == "frames":
        n -= cfg.vocab_size * cfg.d_model
    return n


def test_every_architecture_resolves():
    assert {get_config(a).name for a in ARCHS} == set(ARCHS)
    with pytest.raises(KeyError):
        get_config("mamba3_1b")


@pytest.mark.parametrize("arch", RECURRENT + ["hubert_xlarge"])
def test_configs_match(arch):
    port, ref = get_config(arch), r_get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.segments() == ref.segments()
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", RECURRENT + ["hubert_xlarge"])
def test_model_params_from_reference(arch):
    cfg = _cut(arch)
    _, params, port = _models(arch)
    state = convert.model_params_from_reference(
        cfg, jax.tree.map(np.asarray, params))
    port = port.state_dict()
    assert sorted(state) == sorted(port)
    for name, t in port.items():
        assert t.dtype == state[name].dtype, name
        assert torch.equal(t, state[name]), name
    assert sum(x.size for x in jax.tree.leaves(params)) == sum(
        t.numel() for t in port.values())
    assert sum(t.numel() for t in port.values()) - _uncounted(cfg, port) \
        == cfg.param_count()
    # RecurrentGemma at full depth: a 3-layer period x 12, then rglru x 2.
    assert get_config("recurrentgemma_9b").segments() == (
        (("rglru+mlp", "rglru+mlp", "attn_local+mlp"), 12),
        (("rglru+mlp",), 2))


def _bf16(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                            ).to(torch.bfloat16)


def _layer_vs_reference(init, apply, ref_apply, arch, S):
    """``apply`` against ``ref_apply`` (JAX's, jitted): a prefill of S
    tokens building the cache, then three decode steps from it."""
    cfg = get_config(arch).reduced()
    p = init(torch.Generator().manual_seed(S), cfg)
    ref_p = _tree(p)
    x = _bf16(np.random.default_rng(S), (B, S + STEPS, cfg.d_model))
    out, cache = apply(p, cfg, x[:, :S], update_cache=True)
    want, ref_cache = ref_apply(ref_p, cfg, jnp.asarray(_numpy(x[:, :S])),
                                update_cache=True)
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), want, "prefill")
    for t in range(STEPS + 1):
        assert cache.conv.dtype == torch.bfloat16
        assert cache.conv.shape == (B, cfg.conv1d_width - 1) + cache.conv.shape[2:]
        for name, got, ref in zip(cache._fields, cache, ref_cache):
            _close(got.float().numpy(), np.asarray(ref, np.float32),
                   f"step {t} {name}")
        if t == STEPS:
            break
        tok = x[:, S + t:S + t + 1]
        before = [c.clone() for c in cache]
        out, new = apply(p, cfg, tok, cache=cache)
        want, ref_cache = ref_apply(ref_p, cfg, jnp.asarray(_numpy(tok)),
                                    cache=ref_cache)
        _close(out.float().numpy(), want, f"decode step {t}")
        # decode leaves its input cache as it was (the prefix cache's entry)
        assert all(torch.equal(b, c) for b, c in zip(before, cache))
        cache = new
    return cache


@pytest.mark.parametrize("S", [PROMPT, 2], ids=["chunks", "short"])
def test_ssm_apply_matches_reference(S):
    cache = _layer_vs_reference(TS.ssm_init, TS.ssm_apply, _SSM,
                                "mamba2_130m", S)
    assert cache.state.dtype == torch.float32


@pytest.mark.parametrize("S", [PROMPT, 2], ids=["long", "short"])
def test_rglru_apply_matches_reference(S):
    cache = _layer_vs_reference(TR.rglru_init, TR.rglru_apply, _RGLRU,
                                "recurrentgemma_9b", S)
    assert cache.h.dtype == torch.float32


@pytest.mark.parametrize("S", [1, 77, 128])
def test_rglru_scan_matches_sequential_loop(S):
    rng = np.random.default_rng(S)
    W = 48
    x, r, i = (torch.from_numpy(rng.uniform(lo, 1.0, (B, S, W))
                                .astype(np.float32)) for lo in (-1, 0, 0))
    lam = torch.from_numpy(rng.uniform(2.2, 6.9, W).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(B, W)).astype(np.float32))
    y, h_last = TR._rglru_scan(x, r, i, lam, h0)
    a = torch.exp(8.0 * r * torch.log(torch.sigmoid(lam)))
    b = torch.sqrt(torch.clamp_min(1 - a * a, 1e-12)) * (i * x)
    h, want = h0, []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    want = torch.stack(want, 1)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(h_last, y[:, -1])


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_and_decode_match_reference(arch):
    model, params, port = _models(arch)
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    cfg = port.cfg
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
    logits, caches = prefill(params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    t_logits, t_caches = port.prefill(torch.as_tensor(tokens[:, :PROMPT]))
    assert t_logits.dtype == torch.float32 and t_logits.shape == (B, cfg.vocab_size)
    _close(t_logits.numpy(), logits, "prefill logits")
    ref_caches = _jax_layer_caches(cfg, caches)
    assert len(t_caches) == len(ref_caches) == cfg.num_layers
    for i, (kind, c, rc) in enumerate(zip(cfg.layer_kinds(), t_caches,
                                          ref_caches)):
        assert isinstance(c, CACHE_TYPE[kind.split("+")[0]])
        for name, t, r in zip(c._fields, c, rc):
            assert t.dtype == torch.float32 if name in ("state", "h") \
                else t.dtype == torch.bfloat16
            assert tuple(t.shape) == r.shape
            _close(t.float().numpy(), r.astype(np.float32),
                   f"layer {i} {name} cache")

    max_len = PROMPT + STEPS
    caches = jax.tree.map(_grown, jax.eval_shape(
        lambda: model.init_caches(B, max_len)), caches)
    grown = ServeEngine(port, batch=B, max_len=max_len)._grow_caches(
        t_caches, PROMPT)
    for t in range(STEPS):
        pos = PROMPT + t
        tok = tokens[:, pos]
        logits, caches = decode(params, jnp.asarray(tok), caches,
                                jnp.asarray(pos, jnp.int32))
        t_logits, grown = port.decode_step(torch.as_tensor(tok), grown, pos)
        assert torch.isfinite(t_logits).all()
        _close(t_logits.numpy(), logits, f"decode step {t}")


def test_encode_matches_reference():
    model, params, port = _models("hubert_xlarge")
    cfg = port.cfg
    assert not cfg.causal and port.embed is None
    frames = np.random.default_rng(2).normal(
        size=(B, PROMPT, cfg.d_model)).astype(np.float32)
    want = jax.jit(model.encode)(params, jnp.asarray(frames))
    got = port.encode(torch.as_tensor(frames))
    assert got.dtype == torch.float32 and got.shape == (B, PROMPT, cfg.vocab_size)
    _close(got.numpy(), want, "encoder logits")
    with pytest.raises(ValueError, match="encoder-only"):
        port.prefill(torch.zeros((B, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(port, batch=B, max_len=8)


def test_serve_engine_counters():
    """The ten requests of ``examples/serve_with_prefix_filter.py`` on the
    reduced mamba2: the counters ``tests/test_torch_serve.py`` holds equal
    to the JAX engine's on that sequence (hits 2, evictions 4, filtered +
    misses 8, stale 0), a repeated prompt's tokens, and each cached
    entry's caches unchanged by the requests that decode from it."""
    port = _models("mamba2_130m")[2]
    engine = ServeEngine(port, batch=B, max_len=PROMPT + STEPS,
                         prefix_cache_entries=4)
    rng = np.random.default_rng(0)
    pool = [rng.integers(0, port.cfg.vocab_size, (B, PROMPT)).astype(np.int32)
            for _ in range(6)]
    first, kept = {}, {}
    for i in [0, 1, 2, 3, 1, 2, 4, 5, 0, 1]:
        tokens, stats = engine.generate(pool[i], steps=STEPS)
        assert tokens.shape == (B, STEPS + 1)
        assert np.array_equal(first.setdefault(i, tokens), tokens)
        # Every entry's caches (the float32 SSM state included) come out
        # of the requests' decodes as its prefill left them.
        for key, (_, caches) in engine.prefix_cache.entries.items():
            assert caches[0].state.dtype == torch.float32
            snap = kept.setdefault(key, [t.clone() for c in caches for t in c])
            assert all(torch.equal(a, b) for a, b in zip(
                snap, (t for c in caches for t in c)))
    assert stats["hits"] == 2 and stats["evictions"] == 4
    assert stats["filtered"] + stats["misses"] == 8 and stats["stale"] == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_launch_serve_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "4", "--steps", "4"])
    assert "served 4 requests, 80 tokens" in out.getvalue()
    if arch == RECURRENT[0]:
        with pytest.raises(ValueError, match="encoder-only"):
            launch_serve.main(["--arch", "hubert_xlarge", "--reduced",
                               "--device", "cpu"])
