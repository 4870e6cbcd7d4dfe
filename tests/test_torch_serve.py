"""The port's serving path vs the JAX package's, at reduced size.

``qwen1_5_4b.reduced()`` (2 layers, d 128, 4 query heads on 2 KV heads:
g = 2, so the GQA head mapping is exercised; split-half RoPE at theta
1e6; tied fp32 readout): the JAX ``Model.init`` parameters carry into the
port's ``Model`` through ``convert.model_params_from_reference``. Then,
with both packages fed the same tokens (numpy, seeded):

* prefill logits and the per-layer k/v caches, and four teacher-forced
  decode steps, at ``tests/test_models_smoke.py``'s tolerance (rtol 5e-2,
  atol max(5e-2, 2e-2 max|ref|): bf16 matmuls round in another order);
* ``ServeEngine`` on the 10-request sequence of
  ``examples/serve_with_prefix_filter.py``: the prefix cache's counters
  equal ``repro.serve.ServeEngine``'s (latencies are not compared). The
  JAX engine's guard is an auto-expanding cascade, the port's a plain
  handle (ROADMAP C): the counters agree because neither filter fills;
* ``FilterService`` on one seeded op stream (three clients, deadline
  dispatches on an injected clock, a ladder of shapes): every ticket's
  ``result()`` and the counters of ``stats()`` equal the JAX service's;
* the two ``PrefixCache`` cases of ``tests/test_service.py``.

One JAX model, its parameters and its jitted prefill/decode are shared by
the module (the JAX engine is handed the same jitted functions).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.serve import ServeEngine as RServeEngine
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.attention import KVCache
from repro_torch.serve import PrefixCache, ServeEngine, prefix_key

torch.set_num_threads(1)

B, PROMPT, STEPS = 2, 16, 4
SEQUENCE = [0, 1, 2, 3, 1, 2, 4, 5, 0, 1]


def _cfg():
    return get_config("qwen1_5_4b").reduced()


@functools.lru_cache(maxsize=None)
def _jax_model():
    """(model, params as numpy, jitted prefill, jitted decode)."""
    model = r_build_model(r_get_config("qwen1_5_4b").reduced())
    params = model.init(jax.random.key(0))
    return (model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step))


@functools.lru_cache(maxsize=None)
def _port_model():
    model, params, *_ = _jax_model()
    port = build_model(_cfg(), device="cpu")
    port.load_state_dict(convert.model_params_from_reference(
        _cfg(), jax.tree.map(np.asarray, params)))
    return port


def _np(t):
    return t.float().numpy()


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    atol = max(5e-2, 2e-2 * float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=atol, err_msg=what)


def test_configs_match():
    port, ref = get_config("qwen1_5_4b"), r_get_config("qwen1_5_4b")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.segments() == ref.segments()
    assert port.param_count() == ref.param_count() == 3_560_898_560
    with pytest.raises(NotImplementedError, match="item 16"):
        get_config("gemma2_2b")


def test_model_params_from_reference():
    _, params, *_ = _jax_model()
    state = convert.model_params_from_reference(
        _cfg(), jax.tree.map(np.asarray, params))
    port = _port_model().state_dict()
    assert sorted(state) == sorted(port)
    for name, t in port.items():
        assert t.dtype == state[name].dtype, name
        assert torch.equal(t, state[name]), name
    leaves = jax.tree.leaves(params)
    assert sum(x.size for x in leaves) == sum(t.numel() for t in port.values())
    wq = np.asarray(params["stack"][0][0]["mixer"]["wq"]["w"])     # [reps, ...]
    assert port["layers.1.mixer.wq.w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(port["layers.1.mixer.wq.w"]),
                                  wq[1].astype(np.float32))


def test_prefill_and_decode_match_reference():
    model, params, prefill, decode = _jax_model()
    port = _port_model()
    cfg = _cfg()
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
    logits, caches = prefill(params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    t_logits, t_caches = port.prefill(torch.as_tensor(tokens[:, :PROMPT]))
    assert t_logits.dtype == torch.float32 and t_logits.shape == (B, cfg.vocab_size)
    _close(t_logits.numpy(), logits, "prefill logits")
    for i, c in enumerate(t_caches):
        assert c.k.dtype == torch.bfloat16
        for name in ("k", "v"):
            _close(_np(getattr(c, name)),
                   getattr(caches[0][0], name)[i].astype(jnp.float32),
                   f"layer {i} {name} cache")

    max_len = PROMPT + STEPS
    big = model.init_caches(B, max_len)
    caches = jax.tree.map(lambda d, s: jax.lax.dynamic_update_slice(
        d.astype(s.dtype), s, (0,) * s.ndim), big, caches)
    grown = port.init_caches(B, max_len)
    for dst, src in zip(grown, t_caches):
        dst.k[:, :PROMPT], dst.v[:, :PROMPT] = src.k, src.v
    for t in range(STEPS):
        pos = PROMPT + t
        tok = tokens[:, pos]
        logits, caches = decode(params, jnp.asarray(tok), caches,
                                jnp.asarray(pos, jnp.int32))
        t_logits, grown = port.decode_step(torch.as_tensor(tok), grown, pos)
        assert torch.isfinite(t_logits).all()
        _close(t_logits.numpy(), logits, f"decode step {t}")


def _pool(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (B, PROMPT)).astype(np.int32)
            for _ in range(6)]


def test_serve_engine_counters_match_reference():
    model, params, prefill, decode = _jax_model()
    ref = RServeEngine(model, params, batch=B, max_len=PROMPT + STEPS,
                       prefix_cache_entries=4)
    ref._prefill, ref._decode = prefill, decode
    port = ServeEngine(_port_model(), batch=B, max_len=PROMPT + STEPS,
                       prefix_cache_entries=4)
    pool = _pool(_cfg().vocab_size)
    first = {}
    for i in SEQUENCE:
        r_tokens, r_stats = ref.generate(pool[i], steps=STEPS)
        tokens, stats = port.generate(pool[i], steps=STEPS)
        assert tokens.shape == r_tokens.shape == (B, STEPS + 1)
        # A prompt served again (from the cache, or after its eviction)
        # gives the tokens of its first serve.
        assert np.array_equal(first.setdefault(i, tokens), tokens)
        for key in ("hits", "misses", "filtered", "evictions", "stale"):
            assert stats[key] == r_stats[key], (i, key)
    assert stats["hits"] == 2 and stats["evictions"] == 4
    assert stats["filtered"] + stats["misses"] == 8 and stats["stale"] == 0
    assert len(port.prefix_cache.entries) == 4
    svc, r_svc = stats["filter_service"], r_stats["filter_service"]
    assert svc["backend"] == "cuckoo"
    # The last request's eviction and admission wait for the next lookup.
    assert svc["pending_ops"] == r_svc["pending_ops"] == 2
    assert svc["ops"] == r_svc["ops"]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stream(seed=5, submissions=24):
    """(client, keys uint64[m], ops int32[m]) submissions over 96 keys."""
    rng = np.random.default_rng(seed)
    universe = np.unique(rng.integers(1, 2**63, size=200, dtype=np.uint64))[:96]
    out = []
    for s in range(submissions):
        m = int(rng.integers(0, 12))
        keys = universe[rng.integers(0, 96, size=m)]
        ops = rng.choice(3, size=m, p=[0.5, 0.35, 0.15]).astype(np.int32)
        out.append((f"c{s % 3}", keys, ops))
    return out


def _run_service(pkg, make):
    clock = _Clock()
    svc = pkg.FilterService(make(), batch_size=32, max_delay=0.01,
                            max_pending=48, clock=clock)
    tickets = []
    for s, (client, keys, ops) in enumerate(_stream()):
        clock.t += 0.004
        tickets.append(svc.submit(keys, ops, client=client))
        if s % 7 == 6:
            svc.poll()
    results = [t.result() for t in tickets]
    svc.drain()
    return results, svc.stats()


def test_filter_service_matches_reference():
    got, stats = _run_service(
        tamq, lambda: tamq.make("cuckoo", capacity=256, device="cpu"))
    want, r_stats = _run_service(ramq, lambda: ramq.make("cuckoo", capacity=256))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == bool and np.array_equal(g, w)
    for key in ("ops", "dispatches", "padded", "accepted_ops", "shed_ops",
                "dispatched_ops", "padded_slots", "queue_depth_max",
                "dispatch_sizes", "dispatch_kinds", "clients",
                "shape_ladder", "batch_size", "pending_ops", "backend"):
        assert stats[key] == r_stats[key], key
    assert stats["padding_waste"] == pytest.approx(r_stats["padding_waste"])
    assert stats["fill"] == pytest.approx(r_stats["fill"])
    assert stats["queue_wait"]["count"] == r_stats["queue_wait"]["count"]
    assert stats["ready"]["count"] == r_stats["ready"]["count"]


def test_hot_swap_without_migration():
    h = tamq.make("cuckoo", capacity=128, device="cpu")
    svc = tamq.FilterService(h, batch_size=16)
    keys = np.arange(1, 11, dtype=np.uint64)
    t = svc.insert(keys)
    with pytest.raises(NotImplementedError, match="item 9b"):
        svc.hot_swap(tamq.make("cuckoo", capacity=128, device="cpu"))
    assert svc.handle is h and svc.pending_ops == 10   # nothing drained
    new = tamq.make("cuckoo", capacity=128, device="cpu")
    rec = svc.hot_swap(new, migrate=False)
    assert rec["drained_ops"] == 10 and not rec["migrated"]
    assert t.result().all() and h.query(keys).hits.all()
    assert svc.handle is new and not svc.query(keys).result().any()
    with pytest.raises(tamq.QueueFullError):
        svc2 = tamq.FilterService(h, batch_size=16, max_pending=4,
                                  admission="error")
        svc2.insert(keys)


def test_prefix_cache_rides_the_service():
    """The serving consumer coalesces filter ops through one service."""
    pc = PrefixCache(2, backend="cuckoo", device="cpu")
    for i in range(4):
        pc.insert([i, i + 1, i + 2], entry=f"e{i}")
    # admissions/evictions were enqueued; no lookup has forced them yet
    assert pc.service.stats["ops"] > 0
    assert pc.lookup([3, 4, 5]) == "e3"     # flushes, then answers
    assert pc.lookup([0, 1, 2]) is None     # evicted + deleted from filter
    assert pc.stats["evictions"] == 2 and pc.stats["stale"] == 0
    assert pc.service.pending_ops == 0


def test_shared_service_across_prefix_caches():
    """Several caches coalesce into one filter service (one guard filter)."""
    svc = tamq.FilterService(tamq.make("cuckoo", capacity=1024, device="cpu"),
                             batch_size=32)
    a = PrefixCache(4, service=svc)
    b = PrefixCache(4, service=svc)
    a.insert([1, 2, 3], entry="a")
    b.insert([4, 5, 6], entry="b")
    assert a.lookup([1, 2, 3]) == "a"
    assert b.lookup([4, 5, 6]) == "b"
    assert a.filter is b.filter is svc.handle


def test_prefix_key_matches_reference():
    from repro.serve import prefix_key as r_prefix_key

    for tokens in ([], [0], [5, 1, 151935], list(range(40))):
        assert prefix_key(tokens) == r_prefix_key(tokens)


def test_engine_keeps_cached_entries_intact():
    """Decode writes its caches in place; a cached entry keeps its prefill
    caches (zeros past the prompt), however often it is served."""
    engine = ServeEngine(_port_model(), batch=B, max_len=PROMPT + STEPS,
                         prefix_cache_entries=2)
    prompt = _pool(_cfg().vocab_size)[0]
    first, _ = engine.generate(prompt, steps=STEPS)
    again, stats = engine.generate(prompt, steps=STEPS)
    assert stats["hits"] == 1 and np.array_equal(first, again)
    (_, caches), = engine.prefix_cache.entries.values()
    assert isinstance(caches[0], KVCache)
    assert not caches[0].k[:, PROMPT:].any() and caches[0].k[:, :PROMPT].any()
