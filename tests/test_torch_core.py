"""The port's torch core vs the JAX core, bit-exact.

``_insert_rounds`` (the legacy lock-step eviction round loop) is
deterministic in both packages: the same keys, made from a seed with
numpy, must give the same table, ``ok``, evictions, rounds and failure
count at loads 0.5, 0.9 and 0.97, under BFS and DFS eviction, with
``valid`` masks and ``dedup_within_batch``. The claim election, the batch
dedup and key preparation are held the same way, and a compacted residue
(the GPU path's hand-off from the direct-insert kernel) must give what
the uncompacted, masked call gives.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CuckooConfig, keys_from_numpy
from repro.core import cuckoo_filter as CF
from repro_torch import convert
from repro_torch.core import cuckoo_filter as TCF

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them, and each compile takes about a
# fifth less time.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

NUM_BUCKETS = 64

# (bucket_size, fp_bits, policy, load, eviction, hash)
CELLS = [
    (16, 16, "xor", 0.5, "bfs", "fmix32"),
    (16, 16, "xor", 0.9, "bfs", "fmix32"),
    (16, 8, "xor", 0.97, "bfs", "xxhash64"),
    (8, 16, "offset", 0.9, "dfs", "fmix32"),
    (4, 32, "xor", 0.97, "dfs", "fmix32"),
    (4, 16, "offset", 0.97, "bfs", "xxhash64"),
]
IDS = [f"b{c[0]}f{c[1]}{c[2]}{int(c[3] * 100)}{c[4]}" for c in CELLS]


def _cfg(bs, fb, policy, eviction, hash_kind, **kw):
    nb = NUM_BUCKETS if policy == "xor" else NUM_BUCKETS - 5
    return CuckooConfig(num_buckets=nb, fp_bits=fb, bucket_size=bs,
                        policy=policy, eviction=eviction, hash_kind=hash_kind,
                        insert_engine="legacy", max_evictions=128, **kw)


@functools.lru_cache(maxsize=None)
def _jax_rounds(cfg, dedup):
    return jax.jit(functools.partial(CF._insert_rounds, cfg,
                                     dedup_within_batch=dedup),
                   compiler_options=_XLA_FAST)


def _keys(seed, n, dup=0.0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    if dup:
        pick = rng.random(n) < dup
        raw[pick] = raw[rng.integers(0, n, size=int(pick.sum()))]
    return keys_from_numpy(raw)


def _both(cfg, keys_np, valid=None, dedup=False):
    """Run both round loops on the same input; returns (jax, port) results.

    Without ``valid`` the port gets None and JAX an all-True mask, which
    its round loop treats exactly as None; one compiled JAX loop per
    config then serves both kinds of call."""
    state = cfg.init()
    tcfg = convert.config_from_reference(cfg)
    tstate = convert.state_from_numpy(
        {"table": np.asarray(state.table), "count": np.asarray(state.count)},
        "cpu")
    vj = jnp.asarray(np.ones(keys_np.shape[0], bool) if valid is None
                     else valid)
    out_j = _jax_rounds(cfg, dedup)(state, jnp.asarray(keys_np), vj)
    vt = None if valid is None else torch.from_numpy(valid)
    keys = torch.from_numpy(keys_np.view(np.int32))
    out_t = TCF._insert_rounds(tcfg, tstate, keys, vt, dedup_within_batch=dedup)
    return out_j, out_t


def _assert_same(out_j, out_t):
    (sj, okj, stj), (st, okt, stt) = out_j, out_t
    np.testing.assert_array_equal(st.table.numpy().view(np.uint32),
                                  np.asarray(sj.table))
    assert int(st.count) == int(sj.count)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(stt.evictions.numpy(), np.asarray(stj.evictions))
    assert int(stt.rounds) == int(stj.rounds)
    assert int(stt.failed) == int(stj.failed)
    assert float(stt.load) == pytest.approx(float(stj.load), abs=0)


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_insert_rounds_bit_exact(cell):
    bs, fb, pol, load, ev, hk = cell
    cfg = _cfg(bs, fb, pol, ev, hk)
    n = int(cfg.num_slots * load)
    keys = _keys(1, n)
    out_j, out_t = _both(cfg, keys)
    _assert_same(out_j, out_t)
    if load > 0.9:  # the high-load cells do evict
        assert int(out_t[2].evictions.sum()) > 0


@pytest.mark.parametrize("cell", CELLS[1::2], ids=IDS[1::2])
def test_insert_rounds_valid_and_dedup_bit_exact(cell):
    bs, fb, pol, load, ev, hk = cell
    cfg = _cfg(bs, fb, pol, ev, hk)
    n = int(cfg.num_slots * load)
    keys = _keys(2, n, dup=0.2)
    valid = np.random.default_rng(3).random(n) < 0.85
    _assert_same(*_both(cfg, keys, valid=valid))
    _assert_same(*_both(cfg, keys, valid=valid, dedup=True))


def test_compacted_residue_equals_masked_call():
    """The GPU path hands the round loop only the keys the kernel could not
    place, compacted in batch order; that must equal the masked call."""
    cfg = convert.config_from_reference(_cfg(8, 16, "xor", "bfs", "fmix32"))
    keys = torch.from_numpy(_keys(4, int(cfg.num_slots * 0.95)).view(np.int32))
    state = TCF._insert_rounds(cfg, cfg.init("cpu"), keys[:300])[0]
    mask = torch.from_numpy(np.random.default_rng(5).random(keys.shape[0]) < 0.4)
    s_mask, ok_mask, st_mask = TCF._insert_rounds(
        cfg, TCF.CuckooState(state.table.clone(), state.count), keys, mask)
    idx = mask.nonzero().squeeze(1)
    s_cmp, ok_cmp, st_cmp = TCF._insert_rounds(
        cfg, TCF.CuckooState(state.table.clone(), state.count), keys[idx])
    assert torch.equal(s_mask.table, s_cmp.table)
    assert int(s_mask.count) == int(s_cmp.count)
    assert torch.equal(ok_mask[idx], ok_cmp) and not ok_mask[~mask].any()
    assert torch.equal(st_mask.evictions[idx], st_cmp.evictions)
    assert int(st_mask.rounds) == int(st_cmp.rounds)


def test_loop_keys_records_each_round_loop_call(monkeypatch):
    """``LOOP_KEYS`` records the keys each round-loop call works on (the
    residue of a bulk insert) and nothing while it is None."""
    cfg = convert.config_from_reference(_cfg(8, 16, "xor", "bfs", "fmix32"))
    keys = torch.from_numpy(_keys(4, int(cfg.num_slots * 0.95)).view(np.int32))
    mask = torch.from_numpy(np.random.default_rng(5).random(keys.shape[0]) < 0.4)
    TCF._insert_rounds(cfg, cfg.init("cpu"), keys, mask)
    assert TCF.LOOP_KEYS is None
    monkeypatch.setattr(TCF, "LOOP_KEYS", [])
    TCF._insert_rounds(cfg, cfg.init("cpu"), keys, mask)
    TCF._insert_rounds(cfg, cfg.init("cpu"), keys[:10])
    assert [int(k) for k in TCF.LOOP_KEYS] == [int(mask.sum()), 10]
    # A bulk insert hands its round loop only the keys its two sorted
    # phases left: at most the batch, at least none.
    bulk = dataclasses.replace(cfg, insert_engine="legacy")
    TCF.LOOP_KEYS.clear()
    TCF.insert_bulk(bulk, bulk.init("cpu"), keys)
    assert len(TCF.LOOP_KEYS) == 1
    assert 0 <= int(TCF.LOOP_KEYS[0]) < keys.shape[0]


def test_claims_dedup_and_prepare_match_reference():
    rng = np.random.default_rng(6)
    a1 = rng.integers(0, 40, size=300)
    a2 = np.where(rng.random(300) < 0.5, 64, rng.integers(0, 40, size=300))
    wj = CF._resolve_claims(jnp.asarray(a1, jnp.int32), jnp.asarray(a2, jnp.int32), 64)
    wt = TCF._resolve_claims(torch.from_numpy(a1), torch.from_numpy(a2), 64)
    for x, y in zip(wt, wj):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    keys = _keys(7, 300, dup=0.3)
    valid = rng.random(300) < 0.8
    fj, rj = CF._batch_dedup(jnp.asarray(keys), jnp.asarray(valid))
    ft, rt = TCF._batch_dedup(torch.from_numpy(keys.view(np.int32)),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))

    for pol in ("xor", "offset"):
        cfg = _cfg(16, 16, pol, "bfs", "xxhash64", seed=2**40 + 3)
        tcfg = convert.config_from_reference(cfg)
        kt = torch.from_numpy(keys.view(np.int32))
        for got, want in zip(TCF.prepare_keys(tcfg, kt),
                             CF.prepare_keys(cfg, jnp.asarray(keys))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
        for got, want in zip(TCF.prepare_keys_plain(tcfg, kt),
                             TCF.prepare_keys(tcfg, kt)):
            assert torch.equal(got, want)


def test_config_identity_and_engine_routing():
    for kw in ({}, {"policy": "offset", "fp_bits": 8}, {"hash_kind": "fmix32",
                                                        "max_rounds": 9}):
        ref = CuckooConfig.for_capacity(10_000, **kw)
        port = TCF.CuckooConfig.for_capacity(10_000, **kw)
        assert repr(port) == repr(ref)
        assert convert.config_from_reference(ref) == port
        assert port.expected_fpr(0.9) == ref.expected_fpr(0.9)
        assert (port.num_slots, port.table_bytes) == (ref.num_slots, ref.table_bytes)
    # Routing equals repro's for every (engine, entry point, eviction):
    # auto is orientation for the bulk entry point, the frontier for
    # insert under BFS and the legacy loop under DFS.
    for eng in TCF.INSERT_ENGINES:
        for bulk in (True, False):
            for ev in ("bfs", "dfs"):
                ref_cfg = CuckooConfig(64, insert_engine=eng, eviction=ev)
                port_cfg = TCF.CuckooConfig(64, insert_engine=eng, eviction=ev)
                assert (TCF.resolve_engine(port_cfg, bulk)
                        == CF.resolve_engine(ref_cfg, bulk))
    assert TCF.resolve_engine(TCF.CuckooConfig(64), True) == "orientation"
    assert TCF.resolve_engine(TCF.CuckooConfig(64), False) == "frontier"
    keys = torch.from_numpy(_keys(10, 50).view(np.int32))
    for fn in (TCF.insert, TCF.insert_bulk):
        cfg = TCF.CuckooConfig(16, insert_engine="orientation")
        state, ok, stats = fn(cfg, cfg.init("cpu"), keys)
        assert bool(ok.all()) and int(state.count) == 50
        assert int(stats.rounds) == 2     # two sorted commits, no residue
        # "frontier" runs: the frontier for insert, the legacy bulk build
        # (two sorted commits) for insert_bulk, as in repro.
        frontier = TCF.CuckooConfig(64, insert_engine="frontier")
        state, ok, stats = fn(frontier, frontier.init("cpu"), keys)
        assert bool(ok.all()) and int(state.count) == 50
        assert int(stats.rounds) >= (2 if fn is TCF.insert_bulk else 1)
    with pytest.raises(ValueError):
        TCF.resolve_engine(TCF.CuckooConfig(64, insert_engine="magic"), False)


def test_core_insert_query_and_wrapper_match_reference():
    cfg = _cfg(16, 16, "xor", "bfs", "fmix32")
    tcfg = convert.config_from_reference(cfg)
    keys = _keys(8, int(cfg.num_slots * 0.9))
    sj, okj, _ = jax.jit(functools.partial(CF.insert, cfg),
                         compiler_options=_XLA_FAST)(cfg.init(),
                                                            jnp.asarray(keys))
    filt = TCF.CuckooFilter(tcfg, device="cpu")
    ok, _ = filt.insert(keys)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(filt.state.table.numpy().view(np.uint32),
                                  np.asarray(sj.table))
    probe = np.concatenate([keys[:100], _keys(9, 200)])
    want = np.asarray(CF.query(cfg, sj, jnp.asarray(probe)))
    np.testing.assert_array_equal(filt.query(probe).numpy(), want)
    np.testing.assert_array_equal(
        TCF.query(tcfg, filt.state, torch.from_numpy(probe.view(np.int32))).numpy(),
        want)
    assert filt.load_factor == pytest.approx(int(ok.sum()) / cfg.num_slots)
    # The wrapper's delete is the core delete: JAX's table and ok.
    sj, okd = jax.jit(functools.partial(CF.delete, cfg),
                      compiler_options=_XLA_FAST)(sj, jnp.asarray(probe))
    np.testing.assert_array_equal(filt.delete(probe).numpy(), np.asarray(okd))
    np.testing.assert_array_equal(filt.state.table.numpy().view(np.uint32),
                                  np.asarray(sj.table))
    assert int(filt.state.count) == int(sj.count)
