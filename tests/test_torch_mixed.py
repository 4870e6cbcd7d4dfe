"""The port's delete and mixed-op path vs the JAX package's, and against the
sequential oracle.

Core ``delete``, ``_count_matches`` and ``apply_ops`` are deterministic in
both packages: the same table and batch, made from a seed with numpy, must
give the same table, ``count``, ``ok`` and every ``InsertStats`` field
(tolerance 0; ``load`` within one float32 ulp, where XLA divides through
the reciprocal). Two JAX configs (XOR with fmix32, where ``i1 == i2`` for
one tag in 64; OFFSET with xxhash64), one jitted ``delete``,
``_count_matches`` and ``apply_ops`` each, all at one batch width.

The mixed batches' definition is the sequential replay of the ported
``cpu-cuckoo`` oracle (the check the JAX package's
``test_mixed_ops.py::test_mixed_matches_sequential_oracle`` means to make):
below the design load, ``FilterHandle.apply_ops`` on ``cuckoo`` (its fused
path, CPU route) and on ``bloom`` (``segmented_apply_ops``) give the
oracle's ``ok``; on ``tcf``, ``gqf`` and ``bcht`` (``segmented_apply_ops``)
the JAX package's handle's ``ok`` and snapshot, array by array. The
oracle itself is held slot for slot against the JAX package's, and
``OpBatch`` and the oracle's state carry across.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro.core import CuckooConfig, keys_from_numpy
from repro.core import cuckoo_filter as CF
from repro.filters import cpu_reference as RPY
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.core import cuckoo_filter as TCF
from repro_torch.filters import cpu_reference as TPY

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them, and each compile takes about a
# fifth less time.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

N = 256                     # the one batch width of every jitted call
CONFIGS = {
    "xor": CuckooConfig(num_buckets=64, fp_bits=16, bucket_size=8,
                        hash_kind="fmix32"),
    "offset": CuckooConfig(num_buckets=61, fp_bits=8, bucket_size=8,
                           policy="offset", hash_kind="xxhash64"),
}


@functools.lru_cache(maxsize=None)
def _jax(fn, name):
    return jax.jit(functools.partial(fn, CONFIGS[name]),
                   compiler_options=_XLA_FAST)


def _t(keys_np):
    return torch.from_numpy(np.ascontiguousarray(keys_np).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _aliased(name, raw):
    """Which of ``raw`` have ``i1 == i2`` (XOR placement only)."""
    tcfg = convert.config_from_reference(CONFIGS[name])
    _, i1, i2 = TCF.prepare_keys_plain(tcfg, _t(keys_from_numpy(raw)))
    return (i1 == i2).numpy()


@functools.lru_cache(maxsize=None)
def _filled(name):
    """(stored, twice, aliased, absent, port state): a table at load ~0.45
    filled by the port's round loop (bit-exact with JAX's). ``twice`` keys
    are stored two times; ``aliased`` keys (XOR: i1 == i2) are stored,
    the first three of them twice."""
    rng = np.random.default_rng(21)
    pool = rng.integers(0, 2**64, size=20000, dtype=np.uint64)
    mid = pool[1000:-1000]                 # disjoint from stored and absent
    alias = mid[_aliased(name, mid)][:6] if name == "xor" else mid[:0]
    stored = np.concatenate([pool[:200], alias])
    twice = pool[:20]
    fill = np.concatenate([stored, twice, alias[:3]])
    tcfg = convert.config_from_reference(CONFIGS[name])
    tstate, ok, _ = TCF._insert_rounds(tcfg, tcfg.init("cpu"),
                                       _t(keys_from_numpy(fill)))
    assert bool(ok.all())
    return stored, twice, alias, pool[-1000:], tstate


def _states(name):
    """Fresh copies of the filled state: (port, JAX)."""
    tstate = _filled(name)[-1]
    jstate = CF.CuckooState(jnp.asarray(_u32(tstate.table).copy()),
                            jnp.asarray(np.int32(int(tstate.count))))
    return TCF.CuckooState(tstate.table.clone(), tstate.count.clone()), jstate


def _assert_state(tstate, jstate):
    np.testing.assert_array_equal(_u32(tstate.table), np.asarray(jstate.table))
    assert int(tstate.count) == int(jstate.count)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_delete_bit_exact(name):
    """Present keys, duplicate deleters (three deletes of keys stored once
    and of keys stored twice), absent keys, aliased keys and a valid
    mask."""
    stored, twice, alias, absent, _ = _filled(name)
    rng = np.random.default_rng(22)
    raw = np.concatenate([stored[100:180], np.repeat(stored[180:190], 3),
                          np.repeat(twice[:10], 3), np.repeat(alias, 2),
                          absent[:N]])[:N]
    raw = raw[rng.permutation(N)]
    valid = rng.random(N) < 0.9
    tstate, jstate = _states(name)
    jstate, jok = _jax(CF.delete, name)(
        jstate, jnp.asarray(keys_from_numpy(raw)), jnp.asarray(valid))
    tcfg = convert.config_from_reference(CONFIGS[name])
    tstate, ok = TCF.delete(tcfg, tstate, _t(keys_from_numpy(raw)),
                            torch.from_numpy(valid))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _assert_state(tstate, jstate)
    assert 0 < int(ok.sum()) < int(valid.sum())
    # The wrapper's delete of the valid keys is the core's masked delete.
    filt = TCF.CuckooFilter(tcfg, _states(name)[0])
    assert torch.equal(filt.delete(raw[valid]), ok[torch.from_numpy(valid)])
    assert torch.equal(filt.state.table, tstate.table)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_count_matches_bit_exact(name):
    """Stored copies per key; an aliased key (i1 == i2) counts its one
    bucket once."""
    stored, twice, alias, absent, _ = _filled(name)
    raw = np.concatenate([alias, twice, stored, absent])[:N]
    want = np.asarray(_jax(CF._count_matches, name)(
        _states(name)[1], jnp.asarray(keys_from_numpy(raw))))
    tcfg = convert.config_from_reference(CONFIGS[name])
    got = TCF._count_matches(tcfg, _states(name)[0], _t(keys_from_numpy(raw)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    copies = np.ones(N, np.int64)
    copies[:alias.size][:3] += 1                     # stored twice
    copies[alias.size:alias.size + twice.size] = 2
    own = np.concatenate([alias, twice, stored])
    assert (got.numpy()[:own.size] >= copies[:own.size]).all()
    if name == "xor":
        assert alias.size == 6 and _aliased(name, alias).all()
        np.testing.assert_array_equal(got.numpy()[:6], [2, 2, 2, 1, 1, 1])


def _mixed_batch(name, case, rng):
    """(raw keys, ops, valid) of one of the mixes; every batch is N wide."""
    stored, twice, _, absent, _ = _filled(name)
    if case == "sparse":      # mostly queries: the compacted branches
        raw = np.concatenate([stored, absent])[rng.integers(0, 400, N)]
        ops = rng.choice(3, size=N, p=[0.84, 0.08, 0.08])
    elif case == "dense":     # many inserts and deletes: the full width
        uni = np.concatenate([stored[:90], twice[:10], absent[:60]])
        raw = uni[rng.integers(0, uni.size, N)]
        ops = rng.choice(3, size=N, p=[0.1, 0.45, 0.45])
    else:                     # every op on one key stored twice
        raw = np.full(N, twice[0], np.uint64)
        ops = rng.integers(0, 3, N)
    return raw, ops.astype(np.int32), rng.random(N) < 0.95


@pytest.mark.parametrize("case", ["sparse", "dense", "one_key"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_ops_bit_exact(name, case):
    rng = np.random.default_rng(23)
    raw, ops, valid = _mixed_batch(name, case, rng)
    tcfg = convert.config_from_reference(CONFIGS[name])
    tstate, jstate = _states(name)
    keys = _t(keys_from_numpy(raw))
    e = TCF.net_effects(tcfg, tstate, keys, torch.from_numpy(ops),
                        torch.from_numpy(valid))
    sparse = max(8, N // 8)
    if case == "dense":
        assert int(e.net_ins.sum()) > sparse and int(e.net_del.sum()) > sparse
    else:
        assert int(e.net_ins.sum()) <= sparse and int(e.net_del.sum()) <= sparse
    jstate, jok, jst = _jax(CF.apply_ops, name)(
        jstate, jnp.asarray(keys_from_numpy(raw)), jnp.asarray(ops),
        jnp.asarray(valid))
    tstate, ok, st = TCF.apply_ops(tcfg, tstate, keys, torch.from_numpy(ops),
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _assert_state(tstate, jstate)
    for field in ("evictions", "rounds", "failed"):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(jst, field)))
    np.testing.assert_allclose(st.load.numpy(), np.asarray(jst.load),
                               rtol=0, atol=np.spacing(np.float32(1)))
    # The wrapper runs the same pass.
    filt = TCF.CuckooFilter(tcfg, _states(name)[0])
    ok2, _ = filt.apply_ops(raw, ops, valid)
    assert torch.equal(ok2, ok) and torch.equal(filt.state.table,
                                                tstate.table)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_ops_empty_batch(name):
    tcfg = convert.config_from_reference(CONFIGS[name])
    tstate, jstate = _states(name)
    empty = np.zeros((0,), np.uint64)
    jstate, jok, jst = CF.apply_ops(CONFIGS[name], jstate,
                                    jnp.asarray(keys_from_numpy(empty)),
                                    jnp.zeros((0,), jnp.int32))
    tstate, ok, st = TCF.apply_ops(tcfg, tstate, _t(keys_from_numpy(empty)),
                                   torch.zeros((0,), dtype=torch.int32))
    assert ok.shape == np.asarray(jok).shape == (0,)
    _assert_state(tstate, jstate)
    assert st.evictions.shape == (0,)
    assert int(st.rounds) == int(jst.rounds) and int(st.failed) == int(jst.failed)
    assert float(st.load) == pytest.approx(float(jst.load), abs=1e-7)


# ---------------------------------------------------------------------------
# Against the sequential oracle (no JAX).
# ---------------------------------------------------------------------------

CAPACITY = 1945             # floor(0.95 * 2048): 128 buckets x 16 slots
MIXES = {                   # (query, insert, delete) fractions
    "ycsb_50_40_10": (0.5, 0.4, 0.1),
    "read_heavy_95_5": (0.95, 0.05, 0.0),
    "churn_20_40_40": (0.2, 0.4, 0.4),
    "write_heavy_50_50": (0.5, 0.5, 0.0),
}


# The backends whose sequential replay is the JAX package's own handle
# (``segmented_apply_ops`` there too), held to it snapshot by snapshot.
REFERENCE_REPLAYED = ("tcf", "gqf", "bcht")
# ``sharded-cuckoo``'s shard count in each of its cases (the mix names
# the case).
SHARDS = {"ycsb_50_40_10": 1, "churn_20_40_40": 2}


@pytest.mark.parametrize("backend,mix", [
    ("cuckoo", "ycsb_50_40_10"), ("cuckoo", "read_heavy_95_5"),
    ("cuckoo", "churn_20_40_40"), ("bloom", "write_heavy_50_50"),
    ("bloom", "read_heavy_95_5"), ("cpu-cuckoo", "churn_20_40_40"),
    ("tcf", "ycsb_50_40_10"), ("gqf", "churn_20_40_40"),
    ("bcht", "churn_20_40_40"), ("sharded-cuckoo", "ycsb_50_40_10"),
    ("sharded-cuckoo", "churn_20_40_40")])
def test_mixed_matches_sequential_oracle(backend, mix):
    """Below the design load the handle's ``apply_ops`` gives the
    sequential replay's ``ok`` in every slot: ``cuckoo`` through its fused
    path, ``sharded-cuckoo`` (over 1 and 2 shards; every key routed at
    this width) through the fused path of each partition, ``bloom``
    (append-only: no deletes) and ``cpu-cuckoo`` itself through
    ``segmented_apply_ops``, each against the ``cpu-cuckoo`` replay;
    ``tcf``, ``gqf`` and ``bcht`` through ``segmented_apply_ops`` against
    the JAX package's handle on the same ops and keys, ``ok``, ``count``
    and every snapshot array equal after each batch. A small key universe
    makes same-key ops collide within a batch."""
    rng = np.random.default_rng(sum(map(ord, backend + mix)))
    pre = rng.integers(0, 2**64, size=600, dtype=np.uint64)
    uni = np.concatenate([pre[:60], rng.integers(0, 2**64, size=90,
                                                 dtype=np.uint64)])
    if backend == "cpu-cuckoo":
        h = tamq.make(backend, capacity=CAPACITY, hash_kind="fmix32")
    elif backend == "sharded-cuckoo":
        h = tamq.make(backend, capacity=CAPACITY, device="cpu",
                      num_shards=SHARDS[mix])
    else:
        h = tamq.make(backend, capacity=CAPACITY, device="cpu")
    if backend in REFERENCE_REPLAYED:
        oracle = ramq.make(backend, capacity=CAPACITY)
    else:
        oracle = tamq.make("cpu-cuckoo", capacity=CAPACITY,
                           hash_kind="fmix32")
        assert (backend in ("bloom", "sharded-cuckoo")
                or oracle.config.num_buckets == h.config.num_buckets)
    h.insert(pre)
    oracle.insert(pre)
    p = np.array(MIXES[mix])
    for _ in range(3):
        args = (uni[rng.integers(0, uni.size, 300)],
                rng.choice(3, size=300, p=p / p.sum()), rng.random(300) < 0.9)
        batch = tamq.OpBatch.make(*args)
        rep = (tamq.segmented_apply_ops(h, batch) if backend == "cpu-cuckoo"
               else h.apply_ops(batch))
        if backend in REFERENCE_REPLAYED:
            want = oracle.apply_ops(ramq.OpBatch.make(*args))
            want = tamq.MixedReport(torch.from_numpy(np.asarray(want.ok)),
                                    batch.valid, None, None)
            got, ref = h.snapshot().arrays, oracle.snapshot().arrays
            assert sorted(got) == sorted(ref)
            for f in ref:
                assert got[f].dtype == ref[f].dtype, f
                assert np.array_equal(got[f], np.asarray(ref[f])), f
        else:
            want = oracle.apply_ops(batch)
        assert torch.equal(rep.ok, want.ok)
        assert not rep.ok[~batch.valid].any()
        # A sharded filter reports masked slots unrouted, as JAX's does.
        assert (torch.equal(rep.routed, batch.valid)
                if backend == "sharded-cuckoo" else bool(rep.routed.all()))
        if backend != "bloom":
            assert h.count() == oracle.count()
        ins = rep.insert_report(batch)
        assert torch.equal(ins.routed, batch.valid & (batch.ops == 1))
        assert torch.equal(rep.query_result(batch).hits,
                           want.ok & batch.valid & (batch.ops == 0))
        assert torch.equal(rep.delete_report(batch).ok,
                           want.ok & batch.valid & (batch.ops == 2))
    assert h.load_factor < 0.95


def test_bloom_batch_with_deletes_raises():
    h = tamq.make("bloom", capacity=100, device="cpu")
    batch = tamq.OpBatch.make([1, 2], [tamq.OP_INSERT, tamq.OP_DELETE])
    with pytest.raises(NotImplementedError, match="append-only"):
        h.apply_ops(batch)
    empty = tamq.OpBatch.make([1], [tamq.OP_DELETE], valid=[False])
    assert not h.apply_ops(empty).ok.any()


def test_oracle_matches_the_reference_slot_for_slot():
    """The ported oracle and the JAX package's leave the same bucket grid
    (evictions included: the same generator), and its state carries
    across both ways."""
    rng = np.random.default_rng(24)
    raw = rng.integers(0, 2**64, size=260, dtype=np.uint64)
    rcfg = RPY.PyCuckooConfig(num_buckets=64, fp_bits=16, bucket_size=4)
    tcfg = convert.config_from_reference(rcfg, TPY.PyCuckooConfig)
    ref, port = rcfg.init(), tcfg.init()
    assert ref.insert_batch(raw).tolist() == port.insert_batch(raw).tolist()
    assert ref.delete_batch(raw[::3]).tolist() == \
        port.delete_batch(raw[::3]).tolist()
    arrays = convert.py_cuckoo_to_numpy(port)
    assert arrays["buckets"].dtype == np.uint32
    np.testing.assert_array_equal(arrays["buckets"],
                                  np.asarray(ref.buckets, np.uint32))
    assert int(arrays["count"]) == ref.count
    back = convert.py_cuckoo_from_numpy(
        {"buckets": np.asarray(ref.buckets, np.uint32),
         "count": np.asarray(ref.count, np.int64)}, tcfg)
    probe = np.concatenate([raw, rng.integers(0, 2**64, size=200,
                                              dtype=np.uint64)])
    assert back.query_batch(probe).tolist() == ref.query_batch(probe).tolist()
    with pytest.raises(ValueError, match="buckets"):
        convert.py_cuckoo_from_numpy({"buckets": arrays["buckets"][1:],
                                      "count": 0}, tcfg)


def test_op_batch_matches_the_reference():
    rng = np.random.default_rng(25)
    raw = rng.integers(0, 2**64, size=10, dtype=np.uint64)
    ops = rng.integers(0, 3, size=10)
    valid = rng.random(10) < 0.8
    got = tamq.OpBatch.make(raw, ops, valid)
    for want in (convert.op_batch_from_reference(
                     ramq.OpBatch.make(raw, ops, valid), "cpu"),):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    padded = tamq.OpBatch.make_padded(raw, ops, 16)
    ref_padded = convert.op_batch_from_reference(
        ramq.OpBatch.make_padded(raw, ops, 16), "cpu")
    for a, b in zip(padded, ref_padded):
        assert torch.equal(a, b)
    assert padded.size == 16 and got.pad_to(10) is got
    tensor_ops = tamq.OpBatch.make(_t(keys_from_numpy(raw)),
                                   torch.from_numpy(ops))
    assert torch.equal(tensor_ops.ops, got.ops)
    for bad in ([0, 1, 3], np.array([0.0, 1.0, 2.0]), [True, False, True],
                [0, 1], [0, 1, 2**32]):
        with pytest.raises(ValueError, match="ops"):
            tamq.OpBatch.make(raw[:3], bad)
    with pytest.raises(ValueError, match="valid"):
        tamq.OpBatch.make(raw[:3], [0, 1, 2], valid=[True])
    with pytest.raises(ValueError, match="cannot pad"):
        got.pad_to(5)
