"""The port's bulk-build insert path vs the JAX package's, bit-exact.

Every function here is deterministic in both packages, so the same keys,
made from a seed with numpy, must give the same result with tolerance 0:
``segment_ranks`` and ``nth_free_slot``; ``_bulk_place_phase``; core
``insert_bulk`` under the ``legacy`` engine (two sorted phases and the
round-loop residue) and under ``orientation`` (table, ``ok`` and every
``InsertStats`` field, with ``valid`` and ``dedup_within_batch``, across
fp 8/16/32 x bucket 4/16 x XOR/OFFSET, at loads up to 0.97);
``_insert_orient`` on a pre-filled table; the bulk kernel's plain version
against ``cuckoo_insert_bulk_pallas`` in interpret mode on the
primary-bucket-sorted stream; ``ops.cuckoo_insert_bulk`` against the JAX
wrapper; and ``make("cuckoo", device="cpu").insert(keys, bulk=True)``
against ``repro.amq.make("cuckoo")``. The adapter's ``legacy`` bulk route
(the bulk kernel, then the round loop) places keys in another order than
JAX's two sorted phases, so it is held by invariants.
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
from repro.core import layout as RL
from repro.kernels import ops as RK
from repro.kernels import roofline as RR
from repro.kernels.cuckoo_insert import cuckoo_insert_bulk_pallas
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.core import CuckooState
from repro_torch.core import cuckoo_filter as TCF
from repro_torch.core import layout as TL
from repro_torch.core.bits64 import from_i32
from repro_torch.kernels import ops as K
from repro_torch.kernels import roofline
from repro_torch.kernels.cuckoo_insert_bulk import cuckoo_insert_bulk_plain

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them, and each compile takes about a
# fifth less time.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

NUM_BUCKETS = 64
BLOCK = 64

# (bucket_size, fp_bits, policy, load, hash): fp 8/16/32 x bucket 4/16 x
# both policies, up to the paper's 0.95 load and past it.
CELLS = [
    (4, 8, "xor", 0.95, "fmix32"),
    (16, 16, "xor", 0.95, "fmix32"),
    (16, 32, "offset", 0.8, "xxhash64"),
    (4, 16, "offset", 0.95, "fmix32"),
    (16, 8, "offset", 0.97, "fmix32"),
    (4, 32, "xor", 0.6, "xxhash64"),
]
IDS = [f"b{c[0]}f{c[1]}{c[2]}{int(c[3] * 100)}" for c in CELLS]


def _cfg(bs, fb, policy, hash_kind="fmix32", **kw):
    nb = NUM_BUCKETS if policy == "xor" else NUM_BUCKETS - 3
    return CuckooConfig(num_buckets=nb, fp_bits=fb, bucket_size=bs,
                        policy=policy, hash_kind=hash_kind, seed=7, **kw)


def _keys(seed, n, dup=0.0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    if dup:
        pick = rng.random(n) < dup
        raw[pick] = raw[rng.integers(0, n, size=int(pick.sum()))]
    return keys_from_numpy(raw)


def _t(keys_np):
    return torch.from_numpy(np.ascontiguousarray(keys_np).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _prefilled(cfg, n, seed=1):
    """The same pre-filled table in both packages: the port's round loop
    (bit-exact with the JAX one, ``test_torch_core``) fills it, and the
    table is carried across."""
    tcfg = convert.config_from_reference(cfg)
    tstate, _, _ = TCF._insert_rounds(tcfg, tcfg.init("cpu"),
                                      _t(_keys(seed, n)))
    # A copy: jnp.asarray may alias the numpy view of the torch table,
    # which the port's engines then update in place.
    jstate = CF.CuckooState(jnp.asarray(_u32(tstate.table).copy()),
                            jnp.asarray(np.int32(int(tstate.count))))
    return tcfg, tstate, jstate


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw),
                   compiler_options=_XLA_FAST)


def _assert_same(out_j, out_t):
    (sj, okj, stj), (st, okt, stt) = out_j, out_t
    np.testing.assert_array_equal(_u32(st.table), np.asarray(sj.table))
    assert int(st.count) == int(sj.count)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(stt.evictions.numpy(),
                                  np.asarray(stj.evictions))
    assert int(stt.rounds) == int(stj.rounds)
    assert int(stt.failed) == int(stj.failed)
    # load = count / num_slots in float32; the count is held exactly above,
    # and XLA may divide through the reciprocal: one float32 ulp apart.
    assert float(stt.load) == pytest.approx(float(stj.load), rel=2**-23,
                                            abs=0)


def _both_bulk(cfg, load, keys_seed=2, valid=None, dedup=False, fn="bulk"):
    """Pre-fill 40 % of the target load, then one bulk batch to ``load``."""
    n = int(cfg.num_slots * load)
    tcfg, tstate, jstate = _prefilled(cfg, int(n * 0.4))
    batch = _keys(keys_seed, n - int(n * 0.4), dup=0.2 if dedup else 0.0)
    # Without ``valid`` the port gets None and JAX an all-True mask (which
    # it treats exactly as None), so one JAX compile serves both calls.
    vj = jnp.asarray(np.ones(batch.shape[0], bool) if valid is None
                     else valid[:batch.shape[0]])
    vt = None if valid is None else torch.from_numpy(valid[:batch.shape[0]])
    jfn, tfn = {"bulk": (CF.insert_bulk, TCF.insert_bulk),
                "orient": (CF._insert_orient, TCF._insert_orient)}[fn]
    out_j = _jit(jfn, cfg, dedup_within_batch=dedup)(
        jstate, jnp.asarray(batch), vj)
    out_t = tfn(tcfg, tstate, _t(batch), vt, dedup_within_batch=dedup)
    return out_j, out_t


@pytest.mark.parametrize("bs", [4, 16])
def test_segment_ranks_and_nth_free_slot_bit_exact(bs):
    rng = np.random.default_rng(bs)
    ids = np.sort(rng.integers(0, 40, size=500)).astype(np.int32)
    np.testing.assert_array_equal(
        TL.segment_ranks(torch.from_numpy(ids).long()).numpy(),
        np.asarray(RL.segment_ranks(jnp.asarray(ids))))
    tags = np.where(rng.random((500, bs)) < 0.5, 0,
                    rng.integers(1, 2**16, size=(500, bs))).astype(np.uint32)
    rank = rng.integers(0, bs + 2, size=500).astype(np.int32)
    pj, sj = RL.nth_free_slot(jnp.asarray(tags), jnp.asarray(rank))
    pt, st = TL.nth_free_slot(torch.from_numpy(tags.astype(np.int64)),
                              torch.from_numpy(rank).long())
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _jax_place_phase(cfg, table, keys, pend):
    base, i1, _ = CF.prepare_keys(cfg, keys)
    return CF._bulk_place_phase(cfg, RL.unpack_words(table, cfg.fp_bits), i1,
                                base, pend)


@pytest.mark.parametrize("cell", CELLS[1:3], ids=IDS[1:3])
def test_bulk_place_phase_bit_exact(cell):
    bs, fb, pol, load, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg, tstate, jstate = _prefilled(cfg, int(cfg.num_slots * load * 0.5))
    keys = _keys(3, int(cfg.num_slots * load * 0.5))
    pend = np.random.default_rng(4).random(keys.shape[0]) < 0.9
    flat_j, placed_j = _jit(_jax_place_phase, cfg)(
        jstate.table, jnp.asarray(keys), jnp.asarray(pend))
    tbase, ti1, _ = TCF.prepare_keys(tcfg, _t(keys))
    flat_t = TCF._unpack_table(tcfg, tstate)
    flat_t, placed_t = TCF._bulk_place_phase(tcfg, flat_t, ti1, tbase,
                                             torch.from_numpy(pend))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j, np.int64))
    np.testing.assert_array_equal(placed_t.numpy(), np.asarray(placed_j))
    assert not placed_t[~torch.from_numpy(pend)].any()


@pytest.mark.parametrize("engine", ["legacy", "orientation"])
@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_insert_bulk_bit_exact(cell, engine):
    bs, fb, pol, load, hk = cell
    cfg = _cfg(bs, fb, pol, hk, insert_engine=engine)
    out_j, out_t = _both_bulk(cfg, load)
    _assert_same(out_j, out_t)
    if bs == 4 and load >= 0.95:    # the residue reaches the round loop
        assert int(out_t[2].rounds) > 2


@pytest.mark.parametrize("engine", ["legacy", "auto"])
@pytest.mark.parametrize("cell", CELLS[::4], ids=IDS[::4])
def test_insert_bulk_valid_and_dedup_bit_exact(cell, engine):
    bs, fb, pol, load, hk = cell
    cfg = _cfg(bs, fb, pol, hk, insert_engine=engine)
    valid = np.random.default_rng(5).random(cfg.num_slots) < 0.85
    _assert_same(*_both_bulk(cfg, load, valid=valid))
    _assert_same(*_both_bulk(cfg, load, keys_seed=6, valid=valid, dedup=True))


def test_insert_orient_on_a_prefilled_table_bit_exact():
    # Called directly, whatever the config's engine says.
    cfg = _cfg(16, 16, "xor", insert_engine="legacy", orient_sweeps=2)
    out_j, out_t = _both_bulk(cfg, 0.9, fn="orient")
    _assert_same(out_j, out_t)


@pytest.mark.parametrize("cell", CELLS[:5], ids=IDS[:5])
def test_bulk_kernel_plain_matches_pallas(cell):
    bs, fb, pol, load, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg, tstate, jstate = _prefilled(cfg, int(cfg.num_slots * load * 0.6))
    rng = np.random.default_rng(8)
    keys = _keys(9, 2 * BLOCK)
    _, i1, _ = CF.prepare_keys(cfg, jnp.asarray(keys))
    order = np.asarray(jnp.argsort(i1.astype(jnp.int32), stable=True))
    ks = keys[order]
    valid = rng.random(2 * BLOCK) < 0.9
    t_want, ok_want = _jit(cuckoo_insert_bulk_pallas, cfg, block_keys=BLOCK)(
        jstate.table, jnp.asarray(ks[:, 0]), jnp.asarray(ks[:, 1]),
        jnp.asarray(valid, jnp.uint32))
    table = tstate.table.clone()
    ok = cuckoo_insert_bulk_plain(tcfg, table, _t(ks), torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(table), np.asarray(t_want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_want).astype(bool))

    # The wrapper sorts itself and restores batch order; valid follows keys.
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    st2, ok2 = K.cuckoo_insert_bulk(tcfg, CuckooState(tstate.table.clone(),
                                                      tstate.count),
                                    _t(keys), torch.from_numpy(valid[inv]))
    np.testing.assert_array_equal(_u32(st2.table), np.asarray(t_want))
    np.testing.assert_array_equal(ok2.numpy(), ok.numpy()[inv])
    assert int(st2.count) == int(tstate.count) + int(ok.sum())


@pytest.mark.parametrize("cell", [CELLS[1], CELLS[3]], ids=[IDS[1], IDS[3]])
def test_bulk_ops_wrapper_matches_jax_wrapper(cell):
    bs, fb, pol, load, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg, tstate, jstate = _prefilled(cfg, int(cfg.num_slots * load * 0.5))
    keys = _keys(10, 3 * BLOCK - 17)                 # not a block multiple
    sj, okj = RK.cuckoo_insert_bulk(cfg, jstate, jnp.asarray(keys),
                                    block_keys=BLOCK)
    st, okt = K.cuckoo_insert_bulk(tcfg, tstate, _t(keys))
    np.testing.assert_array_equal(_u32(st.table), np.asarray(sj.table))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert int(st.count) == int(sj.count)


def _stored_pairs(cfg, table):
    tags = TL.unpack_words(from_i32(table), cfg.fp_bits).reshape(
        cfg.num_buckets, cfg.bucket_size)
    b, s = tags.nonzero(as_tuple=True)
    return list(zip(b.tolist(), tags[b, s].tolist()))


def test_adapter_insert_bulk_auto_matches_reference():
    capacity = 3891                  # floor(0.95 * 4096)
    ref = ramq.make("cuckoo", capacity=capacity)
    port = tamq.make("cuckoo", capacity=capacity, device="cpu")
    raw = np.random.default_rng(11).integers(0, 2**63, size=capacity,
                                             dtype=np.uint64)
    for chunk in np.array_split(raw, 4):
        rr, rp = ref.insert(chunk, bulk=True), port.insert(chunk, bulk=True)
        np.testing.assert_array_equal(rp.ok.numpy(), np.asarray(rr.ok))
        np.testing.assert_array_equal(rp.evictions.numpy(),
                                      np.asarray(rr.evictions))
        assert int(rp.rounds) == int(rr.rounds)
    np.testing.assert_array_equal(_u32(port.state.table),
                                  np.asarray(ref.state.table))
    assert port.count() == ref.count()


def test_adapter_insert_bulk_legacy_holds_invariants():
    capacity = 3891
    ref = ramq.make("cuckoo", capacity=capacity, insert_engine="legacy")
    port = tamq.make("cuckoo", capacity=capacity, device="cpu",
                     insert_engine="legacy")
    raw = np.random.default_rng(12).integers(0, 2**63, size=capacity,
                                             dtype=np.uint64)
    ok_ref, ok_port = [], []
    K.reset_launches()
    for chunk in np.array_split(raw, 4):
        ok_ref.append(np.asarray(ref.insert(chunk, bulk=True).ok))
        rep = port.insert(chunk, bulk=True)
        ok_port.append(rep.ok.numpy())
        assert int(rep.rounds) >= 2      # the two phases kernel #6 stands for
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)      # CPU: plain only
    ok_ref, ok_port = np.concatenate(ok_ref), np.concatenate(ok_port)
    assert ok_ref.all() and ok_port.all()
    assert port.count() == int(ok_port.sum()) == capacity
    assert bool(port.query(raw).hits.all())
    cfg = port.config
    tag, i1, i2 = TCF.prepare_keys(cfg, _t(keys_from_numpy(raw)))
    allowed = (set(zip(i1.tolist(), tag.tolist()))
               | set(zip(i2.tolist(), tag.tolist())))
    stored = _stored_pairs(cfg, port.state.table)
    assert len(stored) == capacity and set(stored) <= allowed


def test_cuckoo_filter_bulk_routes_like_reference():
    cfg = _cfg(16, 16, "xor", "fmix32")
    keys = _keys(13, int(cfg.num_slots * 0.95))
    ref = CF.CuckooFilter(cfg)
    ok_j, st_j = ref.insert(keys, bulk=True)
    port = TCF.CuckooFilter(convert.config_from_reference(cfg), device="cpu")
    ok_t, st_t = port.insert(keys, bulk=True)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(_u32(port.state.table),
                                  np.asarray(ref.state.table))
    assert int(st_t.rounds) == int(st_j.rounds)
    more = _keys(14, 20)
    with pytest.warns(DeprecationWarning):
        ok2, _ = port.insert_bulk(more)
    assert bool(port.query(more)[ok2].all())


@pytest.mark.parametrize("op", ["bulk_insert", "orient_bulk_insert"])
def test_roofline_bulk_ops_match_reference(op):
    for nb, n in ((1 << 10, 1 << 12), (1 << 24, 1 << 24), (1 << 14, 100)):
        cfg = CuckooConfig(num_buckets=nb)
        got = roofline.cuckoo_op_traffic(convert.config_from_reference(cfg),
                                         op, batch=n)
        want = RR.cuckoo_op_traffic(cfg, op, batch=n)
        assert (got.stream_read, got.table_read, got.table_write) == (
            want.stream_read, want.table_read, want.table_write)
        # Results are bool[n] in the port, a uint32 lane in the JAX model.
        assert (got.stream_write, want.stream_write) == (1, 4)
    tcfg = convert.config_from_reference(CuckooConfig(num_buckets=1 << 10,
                                                      hash_kind="fmix32"))
    if op == "bulk_insert":
        assert (roofline.int_ops_per_key(tcfg, op)
                == roofline.int_ops_per_key(tcfg, "insert"))
