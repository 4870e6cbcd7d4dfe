"""Plain versions of the port's kernels vs the JAX Pallas kernels, bit-exact.

Each plain version (what the wrappers in ``repro_torch.kernels.ops`` run
on CPU tensors) is held against its JAX counterpart run in interpret mode,
as ``tests/test_kernel_differential.py`` does, and against the JAX
oracles: the query on tables carried across with ``repro_torch.convert``
(also on crafted tables whose hits are known, in every case of bucket
i1 and i2 that the early exit of either query kernel tells apart);
the direct insert and the mixed op stream with table and ``ok`` bit-exact.
The unfused kernels' plain versions (query #3, direct insert #5) are held
against ``cuckoo_query_pallas`` and ``cuckoo_insert_pallas`` the same way,
on the same cells; the direct insert's plain version also on tables near
load 0.95, where bucket i2 and the turned-down keys decide the outcome,
against both Pallas insert kernels.
The wrappers must raise on what their kernels do not take, and count no
launch on the CPU.
"""

import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CuckooConfig, keys_from_numpy
from repro.core import cuckoo_filter as CF
from repro.kernels import ref as R
from repro.kernels.cuckoo_insert import (cuckoo_insert_fused_pallas,
                                         cuckoo_insert_pallas)
from repro.kernels.cuckoo_mixed import cuckoo_mixed_pallas
from repro.kernels.cuckoo_query import (cuckoo_query_fused_pallas,
                                        cuckoo_query_pallas)
from repro_torch import convert
from repro_torch.core import CuckooState
from repro_torch.core import cuckoo_filter as TCF
from repro_torch.core import layout as TL
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as TR
from repro_torch.kernels import cuckoo_insert_bulk as BULK
from repro_torch.kernels.bloom import WINDOW_L2_SHARE
from repro_torch.kernels import roofline
from repro_torch.kernels.cuckoo_insert import cuckoo_insert_direct_plain
from repro_torch.kernels.cuckoo_mixed import (cuckoo_mixed_plain, key_order,
                                              key_values, scratch_slots)
from repro_torch.kernels.cuckoo_query import (cuckoo_query_plain,
                                              cuckoo_query_unfused_plain)
from _query_tables import crafted_query_table, expected_cases

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them, and each compile takes about a
# fifth less time.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

NUM_BUCKETS = 64
BLOCK = 64

# bucket_size x fp_bits x occupancy x policy x hash: every packed-word shape
# from 1 to 16 words a bucket, both policies and both hashes.
CELLS = [
    (4, 8, 0.3, "xor", "fmix32"),
    (4, 32, 0.7, "offset", "xxhash64"),
    (8, 16, 0.5, "xor", "xxhash64"),
    (16, 8, 0.7, "offset", "fmix32"),
    (16, 16, 0.5, "xor", "fmix32"),
]
IDS = [f"b{c[0]}f{c[1]}o{int(c[2] * 100)}{c[3]}" for c in CELLS]


def _cfg(bs, fb, policy, hash_kind):
    nb = NUM_BUCKETS if policy == "xor" else NUM_BUCKETS - 3
    return CuckooConfig(num_buckets=nb, fp_bits=fb, bucket_size=bs,
                        policy=policy, hash_kind=hash_kind, seed=99)


def _raw(rng, n):
    return rng.integers(1, 2**64, size=n, dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg):
    return jax.jit(functools.partial(fn, cfg), compiler_options=_XLA_FAST)


@functools.lru_cache(maxsize=None)
def _jit_blk(fn, cfg):
    return jax.jit(functools.partial(fn, cfg, block_keys=BLOCK),
                   compiler_options=_XLA_FAST)


@functools.lru_cache(maxsize=None)
def _filled(cfg, occ):
    """A state at ~occ load (legacy round loop) in both packages: the
    port's round loop, bit-exact with the JAX one (``test_torch_core``),
    fills it, and the table is carried into a JAX state."""
    n = max(BLOCK, int(cfg.num_slots * occ))
    keys = keys_from_numpy(_raw(np.random.default_rng(10), n))
    tcfg = convert.config_from_reference(cfg)
    tstate, _, _ = TCF._insert_rounds(tcfg, tcfg.init("cpu"), _t(keys))
    # A copy: jnp.asarray may alias the numpy view of the torch table.
    state = CF.CuckooState(jnp.asarray(_u32(tstate.table).copy()),
                           jnp.asarray(np.int32(int(tstate.count))))
    return state, tstate


def _t(keys_np_u32):
    return torch.from_numpy(np.ascontiguousarray(keys_np_u32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_query_plain_matches_pallas_and_core(cell):
    bs, fb, occ, pol, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg = convert.config_from_reference(cfg)
    rng = np.random.default_rng(11)
    state, tstate = _filled(cfg, occ)
    probe_np = keys_from_numpy(_raw(rng, 4 * BLOCK))
    probe = jnp.asarray(probe_np)
    want = np.asarray(_jit_blk(cuckoo_query_fused_pallas, cfg)(
        state.table, probe[:, 0], probe[:, 1])).astype(bool)
    np.testing.assert_array_equal(want, np.asarray(_jit(CF.query, cfg)(state, probe)))
    keys = _t(probe_np)
    got = cuckoo_query_plain(tcfg, tstate.table, keys)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(K.cuckoo_query(tcfg, tstate, keys).numpy(), want)
    np.testing.assert_array_equal(
        TR.cuckoo_query_ref(tcfg, tstate.table, keys[:, 0], keys[:, 1]).numpy(),
        want)


# Both policies, two layouts each: 4 and 16 slots, 8 to 32 bits.
CRAFTED_CELLS = [CELLS[0], CELLS[1], CELLS[3], CELLS[4]]
# The two query kernels of one function, each with the TPU kernel it
# replaces and its plain version: fused (#2, SWAR match) and unfused (#3,
# lane by lane). Both read bucket i2 only where i1 holds no matching tag.
QUERY_PAIR = {True: (cuckoo_query_fused_pallas, cuckoo_query_plain),
              False: (cuckoo_query_pallas, cuckoo_query_unfused_plain)}


def _pair_cases(cells):
    """(cell, fused) cases, the fused one under the cell's own id."""
    return [pytest.param(c, fused, id=f"b{c[0]}f{c[1]}{c[3]}"
                         + ("" if fused else "-unfused"))
            for fused in (True, False) for c in cells]


@pytest.mark.parametrize("cell, fused", _pair_cases(CRAFTED_CELLS))
def test_query_crafted_tables_match_pallas_and_core(cell, fused):
    """The answer the early exit of #2 and #3 must keep (bucket i2 read
    only where i1 holds no matching tag), on tables whose hits are known:
    the tag only in i2 past a full i1, only in i1, in both, in neither, an
    XOR key with i1 == i2, an OFFSET key with its base tag in i2. The
    plain version and the CPU wrapper against the Pallas kernel the CUDA
    kernel replaces (interpret) and ``CF.query``, bit for bit."""
    bs, fb, _, pol, hk = cell
    pallas, plain = QUERY_PAIR[fused]
    cfg = _cfg(bs, fb, pol, hk)
    tcfg = convert.config_from_reference(cfg)
    pool = _t(keys_from_numpy(_raw(np.random.default_rng(15), 4096)))
    keys, words, want, cases = crafted_query_table(tcfg, pool, 16)
    assert set(cases) == expected_cases(pol)
    # Pool keys pad the batch to the Pallas kernel's blocks.
    probe = torch.cat([keys, pool[:4 * BLOCK - keys.shape[0]]])
    arrays = {"table": words, "count": np.int32(keys.shape[0])}
    tstate = convert.state_from_numpy(arrays, "cpu")
    state = CF.CuckooState(jnp.asarray(words), jnp.asarray(arrays["count"]))
    pj = jnp.asarray(_u32(probe))
    ref = np.asarray(_jit_blk(pallas, cfg)(
        state.table, pj[:, 0], pj[:, 1])).astype(bool)
    np.testing.assert_array_equal(ref[:keys.shape[0]], want)
    np.testing.assert_array_equal(np.asarray(_jit(CF.query, cfg)(state, pj)), ref)
    np.testing.assert_array_equal(plain(tcfg, tstate.table, probe).numpy(), ref)
    np.testing.assert_array_equal(
        K.cuckoo_query(tcfg, tstate, probe, fused=fused).numpy(), ref)


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_insert_plain_matches_pallas(cell):
    bs, fb, occ, pol, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg = convert.config_from_reference(cfg)
    rng = np.random.default_rng(12)
    state, tstate = _filled(cfg, occ / 2)
    keys_np = keys_from_numpy(_raw(rng, 2 * BLOCK))
    kj = jnp.asarray(keys_np)
    valid = (rng.random(2 * BLOCK) < 0.9)
    t_want, ok_want = _jit_blk(cuckoo_insert_fused_pallas, cfg)(
        state.table, kj[:, 0], kj[:, 1], jnp.asarray(valid, jnp.uint32))
    table = tstate.table.clone()
    ok = cuckoo_insert_direct_plain(tcfg, table, _t(keys_np),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(table), np.asarray(t_want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_want).astype(bool))
    # The CPU route of the wrapper is the plain version; count follows ok.
    st2, ok2 = K.cuckoo_insert_direct(
        tcfg, CuckooState(tstate.table.clone(), tstate.count), _t(keys_np),
        torch.from_numpy(valid))
    assert torch.equal(ok2, ok) and torch.equal(st2.table, table)
    assert int(st2.count) == int(tstate.count) + int(ok.sum())
    # The oracle with the JAX signature is the plain loop, functionally.
    t_ref, ok_ref = TR.cuckoo_insert_ref(tcfg, tstate.table, _t(keys_np)[:, 0],
                                         _t(keys_np)[:, 1])
    table_all = tstate.table.clone()
    assert torch.equal(ok_ref, cuckoo_insert_direct_plain(tcfg, table_all,
                                                          _t(keys_np)))
    assert torch.equal(t_ref, table_all)


# A table near load 0.95: most keys find bucket i1 full, so they go on to
# bucket i2, and many find both full and are turned down.
FULL_CELLS = [(16, 16, 0.95, "xor", "fmix32"),
              (8, 32, 0.95, "offset", "xxhash64")]


@pytest.mark.parametrize("cell, fused", _pair_cases(FULL_CELLS))
def test_insert_plain_matches_pallas_past_full_buckets(cell, fused):
    """The direct insert's plain version (#4's and #5's: one function)
    against the Pallas kernel the CUDA kernel replaces (fused or unfused,
    interpret) where the second bucket and the turned-down keys decide the
    outcome: table and ``ok`` bit-exact, through the plain version and
    the CPU wrapper."""
    bs, fb, occ, pol, hk = cell
    pallas = cuckoo_insert_fused_pallas if fused else cuckoo_insert_pallas
    cfg = _cfg(bs, fb, pol, hk)
    tcfg = convert.config_from_reference(cfg)
    rng = np.random.default_rng(14)
    state, tstate = _filled(cfg, occ)
    keys_np = keys_from_numpy(_raw(rng, 2 * BLOCK))
    kj = jnp.asarray(keys_np)
    valid = rng.random(2 * BLOCK) < 0.9
    t_want, ok_want = _jit_blk(pallas, cfg)(
        state.table, kj[:, 0], kj[:, 1], jnp.asarray(valid, jnp.uint32))
    table = tstate.table.clone()
    ok = cuckoo_insert_direct_plain(tcfg, table, _t(keys_np),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(table), np.asarray(t_want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_want).astype(bool))
    st2, ok2 = K.cuckoo_insert_direct(
        tcfg, CuckooState(tstate.table.clone(), tstate.count), _t(keys_np),
        torch.from_numpy(valid), fused=fused)
    assert torch.equal(ok2, ok) and torch.equal(st2.table, table)
    # The batch reaches both outcomes the first bucket cannot give: keys
    # placed in bucket i2, and valid keys turned down.
    _, i1, _ = TCF.prepare_keys_plain(tcfg, _t(keys_np))
    i1_full = (TL.bucket_tags(tstate.table, i1, tcfg.layout) != 0).all(-1)
    in_i2 = ok & i1_full
    assert int(in_i2.sum()) > 0
    assert int((~ok & torch.from_numpy(valid)).sum()) > 0


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_query_unfused_plain_matches_pallas(cell):
    bs, fb, occ, pol, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg = convert.config_from_reference(cfg)
    rng = np.random.default_rng(11)
    state, tstate = _filled(cfg, occ)
    probe_np = keys_from_numpy(_raw(rng, 4 * BLOCK))
    probe = jnp.asarray(probe_np)
    want = np.asarray(_jit_blk(cuckoo_query_pallas, cfg)(
        state.table, probe[:, 0], probe[:, 1])).astype(bool)
    keys = _t(probe_np)
    got = cuckoo_query_unfused_plain(tcfg, tstate.table, keys)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.cuckoo_query(tcfg, tstate, keys, fused=False).numpy(), want)
    # One function: the fused kernel's plain version answers the same.
    np.testing.assert_array_equal(
        cuckoo_query_plain(tcfg, tstate.table, keys).numpy(), want)


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_insert_unfused_plain_matches_pallas(cell):
    bs, fb, occ, pol, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg = convert.config_from_reference(cfg)
    rng = np.random.default_rng(12)
    state, tstate = _filled(cfg, occ / 2)
    keys_np = keys_from_numpy(_raw(rng, 2 * BLOCK))
    kj = jnp.asarray(keys_np)
    valid = (rng.random(2 * BLOCK) < 0.9)
    t_want, ok_want = _jit_blk(cuckoo_insert_pallas, cfg)(
        state.table, kj[:, 0], kj[:, 1], jnp.asarray(valid, jnp.uint32))
    # The plain version of #5 (and #4): the sequential loop.
    table = tstate.table.clone()
    ok = cuckoo_insert_direct_plain(tcfg, table, _t(keys_np),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(table), np.asarray(t_want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_want).astype(bool))
    st2, ok2 = K.cuckoo_insert_direct(
        tcfg, CuckooState(tstate.table.clone(), tstate.count), _t(keys_np),
        torch.from_numpy(valid), fused=False)
    assert torch.equal(ok2, ok) and torch.equal(st2.table, table)
    assert int(st2.count) == int(tstate.count) + int(ok.sum())


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
@pytest.mark.parametrize("stream", ["mixed", "delete"])
def test_mixed_plain_matches_pallas_and_ref(cell, stream):
    bs, fb, occ, pol, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    tcfg = convert.config_from_reference(cfg)
    rng = np.random.default_rng(13)
    state, tstate = _filled(cfg, occ)
    n = 2 * BLOCK
    # A small universe: same-key inserts, deletes and queries collide.
    uni = keys_from_numpy(_raw(rng, 24))
    keys_np = uni[rng.integers(0, 24, size=n)]
    ops_np = (rng.integers(0, 3, size=n) if stream == "mixed"
              else np.full(n, 2)).astype(np.int32)
    valid = rng.random(n) < 0.9
    kj = jnp.asarray(keys_np)
    args = (state.table, kj[:, 0], kj[:, 1], jnp.asarray(ops_np),
            jnp.asarray(valid, jnp.uint32))
    t_want, ok_want = _jit_blk(cuckoo_mixed_pallas, cfg)(*args)
    t_ref, ok_ref = _jit(R.cuckoo_mixed_ref, cfg)(*args)
    np.testing.assert_array_equal(np.asarray(t_want), np.asarray(t_ref))

    keys, ops = _t(keys_np), torch.from_numpy(ops_np)
    table = tstate.table.clone()
    ok = cuckoo_mixed_plain(tcfg, table, keys, ops, torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(table), np.asarray(t_want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_want).astype(bool))
    t2, ok2 = TR.cuckoo_mixed_ref(tcfg, tstate.table, keys[:, 0], keys[:, 1],
                                  ops, torch.from_numpy(valid))
    assert torch.equal(t2, table) and torch.equal(ok2, ok)
    st3, ok3 = K.cuckoo_apply_ops(tcfg, CuckooState(tstate.table.clone(),
                                                    tstate.count),
                                  keys, ops, torch.from_numpy(valid))
    assert torch.equal(ok3, ok) and torch.equal(st3.table, table)
    delta = int((ok & (ops == 1)).sum()) - int((ok & (ops == 2)).sum())
    assert int(st3.count) == int(tstate.count) + delta


def test_segments_group_keys_in_batch_order():
    """The walk's order (a subset of positions by key): each key one run,
    in batch order."""
    rng = np.random.default_rng(3)
    uni = keys_from_numpy(_raw(rng, 10))
    keys = _t(uni[rng.integers(0, 10, size=200)])
    positions = torch.from_numpy(np.flatnonzero(rng.random(200) < 0.7))
    values, perm = key_order(keys, positions)
    order = positions[perm]
    assert sorted(order.tolist()) == positions.tolist()
    assert torch.equal(values, key_values(keys[order]))
    k64 = [tuple(k) for k in keys[order].tolist()]
    runs = 1
    for j in range(1, len(k64)):
        runs += k64[j] != k64[j - 1]
        if k64[j] == k64[j - 1]:
            assert order[j] > order[j - 1]   # batch order within a key
    assert runs == len(set(k64))
    assert [scratch_slots(n) for n in (1, 2, 3, 4, 5, 1 << 24)] == [
        2, 4, 8, 8, 16, 1 << 25]


def _route_order(keys, ops, valid):
    """The order in which csrc/cuckoo_mixed.cu applies a batch: the valid
    ops of keys that occur once (queries, then deletes, then inserts, each
    in batch order), then the repeated keys' ops round by round (round r:
    the r-th valid op of each repeated key, queries, deletes, inserts);
    the masked ops, which change nothing, last."""
    vals = key_values(keys).tolist()
    live = [i for i in range(len(vals)) if valid[i]]
    count, rank = {}, {}
    for i in live:
        rank[i] = count.get(vals[i], 0)
        count[vals[i]] = rank[i] + 1
    kind = [{1: 2, 2: 1}.get(int(op), 0) for op in ops]   # query, delete, insert
    once = sorted((kind[i], i) for i in live if count[vals[i]] == 1)
    again = sorted((rank[i], kind[i], i) for i in live if count[vals[i]] > 1)
    masked = [i for i in range(len(vals)) if not valid[i]]
    return torch.tensor([e[-1] for e in once + again] + masked)


def _mixed_case(rng, kind, stored, fresh):
    """128 positions into a universe of stored and fresh keys: all
    distinct, every key repeated, or a mix of both."""
    uni = np.concatenate([stored, fresh])[rng.permutation(len(stored) + len(fresh))]
    if kind == "distinct":
        return uni[:128]
    if kind == "repeated":
        return uni[rng.integers(0, 24, size=128)]
    return uni[rng.permutation(np.concatenate(
        [np.arange(8, 72), rng.integers(0, 8, size=64)]))]


@pytest.mark.parametrize("kind", ["distinct", "repeated", "mixed"])
def test_route_order_is_a_valid_linearisation(kind):
    """The plain loop on the batch in the route's order gives the plain loop
    in batch order and the TPU kernel (interpret mode): equal ``ok``, equal
    tag multisets in every bucket. The batch has no cross-key aliasing and
    fills no bucket, so keys do not interact and only each key's own order
    matters, which the route keeps."""
    cfg = _cfg(16, 16, "xor", "fmix32")       # a cell of the test above
    tcfg = convert.config_from_reference(cfg)
    rng = np.random.default_rng(31)
    # 160 keys without cross-key aliasing: one key of each (pair, tag) code.
    pool = keys_from_numpy(_raw(rng, 200))
    tag, i1, i2 = TCF.prepare_keys_plain(tcfg, _t(pool))
    first = {}
    for j, code in enumerate(((torch.minimum(i1, i2) << 16) | tag).tolist()):
        first.setdefault(code, j)
    pool = pool[sorted(first.values())[:160]]
    stored, fresh = pool[:32], pool[32:]
    table = tcfg.init("cpu").table
    assert cuckoo_insert_direct_plain(tcfg, table, _t(stored)).all()
    keys_np = _mixed_case(rng, kind, stored, fresh)
    n = keys_np.shape[0]
    ops_np = rng.integers(0, 3, size=n).astype(np.int32)
    valid_np = rng.random(n) < 0.9
    keys, ops, valid = _t(keys_np), torch.from_numpy(ops_np), torch.from_numpy(valid_np)

    t_batch, t_route = table.clone(), table.clone()
    ok_batch = cuckoo_mixed_plain(tcfg, t_batch, keys, ops, valid)
    perm = _route_order(keys, ops_np, valid_np)
    ok_route = torch.empty_like(ok_batch)
    ok_route[perm] = cuckoo_mixed_plain(tcfg, t_route, keys[perm], ops[perm],
                                        valid[perm])
    kj = jnp.asarray(keys_np)
    t_want, ok_want = _jit_blk(cuckoo_mixed_pallas, cfg)(
        jnp.asarray(_u32(table).copy()), kj[:, 0], kj[:, 1],
        jnp.asarray(ops_np), jnp.asarray(valid_np, jnp.uint32))
    ok_want = torch.from_numpy(np.asarray(ok_want).astype(bool))
    t_want = torch.from_numpy(np.asarray(t_want).view(np.int32).copy())

    def multisets(t):
        tags = TL.unpack_words(TL.gather_bucket_words(
            t, torch.arange(tcfg.num_buckets), tcfg.layout), tcfg.fp_bits)
        assert int((tags != 0).sum(-1).max()) < tcfg.bucket_size  # none full
        return torch.sort(tags, dim=-1).values

    assert torch.equal(ok_route, ok_batch) and torch.equal(ok_batch, ok_want)
    assert torch.equal(multisets(t_route), multisets(t_batch))
    assert torch.equal(multisets(t_batch), multisets(t_want))
    repeated = len(set(key_values(keys[valid]).tolist())) < int(valid.sum())
    assert repeated == (kind != "distinct")


def test_wrappers_raise_on_what_kernels_do_not_take():
    cfg = convert.config_from_reference(_cfg(16, 16, "xor", "fmix32"))
    state = cfg.init("cpu")
    keys = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.cuckoo_query(cfg, state, keys.to(torch.int64))
    with pytest.raises(ValueError):
        K.cuckoo_query(cfg, state, torch.zeros((8, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.hash64(torch.zeros((2, 8), dtype=torch.int32).t())  # not contiguous
    with pytest.raises(ValueError):
        K.cuckoo_query(cfg, state._replace(table=state.table[:-1]), keys)
    with pytest.raises(ValueError):                              # wrong device
        K.hash64(keys.to("meta"))
    with pytest.raises(ValueError):
        K.cuckoo_insert_direct(cfg, state, keys, valid=torch.ones(7, dtype=torch.bool))
    with pytest.raises(ValueError):
        K.cuckoo_insert_bulk(cfg, state, keys, valid=torch.ones(9, dtype=torch.bool))
    with pytest.raises(TypeError):
        K.cuckoo_insert_bulk(cfg, state, keys.to(torch.int64))
    with pytest.raises(TypeError):
        K.cuckoo_apply_ops(cfg, state, keys, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.hash64(keys, kind="sha1")


def test_cpu_route_counts_no_launch():
    K.reset_launches()
    cfg = convert.config_from_reference(_cfg(8, 16, "xor", "fmix32"))
    state = cfg.init("cpu")
    keys = _t(keys_from_numpy(_raw(np.random.default_rng(5), 32)))
    K.hash64(keys)
    state, _ = K.cuckoo_insert_direct(cfg, state, keys)
    state, _ = K.cuckoo_insert_direct(cfg, state, keys, fused=False)
    state, _ = K.cuckoo_insert_bulk(cfg, state, keys)
    K.cuckoo_query(cfg, state, keys)
    K.cuckoo_query(cfg, state, keys, fused=False)
    K.cuckoo_apply_ops(cfg, state, keys, torch.full((32,), 2, dtype=torch.int32))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


def test_roofline_bytes_model():
    cfg = convert.config_from_reference(CuckooConfig(num_buckets=1 << 24))
    n = 1 << 24
    per_key = roofline.min_batch_bytes(cfg, "query", n)
    assert per_key == n * (8 + 1 + 2 * 32)
    # Resident: each touched bucket (32 bytes) read once and written once;
    # n uniform keys into n buckets touch 1 - 1/e of them.
    resident = roofline.min_batch_bytes(cfg, "insert", n, table_resident=True)
    touched = roofline.expected_buckets(cfg.num_buckets, n)
    assert touched == pytest.approx((1 - math.exp(-1)) * n, rel=1e-6)
    assert resident == n * 9 + 2 * 32 * touched
    assert roofline.least_batch_bytes(cfg, "hash", n) == n * 16
    assert roofline.least_batch_bytes(cfg, "delete", n) == min(
        n * (9 + 64 + 4), resident)
    # A query reads both buckets of every key and writes nothing.
    assert roofline.min_batch_bytes(cfg, "query", n, table_resident=True) \
        == n * 9 + 32 * roofline.expected_buckets(cfg.num_buckets, 2 * n)
    # A batch's own bucket counts replace the expectation; the whole table
    # caps each direction.
    assert roofline.least_batch_bytes(cfg, "insert", n, touched=(10, 4)) \
        == n * 9 + 32 * 14
    assert roofline.min_batch_bytes(
        cfg, "insert", n, table_resident=True, touched=(2 * n, 2 * n)) \
        == n * 9 + 2 * cfg.table_bytes
    with pytest.raises(ValueError):
        roofline.cuckoo_op_traffic(cfg, "scan")


def test_mixed_route_bytes_by_hand():
    """Kernel #7's route floor at 1000 valid ops, 100 of them repeated, on
    fp 16 x bucket 16 (32-byte buckets), 700 buckets read and 600 written:
    the scratch table is 2048 slots."""
    cfg = convert.config_from_reference(CuckooConfig(num_buckets=1 << 10))
    mark, apply, compact = 13 + 1 + 16, 3 + 16 + 2, 1
    walk = 16 + 8 + 32 + 16 + 12 + 8 + 1
    assert roofline.mixed_route_bytes(cfg, 1000, (700, 600), repeated=100) \
        == 1000 * (mark + apply + compact) + 100 * walk + 2048 * 8 \
        + 32 * (700 + 600)


def test_bulk_route_bytes_by_hand():
    """Kernel #6's windowed route floor at 1000 keys on fp 16 x bucket 16
    (32-byte buckets, a 32 KiB table of 2^10 buckets), 600 buckets
    written: count 9, scatter 19, insert 9, un-permute 4 bytes a key, the
    table read once, the written buckets once."""
    cfg = convert.config_from_reference(CuckooConfig(num_buckets=1 << 10))
    assert roofline.bulk_route_bytes(cfg, 1000, 600) == (
        1000 * (9 + 19 + 9 + 4) + 32 * 1024 + 32 * 600)


_L2 = 50 << 20
_MAIN = CuckooConfig(num_buckets=1 << 24)      # fp 16 x bucket 16: 512 MiB
_AT = int(np.ceil(BULK.WINDOWED_KEYS_PER_BUCKET * (1 << 24)))


# (config, n, L2 bytes, (windowed, log2 of a window's buckets, windows)):
# kernel #6's route rule (kernels/cuckoo_insert_bulk.py: bulk_plan) on an
# H100's 50 MiB L2 unless said. A window is the largest power of two of
# buckets in a fifth of the L2 (2^18 buckets of 32 bytes); the windowed
# route needs a table larger than the L2, at most 256 windows and
# WINDOWED_KEYS_PER_BUCKET keys a bucket.
BULK_ROUTES = [
    pytest.param(_MAIN, 1 << 24, _L2, (True, 18, 64), id="main-path-windowed"),
    pytest.param(_MAIN, 1 << 27, _L2, (True, 18, 64),
                 id="long-segments-windowed"),
    pytest.param(_MAIN, _AT, _L2, (True, 18, 64), id="crossover-windowed"),
    pytest.param(_MAIN, _AT - 1, _L2, (False, 18, 64),
                 id="crossover-less-one-one-window"),
    pytest.param(CuckooConfig(num_buckets=1 << 20), 1 << 24, _L2,
                 (False, 18, 4), id="table-in-l2-one-window"),
    pytest.param(CuckooConfig(num_buckets=1 << 27), 1 << 30, _L2,
                 (False, 18, 512), id="too-many-windows-one-window"),
    pytest.param(_MAIN, 1 << 31, _L2, (False, 18, 64),
                 id="n-past-int32-one-window"),
    pytest.param(CuckooConfig(num_buckets=(1 << 24) - 3, policy="offset"),
                 1 << 24, _L2, (True, 18, 64), id="offset-windowed"),
    pytest.param(CuckooConfig(num_buckets=1 << 24, fp_bits=8, bucket_size=4),
                 1 << 24, _L2, (True, 21, 8), id="4-byte-buckets-windowed"),
    pytest.param(_MAIN, 1 << 24, 6 << 20, (False, 15, 512),
                 id="small-l2-too-many-windows-one-window"),
]


@pytest.mark.parametrize("config,n,l2,want", BULK_ROUTES)
def test_bulk_route_rule(config, n, l2, want):
    cfg = convert.config_from_reference(config)
    plan = BULK.bulk_plan(cfg, n, l2)
    assert tuple(plan) == want
    windowed, s, windows = want
    # What cuckoo_insert_bulk_launch accepts: the windows cover the table
    # and the last is not empty; a window stays within the L2's share.
    assert (windows - 1) << s < cfg.num_buckets <= windows << s
    assert (4 * cfg.layout.words_per_bucket << s) <= l2 * WINDOW_L2_SHARE
    if windowed:
        assert cfg.table_bytes > l2 and windows <= BULK.MAX_WINDOWS
        assert n >= BULK.WINDOWED_KEYS_PER_BUCKET * cfg.num_buckets


@pytest.mark.parametrize("hash_kind,want", [
    ("fmix32", {"hash": 32, "query": 32 + 8 + 48, "insert": 32 + 8 + 24}),
    ("xxhash64", {"hash": 15, "query": 15 + 8 + 48, "delete": 15 + 8 + 24}),
])
def test_roofline_int_ops_floor(hash_kind, want):
    # fp 16 x bucket 16: 8 words a bucket, 3 SWAR instructions a word.
    cfg = convert.config_from_reference(
        CuckooConfig(num_buckets=1 << 10, hash_kind=hash_kind))
    for op, ops in want.items():
        assert roofline.int_ops_per_key(cfg, op) == ops
    assert roofline.int32_ops_per_s(132, 1.98e9) == 132 * 64 * 1.98e9
    with pytest.raises(ValueError):
        roofline.int_ops_per_key(cfg, "orient_bulk_insert")


def test_build_dir_is_the_checkout_or_the_override(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    src = Path(build.__file__).resolve().parents[2]
    assert build.build_dir() == src.parent / "build" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert build.build_dir() == tmp_path
    assert build._lib_path("hash64").parent == tmp_path
