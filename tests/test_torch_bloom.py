"""The port's blocked Bloom filter vs the JAX package's, bit-exact.

``_bit_positions``, ``insert`` and ``query`` of ``filters.blocked_bloom``
are deterministic in both packages (tolerance 0) for both hash kinds; the
plain ``scatter_or`` merges duplicate addresses as JAX's segmented OR-scan
does; ``kernels.ops.bloom_insert`` / ``bloom_query`` (the plain versions
of kernels #9 and #8 on CPU tensors) equal the JAX wrappers, which run
``bloom_insert_pallas`` / ``bloom_query_pallas`` in interpret mode, and
the oracles of ``kernels/ref.py``. The plain insert, which the card holds
kernel #9 against, equals the JAX insert and ``bloom_insert_pallas`` on
adversarial inputs too: few blocks and duplicate keys, 12, 64 and 128
words a block, k of 11, 16 and 20, a partial ``valid`` and a table that
already holds keys. ``make("bloom", device="cpu")`` keeps
the JAX backend's config fingerprint and conformance (no false
negatives, FPR band, no delete), and a JAX table carried across through
``convert`` gives the same answers. Kernel #8's route rule (which
batches the card answers window by window) is held to its cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro.core import keys_from_numpy
from repro.filters import blocked_bloom as RB
from repro.filters import common as RC
from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro.kernels.bloom import bloom_insert_pallas
from repro.kernels import roofline as RR
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.filters import blocked_bloom as TB
from repro_torch.filters import common as TC
from repro_torch.kernels import bloom as TKB
from repro_torch.kernels import ops as K
from repro_torch.kernels.bloom import bloom_insert_plain
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import roofline

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them, and each compile takes about a
# fifth less time.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

CAPACITY = 2000

# The JAX filter's ops, jitted once per config (its OR-scatter's
# associative scan takes tens of seconds op by op).
_J_INSERT = jax.jit(RB.insert, static_argnums=0, compiler_options=_XLA_FAST)
_J_QUERY = jax.jit(RB.query, static_argnums=0, compiler_options=_XLA_FAST)
_J_SCATTER_OR = jax.jit(RC.scatter_or, compiler_options=_XLA_FAST)


def _keys(seed, n):
    raw = np.random.default_rng(seed).integers(0, 2**64, size=n,
                                               dtype=np.uint64)
    return keys_from_numpy(raw)


def _t(keys_np):
    return torch.from_numpy(np.ascontiguousarray(keys_np).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("hash_kind", ["fmix32", "xxhash64"])
def test_bit_positions_insert_query_bit_exact(hash_kind):
    # 4-word blocks and k = 11 exercise the re-mix every 32 // 7 bits.
    for kw in ({}, {"words_per_block": 4, "k": 11}):
        cfg = RB.BloomConfig.for_capacity(CAPACITY, hash_kind=hash_kind,
                                          seed=2**40 + 9, **kw)
        tcfg = convert.bloom_config_from_reference(cfg)
        keys = _keys(1, 2 * CAPACITY)
        for got, want in zip(TB._bit_positions(tcfg, _t(keys)),
                             RB._bit_positions(cfg, jnp.asarray(keys))):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want, np.int64))
        valid = np.random.default_rng(2).random(CAPACITY) < 0.9
        sj, okj = _J_INSERT(cfg, cfg.init(), jnp.asarray(keys[:CAPACITY]),
                            jnp.asarray(valid))
        st, okt = TB.insert(tcfg, tcfg.init("cpu"), _t(keys[:CAPACITY]),
                            torch.from_numpy(valid))
        np.testing.assert_array_equal(_u32(st.table), np.asarray(sj.table))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        assert int(st.count) == int(sj.count) == int(valid.sum())
        np.testing.assert_array_equal(
            TB.query(tcfg, st, _t(keys)).numpy(),
            np.asarray(_J_QUERY(cfg, sj, jnp.asarray(keys))))


def test_scatter_or_bit_exact():
    rng = np.random.default_rng(3)
    table = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    addr = rng.integers(0, 64, size=1000).astype(np.int32)   # duplicates
    val = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    val[::2] = np.uint32(1) << rng.integers(0, 32, size=500).astype(np.uint32)
    val[::9] = 0
    for valid in (None, rng.random(1000) < 0.7):
        want = _J_SCATTER_OR(jnp.asarray(table), jnp.asarray(addr),
                             jnp.asarray(val),
                             None if valid is None else jnp.asarray(valid))
        got = TC.scatter_or(torch.from_numpy(table.view(np.int32).copy()),
                            torch.from_numpy(addr).long(),
                            torch.from_numpy(val.astype(np.int64)),
                            None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_ops_match_the_pallas_kernels_and_oracles():
    cfg = RB.BloomConfig.for_capacity(CAPACITY, hash_kind="xxhash64", seed=5)
    tcfg = convert.bloom_config_from_reference(cfg)
    keys = _keys(4, CAPACITY - 13)                  # not a block multiple
    sj, okj = ROPS.bloom_insert(cfg, cfg.init(), jnp.asarray(keys))
    K.reset_launches()
    st, okt = K.bloom_insert(tcfg, tcfg.init("cpu"), _t(keys))
    np.testing.assert_array_equal(_u32(st.table), np.asarray(sj.table))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert int(st.count) == int(sj.count) == keys.shape[0]
    probe = np.concatenate([keys[:500], _keys(5, 1500)])
    hj = np.asarray(ROPS.bloom_query(cfg, sj, jnp.asarray(probe)))
    np.testing.assert_array_equal(K.bloom_query(tcfg, st, _t(probe)).numpy(),
                                  hj)
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)       # CPU: plain only
    lo, hi = _t(probe)[:, 0], _t(probe)[:, 1]
    np.testing.assert_array_equal(
        TREF.bloom_query_ref(tcfg, st.table, lo, hi).numpy(),
        np.asarray(RREF.bloom_query_ref(cfg, sj.table, jnp.asarray(probe[:, 0]),
                                        jnp.asarray(probe[:, 1]))).astype(bool))
    empty = tcfg.init("cpu").table
    np.testing.assert_array_equal(
        _u32(TREF.bloom_insert_ref(tcfg, empty, _t(keys)[:, 0],
                                   _t(keys)[:, 1])), np.asarray(sj.table))
    assert not empty.any()                          # the oracle copies


# (config fields, keys, distinct keys among them, valid: None for all,
# a fraction for a seeded random mask, a negative count for the last keys
# False, prefilled table). Sizes are multiples of the Pallas kernel's
# 256-key grid step.
ADVERSARIAL = {
    "few_blocks_dups": (dict(num_blocks=3), 512, 40, 0.8, False),
    "wpb12_tail_false": (dict(num_blocks=190, words_per_block=12), 512,
                         512, -37, False),
    "wpb64_few_blocks": (dict(num_blocks=5, words_per_block=64,
                              hash_kind="xxhash64"), 512, 100, 0.7, False),
    "k16_prefilled": (dict(num_blocks=64, k=16, hash_kind="xxhash64"), 256,
                      256, 0.9, True),
    "wpb12_k11_prefilled": (dict(num_blocks=7, words_per_block=12, k=11),
                            256, 64, -5, True),
    "wpb128_k20": (dict(num_blocks=4, words_per_block=128, k=20), 256, 256,
                   None, False),
}
_J_PALLAS_INSERT = jax.jit(bloom_insert_pallas, static_argnums=0,
                           static_argnames=("block_keys", "interpret"),
                           compiler_options=_XLA_FAST)


@pytest.mark.parametrize("case", list(ADVERSARIAL))
def test_plain_insert_on_adversarial_inputs(case):
    fields, n, distinct, valid_kind, prefilled = ADVERSARIAL[case]
    cfg = RB.BloomConfig(seed=2**33 + 17, **fields)
    tcfg = convert.bloom_config_from_reference(cfg)
    rng = np.random.default_rng(11)
    keys = _keys(12, distinct)[rng.integers(0, distinct, size=n)]
    if valid_kind is None:
        valid = np.ones(n, bool)
    elif valid_kind < 0:
        valid = np.arange(n) < n + valid_kind
    else:
        valid = rng.random(n) < valid_kind
    start = cfg.init()
    if prefilled:
        start, _ = _J_INSERT(cfg, start, jnp.asarray(_keys(13, 300)), None)
    table0 = np.asarray(start.table)
    sj, _ = _J_INSERT(cfg, start, jnp.asarray(keys), jnp.asarray(valid))
    want = np.asarray(sj.table)
    assert (want != table0).any()
    pallas = _J_PALLAS_INSERT(cfg, jnp.asarray(table0), jnp.asarray(keys[:, 0]),
                              jnp.asarray(keys[:, 1]),
                              jnp.asarray(valid.astype(np.uint32)),
                              block_keys=256, interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), want)
    table = torch.from_numpy(table0.view(np.int32).copy())
    bloom_insert_plain(tcfg, table, _t(keys), torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(table), want)
    state = TB.BloomState(torch.from_numpy(table0.view(np.int32).copy()),
                          torch.zeros((), dtype=torch.int32))
    st, ok = K.bloom_insert(tcfg, state, _t(keys), torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(st.table), want)
    np.testing.assert_array_equal(ok.numpy(), valid)
    assert int(st.count) == int(valid.sum())


def test_make_bloom_conformance():
    ref = ramq.make("bloom", capacity=CAPACITY)
    port = tamq.make("bloom", capacity=CAPACITY, device="cpu")
    assert repr(port.config) == repr(ref.config)
    assert port.table_bytes == ref.table_bytes
    caps = port.capabilities
    assert not (caps.supports_delete or caps.counting or caps.supports_bulk)
    raw = np.random.default_rng(6).integers(0, 2**63, size=CAPACITY,
                                            dtype=np.uint64)
    rep = port.insert(raw)
    assert bool(rep.ok.all()) and not rep.evictions.any()
    np.testing.assert_array_equal(rep.ok.numpy(),
                                  np.asarray(ref.insert(raw).ok))
    np.testing.assert_array_equal(_u32(port.state.table),
                                  np.asarray(ref.state.table))
    assert port.count() == ref.count() == CAPACITY
    assert bool(port.query(raw).hits.all())             # no false negative
    fresh = np.random.default_rng(7).integers(0, 2**63, size=1 << 14,
                                              dtype=np.uint64) | np.uint64(1 << 63)
    fpr = float(port.query(fresh).hits.float().mean())
    lo, hi = tamq.fpr_tolerance(port.expected_fpr(), fresh.shape[0])
    assert lo <= fpr <= hi
    assert port.expected_fpr() == pytest.approx(ref.expected_fpr())
    with pytest.raises(NotImplementedError, match="append-only"):
        port.delete(raw[:10])
    with pytest.raises(NotImplementedError):
        port.insert(raw, bulk=True)


def test_jax_table_carried_across_gives_the_same_answers():
    ref = ramq.make("bloom", capacity=CAPACITY, hash_kind="xxhash64")
    raw = np.random.default_rng(8).integers(0, 2**63, size=CAPACITY,
                                            dtype=np.uint64)
    ref.insert(raw)
    arrays = {"table": np.asarray(ref.state.table),
              "count": np.asarray(ref.state.count)}
    state = convert.bloom_state_from_numpy(arrays, "cpu")
    port = tamq.make("bloom", config=convert.bloom_config_from_reference(
        ref.config), state=state)
    assert port.count() == ref.count()
    probe = np.concatenate([raw[:500], np.random.default_rng(9).integers(
        0, 2**63, size=3000, dtype=np.uint64) | np.uint64(1 << 63)])
    valid = np.random.default_rng(10).random(probe.shape[0]) < 0.9
    np.testing.assert_array_equal(
        port.query(probe, valid=valid).hits.numpy(),
        np.asarray(ref.query(probe, valid=valid).hits))
    back = convert.state_to_numpy(port.state)
    np.testing.assert_array_equal(back["table"], arrays["table"])


# (config, n, L2 bytes, (windowed, log2 of a window's blocks, windows)):
# kernel #8's route rule (kernels/bloom.py: query_plan) on an H100's 50
# MiB L2 unless said. A window is the largest power of two of blocks in a
# fifth of the L2 (2^17 blocks of 64 bytes); the windowed route needs 16
# to 256 windows (a window a thread of the tile's counters) and 12 keys a
# block.
_L2 = 50 << 20
_CASE_STUDY = TB.BloomConfig.for_capacity(234_375_958)
ROUTES = [
    pytest.param(_CASE_STUDY, 248_956_392, _L2, (True, 17, 56),
                 id="case-study-windowed"),
    pytest.param(_CASE_STUDY, 1 << 24, _L2, (False, 17, 56),
                 id="case-study-few-keys-direct"),
    pytest.param(TB.BloomConfig(num_blocks=1 << 18), 1 << 24, _L2,
                 (False, 17, 2), id="table-in-l2-direct"),
    pytest.param(TB.BloomConfig(num_blocks=1 << 21), 12 << 21, _L2,
                 (True, 17, 16), id="crossover-windowed"),
    pytest.param(TB.BloomConfig(num_blocks=1 << 21), (12 << 21) - 1, _L2,
                 (False, 17, 16), id="crossover-less-one-direct"),
    pytest.param(TB.BloomConfig(num_blocks=1 << 20), 1 << 30, _L2,
                 (False, 17, 8), id="eight-windows-direct"),
    pytest.param(TB.BloomConfig(num_blocks=1 << 25), (1 << 31) - 1, _L2,
                 (True, 17, 256), id="most-windows-windowed"),
    pytest.param(TB.BloomConfig(num_blocks=1 << 25), 1 << 31, _L2,
                 (False, 17, 256), id="n-past-int32-direct"),
    pytest.param(TB.BloomConfig(num_blocks=(1 << 25) + 1), (1 << 31) - 1,
                 _L2, (False, 17, 257), id="too-many-windows-direct"),
    pytest.param(_CASE_STUDY, 248_956_392, 6 << 20, (False, 14, 448),
                 id="small-l2-too-many-windows-direct"),
    pytest.param(TB.BloomConfig(num_blocks=3_000_000, words_per_block=12),
                 48_000_000, _L2, (True, 17, 23), id="48-byte-blocks-windowed"),
    pytest.param(TB.BloomConfig(num_blocks=1 << 20, words_per_block=1),
                 1 << 28, _L2, (False, 21, 1), id="4-byte-blocks-one-window"),
]


@pytest.mark.parametrize("config,n,l2,want", ROUTES)
def test_query_route_rule(config, n, l2, want):
    plan = TKB.query_plan(config, n, l2)
    assert tuple(plan) == want
    windowed, s, windows = want
    # What bloom_query_windowed_launch accepts: the windows cover the table
    # and the last is not empty; a window stays within the L2's share.
    assert (windows - 1) << s < config.num_blocks <= windows << s
    assert (4 * config.words_per_block << s) <= l2 * TKB.WINDOW_L2_SHARE
    if windowed:
        assert TKB.MIN_WINDOWS <= windows <= TKB.MAX_WINDOWS
        assert n >= TKB.WINDOWED_KEYS_PER_BLOCK * config.num_blocks


def test_roofline_bloom_and_kmer():
    cfg = RB.BloomConfig.for_capacity(1 << 20)
    tcfg = convert.bloom_config_from_reference(cfg)
    for op in ("query", "insert"):
        got = roofline.bloom_op_traffic(tcfg, op)
        want = RR.bloom_op_traffic(cfg, op)
        assert (got.stream_read, got.table_read, got.table_write) == (
            want.stream_read, want.table_read, want.table_write)
        assert (got.stream_write, want.stream_write) == (1, 4)
        n = 1 << 20
        per_key = got.batch_bytes(n)
        # Touched blocks: each charged once, never more than the table.
        assert roofline.bloom_batch_bytes(tcfg, op, n, touched=10) < per_key
        whole = roofline.bloom_batch_bytes(tcfg, op, n,
                                           touched=10 * tcfg.num_blocks)
        assert whole == n * 9 + tcfg.table_bytes * (2 if op == "insert" else 1)
        assert roofline.bloom_batch_bytes(tcfg, op, 1) == got.batch_bytes(1)
    with pytest.raises(ValueError):
        roofline.bloom_op_traffic(tcfg, "delete")
    # fmix32 pair (32) + 8 bits x 4 + two re-mixes x 9.
    assert roofline.bloom_int_ops_per_key(tcfg) == 32 + 32 + 18
    # The windowed query route streams 39 bytes a key and reads the table
    # once.
    assert roofline.bloom_windowed_bytes(tcfg, 1000) == (
        39 * 1000 + tcfg.table_bytes)
    # A rolling pack: three instructions a code, whatever k is.
    assert roofline.kmer_pack_int_ops(100) == 300
    assert roofline.kmer_pack_bytes(100, 31) == 100 + 8 * 70
