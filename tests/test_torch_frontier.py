"""The port's batched BFS frontier engine vs the JAX package's, bit-exact.

``_resolve_claims_multi`` (the K-column claim election) and
``_insert_frontier`` are deterministic in both packages, so the same keys,
made from a seed with numpy, must give the same table, ``ok`` and every
``InsertStats`` field (tolerance 0; ``load`` within one float32 ulp, where
XLA divides through the reciprocal). The cells are those of
``tests/test_insert_engines.py`` (64 buckets, ``max_evictions`` 256).

The reference's fault R1 is pinned as its own case: at cell (4, 16, 0.95)
with seed 12920 the legacy round loop's expiry drops the victim tag it
holds, so a key accepted earlier becomes a false negative. Both packages
do it alike, under ``insert`` with the default engine (``auto``, the
frontier, whose stragglers reach the loop) and under ``legacy``; what
holds for every engine is that the false negatives among accepted keys
are at most ``stats.failed``, and none where nothing failed.

The ``cuckoo`` adapter's kernel routes (the direct-insert kernel's plain
version, then the frontier — under ``insert_engine="frontier"`` — or the
round loop — under ``auto`` — on its residue) place keys in another order,
so they are held by invariants.
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
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.core import cuckoo_filter as TCF
from repro_torch.core import layout as TL
from repro_torch.core.bits64 import from_i32

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them, and each compile takes about a
# fifth less time.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

NUM_BUCKETS = 64

# (bucket_size, fp_bits, load, policy, hash) — cells of
# tests/test_insert_engines.py, across both policies and hashes.
CELLS = [
    (16, 16, 0.95, "xor", "fmix32"),
    (8, 8, 0.95, "offset", "xxhash64"),
    (16, 8, 0.97, "xor", "fmix32"),
]
IDS = [f"b{c[0]}f{c[1]}o{int(c[2] * 100)}{c[3]}" for c in CELLS]
R1 = (4, 16, 0.95, 12920)


def _cfg(bs, fb, policy="xor", hash_kind="fmix32", engine="frontier"):
    nb = NUM_BUCKETS if policy == "xor" else NUM_BUCKETS - 3
    return CuckooConfig(num_buckets=nb, fp_bits=fb, bucket_size=bs,
                        policy=policy, hash_kind=hash_kind,
                        max_evictions=256, insert_engine=engine)


def _keys(seed, n):
    """``tests/test_insert_engines.py``'s keys: n distinct uint64 values."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**64, size=4 * n, dtype=np.uint64)
    return keys_from_numpy(np.unique(raw)[:n])


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg, dedup=False):
    return jax.jit(functools.partial(fn, cfg, dedup_within_batch=dedup),
                   compiler_options=_XLA_FAST)


def _t(keys_np):
    return torch.from_numpy(np.ascontiguousarray(keys_np).view(np.int32))


def _both(jfn, tfn, cfg, keys, valid=None, dedup=False):
    out_j = _jit(jfn, cfg, dedup)(cfg.init(), jnp.asarray(keys),
                                  None if valid is None else jnp.asarray(valid))
    tcfg = convert.config_from_reference(cfg)
    out_t = tfn(tcfg, tcfg.init("cpu"), _t(keys),
                None if valid is None else torch.from_numpy(valid),
                dedup_within_batch=dedup)
    return out_j, out_t


def _assert_same(out_j, out_t):
    (sj, okj, stj), (st, okt, stt) = out_j, out_t
    np.testing.assert_array_equal(st.table.numpy().view(np.uint32),
                                  np.asarray(sj.table))
    assert int(st.count) == int(sj.count)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(stt.evictions.numpy(),
                                  np.asarray(stj.evictions))
    assert int(stt.rounds) == int(stj.rounds)
    assert int(stt.failed) == int(stj.failed)
    assert float(stt.load) == pytest.approx(float(stj.load), rel=2**-23,
                                            abs=0)


def _false_negatives(cfg, state, keys, ok):
    hit = TCF.query(convert.config_from_reference(cfg), state, _t(keys))
    return int((~hit[ok]).sum())


def test_resolve_claims_multi_bit_exact():
    rng = np.random.default_rng(0)
    for n, k, invalid in ((300, 3, 40), (1, 4, 7), (64, 1, 64)):
        addrs = rng.integers(0, invalid + 1, size=(n, k)).astype(np.int32)
        want = np.asarray(CF._resolve_claims_multi(jnp.asarray(addrs),
                                                   invalid))
        got = TCF._resolve_claims_multi(torch.from_numpy(addrs).long(),
                                        invalid)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == (n, k)
    # Two columns are the pairwise election, interleaved.
    a = torch.from_numpy(rng.integers(0, 9, size=(50, 2)))
    w1, w2 = TCF._resolve_claims(a[:, 0], a[:, 1], 8)
    assert torch.equal(TCF._resolve_claims_multi(a, 8),
                       torch.stack([w1, w2], dim=1))


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_insert_frontier_bit_exact(cell):
    bs, fb, load, pol, hk = cell
    cfg = _cfg(bs, fb, pol, hk)
    n = int(cfg.num_slots * load)
    keys = _keys(sum(map(ord, pol)) + bs, n)
    valid = dedup = None
    if pol == "offset":        # masked keys and in-batch duplicates
        keys[n // 2:n // 2 + 40] = keys[:40]
        valid = np.random.default_rng(bs).random(n) < 0.9
        dedup = True
    out_j, out_t = _both(CF._insert_frontier, TCF._insert_frontier, cfg,
                         keys, valid, bool(dedup))
    _assert_same(out_j, out_t)
    state, ok, stats = out_t
    assert int(stats.rounds) > 1             # chains ran
    assert int(stats.evictions.max()) >= 1
    if int(stats.failed) == 0:
        assert _false_negatives(cfg, state, keys, ok) == 0


@pytest.mark.parametrize("engine", ["auto", "legacy"])
def test_r1_case_false_negatives_bounded_by_failed(engine):
    """R1 (seed 12920): bit-exact through ``insert`` under ``auto`` (the
    frontier) and ``legacy``; false negatives <= failed."""
    bs, fb, load, seed = R1
    cfg = _cfg(bs, fb, engine=engine)
    assert TCF.resolve_engine(convert.config_from_reference(cfg), False) == (
        "frontier" if engine == "auto" else "legacy")
    keys = _keys(seed, int(NUM_BUCKETS * bs * load))
    out_j, out_t = _both(CF.insert, TCF.insert, cfg, keys)
    _assert_same(out_j, out_t)
    state, ok, stats = out_t
    failed = int(stats.failed)
    assert failed == int((~ok).sum()) == 3
    assert _false_negatives(cfg, state, keys, ok) <= failed


def _adapter_keys():
    bs, fb, load, seed = R1
    n = int(NUM_BUCKETS * bs * load) // 4 * 4
    return np.unique(np.random.default_rng(seed).integers(
        0, 2**64, size=4 * n, dtype=np.uint64))[:n]


@functools.lru_cache(maxsize=None)
def _adapter_reference_ok():
    """JAX ``make("cuckoo")``'s ok over the four batches (its incremental
    ``auto`` is the frontier, so one reference serves both routes)."""
    ref = ramq.make("cuckoo", config=_cfg(R1[0], R1[1], engine="frontier"))
    return np.concatenate([np.asarray(ref.insert(chunk).ok)
                           for chunk in np.split(_adapter_keys(), 4)])


def _adapter_fill(engine):
    """The R1 cell through ``make("cuckoo")`` in four batches: the direct
    kernel's plain version, then the engine ``engine`` routes its residue
    to. Holds the invariants; returns the keys handed to the frontier and
    to the round loop."""
    bs, fb, _, _ = R1
    tcfg = convert.config_from_reference(_cfg(bs, fb, engine=engine))
    raw = _adapter_keys()
    port = tamq.make("cuckoo", config=tcfg, device="cpu")
    ok_port = []
    TCF.FRONTIER_KEYS, TCF.LOOP_KEYS = [], []
    try:
        for chunk in np.split(raw, 4):
            rep = port.insert(chunk)
            ok_port.append(rep.ok.numpy())
            assert int(rep.rounds) >= 1
        handed = (int(sum(TCF.FRONTIER_KEYS)), int(sum(TCF.LOOP_KEYS)))
    finally:
        TCF.FRONTIER_KEYS = TCF.LOOP_KEYS = None
    ok_ref, ok_port = _adapter_reference_ok(), np.concatenate(ok_port)
    assert port.count() == int(ok_port.sum())
    failed = int((~ok_port).sum())
    if ok_ref.all():
        assert ok_port.all()
    hit = port.query(raw[ok_port]).hits
    assert int((~hit).sum()) <= failed       # zero when nothing failed
    tag, i1, i2 = TCF.prepare_keys(tcfg, _t(keys_from_numpy(raw)))
    allowed = (set(zip(i1.tolist(), tag.tolist()))
               | set(zip(i2.tolist(), tag.tolist())))
    tags = TL.unpack_words(from_i32(port.state.table), fb).reshape(
        tcfg.num_buckets, bs)
    b, s = tags.nonzero(as_tuple=True)
    stored = list(zip(b.tolist(), tags[b, s].tolist()))
    assert len(stored) == port.count() and set(stored) <= allowed
    return handed


def test_adapter_frontier_route_holds_invariants():
    """``make("cuckoo", insert_engine="frontier")`` at the R1 cell: the
    direct kernel's plain version, then the frontier on its residue."""
    frontier, _ = _adapter_fill("frontier")
    assert frontier > 0                      # the frontier took a residue


def test_adapter_auto_route_takes_the_loop():
    """Under ``auto`` the adapter hands the direct kernel's residue to the
    round loop, not the frontier (core ``insert`` still routes ``auto`` to
    the frontier, as JAX does)."""
    assert TCF.resolve_engine(
        convert.config_from_reference(_cfg(4, 16, engine="auto")),
        False) == "frontier"
    frontier, loop = _adapter_fill("auto")
    assert frontier == 0 and loop > 0
