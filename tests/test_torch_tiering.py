"""The port's GPU-hot / host-cold tiered handle vs the JAX package's
(DESIGN.md §12), on the CPU.

* The cold tier's host probes: the port's ``host_query`` and
  ``host_delete`` equal ``repro``'s on the same snapshot arrays and keys,
  for cuckoo (XOR and offset placement, fmix32 and xxhash64) and Bloom.
* Fixed-seed schedules of insert, query, delete, demote, promote,
  maintain, compact and snapshot against a flat set oracle: no false
  negatives wherever a key's level lives, the FPR inside the budget's
  band, the device footprint under its budget, the count exact.
* A tiered snapshot crosses between the packages by file in both
  directions with the same answers.
* Budget validation, tier-surgery guards, a Bloom tier without delete,
  and ``stats()["tiers"]`` from the service.
"""

import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro.core import keys_from_numpy as r_pairs
from repro_torch import amq as tamq

torch.set_num_threads(1)

CAPACITY = 256
BUDGET = 8 * 1024                 # a few small levels' worth of device RAM
UNIVERSE = 2048
N_NEG = 2048
ACTIONS = ("insert", "insert", "insert", "delete", "demote", "promote",
           "maintain", "compact", "snapshot")


def _raw(seed, n):
    rng = np.random.default_rng(seed)
    raw = np.unique(rng.integers(1, 2**63, size=2 * n, dtype=np.uint64))[:n]
    assert raw.size == n
    return raw


KEYS = _raw(0, UNIVERSE + N_NEG)
POS, NEG = KEYS[:UNIVERSE], KEYS[UNIVERSE:]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mk(name="cuckoo", **kw):
    kw.setdefault("device_budget_bytes", BUDGET)
    return tamq.make(name, capacity=CAPACITY, tiered=True, device="cpu",
                     **kw)


@pytest.mark.parametrize("name,kw", [
    ("cuckoo", {}),
    ("cuckoo", {"hash_kind": "xxhash64"}),
    ("cuckoo", {"policy": "offset"}),
    ("cuckoo", {"policy": "offset", "hash_kind": "xxhash64", "fp_bits": 8}),
    ("bloom", {}),
])
def test_host_probes_match_reference(name, kw):
    h = tamq.make(name, capacity=1000, device="cpu", **kw)
    assert bool(h.insert(POS[:700]).ok.all())
    arrays = h.snapshot().arrays
    adapter, r_adapter = tamq.get(name), ramq.get(name)
    r_cfg = r_adapter.make_config(1000, **kw)
    assert repr(r_cfg) == repr(h.config)
    probe = np.concatenate([POS[:1000], NEG[:1000]])
    got = adapter.host_query(h.config, arrays, probe, device="cpu")
    want = r_adapter.host_query(r_cfg, arrays, r_pairs(probe))
    assert got[:700].all()
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, _np(h.query(probe).hits))
    if adapter.host_delete is None:
        return
    # Deletes with a key twice (two copies stored) and keys never stored.
    rng = np.random.default_rng(1)
    dels = np.concatenate([POS[:50], POS[:20], NEG[:30]])
    valid = rng.random(dels.size) < 0.9
    h.insert(POS[:20])
    a_port = {k: v.copy() for k, v in h.snapshot().arrays.items()}
    a_ref = {k: v.copy() for k, v in a_port.items()}
    ok = adapter.host_delete(h.config, a_port, dels, valid, device="cpu")
    r_ok = r_adapter.host_delete(r_cfg, a_ref, r_pairs(dels), valid)
    assert np.array_equal(ok, np.asarray(r_ok))
    assert ok[:70][valid[:70]].all()
    for k in a_port:
        assert np.array_equal(a_port[k], a_ref[k]), k
    # And the port's device delete on the same keys agrees.
    assert np.array_equal(ok, _np(h.delete(dels, valid=torch.from_numpy(
        valid)).ok))
    assert h.count() == int(a_port["count"])


def _check_invariants(h, live):
    hits = _np(h.query(POS).hits)
    assert not (live & ~hits).any(), h.tier_stats()
    _, hi = tamq.fpr_tolerance(h.fpr_budget, N_NEG)
    assert _np(h.query(NEG).hits).mean() <= hi
    assert h.device_bytes <= h.device_budget_bytes


@pytest.mark.parametrize("seed", range(4))
def test_schedule_matches_flat_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    h = _mk()
    live = np.zeros(UNIVERSE, bool)
    for _ in range(10):
        action = ACTIONS[rng.integers(len(ACTIONS))]
        if action == "insert":
            idx = np.flatnonzero(~live)[:int(rng.integers(1, 500))]
            if idx.size:
                assert _np(h.insert(POS[idx]).ok).all()
                live[idx] = True
        elif action == "delete":
            idx = np.flatnonzero(live)[:int(rng.integers(1, 200))]
            if idx.size:
                assert _np(h.delete(POS[idx]).ok).all()
                live[idx] = False
        elif action == "demote":
            before = len(h.hot.levels)
            assert (h.demote() is None) == (before <= 1)
        elif action == "promote":
            if h.promote(force=bool(rng.integers(2))):
                assert not h.cold or (
                    h.cold[-1].alloc_id < h.hot.level_alloc_ids[0])
            while h.maintain()["action"] == "demote":
                pass
        elif action == "maintain":
            for _ in range(8):
                if h.maintain()["action"] == "none":
                    break
        elif action == "compact":
            h.compact()
            assert all(c.count > 0 for c in h.cold)
        else:
            h = _mk(snapshot=h.snapshot())
        _check_invariants(h, live)
    assert h.count() == int(live.sum())


def test_beyond_budget_and_mixed_ops_across_tiers():
    h = _mk()
    assert _np(h.insert(POS).ok).all()
    assert h.table_bytes > h.device_budget_bytes and len(h.cold) >= 1
    assert h.device_bytes <= h.device_budget_bytes
    assert _np(h.query(POS).hits).all()
    # The oldest keys live in the cold tier: query, delete, query again.
    probe = np.repeat(POS[:16], 3)
    ops = np.array([tamq.OP_QUERY, tamq.OP_DELETE, tamq.OP_QUERY] * 16,
                   np.int32)
    ok = _np(h.apply_ops(tamq.OpBatch.make(probe, ops)).ok).reshape(16, 3)
    assert ok[:, 0].all() and ok[:, 1].all() and not ok[:, 2].any()
    stats = h.tier_stats()
    assert stats["cold_probe_keys"] > 0 and stats["cold_hits"] > 0
    assert h.report().cold_probes == stats["cold_probes"]


def test_tiered_snapshot_crosses_by_file(tmp_path):
    h = _mk()
    assert _np(h.insert(POS[:1500]).ok).all()
    h.delete(POS[:10])                 # a cold delete
    probe = np.concatenate([POS, NEG])
    want = _np(h.query(probe).hits)
    tamq.save_snapshot(tmp_path / "port.npz", h.snapshot())
    r = ramq.make("cuckoo", capacity=CAPACITY, tiered=True,
                  snapshot=ramq.load_snapshot(tmp_path / "port.npz"))
    assert r.device_budget_bytes == BUDGET
    assert (len(r.cold), len(r.hot.levels)) == (len(h.cold), len(h.hot.levels))
    assert r.count() == h.count()
    assert np.array_equal(_np(r.query(probe).hits), want)
    ramq.save_snapshot(tmp_path / "repro.npz", r.snapshot())
    back = _mk(snapshot=tamq.load_snapshot(tmp_path / "repro.npz"))
    assert back.count() == h.count()
    assert np.array_equal(_np(back.query(probe).hits), want)
    # The budget may come from the snapshot; a different one is refused.
    twin = tamq.make("cuckoo", capacity=CAPACITY, tiered=True, device="cpu",
                     snapshot=tamq.load_snapshot(tmp_path / "repro.npz"))
    assert twin.device_budget_bytes == BUDGET
    with pytest.raises(tamq.SnapshotMismatchError):
        _mk(device_budget_bytes=2 * BUDGET).restore(back.snapshot())
    with pytest.raises(tamq.SnapshotMismatchError):
        tamq.make("cuckoo", capacity=CAPACITY, auto_expand=True,
                  device="cpu").restore(back.snapshot())
    # A snapshot never shares a buffer with the live cold tier.
    snap = back.snapshot()
    kept = {k: v.copy() for k, v in snap.arrays.items()}
    back.delete(POS[10:40])
    for k in kept:
        assert np.array_equal(kept[k], snap.arrays[k]), k


def test_budget_validation():
    with pytest.raises(ValueError):
        _mk(device_budget_bytes=0)
    with pytest.raises(ValueError):
        tamq.make("cuckoo", capacity=1 << 16, tiered=True, device="cpu",
                  device_budget_bytes=16)
    with pytest.raises(TypeError):
        tamq.make("cuckoo", capacity=CAPACITY, tiered=True, device="cpu")
    with pytest.raises(TypeError):
        _mk(auto_expand=True)
    with pytest.raises(NotImplementedError):
        tamq.make("cpu-cuckoo", capacity=CAPACITY, tiered=True,
                  device_budget_bytes=BUDGET)
    # The clamp is the JAX package's.
    assert (_mk().hot.max_level_capacity
            == ramq.make("cuckoo", capacity=CAPACITY, tiered=True,
                         device_budget_bytes=BUDGET).hot.max_level_capacity)


def test_tier_surgery_guards():
    h = _mk()
    with pytest.raises(ValueError):
        h.hot.detach_oldest()
    assert h.demote() is None and not h.promote()
    h.insert(POS)
    h.promote(force=True)
    lvl, share, aid = h.hot.detach_oldest()
    with pytest.raises(ValueError):
        h.hot.attach_oldest(lvl, share, aid + 10_000)
    h.hot.attach_oldest(lvl, share, aid)
    while h.maintain()["action"] == "demote":
        pass
    assert h.device_bytes <= h.device_budget_bytes
    assert _np(h.query(POS).hits).all()


def test_bloom_tiers_without_delete():
    h = _mk("bloom", device_budget_bytes=BUDGET // 4)
    assert _np(h.insert(POS).ok).all()
    assert h.device_bytes <= h.device_budget_bytes and h.cold
    assert _np(h.query(POS).hits).all()
    with pytest.raises(NotImplementedError):
        h.delete(POS[:4])


def test_service_surfaces_tier_stats():
    svc = tamq.FilterService(_mk(), batch_size=64)
    t = svc.insert(POS[:1500])
    svc.flush()
    assert t.result().all()
    stats = svc.stats()
    assert stats["tiers"]["device_budget_bytes"] == BUDGET
    assert stats["tiers"]["demotions"] >= 1
    q = svc.query(POS[:1500])
    assert q.result().all()
    assert svc.stats()["tiers"]["cold_probe_keys"] > 0
