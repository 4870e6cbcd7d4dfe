"""The port's auto-expanding cascade vs the JAX package's (DESIGN.md §8).

A port cascade and a ``repro`` cascade fed the same keys (8x the base
capacity, in chunks, from a seed with numpy) grow the same levels: the
same level count, per-level config fingerprints, FPR shares, allocation
ids and counts. Fed with ``bulk=True`` (the orientation build in both
packages, under the watermark's ``valid`` mask) their level tables are
bit-exact. Cascade snapshots cross between the packages by file in both
directions with the same answers. Then the port alone: deletes route to
the newest level holding the key, ``compact`` frees drained levels, the
``valid`` mask, ``apply_ops`` on its single-level fast path and on its
segmented path against a ``cpu-cuckoo`` cascade (the sequential oracle,
same hashes and sizes), ``PrefixCache()`` builds a cascade, and the Bloom
cascade's FPR stays inside its split budget. A GQF and a BCHT cascade
grow ``repro``'s levels and tables; the TCF cannot expand, so
``PrefixCache(backend="tcf")`` guards with a static handle. One JAX
cuckoo cascade is built for the module.
"""

import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro_torch import amq as tamq
from repro_torch.serve import PrefixCache

torch.set_num_threads(1)

CAPACITY = 256          # the base level's capacity
N_PAST = 2048           # 8x the base capacity: three levels, fp 16, 16, 32
CHUNK = 512
N_NEG = 1 << 13


def _raw(seed, n, top=False):
    rng = np.random.default_rng(seed)
    raw = np.unique(rng.integers(1, 2**63, size=2 * n, dtype=np.uint64))[:n]
    assert raw.size == n
    return raw | np.uint64(1 << 63) if top else raw


POS = _raw(0, N_PAST)
NEG = _raw(1, N_NEG, top=True)
PROBE = np.concatenate([POS, NEG[:2048]])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stream(h, keys=POS, **opts):
    return np.concatenate([_np(h.insert(keys[s:s + CHUNK], **opts).ok)
                           for s in range(0, keys.shape[0], CHUNK)])


def _cascade(name="cuckoo", **kw):
    if name != "cpu-cuckoo":
        kw["device"] = "cpu"
    return tamq.make(name, capacity=CAPACITY, auto_expand=True, **kw)


def _structure(h):
    return ([repr(lv.config) for lv in h.levels], h.level_shares,
            h.level_alloc_ids, [lv.count() for lv in h.levels],
            h.fpr_budget)


@pytest.fixture(scope="module")
def ref():
    """The JAX cascade fed POS with bulk=True, its answers on PROBE."""
    h = ramq.make("cuckoo", capacity=CAPACITY, auto_expand=True)
    assert _stream(h, bulk=True).all()
    return h, _np(h.query(PROBE).hits)


@pytest.mark.parametrize("bulk", (True, False))
def test_cascade_matches_reference(ref, bulk):
    r_handle, r_hits = ref
    h = _cascade()
    assert _stream(h, bulk=bulk).all()
    assert len(h.levels) == len(r_handle.levels) == 3
    assert [lv.config.fp_bits for lv in h.levels] == [16, 16, 32]
    assert _structure(h) == _structure(r_handle)
    assert h.count() == N_PAST
    report = h.report()
    for level in report.levels:   # no level past its watermark
        assert level.load_factor <= h.watermark + 1.0 / level.num_slots
    hits = _np(h.query(PROBE).hits)
    assert hits[:N_PAST].all()
    if bulk:
        # The orientation build under the watermark's valid mask leaves
        # the reference's tables word for word.
        for lv, r_lv in zip(h.levels, r_handle.levels):
            assert np.array_equal(lv.state.table.numpy().view(np.uint32),
                                  np.asarray(r_lv.state.table))
        assert np.array_equal(hits, r_hits)
    else:
        # The direct-insert route places keys otherwise: the FPR band.
        _, hi = tamq.fpr_tolerance(report.fpr_budget, N_NEG)
        assert _np(h.query(NEG).hits).mean() <= hi


def test_cascade_snapshot_crosses_by_file(ref, tmp_path):
    r_handle, r_hits = ref
    ramq.save_snapshot(tmp_path / "repro.npz", r_handle.snapshot())
    snap = tamq.load_snapshot(tmp_path / "repro.npz")
    assert snap.kind == "cascade" and not snap.configs
    port = _cascade(snapshot=snap)
    assert _structure(port) == _structure(r_handle)
    assert np.array_equal(_np(port.query(PROBE).hits), r_hits)

    mine = _cascade()
    _stream(mine)
    mine.delete(POS[:300])            # drains part of level 0
    tamq.save_snapshot(tmp_path / "port.npz", mine.snapshot())
    back = ramq.make("cuckoo", capacity=CAPACITY, auto_expand=True,
                     snapshot=ramq.load_snapshot(tmp_path / "port.npz"))
    assert _structure(back) == _structure(mine)
    assert np.array_equal(_np(back.query(PROBE).hits),
                          _np(mine.query(PROBE).hits))
    # Another base capacity replays other level sizes: refused.
    with pytest.raises(tamq.SnapshotMismatchError):
        tamq.make("cuckoo", capacity=2 * CAPACITY, auto_expand=True,
                  device="cpu", snapshot=snap)
    with pytest.raises(tamq.SnapshotMismatchError):
        tamq.make("cuckoo", capacity=CAPACITY, device="cpu", snapshot=snap)


def test_make_arg_errors_and_gating():
    with pytest.raises(TypeError, match="capacity"):
        tamq.make("cuckoo", auto_expand=True, device="cpu")
    with pytest.raises(TypeError, match="config"):
        tamq.make("cuckoo", auto_expand=True, device="cpu",
                  config=tamq.get("cuckoo").make_config(64))
    with pytest.raises(ValueError, match="growth"):
        tamq.make("cuckoo", capacity=64, auto_expand=True, device="cpu",
                  growth=1.0)
    c = _cascade(watermark=0.5, growth=4.0, fp_bits=8)
    assert (c.watermark, c.growth) == (0.5, 4.0)


def test_delete_routes_newest_first_and_compact():
    h = _cascade()
    assert _stream(h).all()
    # A second copy of level 0's first keys lands in the active level.
    dup = POS[:100]
    assert _np(h.insert(dup).ok).all()
    counts = [lv.count() for lv in h.levels]
    assert _np(h.delete(dup).ok).all()
    after = [lv.count() for lv in h.levels]
    assert after[-1] == counts[-1] - 100 and after[:-1] == counts[:-1]
    # Drain level 0 (its keys come first in POS): compact frees it.
    n0 = h.levels[0].count()
    assert _np(h.delete(POS[:n0]).ok).all()
    assert h.levels[0].count() == 0
    report = h.compact()
    assert report.num_levels == 2 and h.level_alloc_ids == (1, 2)
    assert _np(h.query(POS[n0:]).hits).all()
    # A full drain resets to one fresh base-capacity level.
    assert _np(h.delete(POS[n0:]).ok).all()
    assert h.count() == 0
    h.compact()
    assert len(h.levels) == 1 and h.level_alloc_ids == (0,)


def test_valid_mask():
    h = _cascade()
    valid = np.zeros(N_PAST, bool)
    valid[::3] = True
    rep = h.insert(POS, valid=torch.from_numpy(valid))
    assert np.array_equal(_np(rep.ok), valid)
    assert h.count() == valid.sum()
    hits = _np(h.query(POS, valid=torch.from_numpy(valid)).hits)
    assert np.array_equal(hits, valid)


@pytest.mark.parametrize("grown", (False, True))
def test_apply_ops_both_paths(grown):
    """The fast path (one level with headroom) and the segmented path
    (several levels) against the cpu-cuckoo cascade's sequential replay."""
    rng = np.random.default_rng(5 + grown)
    port, oracle = _cascade(), _cascade("cpu-cuckoo")
    if grown:
        for h in (port, oracle):
            assert _stream(h, POS[:1024]).all()
        assert len(port.levels) == 2
    universe = np.concatenate([POS[:64], POS[1500:1564]])
    keys = universe[rng.integers(0, universe.size, size=256)]
    ops = rng.choice(3, size=256, p=[0.4, 0.4, 0.2]).astype(np.int32)
    valid = rng.random(256) < 0.9
    got = port.apply_ops(tamq.OpBatch.make(keys, ops, valid))
    want = oracle.apply_ops(tamq.OpBatch.make(keys, ops, valid))
    assert np.array_equal(_np(got.ok), _np(want.ok))
    assert port.count() == oracle.count()
    assert len(port.levels) == len(oracle.levels)


def test_prefix_cache_builds_a_cascade():
    pc = PrefixCache(2, device="cpu")
    assert isinstance(pc.filter, tamq.CascadeHandle)
    for i in range(4):
        pc.insert([i, i + 1, i + 2], entry=f"e{i}")
    assert pc.lookup([3, 4, 5]) == "e3"
    assert pc.lookup([0, 1, 2]) is None and pc.stats["stale"] == 0


def test_bloom_cascade_fpr_within_split_budget():
    h = _cascade("bloom")
    assert _stream(h).all()
    report = h.report()
    assert report.num_levels > 1
    ref = ramq.make("bloom", capacity=CAPACITY, auto_expand=True)
    assert h.fpr_budget == ref.fpr_budget
    assert repr(h.levels[0].config) == repr(ref.levels[0].config)
    for level in report.levels:
        assert level.expected_fpr <= level.fpr_share * (1 + 1e-9)
    assert report.expected_fpr <= report.fpr_budget * (1 + 1e-9)
    assert _np(h.query(POS).hits).all()
    _, hi = tamq.fpr_tolerance(report.fpr_budget, N_NEG)
    assert _np(h.query(NEG).hits).mean() <= hi
    with pytest.raises(NotImplementedError):
        h.delete(POS[:4])


@pytest.mark.parametrize("name", ("gqf", "bcht"))
def test_baseline_cascade_matches_reference(name):
    """A GQF and a BCHT cascade grow ``repro``'s levels (configs, shares,
    allocation ids, counts) from the same keys, with the same tables word
    for word: both inserts are deterministic in both packages."""
    ref = ramq.make(name, capacity=CAPACITY, auto_expand=True)
    h = _cascade(name)
    keys = POS[:1024]
    want = np.concatenate([_np(ref.insert(keys[s:s + CHUNK]).ok)
                           for s in range(0, keys.size, CHUNK)])
    assert np.array_equal(_stream(h, keys), want)
    assert len(h.levels) > 1 and _structure(h) == _structure(ref)
    for lv, r_lv in zip(h.levels, ref.levels):
        got = tamq.get(name).snapshot(lv.config, lv.state)
        for f, a in got.items():
            assert np.array_equal(a, np.asarray(getattr(r_lv.state, f))), f
    probe = np.concatenate([keys, NEG[:1024]])
    assert np.array_equal(_np(h.query(probe).hits),
                          _np(ref.query(probe).hits))


def test_tcf_cannot_expand_and_guards_statically():
    with pytest.raises(NotImplementedError, match="supports_expand"):
        _cascade("tcf")
    pc = PrefixCache(2, backend="tcf", device="cpu")
    assert isinstance(pc.filter, tamq.FilterHandle) and pc.filter.name == "tcf"
    pc.insert([1, 2, 3], entry="e")
    assert pc.lookup([1, 2, 3]) == "e"
