"""The port's filter-state lifecycle vs the JAX package's (DESIGN.md §10).

For ``cuckoo``, ``bloom``, ``tcf``, ``gqf``, ``bcht`` and ``cpu-cuckoo``
on the CPU (the kernels' plain versions): snapshot / restore is bit-exact and restores in place; a
snapshot of another backend, config fingerprint or kind, and a file of a
future format version, are refused with ``SnapshotMismatchError``; a
``.npz`` written by either package restores on the other, with equal
tables and equal answers on stored and fresh keys; ``hot_swap``'s default
migration loses no acknowledged op; a restored CPU handle owns its table
(the kernels update tables in place, so a shared buffer would let a later
insert rewrite the snapshot). Keys come from a seed with numpy; each JAX
handle is built once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro_torch import amq as tamq

torch.set_num_threads(1)

BACKENDS = ("cuckoo", "bloom", "tcf", "gqf", "bcht", "cpu-cuckoo")
CAPACITY = 1000
N_STORED = 600


def _raw(seed, n):
    rng = np.random.default_rng(seed)
    raw = np.unique(rng.integers(1, 2**63, size=2 * n, dtype=np.uint64))[:n]
    assert raw.size == n
    return raw


STORED = _raw(0, N_STORED)
FRESH = _raw(1, 2000) | np.uint64(1 << 63)
PROBE = np.concatenate([STORED, FRESH])


def _port(name, keys=STORED, **kw):
    h = tamq.make(name, capacity=CAPACITY, device="cpu", **kw)
    assert bool(h.insert(keys).ok.all())
    return h


def _hits(h, keys=PROBE):
    hits = h.query(keys).hits
    return hits.numpy() if isinstance(hits, torch.Tensor) else np.asarray(hits)


def _arrays_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.fixture(scope="module", params=BACKENDS)
def ref(request):
    """(name, the JAX handle holding STORED, its answers on PROBE)."""
    h = ramq.make(request.param, capacity=CAPACITY)
    h.insert(STORED)
    return request.param, h, _hits(h)


@pytest.mark.parametrize("name", BACKENDS)
def test_snapshot_restore_bit_exact(name):
    h = _port(name)
    snap = h.snapshot()
    assert (snap.backend, snap.kind, snap.fingerprint) == (
        name, "filter", repr(h.config))
    want = {"cuckoo": {"table": np.uint32, "count": np.int32},
            "bloom": {"table": np.uint32, "count": np.int32},
            "tcf": {"table": np.uint32, "stash": np.uint32,
                    "count": np.int32},
            "gqf": {"table": np.uint32, "count": np.int32},
            "bcht": {"key_lo": np.uint32, "key_hi": np.uint32,
                     "used": np.bool_, "count": np.int32},
            "cpu-cuckoo": {"buckets": np.uint32, "count": np.int64}}[name]
    assert {k: v.dtype for k, v in snap.arrays.items()} == {
        k: np.dtype(v) for k, v in want.items()}
    twin = tamq.make(name, config=h.config, snapshot=snap, device="cpu")
    assert twin.count() == h.count() == N_STORED
    _arrays_equal(twin.snapshot().arrays, snap.arrays)
    assert np.array_equal(_hits(twin), _hits(h))


@pytest.mark.parametrize("name", BACKENDS)
def test_snapshot_restore_in_place(name):
    h = _port(name)
    snap = h.snapshot()
    target = tamq.make(name, capacity=CAPACITY, device="cpu")
    assert target.restore(snap) is target
    assert target.count() == N_STORED and _hits(target)[:N_STORED].all()
    _arrays_equal(target.snapshot().arrays, snap.arrays)


@pytest.mark.parametrize("name", BACKENDS)
def test_restore_mismatch_fails_loudly(name):
    snap = _port(name).snapshot()
    other = tamq.make(name, capacity=4 * CAPACITY, device="cpu")
    stranger = "gqf" if name == "tcf" else "tcf"
    for bad in (snap._replace(backend=stranger),
                snap._replace(kind="cascade")):
        with pytest.raises(tamq.SnapshotMismatchError):
            tamq.make(name, capacity=CAPACITY, device="cpu", snapshot=bad)
    with pytest.raises(tamq.SnapshotMismatchError, match="fingerprint"):
        other.restore(snap)
    with pytest.raises(tamq.SnapshotMismatchError):
        tamq.make(name, config=other.config, snapshot=snap, device="cpu")
    with pytest.raises(TypeError):
        tamq.make(name, capacity=CAPACITY, device="cpu", snapshot=snap,
                  state=other.state)
    # A table of the wrong shape under the right fingerprint.
    table = {"cpu-cuckoo": "buckets", "bcht": "key_lo"}.get(name, "table")
    cut = dict(snap.arrays, **{table: snap.arrays[table][1:]})
    with pytest.raises(tamq.SnapshotMismatchError):
        tamq.make(name, capacity=CAPACITY, device="cpu",
                  snapshot=snap._replace(arrays=cut))


def test_snapshot_future_version_refused(tmp_path):
    snap = _port("cuckoo").snapshot()
    path = tmp_path / "future.npz"
    tamq.save_snapshot(path, snap._replace(version=tamq.SNAPSHOT_VERSION + 1))
    for pkg in (tamq, ramq):
        with pytest.raises(pkg.SnapshotMismatchError, match="newer"):
            pkg.load_snapshot(path)


def test_npz_crosses_packages(ref, tmp_path):
    """repro -> port and port -> repro, through files."""
    name, r_handle, r_hits = ref
    r_path, t_path = tmp_path / "repro.npz", tmp_path / "port.npz"
    ramq.save_snapshot(r_path, r_handle.snapshot())
    port = tamq.make(name, capacity=CAPACITY, device="cpu",
                     snapshot=tamq.load_snapshot(r_path))
    _arrays_equal(port.snapshot().arrays, r_handle.snapshot().arrays)
    assert np.array_equal(_hits(port), r_hits)
    assert port.count() == r_handle.count() == N_STORED

    mine = _port(name)
    tamq.save_snapshot(t_path, mine.snapshot())
    back = ramq.make(name, capacity=CAPACITY,
                     snapshot=ramq.load_snapshot(t_path))
    _arrays_equal(back.snapshot().arrays, mine.snapshot().arrays)
    assert np.array_equal(_hits(back), _hits(mine))


@pytest.mark.parametrize("name", ("cuckoo", "bloom"))
def test_restored_handle_owns_its_table(name):
    h = _port(name)
    snap = h.snapshot()
    kept = {k: v.copy() for k, v in snap.arrays.items()}
    twin = tamq.make(name, config=h.config, snapshot=snap, device="cpu")
    for a in snap.arrays.values():
        assert not np.shares_memory(a, twin.state.table.numpy())
        assert not np.shares_memory(a, h.state.table.numpy())
    before = h.state.table.clone()
    assert bool(twin.insert(FRESH[:200]).ok.all())
    assert bool(h.insert(FRESH[200:400]).ok.all())
    _arrays_equal(snap.arrays, kept)        # neither insert reached it
    assert not torch.equal(twin.state.table, before)
    assert twin.count() == N_STORED + 200


@pytest.mark.parametrize("name", ("cuckoo", "cpu-cuckoo"))
def test_hot_swap_loses_no_acknowledged_op(name):
    """Interleaved inserts and deletes, a migrating swap mid-stream: every
    acknowledged insert not deleted since is found on the new handle."""
    kw = {} if name == "cpu-cuckoo" else {"device": "cpu"}
    h = tamq.make(name, capacity=CAPACITY, **kw)
    svc = tamq.FilterService(h, batch_size=64)
    rng = np.random.default_rng(3)
    t_ins = [svc.insert(STORED[s:s + 50]) for s in range(0, 400, 50)]
    gone = rng.choice(400, size=60, replace=False)
    t_del = svc.delete(STORED[gone])
    new = tamq.make(name, capacity=CAPACITY, **kw)
    rec = svc.hot_swap(new)
    assert rec["migrated"] and svc.handle is new
    assert all(t.result().all() for t in t_ins) and t_del.result().all()
    live = np.setdiff1d(np.arange(400), gone)
    assert svc.query(STORED[live]).result().all()
    assert new.count() == live.size
    # The service keeps serving the new handle.
    t = svc.insert(STORED[400:450])
    assert t.result().all() and bool(new.query(STORED[400:450]).hits.all())
