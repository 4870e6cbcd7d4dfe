"""The port's mesh-sharded filter vs the JAX package's.

* Routing (``partition_of``, ``shard_of``, ``_route``, ``_unroute``) is a
  pure function in both packages: every output bit-exact, eager JAX, for
  P in {1, 3, 8} partitions over K in {1, 2, 4} shards where K divides P.
* The core driver ``ShardedCuckooFilter`` is bit-exact with JAX's (table
  words, ``count``, ``ok``, ``routed``) through insert with
  ``dedup_within_batch``, bulk insert, query, delete and ``apply_ops``,
  each under a valid mask: at K = 1 in-process (JAX's own sharded op
  under ``shard_map`` on a one-device mesh), and at K = 4 against one
  subprocess that runs JAX on 4 forced host devices (the JAX package's
  own multi-shard test setup) and writes every step to a ``.npz``.
* K→K′ resharding moves every word verbatim and changes no answer.
* The ``sharded-cuckoo`` adapter on the CPU (the kernels' plain
  versions): ``routed`` bit-exact with JAX's adapter, the north star's
  invariants in every partition, query answers bit-exact on a table
  carried from JAX, ``.npz`` snapshots across both ways, a cascade of
  shards on one mesh, ``hot_swap`` onto a resharded handle, and a mesh of
  distinct devices refused.

Keys come from a seed with numpy; the bins are sized small enough that
some keys overflow them (``routed`` False).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro.amq import adapters as RAD
from repro.core import compat, keys_from_numpy
from repro.core import sharded_filter as RSF
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.amq import adapters as TAD
from repro_torch.amq.dispatch import batch_align
from repro_torch.core import cuckoo_filter as TCF
from repro_torch.core.bits64 import from_i32
from repro_torch.core import layout as TL
from repro_torch.core import sharded_filter as TSF

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _t(raw):
    return torch.from_numpy(keys_from_numpy(raw).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _raw(seed, n):
    rng = np.random.default_rng(seed)
    raw = np.unique(rng.integers(1, 2**63, size=2 * n, dtype=np.uint64))[:n]
    return rng.permutation(raw)


def _config(K, pps, capacity=2048, cf=1.0):
    jcfg = RSF.ShardedCuckooConfig.for_capacity(
        capacity, K, partitions_per_shard=pps, hash_kind="fmix32",
        capacity_factor=cf)
    return jcfg, convert.sharded_config_from_reference(jcfg)


# ---------------------------------------------------------------------------
# (a) Routing.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,K", [(1, 1), (3, 1), (8, 1), (8, 2), (8, 4)])
def test_routing_bit_exact(P, K):
    jcfg, tcfg = _config(K, P // K)
    assert repr(tcfg) == repr(jcfg) and tcfg.partitions == P
    rng = np.random.default_rng(P * 10 + K)
    raw = rng.integers(0, 2**64, size=300, dtype=np.uint64)
    raw[::7] = raw[3]                           # one key many times
    valid = rng.random(300) < 0.85
    jk, tk = jnp.asarray(keys_from_numpy(raw)), _t(raw)
    assert np.array_equal(np.asarray(RSF.partition_of(jcfg, jk)),
                          TSF.partition_of(tcfg, tk).numpy())
    assert np.array_equal(np.asarray(RSF.shard_of(jcfg, jk)),
                          TSF.shard_of(tcfg, tk).numpy())
    cap = 12                                    # some bins overflow
    jout = RSF._route(jcfg, jk, cap, jnp.asarray(valid))
    tout = TSF._route(tcfg, tk, cap, torch.from_numpy(valid))
    names = ("bins", "bin_valid", "order", "dest_s", "idx_in_group",
             "routed", "slot")
    for name, j, t in zip(names, jout, tout):
        j = np.asarray(j)
        t = t.numpy().view(np.uint32) if name == "bins" else t.numpy()
        assert j.shape == t.shape, name
        assert np.array_equal(j, t.astype(j.dtype)), name
    assert not np.asarray(jout[5]).all() or P == 1
    back = rng.random((P, cap)) < 0.5
    got = TSF._unroute(*tout[2:6], torch.from_numpy(back))
    want = RSF._unroute(*jout[2:6], jnp.asarray(back))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # The K local batches routed in one batched sort, row by row.
    rows = TSF._route(tcfg, tk.view(3, 100, 2), cap,
                      torch.from_numpy(valid).view(3, 100))
    for r in range(3):
        one = TSF._route(tcfg, tk[r * 100:(r + 1) * 100], cap,
                         torch.from_numpy(valid[r * 100:(r + 1) * 100]))
        for name, a, b in zip(names, rows, one):
            assert torch.equal(a[r], b), name


# ---------------------------------------------------------------------------
# (b), (c) The core driver, bit-exact.
# ---------------------------------------------------------------------------

OPS = ("insert", "insert_bulk", "query", "delete", "apply_ops")


def _batches(seed, n, steps=2):
    """``steps`` rounds of (raw keys, valid, op codes), each ``n`` wide,
    drawn from a pool so that keys repeat within and across batches."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, size=2000, dtype=np.uint64)
    return [(pool[rng.integers(0, 1200, n)], rng.random(n) < 0.9,
             rng.integers(0, 3, n).astype(np.int32)) for _ in range(steps)]


def _port_step(filt, op, raw, valid, ops):
    keys, v = _t(raw), torch.from_numpy(valid)
    if op == "insert_bulk":
        return filt.insert(keys, bulk=True, dedup_within_batch=True, valid=v)
    if op == "apply_ops":
        return filt.apply_ops(keys, torch.from_numpy(ops), valid=v)
    return getattr(filt, op)(keys, valid=v)


def _assert_step(label, filt, ok, routed, table, count, want_ok, want_routed):
    np.testing.assert_array_equal(_u32(filt.state.table), table,
                                  err_msg=label)
    np.testing.assert_array_equal(filt.state.count.numpy(), count,
                                  err_msg=label)
    np.testing.assert_array_equal(ok.numpy(), want_ok, err_msg=label)
    np.testing.assert_array_equal(routed.numpy(), want_routed, err_msg=label)


@functools.lru_cache(maxsize=None)
def _jax_config():
    """The JAX adapter's config for the one-shard cases: ``_config(1, 4)``
    on a one-device mesh. Its sharded ops are JAX's driver function under
    ``shard_map``, jitted and cached by the JAX adapter, so the adapter
    tests below reuse the compiles of the driver test."""
    jcfg, tcfg = _config(1, 4)
    return (RAD.ShardedAMQConfig(jcfg, jax.make_mesh((1,), ("data",))),
            TAD.ShardedAMQConfig(tcfg, TSF.make_mesh(1, device="cpu")))


N1 = 192                     # the one-shard cases' batch width


def test_driver_bit_exact_one_shard(four_shard_reference):
    # ``four_shard_reference`` is only started here, so that JAX's
    # four-device run overlaps this test's compiles. One step: the
    # four-shard case repeats keys across steps.
    jcfg, tcfg = _jax_config()
    port = TSF.ShardedCuckooFilter(tcfg.inner, tcfg.mesh, N1)
    jtable, jcount = jcfg.inner.init()
    for step, (raw, valid, ops) in enumerate(_batches(3, N1, steps=1)):
        args = (jnp.asarray(keys_from_numpy(raw)), jnp.asarray(valid))
        for op in OPS:
            extra = (jnp.asarray(ops),) if op == "apply_ops" else ()
            table, count, ok, routed = RAD._sharded_fn(
                jcfg, op, N1, op == "insert_bulk")(jtable, jcount, *args,
                                                   *extra)
            if op != "query":
                jtable, jcount = table, count
            got = _port_step(port, op, raw, valid, ops)
            _assert_step(f"{step}/{op}", port, *got, np.asarray(jtable),
                         np.asarray(jcount), np.asarray(ok),
                         np.asarray(routed))
    assert port.total_count > 0


# Runs in its own process: JAX on 4 forced host devices (XLA_FLAGS set by
# the test before JAX starts), the driver's op sequence, every step's
# state and results into one .npz.
_JAX_FOUR_SHARDS = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import keys_from_numpy
from repro.core.sharded_filter import ShardedCuckooConfig, ShardedCuckooFilter

assert jax.device_count() == 4, jax.device_count()
cfg = ShardedCuckooConfig.for_capacity(
    2048, 4, partitions_per_shard=2, hash_kind="fmix32", capacity_factor=1.0)
lb = int(sys.argv[2])
filt = ShardedCuckooFilter(cfg, jax.make_mesh((4,), ("data",)), lb)
data = np.load(sys.argv[3])
out = {}
for step in range(int(data["steps"])):
    keys = jnp.asarray(keys_from_numpy(data[f"{step}/raw"]))
    valid = jnp.asarray(data[f"{step}/valid"])
    calls = {
        "insert": lambda: filt.insert(keys, valid=valid),
        "insert_bulk": lambda: filt.insert(keys, bulk=True,
                                           dedup_within_batch=True,
                                           valid=valid),
        "query": lambda: filt.query(keys, valid=valid),
        "delete": lambda: filt.delete(keys, valid=valid),
        "apply_ops": lambda: filt.apply_ops(keys, data[f"{step}/ops"],
                                            valid=valid)}
    for op, call in calls.items():
        ok, routed = call()
        for name, a in (("ok", ok), ("routed", routed),
                        ("table", filt.state.table),
                        ("count", filt.state.count)):
            out[f"{step}/{op}/{name}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


FOUR_SHARDS_LB = 96          # the four-shard case's local batch


@pytest.fixture(scope="module")
def four_shard_reference(tmp_path_factory):
    """JAX's four-shard run, started in the background: (its process, the
    batches, the path of its .npz)."""
    tmp = tmp_path_factory.mktemp("four_shards")
    batches = _batches(4, 4 * FOUR_SHARDS_LB)
    inputs = {"steps": len(batches)}
    for step, (raw, valid, ops) in enumerate(batches):
        inputs.update({f"{step}/raw": raw, f"{step}/valid": valid,
                       f"{step}/ops": ops})
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4 "
        "--xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true"))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in
                                       env.get("PYTHONPATH", "").split(
                                           os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_FOUR_SHARDS, str(tmp / "out.npz"),
         str(FOUR_SHARDS_LB), str(tmp / "in.npz")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    yield proc, batches, tmp / "out.npz"
    proc.kill()
    proc.communicate()


def test_driver_bit_exact_four_shards_subprocess(four_shard_reference):
    K, lb = 4, FOUR_SHARDS_LB
    proc, batches, out = four_shard_reference
    _, stderr = proc.communicate(timeout=120)
    assert proc.returncode == 0, stderr[-3000:]
    _, tcfg = _config(K, 2)
    want = np.load(out)
    port = TSF.ShardedCuckooFilter(tcfg, TSF.make_mesh(K, device="cpu"), lb)
    unrouted = 0
    for step, (raw, valid, ops) in enumerate(batches):
        for op in OPS:
            got = _port_step(port, op, raw, valid, ops)
            w = [want[f"{step}/{op}/{f}"]
                 for f in ("table", "count", "ok", "routed")]
            _assert_step(f"{step}/{op}", port, *got, *w)
            unrouted += int((valid & ~w[3]).sum())
    assert unrouted > 0                    # the overflow path was exercised


# ---------------------------------------------------------------------------
# (d) Exact resharding.
# ---------------------------------------------------------------------------

STORED = _raw(0, 1504)
FRESH = _raw(1, 4096) | np.uint64(1 << 63)
PROBE = np.concatenate([STORED, FRESH])


def _handle(K=4, pps=2, keys=STORED, **kw):
    h = tamq.make("sharded-cuckoo", capacity=4096, num_shards=K,
                  partitions_per_shard=pps, device="cpu", **kw)
    if keys is not None:
        rep = h.insert(keys)
        assert bool((rep.ok & rep.routed).all())
    return h


def _answers(h, keys=PROBE):
    q = h.query(keys)
    return q.hits & q.routed, q.routed


@pytest.fixture(scope="module")
def four_shards():
    return _handle()


@pytest.mark.parametrize("k2", [1, 2, 8])
def test_reshard_moves_words_verbatim(four_shards, k2):
    h = four_shards
    hits, routed = _answers(h)
    moved = h.resharded(num_shards=k2)
    assert moved is not h and moved.config.inner.num_shards == k2
    assert moved.config.inner.partitions == 8 and moved.device == CPU
    assert moved.fingerprint == h.fingerprint
    assert torch.equal(moved.state.table, h.state.table)
    assert torch.equal(moved.state.count, h.state.count)
    assert moved.state.table.data_ptr() != h.state.table.data_ptr()
    got_hits, got_routed = _answers(moved)
    assert torch.equal(got_hits, hits) and bool(got_routed.all())
    assert bool(hits[:STORED.size].all())
    # The core driver's reshard too.
    drv = TSF.ShardedCuckooFilter(h.config.inner, h.config.mesh, 1024,
                                  state=h.state)
    moved_drv = drv.resharded(TSF.make_mesh(k2, device="cpu"))
    assert torch.equal(moved_drv.state.table, h.state.table)
    assert torch.equal(moved_drv.query(PROBE)[0] & moved_drv.query(PROBE)[1],
                       drv.query(PROBE)[0] & drv.query(PROBE)[1])


def test_reshard_refusals(four_shards):
    with pytest.raises(ValueError, match="partitions"):
        four_shards.config.resharded(num_shards=3)
    with pytest.raises(NotImplementedError, match="resharding"):
        tamq.make("cuckoo", capacity=1024, device="cpu").resharded(
            num_shards=2)


# ---------------------------------------------------------------------------
# (e) The adapter.
# ---------------------------------------------------------------------------

def _partition_codes(cfg, table):
    """Sorted (pair, tag) codes of the tags stored in one partition."""
    tags = TL.unpack_words(from_i32(table).view(
        cfg.num_buckets, cfg.layout.words_per_bucket), cfg.fp_bits)
    tags = tags.reshape(cfg.num_buckets, cfg.bucket_size)
    live = tags != 0
    bucket = torch.arange(cfg.num_buckets)[:, None].expand_as(tags)[live]
    tag = tags[live]
    alt = cfg.placement.alt_bucket(bucket, tag)
    return torch.sort((torch.minimum(bucket, alt) << cfg.fp_bits) | tag).values


def _key_codes(cfg, keys):
    tag, i1, i2 = TCF.prepare_keys_plain(cfg, keys)
    return torch.sort((torch.minimum(i1, i2) << cfg.fp_bits) | tag).values


def test_adapter_invariants_in_every_partition():
    """``count`` equals each partition's accepted keys, every accepted key
    is found, each partition's table holds exactly its accepted keys'
    tags (each in one of its key's buckets), the FPR inside Eq. 4's band,
    and a delete of every stored key empties every partition."""
    h = _handle(keys=None, capacity_factor=1.0)
    inner = h.config.inner
    accepted = []
    for seed, bulk in ((2, False), (3, True), (4, False)):
        raw = _raw(seed, 1024)
        rep = h.insert(raw, bulk=bulk)
        assert not bool((rep.routed & ~rep.ok).any())
        assert not bool(rep.routed.all())           # some bins overflowed
        accepted.append(raw[rep.ok.numpy()])
    keys = _t(np.concatenate(accepted))
    keys = keys[:keys.shape[0] - keys.shape[0] % inner.num_shards]
    part = TSF.partition_of(inner, keys)
    every = _t(np.concatenate(accepted))
    for p in range(inner.partitions):
        mine = every[TSF.partition_of(inner, every) == p]
        assert int(h.state.count[p]) == mine.shape[0]
        assert torch.equal(_partition_codes(inner.shard, h.state.table[p]),
                           _key_codes(inner.shard, mine))
    q = h.query(keys)
    assert bool((q.hits | ~q.routed).all()) and bool(q.routed.any())
    fresh = h.query(FRESH)
    fpr = float((fresh.hits & fresh.routed).sum()) / float(fresh.routed.sum())
    lo, hi = tamq.fpr_tolerance(h.expected_fpr(), int(fresh.routed.sum()))
    assert lo <= fpr <= hi
    pending = every
    while pending.shape[0]:
        pad = (-pending.shape[0]) % inner.num_shards
        batch = torch.cat([pending, pending[:pad]])
        d = h.delete(batch, valid=torch.arange(batch.shape[0])
                     < pending.shape[0])
        assert bool(d.ok[:pending.shape[0]][d.routed[:pending.shape[0]]].all())
        pending = pending[~d.routed[:pending.shape[0]]]
    assert h.count() == 0 and not bool(h.state.table.any())


@pytest.fixture(scope="module")
def reference_pair():
    """The JAX ``sharded-cuckoo`` handle at K = 1 (the CPU has one JAX
    device) and the port's of the same config, both fed the same batches
    (bins small enough to overflow)."""
    jcfg, tcfg = _jax_config()
    jh = ramq.make("sharded-cuckoo", config=jcfg)
    th = tamq.make("sharded-cuckoo", config=tcfg)
    assert th.fingerprint == jh.fingerprint and th.device == CPU
    raw = _raw(5, 4 * N1)
    reps = [(jh.insert(chunk), th.insert(chunk))
            for chunk in np.split(raw, 4)]
    return jh, th, raw, reps


def test_adapter_routed_bit_exact_with_reference(reference_pair):
    jh, th, raw, reps = reference_pair
    for jrep, trep in reps:
        np.testing.assert_array_equal(trep.routed.numpy(),
                                      np.asarray(jrep.routed))
        np.testing.assert_array_equal(trep.ok.numpy(), np.asarray(jrep.ok))
    assert not all(bool(trep.routed.all()) for _, trep in reps)
    assert th.count() == jh.count()
    np.testing.assert_array_equal(th.state.count.numpy(),
                                  np.asarray(jh.state.count))


def test_npz_snapshots_cross_both_ways(reference_pair, tmp_path):
    """A table carried from JAX answers bit-exact in the port, and the
    port's answers carry back; fingerprints equal both ways."""
    jh, th, raw, _ = reference_pair
    probe = np.concatenate([raw, FRESH[:1280]])
    want = jh.query(probe)
    want = np.asarray(want.hits) & np.asarray(want.routed)
    ramq.save_snapshot(tmp_path / "jax.npz", jh.snapshot())
    carried = tamq.make("sharded-cuckoo", config=th.config,
                        snapshot=tamq.load_snapshot(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(_u32(carried.state.table),
                                  np.asarray(jh.state.table))
    state = convert.sharded_state_from_numpy(jh.snapshot().arrays, CPU)
    assert all(torch.equal(a, b) for a, b in zip(state, carried.state))
    assert np.array_equal(convert.state_to_numpy(state)["table"],
                          np.asarray(jh.state.table))
    got = carried.query(probe)
    np.testing.assert_array_equal((got.hits & got.routed).numpy(), want)
    # The port's own table back into JAX, and restored onto 2 shards.
    tamq.save_snapshot(tmp_path / "port.npz", th.snapshot())
    back = ramq.make("sharded-cuckoo", config=jh.config,
                     snapshot=ramq.load_snapshot(tmp_path / "port.npz"))
    assert back.fingerprint == th.fingerprint
    np.testing.assert_array_equal(np.asarray(back.state.table),
                                  _u32(th.state.table))
    got = th.query(probe)
    want = back.query(probe)
    np.testing.assert_array_equal((got.hits & got.routed).numpy(),
                                  np.asarray(want.hits)
                                  & np.asarray(want.routed))
    two = tamq.make("sharded-cuckoo", config=th.config.resharded(2),
                    snapshot=tamq.load_snapshot(tmp_path / "port.npz"))
    assert torch.equal(two.state.table, th.state.table)
    assert torch.equal(_answers(two, probe)[0], _answers(th, probe)[0])


def test_cascade_of_shards_keeps_one_mesh():
    h = tamq.make("sharded-cuckoo", capacity=512, num_shards=2,
                  device="cpu", auto_expand=True)
    raw = _raw(6, 4096)
    for chunk in np.split(raw, 8):
        assert bool(h.insert(chunk).ok.all())
    assert len(h.levels) > 1
    assert len({id(lvl.config.mesh) for lvl in h.levels}) == 1
    assert len({(lvl.config.inner.num_shards, lvl.config.inner.axis_name,
                 lvl.config.inner.capacity_factor,
                 lvl.config.inner.partitions) for lvl in h.levels}) == 1
    slots = [lvl.config.num_slots for lvl in h.levels]
    assert slots == sorted(slots) and slots[-1] > slots[0]
    assert bool(h.query(raw).hits.all()) and h.count() == raw.size
    assert batch_align(h) == 2


def test_hot_swap_onto_resharded_handle():
    h = _handle(keys=None)
    svc = tamq.FilterService(h, batch_size=64)
    keys = _raw(7, 800)
    assert svc.insert(keys).result().all()
    swap = svc.hot_swap(h.resharded(num_shards=2))
    assert swap["migrated"] and svc.handle.config.inner.num_shards == 2
    assert svc.query(keys).result().all()
    assert svc.handle.count() == keys.size
    assert all(r % 2 == 0 for r in svc.shape_ladder)


def test_mesh_placement():
    with pytest.raises(NotImplementedError, match="item 13"):
        TSF.Mesh(("cpu", "meta"))
    with pytest.raises(NotImplementedError, match="more than one"):
        tamq.make("sharded-cuckoo", capacity=1024,
                  mesh=TSF.Mesh((torch.device("cuda", 0),
                                 torch.device("cuda", 1))))
    mesh = TSF.make_mesh(2, device="cpu")
    assert mesh.shape == {"data": 2} and mesh.device == CPU
    h = tamq.make("sharded-cuckoo", capacity=1024, mesh=mesh)
    assert h.device == CPU and h.config.inner.num_shards == 2
    with pytest.raises(ValueError, match="mesh"):
        tamq.make("sharded-cuckoo", capacity=1024, mesh=mesh, num_shards=4)
    with pytest.raises(ValueError, match="not on device"):
        tamq.make("sharded-cuckoo", capacity=1024, mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="not divisible"):
        h.insert(_raw(8, 3))
