"""The port's ``cuckoo`` backend end to end vs the JAX package's.

``repro_torch.amq.make("cuckoo", ..., device="cpu")`` runs the plain
versions of the kernels; it is held against ``repro.amq.make("cuckoo",
...)`` on the same keys, made from a seed with numpy. The bulk path
(``insert(keys, bulk=True)``, the orientation build in both packages) must
leave the same table. Where the two place keys differently (``insert``
routes to the frontier engine in both, but the port runs the direct-insert
kernel first and hands the frontier only its residue), the port is held by
invariants: ``count == ok.sum()``, every accepted key
queryable, every stored tag in one of its key's buckets, every key placed
where the reference places every key, and the FPR inside the Eq. 4 band.
Query answers on a JAX table carried across are bit-exact, and deletes
agree with the JAX ``delete``'s ``ok``. ``make(..., auto_expand="auto")``
gives a plain handle, as in the JAX package, and a mixed batch runs
through ``FilterHandle.apply_ops``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.core import cuckoo_filter as TCF
from repro_torch.core import layout as L
from repro_torch.core.bits64 import from_i32
from repro_torch.core.hashing import keys_from_numpy

torch.set_num_threads(1)

CAPACITY = 3891          # floor(0.95 * 4096): 256 buckets x 16 slots
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _raw(seed, n, top=False):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**63, size=n, dtype=np.uint64)
    return raw | np.uint64(1 << 63) if top else raw


def _stored_tags_belong(cfg, table, keys_ok):
    """Every stored (bucket, tag) is one an accepted key may occupy."""
    tag, i1, i2 = TCF.prepare_keys(cfg, keys_from_numpy(keys_ok))
    pol = cfg.placement
    allowed = set(zip(i1.tolist(), pol.place_tag(tag, False).tolist()))
    allowed |= set(zip(i2.tolist(), pol.place_tag(tag, True).tolist()))
    tags = L.unpack_words(from_i32(table), cfg.fp_bits).reshape(
        cfg.num_buckets, cfg.bucket_size)
    b, s = tags.nonzero(as_tuple=True)
    stored = list(zip(b.tolist(), tags[b, s].tolist()))
    assert len(stored) == len(keys_ok)
    assert all(x in allowed for x in stored)


@pytest.mark.parametrize("bulk", [False, True], ids=["insert", "bulk"])
def test_fill_to_095_holds_invariants(bulk):
    ref = ramq.make("cuckoo", capacity=CAPACITY)
    port = tamq.make("cuckoo", capacity=CAPACITY, device="cpu")
    assert repr(port.config) == repr(ref.config)
    assert port.config.num_slots == 4096 and port.device.type == "cpu"
    raw = _raw(1, CAPACITY)
    ok_ref, ok_port = [], []
    for chunk in np.array_split(raw, 4):
        ok_ref.append(np.asarray(ref.insert(chunk, bulk=bulk).ok))
        rep = port.insert(chunk, bulk=bulk)
        ok_port.append(rep.ok.numpy())
        assert rep.ok.shape == (len(chunk),) and int(rep.rounds) >= 1
    ok_ref, ok_port = np.concatenate(ok_ref), np.concatenate(ok_port)
    if bulk:    # auto -> the orientation build in both: bit-exact
        np.testing.assert_array_equal(ok_port, ok_ref)
        np.testing.assert_array_equal(
            port.state.table.numpy().view(np.uint32),
            np.asarray(ref.state.table))
    assert port.count() == int(ok_port.sum())
    if ok_ref.all():
        assert ok_port.all()
    assert port.load_factor == pytest.approx(ok_port.sum() / 4096)
    assert bool(port.query(raw[ok_port]).hits.all())          # no false negative
    _stored_tags_belong(port.config, port.state.table, raw[ok_port])

    fresh = _raw(2, 1 << 14, top=True)
    fpr = float(port.query(fresh).hits.float().mean())
    lo, hi = tamq.fpr_tolerance(port.expected_fpr(), fresh.shape[0])
    assert lo <= fpr <= hi
    assert port.expected_fpr() == pytest.approx(ref.expected_fpr())
    assert port.table_bytes == ref.table_bytes


def test_query_and_delete_on_a_carried_table():
    ref = ramq.make("cuckoo", capacity=CAPACITY)
    raw = _raw(3, 3000)
    ref.insert(raw, bulk=True)
    snap = ref.snapshot()
    state = convert.state_from_numpy(snap.arrays, "cpu")
    port = tamq.make("cuckoo", config=convert.config_from_reference(ref.config),
                     state=state)
    assert port.count() == ref.count()
    back = convert.state_to_numpy(port.state)
    np.testing.assert_array_equal(back["table"], snap.arrays["table"])
    assert back["count"].dtype == np.int32 and int(back["count"]) == ref.count()

    probe = np.concatenate([raw[:500], _raw(4, 1500, top=True)])
    np.testing.assert_array_equal(port.query(probe).hits.numpy(),
                                  np.asarray(ref.query(probe).hits))
    valid = np.random.default_rng(5).random(probe.shape[0]) < 0.9
    np.testing.assert_array_equal(
        port.query(probe, valid=valid).hits.numpy(),
        np.asarray(ref.query(probe, valid=valid).hits))

    # Deletes: present keys, absent keys, and duplicates of present keys.
    dels = np.concatenate([raw[:300], _raw(6, 100, top=True), raw[:50]])
    before = port.count()
    d_port = port.delete(dels).ok.numpy()
    d_ref = np.asarray(ref.delete(dels).ok)
    np.testing.assert_array_equal(d_port, d_ref)
    assert before - port.count() == int(d_port.sum())
    assert port.count() == ref.count()
    assert d_port[:300].all() and not d_port[300:].any()
    np.testing.assert_array_equal(port.query(probe).hits.numpy(),
                                  np.asarray(ref.query(probe).hits))


def test_dedup_and_valid_through_the_handle():
    ref = ramq.make("cuckoo", capacity=CAPACITY)
    port = tamq.make("cuckoo", capacity=CAPACITY, device="cpu")
    raw = _raw(7, 400)
    batch = np.concatenate([raw, raw[:100]])
    valid = np.ones(batch.shape[0], bool)
    valid[50:60] = False      # masked, but their copies at 450:460 are live
    rep = port.insert(batch, dedup_within_batch=True, valid=valid)
    want = np.asarray(ref.insert(batch, dedup_within_batch=True,
                                 valid=valid).ok)
    np.testing.assert_array_equal(rep.ok.numpy(), want)
    assert port.count() == ref.count() == 400
    assert not want[50:60].any() and want[400:].all()


def test_make_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tamq.make("cuckoo", capacity=1000)
    h = tamq.make("cuckoo", capacity=1000, device="cpu")
    caps = h.capabilities
    assert (caps.supports_delete, caps.supports_bulk, caps.counting,
            caps.supports_mixed) == (True,) * 4
    assert not (caps.supports_expand or caps.supports_snapshot
                or caps.supports_tiering)
    for call in (h.snapshot,
                 lambda: tamq.make("cuckoo", capacity=10, device="cpu",
                                   auto_expand=True),
                 lambda: tamq.make("cuckoo", capacity=10, device="cpu",
                                   tiered=True)):
        with pytest.raises(NotImplementedError, match="item 9b|item 12"):
            call()
    # auto_expand="auto" resolves to supports_expand (False): a plain
    # handle, as in the JAX package.
    plain = tamq.make("cuckoo", capacity=10, device="cpu", auto_expand="auto")
    assert type(plain) is type(h) and plain.device.type == "cpu"
    # A real mixed batch through the fused path.
    raw = _raw(8, 3)
    rep = h.apply_ops(tamq.OpBatch.make(
        raw[[0, 0, 1, 0, 2]], [tamq.OP_INSERT, tamq.OP_QUERY, tamq.OP_QUERY,
                               tamq.OP_DELETE, tamq.OP_DELETE]))
    assert rep.ok.tolist() == [True, True, False, True, False]
    assert h.count() == 0 and rep.ok.device.type == "cpu"
    with pytest.raises(TypeError, match="OpBatch"):
        h.apply_ops(None)
    with pytest.raises(KeyError):
        tamq.make("tcf", capacity=10, device="cpu")
    assert tamq.names() == ("cuckoo", "bloom", "cpu-cuckoo")
    # The host oracle runs on the CPU without being asked.
    assert tamq.make("cpu-cuckoo", capacity=1000).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tamq.make("bloom", capacity=1000)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch import amq\n"
        "amq.make\n"
        "for m in ('repro_torch.filters.cpu_reference',\n"
        "          'repro_torch.kernels.cuckoo_query',\n"
        "          'repro_torch.kernels.cuckoo_insert', 'repro_torch.convert'):\n"
        "    assert m in sys.modules, m\n"
        "amq.make('cpu-cuckoo', capacity=100).apply_ops(amq.OpBatch.make(\n"
        "    [1, 2], [amq.OP_INSERT, amq.OP_QUERY]))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
