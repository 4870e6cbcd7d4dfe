"""The port's tile autotuner (``repro_torch.kernels.autotune``) and the
``block_keys`` of the four cuckoo wrappers vs the JAX package's.

* ``cache_key`` keeps the JAX package's scheme, the backend field being the
  device's name (``"cpu"`` here, as ``jax.default_backend()`` here);
* ``record`` / ``resolve_block_keys`` / ``clear``, persistence through the
  port's own ``REPRO_TORCH_AUTOTUNE_CACHE`` (never the JAX package's
  variable), and ``autotune()`` recording a candidate, then hitting the
  cache;
* each wrapper at every candidate ``block_keys`` on CPU tensors (the plain
  versions, which ignore the tile) against the JAX package's wrapper at the
  same ``block_keys`` (Pallas in interpret mode), from the same numpy
  inputs: equal answers, and for the mutating ops the same table word for
  word and the same count (both apply the batch in one sequential order).

On the card, every candidate against the plain versions:
``tests/test_torch_gpu.py::test_block_keys_candidates_match_plain``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CuckooConfig as RConfig
from repro.core.cuckoo_filter import CuckooState as RState
from repro.kernels import autotune as RA
from repro.kernels import ops as R
from repro_torch.convert import config_from_reference
from repro_torch.kernels import autotune as A
from repro_torch.kernels import ops as K

torch.set_num_threads(1)

OPS = tuple(A.DEFAULT_BLOCK_KEYS)
REF_CFG = RConfig.for_capacity(256, hash_kind="fmix32")
CFG = config_from_reference(REF_CFG)
N = 40                          # keys a batch: a ragged tile at every candidate


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv(A.ENV, raising=False)
    A.clear()
    yield
    A.clear()


def test_candidates_and_names_follow_the_reference():
    assert A.CANDIDATES == RA.CANDIDATES
    assert set(A.DEFAULT_BLOCK_KEYS) == set(RA.DEFAULT_BLOCK_KEYS)
    # The port's defaults are the launches its kernels made before the tile
    # could be tuned (the JAX package's query default is 1024).
    assert A.DEFAULT_BLOCK_KEYS == {"query": 256, "insert": 256,
                                   "bulk_insert": 512, "apply_ops": 256}


@pytest.mark.parametrize("capacity,kw", [
    (2048, {}), (100_000, {"fp_bits": 8, "bucket_size": 4}),
    (5000, {"policy": "offset", "bucket_size": 8})])
def test_cache_key_is_the_reference_key_with_the_device(capacity, kw):
    ref = RConfig.for_capacity(capacity, **kw)
    cfg = config_from_reference(ref)
    for op in OPS:
        want = RA.cache_key(ref, op).split("|")
        want[1] = "cpu"
        assert A.cache_key(cfg, op, "cpu") == "|".join(want)
        assert A.cache_key(cfg, op, torch.device("cpu")) == "|".join(want)


def test_record_resolve_clear():
    assert A.resolve_block_keys(CFG, "query", "cpu") == 256
    A.record(CFG, "query", 1024, "cpu")
    assert A.resolve_block_keys(CFG, "query", "cpu") == 1024
    assert A.resolve_block_keys(CFG, "insert", "cpu") == 256
    other = config_from_reference(RConfig.for_capacity(1 << 16))
    assert A.resolve_block_keys(other, "query", "cpu") == 256
    # The wrappers resolve the cell of their tensors' device: the recorded
    # tile reaches the call, and an invalid one is refused before it runs.
    A.record(CFG, "query", 300, "cpu")
    keys = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="block_keys=300"):
        K.cuckoo_query(CFG, CFG.init("cpu"), keys)
    A.clear()
    assert A.resolve_block_keys(CFG, "query", "cpu") == 256
    assert not K.cuckoo_query(CFG, CFG.init("cpu"), keys).any()


def test_persistent_cache_is_the_ports_own(tmp_path, monkeypatch):
    path = tmp_path / "tune" / "cache.json"
    monkeypatch.setenv(A.ENV, str(path))
    A.record(CFG, "apply_ops", 2048, "cpu")
    stored = json.loads(path.read_text())
    assert stored == {A.cache_key(CFG, "apply_ops", "cpu"): 2048}
    A.clear()                       # a new process: read back from the file
    assert A.resolve_block_keys(CFG, "apply_ops", "cpu") == 2048
    # The JAX package's variable feeds nothing here.
    jax_file = tmp_path / "jax.json"
    jax_file.write_text(json.dumps({A.cache_key(CFG, "query", "cpu"): 512}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jax_file))
    monkeypatch.delenv(A.ENV)
    A.clear()
    assert A.resolve_block_keys(CFG, "query", "cpu") == 256


def test_autotune_records_a_candidate_then_hits_the_cache(monkeypatch):
    with pytest.raises(ValueError, match="unknown op"):
        A.sweep(CFG, "gather", n=8, device="cpu")
    best = A.autotune(CFG, "query", n=512, iters=1, device="cpu")
    assert best in A.CANDIDATES
    assert A.resolve_block_keys(CFG, "query", "cpu") == best

    def no_sweep(*a, **k):
        raise AssertionError("a second call must be a cache hit")

    monkeypatch.setattr(A, "sweep", no_sweep)
    assert A.autotune(CFG, "query", n=512, device="cpu") == best


def _inputs():
    """A table at about half load (the port's plain bulk insert), and a
    batch of N keys with op codes, from numpy with a seed."""
    rng = np.random.default_rng(31)
    fill = rng.integers(0, 2**32, size=(CFG.num_slots // 2, 2),
                        dtype=np.uint32)
    keys = rng.integers(0, 2**32, size=(N, 2), dtype=np.uint32)
    keys[: N // 3] = fill[: N // 3]          # a third of the batch stored
    ops = rng.integers(0, 3, size=(N,), dtype=np.int32)
    state, _ = K.cuckoo_insert_bulk(
        CFG, CFG.init("cpu"), torch.from_numpy(fill.view(np.int32)))
    return state, keys, ops


STATE, KEYS, OPCODES = _inputs()


@pytest.mark.parametrize("block_keys", A.CANDIDATES)
@pytest.mark.parametrize("op", OPS)
def test_wrappers_match_the_reference_at_every_tile(op, block_keys):
    table = STATE.table.clone()
    state = STATE._replace(table=table)
    out = A.run_op(CFG, op, state, torch.from_numpy(KEYS.view(np.int32)),
                   torch.from_numpy(OPCODES), block_keys)
    ref_state = RState(jnp.asarray(STATE.table.numpy().view(np.uint32)),
                       jnp.asarray(int(STATE.count), jnp.int32))
    keys = jnp.asarray(KEYS)
    if op == "query":
        want = R.cuckoo_query(REF_CFG, ref_state, keys, block_keys=block_keys)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert torch.equal(table, STATE.table)
        return
    if op == "insert":
        got = R.cuckoo_insert_direct(REF_CFG, ref_state, keys,
                                     block_keys=block_keys)
    elif op == "bulk_insert":
        got = R.cuckoo_insert_bulk(REF_CFG, ref_state, keys,
                                   block_keys=block_keys)
    else:
        got = R.cuckoo_apply_ops(REF_CFG, ref_state, keys,
                                 jnp.asarray(OPCODES), block_keys=block_keys)
    (ref_table, ref_count), ref_ok = got
    st, ok = out
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(table.numpy().view(np.uint32),
                                  np.asarray(ref_table))
    assert int(st.count) == int(ref_count)
