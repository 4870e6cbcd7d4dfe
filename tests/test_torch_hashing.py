"""Port hashing vs the JAX package, bit-exact (``repro_torch.core.hashing``).

The same keys, made from a seed with numpy, go through
``repro.core.hashing.hash_key`` and the port's ``hash_key``; the hash
kernel's plain version is held against ``hash64_pallas`` (interpret mode)
and the pure-Python ``xxhash64_py``. Edge keys: 0, 2^64 - 1, and keys
with either half equal to 0xFFFFFFFF.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as RH
from repro.kernels.hash64 import hash64_pallas
from repro_torch.core import hashing as TH
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as TR
from repro_torch.kernels.hash64 import hash64_plain

torch.set_num_threads(1)

EDGE = np.array([0, 2**64 - 1, 0xFFFFFFFF, 0xFFFFFFFF00000000,
                 0xFFFFFFFF12345678, 0x12345678FFFFFFFF, 1, 2**63],
                dtype=np.uint64)
SEEDS = [0, 0xDEADBEEFCAFEF00D]


def _raw(n=248, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(0, 2**64, size=n, dtype=np.uint64)])


def _u32(t):
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("kind", ["xxhash64", "fmix32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_hash_key_matches_reference(kind, seed):
    raw = _raw()
    hi_j, lo_j = RH.hash_key(jnp.asarray(RH.keys_from_numpy(raw)), kind, seed)
    hi_t, lo_t = TH.hash_key(TH.keys_from_numpy(raw), kind, seed)
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j, np.int64))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j, np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash64_plain_matches_pallas_and_python(seed):
    raw = _raw()
    keys_j = jnp.asarray(RH.keys_from_numpy(raw))
    hi_p, lo_p = hash64_pallas(keys_j[:, 0], keys_j[:, 1], seed=seed,
                               block_keys=128, interpret=True)
    keys = TH.keys_from_numpy(raw)
    hi, lo = hash64_plain(keys, seed)
    np.testing.assert_array_equal(_u32(hi), np.asarray(hi_p, np.int64))
    np.testing.assert_array_equal(_u32(lo), np.asarray(lo_p, np.int64))
    want = [RH.xxhash64_py(int(k), seed) for k in raw]
    got = [(int(h) << 32) | int(l) for h, l in zip(_u32(hi), _u32(lo))]
    assert got == want
    assert [TH.xxhash64_py(int(k), seed) for k in raw] == want
    # the CPU route of the wrapper and the oracle are the plain version
    for h2, l2 in (K.hash64(keys, seed), TR.hash64_ref(keys[:, 0], keys[:, 1], seed)):
        assert torch.equal(h2, hi) and torch.equal(l2, lo)


def test_fmix32_matches_python():
    x = np.concatenate([[0, 1, 0xFFFFFFFF, 0x80000000],
                        np.random.default_rng(1).integers(0, 2**32, 60)])
    got = TH.fmix32(torch.tensor(x, dtype=torch.int64)).tolist()
    assert got == [RH.fmix32_py(int(v)) for v in x]
    assert [TH.fmix32_py(int(v)) for v in x] == [RH.fmix32_py(int(v)) for v in x]


def test_key_forms_normalize_alike():
    raw = _raw(56)
    want = TH.keys_from_numpy(raw)
    forms = [raw, [int(v) for v in raw], RH.keys_from_numpy(raw),
             torch.from_numpy(raw.view(np.int64)), want]
    for form in forms:
        assert torch.equal(TH.normalize_keys(form), want)
    np.testing.assert_array_equal(TH.keys_to_numpy(want), raw)
    np.testing.assert_array_equal(
        TH.keys_from_numpy(raw).numpy().view(np.uint32),
        RH.keys_from_numpy(raw))
    # 32-bit scalars widen losslessly, as in the JAX package
    small = np.array([1, 2, 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(
        TH.normalize_keys(small).numpy().view(np.uint32),
        RH.normalize_keys(small))


@pytest.mark.parametrize("bad", [
    np.zeros((4, 3), np.uint32), np.zeros(4, np.float32),
    np.array([[1 << 40, 0]], np.uint64), torch.zeros((4, 2), dtype=torch.int64),
    [-1, 2]])
def test_malformed_keys_raise(bad):
    with pytest.raises(ValueError):
        TH.normalize_keys(bad)
