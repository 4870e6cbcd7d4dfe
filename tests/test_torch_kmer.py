"""The port's k-mer tooling vs the JAX package's, bit-exact.

``synthetic_genome``, ``encode_bases``, ``kmer_keys`` (canonical or not,
k 21 and 31, through ``kernels.ops.kmer_pack``) and the plain version of
the k-mer pack kernel are deterministic in both packages: the same codes
give the same keys, tolerance 0. The JAX ``kmer_keys`` runs
``kmer_pack_pallas`` in interpret mode, as the JAX package's own tests
do on the CPU. The edges: k = 31, n = k (one k-mer), and all-A / all-T
runs (whose reverse complements are each other). The canonical k-mer pack
(the kernel's canonical instantiation on the GPU) is held on the CPU by its
plain version and ``kernels.ops.kmer_pack(canonical=True)`` for k about
the 16-code word edge of the kernel's packed stream and n in {k, k + 1, an
odd few thousand}.
"""

import numpy as np
import pytest
import torch

from repro.data import kmer as RK
from repro.kernels import ref as RREF
from repro_torch.data import kmer as TK
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import roofline
from repro_torch.kernels import kmer_pack as KP
from repro_torch.kernels.kmer_pack import kmer_pack_plain

torch.set_num_threads(1)

N_BASES = 4000


def _genome():
    """A few thousand bases with an all-A and an all-T run of 64."""
    g = RK.synthetic_genome(N_BASES, seed=11).copy()
    g[100:164] = 0
    g[1000:1064] = 3
    return g


def _u32(keys):
    return keys.numpy().view(np.uint32)


def test_synthetic_genome_and_encode_bases_bit_exact():
    for n, seed in ((N_BASES, 0), (20_000, 7), (300, 3)):
        np.testing.assert_array_equal(TK.synthetic_genome(n, seed),
                                      RK.synthetic_genome(n, seed))
    seq = "ACGTacgtTTGCA" * 5
    np.testing.assert_array_equal(TK.encode_bases(seq), RK.encode_bases(seq))
    with pytest.raises(ValueError, match="non-ACGT"):
        TK.encode_bases("ACGNT")


@pytest.mark.parametrize("canonical", [False, True], ids=["raw", "canonical"])
@pytest.mark.parametrize("k", [21, 31])
def test_kmer_keys_bit_exact(k, canonical):
    g = _genome()
    want = np.asarray(RK.kmer_keys(g, k=k, canonical=canonical))
    got = TK.kmer_keys(g, k=k, canonical=canonical, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (N_BASES - k + 1, 2)
    np.testing.assert_array_equal(_u32(got), want)
    # The same codes as a tensor stay on its device; any integer type.
    t = torch.from_numpy(g.astype(np.int64))
    assert torch.equal(TK.kmer_keys(t, k=k, canonical=canonical), got)


def test_kmer_edges_bit_exact():
    k = 31
    g = _genome()
    # n == k: one k-mer; an all-A and an all-T window are each other's
    # reverse complement, so both canonicalize to all-A (0).
    for window in (g[:k], g[100:100 + k], g[1000:1000 + k]):
        want = np.asarray(RK.kmer_keys(window, k=k))
        got = TK.kmer_keys(window, k=k, device="cpu")
        assert got.shape == (1, 2)
        np.testing.assert_array_equal(_u32(got), want)
    assert not TK.kmer_keys(g[100:100 + k], k=k, device="cpu").any()
    assert not TK.kmer_keys(g[1000:1000 + k], k=k, device="cpu").any()
    assert K.kmer_pack(torch.from_numpy(g[:k - 1]), k).shape == (0, 2)
    for bad in (0, 32, 33):
        with pytest.raises(ValueError, match="k must be"):
            K.kmer_pack(torch.from_numpy(g), bad)


@pytest.mark.parametrize("canonical", [True, False])
def test_r3_short_sequences_give_no_keys(canonical):
    """R3 (ROADMAP C): a sequence of 1 <= n <= k - 2 bases has no k-mer,
    and ``kmer_keys`` returns none. The JAX package's ``kmer_pack`` returns
    rows of its block padding there, so these cases are not compared with
    it."""
    k = 31
    g = _genome()
    for n in range(1, k - 1):
        got = TK.kmer_keys(g[:n], k=k, canonical=canonical, device="cpu")
        assert got.shape == (0, 2) and got.dtype == torch.int32
        assert K.kmer_pack(torch.from_numpy(g[:n]), k).shape == (0, 2)


@pytest.mark.parametrize("k", [21, 31])
def test_kmer_pack_plain_matches_reference_oracle(k):
    g = _genome()
    hi_j, lo_j = RREF.kmer_pack_ref(np.asarray(g, np.uint32), k)
    t = torch.from_numpy(g)
    hi_t, lo_t = TREF.kmer_pack_ref(t, k)
    np.testing.assert_array_equal(_u32(hi_t), np.asarray(hi_j))
    np.testing.assert_array_equal(_u32(lo_t), np.asarray(lo_j))
    got = kmer_pack_plain(t, k)
    m = N_BASES - k + 1
    np.testing.assert_array_equal(_u32(got[:, 0]), np.asarray(lo_j)[:m])
    np.testing.assert_array_equal(_u32(got[:, 1]), np.asarray(hi_j)[:m])


def test_kmer_keys_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TK.kmer_keys(_genome())
    with pytest.raises(ValueError, match="not on device"):
        TK.kmer_keys(torch.from_numpy(_genome()), device="meta")


@pytest.mark.parametrize("length", ["k", "k+1", "odd"])
@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 21, 31])
def test_canonical_pack_bit_exact(k, length):
    """``kmer_pack_plain(canonical=True)`` and ``ops.kmer_pack(canonical=
    True)`` on the CPU equal the JAX package's canonical ``kmer_keys``, as
    does the forward pack its forward keys. Short sequences are taken at
    the start, in the all-A run and in the all-T run; the odd length spans
    both runs."""
    g = _genome()
    n = {"k": k, "k+1": k + 1, "odd": 3001}[length]
    starts = (0,) if length == "odd" else (0, 100, 1000)
    for at in starts:
        window = g[at:at + n]
        t = torch.from_numpy(window)
        for canonical in (True, False):
            want = np.asarray(RK.kmer_keys(window, k=k, canonical=canonical))
            plain = kmer_pack_plain(t, k, canonical=canonical)
            assert plain.shape == (n - k + 1, 2)
            np.testing.assert_array_equal(_u32(plain), want)
            assert torch.equal(K.kmer_pack(t, k, canonical=canonical), plain)
            # Any integer type; only the low two bits of a code count.
            wide = t.to(torch.int64) | 12
            assert torch.equal(K.kmer_pack(wide, k, canonical=canonical),
                               plain)
            assert torch.equal(TK.kmer_keys(window, k=k, canonical=canonical,
                                            device="cpu"), plain)


def test_canonicalize_keeps_its_public_name_and_value():
    """``repro_torch.data.kmer.canonicalize`` is the kernels module's, and
    gives the JAX package's ``canonicalize`` on packed keys, including
    keys that are their own reverse complement's partner."""
    assert TK.canonicalize is KP.canonicalize
    g = _genome()
    for k in (15, 31):
        packed = kmer_pack_plain(torch.from_numpy(g), k)
        want = np.asarray(RK.canonicalize(_u32(packed), k))
        np.testing.assert_array_equal(_u32(TK.canonicalize(packed, k)), want)


def test_kmer_pack_bound_counts():
    """The canonical floor counts the forward one and more; the bytes are
    the same for both."""
    for n, k in ((100, 31), (31, 31), (248_956_422, 31), (5, 1)):
        fwd = roofline.kmer_pack_int_ops(n, k)
        assert fwd == 3 * n == roofline.kmer_pack_int_ops(n)
        can = roofline.kmer_pack_int_ops(n, k, canonical=True)
        assert can == 6 * n + 4 * (n - k + 1) >= fwd
        assert roofline.kmer_pack_bytes(n, k) == n + 8 * (n - k + 1)
    assert roofline.kmer_pack_int_ops(100, canonical=True) == 600 + 4 * 70
