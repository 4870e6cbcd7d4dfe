"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernels are
built with ``nvcc`` at first use); without them the tests skip. Run on a
machine with the GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports only torch and the port, so it also runs where JAX is
not installed. Each layout the kernels are built for is checked: hash64
and query bit-exact; direct insert and the mixed op stream on batches
small enough next to the table that concurrent inserts cannot contend,
where the kernel must agree with the sequential plain loop on ``ok`` and
on every bucket's tag multiset; the bucket-major bulk insert the same way
against its plain loop on the primary-bucket-sorted stream. Tiny tables
then force thousands of threads onto the same words, where the CAS
kernels are held by invariants. The orientation bulk build (torch ops,
deterministic) must leave the same table on the card as on the CPU, and
the legacy bulk route (bulk kernel, then the round loop) holds the
invariants. The frontier engine (torch ops, deterministic) leaves the
same table on the card as on the CPU, and the adapter's frontier route
(direct-insert kernel, then the frontier) fills to 0.95 under the
invariants. The k-mer pack and the Bloom kernels equal their plain
versions bit for bit. The unfused query and direct-insert kernels are
held as their fused counterparts are. Core ``delete`` and ``apply_ops``
(torch ops, deterministic) leave the same table on the card as on the
CPU, and ``FilterHandle.apply_ops`` on the card (the mixed-op kernel for
its net deletes, the insert kernels for its net inserts) gives core
``apply_ops``'s ``ok`` and the sequential oracle's. The flash-attention
kernel (both variants: tensor cores for bf16 at head sizes 32/64/128,
FMA otherwise) matches its plain version at 1e-4 in float32 and, for bf16
inputs, at 1e-2 in absolute error and in error over each row's largest
value; its bf16 output is its float32 output rounded; and the reduced
qwen served on the card through ``ServeEngine`` matches the same model on
the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch import amq
from repro_torch.core import CuckooConfig, keys_from_numpy
from repro_torch.core import cuckoo_filter as CF
from repro_torch.core import layout as L
from repro_torch.data.kmer import kmer_keys
from repro_torch.filters.blocked_bloom import BloomConfig
from repro_torch.kernels.bloom import bloom_insert_plain, bloom_query_plain
from repro_torch.core.cuckoo_filter import prepare_keys_plain
from repro_torch.kernels import ops as K
from repro_torch.kernels.cuckoo_insert import cuckoo_insert_direct_plain
from repro_torch.kernels.cuckoo_insert_bulk import cuckoo_insert_bulk_plain
from repro_torch.kernels.cuckoo_mixed import cuckoo_mixed_plain
from repro_torch.kernels.cuckoo_query import (cuckoo_query_plain,
                                              cuckoo_query_unfused_plain)
from repro_torch.kernels.hash64 import hash64_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.kmer_pack import kmer_pack_plain

pytestmark = pytest.mark.gpu

# (bucket_size, fp_bits, policy, hash_kind): every words-per-bucket width
# (1, 2, 4, 8, 16, 32) and both policies and hashes.
LAYOUTS = [
    (4, 8, "xor", "fmix32"),
    (8, 8, "offset", "xxhash64"),
    (16, 8, "xor", "xxhash64"),
    (32, 8, "xor", "fmix32"),
    (4, 16, "offset", "fmix32"),
    (16, 16, "xor", "fmix32"),
    (16, 16, "offset", "xxhash64"),
    (32, 16, "xor", "xxhash64"),
    (4, 32, "xor", "fmix32"),
    (16, 32, "offset", "fmix32"),
    (32, 32, "xor", "xxhash64"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _keys(seed, n, device):
    raw = np.random.default_rng(seed).integers(0, 2**64, size=n, dtype=np.uint64)
    return keys_from_numpy(raw, device)


def _cfg(bs, fb, policy, hash_kind, num_buckets=1 << 14):
    if policy == "offset":
        num_buckets -= 3
    return CuckooConfig(num_buckets=num_buckets, fp_bits=fb, bucket_size=bs,
                        policy=policy, hash_kind=hash_kind, seed=12345)


def _half_full(cfg, device, seed):
    """(state, keys it placed): a table at ~0.5 load, filled by the
    direct-insert kernel."""
    keys = _keys(seed, cfg.num_slots // 2, device)
    state, ok = K.cuckoo_insert_direct(cfg, cfg.init(device), keys)
    return state, keys[ok]


def _bucket_multisets(cfg, table):
    tags = L.unpack_words(L.gather_bucket_words(
        table, torch.arange(cfg.num_buckets, device=table.device), cfg.layout),
        cfg.fp_bits)
    return torch.sort(tags, dim=-1).values


def test_hash64_matches_plain(cuda):
    keys = _keys(0, 1 << 16, cuda)
    keys[:2] = torch.tensor([[0, 0], [-1, -1]], dtype=torch.int32)
    for kind in ("xxhash64", "fmix32"):
        for seed in (0, 0xDEADBEEFCAFEF00D):
            got = K.hash64(keys, seed, kind)
            want = hash64_plain(keys, seed, kind)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_query_matches_plain(cuda, layout):
    cfg = _cfg(*layout)
    state, placed = _half_full(cfg, cuda, 1)
    probe = torch.cat([placed[:4096], _keys(2, 4096, cuda)])
    got = K.cuckoo_query(cfg, state, probe)
    want = cuckoo_query_plain(cfg, state.table, probe)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[:4096].all()


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_insert_and_mixed_match_plain(cuda, layout):
    cfg = _cfg(*layout)
    state, _ = _half_full(cfg, cuda, 3)
    keys = _keys(4, 256, cuda)
    valid = torch.rand(256, generator=torch.Generator().manual_seed(0)) < 0.9

    t_kernel = state.table.clone()
    t_plain = state.table.clone()
    _, ok_kernel = K.cuckoo_insert_direct(
        cfg, state._replace(table=t_kernel), keys, valid.to(cuda))
    ok_plain = cuckoo_insert_direct_plain(cfg, t_plain, keys, valid.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(ok_kernel, ok_plain)
    assert torch.equal(_bucket_multisets(cfg, t_kernel),
                       _bucket_multisets(cfg, t_plain))

    # Mixed stream over a small key universe (same-key ops in one batch),
    # and a delete-only stream with duplicate keys.
    uni = torch.cat([keys[:8], _keys(5, 8, cuda)])
    picks = torch.randint(0, 16, (512,), generator=torch.Generator().manual_seed(1))
    mixed = torch.randint(0, 3, (512,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2))
    for ops in (mixed, torch.full((512,), 2, dtype=torch.int32)):
        sk, sp = t_kernel.clone(), t_plain.clone()
        _, ok_k = K.cuckoo_apply_ops(cfg, state._replace(table=sk),
                                     uni[picks.to(cuda)], ops.to(cuda))
        ok_p = cuckoo_mixed_plain(cfg, sp, uni[picks.to(cuda)], ops.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(ok_k, ok_p)
        assert torch.equal(_bucket_multisets(cfg, sk), _bucket_multisets(cfg, sp))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_unfused_kernels_match_plain(cuda, layout):
    """#3 answers as its plain version and as #2; #5 agrees with its plain
    loop on ``ok`` and every bucket's tag multiset, as #4 does."""
    cfg = _cfg(*layout)
    state, placed = _half_full(cfg, cuda, 15)
    probe = torch.cat([placed[:4096], _keys(16, 4096, cuda)])
    K.reset_launches()
    got = K.cuckoo_query(cfg, state, probe, fused=False)
    want = cuckoo_query_unfused_plain(cfg, state.table, probe)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and got[:4096].all()
    assert torch.equal(got, K.cuckoo_query(cfg, state, probe))

    keys = _keys(17, 256, cuda)
    valid = (torch.rand(256, generator=torch.Generator().manual_seed(4))
             < 0.9).to(cuda)
    t_kernel, t_plain = state.table.clone(), state.table.clone()
    st, ok_kernel = K.cuckoo_insert_direct(
        cfg, state._replace(table=t_kernel), keys, valid, fused=False)
    ok_plain = cuckoo_insert_direct_plain(cfg, t_plain, keys, valid)
    torch.cuda.synchronize()
    assert torch.equal(ok_kernel, ok_plain) and not ok_kernel[~valid].any()
    assert int(st.count) == int(state.count) + int(ok_kernel.sum())
    assert torch.equal(_bucket_multisets(cfg, t_kernel),
                       _bucket_multisets(cfg, t_plain))
    assert (K.LAUNCHES["cuckoo_query_unfused"],
            K.LAUNCHES["cuckoo_insert_unfused"]) == (1, 1)


def test_unfused_insert_under_contention_holds_invariants(cuda):
    """As for #4: 4x more keys than slots in one launch of #5."""
    cfg = CuckooConfig(num_buckets=64, fp_bits=16, bucket_size=16,
                       hash_kind="fmix32")
    keys = _keys(18, 4 * cfg.num_slots, cuda)
    state, ok = K.cuckoo_insert_direct(cfg, cfg.init(cuda), keys, fused=False)
    torch.cuda.synchronize()
    _hold_insert_invariants(cfg, state, keys, ok, cuda)


@pytest.mark.parametrize("mix", [(0.5, 0.4, 0.1), (0.95, 0.05, 0.0),
                                 (0.2, 0.4, 0.4)],
                         ids=["ycsb", "read_heavy", "churn"])
def test_apply_ops_on_the_card(cuda, mix):
    """Core ``apply_ops`` on the card leaves the CPU's table, ok and
    stats; the handle's ``apply_ops`` on the card gives core
    ``apply_ops``'s ``ok`` on a copy of the same table, and the
    sequential oracle's, batch after batch, with its count exact."""
    capacity = 62_259                                 # floor(0.95 * 2**16)
    rng = np.random.default_rng(19)
    pre = rng.integers(0, 2**63, size=capacity // 2, dtype=np.uint64)
    h = amq.make("cuckoo", capacity=capacity)
    oracle = amq.make("cpu-cuckoo", capacity=capacity, hash_kind="fmix32")
    h.insert(pre, bulk=True)
    oracle.insert(pre)
    n = 8192
    for _ in range(3):
        raw = np.where(rng.random(n) < 0.5, pre[rng.integers(0, pre.size, n)],
                       rng.integers(0, 2**63, size=n, dtype=np.uint64))
        p = np.array(mix)
        batch = amq.OpBatch.make(raw, rng.choice(3, size=n, p=p / p.sum()),
                                 rng.random(n) < 0.95, device=cuda)
        core = {}
        for dev in ("cpu", cuda):
            state = CF.CuckooState(h.state.table.clone().to(dev),
                                   h.state.count.clone().to(dev))
            core[dev] = CF.apply_ops(h.config, state, batch.keys.to(dev),
                                     batch.ops.to(dev), batch.valid.to(dev))
        (sc, okc, stc), (sg, okg, stg) = core["cpu"], core[cuda]
        assert torch.equal(sg.table.cpu(), sc.table) and torch.equal(okg.cpu(), okc)
        assert torch.equal(stg.evictions.cpu(), stc.evictions)
        assert int(stg.rounds) == int(stc.rounds)
        rep = h.apply_ops(batch)
        torch.cuda.synchronize()
        assert torch.equal(rep.ok.cpu(), okc)
        assert torch.equal(rep.ok.cpu(), oracle.apply_ops(batch).ok)
        assert h.count() == oracle.count() == int(sg.count)
        tags = L.unpack_words(L.gather_bucket_words(
            h.state.table, torch.arange(h.config.num_buckets, device=cuda),
            h.config.layout), h.config.fp_bits)
        assert int((tags != 0).sum()) == h.count()


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_bulk_insert_matches_plain(cuda, layout):
    cfg = _cfg(*layout)
    state, _ = _half_full(cfg, cuda, 9)
    keys = _keys(10, 256, cuda)
    valid = (torch.rand(256, generator=torch.Generator().manual_seed(3))
             < 0.9).to(cuda)
    t_kernel, t_plain = state.table.clone(), state.table.clone()
    K.reset_launches()
    st, ok_kernel = K.cuckoo_insert_bulk(cfg, state._replace(table=t_kernel),
                                         keys, valid)
    ok_plain = cuckoo_insert_bulk_plain(cfg, t_plain, keys, valid)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cuckoo_insert_bulk"] == 1
    assert torch.equal(ok_kernel, ok_plain)
    assert not ok_kernel[~valid].any()
    assert int(st.count) == int(state.count) + int(ok_kernel.sum())
    assert torch.equal(_bucket_multisets(cfg, t_kernel),
                       _bucket_multisets(cfg, t_plain))


def _hold_insert_invariants(cfg, state, keys, ok, device):
    """count == ok.sum() == stored tags; every placed key is found; every
    stored tag sits in one of a placed key's buckets; a key was turned down
    only with both of its buckets full."""
    tags = L.unpack_words(L.gather_bucket_words(
        state.table, torch.arange(cfg.num_buckets, device=device), cfg.layout),
        cfg.fp_bits)
    assert int(state.count) == int(ok.sum()) == int((tags != 0).sum())
    assert bool(K.cuckoo_query(cfg, state, keys[ok]).all())
    full = (tags != 0).all(dim=-1)
    _, i1, i2 = prepare_keys_plain(cfg, keys[~ok])
    assert bool(full[i1].all()) and bool(full[i2].all())
    tag, j1, j2 = prepare_keys_plain(cfg, keys[ok])
    allowed = (set(zip(j1.tolist(), tag.tolist()))
               | set(zip(j2.tolist(), tag.tolist())))
    b, s = tags.nonzero(as_tuple=True)
    assert set(zip(b.tolist(), tags[b, s].tolist())) <= allowed


def test_bulk_insert_under_contention_holds_invariants(cuda):
    """4x more keys than slots (64x more than buckets): primary-bucket
    segments of ~64 keys overflow into secondaries that other segments
    own, so cached words go stale and secondary CASes collide."""
    cfg = CuckooConfig(num_buckets=64, fp_bits=16, bucket_size=16,
                       hash_kind="fmix32")
    keys = _keys(11, 4 * cfg.num_slots, cuda)
    state, ok = K.cuckoo_insert_bulk(cfg, cfg.init(cuda), keys)
    torch.cuda.synchronize()
    assert int(ok.sum()) > cfg.num_slots * 0.9
    _hold_insert_invariants(cfg, state, keys, ok, cuda)


def test_bulk_fills_on_the_card(cuda):
    """The orientation build equals the CPU run bit for bit; the legacy
    bulk route (bulk kernel + round loop) places every key to 0.95."""
    capacity = 62_259                                 # floor(0.95 * 2**16)
    raw = np.random.default_rng(12).integers(0, 2**63, size=capacity,
                                             dtype=np.uint64)
    gpu = amq.make("cuckoo", capacity=capacity)
    cpu = amq.make("cuckoo", capacity=capacity, device="cpu")
    legacy = amq.make("cuckoo", capacity=capacity, insert_engine="legacy")
    K.reset_launches()
    for chunk in np.array_split(raw, 8):
        rg, rc = gpu.insert(chunk, bulk=True), cpu.insert(chunk, bulk=True)
        assert torch.equal(rg.ok.cpu(), rc.ok) and int(rg.rounds) == int(rc.rounds)
        assert bool(legacy.insert(chunk, bulk=True).ok.all())
    assert torch.equal(gpu.state.table.cpu(), cpu.state.table)
    assert gpu.count() == cpu.count() == capacity
    assert K.LAUNCHES["cuckoo_insert_bulk"] == 8
    keys = keys_from_numpy(raw, cuda)
    _hold_insert_invariants(legacy.config, legacy.state, keys,
                            torch.ones(capacity, dtype=torch.bool,
                                       device=cuda), cuda)


def test_insert_under_contention_holds_invariants(cuda):
    """4x more keys than slots in one launch: thousands of threads CAS the
    same words. Every placed key is stored once and queryable, and every
    key that failed has both of its buckets full."""
    cfg = CuckooConfig(num_buckets=64, fp_bits=16, bucket_size=16,
                       hash_kind="fmix32")
    keys = _keys(6, 4 * cfg.num_slots, cuda)
    state, ok = K.cuckoo_insert_direct(cfg, cfg.init(cuda), keys)
    torch.cuda.synchronize()
    _hold_insert_invariants(cfg, state, keys, ok, cuda)


def test_deletes_under_contention_follow_batch_order(cuda):
    """Duplicate copies of 256 keys, then a shuffled stream of duplicate
    deletes: concurrent segments race on shared words, yet each key
    removes exactly min(copies, deletes) copies — its first deletes in
    batch order — and keeps the rest queryable."""
    cfg = CuckooConfig(num_buckets=128, fp_bits=16, bucket_size=16,
                       hash_kind="fmix32")
    rng = np.random.default_rng(7)
    uni = _keys(8, 256, cuda)
    copies = rng.integers(1, 4, size=256)
    dels = rng.integers(0, 5, size=256)
    ins_idx = torch.from_numpy(np.repeat(np.arange(256), copies)).to(cuda)
    state, ok = K.cuckoo_insert_direct(cfg, cfg.init(cuda), uni[ins_idx])
    assert bool(ok.all())
    order = rng.permutation(np.repeat(np.arange(256), dels))
    ops = torch.full((order.size,), 2, dtype=torch.int32, device=cuda)
    stream = uni[torch.from_numpy(order).to(cuda)]
    state2, ok_del = K.cuckoo_apply_ops(cfg, state, stream, ops)
    torch.cuda.synchronize()
    seen = np.zeros(256, np.int64)
    want = np.zeros(order.size, bool)
    for j, k in enumerate(order):
        want[j] = seen[k] < copies[k]
        seen[k] += 1
    np.testing.assert_array_equal(ok_del.cpu().numpy(), want)
    assert int(state2.count) == int(copies.sum()) - int(want.sum())
    left = torch.from_numpy(copies - np.minimum(copies, dels) > 0).to(cuda)
    assert bool(K.cuckoo_query(cfg, state2, uni[left]).all())


def test_frontier_on_the_card(cuda):
    """Core ``_insert_frontier`` leaves the CPU's table, ok and stats on
    the card; the adapter's frontier route (``insert_engine="frontier"``)
    fills to 0.95 in eight batches under the invariants, launching the
    direct kernel."""
    cfg = CuckooConfig(num_buckets=64, bucket_size=4, fp_bits=16,
                       hash_kind="fmix32", max_evictions=256)
    raw = np.random.default_rng(13).integers(0, 2**64, size=243,
                                             dtype=np.uint64)
    out = {dev: CF._insert_frontier(cfg, cfg.init(dev),
                                    keys_from_numpy(raw, dev))
           for dev in ("cpu", cuda)}
    (sc, okc, stc), (sg, okg, stg) = out["cpu"], out[cuda]
    assert torch.equal(sg.table.cpu(), sc.table)
    assert torch.equal(okg.cpu(), okc)
    assert torch.equal(stg.evictions.cpu(), stc.evictions)
    assert int(stg.rounds) == int(stc.rounds)

    capacity = 62_259                                 # floor(0.95 * 2**16)
    raw = np.random.default_rng(14).integers(0, 2**63, size=capacity,
                                             dtype=np.uint64)
    h = amq.make("cuckoo", capacity=capacity, insert_engine="frontier")
    assert CF.resolve_engine(h.config, False) == "frontier"
    K.reset_launches()
    CF.FRONTIER_KEYS = []
    try:
        for chunk in np.array_split(raw, 8):
            assert bool(h.insert(chunk).ok.all())
        residue = int(sum(CF.FRONTIER_KEYS))
    finally:
        CF.FRONTIER_KEYS = None
    assert K.LAUNCHES["cuckoo_insert_direct"] == 8 and residue > 0
    _hold_insert_invariants(h.config, h.state, keys_from_numpy(raw, cuda),
                            torch.ones(capacity, dtype=torch.bool,
                                       device=cuda), cuda)


@pytest.mark.parametrize("k", [1, 21, 31])
def test_kmer_pack_matches_plain(cuda, k):
    codes = torch.from_numpy(np.random.default_rng(k).integers(
        0, 4, size=(1 << 16) + 7, dtype=np.uint8)).to(cuda)
    codes[:64] = 0                                     # an all-A run
    codes[64:128] = 3                                  # an all-T run
    K.reset_launches()
    got = K.kmer_pack(codes, k)
    want = kmer_pack_plain(codes, k)
    wide = K.kmer_pack(codes.to(torch.int64) | 4, k)   # high bits ignored
    torch.cuda.synchronize()
    assert K.LAUNCHES["kmer_pack"] == 2
    assert got.shape == (codes.shape[0] - k + 1, 2)
    assert torch.equal(got, want) and torch.equal(wide, want)
    assert torch.equal(K.kmer_pack(codes[:k], k), want[:1])
    assert torch.equal(kmer_keys(codes, k).cpu(),
                       kmer_keys(codes.cpu(), k, device="cpu"))


@pytest.mark.parametrize("wpb,k,hash_kind", [(16, 8, "fmix32"),
                                             (16, 8, "xxhash64"),
                                             (4, 11, "fmix32"),
                                             (1, 3, "xxhash64")])
def test_bloom_matches_plain(cuda, wpb, k, hash_kind):
    cfg = BloomConfig.for_capacity(20_000, words_per_block=wpb, k=k,
                                   hash_kind=hash_kind, seed=99)
    keys = _keys(15, 20_000, cuda)
    valid = (torch.rand(20_000, generator=torch.Generator().manual_seed(4))
             < 0.9).to(cuda)
    K.reset_launches()
    state, ok = K.bloom_insert(cfg, cfg.init(cuda), keys, valid)
    table = cfg.init(cuda).table
    bloom_insert_plain(cfg, table, keys, valid)
    torch.cuda.synchronize()
    assert torch.equal(state.table, table)
    assert torch.equal(ok, valid) and int(state.count) == int(valid.sum())
    probe = torch.cat([keys, _keys(16, 20_000, cuda)])
    hit = K.bloom_query(cfg, state, probe)
    assert torch.equal(hit, bloom_query_plain(cfg, table, probe))
    assert bool(hit[:20_000][valid].all())
    assert K.LAUNCHES["bloom_insert"] == 1 and K.LAUNCHES["bloom_query"] == 1
    h = amq.make("bloom", capacity=20_000)
    h.insert(keys)
    assert bool(h.query(keys).hits.all())


# (BK, g, Sq, Sk, D, Dv, causal, window, q_offset, dtype): the five shapes
# of tests/test_flash_kernel.py in the kernel layout, then bf16 at every
# tensor-core head size, bf16 through the FMA variant (Dv != D), a
# windowed bf16 case with a query offset, and rows that see no key.
FLASH_CASES = [
    (4, 3, 192, 256, 64, 32, True, None, 0, torch.float32),
    (4, 3, 192, 256, 64, 32, True, 64, 0, torch.float32),
    (4, 1, 256, 256, 128, 128, False, None, 0, torch.float32),
    (1, 8, 100, 130, 32, 32, True, None, 0, torch.float32),
    (4, 2, 128, 128, 64, 64, True, None, 0, torch.bfloat16),
    (3, 2, 300, 300, 128, 128, True, None, 0, torch.bfloat16),
    (2, 1, 77, 200, 32, 32, False, None, 0, torch.bfloat16),
    (2, 3, 130, 130, 64, 32, True, None, 0, torch.bfloat16),
    (2, 2, 96, 224, 128, 128, True, 50, 128, torch.bfloat16),
    (2, 1, 64, 64, 64, 64, True, 0, 0, torch.bfloat16),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "{}x{}x{}x{}d{}v{}c{}w{}o{}{}".format(*c[:9], str(c[9])[6:]))
def test_flash_attention_matches_plain(cuda, case):
    BK, g, Sq, Sk, D, Dv, causal, window, q_offset, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(Sq * Sk + D)
    q = (torch.randn((BK, g, Sq, D), generator=gen, device=cuda) * 0.3).to(dtype)
    k = (torch.randn((BK, Sk, D), generator=gen, device=cuda) * 0.3).to(dtype)
    v = (torch.randn((BK, Sk, Dv), generator=gen, device=cuda) * 0.3).to(dtype)
    K.reset_launches()
    got = K.flash_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        # The tensor cores take P rounded to bf16 (about 2^-9 a weight;
        # chip_smoke.py's flash phase reads at most 4.2e-3 in either
        # measure on an H100). The row measure sees a zeroed row or a
        # dropped key in a row of small values.
        err = (got - want).abs()
        row = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert float(err.max()) <= 1e-2
        assert float((err / row).max()) <= 1e-2
    if window == 0:
        assert not bool(got.any())         # every key masked: zeros
    got_bf16 = K.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, out_dtype=torch.bfloat16)
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((2, 1, 8, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((2, 8, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="softcap"):
        K.flash_attention(q, k, k, attn_softcap=30.0)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    with pytest.raises(TypeError):
        K.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="out_dtype"):
        K.flash_attention(q, k, k, out_dtype=torch.float16)


def test_serve_engine_on_the_card(cuda):
    """The reduced qwen through ServeEngine on the card: prefill logits
    and caches within the model tolerance of the same weights on the CPU,
    the flash kernel launched once a layer a prefill, the prefix cache's
    counters equal to the CPU run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen1_5_4b").reduced()
    cpu = build_model(cfg, device="cpu", seed=3)
    gpu = build_model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    pool = [rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
            for _ in range(6)]
    ref_logits, ref_caches = cpu.prefill(torch.as_tensor(pool[0]))
    K.reset_launches()
    logits, caches = gpu.prefill(torch.as_tensor(pool[0]))
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == cfg.num_layers
    ref = ref_logits.numpy()
    atol = max(5e-2, 2e-2 * float(np.abs(ref).max()))
    np.testing.assert_allclose(logits.cpu().numpy(), ref, rtol=5e-2, atol=atol)
    for c, rc in zip(caches, ref_caches):
        np.testing.assert_allclose(c.k.float().cpu().numpy(),
                                   rc.k.float().numpy(), rtol=5e-2, atol=5e-2)
    stats = {}
    for dev, model in (("cpu", cpu), ("gpu", gpu)):
        engine = ServeEngine(model, batch=2, max_len=32,
                             prefix_cache_entries=4)
        K.reset_launches()
        for i in [0, 1, 2, 3, 1, 2, 4, 5, 0, 1]:
            tokens, st = engine.generate(pool[i], steps=8)
            assert tokens.shape == (2, 9)
        st.pop("filter_service")
        stats[dev] = st
    assert K.LAUNCHES["flash_attention"] == cfg.num_layers * 8
    assert K.LAUNCHES["cuckoo_mixed"] > 0 and K.LAUNCHES["hash64"] > 0
    assert K.LAUNCHES["cuckoo_insert_direct"] > 0
    assert stats["gpu"] == stats["cpu"]
    assert stats["gpu"]["hits"] == 2 and stats["gpu"]["evictions"] == 4
