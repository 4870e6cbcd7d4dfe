"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernels are
built with ``nvcc`` at first use); without them the tests skip. Run on a
machine with the GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports only torch and the port, so it also runs where JAX is
not installed. Each layout the kernels are built for is checked: hash64
and query bit-exact, the query also on tables whose hits are known in
every case of buckets i1 and i2 (``_query_tables``), where its early exit
(bucket i2 read only when i1 holds no matching tag) decides; direct insert on batches
small enough next to the table that concurrent inserts cannot contend,
and the mixed op stream (keys that occur once, every key repeated, a mix,
one op, repeats of a masked op) over keys that share no bucket, where the
kernels must agree with the sequential plain loop on ``ok`` and on every
bucket's tag multiset, and the mixed route walks only repeated keys (also
with runs enough for each of the walk's three modes); the bucket-major bulk insert the same way
against its plain loop on the primary-bucket-sorted stream. Tiny tables
then force thousands of threads onto the same words, where the CAS
kernels are held by invariants. The orientation bulk build (torch ops,
deterministic) must leave the same table on the card as on the CPU, and
the legacy bulk route (bulk kernel, then the round loop) holds the
invariants. The frontier engine (torch ops, deterministic) leaves the
same table on the card as on the CPU, and the adapter's frontier route
(direct-insert kernel, then the frontier) fills to 0.95 under the
invariants. The k-mer pack and the Bloom kernels equal their plain
versions bit for bit, the Bloom query by both of its routes (the
windowed one on small tables where the route rule is shown a small
L2). The unfused query and direct-insert kernels (#3, #5), which share
their fused siblings' reads and CAS loop and differ only in the scan,
are held as those are: on the crafted tables, under contention and in
every test below. The direct-insert kernels are also
held exactly to the plain loop on tables near load 0.9, where keys go on
to bucket i2 or are turned down, with keys chosen so that no two share a
bucket: over every layout, on a 64-bucket XOR table where some keys have
one candidate bucket, at batch edges, with a ``valid`` mask ending False,
and with every key twice (a key with one free slot places exactly one
copy). Core ``delete`` and ``apply_ops``
(torch ops, deterministic) leave the same table on the card as on the
CPU, and ``FilterHandle.apply_ops`` on the card (the mixed-op kernel for
its net deletes, the insert kernels for its net inserts) gives core
``apply_ops``'s ``ok`` and the sequential oracle's. The flash-attention
kernel (both variants: wgmma for bf16 at head sizes 32/64/128, FMA
otherwise) matches its plain version at 1e-4 in float32 and, for bf16
inputs, at 1e-2 in absolute error and in error over each row's largest
value; its bf16 output is its float32 output rounded; the model-layout
entry on strided [B, S, H, D] views gives the same bits; and the reduced
qwen served on the card through ``ServeEngine`` matches the same model on
the CPU. The lifecycle on the card: a snapshot and ``from_snapshot``
round trip (the twin's table equal word for word, owned: an insert into
it leaves the original and the snapshot as they were), a cascade whose
levels span fp 8, 16 and 32 at bucket 16 (XOR, fmix32), each level's
query equal to its plain version, and a demoted level's host probe equal
to its device query. The dynamic baselines: the GQF's serial kernels (G1
insert, G2 delete) equal their plain loops word for word at loads 0.5,
0.9 and 0.99 and remainder bits 8, 16 and 28 (R6's wrap), and the TCF's
and BCHT's tables on the card equal the CPU's. The mesh-sharded filter
(4 shards on the card): the core driver's tables and answers equal the
CPU's; the ``sharded-cuckoo`` adapter runs the query, direct-insert and
mixed-op kernels on every partition, routes as on the CPU, keeps each
partition's count, answers ``apply_ops`` as the core driver does and
reshards exactly. Dedup on the card: ``sequence_keys`` and the Bloom
dedup equal the CPU's; a streaming deduper on a cascade of shards masks
every repeat.
"""

import numpy as np
import pytest
import torch

from repro_torch import amq, convert
from repro_torch.core import CuckooConfig, keys_from_numpy
from repro_torch.core.bits64 import to_i32
from repro_torch.core import cuckoo_filter as CF
from repro_torch.core import layout as L
from repro_torch.core import sharded_filter as SF
from repro_torch.core.hashing import keys_to_numpy
from repro_torch.data import dedup as DD
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.data.kmer import kmer_keys
from repro_torch.filters import bcht as HTm
from repro_torch.filters import quotient as QF
from repro_torch.filters import two_choice as TCm
from repro_torch.filters.blocked_bloom import BloomConfig
from repro_torch.kernels import bloom as bloom_kernels
from repro_torch.kernels.bloom import bloom_insert_plain, bloom_query_plain
from repro_torch.core.cuckoo_filter import prepare_keys_plain
from repro_torch.kernels import ops as K
from repro_torch.kernels.cuckoo_insert import cuckoo_insert_direct_plain
from repro_torch.kernels import cuckoo_insert_bulk as bulk_module
from repro_torch.kernels.cuckoo_insert_bulk import cuckoo_insert_bulk_plain
from repro_torch.kernels.cuckoo_mixed import cuckoo_mixed_plain
from repro_torch.kernels.cuckoo_query import (cuckoo_query_plain,
                                              cuckoo_query_unfused_plain)
from repro_torch.kernels.hash64 import hash64_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels import kmer_pack as kmer_pack_module
from repro_torch.kernels.kmer_pack import kmer_pack_plain

from _query_tables import crafted_query_table, expected_cases

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
    (16, 32, "xor", "fmix32"),      # the cascade's deep levels
]
# The fused kernels (#2, #4: SWAR scans) and the unfused ones (#3, #5:
# lane-by-lane scans), which share their reads and CAS loop.
FUSED = [True, False]
FUSED_IDS = ["fused", "unfused"]
QUERY_KERNEL = {True: "cuckoo_query", False: "cuckoo_query_unfused"}
QUERY_PLAIN = {True: cuckoo_query_plain, False: cuckoo_query_unfused_plain}
INSERT_KERNEL = {True: "cuckoo_insert_direct", False: "cuckoo_insert_unfused"}


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


@pytest.mark.parametrize("fused", FUSED, ids=FUSED_IDS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_query_early_exit_matches_plain(cuda, layout, fused):
    """#2 and #3 read bucket i2 only where bucket i1 holds no matching tag.
    On tables whose hits are known (the tag only in i2 past a full i1, only
    in i1, in both, in neither; XOR keys with i1 == i2, which 8-bit tags
    give only in the 64-bucket table; OFFSET keys with the base tag in i2),
    in one launch of the crafted keys drawn 2^16 times in random order, so
    that warps mix the cases: equal to the plain version and to the
    expected hits, bit for bit."""
    seen = set()
    for num_buckets in (64, 1 << 10):
        cfg = _cfg(*layout, num_buckets=num_buckets)
        keys, words, want, cases = crafted_query_table(
            cfg, _keys(30, 1 << 14, "cpu"), 31)
        seen.update(cases)
        state = convert.state_from_numpy(
            {"table": words, "count": np.int32(keys.shape[0])}, cuda)
        pick = torch.from_numpy(np.random.default_rng(32).integers(
            0, keys.shape[0], size=1 << 16))
        probe = torch.cat([keys, keys[pick]]).to(cuda)
        K.reset_launches()
        got = K.cuckoo_query(cfg, state, probe, fused=fused)
        plain = QUERY_PLAIN[fused](cfg, state.table, probe)
        torch.cuda.synchronize()
        assert K.LAUNCHES[QUERY_KERNEL[fused]] == 1
        assert K.LAUNCHES[QUERY_KERNEL[not fused]] == 0
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(
            got.cpu().numpy(), np.concatenate([want, want[pick.numpy()]]))
    assert seen == expected_cases(layout[2])


# The mixed op streams: keys that occur once, every key repeated, a mix of
# both, one op, and repeats of a masked op (beside keys that occur once).
MIXED_STREAMS = ["distinct", "repeated", "mix", "one_op", "invalid_repeats"]


def _mixed_stream(cfg, stream, stored, device):
    """(keys, ops, valid) of one stream over stored and fresh keys that
    share no bucket, so that the order of different keys' ops cannot
    matter, and whether the route must walk repeated keys."""
    pool = torch.cat([stored[:2048], _keys(5, 2048, device)])
    keep = _disjoint(cfg, pool)
    uni = pool[keep[torch.randperm(keep.numel(), generator=torch.Generator()
                                   .manual_seed(6))[:512].to(device)]]
    rng = np.random.default_rng(7)
    if stream == "distinct":
        picks = np.arange(512)
    elif stream == "repeated":
        picks = rng.integers(0, 16, size=512)
    elif stream == "mix":
        picks = rng.permutation(np.concatenate(
            [np.arange(16, 272), rng.integers(0, 16, size=256)]))
    elif stream == "one_op":
        picks = np.zeros(1, np.int64)
    else:
        picks = rng.permutation(np.concatenate(
            [np.arange(2, 258), np.zeros(16, np.int64), np.ones(8, np.int64)]))
    n = picks.size
    ops = torch.from_numpy(rng.integers(0, 3, size=n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    if stream == "invalid_repeats":   # key 0 always masked, key 1 valid once
        valid = torch.from_numpy(picks != 0)
        valid[np.flatnonzero(picks == 1)[1:]] = False
    walks = stream in ("repeated", "mix")
    return uni[torch.from_numpy(picks).to(device)], ops.to(device), \
        valid.to(device), walks


@pytest.mark.parametrize("stream", MIXED_STREAMS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_insert_and_mixed_match_plain(cuda, layout, stream):
    cfg = _cfg(*layout)
    state, placed = _half_full(cfg, cuda, 3)
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

    # The stream with its ops, and as a delete-only stream: ok and every
    # bucket's tag multiset equal the plain loop's in batch order; the walk
    # runs exactly where a valid key repeats.
    mixed, ops, valid, walks = _mixed_stream(
        cfg, stream, torch.cat([keys[ok_kernel], placed]), cuda)
    for stream_ops in (ops, torch.full_like(ops, 2)):
        sk, sp = t_kernel.clone(), t_plain.clone()
        K.reset_launches()
        _, ok_k = K.cuckoo_apply_ops(cfg, state._replace(table=sk), mixed,
                                     stream_ops, valid)
        ok_p = cuckoo_mixed_plain(cfg, sp, mixed, stream_ops, valid)
        torch.cuda.synchronize()
        assert torch.equal(ok_k, ok_p) and not ok_k[~valid].any()
        assert torch.equal(_bucket_multisets(cfg, sk), _bucket_multisets(cfg, sp))
        assert K.LAUNCHES["cuckoo_mixed"] == 1
        assert K.LAUNCHES["cuckoo_mixed_walk"] == int(walks)


def test_mixed_walk_across_the_grid(cuda):
    """8192 keys with two ops each, 2500 with 14 and 64 with 40: the walk's
    first rounds scan every position across the grid, the next read a list
    of the open runs across the grid, the last run in block 0 alone. ``ok``
    and every bucket's tag multiset equal the plain loop's."""
    cfg = _cfg(16, 16, "xor", "fmix32", num_buckets=1 << 18)
    state, placed = _half_full(cfg, cuda, 9)
    pool = torch.cat([placed[:16384], _keys(10, 16384, cuda)])
    uni = pool[_disjoint(cfg, pool)[:10756]]
    rng = np.random.default_rng(11)
    ops_a_key = np.repeat([2, 14, 40], [8192, 2500, 64])
    picks = torch.from_numpy(rng.permutation(np.repeat(
        np.arange(10756), ops_a_key))).to(cuda)
    keys = uni[picks]
    ops = torch.from_numpy(rng.integers(0, 3, size=picks.numel())
                           .astype(np.int32)).to(cuda)
    t_kernel, t_plain = state.table.clone(), state.table.clone()
    K.reset_launches()
    _, ok = K.cuckoo_apply_ops(cfg, state._replace(table=t_kernel), keys, ops)
    ok_plain = cuckoo_mixed_plain(cfg, t_plain, keys, ops)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cuckoo_mixed_walk"] == 1
    assert torch.equal(ok, ok_plain)
    assert torch.equal(_bucket_multisets(cfg, t_kernel),
                       _bucket_multisets(cfg, t_plain))


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


def _bulk_route(monkeypatch, cfg, n, windows):
    """Show kernel #6's route rule an L2 that cuts ``cfg``'s table into
    ``windows`` windows and asks no keys a bucket (``windows`` 1: the rule
    of this card, whose L2 holds the test's tables: the insert pass
    alone). Returns the plan the wrapper will take."""
    if windows > 1:
        bucket_bytes = 4 * cfg.layout.words_per_bucket
        s = (-(-cfg.num_buckets // windows) - 1).bit_length()
        l2 = 5 * (bucket_bytes << s) + 4
        monkeypatch.setattr(bulk_module, "l2_bytes", lambda device: l2)
        monkeypatch.setattr(bulk_module, "WINDOWED_KEYS_PER_BUCKET", 0)
    plan = bulk_module.bulk_plan(cfg, n, bulk_module.l2_bytes(
        torch.device("cuda")))
    assert plan.windowed == (windows > 1)
    assert not plan.windowed or plan.windows == windows
    return plan


@pytest.mark.parametrize("windows", [1, 16], ids=["one-window", "16-windows"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_bulk_insert_matches_plain(cuda, monkeypatch, layout, windows):
    """Kernel #6 by each route on keys that share no bucket, so that every
    order of its CASes gives the sequential loop's outcome."""
    cfg = _cfg(*layout)
    state, _ = _half_full(cfg, cuda, 9)
    pool = _keys(10, 4096, cuda)
    keys = pool[_disjoint(cfg, pool)[:1024]]
    n = keys.shape[0]
    valid = (torch.rand(n, generator=torch.Generator().manual_seed(3))
             < 0.9).to(cuda)
    _bulk_route(monkeypatch, cfg, n, windows)
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


# (layout, keys a bucket, the share of keys masked out) of kernel #6's
# windowed route on 2^14-bucket tables cut into 16 windows, into the empty
# table: eight keys a bucket (the long segments' shape, load 0.5 at 16
# slots); a mask with a random fifth, a whole tile and the tail masked
# out, with a ragged last tile; the offset policy, whose last window is
# short; every key masked out.
WINDOWED_CASES = [
    pytest.param((16, 16, "xor", "fmix32"), 8, None, id="eight-keys-a-bucket"),
    pytest.param((16, 16, "xor", "xxhash64"), 3.1, "mixed", id="partly-invalid"),
    pytest.param((8, 8, "offset", "fmix32"), 2, None, id="offset-short-window"),
    pytest.param((4, 8, "xor", "fmix32"), 1, "all", id="all-invalid"),
]


@pytest.mark.parametrize("layout,per_bucket,masked", WINDOWED_CASES)
def test_bulk_windowed_route_holds_invariants(cuda, monkeypatch, layout,
                                              per_bucket, masked):
    cfg = _cfg(*layout)
    n = int(per_bucket * cfg.num_buckets)
    keys = _keys(13, n, cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    if masked == "mixed":
        valid = (torch.rand(n, generator=torch.Generator().manual_seed(8))
                 >= 0.2).to(cuda)
        valid[4096:8192] = False
        valid[-1000:] = False
    elif masked == "all":
        valid[:] = False
    _bulk_route(monkeypatch, cfg, n, 16)
    K.reset_launches()
    state, ok = K.cuckoo_insert_bulk(cfg, cfg.init(cuda), keys, valid)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cuckoo_insert_bulk"] == 1
    assert not ok[~valid].any()
    assert int(ok.sum()) > 0.9 * min(int(valid.sum()), cfg.num_slots) or (
        masked == "all")
    # The masked keys were never tried: the invariants hold on the others.
    _hold_insert_invariants(cfg, state, keys[valid], ok[valid], cuda)


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
    alt = cfg.placement.place_tag(tag, True)   # the tag as bucket i2 holds it
    allowed = (set(zip(j1.tolist(), tag.tolist()))
               | set(zip(j2.tolist(), alt.tolist())))
    b, s = tags.nonzero(as_tuple=True)
    assert set(zip(b.tolist(), tags[b, s].tolist())) <= allowed


@pytest.mark.parametrize("windows", [1, 16], ids=["one-window", "16-windows"])
def test_bulk_insert_under_contention_holds_invariants(cuda, monkeypatch,
                                                       windows):
    """4x more keys than slots (64x more than buckets): keys of one primary
    bucket race each other's CASes and overflow into secondaries that
    other keys fill, so cached words go stale and CASes collide."""
    cfg = CuckooConfig(num_buckets=64, fp_bits=16, bucket_size=16,
                       hash_kind="fmix32")
    keys = _keys(11, 4 * cfg.num_slots, cuda)
    _bulk_route(monkeypatch, cfg, keys.shape[0], windows)
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


@pytest.mark.parametrize("fused", FUSED, ids=FUSED_IDS)
def test_insert_under_contention_holds_invariants(cuda, fused):
    """4x more keys than slots in one launch of #4 or #5: thousands of
    threads CAS the same words, and lost CASes refresh their word. Every
    placed key is stored once and queryable, and every key that failed
    has both of its buckets full."""
    cfg = CuckooConfig(num_buckets=64, fp_bits=16, bucket_size=16,
                       hash_kind="fmix32")
    keys = _keys(6 if fused else 18, 4 * cfg.num_slots, cuda)
    K.reset_launches()
    state, ok = K.cuckoo_insert_direct(cfg, cfg.init(cuda), keys, fused=fused)
    torch.cuda.synchronize()
    assert K.LAUNCHES[INSERT_KERNEL[fused]] == 1
    _hold_insert_invariants(cfg, state, keys, ok, cuda)


def _dense_table(cfg, seed, device):
    """A table near load 0.9 from random tags: half the buckets full, in the
    rest each slot filled with probability 0.8. Most keys find bucket i1
    full and go on to bucket i2; about a quarter find both full."""
    rng = np.random.default_rng(seed)
    nb, bs = cfg.num_buckets, cfg.bucket_size
    filled = (rng.random(nb) < 0.5)[:, None] | (rng.random((nb, bs)) < 0.8)
    tags = torch.from_numpy(rng.integers(1, 1 << cfg.fp_bits, size=(nb, bs))
                            * filled)
    return to_i32(L.pack_tags(tags, cfg.fp_bits).reshape(-1)).to(device)


def _disjoint(cfg, keys):
    """Positions, in batch order, of the keys whose candidate buckets no
    earlier kept key has. With no bucket shared between two keys, every
    order of the launch's threads gives the sequential loop's outcome."""
    _, i1, i2 = prepare_keys_plain(cfg, keys)
    used, keep = set(), []
    for k, (a, b) in enumerate(zip(i1.tolist(), i2.tolist())):
        if a not in used and b not in used:
            used.update((a, b))
            keep.append(k)
    return torch.tensor(keep, device=keys.device)


def _direct_insert_exact(cfg, table, keys, valid, fused=True):
    """#4 or #5 (one launch) and the plain loop on copies of ``table``:
    equal ``ok``, masked keys False, ``count`` following ``ok``, and equal
    tag multisets in every bucket. Returns ``ok``."""
    K.reset_launches()
    t_kernel, t_plain = table.clone(), table.clone()
    st, ok = K.cuckoo_insert_direct(
        cfg, cfg.init(table.device)._replace(table=t_kernel), keys, valid,
        fused=fused)
    ok_plain = cuckoo_insert_direct_plain(cfg, t_plain, keys, valid)
    torch.cuda.synchronize()
    assert K.LAUNCHES[INSERT_KERNEL[fused]] == 1
    assert K.LAUNCHES[INSERT_KERNEL[not fused]] == 0
    assert torch.equal(ok, ok_plain) and not ok[~valid].any()
    assert int(st.count) == int(ok.sum())
    assert torch.equal(_bucket_multisets(cfg, t_kernel),
                       _bucket_multisets(cfg, t_plain))
    return ok


def _i1_full(cfg, table, keys):
    _, i1, _ = prepare_keys_plain(cfg, keys)
    return (L.bucket_tags(table, i1, cfg.layout) != 0).all(-1)


@pytest.mark.parametrize("fused", FUSED, ids=FUSED_IDS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: "b{}f{}{}{}".format(*c))
def test_insert_past_full_buckets_matches_plain(cuda, layout, fused):
    """#4 and #5 on a table near load 0.9: many keys are placed in bucket
    i2 past a full i1, and some are turned down with both buckets full."""
    cfg = _cfg(*layout)
    table = _dense_table(cfg, 20, cuda)
    pool = _keys(21, 8192, cuda)
    keys = pool[_disjoint(cfg, pool)]
    valid = torch.from_numpy(
        np.random.default_rng(22).random(keys.shape[0]) < 0.9).to(cuda)
    ok = _direct_insert_exact(cfg, table, keys, valid, fused)
    assert int((ok & _i1_full(cfg, table, keys)).sum()) > 100
    assert int((~ok & valid).sum()) > 100


XOR_LAYOUTS = [c for c in LAYOUTS if c[2] == "xor"]


@pytest.mark.parametrize("fused", FUSED, ids=FUSED_IDS)
@pytest.mark.parametrize("layout", XOR_LAYOUTS,
                         ids=lambda c: "b{}f{}{}{}".format(*c))
def test_insert_small_xor_table_with_one_candidate_bucket(cuda, layout, fused):
    """64 buckets under XOR, where a key has i1 == i2 when fmix32(tag) & 63
    is 0: such a key takes its one bucket's free slot, or is turned down
    when that bucket is full."""
    cfg = _cfg(*layout, num_buckets=64)
    table = _dense_table(cfg, 23, cuda)
    pool = _keys(24, 8192, cuda)
    _, i1, i2 = prepare_keys_plain(cfg, pool)
    pool = torch.cat([pool[i1 == i2], pool[i1 != i2]])
    keys = pool[_disjoint(cfg, pool)]
    ok = _direct_insert_exact(cfg, table, keys,
                              torch.ones(keys.shape[0], dtype=torch.bool,
                                         device=cuda), fused)
    _, j1, j2 = prepare_keys_plain(cfg, keys)
    one = j1 == j2
    assert bool(ok[one].any()) and bool((~ok[one]).any())


@pytest.mark.parametrize("n", [1, 255, 257])
def test_insert_batch_edges_match_plain(cuda, n):
    """Batches one key short of and one past a block's keys, and one key."""
    cfg = _cfg(16, 16, "xor", "fmix32")
    table = _dense_table(cfg, 25, cuda)
    pool = _keys(26, 4096, cuda)
    keys = pool[_disjoint(cfg, pool)[:n]]
    assert keys.shape[0] == n
    _direct_insert_exact(cfg, table, keys,
                         torch.ones(n, dtype=torch.bool, device=cuda))


def test_insert_valid_mask_ending_false(cuda):
    """The last keys of the batch masked out: they report False and write
    nothing."""
    cfg = _cfg(8, 16, "offset", "xxhash64")
    table = _dense_table(cfg, 27, cuda)
    pool = _keys(28, 4096, cuda)
    keys = pool[_disjoint(cfg, pool)[:1000]]
    valid = torch.ones(1000, dtype=torch.bool, device=cuda)
    valid[-100:] = False
    ok = _direct_insert_exact(cfg, table, keys, valid)
    assert not ok[-100:].any() and bool(ok[:900].any())


@pytest.mark.parametrize("fused", FUSED, ids=FUSED_IDS)
@pytest.mark.parametrize("layout", [LAYOUTS[0], LAYOUTS[5], LAYOUTS[9]],
                         ids=lambda c: "b{}f{}{}{}".format(*c))
def test_insert_every_key_duplicated(cuda, layout, fused):
    """Every key twice in one launch, half the copies in neighbouring
    threads and half a batch apart. A key with two or more free slots
    across its buckets places both copies, one with none places neither:
    there ``ok`` equals the plain loop's. A key with one free slot places
    exactly one copy, whichever CAS lands first; the tag multisets equal
    the plain loop's everywhere."""
    cfg = _cfg(*layout)
    table = _dense_table(cfg, 29, cuda)
    pool = _keys(30, 4096, cuda)
    uniq = pool[_disjoint(cfg, pool)[:1000]]
    a, b = uniq[:500], uniq[500:]
    keys = torch.cat([a.repeat_interleave(2, dim=0), b, b])
    copies = torch.cat([torch.arange(500).repeat_interleave(2),
                        torch.arange(500, 1000), torch.arange(500, 1000)]).to(cuda)
    _, i1, i2 = prepare_keys_plain(cfg, uniq)
    free1 = (L.bucket_tags(table, i1, cfg.layout) == 0).sum(-1)
    free2 = (L.bucket_tags(table, i2, cfg.layout) == 0).sum(-1)
    free = free1 + torch.where(i1 == i2, 0, free2)
    K.reset_launches()
    t_kernel, t_plain = table.clone(), table.clone()
    st, ok = K.cuckoo_insert_direct(
        cfg, cfg.init(cuda)._replace(table=t_kernel), keys, fused=fused)
    ok_plain = cuckoo_insert_direct_plain(cfg, t_plain, keys)
    torch.cuda.synchronize()
    assert K.LAUNCHES[INSERT_KERNEL[fused]] == 1
    decided = (free != 1)[copies]
    assert torch.equal(ok[decided], ok_plain[decided])
    placed = torch.zeros(1000, dtype=torch.int64, device=cuda)
    placed.index_add_(0, copies, ok.long())
    assert torch.equal(placed, torch.clamp(free, max=2))
    assert int(st.count) == int(ok.sum()) == int(ok_plain.sum())
    assert torch.equal(_bucket_multisets(cfg, t_kernel),
                       _bucket_multisets(cfg, t_plain))
    assert bool((free == 0).any()) and bool((free == 1).any())


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


KMER_TILE = 4096                   # positions a block of csrc/kmer_pack.cu


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 21, 31])
def test_kmer_pack_matches_plain(cuda, k, monkeypatch):
    """Both instantiations of kernel #10 equal the plain version: on codes
    with an all-A and an all-T run, on uint8 codes with high bits set and on
    int64 codes; on slices starting at offsets 0-16 (unaligned pointers) of
    one k-mer and of a tile's positions less one, exactly and plus one; and
    ``kmer_keys`` makes one launch a call, with no torch ``canonicalize``."""
    gen = np.random.default_rng(k)
    codes = torch.from_numpy(gen.integers(
        0, 4, size=(1 << 16) + 7, dtype=np.uint8)).to(cuda)
    codes[:64] = 0                                     # an all-A run
    codes[64:128] = 3                                  # an all-T run
    high = codes | torch.from_numpy(gen.integers(
        0, 64, size=codes.shape[0], dtype=np.uint8) << 2).to(cuda)
    for canonical in (False, True):
        K.reset_launches()
        got = K.kmer_pack(codes, k, canonical=canonical)
        want = kmer_pack_plain(codes, k, canonical)
        masked = K.kmer_pack(high, k, canonical=canonical)  # high bits ignored
        wide = K.kmer_pack(codes.to(torch.int64) | 4, k, canonical=canonical)
        torch.cuda.synchronize()
        assert K.LAUNCHES["kmer_pack"] == 3
        assert got.shape == (codes.shape[0] - k + 1, 2)
        assert torch.equal(got, want) and torch.equal(masked, want)
        assert torch.equal(wide, want)
        for off in range(17):
            for m in (1, KMER_TILE - 1, KMER_TILE, KMER_TILE + 1):
                part = codes[off:off + m + k - 1]
                assert torch.equal(K.kmer_pack(part, k, canonical=canonical),
                                   want[off:off + m]), (canonical, off, m)
        tail = codes[-(KMER_TILE + k):]                # the input's last byte
        assert torch.equal(K.kmer_pack(tail, k, canonical=canonical),
                           want[-(KMER_TILE + 1):])
    want = {c: kmer_keys(codes.cpu(), k, canonical=c, device="cpu")
            for c in (False, True)}

    def no_torch_canonicalize(*args):
        raise AssertionError("torch canonicalize ran on the card's path")

    monkeypatch.setattr(kmer_pack_module, "canonicalize",
                        no_torch_canonicalize)
    for canonical in (False, True):
        K.reset_launches()
        keys = kmer_keys(codes, k, canonical=canonical)
        torch.cuda.synchronize()
        assert K.LAUNCHES["kmer_pack"] == 1
        assert torch.equal(keys.cpu(), want[canonical])


# (words_per_block, k, hash kind, case): the default shape is 20000 keys,
# nine in ten valid, into an empty table sized for them. The cases change
# it: ``n`` keys (1, 31 and 33: a lone lane, a partial warp, a warp and
# one), ``tail`` last keys not valid, ``blocks`` blocks only (groups of
# lanes hitting one block at once), ``distinct`` keys repeated over the
# batch (1: the same key every time), ``prefill`` keys already in the
# table; 2^20 and 2^21 blocks make tables larger than the L2, which the
# kernel prefetches blocks into. Block widths: 1, 2, 4, 16 and 32 words (a group of that many
# lanes), 12 (a group of 16, four lanes idle), 64 and 128 (lanes stride
# over the words); k = 11, 16 and 20 (positions 8 at a time).
# The query probes the batch and ``probe`` fresh keys (20000 by default).
# ``s`` makes the query's route rule see an L2 that gives windows of 2^s
# blocks, so that small tables take the windowed route (``windowed``, by
# default True, is the route the rule must give): 2^20 blocks in 64
# windows asked 17 times a block by 2^20 distinct keys; ragged last tiles; a
# batch below one tile; 256 windows of which three get keys; the batch
# one key either side of the crossover; every block width whose blocks
# the probe stages (4, 8, 16, 32 words) and two it tests word by word (12
# and 64), under both hashes.
BLOOM_CASES = [
    pytest.param(16, 8, "fmix32", {}, id="16-8-fmix32"),
    pytest.param(16, 8, "xxhash64", {}, id="16-8-xxhash64"),
    pytest.param(4, 11, "fmix32", {}, id="4-11-fmix32"),
    pytest.param(1, 3, "xxhash64", {}, id="1-3-xxhash64"),
    pytest.param(12, 8, "fmix32", {}, id="12-8-fmix32"),
    pytest.param(32, 8, "xxhash64", {}, id="32-8-xxhash64"),
    pytest.param(64, 8, "fmix32", {}, id="64-8-fmix32"),
    pytest.param(128, 20, "xxhash64", {}, id="128-20-xxhash64"),
    pytest.param(2, 5, "fmix32", {}, id="2-5-fmix32"),
    pytest.param(16, 16, "fmix32", {}, id="16-16-fmix32"),
    pytest.param(64, 16, "xxhash64", {}, id="64-16-xxhash64"),
    pytest.param(16, 8, "fmix32", {"n": 1, "tail": 0}, id="16-8-fmix32-n1"),
    pytest.param(16, 8, "fmix32", {"n": 31, "tail": 3}, id="16-8-fmix32-n31"),
    pytest.param(16, 8, "xxhash64", {"n": 33, "tail": 2},
                 id="16-8-xxhash64-n33"),
    pytest.param(12, 11, "fmix32", {"n": 33, "tail": 5}, id="12-11-fmix32-n33"),
    pytest.param(16, 8, "fmix32", {"blocks": 4}, id="16-8-fmix32-4blocks"),
    pytest.param(12, 8, "xxhash64", {"blocks": 3}, id="12-8-xxhash64-3blocks"),
    pytest.param(64, 8, "fmix32", {"blocks": 2}, id="64-8-fmix32-2blocks"),
    pytest.param(16, 8, "fmix32", {"distinct": 1}, id="16-8-fmix32-one-key"),
    pytest.param(16, 8, "xxhash64", {"distinct": 5, "blocks": 4},
                 id="16-8-xxhash64-5keys-4blocks"),
    pytest.param(16, 8, "fmix32", {"prefill": True}, id="16-8-fmix32-prefilled"),
    pytest.param(12, 11, "xxhash64", {"prefill": True, "blocks": 2000},
                 id="12-11-xxhash64-prefilled"),
    pytest.param(16, 8, "fmix32", {"blocks": 1 << 20}, id="16-8-fmix32-64MiB"),
    pytest.param(12, 8, "xxhash64", {"blocks": 1 << 21}, id="12-8-xxhash64-96MiB"),
    pytest.param(16, 8, "fmix32", {"blocks": 1 << 20, "distinct": 1 << 20,
                                   "n": 17 << 20, "s": 14},
                 id="16-8-fmix32-windowed-64-windows"),
    pytest.param(16, 8, "xxhash64", {"blocks": 2048, "s": 5},
                 id="16-8-xxhash64-windowed-ragged-tiles"),
    pytest.param(16, 8, "fmix32", {"blocks": 128, "n": 1000, "probe": 2000,
                                   "s": 3},
                 id="16-8-fmix32-windowed-below-a-tile"),
    pytest.param(16, 8, "fmix32", {"blocks": 4096, "n": 70_000, "distinct": 3,
                                   "probe": 0, "s": 4},
                 id="16-8-fmix32-windowed-empty-windows"),
    pytest.param(16, 8, "xxhash64", {"blocks": 1024, "n": 12 * 1024 - 1,
                                     "probe": 0, "s": 6, "windowed": False},
                 id="16-8-xxhash64-crossover-less-one"),
    pytest.param(16, 8, "xxhash64", {"blocks": 1024, "n": 12 * 1024,
                                     "probe": 0, "s": 6},
                 id="16-8-xxhash64-crossover"),
    pytest.param(4, 11, "fmix32", {"blocks": 2048, "s": 6},
                 id="4-11-fmix32-windowed"),
    pytest.param(8, 8, "xxhash64", {"blocks": 2048, "s": 6},
                 id="8-8-xxhash64-windowed"),
    pytest.param(32, 8, "fmix32", {"blocks": 2048, "s": 6},
                 id="32-8-fmix32-windowed"),
    pytest.param(12, 8, "xxhash64", {"blocks": 2000, "s": 6},
                 id="12-8-xxhash64-windowed"),
    pytest.param(64, 8, "fmix32", {"blocks": 2000, "s": 4},
                 id="64-8-fmix32-windowed"),
    pytest.param(64, 8, "xxhash64", {"blocks": 2000, "s": 4},
                 id="64-8-xxhash64-windowed"),
]


@pytest.mark.parametrize("wpb,k,hash_kind,case", BLOOM_CASES)
def test_bloom_matches_plain(cuda, monkeypatch, wpb, k, hash_kind, case):
    n = case.get("n", 20_000)
    if "blocks" in case:
        cfg = BloomConfig(num_blocks=case["blocks"], words_per_block=wpb, k=k,
                          hash_kind=hash_kind, seed=99)
    else:
        cfg = BloomConfig.for_capacity(20_000, words_per_block=wpb, k=k,
                                       hash_kind=hash_kind, seed=99)
    keys = _keys(15, case.get("distinct", n), cuda)
    if "distinct" in case:
        pick = torch.randint(0, keys.shape[0], (n,),
                             generator=torch.Generator().manual_seed(5))
        keys = keys[pick.to(cuda)]
    valid = (torch.rand(n, generator=torch.Generator().manual_seed(4))
             < 0.9).to(cuda)
    if "tail" in case:
        valid = torch.arange(n, device=cuda) < n - case["tail"]
    start = cfg.init(cuda)
    if case.get("prefill"):
        bloom_insert_plain(cfg, start.table, _keys(17, 20_000, cuda),
                           torch.ones(20_000, dtype=torch.bool, device=cuda))
    K.reset_launches()
    state, ok = K.bloom_insert(cfg, start._replace(table=start.table.clone()),
                               keys, valid)
    table = start.table.clone()
    bloom_insert_plain(cfg, table, keys, valid)
    torch.cuda.synchronize()
    assert torch.equal(state.table, table)
    assert not torch.equal(table, start.table) or not bool(valid.any())
    assert torch.equal(ok, valid) and int(state.count) == int(valid.sum())
    probe = torch.cat([keys, _keys(16, case.get("probe", 20_000), cuda)])
    if "s" in case:
        l2 = 5 * (4 * wpb << case["s"]) + 4
        monkeypatch.setattr(bloom_kernels, "l2_bytes", lambda device: l2)
        plan = bloom_kernels.query_plan(cfg, probe.shape[0], l2)
        assert plan.log2_window == case["s"]
        assert plan.windowed == case.get("windowed", True)
    hit = K.bloom_query(cfg, state, probe)
    assert torch.equal(hit, bloom_query_plain(cfg, table, probe))
    assert bool(hit[:n][valid].all())
    assert K.LAUNCHES["bloom_insert"] == 1 and K.LAUNCHES["bloom_query"] == 1
    h = amq.make("bloom", capacity=20_000)
    h.insert(keys)
    assert bool(h.query(keys).hits.all())


# (BK, g, Sq, Sk, D, Dv, causal, window, q_offset, dtype): the five shapes
# of tests/test_flash_kernel.py in the kernel layout, then bf16 at every
# tensor-core head size, bf16 through the FMA variant (Dv != D), a
# windowed bf16 case with a query offset, rows that see no key, GQA g = 8,
# and ragged edges: Sq past 128 and not a multiple of it, Sk not a
# multiple of the wgmma variant's key tile (96 at D = 128, 128 below).
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
    (1, 8, 100, 130, 32, 32, True, None, 0, torch.bfloat16),
    (2, 3, 333, 517, 64, 64, True, None, 0, torch.bfloat16),
    (4, 2, 1000, 1000, 128, 128, True, 300, 0, torch.bfloat16),
    (2, 2, 200, 389, 128, 128, False, None, 0, torch.bfloat16),
]


def _model_views(t, kv_heads: int):
    """A kernel-layout tensor ([BK, g, S, D] or [BK, S, D]) as the model's
    [B, S, H, D] (B = BK / kv_heads), a strided view into a buffer with 8
    more columns a row."""
    if t.ndim == 3:
        t = t[:, None]
    BK, g, S, D = t.shape
    t = t.reshape(BK // kv_heads, kv_heads * g, S, D).transpose(1, 2)
    buf = torch.zeros(t.shape[:3] + (D + 8,), dtype=t.dtype, device=t.device)
    buf[..., :D] = t
    return buf[..., :D]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "{}x{}x{}x{}d{}v{}c{}w{}o{}{}".format(*c[:9], str(c[9])[6:]))
def test_flash_attention_matches_plain(cuda, case):
    BK, g, Sq, Sk, D, Dv, causal, window, q_offset, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(Sq * Sk + D)
    q = (torch.randn((BK, g, Sq, D), generator=gen, device=cuda) * 0.3).to(dtype)
    k = (torch.randn((BK, Sk, D), generator=gen, device=cuda) * 0.3).to(dtype)
    v = (torch.randn((BK, Sk, Dv), generator=gen, device=cuda) * 0.3).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    K.reset_launches()
    got = K.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, **kw)
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
    got_bf16 = K.flash_attention(q, k, v, out_dtype=torch.bfloat16, **kw)
    assert torch.equal(got_bf16, got.to(torch.bfloat16))
    if dtype == torch.bfloat16:
        # The model-layout entry on strided [B, S, H, D] views: the same
        # kernel on the same values, so the same bits, written as
        # [B, S, H, Dv].
        kv_heads = 2 if BK % 2 == 0 else 1
        views = [_model_views(t, kv_heads) for t in (q, k, v)]
        assert not views[0].is_contiguous()
        K.reset_launches()
        for out_dtype, ref in ((torch.float32, got), (torch.bfloat16, got_bf16)):
            out = K.flash_attention_bshd(*views, out_dtype=out_dtype, **kw)
            B = BK // kv_heads
            assert out.shape == (B, Sq, kv_heads * g, Dv)
            assert torch.equal(out, ref.reshape(B, kv_heads * g, Sq, Dv)
                               .transpose(1, 2))
        assert K.LAUNCHES["flash_attention"] == 2


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


@pytest.mark.parametrize("name", ["cuckoo", "bloom"])
def test_snapshot_round_trip_on_the_card(cuda, name):
    h = amq.make(name, capacity=50_000, device=cuda)
    stored, fresh = _keys(1, 40_000, cuda), _keys(2, 40_000, cuda)
    assert bool(h.insert(stored).ok.all())
    snap = h.snapshot()
    kept = {k: v.copy() for k, v in snap.arrays.items()}
    assert np.array_equal(snap.arrays["table"].view(np.int32),
                          h.state.table.cpu().numpy())
    twin = amq.make(name, config=h.config, snapshot=snap, device=cuda)
    assert twin.state.table.is_cuda and twin.count() == h.count()
    assert torch.equal(twin.state.table, h.state.table)
    probe = torch.cat([stored, fresh])
    assert torch.equal(twin.query(probe).hits, h.query(probe).hits)
    before = h.state.table.clone()
    assert bool(twin.insert(fresh[:5000]).ok.all())
    torch.cuda.synchronize()
    assert torch.equal(h.state.table, before)
    for k in kept:
        assert np.array_equal(kept[k], snap.arrays[k])
    with pytest.raises(amq.SnapshotMismatchError):
        amq.make(name, capacity=100_000, device=cuda, snapshot=snap)


def test_cascade_levels_span_fp_widths_on_the_card(cuda):
    """Shares that admit fp 8 at level 0, fp 16 at 1 and fp 32 at 2: each
    level's query kernel equals its plain version on stored and fresh
    keys, and the cascade finds every key."""
    h = amq.make("cuckoo", capacity=4096, auto_expand=True, device=cuda,
                 fpr_budget=0.12, split_ratio=0.01)
    keys, fresh = _keys(3, 40_000, cuda), _keys(4, 20_000, cuda)
    for s in range(0, 40_000, 8192):
        assert bool(h.insert(keys[s:s + 8192]).ok.all())
    widths = [lv.config.fp_bits for lv in h.levels]
    assert widths[:3] == [8, 16, 32] and h.count() == 40_000
    probe = torch.cat([keys, fresh])
    for lv in h.levels:
        assert (lv.config.bucket_size, lv.config.policy,
                lv.config.hash_kind) == (16, "xor", "fmix32")
        assert torch.equal(lv.query(probe).hits,
                           cuckoo_query_plain(lv.config, lv.state.table, probe))
    K.reset_launches()
    assert bool(h.query(keys).hits.all())
    assert K.LAUNCHES["cuckoo_query"] == len(h.levels)
    assert bool(h.delete(keys[:5000]).ok.all())
    assert h.count() == 35_000


@pytest.mark.parametrize("name", ["cuckoo", "bloom"])
def test_host_query_matches_device_query(cuda, name):
    """Each hot level's device answers, then its host probe once demoted."""
    h = amq.make(name, capacity=8192, tiered=True, device=cuda,
                 device_budget_bytes=1 << 19)
    keys, fresh = _keys(5, 60_000, cuda), _keys(6, 20_000, cuda)
    assert bool(h.insert(keys).ok.all())
    probe = torch.cat([keys[::3], fresh])
    answers = {aid: lv.query(probe).hits.cpu().numpy()
               for lv, aid in zip(h.hot.levels, h.hot.level_alloc_ids)}
    assert len(answers) >= 2
    while h.demote() is not None:
        pass
    adapter, checked = amq.get(name), 0
    for cold in h.cold:
        if cold.alloc_id in answers:
            got = adapter.host_query(cold.config, cold.arrays, probe,
                                     device=cuda)
            assert np.array_equal(got, answers[cold.alloc_id])
            checked += 1
    assert checked == len(answers) - 1
    assert bool(h.query(keys).hits.all())
    assert h.device_bytes <= h.device_budget_bytes


# ---------------------------------------------------------------------------
# The dynamic baselines: the GQF's serial kernels G1 / G2 against their
# plain loops; the TCF's and BCHT's rounds (torch ops, deterministic) leave
# the same tables on the card as on the CPU.
# ---------------------------------------------------------------------------

def _baseline_states_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x.cpu(), y.cpu()), f


@pytest.mark.parametrize("remainder_bits", [8, 16, 28])
@pytest.mark.parametrize("load", [0.5, 0.9, 0.99])
def test_gqf_serial_kernels_match_plain(cuda, load, remainder_bits):
    """A 2^14-slot table filled through G1 to ``load`` less 2^12 keys, then
    those 2^12 inserts and 2^12 deletes (stored keys, some twice, and
    absent keys, under a mask): table, ``ok`` and ``count`` equal the plain
    loops' word for word. At r = 28 the distance field wraps (R6) in both;
    the table is never overfilled there, where an insert into a full table
    would never end (in the JAX loop too)."""
    cfg = QF.GQFConfig(num_slots=1 << 14, remainder_bits=remainder_bits)
    dev, host = cfg.init(cuda), cfg.init("cpu")
    fill = _keys(40 + remainder_bits, int(load * cfg.num_slots) - (1 << 12),
                 cuda)
    more = _keys(41, 1 << 12, cuda)
    rng = np.random.default_rng(42)
    pick = torch.from_numpy(rng.integers(0, fill.shape[0], 1 << 12)).to(cuda)
    dels = torch.cat([fill[pick[: 3 << 10]], _keys(43, 1 << 10, cuda)])
    dvalid = torch.from_numpy(rng.random(1 << 12) < 0.9).to(cuda)
    K.reset_launches()
    for op, keys, valid in (("insert", fill, None), ("insert", more, None),
                            ("delete", dels, dvalid)):
        dev, ok = getattr(QF, op)(cfg, dev, keys, valid)
        host, want = getattr(QF, op)(
            cfg, host, keys.cpu(), None if valid is None else valid.cpu())
        assert torch.equal(ok.cpu(), want)
        _baseline_states_equal(dev, host)
        assert int(dev.count) == int(host.count)
    assert K.LAUNCHES["gqf_insert_serial"] == 2
    assert K.LAUNCHES["gqf_delete_serial"] == 1
    probe = torch.cat([fill, more, _keys(44, 1 << 12, cuda)])
    assert torch.equal(QF.query(cfg, dev, probe).cpu(),
                       QF.query(cfg, host, probe.cpu()))


@pytest.mark.parametrize("name", ["tcf", "bcht"])
def test_tcf_bcht_tables_on_the_card_equal_cpu(cuda, name):
    """2^16-slot tables filled to 0.95 in two batches (repeats and a mask
    in the first), then deletes: the card's tables, ``ok`` and answers
    equal the CPU's word for word (stable-sort claims, unique winners)."""
    mod, cfg = ((TCm, TCm.TCFConfig(num_blocks=1 << 11)) if name == "tcf"
                else (HTm, HTm.BCHTConfig(num_buckets=1 << 12)))
    dev, host = cfg.init(cuda), cfg.init("cpu")
    keys = _keys(50, int(0.95 * cfg.num_slots), cuda)
    keys[7::11] = keys[6::11][: keys[7::11].shape[0]]
    half = keys.shape[0] // 2
    valid = torch.from_numpy(
        np.random.default_rng(51).random(half) < 0.9).to(cuda)
    for op, k, v in (("insert", keys[:half], valid),
                     ("insert", keys[half:], None),
                     ("delete", keys[::3], None)):
        dev, ok = getattr(mod, op)(cfg, dev, k, v)
        host, want = getattr(mod, op)(cfg, host, k.cpu(),
                                      None if v is None else v.cpu())
        assert torch.equal(ok.cpu(), want)
        _baseline_states_equal(dev, host)
    probe = torch.cat([keys, _keys(52, 1 << 14, cuda)])
    assert torch.equal(mod.query(cfg, dev, probe).cpu(),
                       mod.query(cfg, host, probe.cpu()))


def _sharded_steps(seed, n, device):
    """Two rounds of (keys, valid, ops) drawn from a pool, so keys repeat
    within and across batches."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, size=4 * n, dtype=np.uint64)
    return [(keys_from_numpy(pool[rng.integers(0, 3 * n, n)], device),
             torch.from_numpy(rng.random(n) < 0.9).to(device),
             torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(
                 device)) for _ in range(2)]


def _sharded_call(target, op, keys, valid, ops):
    if op == "insert_bulk":
        return target.insert(keys, bulk=True, dedup_within_batch=True,
                             valid=valid)
    if op == "apply_ops":
        return target.apply_ops(keys, ops, valid=valid)
    return getattr(target, op)(keys, valid=valid)


def test_sharded_driver_on_the_card_equals_cpu(cuda):
    """The core driver over 4 shards of 2 partitions: the card's tables,
    ``count``, ``ok`` and ``routed`` equal the CPU's after every op (the
    routing sort is stable, the core ops deterministic)."""
    cfg = SF.ShardedCuckooConfig.for_capacity(
        1 << 16, 4, partitions_per_shard=2, hash_kind="fmix32",
        capacity_factor=1.0)
    n = 1 << 13
    dev = SF.ShardedCuckooFilter(cfg, SF.make_mesh(4, device=cuda), n // 4)
    host = SF.ShardedCuckooFilter(cfg, SF.make_mesh(4, device="cpu"), n // 4)
    for keys, valid, ops in _sharded_steps(60, n, cuda):
        for op in ("insert", "insert_bulk", "query", "delete", "apply_ops"):
            got = _sharded_call(dev, op, keys, valid, ops)
            want = _sharded_call(host, op, keys.cpu(), valid.cpu(), ops.cpu())
            assert torch.equal(got[0].cpu(), want[0]), op
            assert torch.equal(got[1].cpu(), want[1]), op
            assert not bool(want[1].all())             # bins overflowed
            assert torch.equal(dev.state.table.cpu(), host.state.table), op
            assert torch.equal(dev.state.count.cpu(), host.state.count), op


def test_sharded_adapter_on_the_card(cuda):
    """``sharded-cuckoo`` over 4 shards on the card runs the hash, query,
    direct-insert and mixed-op kernels on every partition: ``routed`` as
    on the CPU, each partition's ``count`` its accepted keys, no false
    negative, ``apply_ops``'s ``ok`` the core driver's on a copy, and a
    reshard onto 2 and 8 shards moving every word and answer."""
    h = amq.make("sharded-cuckoo", capacity=1 << 18, num_shards=4,
                 partitions_per_shard=2)
    assert h.device.type == "cuda" and h.config.mesh.device == h.device
    cpu = amq.make("sharded-cuckoo", capacity=1 << 18, num_shards=4,
                   partitions_per_shard=2, device="cpu")
    inner = h.config.inner
    keys = _keys(61, 1 << 16, cuda)
    K.reset_launches()
    accepted = []
    for part, bulk in ((keys[:1 << 15], False), (keys[1 << 15:], True)):
        rep = h.insert(part, bulk=bulk)
        want = cpu.insert(part.cpu(), bulk=bulk)
        assert torch.equal(rep.routed.cpu(), want.routed)
        assert bool((rep.ok == rep.routed).all())
        accepted.append(part[rep.ok])
    stored = torch.cat(accepted)
    part_of = SF.partition_of(inner, stored)
    assert torch.equal(h.state.count.cpu(), torch.bincount(
        part_of, minlength=inner.partitions).to(torch.int32).cpu())
    q = h.query(stored[:stored.shape[0] // 4 * 4])
    assert bool((q.hits | ~q.routed).all())
    for k2 in (2, 8):
        moved = h.resharded(num_shards=k2)
        assert torch.equal(moved.state.table, h.state.table)
        probe = torch.cat([keys, _keys(62, 1 << 14, cuda)])
        a, b = moved.query(probe), h.query(probe)
        assert torch.equal(a.hits & a.routed, b.hits & b.routed)
    steps = _sharded_steps(63, 1 << 14, cuda)
    keys2, valid, ops = steps[0]
    core = SF.ShardedCuckooFilter(
        inner, h.config.mesh, (1 << 14) // 4,
        state=SF.ShardedCuckooState(h.state.table.clone(),
                                    h.state.count.clone()))
    want_ok, want_routed = core.apply_ops(keys2, ops, valid=valid)
    rep = h.apply_ops(amq.OpBatch(keys2, ops, valid))
    assert torch.equal(rep.routed, want_routed)
    assert torch.equal(rep.ok, want_ok)
    d = h.delete(stored[:1 << 12])
    assert bool(d.ok[d.routed].all())
    for name in ("hash64", "cuckoo_query", "cuckoo_insert_direct",
                 "cuckoo_mixed"):
        assert K.LAUNCHES[name] > 0, name


def test_dedup_on_the_card(cuda):
    """``sequence_keys`` on the card equals the CPU's; ``dedup_batch`` on
    ``bloom`` leaves the CPU's masks and table; a ``StreamingDeduper`` on
    a cascade of 4 shards masks every repeat and only repeats or false
    positives."""
    dcfg = DataConfig(vocab_size=151936, batch=512, seq_len=64)
    tokens = [make_batch(dcfg, s, device=cuda)["tokens"] for s in range(4)]
    assert torch.equal(make_batch(dcfg, 0, device="cpu")["tokens"],
                       tokens[0].cpu())
    for t in tokens:
        assert torch.equal(DD.sequence_keys(t).cpu(),
                           DD.sequence_keys(t.cpu()))
    (gcfg, gstate), (ccfg, cstate) = (
        DD.make_dedup(1 << 12, backend="bloom", device=dev)
        for dev in (cuda, "cpu"))
    for t in tokens:
        gstate, gout, _ = DD.dedup_batch(gcfg, gstate, {"tokens": t})
        cstate, cout, _ = DD.dedup_batch(ccfg, cstate, {"tokens": t.cpu()})
        assert torch.equal(gout["mask"].cpu(), cout["mask"])
    assert torch.equal(gstate.table.cpu(), cstate.table)
    d = DD.make_deduper(512, backend="sharded-cuckoo", service_batch=256,
                        num_shards=4, device=cuda)
    seen, fresh_masked = set(), 0
    for t in tokens:
        out, stats = d.dedup({"tokens": t})
        mask = out["mask"].cpu().numpy()
        for i, k in enumerate(keys_to_numpy(DD.sequence_keys(t)).tolist()):
            if k in seen:
                assert not mask[i]
            fresh_masked += k not in seen and not mask[i]
            seen.add(k)
    d.flush()
    assert len(d.handle.levels) > 1 and d.stats["insert_failures"] == 0
    assert fresh_masked <= 2 and d.handle.count() == len(seen) - fresh_masked
