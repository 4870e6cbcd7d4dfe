"""The port's dynamic baselines (TCF, GQF, BCHT) vs the JAX package's.

The same seeded numpy keys go through ``repro.filters.{two_choice,
quotient,bcht}`` and their ports on the CPU: inserts with a ``valid`` mask
and without one (the JAX side runs an all-True mask, which it treats as
none), repeated keys within a batch, a query of stored and fresh keys,
deletes of stored, repeated and absent keys. Tables (the TCF's stash
included), ``ok``, ``count`` and answers are bit-exact (tolerance 0): the
rounds elect claim winners by a stable sort in both packages, and the
GQF's loops are serial; ``convert`` carries each JAX state and config
into the port unchanged. On the CPU the GQF's insert and delete run the
plain versions of kernels G1 and G2 (``kernels/ref.py``), also held to the
JAX loops on the JAX package's own ``_prepare``; ``resolve_claims_single``
is held to the JAX function. The reference's faults are pinned, as the
port reproduces them: R5 (a GQF insert past ``max_probe`` drops the entry
it carries), R6 (the GQF's distance field wraps when r > 24) and R7 (the
BCHT's expiry drops a victim). The registry backends keep ``repro``'s
capabilities and config fingerprints. Each JAX entry point is jitted once
a config, at one batch width, and kept for the module (``_ref``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import amq as ramq
from repro.core import keys_from_numpy
from repro.filters import bcht as RB
from repro.filters import common as RC
from repro.filters import quotient as RQ
from repro.filters import two_choice as RT
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.filters import bcht as TB
from repro_torch.filters import common as TC
from repro_torch.filters import quotient as TQ
from repro_torch.filters import two_choice as TT
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as TREF

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them, and each compile takes about a
# fifth less time.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

# name -> (JAX module, port module, config kwargs, batch width). The TCF's
# second table is tiny, so both blocks fill and the stash and its full
# path are exercised; the GQF's second and third are R5's and R6's; the
# BCHT's 2048 slots are R7's.
CASES = {
    "tcf": (RT, TT, "TCFConfig", {"num_blocks": 33}, 512),
    "tcf_stash": (RT, TT, "TCFConfig",
                  {"num_blocks": 2, "block_size": 4, "stash_size": 16}, 32),
    "gqf": (RQ, TQ, "GQFConfig", {"num_slots": 1024}, 512),
    "gqf_r5": (RQ, TQ, "GQFConfig", {"num_slots": 1024, "max_probe": 8},
               1024),
    "gqf_r6": (RQ, TQ, "GQFConfig", {"num_slots": 4096, "remainder_bits": 28},
               2048),
    "bcht": (RB, TB, "BCHTConfig", {"num_buckets": 128}, 1024),
}


def _raw(seed, n):
    rng = np.random.default_rng(seed)
    raw = np.unique(rng.integers(1, 2**64, size=2 * n, dtype=np.uint64))[:n]
    assert raw.size == n
    return rng.permutation(raw)


def _t(raw):
    return torch.from_numpy(keys_from_numpy(raw).view(np.int32))


def _j(raw):
    return jnp.asarray(keys_from_numpy(raw))


def _arrays(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_state_equal(ref_state, port_state):
    got = convert.state_to_numpy(port_state)
    want = _arrays(ref_state)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
        assert np.array_equal(got[f], want[f]), f


class _Ref:
    """A JAX config's jitted insert / query / delete at one batch width."""

    def __init__(self, name):
        rmod, tmod, cls, kw, width = CASES[name]
        self.rmod, self.tmod, self.width = rmod, tmod, width
        self.rcfg = getattr(rmod, cls)(**kw)
        self.tcfg = getattr(tmod, cls)(**kw)
        assert repr(self.rcfg) == repr(self.tcfg)
        jit = functools.partial(jax.jit, compiler_options=_XLA_FAST)
        self.insert = jit(functools.partial(rmod.insert, self.rcfg))
        self.query = jit(functools.partial(rmod.query, self.rcfg))
        self.delete = jit(functools.partial(rmod.delete, self.rcfg))

    def pad(self, raw, valid=None):
        """Keys and mask padded to the batch width (padding masked off)."""
        n = raw.shape[0]
        keys = np.zeros((self.width,), np.uint64)
        keys[:n] = raw
        mask = np.zeros((self.width,), bool)
        mask[:n] = True if valid is None else valid
        return _j(keys), jnp.asarray(mask)


@functools.lru_cache(maxsize=None)
def _ref(name):
    return _Ref(name)


_FROM_NUMPY = {TT: convert.tcf_state_from_numpy,
               TQ: convert.gqf_state_from_numpy,
               TB: convert.bcht_state_from_numpy}


def _run(name, ref_state, port_state, op, raw, valid=None):
    """One op on both packages -> (JAX state, port state, ok / hits), the
    JAX result cut to the batch; ``valid=None`` runs the port unmasked."""
    r = _ref(name)
    n = raw.shape[0]
    keys, mask = r.pad(raw, valid)
    tk = _t(raw)
    tv = None if valid is None else torch.from_numpy(valid)
    if op == "query":
        want = np.asarray(r.query(ref_state, keys))[:n]
        got = r.tmod.query(r.tcfg, port_state, tk)
        return ref_state, port_state, want, got.numpy()
    ref_state, want = getattr(r, op)(ref_state, keys, mask)
    port_state, got = getattr(r.tmod, op)(r.tcfg, port_state, tk, tv)
    return ref_state, port_state, np.asarray(want)[:n], got.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_insert_query_delete_bit_exact(name):
    r = _ref(name)
    rs, ts = r.rcfg.init(), r.tcfg.init("cpu")
    slots = r.tcfg.num_slots
    rng = np.random.default_rng(sum(map(ord, name)))
    stored = _raw(len(name), min(r.width, int(slots * 0.9)) + 40)
    first = stored[: len(stored) // 2]
    first[3::7] = first[2::7][: first[3::7].size]     # repeats in a batch
    valid = rng.random(first.size) < 0.85
    for op, raw, v in (("insert", first, valid),
                       ("insert", stored[len(stored) // 2:], None)):
        rs, ts, want, got = _run(name, rs, ts, op, raw, v)
        assert np.array_equal(got, want)
        _assert_state_equal(rs, ts)
    assert int(ts.count) == int(rs.count)
    probe = np.concatenate([stored, _raw(99, 200) | np.uint64(1 << 63)])
    for s in range(0, probe.size, r.width):
        _, _, want, got = _run(name, rs, ts, "query", probe[s:s + r.width])
        assert np.array_equal(got, want)
    # Deletes: stored keys (some twice), absent keys, a mask; then unmasked.
    dels = np.concatenate([stored[::3], stored[:8], _raw(7, 8) | np.uint64(1)])
    dels = dels[rng.permutation(dels.size)][: r.width]
    dvalid = rng.random(dels.size) < 0.9
    rs, ts, want, got = _run(name, rs, ts, "delete", dels, dvalid)
    assert np.array_equal(got, want) and got[dvalid].any()
    _assert_state_equal(rs, ts)
    rs, ts, want, got = _run(name, rs, ts, "delete", stored[1::3][: r.width])
    assert np.array_equal(got, want)
    _assert_state_equal(rs, ts)
    # The JAX state and config carried into the port by ``convert``.
    assert convert.config_from_reference(r.rcfg, type(r.tcfg)) == r.tcfg
    carried = _FROM_NUMPY[r.tmod](_arrays(rs), "cpu")
    _assert_state_equal(rs, carried)
    assert carried.count.shape == () and type(carried) is type(ts)


def test_tcf_stash_path_taken():
    """The tiny TCF's batches reach the stash and turn keys down with both
    blocks and the stash full, bit for bit as in JAX."""
    r = _ref("tcf_stash")
    rs, ts = r.rcfg.init(), r.tcfg.init("cpu")
    raw = _raw(3, 30)
    records = []
    TT.INSERT_RECORDS = records
    try:
        rs, ts, want, got = _run("tcf_stash", rs, ts, "insert", raw)
    finally:
        TT.INSERT_RECORDS = None
    assert np.array_equal(got, want)
    _assert_state_equal(rs, ts)
    stash = ts.stash.numpy().view(np.uint32)
    assert (stash != 0).all() and int(ts.count) == 8 + 16 == got.sum()
    assert int(records[0]["dead"]) == (~got).sum() and records[0]["rounds"] > 1
    _, _, want, hits = _run("tcf_stash", rs, ts, "query", raw)
    assert np.array_equal(hits, want) and hits[got].all()


@pytest.mark.parametrize("name", ["gqf", "gqf_r6"])
def test_serial_plain_versions_match_reference(name):
    """G1's and G2's plain versions on the JAX package's own ``_prepare``
    against ``QF.insert`` / ``QF.delete``."""
    r = _ref(name)
    cfg = r.rcfg
    raw = _raw(11, r.width)
    valid = np.random.default_rng(12).random(r.width) < 0.9
    rs, ok = r.insert(cfg.init(), *r.pad(raw, valid))
    rem, home = (torch.from_numpy(np.asarray(x).astype(np.int64))
                 for x in RQ._prepare(cfg, _j(raw)))
    table = torch.zeros((cfg.num_slots,), dtype=torch.int32)
    got = TREF.gqf_insert_plain(table, rem, home, torch.from_numpy(valid),
                                cfg.remainder_bits, cfg.max_probe)
    assert np.array_equal(got.numpy(), np.asarray(ok))
    assert np.array_equal(table.numpy().view(np.uint32), np.asarray(rs.table))
    dvalid = np.random.default_rng(13).random(r.width) < 0.7
    rs, ok = r.delete(rs, *r.pad(raw, dvalid))
    got = TREF.gqf_delete_plain(table, rem, home, torch.from_numpy(dvalid),
                                cfg.remainder_bits, cfg.max_probe)
    assert np.array_equal(got.numpy(), np.asarray(ok))
    assert np.array_equal(table.numpy().view(np.uint32), np.asarray(rs.table))
    # The wrapper's CPU route is the plain version, count kept by ok.
    state = TQ.GQFState(torch.zeros_like(table), torch.tensor(5, dtype=torch.int32))
    state, ok = K.gqf_insert(r.tcfg, state, rem, home)
    assert int(state.count) == 5 + int(ok.sum())
    with pytest.raises(TypeError, match="int64"):
        K.gqf_insert(r.tcfg, state, rem.to(torch.int32), home)


def test_resolve_claims_single_bit_exact():
    rng = np.random.default_rng(21)
    for n, hi in ((1, 4), (64, 8), (500, 97), (0, 4)):
        addr = rng.integers(0, hi + 1, size=n)       # hi = invalid
        want = np.asarray(RC.resolve_claims_single(jnp.asarray(addr, jnp.int32),
                                                   hi))
        got = TC.resolve_claims_single(torch.from_numpy(addr), hi)
        assert np.array_equal(got.numpy(), want)


def _false_negatives(tmod, cfg, state, raw, ok):
    hits = tmod.query(cfg, state, _t(raw)).numpy()
    return int((ok & ~hits).sum()), int((~ok & hits).sum())


def test_r5_gqf_insert_past_max_probe_pinned():
    """R5: at ``max_probe=8`` an insert that runs past it drops the entry it
    carries, and an entry stored at distance exactly ``max_probe`` lies
    outside the query's window. The port gives JAX's outcome; the false
    negatives among ``ok`` are at most the failed keys plus the slots
    holding a distance >= ``max_probe``."""
    r = _ref("gqf_r5")
    raw = _raw(5, r.tcfg.num_slots)
    rs, ts, want, ok = _run("gqf_r5", r.rcfg.init(), r.tcfg.init("cpu"),
                            "insert", raw)
    assert np.array_equal(ok, want)
    _assert_state_equal(rs, ts)
    assert int(ts.count) == ok.sum()
    fn, failed_true = _false_negatives(TQ, r.tcfg, ts, raw, ok)
    _, _, want_hits, _ = _run("gqf_r5", rs, ts, "query", raw)
    assert fn == int((want & ~want_hits).sum()) > 0
    far = int((TQ._dist(r.tcfg, ts.table.long() & 0xFFFFFFFF)
               >= r.tcfg.max_probe).sum())
    assert fn <= int((~ok).sum()) + far
    assert failed_true > 0            # failed keys that answer True


def test_r6_gqf_distance_wraps_pinned():
    """R6: at ``remainder_bits=28`` the packed distance keeps 4 bits, so a
    key stored 16 or more slots from home is lost to the query. The port
    wraps as JAX's uint32 shift does and gives its false negatives."""
    r = _ref("gqf_r6")
    cfg = r.tcfg
    assert int(TQ._pack(cfg, torch.tensor([5]), torch.tensor([16]))) == 5
    raw = _raw(6, int(cfg.num_slots * 0.97))
    rs, ts = r.rcfg.init(), cfg.init("cpu")
    oks = []
    for s in range(0, raw.size, r.width):
        part = raw[s:s + r.width]
        rs, ts, want, ok = _run("gqf_r6", rs, ts, "insert", part)
        assert np.array_equal(ok, want)
        oks.append(ok)
    _assert_state_equal(rs, ts)
    ok = np.concatenate(oks)
    fn, _ = _false_negatives(TQ, cfg, ts, raw, ok)
    want_hits = np.concatenate([
        _run("gqf_r6", rs, ts, "query", raw[s:s + r.width])[2]
        for s in range(0, raw.size, r.width)])
    assert fn == int((ok & ~want_hits).sum()) > 0
    assert int(ts.count) == ok.sum()



@pytest.mark.parametrize("extra_valid", [True, False])
def test_r6_overfilling_insert_raises(extra_valid):
    """R6's endless insert: at r > 24 an insert carried round a full table
    never ends (in the JAX loop too), so the port refuses a batch that
    would take ``count`` past ``num_slots`` before it runs, and leaves the
    state as it was. A batch that fills the table exactly ends, and so
    does an overfilling one at r = 24, where a key past ``max_probe`` is
    turned down."""
    raw = _raw(9, 65)
    cfg = TQ.GQFConfig(num_slots=64, remainder_bits=28)
    st, ok = TQ.insert(cfg, cfg.init("cpu"), _t(raw[:64]))
    assert int(st.count) == int(ok.sum()) == 64
    table = st.table.clone()
    extra = torch.tensor([extra_valid])
    if extra_valid:
        with pytest.raises(ValueError, match="R6"):
            TQ.insert(cfg, st, _t(raw[64:]), extra)
    else:
        st, ok = TQ.insert(cfg, st, _t(raw[64:]), extra)
        assert not ok.any()
    assert torch.equal(st.table, table) and int(st.count) == 64
    c24 = dataclasses.replace(cfg, remainder_bits=24)
    st, ok = TQ.insert(c24, c24.init("cpu"), _t(raw))
    assert int(st.count) == int(ok.sum()) == 64

def test_r7_bcht_expiry_drops_a_victim_pinned():
    """R7: at load 1.0 a key that reaches ``max_evictions`` has already
    written itself and drops the victim it carries. The port gives JAX's
    outcome; false negatives among ``ok`` are at most the failed keys."""
    r = _ref("bcht")
    raw = _raw(8, r.tcfg.num_slots)
    rs, ts = r.rcfg.init(), r.tcfg.init("cpu")
    oks = []
    for s in range(0, raw.size, r.width):
        rs, ts, want, ok = _run("bcht", rs, ts, "insert", raw[s:s + r.width])
        assert np.array_equal(ok, want)
        oks.append(ok)
    _assert_state_equal(rs, ts)
    ok = np.concatenate(oks)
    fn, failed_true = _false_negatives(TB, r.tcfg, ts, raw, ok)
    assert 0 < fn <= int((~ok).sum())
    assert failed_true > 0 and int(ts.count) == ok.sum()
    assert int(ts.used.sum()) == int(ts.count)   # every slot full: load 1.0


@pytest.mark.parametrize("name", ["tcf", "gqf", "bcht"])
def test_registry_backend_matches_reference(name):
    """Capabilities, sizing and fingerprints are ``repro``'s; dedup within a
    batch raises as there; a JAX handle's snapshot restores on the port
    with the same answers; without a card ``make`` raises unless asked for
    the CPU."""
    assert (dataclasses.asdict(tamq.get(name).capabilities)
            == dataclasses.asdict(ramq.get(name).capabilities))
    assert tamq.get(name).growth_sizings == ramq.get(name).growth_sizings
    h = tamq.make(name, capacity=300, device="cpu")
    ref = ramq.make(name, capacity=300)
    assert repr(h.config) == repr(ref.config) and h.device.type == "cpu"
    assert h.table_bytes == ref.table_bytes
    raw = _raw(31, 240)
    ok = h.insert(raw).ok
    assert torch.equal(ok, torch.from_numpy(np.array(ref.insert(raw).ok)))
    rep = h.insert(raw[:4])
    assert not rep.evictions.any() and int(rep.rounds) == 0
    with pytest.raises(NotImplementedError, match="dedup"):
        h.insert(raw[:4], dedup_within_batch=True)
    twin = tamq.make(name, config=h.config, device="cpu",
                     snapshot=ref.snapshot())
    probe = np.concatenate([raw, _raw(32, 300) | np.uint64(1 << 63)])
    assert np.array_equal(twin.query(probe).hits.numpy(),
                          np.asarray(ref.query(probe).hits))
    assert h.expected_fpr(0.5) == ref.expected_fpr(0.5)
    if not torch.cuda.is_available():       # the card by default, no fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tamq.make(name, capacity=300)
