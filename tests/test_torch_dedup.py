"""The port's data pipeline and filter-backed dedup vs the JAX package's.

* ``make_batch``, ``make_frames_batch`` and ``data_iterator`` draw from the
  JAX package's numpy generators: equal tokens, frames and labels bit for
  bit. ``sequence_keys`` (uint32 arithmetic carried in int64) and
  ``intra_batch_duplicates`` are bit-exact with JAX's.
* ``dedup_batch`` on ``bloom`` is deterministic in both packages: equal
  masks, stats and tables, batch after batch. On ``cuckoo`` and
  ``sharded-cuckoo`` (the kernels' plain versions, whose placement is not
  JAX's) it is held by invariants against a set oracle: every repeated
  sequence masked, and a fresh sequence masked only where the filter
  already answered its key (a false positive of the state before the
  batch).
* ``StreamingDeduper`` on an auto-expanding cascade (``cuckoo``, and
  ``sharded-cuckoo`` over 4 shards) against the same oracle, across
  growth, then ``forget``; ``forget`` on ``bloom`` raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import dedup as RDD
from repro.data import pipeline as RP
from repro_torch import amq as tamq
from repro_torch import convert
from repro_torch.core.hashing import keys_to_numpy
from repro_torch.data import dedup as TDD
from repro_torch.data import pipeline as TP

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's backend optimisations: its
# integer results do not depend on them.
_XLA_FAST = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}

CFG = TP.DataConfig(vocab_size=1000, batch=64, seq_len=24, seed=3,
                    duplicate_fraction=0.25)
RCFG = RP.DataConfig(**{f: getattr(CFG, f) for f in
                        ("vocab_size", "batch", "seq_len", "seed",
                         "duplicate_fraction", "zipf_a")})


def _tokens(step):
    return TP.make_batch(CFG, step, device="cpu")["tokens"]


def test_batches_bit_exact():
    it = TP.data_iterator(CFG, start_step=2, device="cpu")
    for step in (2, 3):
        got = next(it)["tokens"]
        want = np.asarray(RP.make_batch(RCFG, step)["tokens"])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    got = TP.make_frames_batch(CFG, 1, d_model=8, device="cpu")
    want = RP.make_frames_batch(RCFG, 1, d_model=8)
    for f in ("frames", "labels"):
        assert got[f].numpy().dtype == np.asarray(want[f]).dtype
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.make_batch(CFG, 0)


def test_keys_and_intra_batch_duplicates_bit_exact():
    tokens = torch.cat([_tokens(0), _tokens(1)])
    tokens[5] = tokens[70]                        # a cross-batch repeat
    tokens[9, 3] = -7                             # negative ids hash too
    got = TDD.sequence_keys(tokens)
    want = RDD.sequence_keys(jnp.asarray(tokens.numpy()))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    dup = TDD.intra_batch_duplicates(got)
    np.testing.assert_array_equal(
        dup.numpy(), np.asarray(RDD.intra_batch_duplicates(want)))
    assert 0 < int(dup.sum()) < tokens.shape[0]


def test_dedup_batch_bit_exact_on_bloom():
    kw = dict(bits_per_key=12, k=8)
    rcfg, rstate = RDD.make_dedup(4096, backend="bloom", **kw)
    tcfg, tstate = TDD.make_dedup(4096, backend="bloom", device="cpu", **kw)
    assert repr(tcfg.filter) == repr(rcfg.filter)
    # One jitted JAX step (dedup_batch is jit-compatible with cfg static).
    ref_step = jax.jit(functools.partial(RDD.dedup_batch, rcfg),
                       compiler_options=_XLA_FAST)
    for step in range(3):
        tokens = _tokens(step)
        rstate, rout, rstats = ref_step(
            rstate, {"tokens": jnp.asarray(tokens.numpy())})
        tstate, tout, tstats = TDD.dedup_batch(tcfg, tstate,
                                               {"tokens": tokens})
        np.testing.assert_array_equal(tout["mask"].numpy(),
                                      np.asarray(rout["mask"]))
        for k in ("duplicates", "insert_failures", "unrouted"):
            assert int(tstats[k]) == int(rstats[k]), k
        np.testing.assert_array_equal(convert.state_to_numpy(tstate)["table"],
                                      np.asarray(rstate.table))
    assert int(tstats["duplicates"]) > 0
    with pytest.raises(NotImplementedError, match="append-only"):
        TDD.forget_keys(tcfg, tstate, TDD.sequence_keys(tokens))


class _Oracle:
    """The stream's seen set of 64-bit sequence keys."""

    def __init__(self):
        self.seen = set()

    def check(self, keys, mask, hit_before=None):
        """Every repeat masked; a fresh key masked only where
        ``hit_before`` (the filter's answer before the batch) says so.
        Returns the fresh keys masked."""
        raw = keys_to_numpy(keys)
        mask = mask.cpu().numpy()
        fp = 0
        for i, k in enumerate(raw.tolist()):
            if k in self.seen:
                assert not mask[i], i
            elif not mask[i]:
                fp += 1
                assert hit_before is None or hit_before[i], i
            self.seen.add(k)
        return fp


@pytest.mark.parametrize("backend,kw", [
    ("cuckoo", {}), ("sharded-cuckoo", {"num_shards": 4,
                                        "partitions_per_shard": 2})])
def test_dedup_batch_invariants(backend, kw):
    cfg, state = TDD.make_dedup(2048, backend=backend, device="cpu", **kw)
    oracle = _Oracle()
    for step in range(4):
        tokens = _tokens(step)
        keys = TDD.sequence_keys(tokens)
        hit_before = cfg.adapter.query(cfg.filter, state, keys)[1].hits
        state, out, stats = TDD.dedup_batch(cfg, state, {"tokens": tokens})
        oracle.check(keys, out["mask"], hit_before.numpy())
        assert int(stats["duplicates"]) == int((~out["mask"]).sum())
        assert int(stats["insert_failures"]) == 0
        assert int(stats["unrouted"]) == 0
    assert int(state.count.sum()) == len(oracle.seen)
    state = TDD.forget_keys(cfg, state, TDD.sequence_keys(_tokens(0)))
    assert 0 < int(state.count.sum()) < len(oracle.seen)


@pytest.mark.parametrize("backend,kw", [
    ("cuckoo", {}), ("sharded-cuckoo", {"num_shards": 4})])
def test_streaming_deduper_on_a_cascade(backend, kw):
    d = TDD.make_deduper(128, backend=backend, service_batch=32,
                         device="cpu", **kw)
    assert type(d.handle) is tamq.CascadeHandle
    oracle = _Oracle()
    fresh_masked = 0
    for step in range(6):
        tokens = _tokens(step)
        out, stats = d.dedup({"tokens": tokens})
        fresh_masked += oracle.check(TDD.sequence_keys(tokens), out["mask"])
        assert stats["duplicates"] == int((~out["mask"]).sum())
    d.flush()
    assert len(d.handle.levels) > 1
    assert d.stats["insert_failures"] == 0
    assert d.handle.count() == len(oracle.seen) - fresh_masked
    assert fresh_masked <= 2                      # false positives only
    first = TDD.sequence_keys(_tokens(0))
    assert d.service.query(keys_to_numpy(first)).result().all()
    d.forget(first[~TDD.intra_batch_duplicates(first)])
    assert d.handle.count() < len(oracle.seen) - fresh_masked
    bloom = TDD.make_deduper(128, backend="bloom", device="cpu")
    with pytest.raises(NotImplementedError, match="append-only"):
        bloom.forget(first)
