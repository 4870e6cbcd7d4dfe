"""Port layout algebra and placement policies vs the JAX package, bit-exact.

SWAR masks, pack/unpack, extract/replace_tag, the circular first-true
scan, the bucket gathers and both placement policies, over
fp_bits {8, 16, 32} x bucket {4, 8, 16} x {xor, offset}. Inputs come from
numpy with a seed and go through ``repro.core`` and ``repro_torch.core``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as RL
from repro.core import policies as RP
from repro_torch.core import layout as TL
from repro_torch.core import policies as TP

torch.set_num_threads(1)

CELLS = [(fb, bs, pol) for fb in (8, 16, 32) for bs in (4, 8, 16)
         for pol in ("xor", "offset")]


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy uint32 -> the port's uint32-in-int64 tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want).astype(
        np.asarray(got).dtype))


@pytest.mark.parametrize("fb,bs,pol", CELLS)
def test_layout_and_policy_bit_exact(fb, bs, pol):
    rng = np.random.default_rng(fb * 100 + bs + (pol == "offset"))
    nb = 64 if pol == "xor" else 61
    lay_r, lay_t = RL.BucketLayout(nb, bs, fb), TL.BucketLayout(nb, bs, fb)
    assert (lay_t.words_per_bucket, lay_t.num_words, lay_t.fp_mask) == (
        lay_r.words_per_bucket, lay_r.num_words, lay_r.fp_mask)
    n = 256
    # Words with planted zero lanes and planted tag matches.
    words = _u32(rng, (n, lay_r.words_per_bucket))
    tags = (_u32(rng, n) & np.uint32(lay_r.fp_mask)) | np.uint32(1)
    lanes = np.array(RL.unpack_words(jnp.asarray(words), fb))
    lanes[rng.random(lanes.shape) < 0.2] = 0
    hit = rng.random(lanes.shape) < 0.2
    lanes[hit] = np.broadcast_to(tags[:, None], lanes.shape)[hit]
    words = np.asarray(RL.pack_tags(jnp.asarray(lanes), fb))
    w_j, w_t = jnp.asarray(words), _t(words)

    _eq(TL.unpack_words(w_t, fb), RL.unpack_words(w_j, fb))
    _eq(TL.pack_tags(TL.unpack_words(w_t, fb), fb), words)
    _eq(TL.swar_zero_mask(w_t, fb), RL.swar_zero_mask(w_j, fb))
    m_t = TL.swar_match_mask(w_t, _t(tags)[:, None], fb)
    m_j = RL.swar_match_mask(w_j, jnp.asarray(tags)[:, None], fb)
    _eq(m_t, m_j)
    _eq(TL.swar_mask_to_bools(m_t, fb), RL.swar_mask_to_bools(m_j, fb))
    _eq(TL.broadcast_tag(_t(tags), fb), RL.broadcast_tag(jnp.asarray(tags), fb))

    slot = rng.integers(0, lay_r.tags_per_word, size=n)
    word0 = words[:, 0]
    _eq(TL.extract_tag(_t(word0), torch.from_numpy(slot), fb),
        RL.extract_tag(jnp.asarray(word0), jnp.asarray(slot), fb))
    _eq(TL.replace_tag(_t(word0), torch.from_numpy(slot), _t(tags), fb),
        RL.replace_tag(jnp.asarray(word0), jnp.asarray(slot),
                       jnp.asarray(tags), fb))

    flags = rng.random((n, bs)) < 0.15
    start = rng.integers(0, bs, size=n)
    f_t, s_t = TL.first_true_circular(torch.from_numpy(flags),
                                      torch.from_numpy(start))
    f_j, s_j = RL.first_true_circular(jnp.asarray(flags),
                                      jnp.asarray(start, jnp.int32))
    _eq(f_t, f_j)
    _eq(s_t, s_j)
    _eq(TL.slot_to_word(s_t, lay_t)[0], RL.slot_to_word(s_j, lay_r)[0])
    _eq(TL.slot_to_word(s_t, lay_t)[1], RL.slot_to_word(s_j, lay_r)[1])

    table = _u32(rng, lay_r.num_words)
    buckets = rng.integers(0, nb, size=n)
    _eq(TL.bucket_tags(torch.from_numpy(table.view(np.int32)),
                       torch.from_numpy(buckets), lay_t),
        RL.bucket_tags(jnp.asarray(table), jnp.asarray(buckets), lay_r))
    _eq(TL.scan_start(_t(tags), lay_t), RL.scan_start(jnp.asarray(tags), lay_r))

    # Placement policy: tags, candidate buckets, relocation, matching.
    rp, tp = RP.make_policy(pol, nb, fb), TP.make_policy(pol, nb, fb)
    assert (tp.kind, tp.effective_fp_bits) == (rp.kind, rp.effective_fp_bits)
    hi, lo = _u32(rng, n), _u32(rng, n)
    hi[:4] = 0  # tag derivation maps a zero fingerprint to 1
    tag_j, tag_t = rp.make_tag(jnp.asarray(hi)), tp.make_tag(_t(hi))
    _eq(tag_t, tag_j)
    for a, b in zip(tp.initial_buckets(_t(lo), tag_t),
                    rp.initial_buckets(jnp.asarray(lo), tag_j)):
        _eq(a, b)
    in_alt = rng.random(n) < 0.5
    stored_t = tp.place_tag(tag_t, torch.from_numpy(in_alt))
    stored_j = rp.place_tag(tag_j, jnp.asarray(in_alt))
    _eq(stored_t, stored_j)
    bucket = rng.integers(0, nb, size=n).astype(np.uint32)
    alt_t = tp.alt_bucket(_t(bucket), stored_t)
    _eq(alt_t, rp.alt_bucket(jnp.asarray(bucket), stored_j))
    _eq(tp.on_relocate(stored_t), rp.on_relocate(stored_j))
    for a, b in zip(tp.query_match_tags(tag_t), rp.query_match_tags(tag_j)):
        _eq(a, b)
    _eq(tp.match_tag(stored_t, tag_t), rp.match_tag(stored_j, tag_j))


def test_layout_rejects_bad_widths():
    with pytest.raises(ValueError):
        TL.BucketLayout(64, 16, 12)
    with pytest.raises(ValueError):
        TL.BucketLayout(64, 6, 8)
    with pytest.raises(ValueError):
        TP.XorPolicy(60, 16)
