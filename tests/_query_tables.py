"""Tables whose query answers are known, for the fused query's early exit.

The fused query kernel (#2) reads bucket i2 only where bucket i1 holds no
matching tag. :func:`crafted_query_table` builds, in numpy, a table in
which each picked key's answer is set by one of these cases (every other
lane of its buckets holds a random tag that matches none of the key's):

* ``i2_only``: bucket i1 full of other tags, the key's t2 in bucket i2;
* ``i1_only``: t1 in bucket i1, bucket i2 full of other tags;
* ``both``: t1 in bucket i1 and t2 in bucket i2;
* ``neither``: both buckets full of other tags (a miss);
* ``one_bucket_hit`` / ``one_bucket_miss``: XOR keys with i1 == i2, their
  one bucket with and without the tag;
* ``base_in_i2`` (OFFSET): the base tag, without the choice bit, in bucket
  i2 and bucket i1 full of other tags (a miss: t2 carries the choice bit).

The picked keys share no bucket, so every case holds whatever the others
write. The module imports only numpy, torch and the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cuckoo_filter import prepare_keys_plain

HITS = ("i2_only", "i1_only", "both", "one_bucket_hit")
TWO_BUCKET_CASES = {"xor": ("i2_only", "i1_only", "both", "neither"),
                    "offset": ("i2_only", "i1_only", "both", "neither",
                               "base_in_i2")}
ONE_BUCKET_CASES = ("one_bucket_hit", "one_bucket_miss")


def expected_cases(policy: str) -> set:
    """The cases a table of ``policy`` holds."""
    return set(TWO_BUCKET_CASES[policy]) | (
        set(ONE_BUCKET_CASES) if policy == "xor" else set())


def crafted_query_table(config, pool: torch.Tensor, seed: int,
                        one_bucket_keys: int = 8):
    """Pick keys of ``pool`` (int32[n, 2]) whose candidate buckets no other
    picked key shares (at most ``one_bucket_keys`` with i1 == i2, taken
    first) and write a case into each one's buckets.

    Returns (keys int32[m, 2] on the CPU, table words uint32[num_words],
    expected hits bool[m], case names str[m])."""
    tag, i1, i2 = prepare_keys_plain(config, pool.cpu())
    t1, t2 = config.placement.query_match_tags(tag)
    tag, i1, i2, t1, t2 = (x.numpy() for x in (tag, i1, i2, t1, t2))
    one = np.flatnonzero(i1 == i2)[:one_bucket_keys]
    used, picked = set(), []
    for k in np.concatenate([one, np.flatnonzero(i1 != i2)]).tolist():
        a, b = int(i1[k]), int(i2[k])
        if a not in used and b not in used:
            used.update((a, b))
            picked.append(k)

    rng = np.random.default_rng(seed)
    bs, fb = config.bucket_size, config.fp_bits
    lanes = np.zeros((config.num_buckets, bs), np.uint64)
    two_cases = TWO_BUCKET_CASES[config.policy]
    cases = []
    for k in picked:
        a, b = int(i1[k]), int(i2[k])
        avoid = np.array([t1[k], t2[k], tag[k]], np.uint64)
        for bucket in {a, b}:
            other = rng.integers(1, 1 << fb, size=bs, dtype=np.uint64)
            while np.isin(other, avoid).any():
                bad = np.isin(other, avoid)
                other[bad] = rng.integers(1, 1 << fb, size=int(bad.sum()),
                                          dtype=np.uint64)
            lanes[bucket] = other
        if a == b:
            case = ONE_BUCKET_CASES[sum(c.startswith("one") for c in cases) % 2]
        else:
            case = two_cases[sum(not c.startswith("one") for c in cases)
                             % len(two_cases)]
        if case in ("i1_only", "both", "one_bucket_hit"):
            lanes[a, rng.integers(bs)] = t1[k]
        if case in ("i2_only", "both"):
            lanes[b, rng.integers(bs)] = t2[k]
        if case == "base_in_i2":
            lanes[b, rng.integers(bs)] = tag[k]
        cases.append(case)

    tpw = 32 // fb
    shifts = np.arange(tpw, dtype=np.uint64) * np.uint64(fb)
    words = (lanes.reshape(-1, tpw) << shifts).sum(-1).astype(np.uint32)
    cases = np.array(cases)
    return pool.cpu()[picked], words, np.isin(cases, HITS), cases
