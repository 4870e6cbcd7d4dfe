"""Quickstart on the PyTorch port: the unified AMQ API on the GPU.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``, at its
sizes and with its checks:

    PYTHONPATH=src python examples/quickstart_torch.py             # the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Without a CUDA device it fails unless ``--device cpu`` is given, which runs
the kernels' plain PyTorch versions.
"""

import argparse

import numpy as np
import torch

from repro_torch import amq
from repro_torch.core import CuckooConfig, keys_from_numpy
from repro_torch.kernels.ops import cuckoo_query

CAPACITY = 100_000          # the first filter and the cascade's first level
INSERTED = 95_000
NEGATIVES = 50_000
DELETED = 10_000
DEMO_CAPACITY = 8_192       # each registry backend's
DEMO_KEYS = 4_096
STREAM_TOTAL = 1_000_000
STREAM_CHUNK = 1 << 17
LIVE = 4_096                # keys the kernel query probes


def main(device: str = "cuda") -> None:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart_torch: no CUDA device is available; "
                         "run with --device cpu")

    # 1. One registry, every filter family. Pick a backend by name and
    #    size it by capacity — paper defaults (16-bit fingerprints, 16-slot
    #    buckets, XOR placement, BFS eviction) apply for "cuckoo".
    filt = amq.make("cuckoo", capacity=CAPACITY, load_factor=0.95,
                    device=device)
    print(f"{filt.name}: {filt.table_bytes / 1024:.0f} KiB, expected FPR at "
          f"95% load: {filt.expected_fpr(0.95):.5f}, "
          f"caps={filt.capabilities}")

    # 2. Insert a batch of 64-bit keys (int32[n, 2] (lo, hi) pairs).
    #    bulk=True takes the bulk-build path.
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 2**63, size=INSERTED, dtype=np.uint64)
    keys = keys_from_numpy(raw, device)
    report = filt.insert(keys, bulk=True)
    print(f"inserted {int(report.ok.sum())}/{len(raw)} "
          f"(load {filt.load_factor:.2%}, {int(report.rounds)} rounds, "
          f"max eviction chain {int(report.evictions.max())})")

    # 3. Query: no false negatives, bounded false positives.
    assert bool(filt.query(keys).hits.all())
    neg = keys_from_numpy(
        rng.integers(2**63, 2**64, size=NEGATIVES, dtype=np.uint64), device)
    print(f"empirical FPR: "
          f"{float(filt.query(neg).hits.float().mean()):.5f}")

    # 4. Delete — the cuckoo filter's capability over Bloom filters; the
    #    handles raise on unsupported ops (try backend='bloom').
    filt.delete(keys[:DELETED])
    print(f"after deleting {DELETED}: count={filt.count()}")

    # 5. Same program, any backend: iterate the registry and branch on
    #    capabilities, never on names (on the GPU the Bloom filter runs
    #    its two kernels, the quotient filter its serial insert and delete;
    #    a host backend, the cpu-cuckoo oracle, runs where it lives).
    demo = keys_from_numpy(
        rng.integers(0, 2**63, size=DEMO_KEYS, dtype=np.uint64), device)
    for name in amq.names():
        where = amq.get(name).device or device
        h = amq.make(name, capacity=DEMO_CAPACITY, device=where)
        caps = h.capabilities
        h.insert(demo)
        hits = float(h.query(demo).hits.float().mean())
        deleted = bool(caps.supports_delete) and bool(h.delete(demo).ok.any())
        print(f"  {name:15s} hits={hits:.3f} "
              f"delete={'yes' if deleted else 'no'} "
              f"exact={caps.exact} bulk={caps.supports_bulk}")

    # 6. Auto-expansion: streaming workloads need no a-priori sizing. The
    #    handle grows as a geometric cascade of levels: inserts land in the
    #    newest level, queries fan over all of them, and the FPR budget is
    #    split across levels so the aggregate stays bounded.
    stream = amq.make("cuckoo", capacity=CAPACITY, auto_expand=True,
                      device=device)
    streamed = keys_from_numpy(
        rng.integers(0, 2**63, size=STREAM_TOTAL, dtype=np.uint64), device)
    for start in range(0, STREAM_TOTAL, STREAM_CHUNK):
        stream.insert(streamed[start:start + STREAM_CHUNK], bulk=True)
    print(f"streamed {STREAM_TOTAL} keys into an initial-{CAPACITY} cascade: "
          f"{len(stream.levels)} levels, aggregate load "
          f"{stream.load_factor:.2%}, fpr budget {stream.fpr_budget:.1e}")
    # No false negatives.
    assert bool(stream.query(streamed[:STREAM_CHUNK]).hits.all())

    # 7. The config surface: the OFFSET policy sizes tables exactly (no
    #    power-of-two over-provisioning); a pre-built config drops straight
    #    into the registry.
    flex = CuckooConfig.for_capacity(CAPACITY, load_factor=0.95,
                                     policy="offset")
    print(f"offset policy: {flex.table_bytes / 1024:.0f} KiB vs XOR "
          f"{filt.table_bytes / 1024:.0f} KiB")
    exact = amq.make("cuckoo", config=flex, device=device)
    print(f"handle from config: {exact.name}, "
          f"{exact.table_bytes / 1024:.0f} KiB")

    # 8. The kernel path: a batch query straight through the wrapper of the
    #    query kernel, on the handle's own config and state.
    live = keys[DELETED:DELETED + LIVE]   # still stored: the first were deleted
    hits = cuckoo_query(filt.config, filt.state, live)
    print(f"kernel query: {int(hits.sum())}/{LIVE} hits (expect {LIVE})")
    assert int(hits.sum()) == LIVE


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    main(ap.parse_args().device)
