"""filterctl_torch — save / load / inspect AMQ filter snapshots with the
PyTorch port (``repro_torch.amq``), the counterpart of ``tools/filterctl.py``.

The same subcommands and flags: build and populate a filter, persist its
versioned snapshot, inspect a snapshot file without touching a device, and
restore one onto a freshly built config (the fingerprint check refuses a
wrong ``--capacity`` or sizing kwarg instead of restoring a corrupt table).
The snapshot files are the JAX package's format, so a file saved by either
CLI inspects and loads with the other.

    PYTHONPATH=src python tools/filterctl_torch.py save out.npz \\
        --backend cuckoo --capacity 100000 --insert-random 80000
    PYTHONPATH=src python tools/filterctl_torch.py inspect out.npz
    PYTHONPATH=src python tools/filterctl_torch.py load out.npz \\
        --backend cuckoo --capacity 100000 --verify-random 80000
    PYTHONPATH=src python tools/filterctl_torch.py stats \\
        bench-json/BENCH_serving_slo.json --cell hot_swap

``save`` and ``load`` run on the GPU (``--device cuda``, the default): with
no CUDA device they fail unless ``--device cpu`` is given, which runs the
kernels' plain versions on the CPU. ``inspect``, ``tiers`` and ``stats``
touch no device. ``--device-budget-bytes N`` on ``save``/``load`` builds a
tiered GPU-hot / host-cold handle; ``tiers`` prints a tiered snapshot's
per-level residency table:

    PYTHONPATH=src python tools/filterctl_torch.py save tiered.npz \\
        --backend cuckoo --capacity 4096 --device-budget-bytes 65536 \\
        --insert-random 60000
    PYTHONPATH=src python tools/filterctl_torch.py tiers tiered.npz

Sizing kwargs ride along as repeated ``--kw name=value`` flags (values are
parsed as int/float where possible), e.g. ``--kw fp_bits=8``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import amq  # noqa: E402
from repro_torch.amq.protocol import load_snapshot, save_snapshot  # noqa: E402


def _parse_kw(pairs) -> dict:
    out = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(f"--kw expects name=value, got {pair!r}")
        k, v = pair.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def _rand_keys(n: int, seed: int) -> np.ndarray:
    """First ``n`` distinct keys of the seeded stream — prefix-stable.

    Deduplicated in *generation order* (not sorted), so for one seed the
    first ``m <= n`` keys of a larger draw equal a smaller draw exactly:
    ``load --verify-random M`` (M <= save's ``--insert-random N``) queries
    keys that were actually inserted. The same keys as ``filterctl.py``'s:
    where the first ``n`` draws hold no repeat (a repeat among 2^24 draws
    has odds of about 2^-17), they are those keys, found with one sort of
    ``n`` values instead of an argsort of ``2n`` (with ``np.unique`` in its
    place, ``chip_smoke.py``'s tools phase took 80 s on an H100 host; with
    the sort, 8-10 s).
    """
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 2**64, size=2 * n + 16, dtype=np.uint64)
    head = np.sort(arr[:n])
    if not (head[1:] == head[:-1]).any():
        return arr[:n]
    _, idx = np.unique(arr, return_index=True)
    return arr[np.sort(idx)][:n]


def _load_keys(args) -> np.ndarray:
    if args.keys is not None:
        return np.load(args.keys).astype(np.uint64).reshape(-1)
    if args.insert_random:
        return _rand_keys(args.insert_random, args.seed)
    return np.zeros((0,), np.uint64)


def _device(args) -> torch.device:
    """``--device``; no CUDA device and no ``--device cpu`` is an error,
    never a fallback to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("filterctl_torch: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def _make(args, snapshot=None):
    kw = _parse_kw(args.kw)
    budget = getattr(args, "device_budget_bytes", None)
    if budget is not None:
        kw.update(tiered=True, device_budget_bytes=budget)
    if snapshot is not None:
        kw["snapshot"] = snapshot
        if snapshot.kind == "tiered" and budget is None:
            kw["tiered"] = True   # budget comes from the snapshot meta
    return amq.make(args.backend or "cuckoo", capacity=args.capacity,
                    device=_device(args), **kw)


def _tier_table(meta: dict) -> None:
    """Render a tiered snapshot's per-level table (tier, occupancy, bytes)."""
    rows = list(meta.get("cold_levels", ())) + list(meta.get("hot_levels", ()))
    print(f"{'tier':<6} {'alloc':>5} {'count':>10} {'slots':>10} "
          f"{'load':>6} {'bytes':>10} {'fpr_share':>10}")
    for lm in rows:
        load = lm["count"] / lm["num_slots"] if lm["num_slots"] else 0.0
        print(f"{lm['residency']:<6} {lm['alloc_index']:>5} "
              f"{lm['count']:>10} {lm['num_slots']:>10} {load:>6.3f} "
              f"{lm['table_bytes']:>10} {lm['share']:>10.2e}")
    device = sum(lm["table_bytes"] for lm in meta.get("hot_levels", ()))
    host = sum(lm["table_bytes"] for lm in meta.get("cold_levels", ()))
    print(f"device: {device} B of {meta.get('device_budget_bytes', '?')} B "
          f"budget; host: {host} B; total keys: {meta.get('count', '?')}")


def cmd_save(args) -> int:
    """Build + populate a filter, then persist its snapshot."""
    handle = _make(args)
    keys = _load_keys(args)
    if keys.size:
        report = handle.insert(keys)
        ok = (report.ok & report.routed).cpu().numpy()
        print(f"inserted {int(ok.sum())}/{keys.size} keys "
              f"(load {handle.load_factor:.3f})")
    snap = handle.snapshot()
    save_snapshot(args.path, snap)
    print(f"wrote {args.path}: backend={snap.backend} "
          f"count={snap.meta['count']} bytes={snap.nbytes}")
    return 0


def cmd_inspect(args) -> int:
    """Print a snapshot file's header and array inventory (host-only)."""
    snap = load_snapshot(args.path)
    print(f"backend:     {snap.backend}")
    print(f"kind:        {snap.kind}")
    print(f"format:      v{snap.version}")
    print(f"fingerprint: {snap.fingerprint or '(per-level, see meta)'}")
    for k, v in sorted(snap.meta.items()):
        if k in ("hot_levels", "cold_levels"):
            continue   # rendered as the tier table below
        print(f"meta.{k}: {v}")
    if snap.kind == "tiered":
        _tier_table(snap.meta)
    for name in sorted(snap.arrays):
        a = snap.arrays[name]
        print(f"array {name}: {a.dtype}{list(a.shape)} ({a.nbytes} B)")
    return 0


def cmd_tiers(args) -> int:
    """Print a tiered snapshot's per-level residency table (host-only)."""
    snap = load_snapshot(args.path)
    if snap.kind != "tiered":
        print(f"{args.path}: kind={snap.kind!r} — not a tiered snapshot "
              "(take one from amq.make(..., tiered=True).snapshot())",
              file=sys.stderr)
        return 2
    print(f"backend: {snap.backend} (format v{snap.version})")
    _tier_table(snap.meta)
    return 0


def cmd_load(args) -> int:
    """Restore a snapshot onto a freshly built config and sanity-check it."""
    snap = load_snapshot(args.path)
    if args.backend is None:
        args.backend = snap.backend
    handle = _make(args, snapshot=snap)
    print(f"restored {handle.name}: count={handle.count()} "
          f"load={handle.load_factor:.3f}")
    if args.verify_random:
        keys = _rand_keys(args.verify_random, args.seed)
        hits = handle.query(keys).hits.cpu().numpy()
        print(f"verify: {int(hits.sum())}/{keys.size} stored keys answered "
              "positive" + ("" if hits.all() else "  <-- FALSE NEGATIVES"))
        if not hits.all():
            return 1
    return 0


def cmd_stats(args) -> int:
    """Pretty-print serving-SLO metrics from a BENCH_*.json artifact.

    Reads the ``data.cells`` payload the serving_slo suite emits (each
    cell is a ``FilterService.stats()`` snapshot plus harness context) and
    renders the operator view: latency percentiles, sustained throughput,
    dispatch mix, queue bound, padding waste.
    """
    payload = json.loads(pathlib.Path(args.path).read_text())
    cells = payload.get("data", {}).get("cells", [])
    if args.cell:
        cells = [c for c in cells if args.cell in c.get("label", "")]
    if not cells:
        print(f"no serving cells in {args.path}"
              + (f" matching {args.cell!r}" if args.cell else ""))
        return 1
    for cell in cells:
        print(f"cell {cell['label']}")
        print(f"  enqueue-to-ready: p50={cell['p50_us']:.0f}us "
              f"p99={cell['p99_us']:.0f}us")
        print(f"  sustained:        {cell['sustained_ops_per_s']:.0f} ops/s "
              f"({cell['acked_ops']} acked over {cell['sim_s']:.2f}s)")
        kinds = ", ".join(f"{k}={v}" for k, v in
                          sorted(cell.get("dispatch_kinds", {}).items()))
        print(f"  dispatches:       {kinds or '(none)'}")
        print(f"  queue depth max:  {cell['queue_depth_max']}"
              + (f" (bound {cell['max_pending']})"
                 if "max_pending" in cell else ""))
        print(f"  padding waste:    {cell['padding_waste']:.1%}")
        if cell.get("shed_ops") or cell.get("rejected_submissions"):
            print(f"  refused:          shed_ops={cell['shed_ops']} "
                  f"rejected={cell['rejected_submissions']}")
        if "swap" in cell:
            s = cell["swap"]
            print(f"  hot swap:         {s['old_backend']} -> "
                  f"{s['new_backend']} pause={s['pause_s'] * 1e3:.1f}ms "
                  f"drained={s['drained_ops']} "
                  f"acked_verified={cell.get('acked_inserts_verified', 0)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="filterctl_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, capacity_required):
        p.add_argument("path", help="snapshot file (.npz)")
        # None so `load` can fall back to the snapshot's recorded backend
        # (save defaults to cuckoo in _make).
        p.add_argument("--backend", default=None)
        p.add_argument("--capacity", type=int,
                       required=capacity_required)
        p.add_argument("--kw", action="append", metavar="NAME=VALUE",
                       help="backend sizing kwarg (repeatable)")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device-budget-bytes", type=int, default=None,
                       help="build a tiered GPU-hot / host-cold handle "
                            "under this device budget")
        p.add_argument("--device", default="cuda",
                       help="where the filter lives: cuda (default; fails "
                            "without a CUDA device) or cpu")

    p = sub.add_parser("save", help="build + populate + snapshot to file")
    common(p, True)
    p.add_argument("--insert-random", type=int, default=0, metavar="N",
                   help="populate with N random uint64 keys before saving")
    p.add_argument("--keys", default=None,
                   help=".npy file of uint64 keys to insert before saving")
    p.set_defaults(fn=cmd_save)

    p = sub.add_parser("inspect", help="print snapshot header (no device)")
    p.add_argument("path")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("tiers", help="per-tier level table of a tiered "
                                     "snapshot (no device)")
    p.add_argument("path", help="tiered snapshot file (.npz)")
    p.set_defaults(fn=cmd_tiers)

    p = sub.add_parser("load", help="restore onto a freshly built config")
    common(p, True)
    p.add_argument("--verify-random", type=int, default=0, metavar="N",
                   help="re-query the first N keys of the save-time seeded "
                        "stream (N <= save's --insert-random) and fail on "
                        "any false negative")
    p.set_defaults(fn=cmd_load)

    p = sub.add_parser("stats", help="pretty-print serving-SLO metrics "
                                     "from a BENCH_*.json artifact")
    p.add_argument("path", help="BENCH_serving_slo.json (benchmarks.run "
                                "--json-dir output)")
    p.add_argument("--cell", default=None,
                   help="only cells whose label contains this substring")
    p.set_defaults(fn=cmd_stats)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
