"""The port's operator CLI (``tools/filterctl_torch.py``) and examples
(``examples/quickstart_torch.py``, ``examples/kmer_index_torch.py``) on the
CPU, in-process.

* every subcommand of ``filterctl_torch`` with ``--device cpu`` (``save``,
  ``inspect``, ``load`` with ``--verify-random``, a tiered ``save`` and
  ``tiers``, ``stats`` on a JSON written here), a wrong ``--capacity``
  refused by the fingerprint check, and no fallback to the CPU without
  ``--device cpu`` where there is no CUDA device;
* its seeded keys are ``filterctl.py``'s;
* one ``.npz`` saved by each CLI (``tools/filterctl.py`` on the JAX
  package) inspected and loaded by the other, every saved key found;
* both examples' ``main("cpu")`` with their sizes cut small, and their
  refusal of ``main("cuda")`` without a CUDA device; at the reference's
  sizes they run under the ``slow`` marker.

On the card these run in ``chip_smoke.py``'s ``tools`` phase.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.amq.protocol import SnapshotMismatchError as RMismatch
from repro_torch.amq import SnapshotMismatchError

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAPACITY = "4096"
KEYS = "1000"


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TORCH_CLI = _load("tools/filterctl_torch.py", "filterctl_torch")
JAX_CLI = _load("tools/filterctl.py", "filterctl")
QUICKSTART = _load("examples/quickstart_torch.py", "quickstart_torch")
KMER_INDEX = _load("examples/kmer_index_torch.py", "kmer_index_torch")


def _save(cli, path, *extra):
    return cli.main(["save", str(path), "--backend", "cuckoo", "--capacity",
                     CAPACITY, "--insert-random", KEYS, *extra])


def _verify(cli, path, *extra):
    return cli.main(["load", str(path), "--backend", "cuckoo", "--capacity",
                     CAPACITY, "--verify-random", KEYS, *extra])


def test_every_subcommand_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "f.npz"
    assert _save(TORCH_CLI, path, "--device", "cpu") == 0
    assert "inserted 1000/1000" in capsys.readouterr().out
    assert TORCH_CLI.main(["inspect", str(path)]) == 0
    out = capsys.readouterr().out
    assert "backend:     cuckoo" in out and "fingerprint" in out
    assert _verify(TORCH_CLI, path, "--device", "cpu") == 0
    assert "1000/1000 stored keys" in capsys.readouterr().out
    with pytest.raises(SnapshotMismatchError):
        TORCH_CLI.main(["load", str(path), "--capacity", "64",
                        "--device", "cpu"])
    assert TORCH_CLI.main(["tiers", str(path)]) == 2     # not tiered

    tiered = tmp_path / "t.npz"
    assert TORCH_CLI.main(["save", str(tiered), "--capacity", "256",
                           "--device-budget-bytes", "4096",
                           "--insert-random", "3000", "--kw", "fp_bits=8",
                           "--device", "cpu"]) == 0
    capsys.readouterr()
    assert TORCH_CLI.main(["tiers", str(tiered)]) == 0
    out = capsys.readouterr().out
    assert "cold" in out and "hot" in out and "total keys: 3000" in out
    assert TORCH_CLI.main(["inspect", str(tiered)]) == 0
    assert "kind:        tiered" in capsys.readouterr().out

    stats = tmp_path / "BENCH_serving_slo.json"
    cell = {"label": "zipf hot_swap", "p50_us": 120.0, "p99_us": 900.0,
            "sustained_ops_per_s": 5e5, "acked_ops": 1000, "sim_s": 0.5,
            "dispatch_kinds": {"query": 3}, "queue_depth_max": 7,
            "max_pending": 64, "padding_waste": 0.125,
            "swap": {"old_backend": "cuckoo", "new_backend": "cuckoo",
                     "pause_s": 0.002, "drained_ops": 10},
            "acked_inserts_verified": 400}
    stats.write_text(json.dumps({"data": {"cells": [cell]}}))
    assert TORCH_CLI.main(["stats", str(stats), "--cell", "hot_swap"]) == 0
    out = capsys.readouterr().out
    assert "p99=900us" in out and "pause=2.0ms" in out and "12.5%" in out
    assert TORCH_CLI.main(["stats", str(stats), "--cell", "none"]) == 1


def test_rand_keys_are_the_reference_keys(monkeypatch):
    """The same prefix-stable keys as ``filterctl.py``'s, also where the
    seeded stream repeats a value within its first ``n`` draws."""
    for n, seed in ((0, 0), (1, 5), (1000, 0), (4096, 7)):
        assert np.array_equal(TORCH_CLI._rand_keys(n, seed),
                              JAX_CLI._rand_keys(n, seed))

    class Repeats:
        def integers(self, lo, hi, size, dtype):
            return (np.arange(size, dtype=dtype) * 7919) % np.uint64(13)

    monkeypatch.setattr(np.random, "default_rng", lambda seed: Repeats())
    for n in (1, 5, 13):
        want = JAX_CLI._rand_keys(n, 0)
        assert np.array_equal(TORCH_CLI._rand_keys(n, 0), want)
        assert np.unique(want).size == want.size == n


def test_no_fallback_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(SystemExit, match="--device cpu"):
        _save(TORCH_CLI, tmp_path / "f.npz")
    with pytest.raises(SystemExit, match="--device cpu"):
        QUICKSTART.main("cuda")
    with pytest.raises(SystemExit, match="--device cpu"):
        KMER_INDEX.main("cuda")


def test_files_cross_between_the_clis(tmp_path, capsys):
    # The legacy engine spares the JAX side the frontier's compile; a file
    # carries the engine in its fingerprint, so both sides name it.
    from_jax, from_torch = tmp_path / "jax.npz", tmp_path / "torch.npz"
    kw = ("--kw", "insert_engine=legacy")
    assert _save(JAX_CLI, from_jax, *kw) == 0
    assert _save(TORCH_CLI, from_torch, *kw, "--device", "cpu") == 0
    capsys.readouterr()
    for cli, path in ((TORCH_CLI, from_jax), (JAX_CLI, from_torch)):
        assert cli.main(["inspect", str(path)]) == 0
        out = capsys.readouterr().out
        assert "backend:     cuckoo" in out and "insert_engine='legacy'" in out
    assert _verify(TORCH_CLI, from_jax, *kw, "--device", "cpu") == 0
    assert _verify(JAX_CLI, from_torch, *kw) == 0
    assert capsys.readouterr().out.count("1000/1000 stored keys") == 2
    with pytest.raises(RMismatch):
        JAX_CLI.main(["load", str(from_torch), "--capacity", "64"])


def test_examples_on_the_cpu_at_small_sizes(monkeypatch, capsys):
    for name, value in (("CAPACITY", 2_000), ("INSERTED", 1_900),
                        ("NEGATIVES", 1_000), ("DELETED", 200),
                        ("DEMO_CAPACITY", 512), ("DEMO_KEYS", 256),
                        ("STREAM_TOTAL", 20_000), ("STREAM_CHUNK", 4_096),
                        ("LIVE", 256)):
        monkeypatch.setattr(QUICKSTART, name, value)
    QUICKSTART.main("cpu")
    out = capsys.readouterr().out
    assert "kernel query: 256/256 hits" in out
    for name in ("cuckoo", "bloom", "tcf", "gqf", "bcht", "sharded-cuckoo",
                 "cpu-cuckoo"):
        assert f"  {name:15s} hits=1.000" in out
    for name, value in (("N_BASES", 20_000), ("READ", (100, 300)),
                        ("FOREIGN_BASES", 1_000), ("REGION", (5_000, 6_000))):
        monkeypatch.setattr(KMER_INDEX, name, value)
    KMER_INDEX.main("cpu")
    out = capsys.readouterr().out
    assert "170/170 k-mers found" in out and "removed 970 k-mers" in out


@pytest.mark.slow
def test_examples_on_the_cpu_at_the_reference_sizes(capsys):
    QUICKSTART.main("cpu")
    assert "kernel query: 4096/4096 hits" in capsys.readouterr().out
    KMER_INDEX.main("cpu")
    assert "170/170 k-mers found" in capsys.readouterr().out
