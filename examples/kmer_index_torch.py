"""Genomic k-mer indexing case study (paper §5.5) end to end on the PyTorch
port, the counterpart of ``examples/kmer_index.py`` at its sizes and with
its checks.

Synthetic genome -> 2-bit codes -> canonical 31-mers (the k-mer pack
kernel on the GPU) -> cuckoo filter membership, with deletion
demonstrating contamination removal (the dynamic-AMQ workflow of
NGSReadsTreatment / Cleanifier).

    PYTHONPATH=src python examples/kmer_index_torch.py             # the GPU
    PYTHONPATH=src python examples/kmer_index_torch.py --device cpu

Without a CUDA device it fails unless ``--device cpu`` is given.
"""

import argparse

import torch

from repro_torch.core import CuckooConfig, CuckooFilter
from repro_torch.data.kmer import kmer_keys, synthetic_genome

K = 31
N_BASES = 200_000
READ = (1000, 1200)             # a read of the genome
FOREIGN_BASES = 5_000
REGION = (50_000, 60_000)       # the contaminating region deleted


def main(device: str = "cuda") -> None:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kmer_index_torch: no CUDA device is available; "
                         "run with --device cpu")

    print(f"generating {N_BASES} bases of synthetic genome...")
    genome = synthetic_genome(N_BASES, seed=42)
    keys = kmer_keys(genome, k=K, canonical=True, device=device)
    print(f"extracted {keys.shape[0]} canonical {K}-mers")

    cfg = CuckooConfig.for_capacity(keys.shape[0], load_factor=0.9)
    index = CuckooFilter(cfg, device=device)
    ok, _ = index.insert(keys)
    print(f"indexed {int(ok.sum())} k-mers "
          f"({cfg.table_bytes / 2**20:.1f} MiB filter, "
          f"load {index.load_factor:.2%})")

    # membership of reads from the same genome: every k-mer must hit
    read = genome[READ[0]:READ[1]]
    read_keys = kmer_keys(read, k=K, canonical=True, device=device)
    hits = index.query(read_keys)
    print(f"read lookup: {int(hits.sum())}/{read_keys.shape[0]} k-mers found "
          "(expect all)")
    assert bool(hits.all())

    # contamination: foreign sequence k-mers should mostly miss
    foreign = synthetic_genome(FOREIGN_BASES, seed=777)
    fk = kmer_keys(foreign, k=K, canonical=True, device=device)
    fpr = float(index.query(fk).float().mean())
    print(f"foreign-genome hit rate: {fpr:.5f} (~filter FPR)")

    # deletion: remove a contaminating region from the index (Bloom can't!)
    region = genome[REGION[0]:REGION[1]]
    rk = kmer_keys(region, k=K, canonical=True, device=device)
    removed = index.delete(rk)
    print(f"removed {int(removed.sum())} k-mers of a contaminating region; "
          f"count={int(index.state.count)}")
    post = index.query(rk)
    print(f"region k-mers still positive after removal: "
          f"{float(post.float().mean()):.4f} (residual = shared k-mers "
          "elsewhere in the genome + FPR)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    main(ap.parse_args().device)
