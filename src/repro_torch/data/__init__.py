"""Data substrate of the port: the k-mer tooling of the genomic case study.

The JAX package's ``data`` also holds the filter-backed dedup and the
synthetic batch pipelines; those are later port slices (ROADMAP queue A).
"""

from .kmer import (  # noqa: F401
    canonicalize,
    encode_bases,
    kmer_keys,
    synthetic_genome,
)
