"""Data substrate of the port: synthetic pipelines, filter-backed dedup,
and the k-mer tooling of the genomic case study."""

from .dedup import (  # noqa: F401
    DedupConfig,
    StreamingDeduper,
    dedup_batch,
    forget_keys,
    make_dedup,
    make_deduper,
    sequence_keys,
)
from .kmer import (  # noqa: F401
    canonicalize,
    encode_bases,
    kmer_keys,
    synthetic_genome,
)
from .pipeline import (  # noqa: F401
    DataConfig,
    data_iterator,
    make_batch,
    make_frames_batch,
)
