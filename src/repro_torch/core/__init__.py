"""Core library of the port: the Cuckoo-GPU filter on torch tensors.

* :class:`CuckooConfig` / :class:`CuckooState` — static config + state.
* :func:`insert` / :func:`insert_bulk` / :func:`query` / :func:`delete`
  / :func:`apply_ops` — batch functional ops (the batched BFS frontier
  and the legacy eviction round loop, the bulk build with the
  graph-orientation engine, the unpack-based query, claim-round deletes
  and the fused mixed-op pass).
* :class:`CuckooFilter` — convenience object wrapper.
* ``sharded_filter`` — the mesh-sharded filter (fixed partitions, its
  shards on one device).
* The AMQ protocol types (``Capabilities``, ``InsertReport``,
  ``QueryResult``, ``DeleteReport``, ...) re-exported from
  :mod:`repro_torch.amq.protocol`, as the JAX package's ``core`` does.
"""

from ..amq.protocol import (  # noqa: F401
    Capabilities,
    CascadeReport,
    DeleteReport,
    InsertReport,
    LevelStats,
    MixedReport,
    OpBatch,
    QueryResult,
)
from .cuckoo_filter import (  # noqa: F401
    CuckooConfig,
    CuckooFilter,
    CuckooState,
    InsertStats,
    apply_ops,
    delete,
    insert,
    insert_bulk,
    prepare_keys,
    query,
    resolve_engine,
)
from .hashing import (  # noqa: F401
    hash_key,
    keys_from_numpy,
    keys_to_numpy,
    normalize_keys,
)
from .layout import BucketLayout  # noqa: F401
from .policies import OffsetPolicy, XorPolicy, make_policy  # noqa: F401
