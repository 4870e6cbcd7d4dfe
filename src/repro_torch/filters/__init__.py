"""Baseline AMQ structures of the port (the paper's §5.1).

The blocked Bloom filter (the append-only GPU baseline, GBBF), the
two-choice filter (TCF), the quotient-filter analogue (GQF, whose serial
Robin Hood insert and delete run as CUDA kernels on the card), the
bucketed cuckoo hash table (BCHT, exact membership) and the pure-Python
sequential cuckoo filter (the CPU baseline and the host oracle behind the
``cpu-cuckoo`` backend). Each module provides a ``*Config`` (frozen, the
JAX package's fields and defaults), a state NamedTuple of tensors,
functional ``insert``/``query``[/``delete``] and a stateful wrapper; all
of them are also registry backends: ``repro_torch.amq.make("bloom"|"tcf"|
"gqf"|"bcht", capacity=...)``.
"""

from .bcht import BCHTConfig, BCHTState, BucketedCuckooHashTable  # noqa: F401
from .blocked_bloom import BlockedBloomFilter, BloomConfig, BloomState  # noqa: F401
from .cpu_reference import PyCuckooConfig, PyCuckooFilter  # noqa: F401
from .quotient import GQFConfig, GQFState, QuotientFilter  # noqa: F401
from .two_choice import TCFConfig, TCFState, TwoChoiceFilter  # noqa: F401
