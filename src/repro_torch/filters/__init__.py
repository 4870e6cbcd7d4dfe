"""Baseline AMQ structures of the port.

The blocked Bloom filter (the paper's append-only GPU baseline, GBBF) and
the pure-Python sequential cuckoo filter (the CPU baseline and the host
oracle behind the ``cpu-cuckoo`` backend); the two-choice, quotient and
BCHT baselines are later port slices (ROADMAP queue A item 11).
"""

from .blocked_bloom import BlockedBloomFilter, BloomConfig, BloomState  # noqa: F401
from .cpu_reference import PyCuckooConfig, PyCuckooFilter  # noqa: F401
