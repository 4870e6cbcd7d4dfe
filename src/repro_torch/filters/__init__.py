"""Baseline AMQ structures of the port.

This slice ports the blocked Bloom filter (the paper's append-only GPU
baseline, GBBF); the two-choice, quotient and BCHT baselines are later
port slices (ROADMAP queue A item 11).
"""

from .blocked_bloom import BlockedBloomFilter, BloomConfig, BloomState  # noqa: F401
