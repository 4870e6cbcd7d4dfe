"""Bucket placement policies (paper §2.1 and §4.6.2), in torch.

Port of ``repro.core.policies``; all values are uint32 held in int64.

* ``XorPolicy``    — partial-key cuckoo hashing, ``i2 = i1 ^ H(fp)``;
  power-of-two bucket counts only.
* ``OffsetPolicy`` — any bucket count; a choice bit in the tag's top bit
  records whether the entry sits in its primary (0) or alternate (1)
  bucket: ``i2 = (i1 + offset(fp)) mod m``.
"""

from __future__ import annotations

import dataclasses

import torch

from .hashing import fmix32


@dataclasses.dataclass(frozen=True)
class XorPolicy:
    """i2 = i1 XOR H(fp); power-of-two bucket counts only."""

    num_buckets: int
    fp_bits: int

    kind: str = dataclasses.field(default="xor", init=False)

    def __post_init__(self):
        if self.num_buckets & (self.num_buckets - 1):
            raise ValueError(
                "XorPolicy requires a power-of-two number of buckets "
                "(use OffsetPolicy for arbitrary sizes — paper §4.6.2)")

    @property
    def mask(self) -> int:
        return self.num_buckets - 1

    @property
    def effective_fp_bits(self) -> int:
        return self.fp_bits

    def make_tag(self, fp_hash: torch.Tensor) -> torch.Tensor:
        """Derive the stored tag from the fingerprint hash word (never 0)."""
        fp = fp_hash & ((1 << self.fp_bits) - 1)
        return torch.where(fp == 0, 1, fp)

    def primary_bucket(self, index_hash: torch.Tensor) -> torch.Tensor:
        return index_hash & self.mask

    def initial_buckets(self, index_hash, tag):
        i1 = self.primary_bucket(index_hash)
        return i1, self.alt_bucket(i1, tag)

    def alt_bucket(self, bucket: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
        """Involution: alt(alt(i, t), t) == i."""
        return bucket ^ (fmix32(tag) & self.mask)

    def place_tag(self, tag: torch.Tensor, in_alternate: bool) -> torch.Tensor:
        """Tag as stored when placed in primary/alternate bucket (no-op here)."""
        del in_alternate
        return tag

    def on_relocate(self, stored_tag: torch.Tensor) -> torch.Tensor:
        """Stored tag after moving to its other bucket (no-op for XOR)."""
        return stored_tag

    def match_tag(self, stored: torch.Tensor, query_tag: torch.Tensor) -> torch.Tensor:
        return stored == query_tag

    def query_match_tags(self, query_tag: torch.Tensor):
        """Tags to match in (primary, alternate) buckets for a query."""
        return query_tag, query_tag


@dataclasses.dataclass(frozen=True)
class OffsetPolicy:
    """Asymmetric offset + choice bit; arbitrary bucket counts (§4.6.2)."""

    num_buckets: int
    fp_bits: int

    kind: str = dataclasses.field(default="offset", init=False)

    @property
    def choice_bit(self) -> int:
        return 1 << (self.fp_bits - 1)

    @property
    def effective_fp_bits(self) -> int:
        return self.fp_bits - 1  # one bit of entropy spent on the choice bit

    @property
    def fp_value_mask(self) -> int:
        return (1 << (self.fp_bits - 1)) - 1

    def make_tag(self, fp_hash: torch.Tensor) -> torch.Tensor:
        fp = fp_hash & self.fp_value_mask
        return torch.where(fp == 0, 1, fp)

    def _offset(self, tag: torch.Tensor) -> torch.Tensor:
        """Fingerprint-derived offset in [1, m) (0 would alias the buckets)."""
        fp = tag & self.fp_value_mask
        return fmix32(fp ^ 0x27D4EB2F) % (self.num_buckets - 1) + 1

    def primary_bucket(self, index_hash: torch.Tensor) -> torch.Tensor:
        return index_hash % self.num_buckets

    def initial_buckets(self, index_hash, tag):
        i1 = self.primary_bucket(index_hash)
        return i1, (i1 + self._offset(tag)) % self.num_buckets

    def alt_bucket(self, bucket: torch.Tensor, stored_tag: torch.Tensor) -> torch.Tensor:
        """Other bucket of a *stored* entry, using its choice bit."""
        m = self.num_buckets
        off = self._offset(stored_tag)
        in_alt = (stored_tag & self.choice_bit) != 0
        fwd = (bucket + off) % m          # choice 0: currently primary -> alt
        back = (bucket + m - off) % m     # choice 1: currently alt -> primary
        return torch.where(in_alt, back, fwd)

    def place_tag(self, tag: torch.Tensor, in_alternate) -> torch.Tensor:
        base = tag & self.fp_value_mask
        return torch.where(torch.as_tensor(in_alternate, device=tag.device),
                           base | self.choice_bit, base)

    def on_relocate(self, stored_tag: torch.Tensor) -> torch.Tensor:
        """Moving between buckets flips the choice bit (paper §4.6.2)."""
        return stored_tag ^ self.choice_bit

    def match_tag(self, stored: torch.Tensor, query_tag: torch.Tensor) -> torch.Tensor:
        """Match ignores the choice bit."""
        m = self.fp_value_mask
        return (stored & m) == (query_tag & m)

    def query_match_tags(self, query_tag: torch.Tensor):
        """In the primary bucket an entry carries choice=0; in the
        alternate, choice=1 — match the full tag including that bit."""
        base = query_tag & self.fp_value_mask
        return base, base | self.choice_bit


def make_policy(kind: str, num_buckets: int, fp_bits: int):
    if kind == "xor":
        return XorPolicy(num_buckets, fp_bits)
    if kind == "offset":
        return OffsetPolicy(num_buckets, fp_bits)
    raise ValueError(f"unknown placement policy {kind!r}")
