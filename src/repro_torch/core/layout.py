"""Packed-fingerprint bucket layout + SWAR primitives (paper §4.2), in torch.

Port of ``repro.core.layout``. The table is a flat ``int32[num_words]``
tensor (the bits of the JAX package's ``uint32`` words); a bucket is the
contiguous word range ``[b * wpb, (b+1) * wpb)``. A word holds 4×8-bit,
2×16-bit or 1×32-bit fingerprints.

Word arithmetic here runs on uint32 values held in int64 (see
:mod:`.bits64`): :func:`gather_bucket_words` widens what it reads, and
callers narrow with ``bits64.to_i32`` when they write back.
"""

from __future__ import annotations

import dataclasses

import torch

from .bits64 import MASK32, from_i32

# SWAR constants per fingerprint width: (low-7(15,31)-bits pattern, high-bit pattern).
_SWAR_LOW7 = {8: 0x7F7F7F7F, 16: 0x7FFF7FFF, 32: 0x7FFFFFFF}
_SWAR_HIGH = {8: 0x80808080, 16: 0x80008000, 32: 0x80000000}


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static description of the packed bucket layout."""

    num_buckets: int
    bucket_size: int          # b: fingerprints per bucket
    fp_bits: int              # f: bits per stored tag (incl. choice bit if any)

    def __post_init__(self):
        if self.fp_bits not in (8, 16, 32):
            raise ValueError("fp_bits must be 8, 16 or 32 (hardware-friendly widths)")
        if self.bucket_size % self.tags_per_word:
            raise ValueError("bucket_size must be a multiple of tags_per_word")

    @property
    def tags_per_word(self) -> int:
        return 32 // self.fp_bits

    @property
    def words_per_bucket(self) -> int:
        return self.bucket_size // self.tags_per_word

    @property
    def num_words(self) -> int:
        return self.num_buckets * self.words_per_bucket

    @property
    def num_slots(self) -> int:
        return self.num_buckets * self.bucket_size

    @property
    def fp_mask(self) -> int:
        return (1 << self.fp_bits) - 1

    @property
    def table_bytes(self) -> int:
        return self.num_words * 4

    def empty_table(self, device) -> torch.Tensor:
        return torch.zeros((self.num_words,), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# SWAR primitives (paper §4.3 "bitwise SWAR algorithm", §4.4 HasZeroSegment).
# ---------------------------------------------------------------------------

def swar_zero_mask(word: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """High bit of each fp lane set iff that lane is zero — exact per lane.

        y = (v & 0x7F..7F) + 0x7F..7F   # high bit <- OR of low bits
        y |= v                           # high bit <- lane nonzero
        mask = ~y & 0x80..80
    """
    low7 = _SWAR_LOW7[fp_bits]
    y = ((word & low7) + low7) | word
    return ~y & _SWAR_HIGH[fp_bits]


def swar_match_mask(word: torch.Tensor, tag: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """High bit of each fp lane set iff that lane equals ``tag``."""
    return swar_zero_mask(word ^ broadcast_tag(tag, fp_bits), fp_bits)


def broadcast_tag(tag: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """Replicate a tag into every lane of a 32-bit word (paper BroadcastTag)."""
    word = tag & MASK32
    if fp_bits <= 16:
        word = word | ((word << 16) & MASK32)
    if fp_bits <= 8:
        word = word | ((word & 0x00FF00FF) << 8)
    return word


def swar_mask_to_bools(mask: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """SWAR high-bit mask -> bool[..., tags_per_word] per-lane flags."""
    tpw = 32 // fp_bits
    shifts = torch.arange(tpw, device=mask.device) * fp_bits + (fp_bits - 1)
    return ((mask[..., None] >> shifts) & 1).bool()


# ---------------------------------------------------------------------------
# Pack / unpack and slot read-modify-write.
# ---------------------------------------------------------------------------

def unpack_words(words: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """[..., W] packed words -> [..., W * tpw] tag values."""
    tpw = 32 // fp_bits
    shifts = torch.arange(tpw, device=words.device) * fp_bits
    tags = (words[..., None] >> shifts) & ((1 << fp_bits) - 1)
    return tags.reshape(*words.shape[:-1], words.shape[-1] * tpw)


def pack_tags(tags: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """Inverse of unpack_words."""
    tpw = 32 // fp_bits
    t = tags.reshape(*tags.shape[:-1], tags.shape[-1] // tpw, tpw)
    shifts = torch.arange(tpw, device=tags.device) * fp_bits
    return ((t & ((1 << fp_bits) - 1)) << shifts).sum(dim=-1)


def extract_tag(word: torch.Tensor, slot_in_word: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """ExtractTag (paper Alg. 1 line 17)."""
    return (word >> (slot_in_word * fp_bits)) & ((1 << fp_bits) - 1)


def replace_tag(word: torch.Tensor, slot_in_word: torch.Tensor,
                tag: torch.Tensor, fp_bits: int) -> torch.Tensor:
    """ReplaceTag (paper Alg. 1 line 18) — returns the ``desired`` word."""
    shift = slot_in_word * fp_bits
    lane_mask = ((1 << fp_bits) - 1) << shift
    return (word & ~lane_mask) | ((tag << shift) & lane_mask)


# ---------------------------------------------------------------------------
# Bucket gather + circular first-empty / first-match scans.
# ---------------------------------------------------------------------------

def gather_bucket_words(table: torch.Tensor, bucket: torch.Tensor,
                        layout: BucketLayout) -> torch.Tensor:
    """Gather the packed words of each bucket -> [..., words_per_bucket]
    uint32 values held in int64."""
    wpb = layout.words_per_bucket
    offs = torch.arange(wpb, device=table.device)
    return from_i32(table[bucket[..., None] * wpb + offs])


def bucket_tags(table: torch.Tensor, bucket: torch.Tensor,
                layout: BucketLayout) -> torch.Tensor:
    """Gather and unpack a bucket -> [..., bucket_size] tags."""
    return unpack_words(gather_bucket_words(table, bucket, layout), layout.fp_bits)


def scan_start(tag: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """Pseudo-random slot scan start: ``tag mod bucketSize`` (paper Alg. 1 l.26)."""
    return tag % layout.bucket_size


def first_true_circular(flags: torch.Tensor, start: torch.Tensor):
    """First True position scanning circularly from ``start``.

    flags: bool[..., b]; start: int64[...] in [0, b).
    Returns (found: bool[...], slot: int64[...] absolute index).
    """
    b = flags.shape[-1]
    idx = (start[..., None] + torch.arange(b, device=flags.device)) % b
    rot = torch.gather(flags, -1, idx)
    found = rot.any(dim=-1)
    first_rel = rot.to(torch.uint8).argmax(dim=-1)
    return found, (start + first_rel) % b


# ---------------------------------------------------------------------------
# Segmented-scan helpers of the bulk-build insertion path. Unpacking the
# flat table gives the per-slot view in global slot order (slot s of bucket
# b at b * bucket_size + s). For a batch sorted by destination bucket, each
# key's rank in its bucket segment and the bucket's rank-th free slot give
# every key a distinct slot, so a whole-bucket commit is conflict-free.
# ---------------------------------------------------------------------------

def segment_ranks(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values.

    sorted_ids: int64[n] ascending (runs = segments). Returns int64[n] with
    0, 1, 2, ... restarting at every segment boundary.
    """
    n = sorted_ids.shape[0]
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    return torch.arange(n, device=sorted_ids.device) - first


def nth_free_slot(btags: torch.Tensor, rank: torch.Tensor):
    """Position of the ``rank``-th empty slot in each bucket.

    btags: [..., b] unpacked bucket tags; rank: int64[...] >= 0.
    Returns (placed: bool[...], slot: int64[...]). ``placed`` is False when
    the bucket has <= rank free slots (the key spills to the next phase).
    """
    free = btags == 0
    # Inclusive count of free slots along the slot axis. The scan runs over
    # a slot-major copy: torch's CUDA scan along an innermost axis of 4-32
    # elements takes ~100 ms for 2^24 buckets, over the outer axis ~1 ms.
    prefix = torch.cumsum(free.movedim(-1, 0).contiguous(), dim=0,
                          dtype=torch.int32).movedim(0, -1)
    hit = free & (prefix == rank[..., None] + 1)
    placed = prefix[..., -1] > rank
    return placed, hit.to(torch.uint8).argmax(dim=-1)


def slot_to_word(slot: torch.Tensor, layout: BucketLayout):
    """Absolute slot index in bucket -> (word index in bucket, slot within word)."""
    tpw = layout.tags_per_word
    return slot // tpw, slot % tpw


def word_addr(bucket: torch.Tensor, word_in_bucket: torch.Tensor,
              layout: BucketLayout) -> torch.Tensor:
    """Flat word address of (bucket, word) — the claim/CAS granule."""
    return bucket * layout.words_per_bucket + word_in_bucket
