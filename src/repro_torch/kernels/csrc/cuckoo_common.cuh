// Shared device code of the cuckoo-filter kernels for Hopper (sm_90a).
//
// Everything here computes exactly what the JAX package computes
// (repro/core/hashing.py, policies.py, layout.py), on native uint32/uint64:
// the xxHash64 and fmix32-pair key hashes, the XOR and OFFSET placement
// policies, and the SWAR zero/match masks over packed fingerprint words.
//
// Table layout: a flat uint32 array, bucket-major; bucket b is the words
// [b * WPB, (b + 1) * WPB). A word holds 32 / F fingerprints of F bits.
// Keys arrive as (lo, hi) uint32 pairs, read as one uint2.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cuckoo {

constexpr uint64_t PRIME64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t PRIME64_2 = 0xC2B2AE3D4F118CB1ULL;
constexpr uint64_t PRIME64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t PRIME64_4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t PRIME64_5 = 0x27D4EB2F165667C5ULL;

constexpr int OP_QUERY = 0;
constexpr int OP_INSERT = 1;
constexpr int OP_DELETE = 2;

constexpr int THREADS = 256;

// Runtime geometry of one filter (CuckooConfig's fields the kernels read).
struct Geometry {
  uint32_t num_buckets;
  uint32_t bucket_size;
  uint32_t fp_bits;
  uint32_t policy;     // 0 = xor, 1 = offset
  uint32_t hash_kind;  // 0 = xxhash64, 1 = fmix32
  uint64_t seed;
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

// xxHash64 of one 8-byte key (repro/core/hashing.py: xxhash64_u64).
__device__ __forceinline__ uint64_t xxhash64(uint64_t key, uint64_t seed) {
  uint64_t h = seed + PRIME64_5 + 8;
  uint64_t k1 = rotl64(key * PRIME64_2, 31) * PRIME64_1;
  h ^= k1;
  h = rotl64(h, 27) * PRIME64_1 + PRIME64_4;
  h ^= h >> 33;
  h *= PRIME64_2;
  h ^= h >> 29;
  h *= PRIME64_3;
  h ^= h >> 32;
  return h;
}

// murmur3 32-bit finalizer (hashing.py: fmix32).
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Key (lo, hi) -> digest (hhi, hlo) (hashing.py: hash_key).
__device__ __forceinline__ void hash_key(uint32_t lo, uint32_t hi,
                                         const Geometry& g, uint32_t& hhi,
                                         uint32_t& hlo) {
  if (g.hash_kind == 0) {
    const uint64_t h = xxhash64((uint64_t(hi) << 32) | lo, g.seed);
    hhi = uint32_t(h >> 32);
    hlo = uint32_t(h);
  } else {
    // fmix32_pair; the seed's low word is XORed into the key's hi half and
    // its high word into lo, as the JAX package does.
    const uint32_t khi = hi ^ uint32_t(g.seed);
    const uint32_t klo = lo ^ uint32_t(g.seed >> 32);
    const uint32_t a = fmix32(klo ^ fmix32(khi ^ 0x9E3779B9u));
    const uint32_t b = fmix32(khi ^ fmix32(klo + 0x85EBCA6Bu) ^ a);
    hhi = b;
    hlo = a;
  }
}

// Everything a key needs to probe the table (cuckoo_filter.py:
// prepare_keys, place_tag, query_match_tags, scan_start).
struct Probe {
  uint32_t i1, i2;      // candidate buckets
  uint32_t tag1, tag2;  // stored form of the tag in i1 / i2
  uint32_t t1, t2;      // tag to match in i1 / i2
  uint32_t start;       // circular scan start, tag mod bucket_size
};

// A key's tag and primary bucket, the part of a probe that needs the hash.
__device__ __forceinline__ void primary(uint32_t lo, uint32_t hi,
                                        const Geometry& g, uint32_t& tag,
                                        uint32_t& i1) {
  uint32_t hhi, hlo;
  hash_key(lo, hi, g, hhi, hlo);
  if (g.policy == 0) {  // XorPolicy
    const uint32_t fmask =
        g.fp_bits == 32 ? 0xFFFFFFFFu : (1u << g.fp_bits) - 1u;
    const uint32_t fp = hhi & fmask;
    tag = fp ? fp : 1u;
    i1 = hlo & (g.num_buckets - 1u);
  } else {  // OffsetPolicy: the tag leaves its top bit to the choice
    const uint32_t fp = hhi & ((1u << (g.fp_bits - 1)) - 1u);
    tag = fp ? fp : 1u;
    i1 = hlo % g.num_buckets;
  }
}

// The whole probe from a tag and its primary bucket.
__device__ __forceinline__ Probe probe_of(uint32_t i1, uint32_t tag,
                                          const Geometry& g) {
  Probe p;
  p.i1 = i1;
  if (g.policy == 0) {  // XorPolicy
    const uint32_t bmask = g.num_buckets - 1u;
    p.i2 = i1 ^ (fmix32(tag) & bmask);
    p.tag1 = p.tag2 = p.t1 = p.t2 = tag;
  } else {  // OffsetPolicy: choice bit in the tag's top bit
    const uint32_t choice = 1u << (g.fp_bits - 1);
    const uint32_t off = fmix32(tag ^ 0x27D4EB2Fu) % (g.num_buckets - 1u) + 1u;
    p.i2 = (i1 + off) % g.num_buckets;
    p.tag1 = p.t1 = tag;
    p.tag2 = p.t2 = tag | choice;
  }
  p.start = tag % g.bucket_size;
  return p;
}

__device__ __forceinline__ Probe prepare(uint32_t lo, uint32_t hi,
                                         const Geometry& g) {
  uint32_t tag, i1;
  primary(lo, hi, g, tag, i1);
  return probe_of(i1, tag, g);
}

// ---------------------------------------------------------------------------
// SWAR masks (layout.py: swar_zero_mask, broadcast_tag, swar_match_mask).
// ---------------------------------------------------------------------------

template <int F>
__device__ __forceinline__ uint32_t swar_zero_mask(uint32_t w) {
  constexpr uint32_t LOW = F == 8 ? 0x7F7F7F7Fu : F == 16 ? 0x7FFF7FFFu : 0x7FFFFFFFu;
  constexpr uint32_t HIGH = F == 8 ? 0x80808080u : F == 16 ? 0x80008000u : 0x80000000u;
  return ~(((w & LOW) + LOW) | w) & HIGH;
}

template <int F>
__device__ __forceinline__ uint32_t broadcast_tag(uint32_t tag) {
  uint32_t w = tag;
  if (F <= 16) w |= w << 16;
  if (F <= 8) w |= (w & 0x00FF00FFu) << 8;
  return w;
}

// The high bit of each lane of a SWAR mask -> one bit per slot of the word.
template <int F>
__device__ __forceinline__ uint32_t lane_bits(uint32_t mask) {
  constexpr int TPW = 32 / F;
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < TPW; ++j) out |= ((mask >> (j * F + F - 1)) & 1u) << j;
  return out;
}

// Bitmap over the bucket's slots (bit s = slot s) of free lanes.
template <int W, int F>
__device__ __forceinline__ uint32_t free_slots(const uint32_t (&w)[W]) {
  constexpr int TPW = 32 / F;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) bits |= lane_bits<F>(swar_zero_mask<F>(w[i])) << (i * TPW);
  return bits;
}

// Bitmap over the bucket's slots of lanes equal to ``tag``.
template <int W, int F>
__device__ __forceinline__ uint32_t match_slots(const uint32_t (&w)[W], uint32_t tag) {
  constexpr int TPW = 32 / F;
  const uint32_t bt = broadcast_tag<F>(tag);
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) bits |= lane_bits<F>(swar_zero_mask<F>(w[i] ^ bt)) << (i * TPW);
  return bits;
}

// First set slot scanning circularly from ``start`` over B = W * 32 / F
// slots (layout.py: first_true_circular); -1 if none.
template <int W, int F>
__device__ __forceinline__ int first_circular(uint32_t bits, uint32_t start) {
  constexpr int B = W * (32 / F);
  const uint64_t all = (1ull << B) - 1ull;
  const uint64_t v = bits;
  const uint64_t rot = ((v >> start) | (v << (B - start))) & all;
  if (rot == 0) return -1;
  return int((start + uint32_t(__ffsll((long long)rot) - 1)) % B);
}

// Word ``idx`` of a bucket held in registers (an unrolled select, so the
// array stays in registers instead of local memory).
template <int W>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[W], int idx) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) out = i == idx ? w[i] : out;
  return out;
}

// Word ``idx`` of a bucket held in registers set to ``value`` (an unrolled
// select, so the array stays in registers).
template <int W>
__device__ __forceinline__ void put(uint32_t (&w)[W], int idx, uint32_t value) {
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = i == idx ? value : w[i];
}

// Write tag into lane ``lane`` of word (layout.py: replace_tag).
template <int F>
__device__ __forceinline__ uint32_t replace_lane(uint32_t word, int lane, uint32_t tag) {
  const uint32_t fmask = uint32_t(0xFFFFFFFFull >> (32 - F));
  const uint32_t shift = uint32_t(lane) * F;
  const uint32_t lane_mask = fmask << shift;
  return (word & ~lane_mask) | ((tag << shift) & lane_mask);
}

// ---------------------------------------------------------------------------
// Bucket loads. A bucket of W words is read with 16-byte vector loads where
// W is a multiple of 4 (32 bytes = two uint4 at 16x16-bit).
//   READ_ONLY: the table does not change during the kernel -> __ldg.
//   otherwise: other threads' CAS writes must be seen -> __ldcg reads at L2,
//   the coherence point of the atomics, never a stale L1 line.
// ---------------------------------------------------------------------------

template <int W, bool READ_ONLY>
__device__ __forceinline__ void load_bucket(const uint32_t* table, uint32_t bucket,
                                            uint32_t (&w)[W]) {
  const uint32_t* base = table + size_t(bucket) * W;
  if constexpr (W % 4 == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(base);
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      const uint4 q = READ_ONLY ? __ldg(p + v) : __ldcg(p + v);
      w[4 * v + 0] = q.x;
      w[4 * v + 1] = q.y;
      w[4 * v + 2] = q.z;
      w[4 * v + 3] = q.w;
    }
  } else if constexpr (W == 2) {
    const uint2 q = READ_ONLY ? __ldg(reinterpret_cast<const uint2*>(base))
                              : __ldcg(reinterpret_cast<const uint2*>(base));
    w[0] = q.x;
    w[1] = q.y;
  } else {
    static_assert(W == 1, "words per bucket must be 1, 2 or a multiple of 4");
    w[0] = READ_ONLY ? __ldg(base) : __ldcg(base);
  }
}

// ---------------------------------------------------------------------------
// Bucket scans. Each fused kernel and its unfused sibling share one body
// (query and insert below) and differ only in the scan they instantiate it
// with, as the TPU's pair differs:
//   Swar:  SWAR zero and match masks on the packed words (layout.py), the
//          fused kernels' scan (cuckoo_query.cu, cuckoo_insert.cu, and the
//          insert pass of cuckoo_insert_bulk.cu);
//   Lanes: every lane extracted with a shift and a mask and compared on
//          its own, the unfused kernels' scan (cuckoo_query_unfused.cu,
//          cuckoo_insert_unfused.cu), as the TPU's cuckoo_query_pallas and
//          cuckoo_insert_pallas unpack their buckets.
// free_lanes: bitmap over the bucket's slots (bit s = slot s) of empty
//             lanes; has_tag: whether any lane equals ``tag``.
// ---------------------------------------------------------------------------

struct Swar {
  template <int W, int F>
  static __device__ __forceinline__ uint32_t free_lanes(
      const uint32_t (&w)[W]) {
    return free_slots<W, F>(w);
  }
  template <int W, int F>
  static __device__ __forceinline__ bool has_tag(const uint32_t (&w)[W],
                                                 uint32_t tag) {
    const uint32_t b = broadcast_tag<F>(tag);
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) any |= swar_zero_mask<F>(w[k] ^ b);
    return any != 0;
  }
};

struct Lanes {
  template <int W, int F>
  static __device__ __forceinline__ uint32_t free_lanes(
      const uint32_t (&w)[W]) {
    constexpr int TPW = 32 / F;
    constexpr uint32_t FMASK = uint32_t(0xFFFFFFFFull >> (32 - F));
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < TPW; ++j)
        bits |= uint32_t(((w[i] >> (j * F)) & FMASK) == 0) << (i * TPW + j);
    return bits;
  }
  template <int W, int F>
  static __device__ __forceinline__ bool has_tag(const uint32_t (&w)[W],
                                                 uint32_t tag) {
    constexpr int TPW = 32 / F;
    constexpr uint32_t FMASK = uint32_t(0xFFFFFFFFull >> (32 - F));
    bool hit = false;
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < TPW; ++j) hit |= ((w[i] >> (j * F)) & FMASK) == tag;
    return hit;
  }
};

// ---------------------------------------------------------------------------
// Query of one key (cuckoo_query.cu, cuckoo_query_unfused.cu): bucket i1
// read with read-only vector loads (the table does not change during a
// query) and scanned for t1; bucket i2 read and scanned for t2 only where
// no lane of i1 equals t1. No case needs its own code: under XOR a key
// with i1 == i2 reads its one bucket twice if it misses, and under OFFSET
// t2 carries the choice bit, so a tag stored in i1 never matches at i2.
// ---------------------------------------------------------------------------

template <int W, int F, class Scan>
__device__ __forceinline__ bool query(const uint32_t* table, const Probe& p) {
  uint32_t w[W];
  load_bucket<W, true>(table, p.i1, w);
  bool found = Scan::template has_tag<W, F>(w, p.t1);
  if (!found) {
    load_bucket<W, true>(table, p.i2, w);
    found = Scan::template has_tag<W, F>(w, p.t2);
  }
  return found;
}

// ---------------------------------------------------------------------------
// Direct insert of one key, no eviction (cuckoo_insert.cu,
// cuckoo_insert_unfused.cu, and the insert pass of cuckoo_insert_bulk.cu):
// the first free slot of bucket i1 (words in ``w1``), else of bucket i2
// (words in ``w2`` once ``have2``; read here if i1 fills up while the key
// tries it), each scanned circularly from the key's start. One loop and
// one CAS site serve both buckets, so a warp's CASes go out together
// whichever bucket each thread settles in. A lost CAS puts the word it
// returns into the copy and rescans the copy: no bucket is read again.
// False once both copies show no free slot.
// ---------------------------------------------------------------------------

template <int W, int F, class Scan>
__device__ __forceinline__ bool settle(uint32_t* table, const Probe& p,
                                       uint32_t (&w1)[W], uint32_t (&w2)[W],
                                       bool have2) {
  constexpr int TPW = 32 / F;
  for (;;) {
    int slot =
        first_circular<W, F>(Scan::template free_lanes<W, F>(w1), p.start);
    const bool in1 = slot >= 0;
    if (!in1) {
      if (!have2) {
        load_bucket<W, false>(table, p.i2, w2);
        have2 = true;
      }
      slot =
          first_circular<W, F>(Scan::template free_lanes<W, F>(w2), p.start);
    }
    if (slot < 0) return false;
    const int widx = slot / TPW;
    const uint32_t old = in1 ? pick(w1, widx) : pick(w2, widx);
    const uint32_t desired =
        replace_lane<F>(old, slot % TPW, in1 ? p.tag1 : p.tag2);
    const uint32_t seen =
        atomicCAS(table + size_t(in1 ? p.i1 : p.i2) * W + widx, old, desired);
    if (seen == old) return true;
    if (in1) {
      put(w1, widx, seen);
    } else {
      put(w2, widx, seen);
    }
  }
}

// Bucket i1 read at L2 (other threads' CASes must be seen), bucket i2 only
// if i1 shows no free slot, issued before the first CAS; then settle.
template <int W, int F, class Scan>
__device__ __forceinline__ bool insert(uint32_t* table, const Probe& p) {
  uint32_t w1[W], w2[W];
  load_bucket<W, false>(table, p.i1, w1);
  const bool have2 = Scan::template free_lanes<W, F>(w1) == 0;
  if (have2) load_bucket<W, false>(table, p.i2, w2);
  return settle<W, F, Scan>(table, p, w1, w2, have2);
}

}  // namespace cuckoo

// Runs the statements given after the two sizes with constexpr W (words
// per bucket) and F (fingerprint bits) bound, for every layout with at
// most 32 slots per bucket; returns cudaErrorInvalidValue for any other.
#define CUCKOO_DISPATCH(WPB, FPB, ...)                                     \
  switch ((FPB) * 100 + (WPB)) {                                           \
    case 801: { constexpr int W = 1, F = 8; __VA_ARGS__; } break;          \
    case 802: { constexpr int W = 2, F = 8; __VA_ARGS__; } break;          \
    case 804: { constexpr int W = 4, F = 8; __VA_ARGS__; } break;          \
    case 808: { constexpr int W = 8, F = 8; __VA_ARGS__; } break;          \
    case 1601: { constexpr int W = 1, F = 16; __VA_ARGS__; } break;        \
    case 1602: { constexpr int W = 2, F = 16; __VA_ARGS__; } break;        \
    case 1604: { constexpr int W = 4, F = 16; __VA_ARGS__; } break;        \
    case 1608: { constexpr int W = 8, F = 16; __VA_ARGS__; } break;        \
    case 1616: { constexpr int W = 16, F = 16; __VA_ARGS__; } break;       \
    case 3201: { constexpr int W = 1, F = 32; __VA_ARGS__; } break;        \
    case 3202: { constexpr int W = 2, F = 32; __VA_ARGS__; } break;        \
    case 3204: { constexpr int W = 4, F = 32; __VA_ARGS__; } break;        \
    case 3208: { constexpr int W = 8, F = 32; __VA_ARGS__; } break;        \
    case 3216: { constexpr int W = 16, F = 32; __VA_ARGS__; } break;       \
    case 3232: { constexpr int W = 32, F = 32; __VA_ARGS__; } break;       \
    default: return int(cudaErrorInvalidValue);                            \
  }

#define CUCKOO_EXPORT extern "C" __attribute__((visibility("default")))
