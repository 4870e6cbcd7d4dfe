// Shared device code of the blocked-Bloom kernels for Hopper (sm_90a).
//
// The k bit positions of a key, exactly as repro/filters/blocked_bloom.py:
// _bit_positions derives them: the key's hash (cuckoo_common.cuh, the
// xxHash64 or fmix32-pair digest) gives the block from its lower word,
// and the in-block bits are peeled from its upper word in BITS-bit chunks
// (BITS = bit_length(block_bits - 1)), re-mixed with fmix32(h + j) when a
// word is used up.
#pragma once

#include <atomic>

#include "cuckoo_common.cuh"

namespace bloom {

struct Geometry {
  uint32_t num_blocks;
  uint32_t words_per_block;
  uint32_t k;
  uint32_t bits_needed;  // bit_length(words_per_block * 32 - 1)
  uint32_t hash_kind;    // 0 = xxhash64, 1 = fmix32
  uint64_t seed;
};

// A key's hash as the positions need it: its block and the upper hash
// word the in-block bits are peeled from.
struct Hashed {
  uint32_t block;
  uint32_t h;
};

__device__ __forceinline__ Hashed hash_block(uint32_t lo, uint32_t hi,
                                             const Geometry& g) {
  const cuckoo::Geometry hg{0, 0, 0, 0, g.hash_kind, g.seed};
  uint32_t h, hlo;
  cuckoo::hash_key(lo, hi, hg, h, hlo);
  return {hlo % g.num_blocks, h};
}

// A key's block and its k positions in the block, one position a call of
// next(). The chunk counter and shift are carried from call to call, so no
// position costs a division (a power-of-two block, the rule, takes its
// positions modulo by a mask).
struct BitWalk {
  uint32_t block;  // the key's block index
  uint32_t h, j = 0, r = 0, shift = 0;
  uint32_t per_word, bits, block_bits;
  bool pow2;

  __device__ __forceinline__ BitWalk(Hashed k, const Geometry& g)
      : block(k.block), h(k.h), bits(g.bits_needed),
        block_bits(g.words_per_block * 32u) {
    per_word = 32u / g.bits_needed;
    if (per_word == 0) per_word = 1;
    pow2 = (block_bits & (block_bits - 1u)) == 0;
  }

  __device__ __forceinline__ BitWalk(uint32_t lo, uint32_t hi,
                                     const Geometry& g)
      : BitWalk(hash_block(lo, hi, g), g) {}

  // The next bit's position in the block, [0, block_bits).
  __device__ __forceinline__ uint32_t next() {
    if (r == per_word) {
      r = 0;
      shift = 0;
      h = cuckoo::fmix32(h + j);
    }
    const uint32_t x = h >> shift;
    ++r;
    ++j;
    shift += bits;
    return pow2 ? x & (block_bits - 1u) : x % block_bits;
  }
};

// Calls visit(word address, bit mask) for each of the k bits of a walk.
template <typename Visit>
__device__ __forceinline__ void for_each_bit(BitWalk w, const Geometry& g,
                                             Visit visit) {
  const size_t base = size_t(w.block) * g.words_per_block;
  for (uint32_t j = 0; j < g.k; ++j) {
    const uint32_t pos = w.next();
    visit(base + (pos >> 5), 1u << (pos & 31u));
  }
}

// The L2's size in bytes of the current device, asked once a device (0 in
// `cached`: not yet). Returns the cudaError_t of the lookup.
inline int l2_bytes(int* out) {
  static std::atomic<int> cached[64];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  int bytes = dev < 64 ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (bytes == 0) {
    const cudaError_t a =
        cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev);
    if (a != cudaSuccess) return int(a);
    if (dev < 64) cached[dev].store(bytes, std::memory_order_relaxed);
  }
  *out = bytes;
  return 0;
}

}  // namespace bloom
