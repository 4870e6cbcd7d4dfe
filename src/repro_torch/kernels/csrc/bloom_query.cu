// Blocked-Bloom batch query (the paper's GBBF baseline).
//
// Replaces the TPU kernel repro/kernels/bloom.py: bloom_query_pallas
// (_query_kernel), which pinned the whole table in VMEM and gathered each
// key's k words. Here the table stays in device memory and one thread
// tests one key: hash, the k (word, bit) pairs of its block
// (bloom_common.cuh), k independent read-only loads, hit = all bits set.
//
// Bound: device-memory bytes — each key's 64-byte block (16 words) read
// once, 8 key bytes in and 1 hit byte out. The k loads of a thread fall in
// one block, i.e. in at most two 32-byte sectors, so after the first miss
// the rest hit L1; nothing else is read.
#include "bloom_common.cuh"

namespace {

__global__ void bloom_query_kernel(const uint32_t* __restrict__ table,
                                   const uint2* __restrict__ keys,
                                   uint8_t* __restrict__ hit, int64_t n,
                                   bloom::Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2 key = keys[i];  // (lo, hi)
  // No early exit: the k loads do not depend on each other, so they are
  // all in flight at once.
  uint32_t missing = 0;
  bloom::for_each_bit(key.x, key.y, g, [&](size_t addr, uint32_t mask) {
    missing |= ~__ldg(table + addr) & mask;
  });
  hit[i] = missing == 0;
}

}  // namespace

// table: uint32[num_blocks * words_per_block]; keys: uint32[n, 2] (lo,
// hi); hit: uint8[n]. Returns the cudaError_t of the launch.
CUCKOO_EXPORT int bloom_query_launch(const void* table, const void* keys,
                                     void* hit, int64_t n,
                                     uint32_t num_blocks,
                                     uint32_t words_per_block, uint32_t k,
                                     uint32_t bits_needed, uint32_t hash_kind,
                                     uint64_t seed, void* stream) {
  const bloom::Geometry g{num_blocks, words_per_block, k, bits_needed,
                          hash_kind, seed};
  const int64_t blocks = (n + cuckoo::THREADS - 1) / cuckoo::THREADS;
  bloom_query_kernel<<<dim3(unsigned(blocks)), cuckoo::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint2*>(keys),
      static_cast<uint8_t*>(hit), n, g);
  return int(cudaGetLastError());
}
