// Blocked-Bloom batch insert (the paper's GBBF baseline).
//
// Replaces the TPU kernel repro/kernels/bloom.py: bloom_insert_pallas
// (_insert_kernel), which made its read-modify-writes race-free by running
// the grid in order on one core. Here one thread takes one valid key and
// sets its k bits (bloom_common.cuh) with atomicOr. OR commutes, so the
// table does not depend on the order the threads run in: it equals the
// plain version's bit for bit.
//
// Bound: device-memory bytes — each key's 64-byte block read and written
// once (the atomics' read-modify-write stays in L2), 8 key bytes and one
// valid byte in. The k atomics of a thread hit one block, so they stay in
// two 32-byte sectors of L2.
#include "bloom_common.cuh"

namespace {

__global__ void bloom_insert_kernel(uint32_t* __restrict__ table,
                                    const uint2* __restrict__ keys,
                                    const uint8_t* __restrict__ valid,
                                    int64_t n, bloom::Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const uint2 key = keys[i];  // (lo, hi)
  bloom::for_each_bit(key.x, key.y, g, [&](size_t addr, uint32_t mask) {
    atomicOr(table + addr, mask);
  });
}

}  // namespace

// table: uint32[num_blocks * words_per_block], updated in place; keys:
// uint32[n, 2] (lo, hi); valid: uint8[n]. Returns the cudaError_t of the
// launch.
CUCKOO_EXPORT int bloom_insert_launch(void* table, const void* keys,
                                      const void* valid, int64_t n,
                                      uint32_t num_blocks,
                                      uint32_t words_per_block, uint32_t k,
                                      uint32_t bits_needed,
                                      uint32_t hash_kind, uint64_t seed,
                                      void* stream) {
  const bloom::Geometry g{num_blocks, words_per_block, k, bits_needed,
                          hash_kind, seed};
  const int64_t blocks = (n + cuckoo::THREADS - 1) / cuckoo::THREADS;
  bloom_insert_kernel<<<dim3(unsigned(blocks)), cuckoo::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(table), static_cast<const uint2*>(keys),
      static_cast<const uint8_t*>(valid), n, g);
  return int(cudaGetLastError());
}
