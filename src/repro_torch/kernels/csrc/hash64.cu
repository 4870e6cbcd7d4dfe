// Batched key hash (paper §4.3 step 1).
//
// Replaces the TPU kernel repro/kernels/hash64.py: hash64_pallas
// (_hash_kernel), which computed xxHash64 on uint64 arithmetic emulated in
// 16-bit limbs. Here one thread hashes one key with native 64-bit
// multiplies. The kernel also computes the fmix32 pair-hash (the
// registry's default), so every hash_key of keys on the GPU runs here —
// the eviction loop's key preparation among them.
//
// Bound: device-memory bytes. Each key reads 8 bytes and writes 8; the
// hash is ~30 integer operations, far below the card's integer rate. The
// design reads the key as one 8-byte uint2 and writes both halves from
// neighbouring threads to neighbouring addresses, so every access is
// coalesced and nothing is read twice.
#include "cuckoo_common.cuh"

namespace {

__global__ void hash64_kernel(const uint2* __restrict__ keys,
                              uint32_t* __restrict__ out_hi,
                              uint32_t* __restrict__ out_lo, int64_t n,
                              cuckoo::Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2 k = keys[i];  // (lo, hi)
  uint32_t hi, lo;
  cuckoo::hash_key(k.x, k.y, g, hi, lo);
  out_hi[i] = hi;
  out_lo[i] = lo;
}

}  // namespace

// keys: uint32[n, 2] (lo, hi); out_hi/out_lo: uint32[n]; hash_kind: 0 =
// xxhash64, 1 = fmix32. Returns the cudaError_t of the launch.
CUCKOO_EXPORT int hash64_launch(const void* keys, void* out_hi, void* out_lo,
                                int64_t n, uint32_t hash_kind, uint64_t seed,
                                void* stream) {
  const cuckoo::Geometry g{0, 0, 0, 0, hash_kind, seed};
  const int64_t blocks = (n + cuckoo::THREADS - 1) / cuckoo::THREADS;
  hash64_kernel<<<dim3(unsigned(blocks)), cuckoo::THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(keys), static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo), n, g);
  return int(cudaGetLastError());
}
