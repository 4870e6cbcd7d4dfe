// Batched cuckoo-filter query (paper Alg. 2).
//
// Replaces the TPU kernel repro/kernels/cuckoo_query.py:
// cuckoo_query_fused_pallas (_query_fused_kernel): hash -> tag, i1, i2 ->
// both candidate buckets -> SWAR match -> hit. The TPU pinned the whole
// table in VMEM; on Hopper the table stays in device memory (a 512 MiB
// table is ten times the 50 MB L2).
//
// Bound: device-memory bytes, dominated by two random bucket reads per key
// (2 x 32 bytes at 16 x 16-bit), plus 8 key bytes in and 1 hit byte out.
// The design: one thread per key; both buckets are requested with 16-byte
// read-only vector loads (__ldg) before either is used, so each thread has
// two independent misses in flight; the SWAR match runs on the packed
// words in registers, with no unpacking.
#include "cuckoo_common.cuh"

namespace {

template <int W, int F>
__global__ void cuckoo_query_kernel(const uint32_t* __restrict__ table,
                                    const uint2* __restrict__ keys,
                                    uint8_t* __restrict__ hit, int64_t n,
                                    cuckoo::Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2 k = keys[i];
  const cuckoo::Probe p = cuckoo::prepare(k.x, k.y, g);
  uint32_t w1[W], w2[W];
  cuckoo::load_bucket<W, true>(table, p.i1, w1);
  cuckoo::load_bucket<W, true>(table, p.i2, w2);
  const uint32_t b1 = cuckoo::broadcast_tag<F>(p.t1);
  const uint32_t b2 = cuckoo::broadcast_tag<F>(p.t2);
  uint32_t any = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    any |= cuckoo::swar_zero_mask<F>(w1[w] ^ b1) |
           cuckoo::swar_zero_mask<F>(w2[w] ^ b2);
  hit[i] = any != 0;
}

}  // namespace

// table: uint32[num_buckets * wpb]; keys: uint32[n, 2] (lo, hi);
// hit: uint8[n]. Returns the cudaError_t of the launch.
CUCKOO_EXPORT int cuckoo_query_launch(const void* table, const void* keys,
                                      void* hit, int64_t n,
                                      uint32_t num_buckets,
                                      uint32_t bucket_size, uint32_t fp_bits,
                                      uint32_t policy, uint32_t hash_kind,
                                      uint64_t seed, void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  const dim3 grid(unsigned((n + cuckoo::THREADS - 1) / cuckoo::THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  cuckoo_query_kernel<W, F><<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<const uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<uint8_t*>(hit), n, g))
  return int(cudaGetLastError());
}
