// Batched cuckoo-filter query, unfused (paper Alg. 2).
//
// Replaces the TPU kernel repro/kernels/cuckoo_query.py: cuckoo_query_pallas
// (_query_kernel): hash -> tag, i1, i2 -> bucket i1's words, unpacked to
// fingerprint lanes and compared lane by lane -> the same for bucket i2 ->
// hit. It computes what the fused kernel (cuckoo_query.cu) computes; the
// pair measures the fused design (one gather of both buckets, SWAR match
// on packed words) against this one (a bucket at a time, every lane
// extracted with a shift and a mask), as the roofline suite's
// query_kernel_{fused,prepr} rows do on the TPU.
//
// Bound: device-memory bytes, as the fused kernel's (the same function):
// two random bucket reads per key, 8 key bytes in, 1 hit byte out. One
// thread per key; each bucket is read with 16-byte read-only vector loads
// (__ldg) and its lanes compared in registers.
#include "cuckoo_common.cuh"

namespace {

// True if any lane of bucket ``bucket`` holds ``tag``: each word's
// 32 / F lanes are extracted and compared one by one.
template <int W, int F>
__device__ __forceinline__ bool bucket_has(const uint32_t* __restrict__ table,
                                           uint32_t bucket, uint32_t tag) {
  constexpr int TPW = 32 / F;
  constexpr uint32_t FMASK = uint32_t(0xFFFFFFFFull >> (32 - F));
  uint32_t w[W];
  cuckoo::load_bucket<W, true>(table, bucket, w);
  bool hit = false;
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < TPW; ++j) hit |= ((w[i] >> (j * F)) & FMASK) == tag;
  return hit;
}

template <int W, int F>
__global__ void cuckoo_query_unfused_kernel(const uint32_t* __restrict__ table,
                                            const uint2* __restrict__ keys,
                                            uint8_t* __restrict__ hit,
                                            int64_t n, cuckoo::Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2 k = keys[i];
  const cuckoo::Probe p = cuckoo::prepare(k.x, k.y, g);
  const bool h1 = bucket_has<W, F>(table, p.i1, p.t1);
  const bool h2 = bucket_has<W, F>(table, p.i2, p.t2);
  hit[i] = h1 | h2;
}

}  // namespace

// table: uint32[num_buckets * wpb]; keys: uint32[n, 2] (lo, hi);
// hit: uint8[n]. Returns the cudaError_t of the launch.
CUCKOO_EXPORT int cuckoo_query_unfused_launch(
    const void* table, const void* keys, void* hit, int64_t n,
    uint32_t num_buckets, uint32_t bucket_size, uint32_t fp_bits,
    uint32_t policy, uint32_t hash_kind, uint64_t seed, void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  const dim3 grid(unsigned((n + cuckoo::THREADS - 1) / cuckoo::THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  cuckoo_query_unfused_kernel<W, F>
                  <<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<const uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<uint8_t*>(hit), n, g))
  return int(cudaGetLastError());
}
