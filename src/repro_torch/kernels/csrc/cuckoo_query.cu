// Batched cuckoo-filter query (paper Alg. 2).
//
// Replaces the TPU kernel repro/kernels/cuckoo_query.py:
// cuckoo_query_fused_pallas (_query_fused_kernel): hash -> tag, i1, i2 ->
// candidate buckets -> SWAR match -> hit. The TPU pinned the whole table
// in VMEM and gathered both buckets of every key in one go; on Hopper the
// table stays in device memory (a 512 MiB table is ten times the 50 MB
// L2), so each bucket read is a random 32-byte sector (16 x 16-bit).
//
// Bound: device-memory bytes, set by those random bucket reads: about
// 1.06 a key for the stored keys the main path queries (bucket i1 holds
// the tag of nearly every stored key), two a key for keys not stored; plus
// 8 key bytes in and 1 hit byte out.
//
// The design reads no bucket the answer does not need. One thread per key
// (more keys a thread lost on the direct insert's same random traffic):
// hash, read bucket i1 with 16-byte read-only vector loads (__ldg: the
// table does not change during a query), SWAR-match it against t1 on the
// packed words in registers, and only if no lane matches read bucket i2
// and match it against t2. A key that is not stored thus issues its two
// reads one after the other. No case needs its own code: under XOR a key
// with i1 == i2 reads its one bucket twice if it misses, and under OFFSET
// t2 carries the choice bit, so a tag stored in i1 never matches at i2.
// The body is cuckoo::query (cuckoo_common.cuh) with the SWAR scan; the
// unfused kernel (cuckoo_query_unfused.cu) runs the same body with the
// lane-by-lane scan.
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
  hit[i] = cuckoo::query<W, F, cuckoo::Swar>(table,
                                             cuckoo::prepare(k.x, k.y, g));
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
