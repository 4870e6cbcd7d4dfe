// Batched cuckoo-filter query, unfused (paper Alg. 2).
//
// Replaces the TPU kernel repro/kernels/cuckoo_query.py: cuckoo_query_pallas
// (_query_kernel): hash -> tag, i1, i2 -> bucket i1's words unpacked to
// fingerprint lanes and compared lane by lane -> the same for bucket i2 ->
// hit. It computes what the fused kernel (cuckoo_query.cu) computes. The
// TPU pair measures what the SWAR match on packed words buys over
// extracting every lane with a shift and a mask (the roofline suite's
// query_kernel_{fused,prepr} rows), so this kernel is the fused kernel's
// Hopper design with the lane-by-lane scan in place of the SWAR one, and
// nothing else: both run cuckoo::query (cuckoo_common.cuh), this one
// instantiated with cuckoo::Lanes. One thread per key: hash, read bucket
// i1 with 16-byte read-only vector loads (__ldg: the table does not change
// during a query), compare its lanes one by one against t1, and only where
// no lane equals t1 read bucket i2 and compare its lanes against t2. XOR
// keys with i1 == i2 and OFFSET's t2, which carries the choice bit, need
// no code of their own (see cuckoo_query.cu).
//
// Bound: the query's (kernels/roofline.py: the fused and unfused kernels
// take one op's bound), device-memory bytes: the buckets the batch needs,
// each once (every key's i1, and its i2 where i1 holds no matching tag), 8
// key bytes in and 1 hit byte out. What holds it on this card is what
// holds the fused kernel: a random 32-byte sector a bucket from a table
// ten times the L2, read one after the other for a key that i1 does not
// settle. The scan's instructions can show only where the table sits in
// the L2.
#include "cuckoo_common.cuh"

namespace {

template <int W, int F>
__global__ void cuckoo_query_unfused_kernel(const uint32_t* __restrict__ table,
                                            const uint2* __restrict__ keys,
                                            uint8_t* __restrict__ hit,
                                            int64_t n, uint32_t block_keys,
                                            cuckoo::Geometry g) {
  int64_t first, end;
  cuckoo::block_tile(n, block_keys, first, end);
  for (int64_t i = first + threadIdx.x; i < end; i += cuckoo::THREADS) {
    const uint2 k = keys[i];
    hit[i] = cuckoo::query<W, F, cuckoo::Lanes>(table,
                                                cuckoo::prepare(k.x, k.y, g));
  }
}

}  // namespace

// table: uint32[num_buckets * wpb]; keys: uint32[n, 2] (lo, hi);
// hit: uint8[n]; block_keys: keys a block (cuckoo::block_keys_ok).
// Returns the cudaError_t of the launch.
CUCKOO_EXPORT int cuckoo_query_unfused_launch(
    const void* table, const void* keys, void* hit, int64_t n,
    uint32_t block_keys, uint32_t num_buckets, uint32_t bucket_size,
    uint32_t fp_bits, uint32_t policy, uint32_t hash_kind, uint64_t seed,
    void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  if (!cuckoo::block_keys_ok(block_keys)) return int(cudaErrorInvalidValue);
  const dim3 grid = cuckoo::tile_grid(n, block_keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  cuckoo_query_unfused_kernel<W, F>
                  <<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<const uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<uint8_t*>(hit), n, block_keys, g))
  return int(cudaGetLastError());
}
