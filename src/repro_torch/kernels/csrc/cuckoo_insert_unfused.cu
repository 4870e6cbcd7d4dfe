// Direct cuckoo-filter insert, unfused, no eviction (paper Alg. 1 phase 1).
//
// Replaces the TPU kernel repro/kernels/cuckoo_insert.py:
// cuckoo_insert_pallas (_insert_kernel): unpack bucket i1, then bucket i2,
// to fingerprint lanes; take the first free lane scanning circularly from
// scan_start(tag); replace_tag into that one word; ok. It computes what
// the fused kernel (cuckoo_insert.cu) computes. The TPU pair measures what
// SWAR zero masks on packed words buy over extracting every lane with a
// shift and a mask and testing it for zero (the roofline suite's insert
// rows), so this kernel is the fused kernel's Hopper design with the
// lane-by-lane scan in place of the SWAR one, and nothing else: both run
// cuckoo::insert and cuckoo::settle (cuckoo_common.cuh), this one
// instantiated with cuckoo::Lanes.
//
// The TPU kernel applied keys in order inside one core, race-free. Here a
// thread per key reads bucket i1 at L2 (__ldcg, where the atomics are
// coherent), and bucket i2 only when i1 shows no free lane, before its
// first CAS; one loop with one CAS site serves both buckets. A lost CAS
// puts the word it returns into the thread's register copy, which is
// rescanned: no bucket is read again, and every failure follows another
// thread's success. Keys with both buckets full report ok = 0; ``valid``
// masks keys out.
//
// Bound: the insert's (kernels/roofline.py: the fused and unfused kernels
// take one op's bound), device-memory bytes: each bucket the batch needs
// read once (every key's i1, its i2 where i1 is full) and each changed one
// written once, plus the key, valid and ok streams. What holds it on this
// card is what holds the fused kernel: a random 32-byte sector read and
// the write-back of the sector its CAS dirties, in a table ten times the
// L2. The scan's instructions can show only where the table sits in the
// L2.
#include "cuckoo_common.cuh"

namespace {

template <int W, int F>
__global__ void cuckoo_insert_unfused_kernel(uint32_t* table, const uint2* keys,
                                             const uint8_t* valid, uint8_t* ok,
                                             int64_t n, uint32_t block_keys,
                                             cuckoo::Geometry g) {
  int64_t first, end;
  cuckoo::block_tile(n, block_keys, first, end);
  for (int64_t i = first + threadIdx.x; i < end; i += cuckoo::THREADS) {
    if (!valid[i]) {
      ok[i] = 0;
      continue;
    }
    const uint2 k = keys[i];
    ok[i] = cuckoo::insert<W, F, cuckoo::Lanes>(
        table, cuckoo::prepare(k.x, k.y, g));
  }
}

}  // namespace

// table: uint32[num_buckets * wpb], updated in place; keys: uint32[n, 2]
// (lo, hi); valid, ok: uint8[n]; block_keys: keys a block
// (cuckoo::block_keys_ok). Returns the cudaError_t of the launch.
CUCKOO_EXPORT int cuckoo_insert_unfused_launch(
    void* table, const void* keys, const void* valid, void* ok, int64_t n,
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
                  cuckoo_insert_unfused_kernel<W, F>
                  <<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<const uint8_t*>(valid),
                      static_cast<uint8_t*>(ok), n, block_keys, g))
  return int(cudaGetLastError());
}
