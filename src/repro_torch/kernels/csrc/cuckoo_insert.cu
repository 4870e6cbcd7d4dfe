// Direct cuckoo-filter insert, no eviction (paper Alg. 1 phase 1).
//
// Replaces the TPU kernel repro/kernels/cuckoo_insert.py:
// cuckoo_insert_fused_pallas (_insert_fused_kernel). The TPU applied keys
// one after another inside the kernel, race-free because grid steps run in
// order on one core with the table in VMEM, so it read both candidate
// buckets of every key. Hopper runs thousands of keys at once against a
// table in device memory, so each key claims its slot with atomicCAS on
// the one 32-bit word it changes, as in the paper, and reads no bucket it
// does not need.
//
// Per key: hash -> tag, i1, i2. Read bucket i1 into registers and take its
// first free slot scanning circularly from scan_start (layout.py:
// first_true_circular), with one atomicCAS on that word. Only when i1 has
// no free slot is bucket i2 read, and scanned from the same start. Slots
// only fill during an insert, so a bucket a thread has seen full stays
// full for the rest of the launch: a key never goes back to i1. Keys with
// both buckets full report ok = 0 and go to the caller's eviction path.
// i1 == i2 (XOR policy with fmix32(tag) & mask == 0) needs no special case:
// the second scan finds the same full bucket.
//
// One loop with one CAS site serves both buckets, so a warp's CASes go out
// together whichever bucket each of its threads settles in; a thread whose
// i1 is full reads i2 before the warp's first CAS, not after it.
//
// A lost CAS returns the word as it now is. The thread puts it into its
// register copy of the bucket and rescans the copy; the bucket is never
// read again. A word the copy shows full is full, and a stale free slot
// elsewhere in the copy only makes a later CAS fail, which refreshes that
// word. Each lost CAS shows the thread at least one more filled lane, so a
// key fails at most bucket_size times a bucket, and every failure follows
// another thread's success: the loop is lock-free.
//
// Loads use __ldcg (at L2, the coherence point of the atomics), never
// __ldg or const __restrict__: another thread's CAS must be visible.
//
// Bound: device-memory bytes — per key one random 32-byte bucket read
// (a second only where the first is full) and one 4-byte read-modify-write,
// plus the key, valid and ok streams (kernels/roofline.py charges each
// touched bucket once). What holds it on the card: the random sector reads
// and the write-back of the sectors the CASes dirty, each a 32-byte access
// at a random place in a table ten times the L2. More loads in flight do
// not help: a thread that owned two or four keys and issued all their
// loads together ran slower on the H100 (PERF.md, section 6), so a thread
// settles one key at a time: one by default, and with a tile of block_keys
// > 256 keys a block (kernels/autotune.py) its keys one after another.
//
// The body is cuckoo::insert and cuckoo::settle (cuckoo_common.cuh) with
// the SWAR scan; the unfused kernel (cuckoo_insert_unfused.cu) runs the
// same body with the lane-by-lane scan.
#include "cuckoo_common.cuh"

namespace {

template <int W, int F>
__global__ void cuckoo_insert_kernel(uint32_t* table, const uint2* keys,
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
    ok[i] = cuckoo::insert<W, F, cuckoo::Swar>(
        table, cuckoo::prepare(k.x, k.y, g));
  }
}

}  // namespace

// table: uint32[num_buckets * wpb], updated in place; keys: uint32[n, 2]
// (lo, hi); valid, ok: uint8[n]; block_keys: keys a block
// (cuckoo::block_keys_ok). Returns the cudaError_t of the launch.
CUCKOO_EXPORT int cuckoo_insert_launch(void* table, const void* keys,
                                       const void* valid, void* ok, int64_t n,
                                       uint32_t block_keys,
                                       uint32_t num_buckets,
                                       uint32_t bucket_size, uint32_t fp_bits,
                                       uint32_t policy, uint32_t hash_kind,
                                       uint64_t seed, void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  if (!cuckoo::block_keys_ok(block_keys)) return int(cudaErrorInvalidValue);
  const dim3 grid = cuckoo::tile_grid(n, block_keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  cuckoo_insert_kernel<W, F><<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<const uint8_t*>(valid),
                      static_cast<uint8_t*>(ok), n, block_keys, g))
  return int(cudaGetLastError());
}
