// Direct cuckoo-filter insert, no eviction (paper Alg. 1 phase 1).
//
// Replaces the TPU kernel repro/kernels/cuckoo_insert.py:
// cuckoo_insert_fused_pallas (_insert_fused_kernel). The TPU applied keys
// one after another inside the kernel, race-free because grid steps run in
// order on one core. Hopper runs thousands of keys at once, so each key
// claims its slot with atomicCAS on the one 32-bit word it changes, as in
// the paper.
//
// Per key (one thread): hash -> tag, i1, i2; read both buckets; take the
// first free slot scanning bucket i1 circularly from scan_start, then
// bucket i2 from the same start (layout.py: first_true_circular); CAS the
// word. A failed CAS means another thread changed that word, so the thread
// re-reads both buckets and rescans: the loop is lock-free, and every
// retry follows someone else's success. Keys with both buckets full report
// ok = 0 and go to the caller's eviction path. i1 == i2 (XOR policy with
// fmix32(tag) & mask == 0) needs no special case: the second scan finds
// the same full bucket.
//
// Loads use __ldcg (at L2, the coherence point of the atomics), never
// __ldg or const __restrict__: another thread's CAS must be visible.
//
// Bound: device-memory bytes — two random 32-byte bucket reads and one
// 4-byte read-modify-write per key, plus key, valid and ok streams. Both
// bucket loads are issued before either is used, and a retry costs only
// the contended key.
#include "cuckoo_common.cuh"

namespace {

template <int W, int F>
__global__ void cuckoo_insert_kernel(uint32_t* table, const uint2* keys,
                                     const uint8_t* valid, uint8_t* ok,
                                     int64_t n, cuckoo::Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    ok[i] = 0;
    return;
  }
  const uint2 k = keys[i];
  const cuckoo::Probe p = cuckoo::prepare(k.x, k.y, g);
  constexpr int TPW = 32 / F;
  for (;;) {
    uint32_t w1[W], w2[W];
    cuckoo::load_bucket<W, false>(table, p.i1, w1);
    cuckoo::load_bucket<W, false>(table, p.i2, w2);
    int slot = cuckoo::first_circular<W, F>(cuckoo::free_slots<W, F>(w1), p.start);
    const bool in1 = slot >= 0;
    if (!in1) slot = cuckoo::first_circular<W, F>(cuckoo::free_slots<W, F>(w2), p.start);
    if (slot < 0) {
      ok[i] = 0;
      return;
    }
    const int widx = slot / TPW;
    const uint32_t old = in1 ? cuckoo::pick(w1, widx) : cuckoo::pick(w2, widx);
    const uint32_t desired =
        cuckoo::replace_lane<F>(old, slot % TPW, in1 ? p.tag1 : p.tag2);
    uint32_t* addr = table + size_t(in1 ? p.i1 : p.i2) * W + widx;
    if (atomicCAS(addr, old, desired) == old) {
      ok[i] = 1;
      return;
    }
  }
}

}  // namespace

// table: uint32[num_buckets * wpb], updated in place; keys: uint32[n, 2]
// (lo, hi); valid, ok: uint8[n]. Returns the cudaError_t of the launch.
CUCKOO_EXPORT int cuckoo_insert_launch(void* table, const void* keys,
                                       const void* valid, void* ok, int64_t n,
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
                  cuckoo_insert_kernel<W, F><<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<const uint8_t*>(valid),
                      static_cast<uint8_t*>(ok), n, g))
  return int(cudaGetLastError());
}
