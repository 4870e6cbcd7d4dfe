// Direct cuckoo-filter insert, unfused, no eviction (paper Alg. 1 phase 1).
//
// Replaces the TPU kernel repro/kernels/cuckoo_insert.py:
// cuckoo_insert_pallas (_insert_kernel): unpack bucket i1, then bucket i2,
// to fingerprint lanes; take the first free lane scanning circularly from
// scan_start(tag); replace_tag into that one word; ok. It computes what
// the fused kernel (cuckoo_insert.cu) computes; the pair measures the
// fused design (SWAR zero masks on packed words) against this one (every
// lane extracted with a shift and a mask and tested for zero), as the
// roofline suite's insert rows do on the TPU.
//
// The TPU kernel applied keys in order inside one core, race-free. Here a
// thread per key commits with atomicCAS on the one word it changes, as the
// fused kernel does: a failed CAS means another thread changed that word,
// so the thread re-reads both buckets (__ldcg, at L2, where the atomics
// are coherent) and rescans; every retry follows someone else's success.
// Keys with both buckets full report ok = 0; ``valid`` masks keys out.
//
// Bound: device-memory bytes, as the fused kernel's (the same function):
// two random bucket reads and one 4-byte read-modify-write per key, plus
// the key, valid and ok streams.
#include "cuckoo_common.cuh"

namespace {

// Bitmap over the bucket's slots of empty lanes, lane by lane.
template <int W, int F>
__device__ __forceinline__ uint32_t empty_lanes(const uint32_t (&w)[W]) {
  constexpr int TPW = 32 / F;
  constexpr uint32_t FMASK = uint32_t(0xFFFFFFFFull >> (32 - F));
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < TPW; ++j)
      bits |= uint32_t(((w[i] >> (j * F)) & FMASK) == 0) << (i * TPW + j);
  return bits;
}

template <int W, int F>
__global__ void cuckoo_insert_unfused_kernel(uint32_t* table, const uint2* keys,
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
    int slot = cuckoo::first_circular<W, F>(empty_lanes<W, F>(w1), p.start);
    const bool in1 = slot >= 0;
    if (!in1) {
      cuckoo::load_bucket<W, false>(table, p.i2, w2);
      slot = cuckoo::first_circular<W, F>(empty_lanes<W, F>(w2), p.start);
    }
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
CUCKOO_EXPORT int cuckoo_insert_unfused_launch(
    void* table, const void* keys, const void* valid, void* ok, int64_t n,
    uint32_t num_buckets, uint32_t bucket_size, uint32_t fp_bits,
    uint32_t policy, uint32_t hash_kind, uint64_t seed, void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  const dim3 grid(unsigned((n + cuckoo::THREADS - 1) / cuckoo::THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  cuckoo_insert_unfused_kernel<W, F>
                  <<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<const uint8_t*>(valid),
                      static_cast<uint8_t*>(ok), n, g))
  return int(cudaGetLastError());
}
