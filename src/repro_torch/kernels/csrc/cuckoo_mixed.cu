// Mixed QUERY / INSERT / DELETE op stream (DESIGN.md §9); a delete-only
// stream is the filter's delete (paper Alg. 3).
//
// Replaces the TPU kernel repro/kernels/cuckoo_mixed.py:
// cuckoo_mixed_pallas (_mixed_kernel). The TPU ran the whole stream in
// batch order on one core, so operation i saw every write of operations
// j < i, across keys too. A grid of blocks on Hopper cannot reproduce that
// cross-key order, so this kernel gives the normative semantics of
// DESIGN.md §9 instead: operations on the same 64-bit key resolve in batch
// order. The wrapper stable-sorts the ops by key value (plumbing outside
// the kernel, as the JAX wrapper argsorts outside its kernel); one thread
// walks one key's segment in batch order:
//
//   QUERY  — SWAR match over both buckets; ok = any lane matches.
//   INSERT — first free slot, bucket i1 then i2, from scan_start; CAS.
//   DELETE — first matching slot, i1 then i2, from scan_start; CAS to 0.
//
// A failed CAS re-reads both buckets and rescans (lock-free: each failure
// follows another thread's success). ok is written straight to the op's
// batch position. Cross-key fingerprint aliasing within one batch (two
// different keys with the same tag and buckets) is observed in an
// unspecified order.
//
// Loads use __ldcg (at L2, the coherence point of the atomics), never
// __ldg or const __restrict__ on the table.
//
// Bound: device-memory bytes — two random 32-byte bucket reads per op, one
// 4-byte read-modify-write per insert or delete, plus the key, op, order
// and ok streams. Each segment hashes its key once.
#include "cuckoo_common.cuh"

namespace {

template <int W, int F>
__global__ void cuckoo_mixed_kernel(uint32_t* table, const uint2* keys,
                                    const int32_t* ops, const uint8_t* valid,
                                    const int64_t* order,
                                    const int64_t* seg_start,
                                    int64_t num_segments, int64_t n,
                                    uint8_t* ok, cuckoo::Geometry g) {
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_segments) return;
  const int64_t begin = seg_start[s];
  const int64_t end = s + 1 < num_segments ? seg_start[s + 1] : n;
  const uint2 k = keys[order[begin]];
  const cuckoo::Probe p = cuckoo::prepare(k.x, k.y, g);
  constexpr int TPW = 32 / F;
  for (int64_t j = begin; j < end; ++j) {
    const int64_t i = order[j];
    uint8_t res = 0;
    const int op = ops[i];
    while (valid[i]) {
      uint32_t w1[W], w2[W];
      cuckoo::load_bucket<W, false>(table, p.i1, w1);
      cuckoo::load_bucket<W, false>(table, p.i2, w2);
      const bool ins = op == cuckoo::OP_INSERT;
      const uint32_t bits1 = ins ? cuckoo::free_slots<W, F>(w1)
                                 : cuckoo::match_slots<W, F>(w1, p.t1);
      int slot = cuckoo::first_circular<W, F>(bits1, p.start);
      const bool in1 = slot >= 0;
      if (!in1) {
        const uint32_t bits2 = ins ? cuckoo::free_slots<W, F>(w2)
                                   : cuckoo::match_slots<W, F>(w2, p.t2);
        slot = cuckoo::first_circular<W, F>(bits2, p.start);
      }
      if (slot < 0) break;  // no free slot / no stored copy: ok = 0
      if (!ins && op != cuckoo::OP_DELETE) {
        res = 1;  // query hit
        break;
      }
      const int widx = slot / TPW;
      const uint32_t old = in1 ? cuckoo::pick(w1, widx) : cuckoo::pick(w2, widx);
      const uint32_t store = ins ? (in1 ? p.tag1 : p.tag2) : 0u;
      const uint32_t desired = cuckoo::replace_lane<F>(old, slot % TPW, store);
      uint32_t* addr = table + size_t(in1 ? p.i1 : p.i2) * W + widx;
      if (atomicCAS(addr, old, desired) == old) {
        res = 1;
        break;
      }
    }
    ok[i] = res;
  }
}

}  // namespace

// table: uint32[num_buckets * wpb], updated in place; keys: uint32[n, 2];
// ops: int32[n]; valid, ok: uint8[n]; order: int64[n], the ops' batch
// positions sorted stably by key value; seg_start: int64[num_segments],
// the first sorted position of each key's run. Returns the cudaError_t of
// the launch.
CUCKOO_EXPORT int cuckoo_mixed_launch(void* table, const void* keys,
                                      const void* ops, const void* valid,
                                      const void* order, const void* seg_start,
                                      int64_t num_segments, int64_t n, void* ok,
                                      uint32_t num_buckets,
                                      uint32_t bucket_size, uint32_t fp_bits,
                                      uint32_t policy, uint32_t hash_kind,
                                      uint64_t seed, void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  const dim3 grid(
      unsigned((num_segments + cuckoo::THREADS - 1) / cuckoo::THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  cuckoo_mixed_kernel<W, F><<<grid, cuckoo::THREADS, 0, s>>>(
                      static_cast<uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<const int32_t*>(ops),
                      static_cast<const uint8_t*>(valid),
                      static_cast<const int64_t*>(order),
                      static_cast<const int64_t*>(seg_start), num_segments, n,
                      static_cast<uint8_t*>(ok), g))
  return int(cudaGetLastError());
}
