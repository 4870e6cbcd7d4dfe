// Bucket-major direct insert, no eviction: the bulk-build kernel.
//
// Replaces the TPU kernel repro/kernels/cuckoo_insert.py:
// cuckoo_insert_bulk_pallas (_bulk_insert_kernel). Keys arrive sorted by
// primary bucket i1; each takes the first free slot of i1 scanning
// circularly from scan_start, else of i2 (layout.py: first_true_circular),
// exactly the sequential cuckoo_insert_ref on the sorted stream. The TPU
// kernel walked the stream in order on one core and kept the current
// primary bucket's words in registers across the run of keys that share
// it, loading and flushing the bucket once per segment.
//
// On Hopper one thread walks one primary-bucket segment in order
// (the wrapper sorts stably by i1 and gives the segment starts), so keys
// of one segment never contend with each other. The thread loads its
// primary bucket once and keeps the words in registers, updating them
// after each of its own writes. Other segments may place overflow keys
// into this bucket as their secondary at the same time, so every write,
// primary included, is one atomicCAS on the word it changes. Slots only
// fill during an insert, so a cached word can be stale only by missing
// tags: a bucket the cache shows full is full, and a stale free slot makes
// the CAS fail. On a failed CAS the thread re-reads that bucket (__ldcg,
// at L2, the coherence point of the atomics) and rescans: lock-free, every
// retry follows another thread's success. i1 == i2 needs no special case:
// the secondary scan reads the same full bucket. Keys with both buckets
// full report ok = 0 and go to the caller's eviction path.
//
// Bound: device-memory bytes. Per segment one random 32-byte primary
// bucket read; per key its key, order and ok streams, one 4-byte word
// read-modify-write, and a secondary bucket read only when the primary is
// full. The cached primary bucket saves the per-key primary reads of the
// direct-insert kernel; with one key per bucket (2^24 keys into 2^24
// buckets) a segment holds about one key, so the gain is small there and
// the cost is the sort the wrapper runs first.
#include "cuckoo_common.cuh"

namespace {

template <int W, int F>
__global__ void cuckoo_insert_bulk_kernel(uint32_t* table, const uint2* keys,
                                          const uint8_t* valid,
                                          const int64_t* order,
                                          const int64_t* seg_start,
                                          int64_t num_segments, int64_t n,
                                          uint8_t* ok, cuckoo::Geometry g) {
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_segments) return;
  const int64_t begin = seg_start[s];
  const int64_t end = s + 1 < num_segments ? seg_start[s + 1] : n;
  constexpr int TPW = 32 / F;
  uint32_t w1[W];
  bool cached = false;
  for (int64_t j = begin; j < end; ++j) {
    const int64_t i = order[j];
    uint8_t res = 0;
    if (valid[i]) {
      const uint2 k = keys[i];
      const cuckoo::Probe p = cuckoo::prepare(k.x, k.y, g);
      if (!cached) {  // every key of the segment has this primary bucket
        cuckoo::load_bucket<W, false>(table, p.i1, w1);
        cached = true;
      }
      // Primary bucket, from the cached words.
      for (;;) {
        const int slot =
            cuckoo::first_circular<W, F>(cuckoo::free_slots<W, F>(w1), p.start);
        if (slot < 0) break;
        const int widx = slot / TPW;
        const uint32_t old = cuckoo::pick(w1, widx);
        const uint32_t desired = cuckoo::replace_lane<F>(old, slot % TPW, p.tag1);
        if (atomicCAS(table + size_t(p.i1) * W + widx, old, desired) == old) {
          cuckoo::put(w1, widx, desired);
          res = 1;
          break;
        }
        cuckoo::load_bucket<W, false>(table, p.i1, w1);
      }
      // Secondary bucket, read fresh: the primary is full and stays full.
      while (!res) {
        uint32_t w2[W];
        cuckoo::load_bucket<W, false>(table, p.i2, w2);
        const int slot =
            cuckoo::first_circular<W, F>(cuckoo::free_slots<W, F>(w2), p.start);
        if (slot < 0) break;
        const int widx = slot / TPW;
        const uint32_t old = cuckoo::pick(w2, widx);
        const uint32_t desired = cuckoo::replace_lane<F>(old, slot % TPW, p.tag2);
        res = atomicCAS(table + size_t(p.i2) * W + widx, old, desired) == old;
      }
    }
    ok[i] = res;
  }
}

}  // namespace

// table: uint32[num_buckets * wpb], updated in place; keys: uint32[n, 2]
// (lo, hi) in batch order; valid, ok: uint8[n] in batch order; order:
// int64[n], the batch positions sorted stably by primary bucket;
// seg_start: int64[num_segments], the first sorted position of each
// primary bucket's run. Returns the cudaError_t of the launch.
CUCKOO_EXPORT int cuckoo_insert_bulk_launch(
    void* table, const void* keys, const void* valid, const void* order,
    const void* seg_start, int64_t num_segments, int64_t n, void* ok,
    uint32_t num_buckets, uint32_t bucket_size, uint32_t fp_bits,
    uint32_t policy, uint32_t hash_kind, uint64_t seed, void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  const dim3 grid(
      unsigned((num_segments + cuckoo::THREADS - 1) / cuckoo::THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  cuckoo_insert_bulk_kernel<W, F><<<grid, cuckoo::THREADS, 0, st>>>(
                      static_cast<uint32_t*>(table),
                      static_cast<const uint2*>(keys),
                      static_cast<const uint8_t*>(valid),
                      static_cast<const int64_t*>(order),
                      static_cast<const int64_t*>(seg_start), num_segments, n,
                      static_cast<uint8_t*>(ok), g))
  return int(cudaGetLastError());
}
