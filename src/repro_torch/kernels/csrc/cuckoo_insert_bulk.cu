// Bucket-major direct insert, no eviction: the bulk-build kernel.
//
// Replaces the TPU kernel repro/kernels/cuckoo_insert.py:
// cuckoo_insert_bulk_pallas (_bulk_insert_kernel). The TPU kernel walked
// the batch sorted by primary bucket i1 on one core, kept the current
// primary bucket's words in VMEM across the run of keys that share it,
// and gave each key the first free slot of i1 scanning circularly from
// its start, else of i2 (layout.py: first_true_circular), with no
// eviction. Keys with both buckets full report ok = 0 and go to the
// caller's eviction path.
//
// Hopper has no sequential grid, and its fast memory is the L2, not a
// VMEM that holds the table. So the batch is partitioned by table window
// (window_route.cuh), the bucket-major order of the TPU kernel at the
// grain of a window of 2^s buckets small enough to stay in L2. The hash
// is fused into the partition: an entry is the key's (i1, tag), computed
// from the key by the count and again by the scatter, so no hash kernel
// and no sort precede the route, and no pass gathers through a
// permutation. Five launches, no host sync between them:
//   1-3. count, scan and scatter (window_route.cuh); keys with valid = 0
//        are left out;
//   4.   insert: blocks claim tiles of block_keys entries of the
//        concatenated segments in order through an atomic ticket, so the
//        tiles in flight cover one or two windows, and each entry is
//        settled as the direct insert settles a key (cuckoo::settle): a
//        CAS on the word it changes in bucket i1, rescanning on a lost
//        CAS, and bucket i2, which may lie in any window, read only when
//        i1 is full. Each tile also prefetches its share of the next
//        window into L2. The window's buckets are read from device memory
//        about once and each dirty sector written back about once, on
//        eviction, not once a key. The answer goes out as a byte in
//        segment order;
//   5.   un-permute: ok back to batch order through shared memory.
// Every placement is one atomicCAS on an L2 word, so the result is the
// sequential loop's in the order the CASes succeed; keys of one primary
// bucket may take another order than the batch's.
//
// A table that fits in the L2, or a batch too sparse for the partition to
// repay its passes, runs the insert pass alone over the batch in batch
// order, as one window (one launch). The wrapper decides from the shape
// alone (kernels/cuckoo_insert_bulk.py: bulk_plan).
//
// The tile (kernels/autotune.py: block_keys, a power of two in [256,
// 2048]) is the entries a ticket of pass 4, a thread settling block_keys /
// 256 of them in block-strided rounds; pass 4 is compiled once for each
// tile, so each keeps its rounds unrolled. The insert pass alone gives a
// block half a tile, block_keys / 2 keys (a key a thread at the default
// 512), so that the default launches both routes as they were before the
// tile could be tuned. The partition's own TILE (window_route.cuh) is
// structural and does not change.
//
// Bound: device-memory bytes. The function's: each key read once, ok
// written once, each bucket the batch needs read once and each changed
// one written once (kernels/roofline.py). The route's own floor adds its
// streamed bytes, 41 a key (the key and valid byte read twice, 18; the
// entry and slot written and read back, 20; the answer written and read
// back, 2; ok written, 1), and reads the whole table once
// (roofline.bulk_route_bytes).
#include "cuckoo_common.cuh"
#include "window_route.cuh"

namespace {

// The default tile is two entries a thread: at one key a bucket two were
// as fast as one or faster, and faster than four (four gained a little at
// eight keys a bucket).
constexpr uint32_t PREFETCH_CHUNK = 4096;  // bytes a bulk prefetch

// The route's partition: keys with valid = 1, their entry (i1, tag).
struct CuckooPartition {
  cuckoo::Geometry g;
  const uint8_t* valid;
  uint32_t log2_window;

  __device__ __forceinline__ bool entry(int64_t i, uint2 key, uint2& e) const {
    if (!valid[i]) return false;
    uint32_t tag, i1;
    cuckoo::primary(key.x, key.y, g, tag, i1);
    e = make_uint2(i1, tag);
    return true;
  }
  __device__ __forceinline__ uint32_t window(uint2 e) const {
    return e.x >> log2_window;
  }
};

// The insert pass alone, as one window: a block's keys in batch order,
// `block_keys` of them (half the route's tile).
template <int W, int F>
__global__ void __launch_bounds__(cuckoo::THREADS)
    bulk_direct_kernel(uint32_t* table, const uint2* __restrict__ keys,
                       const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ ok, int64_t n,
                       uint32_t block_keys, cuckoo::Geometry g) {
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

// Pass 4: the PER * THREADS entries of the tile the block's ticket names,
// each settled, its answer written in segment order. bases[windows] is the
// number of entries (the valid keys).
template <int W, int F, int PER>
__global__ void __launch_bounds__(cuckoo::THREADS)
    bulk_insert_kernel(uint32_t* table, const uint2* __restrict__ seg,
                       uint8_t* __restrict__ ans,
                       const uint32_t* __restrict__ bases, uint32_t windows,
                       uint32_t log2_window, cuckoo::Geometry g,
                       uint32_t* __restrict__ control) {
  constexpr uint32_t INSERT_TILE = PER * cuckoo::THREADS;
  __shared__ uint32_t ticket, window;
  if (threadIdx.x == 0) ticket = atomicAdd(&control[1], 1u);
  __syncthreads();
  const uint32_t total = bases[windows];
  const uint32_t first = ticket * INSERT_TILE;
  if (first >= total) return;
  // The tile's share of its window w stands for the same share of window
  // w + 1: bulk prefetches bring that slice into L2 before its keys come,
  // so that the next window is read from device memory in order. It pays
  // at one key a bucket; it costs where the batch is sparse, which the
  // route's rule leaves to the insert pass alone, and a little where many
  // keys go on to bucket i2.
  const uint32_t t = threadIdx.x;
  if (t < windows && bases[t] <= first && first < bases[t + 1]) window = t;
  __syncthreads();
  const uint32_t w = window;
  if (w + 1 < windows) {
    using u64 = unsigned long long;
    const u64 len = bases[w + 1] - bases[w];
    const u64 lo = first - bases[w];
    const u64 hi = lo + INSERT_TILE < len ? lo + INSERT_TILE : len;
    const u64 b0 = u64(w + 1) << log2_window;
    const u64 b1 = b0 + (1ull << log2_window);
    const u64 size = (b1 < g.num_buckets ? b1 : u64(g.num_buckets)) - b0;
    const u64 table_end = (u64(g.num_buckets) * W * 4) & ~15ull;
    const u64 a0 = ((b0 + lo * size / len) * W * 4) & ~15ull;
    const u64 a1 = ((b0 + hi * size / len) * W * 4 + 15) & ~15ull;
    const u64 end = a1 < table_end ? a1 : table_end;
    for (u64 a = a0 + u64(t) * PREFETCH_CHUNK; a < end;
         a += u64(blockDim.x) * PREFETCH_CHUNK) {
      const uint32_t bytes =
          uint32_t(end - a < PREFETCH_CHUNK ? end - a : u64(PREFETCH_CHUNK));
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                       reinterpret_cast<char*>(table) + a),
                   "r"(bytes)
                   : "memory");
    }
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const uint32_t j = first + r * cuckoo::THREADS + threadIdx.x;
    if (j < total) {
      const uint2 e = seg[j];
      ans[j] = cuckoo::insert<W, F, cuckoo::Swar>(
          table, cuckoo::probe_of(e.x, e.y, g));
    }
  }
}

// Pass 4 with a tile of PER * THREADS entries.
template <int W, int F, int PER>
void insert_pass(uint32_t* table, int64_t n, uint32_t log2_window,
                 uint32_t windows, const Scratch& s, const cuckoo::Geometry& g,
                 cudaStream_t st) {
  bulk_insert_kernel<W, F, PER>
      <<<cuckoo::tile_grid(n, PER * cuckoo::THREADS), cuckoo::THREADS, 0,
         st>>>(table, s.seg, s.ans, s.bases, windows, log2_window, g,
               s.control);
}

template <int W, int F>
int launch(uint32_t* table, const uint2* keys, const uint8_t* valid,
           uint8_t* ok, int64_t n, void* scratch, uint32_t log2_window,
           uint32_t windows, uint32_t block_keys, const cuckoo::Geometry& g,
           cudaStream_t st) {
  if (!cuckoo::block_keys_ok(block_keys)) return int(cudaErrorInvalidValue);
  if (windows <= 1) {
    const uint32_t half = block_keys / 2;
    bulk_direct_kernel<W, F>
        <<<cuckoo::tile_grid(n, half), cuckoo::THREADS, 0, st>>>(
            table, keys, valid, ok, n, half, g);
    return int(cudaGetLastError());
  }
  if (!windows_fit(n, log2_window, windows, g.num_buckets, scratch, ok))
    return int(cudaErrorInvalidValue);
  const Scratch s = carve(scratch, n, windows);
  partition(keys, n, CuckooPartition{g, valid, log2_window}, windows, s, st);
  const uint32_t per = block_keys / cuckoo::THREADS;
  if (per == 1)
    insert_pass<W, F, 1>(table, n, log2_window, windows, s, g, st);
  else if (per == 2)
    insert_pass<W, F, 2>(table, n, log2_window, windows, s, g, st);
  else if (per == 4)
    insert_pass<W, F, 4>(table, n, log2_window, windows, s, g, st);
  else
    insert_pass<W, F, 8>(table, n, log2_window, windows, s, g, st);
  unpermute(n, windows, s, ok, st);
  return int(cudaGetLastError());
}

}  // namespace

// Bytes of scratch the windowed route takes for n keys and `windows`
// windows.
CUCKOO_EXPORT int64_t cuckoo_insert_bulk_scratch_bytes(int64_t n,
                                                       uint32_t windows) {
  return int64_t(carve(nullptr, n, windows).bytes);
}

// table: uint32[num_buckets * wpb], updated in place; keys: uint32[n, 2]
// (lo, hi); valid, ok: uint8[n], in batch order. windows <= 1: the insert
// pass alone over the batch (scratch unused); else `windows` windows of
// 2^log2_window buckets (at most 256, the last one not empty), 1 <= n <
// 2^31, ok 4-byte aligned, scratch: cuckoo_insert_bulk_scratch_bytes(n,
// windows) bytes, 16-byte aligned; block_keys: the tile
// (cuckoo::block_keys_ok). Returns the cudaError_t of the launches.
CUCKOO_EXPORT int cuckoo_insert_bulk_launch(
    void* table, const void* keys, const void* valid, void* ok, int64_t n,
    void* scratch, uint32_t log2_window, uint32_t windows,
    uint32_t block_keys, uint32_t num_buckets, uint32_t bucket_size,
    uint32_t fp_bits, uint32_t policy, uint32_t hash_kind, uint64_t seed,
    void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  CUCKOO_DISPATCH(wpb, fp_bits,
                  return launch<W, F>(static_cast<uint32_t*>(table),
                                      static_cast<const uint2*>(keys),
                                      static_cast<const uint8_t*>(valid),
                                      static_cast<uint8_t*>(ok), n, scratch,
                                      log2_window, windows, block_keys, g,
                                      static_cast<cudaStream_t>(stream)))
  return int(cudaErrorInvalidValue);
}
