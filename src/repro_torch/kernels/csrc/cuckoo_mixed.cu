// Mixed QUERY / INSERT / DELETE op stream (DESIGN.md §9); a delete-only
// stream is the filter's delete (paper Alg. 3).
//
// Replaces the TPU kernel repro/kernels/cuckoo_mixed.py:
// cuckoo_mixed_pallas (_mixed_kernel). The TPU ran the whole stream in
// batch order on one core, so operation i saw every write of operations
// j < i, across keys too. Hopper runs thousands of operations at once
// against a table in device memory. This route gives the normative
// semantics of DESIGN.md §9 instead: ``ok`` and the table are what one
// sequential order of the ops gives, an order that keeps the ops of each
// 64-bit key in batch order. Cross-key fingerprint aliasing (two keys with
// one tag and one bucket pair) is therefore seen in that order, not the
// batch's.
//
// The route, all on the caller's stream (kernels/cuckoo_mixed.py runs it):
//
//   1. clear — cudaMemsetAsync of a scratch table of 2^s >= 2n 64-bit
//      slots (load <= 0.5 for linear probing).
//   2. mark — a block a tile of block_keys ops (kernels/autotune.py; 256,
//      one thread an op, by default), in batch layout (keys, ops and
//      valid read coalesced). A valid op's digest (cuckoo::hash_key, the filter's own
//      hash) gives a value v, its 63 low bits (0 taken as 1), and a home
//      slot. Linear probing from there claims the first empty slot with a
//      64-bit atomicCAS, or meets v and sets the slot's top bit with
//      atomicOr: a repeat. The op's kind goes into its state byte.
//   3. apply — three launches of one kernel: once-only queries, then
//      deletes, then inserts, each over the mark's tiles; a thread
//      settles the ops of that kind among its own, in batch layout. It finds v's slot; if the top bit is set it writes the
//      state byte 1 + its kind (repeated) and stops, else it settles the
//      op (below) and writes state 0 and ok coalesced.
//   4. walk — only where the caller's one compaction of the state bytes
//      (its one host sync) found repeated ops, which it sorts stably by
//      64-bit key value, each carrying its position and kind: one
//      cooperative launch whose thread owns a key's run, reading the sorted
//      keys themselves (no gather). Round r applies the r-th op of every
//      run still open, queries, deletes and inserts in turn, with a
//      grid-wide barrier after each kind. While most runs are open a round
//      scans every sorted position (coalesced); once few are, it reads a
//      list of the open runs, so a round costs what its ops cost; once at
//      most BLOCK_RUNS are open, block 0 walks the rest alone with
//      __syncthreads() as the barrier (a key with many ops then costs a
//      few microseconds a round, not a grid-wide barrier).
//
// Why the marks are right. Every op of a value v probes the same slot
// sequence, and a slot only goes from empty to a value, never back. So the
// first op of v to win a CAS does it at the first empty slot of that
// sequence, and every other op of v finds v there before any empty slot:
// a real repeat is never missed. Two different keys whose values are equal
// are both marked (a false repeat); the walk groups runs by the 64-bit key,
// so each forms a run of one and is applied exactly. The slots are 64
// bits: with 32-bit values n distinct keys would give about n^2 / 2^32
// false repeats (2^16 at n = 2^24), each sent through the sort and the
// walk; 63-bit values give about n^2 / 2^64.
//
// Why the result is a sequential order of the ops. The route realises:
// once-only queries, deletes, inserts, then the runs of repeated keys
// round by round. A once-only op is its key's only op, so moving it ahead
// of other keys' ops keeps every key's batch order; a run keeps it across
// rounds, and a round holds at most one op of each key. Inside one launch
// or one barrier phase every op in flight is of one kind, and for one kind
// each op's outcome is the sequential loop's at one instant of the phase:
//   - queries write nothing, so the table does not change under them;
//   - deletes only clear lanes: a copy that shows no matching tag in a
//     word stays right, so "no match in i1" still holds when i2 is read
//     and when a CAS in i2 lands (the op's instant), and a stale match
//     only makes the CAS fail;
//   - inserts only fill lanes: a bucket seen full stays full, so "i1
//     full" holds when the insert lands in i2 or is turned down.
// With both deletes and inserts in flight neither holds (a bucket seen
// full may lose a tag, one seen without a tag may gain it), which is why
// the kinds never share a phase. The plain loop's choice of lane inside a
// bucket is not kept (the first free or matching lane from scan_start in
// the thread's copy, which may be stale), so buckets hold the same tag
// multisets, not always the same lanes.
//
// Settling one op (as kernels #2 and #4 do): read bucket i1; read bucket
// i2 only when i1 cannot settle the op (no matching tag for a query or
// delete, no free slot for an insert); both scanned circularly from
// scan_start, i1 first. One loop and one CAS site serve both buckets. A
// lost CAS returns the word as it now is; the thread puts it into its
// register copy and rescans the copy, and goes on to i2 if i1 no longer
// settles the op. Lock-free: each lost CAS follows another thread's
// successful CAS on that word, and in a phase of one kind each loss shows
// the thread one tag or one free slot fewer, so an op loses at most
// bucket_size times a bucket.
//
// Loads of the table that other threads of the same launch may write use
// __ldcg (at L2, the coherence point of the atomics); only the once-only
// query launch, which writes nothing, reads through __ldg.
//
// Bound: device-memory bytes. The function needs each key and op once,
// each touched bucket once (kernels/roofline.py: the "delete" bound). The
// route's own floor adds its passes: the scratch cleared, claimed and read
// back, the keys read twice, the state bytes (roofline.py:
// mixed_route_bytes). What holds it on the card is random traffic: per
// op one scratch slot claimed and read back and one table bucket read and
// its word CASed, each a 32-byte sector at a random place.
#include <algorithm>
#include <cooperative_groups.h>

#include "cuckoo_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint64_t REPEAT = 1ull << 63;
// State byte of an op between mark and apply: its kind plus KIND_BASE, so
// that no pending kind reads as an apply result (0, or 1 + kind).
constexpr uint8_t KIND_BASE = 4;

__device__ __forceinline__ int kind_of(int op) {
  return op == cuckoo::OP_INSERT ? cuckoo::OP_INSERT
       : op == cuckoo::OP_DELETE ? cuckoo::OP_DELETE : cuckoo::OP_QUERY;
}

// The scratch value of a digest: its 63 low bits, never 0.
__device__ __forceinline__ uint64_t mark_value(uint32_t hhi, uint32_t hlo) {
  const uint64_t v = ((uint64_t(hhi) << 32) | hlo) & ~REPEAT;
  return v ? v : 1ull;
}

// First slot of a value's probe sequence (Fibonacci hashing into 2^s).
__device__ __forceinline__ uint64_t home_slot(uint64_t v, uint32_t log2_slots) {
  return (v * 0x9E3779B97F4A7C15ull) >> (64 - log2_slots);
}

// Whether the value's slot carries the repeat bit. The slot is there: the
// mark put v on its probe sequence ahead of every empty slot.
__device__ __forceinline__ bool is_repeat(const unsigned long long* scratch,
                                          uint32_t log2_slots, uint64_t v) {
  const uint64_t mask = (1ull << log2_slots) - 1ull;
  for (uint64_t s = home_slot(v, log2_slots);; s = (s + 1) & mask) {
    const uint64_t w = __ldg(scratch + s);
    if ((w & ~REPEAT) == v) return (w & REPEAT) != 0;
  }
}

// Slots of a bucket that settle an op of kind OP: free lanes for an insert,
// lanes equal to ``tag`` otherwise.
template <int W, int F, int OP>
__device__ __forceinline__ uint32_t settling(const uint32_t (&w)[W],
                                             uint32_t tag) {
  return OP == cuckoo::OP_INSERT ? cuckoo::free_slots<W, F>(w)
                                 : cuckoo::match_slots<W, F>(w, tag);
}

// Settle one op of kind OP (see the header) -> ok.
template <int W, int F, int OP, bool READ_ONLY>
__device__ __forceinline__ bool settle(uint32_t* table, const cuckoo::Probe& p) {
  constexpr int TPW = 32 / F;
  uint32_t w1[W], w2[W];
  cuckoo::load_bucket<W, READ_ONLY>(table, p.i1, w1);
  bool have2 = false;
  for (;;) {
    int slot = cuckoo::first_circular<W, F>(settling<W, F, OP>(w1, p.t1),
                                            p.start);
    const bool in1 = slot >= 0;
    if (!in1) {
      if (!have2) {
        cuckoo::load_bucket<W, READ_ONLY>(table, p.i2, w2);
        have2 = true;
      }
      slot = cuckoo::first_circular<W, F>(settling<W, F, OP>(w2, p.t2),
                                          p.start);
    }
    if (slot < 0) return false;  // no stored copy / no free slot
    if constexpr (OP == cuckoo::OP_QUERY) {
      return true;
    } else {
      const int widx = slot / TPW;
      const uint32_t old = in1 ? cuckoo::pick(w1, widx) : cuckoo::pick(w2, widx);
      const uint32_t store =
          OP == cuckoo::OP_INSERT ? (in1 ? p.tag1 : p.tag2) : 0u;
      const uint32_t desired = cuckoo::replace_lane<F>(old, slot % TPW, store);
      const uint32_t seen =
          atomicCAS(table + size_t(in1 ? p.i1 : p.i2) * W + widx, old, desired);
      if (seen == old) return true;
      if (in1) {
        cuckoo::put(w1, widx, seen);
      } else {
        cuckoo::put(w2, widx, seen);
      }
    }
  }
}

// Claim op i's value in the scratch, or mark it repeated.
__device__ __forceinline__ void mark_op(unsigned long long* scratch,
                                        uint32_t log2_slots, uint2 k,
                                        const cuckoo::Geometry& g) {
  uint32_t hhi, hlo;
  cuckoo::hash_key(k.x, k.y, g, hhi, hlo);
  const uint64_t v = mark_value(hhi, hlo);
  const uint64_t mask = (1ull << log2_slots) - 1ull;
  for (uint64_t s = home_slot(v, log2_slots);; s = (s + 1) & mask) {
    const uint64_t seen = atomicCAS(scratch + s, 0ull, v);
    if (seen == 0) return;  // the value's first op
    if ((seen & ~REPEAT) == v) {
      if (!(seen & REPEAT)) atomicOr(scratch + s, REPEAT);
      return;
    }
  }
}

__global__ void cuckoo_mixed_mark_kernel(unsigned long long* scratch,
                                         uint32_t log2_slots, const uint2* keys,
                                         const int32_t* ops,
                                         const uint8_t* valid, uint8_t* ok,
                                         uint8_t* state, int64_t n,
                                         uint32_t block_keys,
                                         cuckoo::Geometry g) {
  int64_t first, end;
  cuckoo::block_tile(n, block_keys, first, end);
  for (int64_t i = first + threadIdx.x; i < end; i += cuckoo::THREADS) {
    if (!valid[i]) {
      ok[i] = 0;
      state[i] = 0;
      continue;
    }
    state[i] = uint8_t(KIND_BASE + kind_of(ops[i]));
    mark_op(scratch, log2_slots, keys[i], g);
  }
}

template <int W, int F, int OP>
__global__ void cuckoo_mixed_apply_kernel(uint32_t* table, const uint2* keys,
                                          const unsigned long long* scratch,
                                          uint32_t log2_slots, uint8_t* ok,
                                          uint8_t* state, int64_t n,
                                          uint32_t block_keys,
                                          cuckoo::Geometry g) {
  int64_t first, end;
  cuckoo::block_tile(n, block_keys, first, end);
  for (int64_t i = first + threadIdx.x; i < end; i += cuckoo::THREADS) {
    if (state[i] != KIND_BASE + OP) continue;
    const uint2 k = keys[i];
    uint32_t hhi, hlo;
    cuckoo::hash_key(k.x, k.y, g, hhi, hlo);
    if (is_repeat(scratch, log2_slots, mark_value(hhi, hlo))) {
      state[i] = 1 + OP;
      continue;
    }
    ok[i] = settle<W, F, OP, OP == cuckoo::OP_QUERY>(
        table, cuckoo::prepare(k.x, k.y, g));
    state[i] = 0;
  }
}

// ``info[j]``: at sorted position j, the length of the run that begins
// there (0 where none begins) << 2 | the kind of j's op. ``value[j]``: the
// 64-bit key at j, so no key is gathered; ``order[j]``: its op's batch
// position << 2 | its kind. Apply run j's op of round r (if it is of kind
// OP) -> whether the run has ops left after it.
template <int W, int F, int OP>
__device__ __forceinline__ bool walk_op(uint32_t* table, const int64_t* value,
                                        const int64_t* order,
                                        const int32_t* info, int64_t j,
                                        int32_t head, int32_t r, uint8_t* ok,
                                        const cuckoo::Geometry& g) {
  const int64_t at = j + r;
  if ((__ldcg(info + at) & 3) != OP) return false;
  const uint64_t key = uint64_t(value[at]);
  ok[order[at] >> 2] = settle<W, F, OP, false>(
      table, cuckoo::prepare(uint32_t(key), uint32_t(key >> 32), g));
  return (head >> 2) > r + 1;
}

// Adds each thread's ``count`` to ``*total``, one atomic a warp (every
// lane of the warp calls it).
__device__ __forceinline__ void add_by_warp(int32_t* total, int32_t count) {
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(total, count);
}

// Appends ``j`` to ``list`` (its length in ``*count``), one atomic for the
// threads of a warp that append together.
__device__ __forceinline__ void append(int32_t* list, int32_t* count,
                                       int32_t j) {
  cg::coalesced_group group = cg::coalesced_threads();
  int32_t at = 0;
  if (group.thread_rank() == 0) at = atomicAdd(count, int32_t(group.size()));
  list[group.shfl(at, 0) + group.thread_rank()] = j;
}

// Round r's ops of kind OP, found by a scan of every sorted position
// (coalesced while most runs are open); the runs left are counted.
template <int W, int F, int OP>
__device__ __forceinline__ void walk_scan(uint32_t* table, const int64_t* value,
                                          const int64_t* order,
                                          const int32_t* info, int64_t m,
                                          int32_t r, int32_t* next_count,
                                          uint8_t* ok, const cuckoo::Geometry& g,
                                          int64_t first, int64_t stride) {
  int32_t left = 0;
  for (int64_t j = first; j < m; j += stride) {
    const int32_t head = __ldcg(info + j);
    left += (head >> 2) > r &&
            walk_op<W, F, OP>(table, value, order, info, j, head, r, ok, g);
  }
  add_by_warp(next_count, left);
}

// Round r's ops of kind OP over a list of the open runs (``c`` of them, by
// their first sorted position); the runs left go into ``next``.
template <int W, int F, int OP>
__device__ __forceinline__ void walk_list(uint32_t* table, const int64_t* value,
                                          const int64_t* order,
                                          const int32_t* info,
                                          const int32_t* now, int32_t c,
                                          int32_t r, int32_t* next,
                                          int32_t* next_count, uint8_t* ok,
                                          const cuckoo::Geometry& g,
                                          int64_t first, int64_t stride) {
  for (int64_t x = first; x < c; x += stride) {
    const int32_t j = __ldcg(now + x);
    if (walk_op<W, F, OP>(table, value, order, info, j, __ldcg(info + j), r,
                          ok, g))
      append(next, next_count, j);
  }
}

// Open runs at or below which the walk keeps a list of them instead of
// scanning every position (at least LIST_SHARE of the positions), and at
// or below which block 0 walks the rest alone, its threads meeting at
// __syncthreads() instead of the grid's barrier.
constexpr int64_t LIST_SHARE = 16;
constexpr int32_t BLOCK_RUNS = 2048;

// ``lists``: three lists of m run heads, used in rotation (round r reads
// list r % 3 and fills list (r + 1) % 3); ``counts``: the open runs of
// each list, then the cursor that builds the first list; 0 at launch.
template <int W, int F>
__global__ void cuckoo_mixed_walk_kernel(uint32_t* table, const int64_t* value,
                                         const int64_t* order, int64_t m,
                                         int32_t* info, int32_t* lists,
                                         int32_t* counts, uint8_t* ok,
                                         cuckoo::Geometry g) {
  cg::grid_group grid = cg::this_grid();
  int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t stride = int64_t(gridDim.x) * blockDim.x;
  int32_t runs = 0;
  for (int64_t j = first; j < m; j += stride) {
    const int64_t v = value[j];
    int32_t run = 0;
    if (j == 0 || value[j - 1] != v) {
      run = 1;
      while (j + run < m && value[j + run] == v) ++run;
      ++runs;
    }
    info[j] = (run << 2) | int32_t(order[j] & 3);
  }
  add_by_warp(counts, runs);
  grid.sync();
  // Each round: queries, deletes, inserts, a barrier after each. The count
  // of the list filled next round is cleared a round ahead. Every thread
  // reads the same count, so all take the same branches.
  bool listed = false, whole_grid = true;
  for (int32_t r = 0;; ++r) {
    const int32_t c = __ldcg(counts + r % 3);
    if (c == 0) return;
    int32_t* now = lists + (r % 3) * m;
    if (!listed && (c * LIST_SHARE <= m || c <= BLOCK_RUNS)) {
      for (int64_t j = first; j < m; j += stride)
        if ((__ldcg(info + j) >> 2) > r) append(now, counts + 3, int32_t(j));
      grid.sync();
      listed = true;
    }
    if (listed && whole_grid && c <= BLOCK_RUNS) {
      if (blockIdx.x != 0) return;
      whole_grid = false;
      first = threadIdx.x;
      stride = blockDim.x;
    }
    if (first == 0) counts[(r + 2) % 3] = 0;
    int32_t* next = lists + ((r + 1) % 3) * m;
    int32_t* next_count = counts + (r + 1) % 3;
    if (listed) {
      walk_list<W, F, cuckoo::OP_QUERY>(table, value, order, info, now, c, r,
                                        next, next_count, ok, g, first, stride);
      whole_grid ? grid.sync() : __syncthreads();
      walk_list<W, F, cuckoo::OP_DELETE>(table, value, order, info, now, c, r,
                                         next, next_count, ok, g, first, stride);
      whole_grid ? grid.sync() : __syncthreads();
      walk_list<W, F, cuckoo::OP_INSERT>(table, value, order, info, now, c, r,
                                         next, next_count, ok, g, first, stride);
      whole_grid ? grid.sync() : __syncthreads();
    } else {
      walk_scan<W, F, cuckoo::OP_QUERY>(table, value, order, info, m, r,
                                        next_count, ok, g, first, stride);
      grid.sync();
      walk_scan<W, F, cuckoo::OP_DELETE>(table, value, order, info, m, r,
                                         next_count, ok, g, first, stride);
      grid.sync();
      walk_scan<W, F, cuckoo::OP_INSERT>(table, value, order, info, m, r,
                                         next_count, ok, g, first, stride);
      grid.sync();
    }
  }
}

// The walk on as many blocks as the card holds at once (a cooperative
// launch needs every block resident), at most one a THREADS positions.
template <int W, int F>
cudaError_t launch_walk(uint32_t* table, const int64_t* value,
                        const int64_t* order, int64_t m, int32_t* info,
                        int32_t* lists, int32_t* counts, uint8_t* ok,
                        cuckoo::Geometry g, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cuckoo_mixed_walk_kernel<W, F>, cuckoo::THREADS, 0);
  if (e != cudaSuccess) return e;
  const int64_t want = (m + cuckoo::THREADS - 1) / cuckoo::THREADS;
  const unsigned blocks = unsigned(
      std::max<int64_t>(1, std::min<int64_t>(want, int64_t(per_sm) * sms)));
  void* args[] = {&table, &value, &order, &m, &info, &lists, &counts, &ok, &g};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cuckoo_mixed_walk_kernel<W, F>),
      dim3(blocks), dim3(cuckoo::THREADS), args, 0, s);
}

}  // namespace

// Steps 1-3. table: uint32[num_buckets * wpb], updated in place; keys:
// uint32[n, 2]; ops: int32[n]; valid: uint8[n]; scratch: uint64[2^s],
// 2^s >= 2n; ok, state: uint8[n]. Afterwards state[i] is 1 + the kind of
// op i (0 query, 1 insert, 2 delete) where it is a valid op of a repeated
// value (its ok left for the walk), else 0. block_keys: the ops a block of
// the mark and of each apply launch (cuckoo::block_keys_ok); the walk's
// grid is its own. Returns the cudaError_t of the launches.
CUCKOO_EXPORT int cuckoo_mixed_launch(void* table, const void* keys,
                                      const void* ops, const void* valid,
                                      void* scratch, uint32_t log2_slots,
                                      int64_t n, void* ok, void* state,
                                      uint32_t block_keys,
                                      uint32_t num_buckets,
                                      uint32_t bucket_size, uint32_t fp_bits,
                                      uint32_t policy, uint32_t hash_kind,
                                      uint64_t seed, void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  CUCKOO_DISPATCH(wpb, fp_bits, (void)0)  // refuse a layout before any launch
  if (log2_slots < 1 || log2_slots > 62 ||
      (int64_t(1) << log2_slots) < 2 * n || !cuckoo::block_keys_ok(block_keys))
    return int(cudaErrorInvalidValue);
  const dim3 grid = cuckoo::tile_grid(n, block_keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* slots = static_cast<unsigned long long*>(scratch);
  const auto* k = static_cast<const uint2*>(keys);
  auto* t = static_cast<uint32_t*>(table);
  auto* o = static_cast<uint8_t*>(ok);
  auto* st = static_cast<uint8_t*>(state);
  cudaError_t e = cudaMemsetAsync(slots, 0, size_t(8) << log2_slots, s);
  if (e != cudaSuccess) return int(e);
  cuckoo_mixed_mark_kernel<<<grid, cuckoo::THREADS, 0, s>>>(
      slots, log2_slots, k, static_cast<const int32_t*>(ops),
      static_cast<const uint8_t*>(valid), o, st, n, block_keys, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  CUCKOO_DISPATCH(wpb, fp_bits,
      cuckoo_mixed_apply_kernel<W, F, cuckoo::OP_QUERY>
          <<<grid, cuckoo::THREADS, 0, s>>>(t, k, slots, log2_slots, o, st, n,
                                            block_keys, g);
      cuckoo_mixed_apply_kernel<W, F, cuckoo::OP_DELETE>
          <<<grid, cuckoo::THREADS, 0, s>>>(t, k, slots, log2_slots, o, st, n,
                                            block_keys, g);
      cuckoo_mixed_apply_kernel<W, F, cuckoo::OP_INSERT>
          <<<grid, cuckoo::THREADS, 0, s>>>(t, k, slots, log2_slots, o, st, n,
                                            block_keys, g))
  return int(cudaGetLastError());
}

// Step 4. value: int64[m], the repeated ops' 64-bit keys sorted stably;
// order: int64[m], their batch positions << 2 | their kinds (the state
// byte less 1) in that order (batch order within a key); scratch: at least
// 16 * m bytes (the runs' lengths and kinds, three lists of runs); counts:
// int32[4].
// Writes ok at those positions. Returns the cudaError_t of the launches.
CUCKOO_EXPORT int cuckoo_mixed_walk_launch(void* table, const void* value,
                                           const void* order, int64_t m,
                                           void* scratch, void* counts,
                                           void* ok, uint32_t num_buckets,
                                           uint32_t bucket_size,
                                           uint32_t fp_bits, uint32_t policy,
                                           uint32_t hash_kind, uint64_t seed,
                                           void* stream) {
  const cuckoo::Geometry g{num_buckets, bucket_size, fp_bits, policy,
                           hash_kind, seed};
  const uint32_t wpb = bucket_size / (32 / fp_bits);
  CUCKOO_DISPATCH(wpb, fp_bits, (void)0)
  if (m < 1 || m >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* info = static_cast<int32_t*>(scratch);
  cudaError_t e = cudaMemsetAsync(counts, 0, 4 * sizeof(int32_t), s);
  if (e != cudaSuccess) return int(e);
  CUCKOO_DISPATCH(wpb, fp_bits,
      e = launch_walk<W, F>(static_cast<uint32_t*>(table),
                            static_cast<const int64_t*>(value),
                            static_cast<const int64_t*>(order), m, info,
                            info + m, static_cast<int32_t*>(counts),
                            static_cast<uint8_t*>(ok), g, s))
  return int(e != cudaSuccess ? e : cudaGetLastError());
}
