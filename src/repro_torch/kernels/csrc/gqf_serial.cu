// The quotient filter's serial insert (G1) and delete (G2).
//
// No Pallas kernel stands behind these: they replace the two compiled
// device loops of repro/filters/quotient.py, the ``lax.fori_loop`` over
// the batch with a ``lax.while_loop`` a key in ``insert`` (the Robin Hood
// shift chain, :97) and in ``delete`` (the backward-shift compaction,
// :165). In PyTorch the counterpart of one compiled device loop is one
// kernel; the same loop in torch ops would pay a launch and a host sync a
// probe step.
//
// The table is ``uint32[num_slots]``: ``dist << r | remainder``, 0 empty.
// Each kernel is one thread (``<<<1, 1>>>``) running the JAX loop statement
// for statement in uint32 arithmetic, keys in batch order: every shift
// depends on the one before, which is the structure's own semantics (the
// paper's "fundamentally latency-bound" GQF), so the results are
// bit-exact with the JAX package's. That covers its faults: ``dist << r``
// wraps modulo 2^32 (R6: the distance field loses its high bits when r >
// 24), and an insert that runs past ``max_probe`` drops the entry it
// carries (R5).
//
// Bound: latency. A key's probe run is a chain of dependent loads, the
// first a random one; nothing overlaps it. The bytes the batch's runs
// touch, over the memory rate, are printed beside the time as a floor
// that this design does not aim at.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t r) {
  return r >= 32 ? 0u : x << r;  // XLA's shift: 0 past the width
}

__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t r) {
  return r >= 32 ? 0u : x >> r;
}

// quotient.py:108-141: Robin Hood insertion, one key after another.
__global__ void gqf_insert_serial_kernel(
    uint32_t* __restrict__ table, const uint32_t* __restrict__ rem,
    const uint32_t* __restrict__ home, const bool* __restrict__ valid,
    bool* __restrict__ ok, int32_t* __restrict__ count, int64_t n,
    uint64_t num_slots, uint32_t r, uint32_t max_probe) {
  const uint32_t rmask = r >= 32 ? 0xFFFFFFFFu : (1u << r) - 1u;
  int32_t placed_keys = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t pos = home[i];
    uint32_t cur = rem[i];
    uint32_t dist = 0;
    bool live = valid[i];
    bool placed = false;
    while (live) {
      const uint32_t slot = table[pos];
      const bool empty = slot == 0;
      const uint32_t s_dist = shr(slot, r);
      const bool rich = s_dist < dist;  // displace the richer entry
      if (empty || rich) table[pos] = shl(dist, r) | (cur & rmask);
      placed = placed || empty;
      if (rich && !empty) {  // carry the displaced entry forward
        cur = slot & rmask;
        dist = s_dist;
      }
      live = !empty && dist < max_probe;
      pos = pos + 1 == num_slots ? 0 : pos + 1;
      dist += 1;
    }
    ok[i] = placed;
    placed_keys += placed;
  }
  *count += placed_keys;
}

// quotient.py:177-211: the first match in the key's window of
// ``max_probe`` slots, then backward-shift compaction.
__global__ void gqf_delete_serial_kernel(
    uint32_t* __restrict__ table, const uint32_t* __restrict__ rem,
    const uint32_t* __restrict__ home, const bool* __restrict__ valid,
    bool* __restrict__ ok, int32_t* __restrict__ count, int64_t n,
    uint64_t num_slots, uint32_t r, uint32_t max_probe) {
  const uint32_t rmask = r >= 32 ? 0xFFFFFFFFu : (1u << r) - 1u;
  int32_t removed = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t h = home[i];
    const uint32_t want = rem[i];
    bool found = false;
    uint64_t at = 0;
    for (uint32_t d = 0; d < max_probe; ++d) {
      const uint32_t v = table[(h + d) % num_slots];
      if ((v & rmask) == want && shr(v, r) == d) {
        found = true;
        at = d;
        break;
      }
    }
    found = found && valid[i];
    uint64_t pos = (h + at) % num_slots;
    bool live = found;
    while (live) {
      const uint64_t nxt = pos + 1 == num_slots ? 0 : pos + 1;
      const uint32_t nslot = table[nxt];
      const uint32_t nd = shr(nslot, r);
      const bool movable = nslot != 0 && nd > 0;
      table[pos] = movable ? shl(nd - 1, r) | (nslot & rmask) : 0u;
      live = movable;
      pos = nxt;
    }
    ok[i] = found;
    removed += found;
  }
  *count -= removed;
}

using Kernel = void (*)(uint32_t*, const uint32_t*, const uint32_t*,
                        const bool*, bool*, int32_t*, int64_t, uint64_t,
                        uint32_t, uint32_t);

int launch(Kernel kernel, void* table, const void* rem, const void* home,
           const void* valid, void* ok, void* count, int64_t n,
           uint64_t num_slots, uint32_t r, uint32_t max_probe, void* stream) {
  kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(table), static_cast<const uint32_t*>(rem),
      static_cast<const uint32_t*>(home), static_cast<const bool*>(valid),
      static_cast<bool*>(ok), static_cast<int32_t*>(count), n, num_slots, r,
      max_probe);
  return int(cudaGetLastError());
}

}  // namespace

// table: uint32[num_slots]; rem, home: uint32[n] (``_prepare``); valid,
// ok: bool[n]; count: int32[1], updated by the keys placed (removed).
// Each returns the cudaError_t of its launch.
extern "C" __attribute__((visibility("default"))) int gqf_insert_serial_launch(
    void* table, const void* rem, const void* home, const void* valid,
    void* ok, void* count, int64_t n, uint64_t num_slots, uint32_t r,
    uint32_t max_probe, void* stream) {
  return launch(gqf_insert_serial_kernel, table, rem, home, valid, ok, count,
                n, num_slots, r, max_probe, stream);
}

extern "C" __attribute__((visibility("default"))) int gqf_delete_serial_launch(
    void* table, const void* rem, const void* home, const void* valid,
    void* ok, void* count, int64_t n, uint64_t num_slots, uint32_t r,
    uint32_t max_probe, void* stream) {
  return launch(gqf_delete_serial_kernel, table, rem, home, valid, ok, count,
                n, num_slots, r, max_probe, stream);
}
