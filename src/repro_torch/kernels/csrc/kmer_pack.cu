// Rolling k-mer pack (paper §5.5 genomic case study).
//
// Replaces the TPU kernel repro/kernels/kmer_pack.py: kmer_pack_pallas
// (_kmer_kernel), which packed one tile of positions per grid step from a
// (block + k)-base window of the padded input. Here one thread computes
// one output position i < n - k + 1: it shifts the 2-bit codes
// bases[i .. i + k - 1] into a 64-bit accumulator (first base most
// significant) and writes the k-mer as one (lo, hi) uint32 pair, the
// port's key layout. Positions past n - k, which the TPU kernel computed
// from zero padding and its wrapper sliced off, are never computed, so no
// read goes past the input and no padded copy is made.
//
// Bound: device-memory bytes — n code bytes read (uint8, the genome's own
// form) and 8 bytes written per position. The function needs one shift-or
// step a code (a rolling pack); this design spends k a position.
// The design: neighbouring threads read overlapping windows of neighbouring
// bytes, so every code comes from device memory once and the rest of its
// k reads hit L1; the 8-byte stores of a warp are contiguous. A shared-
// memory tile with a (k - 1)-base halo would turn the k loads per thread
// into one — the obvious later speed step, not built here.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void kmer_pack_kernel(const uint8_t* __restrict__ bases,
                                 uint2* __restrict__ out, int64_t m, int k) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint64_t acc = 0;
  for (int j = 0; j < k; ++j) acc = (acc << 2) | (__ldg(bases + i + j) & 3u);
  out[i] = make_uint2(uint32_t(acc), uint32_t(acc >> 32));  // (lo, hi)
}

}  // namespace

// bases: uint8[m + k - 1] codes; out: uint32[m, 2] (lo, hi). Returns the
// cudaError_t of the launch.
extern "C" __attribute__((visibility("default"))) int kmer_pack_launch(
    const void* bases, void* out, int64_t m, uint32_t k, void* stream) {
  const int64_t blocks = (m + THREADS - 1) / THREADS;
  kmer_pack_kernel<<<dim3(unsigned(blocks)), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<uint2*>(out), m,
      int(k));
  return int(cudaGetLastError());
}
