// K-mer pack (paper §5.5 genomic case study), forward or canonical.
//
// Replaces the TPU kernel repro/kernels/kmer_pack.py: kmer_pack_pallas
// (_kmer_kernel), which packed one tile of positions per grid step from a
// (block + k)-base window of the padded input, k shift-or steps a
// position. Output position i < m = n - k + 1 holds bases[i .. i + k - 1]
// packed big-endian by base (first base most significant) into the low 2k
// bits of a 64-bit value, written as one (lo, hi) uint32 pair, the port's
// key layout. The canonical instantiation writes the unsigned minimum of
// that value and its reverse complement instead (the KMC3 convention;
// kernels/kmer_pack.py: canonicalize). Positions past n - k, which the
// TPU kernel computed from zero padding and its wrapper sliced off, are
// never computed, and no byte past the input's n is read.
//
// Bound: device-memory bytes, n code bytes read and 8 bytes written a
// position. The function needs one rolling step a code (canonical: and a
// rolling reverse-complement step a code and a 64-bit min a key): under a
// quarter of the bytes' time in INT32 issue at the case study's shape.
//
// Design: a block owns a tile of TILE positions. Its threads read the
// tile's TILE + k - 1 codes from device memory once, 16 bytes a load from
// the 16-byte-aligned address at or below the tile's first code (a chunk
// that crosses either end of the input is read byte by byte, inside it
// only), mask each code to its low two bits and pack a chunk into one
// 32-bit word of a 2-bit big-endian stream in shared memory. A position's
// window then comes from three consecutive stream words by two funnel
// shifts and a 64-bit shift: a constant few instructions, whatever k, where
// one load and one shift-or a code cost about 93 instructions a position
// at k = 31. The reverse complement of a window is a bit reversal, a swap
// within each 2-bit pair, a NOT and the same shift. A warp's stores cover
// 256 contiguous bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;  // positions a block
// Stream words a block packs: the up to 15 codes before the tile's first in
// its aligned chunk, the tile's codes, the k - 1 <= 30 after its last, and
// the third word a window at the tile's end reads.
constexpr int WORDS = TILE / 16 + 3;

// Four codes, one a byte of x (the first in its lowest byte), masked and
// multiplied into the top byte big-endian: bits 0, 8, 16 and 24 move to 30,
// 28, 26 and 24; the cross products land below bit 22 without carries.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return (x & 0x03030303u) * 0x40100401u;
}

// Sixteen codes, one a byte in memory order, -> one big-endian stream word.
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  const uint32_t a = pack4(v.x), b = pack4(v.y), c = pack4(v.z),
                 d = pack4(v.w);
  // The top bytes of a, b, c and d become bytes 3, 2, 1 and 0.
  return __byte_perm(__byte_perm(d, c, 0x0073), __byte_perm(b, a, 0x7300),
                     0x7610);
}

template <bool kCanonical>
__global__ void __launch_bounds__(THREADS)
    kmer_pack_kernel(const uint8_t* __restrict__ bases,
                     uint2* __restrict__ out, int64_t m, int k) {
  __shared__ uint32_t stream[WORDS];
  const int64_t n = m + k - 1;
  const int64_t p0 = int64_t(blockIdx.x) * TILE;
  // Stream code c of this block is input byte base + c.
  const int lead = int(reinterpret_cast<uintptr_t>(bases + p0) & 15);
  const int64_t base = p0 - lead;
  for (int w = threadIdx.x; w < WORDS; w += THREADS) {
    const int64_t at = base + 16 * w;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (at >= 0 && at + 16 <= n) {
      v = __ldg(reinterpret_cast<const uint4*>(bases + at));
    } else if (at + 16 > 0 && at < n) {
      uint32_t word[4] = {0, 0, 0, 0};
      for (int t = 0; t < 16; ++t) {
        if (at + t >= 0 && at + t < n) {
          word[t >> 2] |= uint32_t(__ldg(bases + at + t)) << (8 * (t & 3));
        }
      }
      v = make_uint4(word[0], word[1], word[2], word[3]);
    }
    stream[w] = pack16(v);
  }
  __syncthreads();

  const int count = int(m - p0 < TILE ? m - p0 : TILE);
  const int drop = 64 - 2 * k;
  for (int p = threadIdx.x; p < count; p += THREADS) {
    const int c = p + lead;
    const int w = c >> 4, shift = 2 * (c & 15);
    const uint32_t a = stream[w], b = stream[w + 1], d = stream[w + 2];
    // Codes c .. c + 31, big-endian, then the window's k at the bottom.
    const uint64_t x = (uint64_t(__funnelshift_l(b, a, shift)) << 32) |
                       __funnelshift_l(d, b, shift);
    uint64_t key = x >> drop;
    if (kCanonical) {
      // NOT complements each code (A<->T, C<->G); the bit reversal reverses
      // the codes' order and each code's two bits, which the swap restores.
      uint64_t r = __brevll(~key);
      r = ((r >> 1) & 0x5555555555555555ull) |
          ((r & 0x5555555555555555ull) << 1);
      r >>= drop;
      key = r < key ? r : key;
    }
    out[p0 + p] = make_uint2(uint32_t(key), uint32_t(key >> 32));  // (lo, hi)
  }
}

}  // namespace

// bases: uint8[m + k - 1] codes at any address; out: uint32[m, 2] (lo, hi);
// canonical: nonzero for min(k-mer, reverse complement). Returns the
// cudaError_t of the launch.
extern "C" __attribute__((visibility("default"))) int kmer_pack_launch(
    const void* bases, void* out, int64_t m, uint32_t k, uint32_t canonical,
    void* stream) {
  const dim3 grid(unsigned((m + TILE - 1) / TILE));
  const auto* b = static_cast<const uint8_t*>(bases);
  auto* o = static_cast<uint2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (canonical) {
    kmer_pack_kernel<true><<<grid, THREADS, 0, s>>>(b, o, m, int(k));
  } else {
    kmer_pack_kernel<false><<<grid, THREADS, 0, s>>>(b, o, m, int(k));
  }
  return int(cudaGetLastError());
}
