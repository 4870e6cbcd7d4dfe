// Flash attention forward: online softmax, causal and/or sliding-window
// masks, GQA, float32 or bf16 output.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel). That kernel ran a (B * KVH, g,
// nq, nk) grid whose innermost nk axis stepped in order on one core, so
// it could carry the output accumulator, running max and denominator in
// VMEM scratch from one KV block to the next, and it padded q/k/v to block
// multiples first. Blocks on Hopper run in parallel and in no order, so
// here one thread block owns one (B * KVH * g) row and one tile of query
// rows and sweeps the whole KV range itself in a loop: the accumulators
// stay in registers for the whole sweep, and nothing is written to device
// memory but the output. Nothing is padded: K/V rows past Sk are staged as
// zeros and masked, query rows past Sq are computed and not stored. Tiles
// that the causal mask or the window hide entirely are skipped by the
// loop bounds, as the TPU kernel skipped them with pl.when.
//
// Layouts (contiguous): q [BK, g, Sq, D], k [BK, Sk, D], v [BK, Sk, Dv],
// out [BK, g, Sq, Dv] float32 or bf16 (the float32 result rounded once);
// query row h of KV row b reads k[b], v[b]
// (BK = B * KVH). The mask is the JAX package's: key position j is seen by
// query position i = q_offset + row when j < Sk, j <= i if causal, and
// i - j < window if a window is set; a masked score is NEG_INF = -1e30,
// the running max is clamped at -1e20 before exp (so a fully masked row
// gives p = 0), and the denominator has a floor of 1e-30 (such a row
// outputs 0).
//
// Bound: at the serving prefill (B 4, S 1024, 20 heads of 128, causal,
// bf16) the least time is set by device-memory bytes (q, k, v read once,
// the bf16 out written once: 83.9 MB, against 2.15e10 FLOP; a float32 out
// adds 21 MB, so the model path, which keeps bf16, asks for bf16, as the
// Pallas kernel writes q's dtype); from a few thousand
// keys a row on, by tensor-core FLOP (4 * pairs * D). The design keeps
// every score and probability on chip and reads each K/V tile once per
// query tile of 64 rows.
//
// Two variants, chosen by the wrapper (kernels.ops.flash_variant):
// * tensor cores (bf16, D == Dv in {32, 64, 128}): 4 warps of 16 query
//   rows each; Q fragments in registers for the whole sweep; a 64-key K
//   tile (row-major) and V tile (transposed) in shared memory;
//   S = Q K^T and O += P V with mma.sync m16n8k16 bf16 -> fp32; P is
//   rounded to bf16 for the second product (the TPU kernel kept it fp32).
//   The softmax runs on the accumulator fragments (a row spans 4 lanes).
//   wgmma, TMA and warp specialisation are later work.
// * FMA (fp32, and bf16 at other head sizes up to 128): 4 warps of 4
//   query rows each, a 32-key tile in shared memory as fp32, a lane per
//   key for the scores and a lane per output column for P V; everything
//   fp32, as the TPU kernel computes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;   // NEG_INF * 1e-10, the m_safe clamp
constexpr float L_FLOOR = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int g, sq, sk, d, dv, causal, window, q_offset;  // window < 0: none
  int out_bf16;                                    // 0: float32 out
  float scale;
};

// Output element i (of this row block) and i + 1 <- a, b.
__device__ __forceinline__ void store2(const Params& p, int64_t i, float a,
                                       float b) {
  if (p.out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(
        static_cast<__nv_bfloat16*>(p.out) + i) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + i) =
        make_float2(a, b);
}

__device__ __forceinline__ void store1(const Params& p, int64_t i, float a) {
  if (p.out_bf16)
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(a);
  else
    static_cast<float*>(p.out)[i] = a;
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int key) {
  return key < p.sk && (!p.causal || key <= qp) &&
         (p.window < 0 || qp - key < p.window);
}

// The keys [lo, hi) any query position in [qp_first, qp_last] may see.
__device__ __forceinline__ void key_range(const Params& p, int qp_first,
                                          int qp_last, int& lo, int& hi) {
  lo = 0;
  hi = p.sk;
  if (p.causal) hi = min(hi, qp_last + 1);
  if (p.window >= 0) lo = max(lo, qp_first - p.window + 1);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a (16x16 bf16, row-major fragment) * b (16x8 bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(Params p) {
  constexpr int BQ = 64, BKT = 64;
  constexpr int KP = D + 8;     // padded pitches: fragment loads hit
  constexpr int VP = BKT + 8;   // 32 distinct banks
  __shared__ __align__(16) __nv_bfloat16 ks[BKT * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[DV * VP];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int64_t kv = bh / p.g;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + int64_t(bh) * p.sq * D;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + kv * p.sk * D;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + kv * p.sk * DV;
  const int64_t out0 = int64_t(bh) * p.sq * DV;

  // This thread's two query rows (fragment rows grp and grp + 8).
  const int r0 = q0 + warp * 16 + grp, r1 = r0 + 8;
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qa[kk][0] = r0 < p.sq ? ld32(q + int64_t(r0) * D + c) : 0u;
    qa[kk][1] = r1 < p.sq ? ld32(q + int64_t(r1) * D + c) : 0u;
    qa[kk][2] = r0 < p.sq ? ld32(q + int64_t(r0) * D + c + 8) : 0u;
    qa[kk][3] = r1 < p.sq ? ld32(q + int64_t(r1) * D + c + 8) : 0u;
  }

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  int lo, hi;
  key_range(p, p.q_offset + q0, p.q_offset + min(q0 + BQ, p.sq) - 1, lo, hi);
  for (int kt = (lo / BKT) * BKT; kt < hi; kt += BKT) {
    __syncthreads();  // the previous tile's readers are done
    // K tile row-major (16-byte copies along a row: coalesced); V tile
    // transposed, a thread a key row (neighbouring threads write
    // neighbouring keys of one vt row). Rows past Sk are zeros.
    for (int i = threadIdx.x; i < BKT * (D / 8); i += THREADS) {
      const int row = i / (D / 8), c8 = (i % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kt + row < p.sk)
        val = *reinterpret_cast<const uint4*>(k + int64_t(kt + row) * D + c8);
      *reinterpret_cast<uint4*>(ks + row * KP + c8) = val;
    }
    for (int i = threadIdx.x; i < BKT * (DV / 8); i += THREADS) {
      const int row = i % BKT, c8 = (i / BKT) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kt + row < p.sk)
        val = *reinterpret_cast<const uint4*>(v + int64_t(kt + row) * DV + c8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c8 + j) * VP + row] = e[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[BKT / 8][4];
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BKT / 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + grp) * KP + kk * 16 + tig * 2;
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale, mask and the online softmax; fragment element i of n-tile n
    // is key kt + 8n + 2 tig + (i & 1) of row r0 (i < 2) or r1.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kt + n * 8 + tig * 2 + (i & 1);
        const int qp = i < 2 ? qp0 : qp1;
        const float x = allowed(p, qp, key) ? s[n][i] * p.scale : NEG_INF;
        s[n][i] = x;
        if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float ms0 = fmaxf(mn0, M_FLOOR), ms1 = fmaxf(mn1, M_FLOOR);
    const float c0 = expf(fminf(m0 - mn0, 0.f)), c1 = expf(fminf(m1 - mn1, 0.f));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n) {
      s[n][0] = expf(s[n][0] - ms0);
      s[n][1] = expf(s[n][1] - ms0);
      s[n][2] = expf(s[n][2] - ms1);
      s[n][3] = expf(s[n][3] - ms1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P V: the score fragments of n-tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk (16 keys).
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + grp) * VP + kk * 16 + tig * 2;
        mma_bf16(o[n], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float d0 = fmaxf(l0, L_FLOOR), d1 = fmaxf(l1, L_FLOOR);
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int c = n * 8 + tig * 2;
    if (r0 < p.sq)
      store2(p, out0 + int64_t(r0) * DV + c, o[n][0] / d0, o[n][1] / d0);
    if (r1 < p.sq)
      store2(p, out0 + int64_t(r1) * DV + c, o[n][2] / d1, o[n][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// FMA variant (fp32 or bf16 inputs, D and Dv up to 128).
// ---------------------------------------------------------------------------

constexpr int FMA_ROWS = 4;                       // query rows a warp
constexpr int FMA_BQ = FMA_ROWS * (THREADS / 32); // 16 rows a block
constexpr int FMA_BKT = 32;                       // keys a tile: a lane each
constexpr int FMA_DMAX = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fma_kernel(Params p) {
  __shared__ float qs[FMA_BQ][FMA_DMAX];
  __shared__ float kf[FMA_BKT][FMA_DMAX + 1];   // +1: lane j reads row j
  __shared__ float vf[FMA_BKT][FMA_DMAX];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * FMA_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t kv = bh / p.g;
  const T* q = static_cast<const T*>(p.q) + int64_t(bh) * p.sq * p.d;
  const T* k = static_cast<const T*>(p.k) + kv * p.sk * p.d;
  const T* v = static_cast<const T*>(p.v) + kv * p.sk * p.dv;
  const int64_t out0 = int64_t(bh) * p.sq * p.dv;

  for (int i = threadIdx.x; i < FMA_BQ * p.d; i += THREADS) {
    const int r = i / p.d, c = i % p.d;
    qs[r][c] = q0 + r < p.sq ? to_f(q[int64_t(q0 + r) * p.d + c]) : 0.f;
  }

  float acc[FMA_ROWS][FMA_DMAX / 32];
  float m[FMA_ROWS], l[FMA_ROWS];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < FMA_DMAX / 32; ++j) acc[r][j] = 0.f;
  }

  int lo, hi;
  key_range(p, p.q_offset + q0, p.q_offset + min(q0 + FMA_BQ, p.sq) - 1, lo,
            hi);
  for (int kt = (lo / FMA_BKT) * FMA_BKT; kt < hi; kt += FMA_BKT) {
    __syncthreads();
    for (int i = threadIdx.x; i < FMA_BKT * p.d; i += THREADS) {
      const int r = i / p.d, c = i % p.d;
      kf[r][c] = kt + r < p.sk ? to_f(k[int64_t(kt + r) * p.d + c]) : 0.f;
    }
    for (int i = threadIdx.x; i < FMA_BKT * p.dv; i += THREADS) {
      const int r = i / p.dv, c = i % p.dv;
      vf[r][c] = kt + r < p.sk ? to_f(v[int64_t(kt + r) * p.dv + c]) : 0.f;
    }
    __syncthreads();

    const int key = kt + lane;
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const int row = warp * FMA_ROWS + r;
      const int qp = p.q_offset + q0 + row;
      float sc = 0.f;
      for (int c = 0; c < p.d; ++c) sc = fmaf(qs[row][c], kf[lane][c], sc);
      const float x = allowed(p, qp, key) ? sc * p.scale : NEG_INF;
      float mx = x;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float corr = expf(fminf(m[r] - mn, 0.f));
      const float pr = expf(x - fmaxf(mn, M_FLOOR));
      float sum = pr;
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = mn;
#pragma unroll
      for (int j = 0; j < FMA_DMAX / 32; ++j) acc[r][j] *= corr;
      for (int kk = 0; kk < FMA_BKT; ++kk) {
        const float pk = __shfl_sync(FULL, pr, kk);
#pragma unroll
        for (int j = 0; j < FMA_DMAX / 32; ++j) {
          const int c = lane + 32 * j;
          if (c < p.dv) acc[r][j] = fmaf(pk, vf[kk][c], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    const int row = q0 + warp * FMA_ROWS + r;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[r], L_FLOOR);
#pragma unroll
    for (int j = 0; j < FMA_DMAX / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < p.dv)
        store1(p, out0 + int64_t(row) * p.dv + c, acc[r][j] / den);
    }
  }
}

}  // namespace

// q, k, v as in the header, of dtype 0 = float32 or 1 = bfloat16; out
// [bk_g, sq, dv] (bk_g = BK * g rows) of out_dtype 0 = float32 or 1 =
// bfloat16. variant 1 = tensor cores
// (bf16, d == dv in {32, 64, 128}), 0 = FMA (d, dv <= 128). window < 0:
// none. Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments no variant takes).
extern "C" __attribute__((visibility("default"))) int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int64_t bk_g,
    int32_t g, int32_t sq, int32_t sk, int32_t d, int32_t dv, int32_t dtype,
    int32_t out_dtype, int32_t variant, int32_t causal, int32_t window, int32_t q_offset,
    float scale, void* stream) {
  const Params p{q, k, v, out, g, sq, sk, d, dv, causal, window, q_offset,
                 out_dtype == 1, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || d != dv) return int(cudaErrorInvalidValue);
    const dim3 grid(unsigned(bk_g), unsigned((sq + 63) / 64));
    if (d == 128)
      flash_mma_kernel<128, 128><<<grid, THREADS, 0, s>>>(p);
    else if (d == 64)
      flash_mma_kernel<64, 64><<<grid, THREADS, 0, s>>>(p);
    else if (d == 32)
      flash_mma_kernel<32, 32><<<grid, THREADS, 0, s>>>(p);
    else
      return int(cudaErrorInvalidValue);
  } else {
    if (d > FMA_DMAX || dv > FMA_DMAX) return int(cudaErrorInvalidValue);
    const dim3 grid(unsigned(bk_g), unsigned((sq + FMA_BQ - 1) / FMA_BQ));
    if (dtype == 0)
      flash_fma_kernel<float><<<grid, THREADS, 0, s>>>(p);
    else
      flash_fma_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(p);
  }
  return int(cudaGetLastError());
}
