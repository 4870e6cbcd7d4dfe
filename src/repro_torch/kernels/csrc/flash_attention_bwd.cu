// Flash attention backward: dQ, dK and dV of exactly the function the
// forward kernel (flash_attention.cu) computes: scale, the attention-logit
// softcap before the mask, causal and sliding-window masks with a query
// offset, GQA / MQA, D != Dv up to 256, float32 or bf16 inputs, a float32
// or bf16 output.
//
// Replaces no TPU kernel. The JAX package trains through an XLA scan
// (repro/models/attention.py: flash_attention) that JAX differentiates;
// its Pallas forward has no custom_vjp. The port's attention forward is
// kernel #11 on the card, so its gradient needs a kernel of its own: left
// to the plain version, every training step would spend its attention
// backward in chunked torch ops.
//
// Three launches, all reading the contiguous kernel layout: q [BK, g, Sq,
// D], k [BK, Sk, D], v [BK, Sk, Dv], the forward's out and its cotangent
// dout [BK, g, Sq, Dv] (as float32: the wrapper widens a bf16 output
// and its cotangent), and the forward's row log-sum-exp lse [BK, g, Sq]
// (float32, in the scaled and capped score's units). Gradients are written
// float32 (the wrapper casts them to the inputs' dtype).
// 1. delta = rowsum(dout * out), one warp a query row, into scratch.
// 2. dQ: a block owns 16 query rows of one (BK, g) row (4 a warp) and
//    sweeps the keys they may see in tiles of 32, a lane a key: it
//    recomputes each score and P = exp(capped score - lse), dP = dout V^T,
//    dS = P (dP - delta) (1 - (capped / cap)^2) scale, and adds dS K into
//    registers, a lane an output column.
// 3. dK / dV: a block owns 16 keys of one BK row (4 a warp) and sweeps,
//    for each of the g query heads in turn, the query rows that may see
//    them in tiles of 32, a lane a query row: dV += P^T dout, dK += dS^T Q.
// No floating-point atomics: every sum runs in one thread in a fixed
// order (key tiles ascending; heads, then query tiles ascending), so two
// launches on the same inputs give the same bits. The scores are computed
// twice (once in each of 2 and 3): seven products of the score shape
// where the forward has two, all fp32 on CUDA cores.
//
// Bound: at the training shape (B 2, S 2048, 20 heads of 128, causal) the
// least time is set by FLOP (2 * pairs * (3 D + 2 Dv) at the bf16 tensor
// rate, 2.5 times the forward's). This kernel is the plain-and-right one:
// fp32 FMAs from shared memory, four rows a warp reusing each loaded key
// (or query) value four times. Tensor cores (mma.sync / wgmma) are later
// work.
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;              // rows a warp: queries (dQ), keys (dK/dV)
constexpr int BLOCK_ROWS = ROWS * WARPS;   // 16 a block
constexpr int TILE = 32;             // the swept tile: a lane a row
constexpr int DMAX = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* o;
  const float* dout;
  const float* lse;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int g, sq, sk, hd, vd, causal, window, q_offset;   // window < 0: none
  float scale, cap;                                  // cap <= 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int key) {
  return key < p.sk && (!p.causal || key <= qp) &&
         (p.window < 0 || qp - key < p.window);
}

// P and dS of one score: sc the raw q . k, lse and delta the query row's.
// A masked pair (or a row or key past the edge) gives 0 for both.
__device__ __forceinline__ void p_ds(const Params& p, float sc, float dp,
                                     float lse, float delta, bool ok,
                                     float& pr, float& ds) {
  float sx = sc * p.scale, dcap = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(sx / p.cap);
    sx = p.cap * t;
    dcap = 1.f - t * t;
  }
  pr = ok ? expf(sx - lse) : 0.f;
  ds = pr * (dp - delta) * dcap * p.scale;
}

__global__ void __launch_bounds__(THREADS) delta_kernel(Params p, int64_t rows) {
  const int64_t row = int64_t(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = p.o + row * p.vd;
  const float* d = p.dout + row * p.vd;
  float acc = 0.f;
  for (int c = lane; c < p.vd; c += 32) acc = fmaf(o[c], d[c], acc);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// Shared memory of the dQ kernel: its 16 q and dout rows, a tile of 32 k
// and v rows (one float more a row: lane j reads row j).
constexpr int dq_smem_floats(int hmax, int vmax) {
  return BLOCK_ROWS * hmax + BLOCK_ROWS * vmax + TILE * (hmax + 1) +
         TILE * (vmax + 1);
}

// Grid (BK * g, query tiles of 16).
template <typename T, int HMAX, int VMAX>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  auto qs = reinterpret_cast<float (*)[HMAX]>(smem);
  auto dos = reinterpret_cast<float (*)[VMAX]>(smem + BLOCK_ROWS * HMAX);
  auto ks = reinterpret_cast<float (*)[HMAX + 1]>(
      smem + BLOCK_ROWS * (HMAX + VMAX));
  auto vs = reinterpret_cast<float (*)[VMAX + 1]>(
      smem + BLOCK_ROWS * (HMAX + VMAX) + TILE * (HMAX + 1));

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BLOCK_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t kv = bh / p.g;
  const T* q = static_cast<const T*>(p.q) + int64_t(bh) * p.sq * p.hd;
  const float* dout = p.dout + int64_t(bh) * p.sq * p.vd;
  const T* k = static_cast<const T*>(p.k) + kv * p.sk * p.hd;
  const T* v = static_cast<const T*>(p.v) + kv * p.sk * p.vd;

  for (int i = threadIdx.x; i < BLOCK_ROWS * p.hd; i += THREADS) {
    const int r = i / p.hd, c = i % p.hd;
    qs[r][c] = q0 + r < p.sq ? to_f(q[int64_t(q0 + r) * p.hd + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < BLOCK_ROWS * p.vd; i += THREADS) {
    const int r = i / p.vd, c = i % p.vd;
    dos[r][c] = q0 + r < p.sq ? dout[int64_t(q0 + r) * p.vd + c] : 0.f;
  }
  float lse[ROWS], delta[ROWS], acc[ROWS][HMAX / 32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + warp * ROWS + r;
    const bool in = row < p.sq;
    lse[r] = in ? p.lse[int64_t(bh) * p.sq + row] : 0.f;
    delta[r] = in ? p.delta[int64_t(bh) * p.sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < HMAX / 32; ++j) acc[r][j] = 0.f;
  }

  const int qp_first = p.q_offset + q0;
  const int qp_last = p.q_offset + min(q0 + BLOCK_ROWS, p.sq) - 1;
  int lo = 0, hi = p.sk;
  if (p.causal) hi = min(hi, qp_last + 1);
  if (p.window >= 0) lo = max(lo, qp_first - p.window + 1);
  for (int kt = (lo / TILE) * TILE; kt < hi; kt += TILE) {
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * p.hd; i += THREADS) {
      const int r = i / p.hd, c = i % p.hd;
      ks[r][c] = kt + r < p.sk ? to_f(k[int64_t(kt + r) * p.hd + c]) : 0.f;
    }
    for (int i = threadIdx.x; i < TILE * p.vd; i += THREADS) {
      const int r = i / p.vd, c = i % p.vd;
      vs[r][c] = kt + r < p.sk ? to_f(v[int64_t(kt + r) * p.vd + c]) : 0.f;
    }
    __syncthreads();

    // This lane's key against the warp's four rows.
    float sc[ROWS], dp[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r] = dp[r] = 0.f;
    for (int c = 0; c < p.hd; ++c) {
      const float kc = ks[lane][c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        sc[r] = fmaf(qs[warp * ROWS + r][c], kc, sc[r]);
    }
    for (int c = 0; c < p.vd; ++c) {
      const float vc = vs[lane][c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        dp[r] = fmaf(dos[warp * ROWS + r][c], vc, dp[r]);
    }
    float ds[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = q0 + warp * ROWS + r;
      float pr;
      p_ds(p, sc[r], dp[r], lse[r], delta[r],
           row < p.sq && allowed(p, p.q_offset + row, kt + lane), pr, ds[r]);
    }
    // dQ += dS K, a lane an output column.
    for (int kk = 0; kk < TILE; ++kk) {
      float dsk[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dsk[r] = __shfl_sync(FULL, ds[r], kk);
#pragma unroll
      for (int j = 0; j < HMAX / 32; ++j) {
        const int c = lane + 32 * j;
        if (c < p.hd) {
          const float kc = ks[kk][c];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][j] = fmaf(dsk[r], kc, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + warp * ROWS + r;
    if (row >= p.sq) continue;
    float* out = p.dq + (int64_t(bh) * p.sq + row) * p.hd;
#pragma unroll
    for (int j = 0; j < HMAX / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < p.hd) out[c] = acc[r][j];
    }
  }
}

// Shared memory of the dK / dV kernel: its 16 k and v rows, a tile of 32
// q and dout rows (one float more a row: lane j reads row j), and the
// tile's lse and delta.
constexpr int dkv_smem_floats(int hmax, int vmax) {
  return BLOCK_ROWS * hmax + BLOCK_ROWS * vmax + TILE * (hmax + 1) +
         TILE * (vmax + 1) + 2 * TILE;
}

// Grid (BK, key tiles of 16).
template <typename T, int HMAX, int VMAX>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  auto ks = reinterpret_cast<float (*)[HMAX]>(smem);
  auto vs = reinterpret_cast<float (*)[VMAX]>(smem + BLOCK_ROWS * HMAX);
  float* tile = smem + BLOCK_ROWS * (HMAX + VMAX);
  auto qs = reinterpret_cast<float (*)[HMAX + 1]>(tile);
  auto dos = reinterpret_cast<float (*)[VMAX + 1]>(tile + TILE * (HMAX + 1));
  float* lses = tile + TILE * (HMAX + 1) + TILE * (VMAX + 1);
  float* deltas = lses + TILE;

  const int64_t kv = blockIdx.x;
  const int k0 = blockIdx.y * BLOCK_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* k = static_cast<const T*>(p.k) + kv * p.sk * p.hd;
  const T* v = static_cast<const T*>(p.v) + kv * p.sk * p.vd;

  for (int i = threadIdx.x; i < BLOCK_ROWS * p.hd; i += THREADS) {
    const int r = i / p.hd, c = i % p.hd;
    ks[r][c] = k0 + r < p.sk ? to_f(k[int64_t(k0 + r) * p.hd + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < BLOCK_ROWS * p.vd; i += THREADS) {
    const int r = i / p.vd, c = i % p.vd;
    vs[r][c] = k0 + r < p.sk ? to_f(v[int64_t(k0 + r) * p.vd + c]) : 0.f;
  }
  float acc_k[ROWS][HMAX / 32], acc_v[ROWS][VMAX / 32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < HMAX / 32; ++j) acc_k[r][j] = 0.f;
#pragma unroll
    for (int j = 0; j < VMAX / 32; ++j) acc_v[r][j] = 0.f;
  }

  // The query rows that may see a key of [k0, key_last].
  const int key_last = min(k0 + BLOCK_ROWS, p.sk) - 1;
  int qlo = 0, qhi = p.sq;
  if (p.causal) qlo = max(qlo, k0 - p.q_offset);
  if (p.window >= 0) qhi = min(qhi, key_last + p.window - p.q_offset);
  for (int h = 0; h < p.g; ++h) {
    const int64_t bh = kv * p.g + h;
    const T* q = static_cast<const T*>(p.q) + bh * p.sq * p.hd;
    const float* dout = p.dout + bh * p.sq * p.vd;
    for (int qt = (max(qlo, 0) / TILE) * TILE; qt < qhi; qt += TILE) {
      __syncthreads();
      for (int i = threadIdx.x; i < TILE * p.hd; i += THREADS) {
        const int r = i / p.hd, c = i % p.hd;
        qs[r][c] = qt + r < p.sq ? to_f(q[int64_t(qt + r) * p.hd + c]) : 0.f;
      }
      for (int i = threadIdx.x; i < TILE * p.vd; i += THREADS) {
        const int r = i / p.vd, c = i % p.vd;
        dos[r][c] = qt + r < p.sq ? dout[int64_t(qt + r) * p.vd + c] : 0.f;
      }
      if (threadIdx.x < TILE) {
        const int row = qt + threadIdx.x;
        lses[threadIdx.x] = row < p.sq ? p.lse[bh * p.sq + row] : 0.f;
        deltas[threadIdx.x] = row < p.sq ? p.delta[bh * p.sq + row] : 0.f;
      }
      __syncthreads();

      // This lane's query row against the warp's four keys.
      const int row = qt + lane;
      float sc[ROWS], dp[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sc[r] = dp[r] = 0.f;
      for (int c = 0; c < p.hd; ++c) {
        const float qc = qs[lane][c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          sc[r] = fmaf(qc, ks[warp * ROWS + r][c], sc[r]);
      }
      for (int c = 0; c < p.vd; ++c) {
        const float dc = dos[lane][c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          dp[r] = fmaf(dc, vs[warp * ROWS + r][c], dp[r]);
      }
      float pr[ROWS], ds[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int key = k0 + warp * ROWS + r;
        p_ds(p, sc[r], dp[r], lses[lane], deltas[lane],
             row < p.sq && allowed(p, p.q_offset + row, key), pr[r], ds[r]);
      }
      // dV += P^T dout, dK += dS^T Q, a lane an output column.
      for (int kk = 0; kk < TILE; ++kk) {
        float pk[ROWS], dsk[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          pk[r] = __shfl_sync(FULL, pr[r], kk);
          dsk[r] = __shfl_sync(FULL, ds[r], kk);
        }
#pragma unroll
        for (int j = 0; j < VMAX / 32; ++j) {
          const int c = lane + 32 * j;
          if (c < p.vd) {
            const float dc = dos[kk][c];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc_v[r][j] = fmaf(pk[r], dc, acc_v[r][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < HMAX / 32; ++j) {
          const int c = lane + 32 * j;
          if (c < p.hd) {
            const float qc = qs[kk][c];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc_k[r][j] = fmaf(dsk[r], qc, acc_k[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int key = k0 + warp * ROWS + r;
    if (key >= p.sk) continue;
    float* gk = p.dk + (kv * p.sk + key) * p.hd;
    float* gv = p.dv + (kv * p.sk + key) * p.vd;
#pragma unroll
    for (int j = 0; j < HMAX / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < p.hd) gk[c] = acc_k[r][j];
    }
#pragma unroll
    for (int j = 0; j < VMAX / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < p.vd) gv[c] = acc_v[r][j];
    }
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, the
// attribute set once a device (bit `device` of `set_on`).
template <typename K>
cudaError_t launch_dynamic(K kernel, std::atomic<uint64_t>& set_on, dim3 grid,
                           int smem, cudaStream_t stream, const Params& p) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  if (!(set_on.load(std::memory_order_relaxed) & bit)) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The dQ and dK / dV kernels at head-size bounds HMAX (D) and VMAX (Dv).
template <typename T, int HMAX, int VMAX>
int launch_grads(const Params& p, int64_t bk, cudaStream_t stream) {
  static std::atomic<uint64_t> dq_set{0}, dkv_set{0};
  const dim3 dq_grid(unsigned(bk * p.g),
                     unsigned((p.sq + BLOCK_ROWS - 1) / BLOCK_ROWS));
  cudaError_t rc = launch_dynamic(
      dq_kernel<T, HMAX, VMAX>, dq_set, dq_grid,
      int(sizeof(float)) * dq_smem_floats(HMAX, VMAX), stream, p);
  if (rc != cudaSuccess) return int(rc);
  const dim3 dkv_grid(unsigned(bk),
                      unsigned((p.sk + BLOCK_ROWS - 1) / BLOCK_ROWS));
  rc = launch_dynamic(dkv_kernel<T, HMAX, VMAX>, dkv_set, dkv_grid,
                      int(sizeof(float)) * dkv_smem_floats(HMAX, VMAX), stream,
                      p);
  return int(rc);
}

template <typename T>
int launch_typed(const Params& p, int64_t bk, cudaStream_t stream) {
  const int64_t rows = bk * p.g * p.sq;
  delta_kernel<<<unsigned((rows + WARPS - 1) / WARPS), THREADS, 0,
                     stream>>>(p, rows);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return int(rc);
  // Head-size bounds (D, Dv): (128, 128), MLA's (256, 128), else (256,
  // 256).
  if (p.vd > 128) return launch_grads<T, 256, 256>(p, bk, stream);
  if (p.hd > 128) return launch_grads<T, 256, 128>(p, bk, stream);
  return launch_grads<T, 128, 128>(p, bk, stream);
}

}  // namespace

// The backward of the forward kernel on the contiguous kernel layout: q
// [bk, g, sq, d], k [bk, sk, d], v [bk, sk, dv] (dtype 0 = float32, 1 =
// bfloat16), out and dout [bk, g, sq, dv] float32, lse [bk, g, sq]
// float32 (the forward's), delta scratch [bk, g, sq] float32; writes
// dq, dk, dv float32 in q's, k's and v's shapes. window < 0: none; cap <=
// 0: no softcap. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for head sizes past 256 or a grid too large).
extern "C" __attribute__((visibility("default"))) int
flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                           const float* out, const float* dout, const float* lse,
                           void* delta, void* dq, void* dk, void* dv,
                           int64_t bk, int32_t g, int32_t sq, int32_t sk,
                           int32_t d, int32_t d_v, int32_t dtype,
                           int32_t causal, int32_t window,
                           int32_t q_offset, float scale, float cap,
                           void* stream) {
  if (d < 1 || d_v < 1 || d > DMAX || d_v > DMAX || bk * g >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{q, k, v, out, dout, lse,
                 static_cast<float*>(delta), static_cast<float*>(dq),
                 static_cast<float*>(dk), static_cast<float*>(dv), g, sq, sk,
                 d, d_v, causal, window, q_offset, scale, cap};
  return dtype == 0 ? launch_typed<float>(p, bk, s)
                    : launch_typed<__nv_bfloat16>(p, bk, s);
}
