// Flash attention forward: online softmax, causal and/or sliding-window
// masks, GQA, float32 or bf16 output.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel). That kernel ran a (B * KVH, g,
// nq, nk) grid whose innermost nk axis stepped in order on one core, so
// it could carry the output accumulator, running max and denominator in
// VMEM scratch from one KV block to the next, and it padded q/k/v to block
// multiples first. Blocks on Hopper run in parallel and in no order, so
// here one thread block owns one (B, KVH, g) row and one tile of query
// rows and sweeps the whole KV range itself in a loop: the accumulators
// stay in registers for the whole sweep, and nothing is written to device
// memory but the output. Nothing is padded: K/V rows past Sk arrive as
// zeros and are masked, query rows past Sq are computed and not stored.
// Tiles that the causal mask or the window hide entirely are skipped by
// the loop bounds, as the TPU kernel skipped them with pl.when.
//
// Layouts. The tensor-core variant reads q and writes out as 5-D views
// (B, KVH, g, S, D) and reads k, v as 4-D views (B, KVH, S, D), each by
// element strides (D contiguous, every other stride a multiple of 16
// bytes, 16-byte-aligned pointers): the model's [B, S, H, D] and the
// kernel layout [BK, g, S, D] (B = BK, KVH = 1) are both such views, so
// the model path hands its tensors over without a copy. The FMA variant
// takes the contiguous kernel layout. Query row h of KV row (b, kvh)
// reads k[b, kvh], v[b, kvh]. The mask is the JAX package's: key position
// j is seen by query position i = q_offset + row when j < Sk, j <= i if
// causal, and i - j < window if a window is set; a masked score is
// NEG_INF = -1e30, the running max is clamped at -1e20 before exp (so a
// fully masked row gives p = 0), and the denominator has a floor of 1e-30
// (such a row outputs 0). Out is float32 or bf16 (the float32 result
// rounded once).
//
// Bound: at the serving prefill (B 4, S 1024, 20 heads of 128, causal,
// bf16 in and out) the least time is set by device-memory bytes (q, k, v
// read once, out written once: 83.9 MB against 2.15e10 FLOP); from a few
// thousand keys a row on, by tensor-core FLOP (4 * pairs * D). What held
// the first (mma.sync) design far from either was issue, not bytes: 64 x
// 64 tiles of m16n8k16 products fed by synchronous loads into one shared
// buffer, a barrier on each side of every copy and V transposed by 2-byte
// stores, so copies and products never overlapped. This design moves
// every copy to TMA behind a ring of stages and every product to wgmma,
// and overlaps a tile's softmax with the previous tile's P V. What still
// holds it near half the FLOP bound at long prefills is not measured yet
// (PERF.md §7 lists the candidates).
//
// Two variants, chosen by the wrapper (kernels.ops.flash_variant):
// * wgmma (bf16, D == Dv in {32, 64, 128}): a block of three warpgroups
//   owns 128 query rows. A producer warpgroup gives up registers
//   (setmaxnreg.dec) and one of its threads issues TMA loads: the Q tile
//   once, then K and V tiles of BC keys into a ring of three
//   shared-memory stages, each guarded by a full mbarrier (expect_tx
//   bytes) and an empty one (the consumers' arrivals). Two consumer
//   warpgroups of 64 rows each (setmaxnreg.inc) compute S = Q K^T with
//   wgmma.mma_async from shared memory (K-major Q and K, 128-byte
//   swizzle, 64B at D = 32), run the online softmax on the accumulator
//   fragments (the running max on raw scores, then one FFMA and one
//   ex2.approx a score with the scale and the max folded in; the mask
//   built only on tiles that cross the diagonal, the window edge or Sk),
//   round P to bf16 in registers as wgmma's A operand (the S fragment of
//   keys 16k..16k+15 is the A fragment of k-step k) and add P V with V
//   read MN-major through wgmma's transpose bit. S of tile t is issued
//   with P V of tile t - 1, so the softmax runs while P V does. BC is 128
//   keys at D <= 64 and 96 at D = 128: ptxas (CUDA 12.9) held the
//   consumer branch well below the registers setmaxnreg.inc grants, and
//   128-key tiles at D = 128 (S, O and P alone take 160 registers a
//   thread) spilled and serialised the wgmmas. TMA zero-fills K/V rows
//   past Sk because S is a dimension of its own in the tensor maps. Under
//   the causal mask the heaviest query tiles launch first.
// * FMA (fp32, and bf16 at other head sizes; D and Dv up to 256 in any
//   combination, as the Pallas kernel takes them: gemma's 256, MLA's 192
//   against 128): 4 warps of 4 query rows each, a 32-key tile in shared
//   memory as fp32, a lane per key for the scores and a lane per output
//   column for P V; everything fp32, as the TPU kernel computes. It is
//   compiled for a head-size bound of 128 and of 256, its tiles sized by
//   the bound: at 256 they take 80 KB, past the 48 KB of static shared
//   memory, so both bounds take theirs dynamically (the attribute set
//   once a device). A smaller key tile would have kept them static, but a
//   tile is a lane a key: fewer keys would leave lanes idle in every
//   score and every P V step. At 256 a block of 80 KB leaves two blocks
//   an SM; this variant is the plain-and-right one, the tensor cores at
//   these shapes are later work.
#include <atomic>
#include <cstdint>
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
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

__device__ __forceinline__ void store1(const Params& p, int64_t i, float a) {
  if (p.out_bf16)
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(a);
  else
    static_cast<float*>(p.out)[i] = a;
}

__device__ __forceinline__ bool allowed(int sk, int causal, int window,
                                        int qp, int key) {
  return key < sk && (!causal || key <= qp) && (window < 0 || qp - key < window);
}

// The keys [lo, hi) any query position in [qp_first, qp_last] may see.
__device__ __forceinline__ void key_range(int sk, int causal, int window,
                                          int qp_first, int qp_last, int& lo,
                                          int& hi) {
  lo = 0;
  hi = sk;
  if (causal) hi = min(hi, qp_last + 1);
  if (window >= 0) lo = max(lo, qp_first - window + 1);
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int key) {
  return allowed(p.sk, p.causal, p.window, qp, key);
}

__device__ __forceinline__ void key_range(const Params& p, int qp_first,
                                          int qp_last, int& lo, int& hi) {
  key_range(p.sk, p.causal, p.window, qp_first, qp_last, lo, hi);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16): TMA, mbarriers, wgmma, warp specialisation.
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;                // query rows a block
constexpr int WG_THREADS = 384;           // producer + two consumers
// Registers a thread after setmaxnreg: 40 * 128 + 232 * 256 = 168 * 384.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

struct WgParams {
  void* out;
  int64_t ob, okvh, og, os;               // out strides (elements)
  int kvh, g, sq, sk, causal, window, q_offset, out_bf16;
  float scale_log2;                       // scale * log2(e)
};

// Shared-memory tiles of a head size: rows of D bf16 in sub-tiles of
// CHUNK columns (one TMA box each), a row SW bytes, swizzled by TMA in
// atoms of 8 rows, the layout wgmma reads.
template <int D>
struct Tile {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;   // swizzle span
  static constexpr int CHUNK = SW / 2;
  static constexpr int NSUB = D / CHUNK;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // 128B / 64B
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of this parity to complete. A wait that never
// completes (a barrier fault) traps after 2^26 polls instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A wgmma shared-memory operand: start address, leading and stride byte
// offsets (the step between swizzle-wide column blocks and between 8-row
// groups), swizzle code.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of registers an in-flight wgmma
// owns across the fence, commit and wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96) (+)= A (64 x 16, shared, K-major) * B (16 x 96, shared,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 96)
    wgmma_ss_n96(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x, flushing results below 2^-126 to 0 (a probability that small
// adds nothing a float32 sum keeps).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int D, int BC, int STAGES>
constexpr int wg_smem_bytes() {
  // Q, then STAGES x (K, V), then 1 + 2 * STAGES barriers; 1024 bytes of
  // slack to align the tiles to the swizzle atom.
  return WG_BQ * D * 2 + STAGES * 2 * BC * D * 2 + 8 * (1 + 2 * STAGES) +
         1024;
}

// Grid (B * KVH * g, query tiles of WG_BQ); WG_THREADS threads; BC keys a
// tile, STAGES tiles in flight.
template <int D, int BC, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const WgParams p) {
  using T = Tile<D>;
  constexpr uint32_t Q_BYTES = WG_BQ * D * 2, KV_BYTES = BC * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;   // Q sub-tiles
  const uint32_t kv_s = q_s + Q_BYTES;          // stage s: K, then V
  const uint32_t bars = kv_s + STAGES * 2 * KV_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int row = blockIdx.x;
  const int h = row % p.g, kvh = (row / p.g) % p.kvh, b = row / (p.g * p.kvh);
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * WG_BQ;
  int lo, hi;
  key_range(p.sk, p.causal, p.window, p.q_offset + q0,
            p.q_offset + min(q0 + WG_BQ, p.sq) - 1, lo, hi);
  const int t0 = lo / BC;
  const int ntiles = hi > lo ? (hi - t0 * BC + BC - 1) / BC : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NSUB; ++c)
        tma_load_5d(q_s + c * WG_BQ * T::SW, &qmap, q_full, c * T::CHUNK, q0,
                    h, kvh, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * KV_BYTES);
        const int kt = (t0 + t) * BC;
        const uint32_t ks = kv_s + stage * 2 * KV_BYTES, vs = ks + KV_BYTES;
#pragma unroll
        for (int c = 0; c < T::NSUB; ++c) {
          tma_load_4d(ks + c * BC * T::SW, &kmap, full(stage), c * T::CHUNK,
                      kt, kvh, b);
          tma_load_4d(vs + c * BC * T::SW, &vmap, full(stage), c * T::CHUNK,
                      kt, kvh, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 query rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
    const int w0 = q0 + cw * 64;                  // this warpgroup's rows
    const bool live = w0 < p.sq;
    const int wq_first = p.q_offset + w0;
    const int wq_last = p.q_offset + min(w0 + 64, p.sq) - 1;
    int wlo, whi;
    key_range(p.sk, p.causal, p.window, wq_first, wq_last, wlo, whi);
    const int r0 = w0 + warp * 16 + grp, r1 = r0 + 8;
    const int qp0 = p.q_offset + r0, qp1 = qp0 + 8;

    // S = Q K^T operands (K-major, one 8-row atom every 8 * SW bytes);
    // P V's B operand V is MN-major: LBO steps between column sub-tiles.
    const uint64_t q_desc =
        wgmma_desc(q_s + cw * 64 * T::SW, 16, 8 * T::SW, T::LAYOUT);
    const uint64_t kv_desc = wgmma_desc(kv_s, 16, 8 * T::SW, T::LAYOUT);
    const uint64_t v_desc =
        wgmma_desc(kv_s + KV_BYTES, BC * T::SW, 8 * T::SW, T::LAYOUT);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float s[BC / 2];
    uint32_t pa[BC / 16][4];

    // S = Q K^T of the tile in `stage` (not waited for).
    auto issue_s = [&](int stage) {
      const uint64_t off = (stage * 2 * KV_BYTES) >> 4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / T::CHUNK, w = kk * 16 % T::CHUNK;
        wgmma_ss<BC>(s, q_desc + ((c * WG_BQ * T::SW + w * 2) >> 4),
                      kv_desc + off + ((c * BC * T::SW + w * 2) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in `stage`, 16 keys a step: V rows 16k.. start
    // 16k * SW bytes on (not waited for).
    auto issue_pv = [&](int stage) {
      const uint64_t off = (stage * 2 * KV_BYTES) >> 4;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], v_desc + off + ((kk * 16 * T::SW) >> 4));
      wgmma_commit();
    };
    // Mask S where the tile at key kt needs it and turn it into
    // probabilities against the new running max (kept on raw scores: the
    // scale is positive), one FFMA and one ex2 a score; returns the
    // factors the rows' earlier sums shrink by. Fragment element 4n + i
    // is key kt + 8n + 2 tig + (i & 1) of row r0 (i < 2) or r1.
    auto softmax = [&](int kt, float& c0, float& c1) {
      const bool masked = kt + BC > p.sk ||
                          (p.causal && kt + BC - 1 > wq_first) ||
                          (p.window >= 0 && wq_last - kt >= p.window);
      if (masked) {
#pragma unroll
        for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!allowed(p.sk, p.causal, p.window, i < 2 ? qp0 : qp1,
                         kt + n * 8 + tig * 2 + (i & 1)))
              s[4 * n + i] = NEG_INF;
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float sl2 = p.scale_log2;
      const float b0 = fmaxf(mn0, M_FLOOR) * sl2, b1 = fmaxf(mn1, M_FLOOR) * sl2;
      c0 = ex2(fminf(m0 - mn0, 0.f) * sl2);
      c1 = ex2(fminf(m1 - mn1, 0.f) * sl2);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        s[4 * n] = ex2(fmaf(s[4 * n], sl2, -b0));
        s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], sl2, -b0));
        s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], sl2, -b1));
        s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], sl2, -b1));
        sum0 += s[4 * n] + s[4 * n + 1];
        sum1 += s[4 * n + 2] + s[4 * n + 3];
      }
      l0 = l0 * c0 + quad_sum(sum0);
      l1 = l1 * c1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
    };
    // P rounded to bf16: n-tiles 2k, 2k + 1 of S are the A fragment of
    // k-step k (16 keys).
    auto pack_p = [&] {
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        pa[n / 2][(n & 1) * 2] = pack_bf16(s[4 * n], s[4 * n + 1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
      }
    };

    // The tiles this warpgroup computes are [tb, te) of the block's; the
    // others (past its diagonal, before its window) it only releases.
    int tb = 0, te = 0;
    if (live && whi > wlo) {
      tb = max(0, wlo / BC - t0);
      te = min(ntiles, (whi + BC - 1) / BC - t0);
    }
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&] {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto release = [&] {
      mbar_wait(full(stage), phase);
      mbar_arrive(empty(stage));
      advance();
    };

    mbar_wait(q_full, 0);
    for (int t = 0; t < tb; ++t) release();
    if (tb < te) {
      // Tile tb alone, then each tile's S = Q K^T issued together with the
      // previous tile's P V: the softmax runs while P V does.
      float c0, c1;
      mbar_wait(full(stage), phase);
      wgmma_fence();
      issue_s(stage);
      wgmma_wait<0>();
      fence_regs(s);
      softmax((t0 + tb) * BC, c0, c1);
      pack_p();
      int prev = stage;
      advance();
      for (int t = tb + 1; t < te; ++t) {
        mbar_wait(full(stage), phase);
        fence_regs(o);
        wgmma_fence();
        issue_s(stage);
        issue_pv(prev);
        wgmma_wait<1>();
        fence_regs(s);
        softmax((t0 + t) * BC, c0, c1);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty(prev));
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n] *= c0;
          o[4 * n + 1] *= c0;
          o[4 * n + 2] *= c1;
          o[4 * n + 3] *= c1;
        }
        pack_p();
        prev = stage;
        advance();
      }
      fence_regs(o);
      wgmma_fence();
      issue_pv(prev);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(prev));
    }
    for (int t = te; t < ntiles; ++t) release();

    // Scale by 1 / l, round once, store rows inside Sq.
    const float d0 = 1.f / fmaxf(l0, L_FLOOR), d1 = 1.f / fmaxf(l1, L_FLOOR);
    const int64_t base = b * p.ob + kvh * p.okvh + h * p.og;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= p.sq) continue;
        const float a = o[4 * n + 2 * half] * (half ? d1 : d0);
        const float bb = o[4 * n + 2 * half + 1] * (half ? d1 : d0);
        const int64_t i = base + r * p.os + c;
        if (p.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + i) =
              __floats2bfloat162_rn(a, bb);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + i) =
              make_float2(a, bb);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// FMA variant (fp32 or bf16 inputs, D and Dv up to 256).
// ---------------------------------------------------------------------------

constexpr int FMA_ROWS = 4;                       // query rows a warp
constexpr int FMA_BQ = FMA_ROWS * (THREADS / 32); // 16 rows a block
constexpr int FMA_BKT = 32;                       // keys a tile: a lane each
constexpr int FMA_DMAX = 256;                     // the larger bound

// Shared memory of the tiles at head-size bound DMAX: the block's q rows,
// a tile of k rows (one float more a row: lane j reads row j) and of v
// rows, all fp32.
template <int DMAX>
constexpr int fma_smem_bytes() {
  return int(sizeof(float)) *
         (FMA_BQ * DMAX + FMA_BKT * (DMAX + 1) + FMA_BKT * DMAX);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fma_kernel(Params p) {
  extern __shared__ __align__(16) float fma_smem[];
  auto qs = reinterpret_cast<float (*)[DMAX]>(fma_smem);
  auto kf = reinterpret_cast<float (*)[DMAX + 1]>(fma_smem + FMA_BQ * DMAX);
  auto vf = reinterpret_cast<float (*)[DMAX]>(
      fma_smem + FMA_BQ * DMAX + FMA_BKT * (DMAX + 1));

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

  float acc[FMA_ROWS][DMAX / 32];
  float m[FMA_ROWS], l[FMA_ROWS];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DMAX / 32; ++j) acc[r][j] = 0.f;
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
      for (int j = 0; j < DMAX / 32; ++j) acc[r][j] *= corr;
      for (int kk = 0; kk < FMA_BKT; ++kk) {
        const float pk = __shfl_sync(FULL, pr, kk);
#pragma unroll
        for (int j = 0; j < DMAX / 32; ++j) {
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
    for (int j = 0; j < DMAX / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < p.dv)
        store1(p, out0 + int64_t(row) * p.dv + c, acc[r][j] / den);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return rc == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first: D, S, then the
// outer ones), strides in elements, boxes of (CHUNK, rows, 1, ...).
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int rank,
                const int64_t* dims, const int64_t* strides, int rows) {
  using T = Tile<D>;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t box[5], ones[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = cuuint64_t(dims[i]);
    box[i] = i == 0 ? T::CHUNK : i == 1 ? rows : 1;
    ones[i] = 1;
    if (i > 0) gstride[i - 1] = cuuint64_t(strides[i - 1]) * 2;
  }
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), gdim, gstride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BC, int STAGES>
int launch_wgmma(const void* q, const void* k, const void* v, int64_t batch,
                 const int64_t* q_strides, const int64_t* k_strides,
                 const int64_t* v_strides, dim3 grid, const WgParams& p,
                 cudaStream_t stream) {
  // Dimensions innermost first; strides (elements) of S and the outer
  // dimensions; the callers' arrays run outermost first (b, kvh[, g], s).
  const int64_t qdims[5] = {D, p.sq, p.g, p.kvh, batch};
  const int64_t qstr[4] = {q_strides[3], q_strides[2], q_strides[1],
                           q_strides[0]};
  const int64_t kdims[4] = {D, p.sk, p.kvh, batch};
  const int64_t kstr[3] = {k_strides[2], k_strides[1], k_strides[0]};
  const int64_t vstr[3] = {v_strides[2], v_strides[1], v_strides[0]};
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map<D>(&qmap, q, 5, qdims, qstr, WG_BQ) ||
      !tensor_map<D>(&kmap, k, 4, kdims, kstr, BC) ||
      !tensor_map<D>(&vmap, v, 4, kdims, vstr, BC))
    return int(cudaErrorInvalidValue);
  constexpr int smem = wg_smem_bytes<D, BC, STAGES>();
  // The shared-memory attribute is set once a device (bit `device` of
  // `set_on`), not at every launch.
  static std::atomic<uint64_t> set_on{0};
  int device = 0;
  const cudaError_t dev = cudaGetDevice(&device);
  if (dev != cudaSuccess) return int(dev);
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  if (!(set_on.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, BC, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return int(attr);
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  flash_wgmma_kernel<D, BC, STAGES><<<grid, WG_THREADS, smem, stream>>>(
      qmap, kmap, vmap, p);
  return int(cudaGetLastError());
}

// The FMA variant at head-size bound DMAX, its tiles in dynamic shared
// memory (the attribute set once a device, as for the wgmma variant).
template <typename T, int DMAX>
int launch_fma(dim3 grid, const Params& p, cudaStream_t stream) {
  constexpr int smem = fma_smem_bytes<DMAX>();
  static std::atomic<uint64_t> set_on{0};
  int device = 0;
  const cudaError_t dev = cudaGetDevice(&device);
  if (dev != cudaSuccess) return int(dev);
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  if (!(set_on.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_fma_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return int(attr);
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  flash_fma_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// Variant 1 (wgmma: bf16, d == dv in {32, 64, 128}): q and out are
// (batch, kvh, g, sq, d) views and k, v (batch, kvh, sk, d) views, with
// element strides outermost first (q_strides / o_strides: b, kvh, g, s;
// k_strides / v_strides: b, kvh, s), D contiguous. Variant 0 (FMA: d, dv
// <= 256, dtype 0 = float32 or 1 = bfloat16) takes the contiguous kernel
// layout, q [batch * kvh, g, sq, d], k [batch * kvh, sk, d], v [..., dv],
// out [batch * kvh, g, sq, dv], and ignores the strides. out_dtype 0 =
// float32, 1 = bfloat16; window < 0: none. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for arguments no variant takes).
extern "C" __attribute__((visibility("default"))) int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int64_t batch,
    int32_t kvh, int32_t g, int32_t sq, int32_t sk, int32_t d, int32_t dv,
    const int64_t* q_strides, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* o_strides, int32_t dtype,
    int32_t out_dtype, int32_t variant, int32_t causal, int32_t window,
    int32_t q_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = batch * kvh * g;
  if (variant == 1) {
    if (dtype != 1 || d != dv) return int(cudaErrorInvalidValue);
    const WgParams p{out, o_strides[0], o_strides[1], o_strides[2],
                     o_strides[3], kvh, g, sq, sk, causal, window, q_offset,
                     out_dtype == 1, scale * 1.4426950408889634f};
    const dim3 grid(unsigned(rows), unsigned((sq + WG_BQ - 1) / WG_BQ));
    if (d == 128)
      return launch_wgmma<128, 96, 3>(q, k, v, batch, q_strides, k_strides,
                                  v_strides, grid, p, s);
    if (d == 64)
      return launch_wgmma<64, 128, 3>(q, k, v, batch, q_strides, k_strides,
                                 v_strides, grid, p, s);
    if (d == 32)
      return launch_wgmma<32, 128, 3>(q, k, v, batch, q_strides, k_strides,
                                 v_strides, grid, p, s);
    return int(cudaErrorInvalidValue);
  }
  if (d > FMA_DMAX || dv > FMA_DMAX) return int(cudaErrorInvalidValue);
  const Params p{q, k, v, out, g, sq, sk, d, dv, causal, window, q_offset,
                 out_dtype == 1, scale};
  const dim3 grid(unsigned(rows), unsigned((sq + FMA_BQ - 1) / FMA_BQ));
  const bool wide = d > 128 || dv > 128;
  if (dtype == 0)
    return wide ? launch_fma<float, 256>(grid, p, s)
                : launch_fma<float, 128>(grid, p, s);
  return wide ? launch_fma<__nv_bfloat16, 256>(grid, p, s)
              : launch_fma<__nv_bfloat16, 128>(grid, p, s);
}
