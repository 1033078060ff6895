// flash_attention's backward pass, bf16 on Hopper's tensor cores (sm_90a):
// the gradients of grouped-query attention, causal with a per-layer
// sliding window or the prefix-LM mask, or bidirectional over a key set of
// its own length (cross-attention), with ragged tails, given the forward's
// output O and its rows' log-sum-exp. The bf16 variant of the port's
// attention backward, for head_dim 64, 96, 128 and 256 and MLA's (192,
// 128) (f32, and bf16 at head_dim 32, run csrc/flash_attention_bwd.cu).
//
// The JAX package has no backward Pallas kernel: its training
// differentiates chunked_attention (src/repro/models/attention.py) with
// XLA. The port's forward is flash_attention_tc.cu (the replacement of
// flash_attention_pallas in src/repro/kernels/flash_attention/kernel.py),
// and this is its backward: FlashAttention-2's formulas, as
// flash_attention_bwd.cu's header states them, with P and dS rounded to
// bf16 as the operands of the products that take them (the function of
// flash_attention_bwd_plain(..., operands="bf16")):
//   D  = rowsum(dO o O),  P = exp(Q K^T * scale - lse) under the mask
//   dV = P^T dO,  dS = P o (dO V^T - D),  dK = dS^T Q * scale,
//   dQ = dS K * scale
// q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, DV), o/dO (B, Sq, H,
// DV) bf16, DV = D except in MLA's mode (D = 192, DV = 128); head h reads
// kv head h / (H / KVH); causal (Sk = Sq): key kp is visible to row qp iff
// kp <= qp and, when window > 0, qp - window < kp; prefix-LM (PaliGemma's,
// flash_mask.cuh): also iff qp, kp < P; not causal: every key kp < Sk;
// lse (B, H, Sq) f32; gradients bf16.
//
// Bound on the H100. Five products of the (causal, windowed) score
// matrix's size, 2.5x the forward's matmul work (2 (3 D + 2 DV) flops a
// visible pair in MLA's mode): bound by the bf16 tensor cores (989
// TFLOP/s) at every training shape the paths run: Hymba (B 2, S 2176,
// 25/5 x 64) 0.077 ms, Phi-3-mini (B 2, S 2048, 32/32 x 96) 0.130 ms,
// Qwen3-1.7B (16/8 x 128) 0.087 ms, DeepSeek-V3's MLA layer (B 8, S 2048,
// 128/128) 3.615 ms. Cross-attention at MusicGen's shape (B 2, Sq 1500,
// Sk 64, 24 heads x 64) is bound by bytes (q, o, dO, dQ). Beside that
// work, every (key block, query tile) pair reloads the tile's Q and dO and
// adds 64 rows of dQ into an f32 accumulator, so both scale with Sk over
// the keys a block owns: at MLA's layer and 64 keys a block, 26.6 GB of
// reductions and 22 GB of reloads, which only the L2 can carry.
//
// Design: three kernels a call.
//  * fbt_prep: one warp per (b, h, row): D = rowsum(dO o O) and the
//    row's lse * log2(e) side by side in an f32 (B, H, Sp, 2) array
//    (Sp = Sq rounded up to 64; padding rows get lse = 1e30, so P = 0),
//    and the row of the f32 dQ accumulator (B, H, Sp, D) zeroed.
//  * the main kernel, one block per (b, query head h, key block): a
//    producer warpgroup (setmaxnreg lowers it to 24 registers; one thread
//    issues every copy) loads the block's K and V once by TMA, then
//    streams 64-row Q and dO tiles (128-byte swizzle) with their rows'
//    (lse, D) through a ring of shared-memory stages guarded by full /
//    empty mbarriers, from the first query tile that sees one of the
//    block's keys (its diagonal, causal; row 0 for a key block that
//    starts in the prefix, or cross) to the window's far edge or the last
//    row. Two consumer warpgroups (240 registers each) do the products.
//    The block order keeps the dQ accumulator in L2: the B x H heads go
//    in as few chunks of equal size as keep a chunk's dQ rows, Q and dO
//    within FBT_L2_BUDGET, and each chunk's blocks run key block first
//    (the longest causal walks first) across its heads, so the ~132
//    resident blocks share a few heads' rows instead of each walking a
//    head of its own. At DeepSeek-V3's MLA layer that order takes the
//    call from 34.9 ms (every head one chunk: key block 0 of each head
//    first) to 13.4; chunks of equal size keep a
//    short last chunk from starting its longest walks late (0.36 against
//    0.33 ms at Hymba's training shape; kernels.ablate --backward,
//    PERF.md).
//    Per query tile, on the accumulator fragments of a warpgroup's keys:
//      S^T = K Q^T and dP^T = V dO^T: wgmma, both operands K-major, in
//        two commit groups, so that the exp starts while dP^T runs;
//      P^T = exp2(S^T scale log2e - lse log2e), masked only on the tiles
//        that straddle the diagonal (or the prefix's end), the window's
//        edge or Sk (a key past Sk is a zero-filled row of K and V, whose
//        P would be exp2(-lse log2e), not 0); dS^T = P^T o (dP^T - D): P
//        is computed once for dV, dK and dQ;
//      dV += P^T dO, dK += dS^T Q; dQ = dS K: dS^T goes to shared memory
//        as bf16 (swizzled) and is read back as an MN-major A operand
//        against the MN-major K tile; the f32 dQ rows are staged in
//        32-column pieces (8 KB, 128-byte swizzle) and each piece is added
//        into the accumulator by one TMA tensor reduction
//        (cp.reduce.async.bulk.tensor .add, a 32 x 64 f32 box): row by
//        row, 64 bulk reductions a tile and warpgroup, those adds took
//        about half of a main kernel's time (two thirds at MLA's layer);
//        as tensor reductions, under 7% of a call's (kernels.ablate
//        --backward, PERF.md).
//    When the query heads of a KV head are one (H = KVH: MLA, Phi-3,
//    MusicGen), the block writes its dK (scaled) and dV in bf16 itself;
//    with a group of G > 1 heads it writes f32 per-query-head partials (B,
//    Sk, H, D), which fbt_finish sums in a fixed order.
//  * fbt_finish: dQ = scale * accumulator; at G > 1 also dK = scale * (the
//    group's G partials summed in order) and dV unscaled; to bf16.
// dK and dV are the same from run to run; dQ's additions from the key
// blocks arrive in the order the blocks run, so its last bits vary.
//
// fbt_main128<D> (head_dim 64, 96, 128): the block owns 128 keys, 64 a
// consumer warpgroup, which halves the (key block, query tile) pairs of a
// 64-key block and so the dQ reductions and the Q / dO reloads. Each
// warpgroup keeps its keys' dK and dV (D columns each) in registers, forms
// S^T and dP^T (64 keys x 64 rows, 32 registers each) and issues dV, dK
// from registers (P^T, dS^T as wgmma's A operand, dO and Q MN-major from
// the stage). Both halves of dS^T (128 keys) meet in shared memory, double
// buffered so that one named barrier a tile suffices, and dQ (64 rows x
// D, 128 keys deep) is split by columns: warpgroup 0 takes columns 0..63
// and warpgroup 1 the rest (32 + 32 at D = 64, the second at a 64-byte
// offset into the swizzled K rows). D = 96 runs at its true width: S^T
// and dP^T 6 steps deep, dV, dK and dQ's second column block at N = 32
// (the tensor maps' innermost extent is 96; TMA fills the 64-wide box's
// last 32 columns with zeros that no product reads). Every tile of a walk
// is computed, those on which a warpgroup's keys are all masked too
// (they give zeros): skipping them put that warpgroup's wgmmas on a
// divergent path, and ptxas then serialized every wgmma of the kernel
// (C7520), the D = 128 instantiations also spilling. Leaving a tile's dQ
// product in flight over the next tile's S^T and dP^T was slower in turns
// (and serialized at D = 128), and so was a second warpgroup that skips
// its products when its keys all lie past Sk (faster only at MusicGen's
// 64 cross-attention keys, serialized). Ring depth 4 at D = 64
// (Fbt128<64>::BYTES = 166,984), 2 at 96 and 128 (198,696): a third
// stage fits there (231,992) but was no faster in turns at Phi-3's and
// Qwen3's training shapes (kernels.ablate --backward, PERF.md). One
// warpgroup on 64 keys, two blocks an SM, was slower at head_dim 64 too,
// in turns at Hymba's and MusicGen's training shapes (PERF.md).
//
// fbt_mla (MLA's D = 192, DV = 128): 128 keys' dK and dV would take 160
// f32 registers a thread beside S^T and dP^T, so the block owns 64 keys and
// the two consumer warpgroups share them, as fbt_main256 does: S^T (12
// steps deep) and dP^T (8) split over the query columns (32 rows each,
// 16 registers), P^T and dS^T meet in shared memory (bf16, double
// buffered), and the 64-column blocks of dK (3), dV (2) and dQ (3) are
// dealt out four a warpgroup: warpgroup 0 dK 0, 1 and dQ 0, 1; warpgroup
// 1 dK 2, dV 0, 1 and dQ 2 (64 and 96 accumulator registers), every
// product a whole swizzle atom wide (a 96 / 96 deal with half blocks at
// N = 32 was slower in turns). FbtMla::BYTES = 206,888.
//
// D = 256 (PaliGemma) has a main kernel of its own, fbt_main256, which
// this design leaves as it was. In one warpgroup the dK and dV
// fragments alone would take 256 f32 registers a thread, and a 2-stage
// ring of Q and dO 128 KB beside 64 KB of K and V. So two consumer
// warpgroups share the 64 keys:
//  * each owns 128 of dK's and dV's 256 columns (2 x 2 x 32 = 128
//    registers a thread);
//  * S^T and dP^T are split over the query columns: warpgroup w forms
//    keys x rows 32w..32w+31 (wgmma m64n32k16, 16 registers each), and
//    P^T and dS^T meet in shared memory as bf16 (128-byte swizzle), from
//    where both warpgroups read them as wgmma's A operand for
//    dV += P^T dO and dK += dS^T Q on their own columns;
//  * dQ = dS K is formed a 64-column block at a time on each warpgroup's
//    columns and staged for the row-wise bulk reduction in 32-column
//    pieces (64 rows x 128 bytes a warpgroup, unpadded);
//  * shared memory: K, V 64 KB; Q and dO in 2 stages 128 KB; P^T and dS^T
//    16 KB; dQ pieces 16 KB; (lse, D) rows 1 KB; barriers and the 1 KB
//    alignment pad: Fbt256::BYTES = 231,464 of 232,448;
//  * 384 threads: two consumer warpgroups and a producer warpgroup, one
//    thread of which issues the copies. At 288 threads (a producer warp)
//    ptxas capped every thread at 168 registers and spilled ~300 bytes;
//    here setmaxnreg moves registers from the producer (40) to the
//    consumers (232), as head_select_tc.cu does.
// It keeps the (H, B, key tile) grid and the f32 partials at every G
// (MQA: PaliGemma's 8 query heads on one KV head).
//
// Registers (ptxas, sm_90a; build/kernels/libflash_attention_bwd_tc-*.log):
// each of the 12 instantiations of fbt_main128 (D 64, 96, 128 x the three
// masks) and fbt_mla (x3) reports 168 registers a thread at launch, the
// launch bound of 384 threads (setmaxnreg then gives the consumers 240),
// and 0 bytes of spill stores and loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace idkd {

constexpr int FBT_TILE = 64;        // query rows per tile; keys a warpgroup
constexpr int FBT_BLK = FBT_TILE * 128;   // 64 rows x 64 bf16 columns
constexpr int FBT_STAGES = 2;       // fbt_main256's Q / dO ring depth
constexpr int FBT_CONSUMERS = 128;  // threads of a consumer warpgroup
constexpr float FBT_LOG2E = 1.4426950408889634f;
constexpr long long FBT_L2_BUDGET = 24ll << 20;   // a chunk's dQ, Q, dO

// fbt_main128's shared memory: K and V of 128 keys (two 64-key halves),
// the Q / dO ring, dS^T of 128 keys in two buffers, a dQ staging area a
// warpgroup, the (lse, D) rows, the barriers.
template <int D>
struct Fbt128 {
  static constexpr int NB = (D + 63) / 64;       // 64-column blocks a row
  static constexpr int TILE = NB * FBT_BLK;      // 64 rows of q, k, v, dO
  static constexpr int NST = D == 64 ? 4 : 2;    // Q / dO ring depth
  static constexpr int DQ0 = D == 64 ? 32 : 64;  // warpgroup 0's dQ columns
  static constexpr int K = 0;                    // keys 0..63, then 64..127
  static constexpr int V = 2 * TILE;
  static constexpr int STAGES = 4 * TILE;        // stage s: Q, then dO
  static constexpr int DS = STAGES + NST * 2 * TILE;
  static constexpr int DQ = DS + 4 * FBT_BLK;    // 2 pieces a warpgroup
  static constexpr int LD = DQ + 4 * FBT_BLK;
  static constexpr int BAR = LD + NST * FBT_TILE * 8;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NST) + 1024;
  static constexpr int THREADS = 384;            // 2 consumer + 1 producer
  static constexpr int CONSUMERS = 256;
  static_assert(DS % 1024 == 0 && DQ % 1024 == 0 && LD % 16 == 0 &&
                    BYTES <= 232448,
                "swizzled tiles on 1024 bytes, bulk copies on 16, and the "
                "H100's shared memory a block");
};

// fbt_mla's: K (3 column blocks) and V (2) of 64 keys, the ring, P^T and
// dS^T in two buffers, the dQ staging of warpgroup 0 (128 columns: 4
// pieces) and 1 (64: 2), the (lse, D) rows, the barriers.
struct FbtMla {
  static constexpr int D = 192, DV = 128;
  static constexpr int TK = 3 * FBT_BLK, TV = 2 * FBT_BLK;
  static constexpr int K = 0, V = TK;
  static constexpr int STAGE = TK + TV;          // Q, then dO
  static constexpr int NST = 2;
  static constexpr int STAGES = TK + TV;
  static constexpr int PS = STAGES + NST * STAGE;   // buffer b: P^T, dS^T
  static constexpr int DQ = PS + 4 * FBT_BLK;      // 8 KB pieces
  static constexpr int LD = DQ + 6 * FBT_BLK;
  static constexpr int BAR = LD + NST * FBT_TILE * 8;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NST) + 1024;
  static constexpr int THREADS = 384;
  static constexpr int CONSUMERS = 256;
  static_assert(PS % 1024 == 0 && DQ % 1024 == 0 && LD % 16 == 0 &&
                    BYTES <= 232448,
                "swizzled tiles on 1024 bytes, bulk copies on 16, and the "
                "H100's shared memory a block");
};

// D and lse * log2(e) per (b, h, row), rows padded to Sp; the dQ
// accumulator's rows zeroed. One warp per row. O and dO rows are DV long,
// dQ's D.
template <int D, int DV = D>
__global__ void __launch_bounds__(256)
fbt_prep(const __nv_bfloat16* __restrict__ o,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, float2* __restrict__ ld,
         float* __restrict__ dq_acc, long long rows, int Sq, int Sp, int H) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = (int)(row % Sp);
  const long long bh = row / Sp;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  float acc = 0.0f;
  if (s < Sq) {
    const size_t off = (((size_t)b * Sq + s) * H + h) * DV;
#pragma unroll
    for (int d = 2 * lane; d < DV; d += 64) {
      const float2 ov = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + off + d));
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
      acc = fmaf(ov.x, gv.x, fmaf(ov.y, gv.y, acc));
    }
  }
#pragma unroll
  for (int k = 16; k > 0; k /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, k);
  float* z = dq_acc + (size_t)row * D;
#pragma unroll
  for (int d = 2 * lane; d < D; d += 64)
    *reinterpret_cast<float2*>(z + d) = make_float2(0.0f, 0.0f);
  if (lane == 0)
    ld[row] = s < Sq ? make_float2(lse[(size_t)bh * Sq + s] * FBT_LOG2E, acc)
                     : make_float2(1e30f, 0.0f);
}

// D (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem);
// B MN-major (transposed) bf16 with 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// wgmma m64nNk16, both operands in shared memory, N = 64 or 32.
template <int N, int TA, int TB>
__device__ __forceinline__ void fbt_mma_ss(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16_ss<TA, TB>(d, da, db, scale_d);
  else
    wgmma_m64n32k16_ss<TA, TB>(d, da, db, scale_d);
}

// A warpgroup's 64 rows x D columns of f32 accumulator fragments: D / 64
// whole 64-column blocks (32 registers a thread each) and, at D = 96, a
// 32-column tail (16).
template <int D>
struct FbtAcc {
  static constexpr int NF = D / 64, TN = D % 64;
  float f[NF][32];
  float t[TN ? TN / 2 : 1];
};

template <int D>
__device__ __forceinline__ void fbt_zero(FbtAcc<D>& a) {
#pragma unroll
  for (int nb = 0; nb < FbtAcc<D>::NF; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) a.f[nb][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < FbtAcc<D>::TN / 2; ++i) a.t[i] = 0.0f;
}

template <int D>
__device__ __forceinline__ void fbt_fence(FbtAcc<D>& a) {
#pragma unroll
  for (int nb = 0; nb < FbtAcc<D>::NF; ++nb) fence_regs(a.f[nb]);
  if constexpr (FbtAcc<D>::TN > 0) fence_regs(a.t);
}

// One wgmma per 16 head dims: acc (64 x N) = A B^T with A the 64-row and
// B the N-row K-major tiles (keys against query rows), D dims deep.
template <int D, int N = 64>
__device__ __forceinline__ void fbt_scores(float (&acc)[N / 2],
                                           const uint8_t* A,
                                           const uint8_t* Bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * FBT_BLK + (kk % 4) * 32;
    fbt_mma_ss<N, 0, 0>(acc, sw128_desc(A + off, 16),
                        sw128_desc(Bt + off, 16), kk > 0);
  }
}

// acc (64 keys x D) += A (64 keys x 64 rows, registers) . T (64 rows x D,
// MN-major from a TMA tile), the tail block at N = 32.
template <int D>
__device__ __forceinline__ void fbt_accumulate(FbtAcc<D>& acc,
                                               const uint32_t (&a)[4][4],
                                               const uint8_t* T) {
#pragma unroll
  for (int nb = 0; nb < FbtAcc<D>::NF; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs_tb(
          acc.f[nb], a[kk],
          sw128_desc(T + nb * FBT_BLK + kk * 16 * 128, 1024), 1);
  if constexpr (FbtAcc<D>::TN > 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n32k16_rs_tb(
          acc.t, a[kk],
          sw128_desc(T + FbtAcc<D>::NF * FBT_BLK + kk * 16 * 128, 1024), 1);
  }
}

// The query tile a key tile's walk starts from: its own (causal), row 0
// for a tile that starts in the prefix (prefix-LM) or for cross-attention.
#define FBT_FIRST_TILE(MODE, kt, k0, prefix)                        \
  ((MODE) == FA_CAUSAL  ? (kt)                                       \
   : (MODE) == FA_CROSS ? 0                                          \
                        : fa_first_row((k0), (prefix)) / FBT_TILE)

// Whether query tile t (rows q0..q0 + 63) against key tile kt (keys
// k0..k0 + 63) holds a masked pair: the diagonal tile or the window's edge
// (causal), keys past Sk (cross), a key the tile's first row does not see
// (prefix-LM); and whether (row qp, key kp) is masked on such a tile. As
// expressions of the mode, so that each instantiation compiles the code
// it always had.
#define FBT_NEED_MASK(MODE)                                               \
  ((MODE) == FA_CAUSAL                                                    \
       ? t == kt || (window > 0 && q0 + FBT_TILE - 1 - k0 >= window)      \
   : (MODE) == FA_CROSS ? k0 + FBT_TILE > Sk                              \
                        : k0 + FBT_TILE - 1 > fa_last_key(q0, prefix))
#define FBT_MASKED(MODE, qp, kp)                                          \
  ((MODE) == FA_CAUSAL                                                    \
       ? (kp) > (qp) || (window > 0 && (qp) - (kp) >= window)             \
   : (MODE) == FA_CROSS ? (kp) >= Sk                                      \
                        : (kp) > fa_last_key((qp), prefix))

// The 64 keys from kw0 against the 64 rows from q0: whether the tile
// holds a masked pair or keys past Sk (FBT_NEED_MASK's cases, for keys
// that need not start a tile of their own).
template <int MODE>
__device__ __forceinline__ bool fbt_tile_masked(int q0, int kw0, int Sk,
                                                int window, int prefix) {
  if (MODE == FA_CAUSAL)
    return kw0 + FBT_TILE - 1 > q0 ||
           (window > 0 && q0 + FBT_TILE - 1 - kw0 >= window);
  if (MODE == FA_CROSS) return kw0 + FBT_TILE > Sk;
  return kw0 + FBT_TILE - 1 > fa_last_key(q0, prefix);
}

// The block's (b, h, key block) in the L2-friendly order: the B x H heads
// in chunks of `chunk`, each chunk's blocks key block first across its
// heads (key block 0, the longest causal walk, first).
struct FbtBlock {
  int b, h, kb;
};
__device__ __forceinline__ FbtBlock fbt_block(int nkb, int BH, int H,
                                              int chunk) {
  const int per = chunk * nkb;
  const int c = (int)blockIdx.x / per, rem = (int)blockIdx.x % per;
  const int n = min(chunk, BH - c * chunk);   // the last chunk's heads
  const int bh = c * chunk + rem % n;
  return {bh / H, bh % H, rem / n};
}

// The thread's two key rows of N columns from d0 (its column pair c2
// included): bf16, scaled by s, into out at element offsets oa, ob (the
// rows' column 0), when out is given; else f32 into part at pa, pb.
template <int N>
__device__ __forceinline__ void fbt_store(const float (&acc)[N / 2], int d0,
                                          float s, __nv_bfloat16* out,
                                          float* part, size_t oa, size_t ob,
                                          bool va, bool vb) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int d = d0 + 8 * j;
    if (out != nullptr) {
      if (va)
        *reinterpret_cast<uint32_t*>(out + oa + d) =
            pack_bf16x2(acc[4 * j] * s, acc[4 * j + 1] * s);
      if (vb)
        *reinterpret_cast<uint32_t*>(out + ob + d) =
            pack_bf16x2(acc[4 * j + 2] * s, acc[4 * j + 3] * s);
    } else {
      if (va)
        *reinterpret_cast<float2*>(part + oa + d) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (vb)
        *reinterpret_cast<float2*>(part + ob + d) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The thread's 16 bf16 pairs of a 64 x 64 tile (rows r_a, r_b = key
// rows, 64 query columns) into a 128-byte-swizzled block: fragment
// element 4j + e is row r_a (e < 2) or r_b, column 8j + c2 + (e & 1).
__device__ __forceinline__ void fbt_put(uint8_t* T, const uint32_t (&a)[4][4],
                                        int r_a, int r_b, int c2) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = x & 1 ? r_b : r_a, chunk = 2 * kk + (x >> 1);
      *reinterpret_cast<uint32_t*>(T + row * 128 +
                                   ((chunk ^ (row & 7)) << 4) + 2 * c2) =
          a[kk][x];
    }
}

// dQ's staging: a warpgroup's 64 rows of f32 in 32-column pieces of 8 KB
// with the 128-byte swizzle, the layout in which the TMA unit reads a 32 x
// 64 f32 box under CU_TENSOR_MAP_SWIZZLE_128B. The thread's pair of
// columns col, col + 1 of row r.
__device__ __forceinline__ void fbt_stage(float* S, int col, int r, float x,
                                          float y) {
  uint8_t* at = reinterpret_cast<uint8_t*>(S) + (col >> 5) * FBT_BLK +
                r * 128 + ((((col & 31) >> 2) ^ (r & 7)) << 4) +
                (col & 3) * 4;
  *reinterpret_cast<float2*>(at) = make_float2(x, y);
}

// Add one staged piece into the dQ accumulator's box at (column c0, row
// c1) of its tensor map: the TMA unit's tensor reduction (add.f32), one
// bulk-group per issuing thread.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile"
      ".bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// A warpgroup's dQ columns col0..col0 + N - 1 of the tile (64 rows) = dS
// (64 rows x 128 keys) . K, then, once dV and dK are done, the stage
// released; then the f32 rows staged in dQs and added into the
// accumulator's rows from row0 by one thread, N / 32 tensor reductions.
template <int D, int N>
__device__ __forceinline__ void fbt_dq128(
    FbtAcc<D>& dk, FbtAcc<D>& dv, const uint8_t* dSb, const uint8_t* K,
    int col0, uint64_t* empty_s, float* dQs, const CUtensorMap* tdq,
    int row0, int bar, int w4, int lane, int r_a, int r_b, int c2) {
  using L = Fbt128<D>;
  float dq[N / 2];
  const int kofs = (col0 / 64) * FBT_BLK + (col0 % 64) * 2;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    fbt_mma_ss<N, 1, 1>(
        dq, sw128_desc(dSb + (kk / 4) * FBT_BLK + (kk % 4) * 16 * 128, 1024),
        sw128_desc(K + (kk / 4) * L::TILE + kofs + (kk % 4) * 16 * 128, 1024),
        kk > 0);
  wgmma_commit();
  wgmma_wait<1>();   // dV and dK
  fbt_fence(dk);
  fbt_fence(dv);
  mbar_arrive(empty_s);   // Q, dO and the (lse, D) rows are read
  wgmma_wait<0>();
  fence_regs(dq);
  // the previous tile's rows have left dQs
  if (w4 == 0) bulk_wait_read<0>();
  named_barrier(bar, FBT_CONSUMERS);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    fbt_stage(dQs, 8 * j + c2, r_a, dq[4 * j], dq[4 * j + 1]);
    fbt_stage(dQs, 8 * j + c2, r_b, dq[4 * j + 2], dq[4 * j + 3]);
  }
  fence_proxy_async();
  named_barrier(bar, FBT_CONSUMERS);
  if (w4 == 0 && lane == 0) {
#pragma unroll
    for (int p = 0; p < N / 32; ++p)
      tma_reduce_add_2d(tdq, dQs + p * FBT_BLK / 4, col0 + 32 * p, row0);
    bulk_commit();
  }
}

// MODE (FA_CAUSAL, FA_CROSS, FA_PREFIX): the mask, a template parameter so
// that the causal kernel's mask and register use stay the self-attention
// kernel's. dk_out, dv_out: the bf16 gradients, written here when H ==
// KVH; else null, and the f32 partials take the block's sums.
template <int D, int MODE>
__global__ void __launch_bounds__(Fbt128<D>::THREADS, 1)
fbt_main128(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdq,
            const float2* __restrict__ ld,
            float* __restrict__ dk_part, float* __restrict__ dv_part,
            __nv_bfloat16* __restrict__ dk_out,
            __nv_bfloat16* __restrict__ dv_out, int Sq, int Sk, int Sp,
            int B, int H, int KVH, int window, float scale_log2,
            float scale, int prefix, int chunk) {
  using L = Fbt128<D>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + L::NST;

  const FbtBlock blk = fbt_block((Sk + 2 * FBT_TILE - 1) / (2 * FBT_TILE),
                                 B * H, H, chunk);
  const int b = blk.b, h = blk.h;
  const int k0 = blk.kb * 2 * FBT_TILE;
  const int kvh = h / (H / KVH);
  const int k_last = min(k0 + 2 * FBT_TILE, Sk) - 1;
  const int q_last = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int t_begin = FBT_FIRST_TILE(MODE, k0 / FBT_TILE, k0, prefix),
            t_end = q_last / FBT_TILE;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ------------------------------------------- producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x == L::CONSUMERS) {
      mbar_expect_tx(kv_full, 4 * L::TILE);   // keys past Sk: TMA's zeros
      for (int w = 0; w < 2; ++w)
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(smem + L::K + w * L::TILE + nb * FBT_BLK, &tk, kv_full,
                      nb * 64, kvh, k0 + w * FBT_TILE, b);
          tma_load_4d(smem + L::V + w * L::TILE + nb * FBT_BLK, &tv, kv_full,
                      nb * 64, kvh, k0 + w * FBT_TILE, b);
        }
      const float2* ld_bh = ld + ((size_t)b * H + h) * Sp;
      for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
        const int s = i % L::NST;
        mbar_wait(&empty[s], ((i / L::NST) & 1) ^ 1);
        uint8_t* Qs = smem + L::STAGES + s * 2 * L::TILE;
        mbar_expect_tx(&full[s], 2 * L::TILE + FBT_TILE * 8);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(Qs + nb * FBT_BLK, &tq, &full[s], nb * 64, h,
                      t * FBT_TILE, b);
          tma_load_4d(Qs + L::TILE + nb * FBT_BLK, &tdo, &full[s], nb * 64,
                      h, t * FBT_TILE, b);
        }
        bulk_load(smem + L::LD + s * FBT_TILE * 8, ld_bh + t * FBT_TILE,
                  FBT_TILE * 8, &full[s]);
      }
    }
    return;
  }

  // ------------------------------------------- consumer warpgroups
  setmaxnreg_inc<240>();
  const int wg = warp / 4, w4 = warp % 4;   // keys k0 + 64wg .. + 63
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r_a = 16 * w4 + g, r_b = r_a + 8;   // the thread's key rows
  const int kw0 = k0 + FBT_TILE * wg;
  const int kp_a = kw0 + r_a, kp_b = kp_a + 8;
  const uint8_t* Ks = smem + L::K + wg * L::TILE;
  const uint8_t* Vs = smem + L::V + wg * L::TILE;
  float* dQs = reinterpret_cast<float*>(smem + L::DQ + wg * 2 * FBT_BLK);
  const int col0 = wg * L::DQ0;   // the warpgroup's first dQ column
  const int row_bh = (b * H + h) * Sp;   // the head's first accumulator row

  FbtAcc<D> dk, dv;
  fbt_zero(dk);
  fbt_zero(dv);

  mbar_wait(kv_full, 0);
  for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
    const int s = i % L::NST;
    mbar_wait(&full[s], (i / L::NST) & 1);
    const uint8_t* Qs = smem + L::STAGES + s * 2 * L::TILE;
    const uint8_t* dOs = Qs + L::TILE;
    const float2* lds =
        reinterpret_cast<const float2*>(smem + L::LD + s * FBT_TILE * 8);
    const int q0 = t * FBT_TILE;
    uint8_t* dSb = smem + L::DS + (i & 1) * 2 * FBT_BLK;   // 128 keys

    // S^T = K Q^T and dP^T = V dO^T, in two commit groups. Every tile of
    // the walk is computed, those whose pairs are all masked too (they
    // give zeros): a warpgroup that skipped its products there put them on
    // a divergent path, and ptxas then serialized every wgmma of the kernel
    float sc[32], dp[32];
    wgmma_fence();
    fbt_scores<D>(sc, Ks, Qs);
    wgmma_commit();
    fbt_scores<D>(dp, Vs, dOs);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P^T on the fragments: element 4j + e is key row r_a (e < 2) or r_b,
    // query column 8j + c2 + (e & 1)
    const bool need_mask = fbt_tile_masked<MODE>(q0, kw0, Sk, window, prefix);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c2 + (e & 1);
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lds[col].x));
        if (need_mask) {
          const int qp = q0 + col, kp = e < 2 ? kp_a : kp_b;
          if (FBT_MASKED(MODE, qp, kp)) p = 0.0f;
        }
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS^T = P^T o (dP^T - D)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] =
            sc[4 * j + e] * (dp[4 * j + e] - lds[8 * j + c2 + (e & 1)].y);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kk][x] = pack_bf16x2(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        da[kk][x] = pack_bf16x2(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }

    // dV += P^T dO, dK += dS^T Q
    fbt_fence(dv);
    fbt_fence(dk);
    wgmma_fence();
    fbt_accumulate<D>(dv, pa, dOs);
    fbt_accumulate<D>(dk, da, Qs);
    wgmma_commit();

    // the warpgroup's half of dS^T into this tile's buffer (bf16, 128-byte
    // swizzle; rows = keys, 64 query columns). The other buffer's last
    // readers, the dQ products of two tiles back, finished before either
    // warpgroup passed the previous tile's barrier.
    fbt_put(dSb + wg * FBT_BLK, da, r_a, r_b, c2);
    fence_proxy_async();
    named_barrier(1, L::CONSUMERS);

    // dQ (64 rows x D) = dS K over the block's 128 keys, split by columns
    if constexpr (2 * L::DQ0 == D)
      fbt_dq128<D, L::DQ0>(dk, dv, dSb, smem + L::K, col0, &empty[s], dQs,
                           &tdq, row_bh + q0, 2 + wg, w4, lane, r_a, r_b,
                           c2);
    else if (wg == 0)
      fbt_dq128<D, L::DQ0>(dk, dv, dSb, smem + L::K, col0, &empty[s], dQs,
                           &tdq, row_bh + q0, 2, w4, lane, r_a, r_b, c2);
    else
      fbt_dq128<D, D - L::DQ0>(dk, dv, dSb, smem + L::K, col0, &empty[s],
                               dQs, &tdq, row_bh + q0, 3, w4, lane, r_a,
                               r_b, c2);
  }
  if (w4 == 0) bulk_wait<0>();

  // the warpgroup's keys of dK (scaled) and dV: bf16 when the group is
  // one head, else f32 into the per-query-head partials (B, Sk, H, D);
  // with H == KVH the two share their layout
  const size_t ra = (((size_t)b * Sk + kp_a) * H + h) * D;
  const size_t rb = ra + 8 * (size_t)H * D;
  const bool va = kp_a < Sk, vb = kp_b < Sk;
#pragma unroll
  for (int nb = 0; nb < FbtAcc<D>::NF; ++nb) {
    fbt_store<64>(dk.f[nb], nb * 64 + c2, scale, dk_out, dk_part, ra, rb, va,
                  vb);
    fbt_store<64>(dv.f[nb], nb * 64 + c2, 1.0f, dv_out, dv_part, ra, rb, va,
                  vb);
  }
  if constexpr (FbtAcc<D>::TN > 0) {
    constexpr int d0 = FbtAcc<D>::NF * 64;
    fbt_store<32>(dk.t, d0 + c2, scale, dk_out, dk_part, ra, rb, va, vb);
    fbt_store<32>(dv.t, d0 + c2, 1.0f, dv_out, dv_part, ra, rb, va, vb);
  }
}

// fbt_mla's consumer warpgroup WG (the header's design): S^T and dP^T on
// query columns 32 WG .. 32 WG + 31, then its four 64-column products:
// WG 0 dK blocks 0, 1 and dQ blocks 0, 1; WG 1 dK block 2, dV blocks 0, 1
// and dQ block 2.
template <int MODE, int WG>
__device__ __forceinline__ void fbt_mla_consumer(
    uint8_t* smem, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    const CUtensorMap* tdq, int row_bh, float* dk_part, float* dv_part,
    __nv_bfloat16* dk_out,
    __nv_bfloat16* dv_out, int b, int h, int k0, int t_begin, int t_end,
    int Sk, int H, int window, float scale_log2, float scale, int prefix) {
  using L = FbtMla;
  constexpr int NK = WG == 0 ? 2 : 1, NV = WG == 0 ? 0 : 2;
  constexpr int NQ = NK, KB0 = WG == 0 ? 0 : 2;   // dK's and dQ's blocks
  const int kt = k0 / FBT_TILE;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r_a = 16 * warp + g, r_b = r_a + 8;   // the thread's key rows
  const int kp_a = k0 + r_a, kp_b = kp_a + 8;
  const uint8_t* Ks = smem + L::K;
  const uint8_t* Vs = smem + L::V;
  float* dQs = reinterpret_cast<float*>(smem + L::DQ + WG * 4 * FBT_BLK);

  float dk[NK][32], dv[NV ? NV : 1][32];
#pragma unroll
  for (int c = 0; c < NK; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = 0.0f;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[c][i] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
    const int s = i % L::NST;
    mbar_wait(&full[s], (i / L::NST) & 1);
    const uint8_t* Qs = smem + L::STAGES + s * L::STAGE;
    const uint8_t* dOs = Qs + L::TK;
    const float2* lds =
        reinterpret_cast<const float2*>(smem + L::LD + s * FBT_TILE * 8);
    const int q0 = t * FBT_TILE;
    uint8_t* PT = smem + L::PS + (i & 1) * 2 * FBT_BLK;
    uint8_t* dST = PT + FBT_BLK;

    // S^T = K Q^T and dP^T = V dO^T on the warpgroup's 32 query rows
    float sc[16], dp[16];
    wgmma_fence();
    fbt_scores<L::D, 32>(sc, Ks, Qs + WG * 32 * 128);
    wgmma_commit();
    fbt_scores<L::DV, 32>(dp, Vs, dOs + WG * 32 * 128);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    const bool need_mask = FBT_NEED_MASK(MODE);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * WG + 8 * j + c2 + (e & 1);
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lds[col].x));
        if (need_mask) {
          const int qp = q0 + col, kp = e < 2 ? kp_a : kp_b;
          if (FBT_MASKED(MODE, qp, kp)) p = 0.0f;
        }
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] *
                        (dp[4 * j + e] - lds[32 * WG + 8 * j + c2 + (e & 1)].y);

    // both warpgroups' halves of P^T and dS^T into this tile's buffer
    // (bf16, 128-byte swizzle, rows = keys); the other buffer's readers
    // finished before the previous tile's barrier
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int chunk = 4 * WG + j;
      const int oa = r_a * 128 + ((chunk ^ (r_a & 7)) << 4) + 2 * c2;
      const int ob = r_b * 128 + ((chunk ^ (r_b & 7)) << 4) + 2 * c2;
      *reinterpret_cast<uint32_t*>(PT + oa) =
          pack_bf16x2(sc[4 * j], sc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(PT + ob) =
          pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dST + oa) =
          pack_bf16x2(dp[4 * j], dp[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dST + ob) =
          pack_bf16x2(dp[4 * j + 2], dp[4 * j + 3]);
    }
    fence_proxy_async();
    named_barrier(1, L::CONSUMERS);

    // dK += dS^T Q and dV += P^T dO on the warpgroup's blocks, then dQ
#pragma unroll
    for (int c = 0; c < NK; ++c) fence_regs(dk[c]);
#pragma unroll
    for (int c = 0; c < NV; ++c) fence_regs(dv[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NK; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 1>(
            dk[c], sw128_desc(dST + kk * 32, 16),
            sw128_desc(Qs + (KB0 + c) * FBT_BLK + kk * 16 * 128, 1024), 1);
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 1>(
            dv[c], sw128_desc(PT + kk * 32, 16),
            sw128_desc(dOs + c * FBT_BLK + kk * 16 * 128, 1024), 1);
    wgmma_commit();
    float dq[NQ][32];
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<1, 1>(
            dq[c], sw128_desc(dST + kk * 16 * 128, 1024),
            sw128_desc(Ks + (KB0 + c) * FBT_BLK + kk * 16 * 128, 1024),
            kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int c = 0; c < NK; ++c) fence_regs(dk[c]);
#pragma unroll
    for (int c = 0; c < NV; ++c) fence_regs(dv[c]);
    mbar_arrive(&empty[s]);   // Q, dO and the (lse, D) rows are read
    wgmma_wait<0>();

    // dQ's rows (NQ blocks from column 64 KB0) staged, then added into
    // the accumulator by one thread, 2 NQ tensor reductions
    if (warp == 0) bulk_wait_read<0>();
    named_barrier(2 + WG, FBT_CONSUMERS);
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      fence_regs(dq[c]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + c2;
        fbt_stage(dQs, d, r_a, dq[c][4 * j], dq[c][4 * j + 1]);
        fbt_stage(dQs, d, r_b, dq[c][4 * j + 2], dq[c][4 * j + 3]);
      }
    }
    fence_proxy_async();
    named_barrier(2 + WG, FBT_CONSUMERS);
    if (warp == 0 && lane == 0) {
#pragma unroll
      for (int p = 0; p < 2 * NQ; ++p)
        tma_reduce_add_2d(tdq, dQs + p * FBT_BLK / 4, 64 * KB0 + 32 * p,
                          row_bh + q0);
      bulk_commit();
    }
  }
  if (warp == 0) bulk_wait<0>();

  // the block's keys of dK (scaled) and dV, bf16 or the f32 partials

  const size_t ka = ((size_t)b * Sk + kp_a) * H + h;
  const size_t kb = ka + 8 * (size_t)H;
  const bool va = kp_a < Sk, vb = kp_b < Sk;
#pragma unroll
  for (int c = 0; c < NK; ++c)
    fbt_store<64>(dk[c], (KB0 + c) * 64 + c2, scale, dk_out, dk_part,
                  ka * L::D, kb * L::D, va, vb);
#pragma unroll
  for (int c = 0; c < NV; ++c)
    fbt_store<64>(dv[c], c * 64 + c2, 1.0f, dv_out, dv_part, ka * L::DV,
                  kb * L::DV, va, vb);
}

template <int MODE>
__global__ void __launch_bounds__(FbtMla::THREADS, 1)
fbt_mla(const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdq,
        const float2* __restrict__ ld,
        float* __restrict__ dk_part, float* __restrict__ dv_part,
        __nv_bfloat16* __restrict__ dk_out,
        __nv_bfloat16* __restrict__ dv_out, int Sq, int Sk, int Sp, int B,
        int H, int KVH, int window, float scale_log2, float scale,
        int prefix, int chunk) {
  using L = FbtMla;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + L::NST;

  const FbtBlock blk = fbt_block((Sk + FBT_TILE - 1) / FBT_TILE, B * H, H,
                                 chunk);
  const int b = blk.b, h = blk.h, k0 = blk.kb * FBT_TILE;
  const int kvh = h / (H / KVH);
  const int k_last = min(k0 + FBT_TILE, Sk) - 1;
  const int q_last = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int t_begin = FBT_FIRST_TILE(MODE, blk.kb, k0, prefix),
            t_end = q_last / FBT_TILE;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    // ------------------------------------------- producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x == L::CONSUMERS) {
      mbar_expect_tx(kv_full, L::TK + L::TV);
      for (int nb = 0; nb < 3; ++nb)
        tma_load_4d(smem + L::K + nb * FBT_BLK, &tk, kv_full, nb * 64, kvh,
                    k0, b);
      for (int nb = 0; nb < 2; ++nb)
        tma_load_4d(smem + L::V + nb * FBT_BLK, &tv, kv_full, nb * 64, kvh,
                    k0, b);
      const float2* ld_bh = ld + ((size_t)b * H + h) * Sp;
      for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
        const int s = i % L::NST;
        mbar_wait(&empty[s], ((i / L::NST) & 1) ^ 1);
        uint8_t* Qs = smem + L::STAGES + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE + FBT_TILE * 8);
        for (int nb = 0; nb < 3; ++nb)
          tma_load_4d(Qs + nb * FBT_BLK, &tq, &full[s], nb * 64, h,
                      t * FBT_TILE, b);
        for (int nb = 0; nb < 2; ++nb)
          tma_load_4d(Qs + L::TK + nb * FBT_BLK, &tdo, &full[s], nb * 64, h,
                      t * FBT_TILE, b);
        bulk_load(smem + L::LD + s * FBT_TILE * 8, ld_bh + t * FBT_TILE,
                  FBT_TILE * 8, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int row_bh = (b * H + h) * Sp;   // the head's first accumulator row
  if (warp < 4)
    fbt_mla_consumer<MODE, 0>(smem, kv_full, full, empty, &tdq, row_bh,
                              dk_part, dv_part, dk_out, dv_out, b, h, k0,
                              t_begin, t_end, Sk, H, window, scale_log2,
                              scale, prefix);
  else
    fbt_mla_consumer<MODE, 1>(smem, kv_full, full, empty, &tdq, row_bh,
                              dk_part, dv_part, dk_out, dv_out, b, h, k0,
                              t_begin, t_end, Sk, H, window, scale_log2,
                              scale, prefix);
}

// D = 256's layout (the header's design): two consumer warpgroups, each
// owning 128 of the 256 columns of dK and dV.
struct Fbt256 {
  static constexpr int D = 256;
  static constexpr int NB = 4;
  static constexpr int TILE = NB * FBT_TILE * 128;   // a 64-row bf16 tile
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int STAGES = 2 * TILE;   // stage s: Q, then dO
  static constexpr int PT = STAGES + FBT_STAGES * 2 * TILE;  // P^T bf16
  static constexpr int DS = PT + FBT_TILE * 128;             // dS^T bf16
  static constexpr int PIECE = 32;          // dQ columns staged at once
  static constexpr int DQ = DS + FBT_TILE * 128;   // one piece per wg
  static constexpr int LD = DQ + 2 * FBT_TILE * PIECE * 4;   // (lse, D)
  static constexpr int BAR = LD + FBT_STAGES * FBT_TILE * 8;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * FBT_STAGES) + 1024;
  static constexpr int THREADS = 384;       // 2 consumer + 1 producer wgs
  static constexpr int CONSUMERS = 256;
  static_assert(PT % 1024 == 0 && DS % 1024 == 0 && DQ % 16 == 0 &&
                    LD % 16 == 0 && BYTES <= 232448,
                "swizzled tiles on 1024 bytes, bulk copies on 16, and the "
                "H100's shared memory a block");
};

template <int MODE>
__global__ void __launch_bounds__(Fbt256::THREADS, 1)
fbt_main256(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float2* __restrict__ ld, float* __restrict__ dq_acc,
            float* __restrict__ dk_part, float* __restrict__ dv_part,
            int Sq, int Sk, int Sp, int H, int KVH, int window,
            float scale_log2, int prefix) {
  using L = Fbt256;
  constexpr int D = L::D, NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + FBT_STAGES;

  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * FBT_TILE;
  const int kvh = h / (H / KVH);
  const int k_last = min(k0 + FBT_TILE, Sk) - 1;
  const int q_last = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int t_begin = FBT_FIRST_TILE(MODE, kt, k0, prefix);
  const int t_end = q_last / FBT_TILE;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < FBT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ------------------------------------------- producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == L::CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * L::TILE);
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(smem + L::K + nb * FBT_TILE * 128, &tk, kv_full, nb * 64,
                    kvh, k0, b);
        tma_load_4d(smem + L::V + nb * FBT_TILE * 128, &tv, kv_full, nb * 64,
                    kvh, k0, b);
      }
      const float2* ld_bh = ld + ((size_t)b * H + h) * Sp;
      for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
        const int s = i % FBT_STAGES;
        mbar_wait(&empty[s], ((i / FBT_STAGES) & 1) ^ 1);
        uint8_t* Qs = smem + L::STAGES + s * 2 * L::TILE;
        mbar_expect_tx(&full[s], 2 * L::TILE + FBT_TILE * 8);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(Qs + nb * FBT_TILE * 128, &tq, &full[s], nb * 64, h,
                      t * FBT_TILE, b);
          tma_load_4d(Qs + L::TILE + nb * FBT_TILE * 128, &tdo, &full[s],
                      nb * 64, h, t * FBT_TILE, b);
        }
        bulk_load(smem + L::LD + s * FBT_TILE * 8, ld_bh + t * FBT_TILE,
                  FBT_TILE * 8, &full[s]);
      }
    }
    return;
  }

  // ------------------------------------------- consumer warpgroups
  setmaxnreg_inc<232>();
  const int wg = warp / 4, w4 = warp % 4;   // columns 128wg .. 128wg + 127
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r_a = 16 * w4 + g, r_b = r_a + 8;   // the thread's key rows
  const int kp_a = k0 + r_a, kp_b = k0 + r_b;
  const uint8_t* Ks = smem + L::K;
  const uint8_t* Vs = smem + L::V;
  uint8_t* PT = smem + L::PT;
  uint8_t* dST = smem + L::DS;
  float* dQs = reinterpret_cast<float*>(smem + L::DQ) +
               wg * FBT_TILE * L::PIECE;

  float dk[2][32], dv[2][32];   // column blocks 2wg and 2wg + 1
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
    const int s = i % FBT_STAGES;
    mbar_wait(&full[s], (i / FBT_STAGES) & 1);
    const uint8_t* Qs = smem + L::STAGES + s * 2 * L::TILE;
    const uint8_t* dOs = Qs + L::TILE;
    const float2* lds =
        reinterpret_cast<const float2*>(smem + L::LD + s * FBT_TILE * 8);
    const int q0 = t * FBT_TILE;

    // S^T = K Q^T and dP^T = V dO^T on the query columns 32wg .. 32wg + 31
    float sc[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * FBT_TILE * 128 + (kk % 4) * 32;
      const int rows = wg * 32 * 128;       // the warpgroup's 32 rows
      wgmma_m64n32k16_ss<0, 0>(sc, sw128_desc(Ks + off, 16),
                               sw128_desc(Qs + rows + off, 16), kk > 0);
      wgmma_m64n32k16_ss<0, 0>(dp, sw128_desc(Vs + off, 16),
                               sw128_desc(dOs + rows + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T on the fragments: element 4j + e is key row r_a
    // (e < 2) or r_b, query column 32wg + 8j + c2 + (e & 1)
    const bool need_mask = FBT_NEED_MASK(MODE);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * wg + 8 * j + c2 + (e & 1);
        const float2 l = lds[col];
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -l.x));
        if (need_mask) {
          const int qp = q0 + col, kp = e < 2 ? kp_a : kp_b;
          if (FBT_MASKED(MODE, qp, kp)) p = 0.0f;
        }
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - l.y);
      }

    // both warpgroups' halves of P^T and dS^T into shared memory, bf16
    // with the 128-byte swizzle (rows = keys, 64 query columns), once the
    // previous tile's products of both have read them
    named_barrier(1, L::CONSUMERS);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int chunk = 4 * wg + j;
      const int oa = r_a * 128 + ((chunk ^ (r_a & 7)) << 4) + 2 * c2;
      const int ob = r_b * 128 + ((chunk ^ (r_b & 7)) << 4) + 2 * c2;
      *reinterpret_cast<uint32_t*>(PT + oa) =
          pack_bf16x2(sc[4 * j], sc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(PT + ob) =
          pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dST + oa) =
          pack_bf16x2(dp[4 * j], dp[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dST + ob) =
          pack_bf16x2(dp[4 * j + 2], dp[4 * j + 3]);
    }
    fence_proxy_async();
    named_barrier(1, L::CONSUMERS);

    // dV += P^T dO and dK += dS^T Q on the warpgroup's two column blocks
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int blk = (2 * wg + c) * FBT_TILE * 128 + kk * 16 * 128;
        wgmma_m64n64k16_ss<0, 1>(dv[c], sw128_desc(PT + kk * 32, 16),
                                 sw128_desc(dOs + blk, 1024), 1);
        wgmma_m64n64k16_ss<0, 1>(dk[c], sw128_desc(dST + kk * 32, 16),
                                 sw128_desc(Qs + blk, 1024), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    mbar_arrive(&empty[s]);   // Q, dO and the (lse, D) rows are read

    // dQ (64 rows x the warpgroup's 128 columns) = dS K, a 64-column
    // block at a time, each to the bulk reduction in two 32-column pieces
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int nb = 2 * wg + c;
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<1, 1>(
            dq, sw128_desc(dST + kk * 16 * 128, 1024),
            sw128_desc(Ks + nb * FBT_TILE * 128 + kk * 16 * 128, 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the previous piece's rows have left dQs
        if (w4 == 0) bulk_wait_read<0>();
        named_barrier(2 + wg, FBT_CONSUMERS);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = 4 * half + j, d = 8 * j + c2;
          *reinterpret_cast<float2*>(dQs + r_a * L::PIECE + d) =
              make_float2(dq[4 * jj], dq[4 * jj + 1]);
          *reinterpret_cast<float2*>(dQs + r_b * L::PIECE + d) =
              make_float2(dq[4 * jj + 2], dq[4 * jj + 3]);
        }
        fence_proxy_async();
        named_barrier(2 + wg, FBT_CONSUMERS);
        if (w4 == 0) {
          float* dst = dq_acc + (((size_t)b * H + h) * Sp + q0) * D +
                       nb * 64 + half * L::PIECE;
          for (int r = lane; r < FBT_TILE; r += 32)
            bulk_reduce_add_f32(dst + (size_t)r * D, dQs + r * L::PIECE,
                                L::PIECE * 4);
          bulk_commit();
        }
      }
    }
  }
  if (w4 == 0) bulk_wait<0>();

  // the block's dK (unscaled) and dV into the per-query-head partials
  const size_t row_stride = (size_t)H * D;
  const size_t off_a = ((size_t)b * Sk + kp_a) * row_stride + (size_t)h * D;
  const size_t off_b = off_a + 8 * row_stride;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = (2 * wg + c) * 64 + 8 * j + c2;
      if (kp_a < Sk) {
        *reinterpret_cast<float2*>(dk_part + off_a + d) =
            make_float2(dk[c][4 * j], dk[c][4 * j + 1]);
        *reinterpret_cast<float2*>(dv_part + off_a + d) =
            make_float2(dv[c][4 * j], dv[c][4 * j + 1]);
      }
      if (kp_b < Sk) {
        *reinterpret_cast<float2*>(dk_part + off_b + d) =
            make_float2(dk[c][4 * j + 2], dk[c][4 * j + 3]);
        *reinterpret_cast<float2*>(dv_part + off_b + d) =
            make_float2(dv[c][4 * j + 2], dv[c][4 * j + 3]);
      }
    }
}

__device__ __forceinline__ void fbt_store4(__nv_bfloat16* dst, float4 v,
                                           float scale) {
  uint2 u;
  u.x = pack_bf16x2(v.x * scale, v.y * scale);
  u.y = pack_bf16x2(v.z * scale, v.w * scale);
  *reinterpret_cast<uint2*>(dst) = u;
}

// dq (B, Sq, H, D) from the accumulator (B, H, Sp, D); dk (B, Sk, KVH, D)
// and dv (B, Sk, KVH, DV) from the partials (B, Sk, H, D) and (B, Sk, H,
// DV), each group's G heads summed in order. Four dims a thread.
template <int D, int DV = D>
__global__ void __launch_bounds__(256)
fbt_finish(const float* __restrict__ dq_acc,
           const float* __restrict__ dk_part,
           const float* __restrict__ dv_part, __nv_bfloat16* __restrict__ dq,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           long long nq4, long long nk4, long long nv4, int Sq, int Sp,
           int H, int KVH, float scale) {
  constexpr int D4 = D / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int d = 4 * (int)(e % D4);
  const int G = H / KVH;
  if (e < nq4) {
    const long long r = e / D4;            // (b, s, h)
    const int h = (int)(r % H);
    const long long bs = r / H;
    const int s = (int)(bs % Sq);
    const long long b = bs / Sq;
    const float4 v = *reinterpret_cast<const float4*>(
        dq_acc + (((size_t)b * H + h) * Sp + s) * D + d);
    fbt_store4(dq + (size_t)r * D + d, v, scale);
  }
  if (e < nk4) {
    const long long r = e / D4;            // (b, s < Sk, kvh)
    const int kvh = (int)(r % KVH);
    const long long bs = r / KVH;
    const float* pk = dk_part + ((size_t)bs * H + (size_t)kvh * G) * D + d;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < G; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(pk + (size_t)g * D);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    }
    fbt_store4(dk + (size_t)r * D + d, sk, scale);
  }
  if (e < nv4) {
    constexpr int DV4 = DV / 4;
    const long long r = e / DV4;
    const int dd = 4 * (int)(e % DV4);
    const int kvh = (int)(r % KVH);
    const long long bs = r / KVH;
    const float* pv = dv_part + ((size_t)bs * H + (size_t)kvh * G) * DV + dd;
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < G; ++g) {
      const float4 c = *reinterpret_cast<const float4*>(pv + (size_t)g * DV);
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    fbt_store4(dv + (size_t)r * DV + dd, sv, 1.0f);
  }
}

// The dQ accumulator (B, H, Sp, D) f32 as a 2-D tensor map (D columns,
// B H Sp rows) read in boxes of 32 columns x 64 rows with the 128-byte
// swizzle: the target of fbt_main128's and fbt_mla's tensor reductions.
inline bool make_map_dq(CUtensorMap* map, float* dq_acc, int D,
                        long long rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {32, FBT_TILE};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, dq_acc, dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV = D>
cudaError_t fbt_launch(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float2* ld, float* dq_acc, float* dk_part,
                       float* dv_part, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int KVH, int window,
                       int mode, int prefix, cudaStream_t stream) {
  const int q_tiles = (Sq + FBT_TILE - 1) / FBT_TILE, Sp = q_tiles * FBT_TILE;
  const int k_tiles = (Sk + FBT_TILE - 1) / FBT_TILE;
  // fbt_main128 and fbt_mla write dK and dV themselves when no group sums
  // them; fbt_main256 always writes the partials
  constexpr bool paired = D != 256;
  const bool direct = paired && H == KVH;
  if (!direct && (dk_part == nullptr || dv_part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mdo, mk, mv;
  const cuuint64_t dq_dims[4] = {(cuuint64_t)D, (cuuint64_t)H,
                                 (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t sq[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                            (cuuint64_t)Sq * H * D * 2};
  const cuuint64_t dk_dims[4] = {(cuuint64_t)D, (cuuint64_t)KVH,
                                 (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t sk[3] = {(cuuint64_t)D * 2, (cuuint64_t)KVH * D * 2,
                            (cuuint64_t)Sk * KVH * D * 2};
  const cuuint64_t do_dims[4] = {(cuuint64_t)DV, (cuuint64_t)H,
                                 (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t sdo[3] = {(cuuint64_t)DV * 2, (cuuint64_t)H * DV * 2,
                             (cuuint64_t)Sq * H * DV * 2};
  const cuuint64_t dv_dims[4] = {(cuuint64_t)DV, (cuuint64_t)KVH,
                                 (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t sv[3] = {(cuuint64_t)DV * 2, (cuuint64_t)KVH * DV * 2,
                            (cuuint64_t)Sk * KVH * DV * 2};
  const cuuint32_t box[4] = {64, 1, FBT_TILE, 1};
  if (!make_map_bf16(&mq, q, 4, dq_dims, sq, box) ||
      !make_map_bf16(&mdo, dout, 4, do_dims, sdo, box) ||
      !make_map_bf16(&mk, k, 4, dk_dims, sk, box) ||
      !make_map_bf16(&mv, v, 4, dv_dims, sv, box))
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sp;
  fbt_prep<D, DV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, ld, dq_acc, rows, Sq, Sp,
      H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (!paired) {
    decltype(&fbt_main256<FA_CAUSAL>) main_kernel =
        mode == FA_PREFIX  ? fbt_main256<FA_PREFIX>
        : mode == FA_CROSS ? fbt_main256<FA_CROSS>
                           : fbt_main256<FA_CAUSAL>;
    err = cudaFuncSetAttribute(main_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Fbt256::BYTES);
    if (err != cudaSuccess) return err;
    main_kernel<<<dim3(H, B, k_tiles), Fbt256::THREADS, Fbt256::BYTES,
                  stream>>>(mq, mdo, mk, mv, ld, dq_acc, dk_part, dv_part, Sq,
                            Sk, Sp, H, KVH, window, scale * FBT_LOG2E,
                            prefix);
  } else {
    CUtensorMap mdq;
    if (rows > 0x7fffffffLL || !make_map_dq(&mdq, dq_acc, D, rows))
      return cudaErrorInvalidValue;
    using Kernel = decltype(&fbt_mla<FA_CAUSAL>);
    Kernel main_kernel;
    int smem, keys;
    if constexpr (D == 192) {
      main_kernel = mode == FA_PREFIX  ? fbt_mla<FA_PREFIX>
                    : mode == FA_CROSS ? fbt_mla<FA_CROSS>
                                       : fbt_mla<FA_CAUSAL>;
      smem = FbtMla::BYTES;
      keys = FBT_TILE;
    } else {
      main_kernel = mode == FA_PREFIX  ? fbt_main128<D, FA_PREFIX>
                    : mode == FA_CROSS ? fbt_main128<D, FA_CROSS>
                                       : fbt_main128<D, FA_CAUSAL>;
      smem = Fbt128<D>::BYTES;
      keys = 2 * FBT_TILE;
    }
    err = cudaFuncSetAttribute(main_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    // the grid's chunk (fbt_block): the heads in as few chunks of equal
    // size as keep a chunk's dQ rows (f32), Q and dO rows (bf16) within
    // FBT_L2_BUDGET (one chunk of every head where they fit)
    const long long bh = (long long)B * H;
    const long long per_head =
        (long long)Sp * D * 4 + (long long)Sq * (D + DV) * 2;
    const long long n_chunks = (bh * per_head + FBT_L2_BUDGET - 1) /
                               FBT_L2_BUDGET;
    const int chunk = (int)((bh + n_chunks - 1) / n_chunks);
    const long long blocks = bh * ((Sk + keys - 1) / keys);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    main_kernel<<<(unsigned)blocks, FbtMla::THREADS, smem, stream>>>(
        mq, mdo, mk, mv, mdq, ld, dk_part, dv_part,
        direct ? static_cast<__nv_bfloat16*>(dk) : nullptr,
        direct ? static_cast<__nv_bfloat16*>(dv) : nullptr, Sq, Sk, Sp, B,
        H, KVH, window, scale * FBT_LOG2E, scale, prefix, chunk);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long nq4 = (long long)B * Sq * H * (D / 4);
  const long long nk4 = direct ? 0 : (long long)B * Sk * KVH * (D / 4);
  const long long nv4 = direct ? 0 : (long long)B * Sk * KVH * (DV / 4);
  const long long n4 = nq4 > nk4 ? nq4 : nk4;
  fbt_finish<D, DV><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      dq_acc, dk_part, dv_part, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), nq4,
      nk4, nv4, Sq, Sp, H, KVH, scale);
  return cudaGetLastError();
}

}  // namespace idkd

// bf16 q/dq (B, Sq, H, D), o/dout (B, Sq, H, DV), k/dk (B, Sk, KVH, D),
// v/dv (B, Sk, KVH, DV), contiguous, 16-byte aligned; lse (B, H, Sq) f32
// from the forward. Scratch (f32): ld (B, H, Sp, 2) and dq_acc (B, H, Sp,
// D) with Sp = Sq rounded up to 64; dk_part (B, Sk, H, D) and dv_part (B,
// Sk, H, DV) when H > KVH or D = 256, else unused (may be null).
// DV = D in {64, 96, 128, 256}, or (D, DV) = (192, 128); H % KVH == 0;
// causal 1: Sk == Sq, window 0 = full causal, prefix 0 <= P <= Sk (0:
// none; P > 0 with window 0 only); causal 0: every key visible (window 0,
// prefix 0). Three launches; returns cudaGetLastError() after them
// (cudaErrorInvalidValue for a shape the kernel does not take, missing
// partials or a tensor map the driver refuses).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ld, void* dq_acc, void* dk_part,
    void* dv_part, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
    int H, int KVH, int D, int DV, int window, int causal, int prefix,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0 || H > 65535 ||
      B > 65535 || !idkd::fa_mode_ok(Sq, Sk, window, causal, prefix))
    return (int)cudaErrorInvalidValue;
  const int m = !causal ? idkd::FA_CROSS
                        : prefix > 0 ? idkd::FA_PREFIX : idkd::FA_CAUSAL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* ldp = static_cast<float2*>(ld);
  float* acc = static_cast<float*>(dq_acc);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
#define FBT_CASE(DIM)                                                     \
  case DIM:                                                               \
    return (int)idkd::fbt_launch<DIM>(q, k, v, o, dout, l, ldp, acc, pk,  \
                                      pv, dq, dk, dv, B, Sq, Sk, H, KVH,  \
                                      window, m, prefix, s);
  if (D == 192 && DV == 128)
    return (int)idkd::fbt_launch<192, 128>(q, k, v, o, dout, l, ldp, acc, pk,
                                           pv, dq, dk, dv, B, Sq, Sk, H, KVH,
                                           window, m, prefix, s);
  if (DV != D) return (int)cudaErrorInvalidValue;
  switch (D) {
    FBT_CASE(64)
    FBT_CASE(96)
    FBT_CASE(128)
    FBT_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FBT_CASE
}
