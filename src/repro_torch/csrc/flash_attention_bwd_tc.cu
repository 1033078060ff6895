// flash_attention's backward pass, bf16 on Hopper's tensor cores (sm_90a):
// the gradients of grouped-query attention, causal with a per-layer
// sliding window or the prefix-LM mask, or bidirectional over a key set of
// its own length (cross-attention), with ragged tails, given the forward's
// output O and its rows' log-sum-exp. The bf16 variant of the port's
// attention backward, for head_dim 64, 96, 128 and 256 (f32, and bf16 at
// head_dim 32, run csrc/flash_attention_bwd.cu).
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
// DV) bf16, DV = D except in MLA's mode (D = 192, DV = 128, below); head
// h reads kv head h / (H / KVH); causal (Sk = Sq): key kp is visible to row qp iff
// kp <= qp and, when window > 0, qp - window < kp; prefix-LM (PaliGemma's,
// flash_mask.cuh): also iff qp, kp < P; not causal: every key kp < Sk;
// lse (B, H, Sq) f32; gradients bf16.
//
// Bound on the H100. Five products of the (causal, windowed) score
// matrix's size, 2.5x the forward's matmul work: at Hymba's training
// shape (B 2, S 2176, 25/5 heads x 64) 76 GFLOP global, 54 GFLOP at
// window 1024, against ~28 MB of inputs and outputs: bound by the bf16
// tensor cores (989 TFLOP/s), and at D = 64 nearly as much by the one
// exponential per score on the SFU. Cross-attention at MusicGen's shape
// (B 2, Sq 1500, Sk 64, 24 heads x 64) is bound by bytes (q, o, dO, dQ);
// its single key tile gives fbt_main one block per (b, h), 48 blocks on
// 132 SMs, each walking all 24 query tiles. PaliGemma's layer (B 2, S 512
// with a 256-position prefix, 8/1 heads x 256) is 6.7 GFLOP against 19 MB:
// bound by operations (0.0068 ms), and its 128 blocks of fbt_main256
// (8 heads x 2 x 8 key tiles) half-fill the SMs.
//
// Design: three kernels a call.
//  * fbt_prep: one warp per (b, h, row): D = rowsum(dO o O) and the
//    row's lse * log2(e) side by side in an f32 (B, H, Sp, 2) array
//    (Sp = Sq rounded up to 64; padding rows get lse = 1e30, so P = 0),
//    and the row of the f32 dQ accumulator (B, H, Sp, D) zeroed.
//  * fbt_main: one block per (b, query head h, 64-key tile), 850 blocks
//    at Hymba's training shape, key tiles that see the most query tiles
//    first. One consumer warpgroup owns the 64 keys; one producer warp
//    loads the key tile's K and V once by TMA, then streams 64-row Q and
//    dO tiles (128-byte swizzle, as flash_attention_tc.cu) with their
//    rows' (lse, D) through a ring of 2 shared-memory stages guarded by
//    full / empty mbarriers, from the diagonal (causal; row 0 for a key
//    tile that starts in the prefix) or the first row to the window's far
//    edge or the last row.
//    Per query tile, all on the accumulator fragments of the warpgroup's
//    64 keys:
//      S^T = K Q^T and dP^T = V dO^T: wgmma, both operands K-major;
//      P^T = exp2(S^T scale log2e - lse log2e), masked only on the tiles
//        that straddle the diagonal (or the prefix's end), the window's
//        edge or Sk (a key past
//        Sk is a zero-filled row of K and V, whose P would be
//        exp2(-lse log2e), not 0, and whose dQ term 0 times a P that may
//        overflow); dS^T =
//        P^T o (dP^T - D): P is computed once for dV, dK and dQ (five
//        products, where the SIMT kernel recomputes P and dP for dQ);
//      dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 as
//        wgmma's register A operand, dO and Q MN-major from the same
//        TMA tiles (the forward's P V form);
//      dQ = dS K: dS^T is written to shared memory as bf16 (swizzled),
//        read back as an MN-major A operand against the MN-major K tile;
//        the f32 result goes through padded shared memory to the TMA
//        unit's bulk reduction (cp.reduce.async.bulk .add.f32) into the
//        dQ accumulator, row by row.
//    The block's dK and dV (f32, in registers over the whole walk) go
//    to per-query-head f32 partials (B, Sk, H, D).
//  * fbt_finish: dK = scale * (the group's G partials summed in a fixed
//    order), dV likewise unscaled, dQ = scale * accumulator, to bf16.
// dK and dV are the same from run to run; dQ's additions from the key
// tiles arrive in the order the blocks run, so its last bits vary.
// Registers: at D = 64 two blocks share an SM (one warpgroup each; ptxas
// gives fbt_main 168 registers a thread, no spills in the causal
// instantiation, 20 bytes in the non-causal one, 8 in the prefix-LM one);
// at D = 128 the dK
// and dV fragments take 128 registers, dQ's two 64-column halves are
// formed one after the other, and one block runs per SM (254 registers,
// no spills). D = 96 (Phi-3-mini) takes D = 128's layout: two 64-dim
// column blocks, the tensor maps at the true innermost extent 96 with a
// 64-wide box, so TMA fills columns 96..127 of the second block with
// zeros (the mbarriers still count the whole box). The score products
// run their 6 true depth steps; dV, dK and dQ's second block carry 32
// zero columns (128/96 of their true work) that are never stored: the
// dQ rows go to the bulk reduction D * 4 = 384 bytes long from a shared
// row padded past D, and the dK, dV partials and fbt_finish write
// columns < D only (the next head starts at column D). ptxas's report
// is in build/kernels/libflash_attention_bwd_tc-*.log.
//
// D = 256 (PaliGemma) has a main kernel of its own, fbt_main256. In one
// warpgroup the dK and dV fragments alone would take 256 f32 registers a
// thread, and FbtSmem<256> would need 64 KB of K and V, 128 KB of Q and
// dO in 2 stages and 66 KB of dQ staging rows: past the H100's 232,448
// bytes a block. So two consumer warpgroups share the 64 keys:
//  * each owns 128 of dK's and dV's 256 columns (2 x 2 x 32 = 128
//    registers a thread);
//  * S^T and dP^T are split over the query columns: warpgroup w forms
//    keys x rows 32w..32w+31 (wgmma m64n32k16, 16 registers each), and
//    P^T and dS^T meet in shared memory as bf16 (128-byte swizzle), from
//    where both warpgroups read them as wgmma's A operand for
//    dV += P^T dO and dK += dS^T Q on their own columns;
//  * dQ = dS K is formed a 64-column block at a time on each warpgroup's
//    columns and staged for the bulk reduction in 32-column pieces (64
//    rows x 128 bytes a warpgroup, unpadded);
//  * shared memory: K, V 64 KB; Q and dO in 2 stages 128 KB; P^T and dS^T
//    16 KB; dQ pieces 16 KB; (lse, D) rows 1 KB; barriers and the 1 KB
//    alignment pad: Fbt256::BYTES = 231,464 of 232,448;
//  * 384 threads: two consumer warpgroups and a producer warpgroup, one
//    thread of which issues the copies. At 288 threads (a producer warp)
//    ptxas capped every thread at 168 registers and spilled ~300 bytes;
//    here setmaxnreg moves registers from the producer (40) to the
//    consumers (232), as head_select_tc.cu does.
// MQA (PaliGemma's 8 query heads on one KV head) needs nothing more: the
// partials of the group's G heads are summed in fbt_finish.
//
// MLA's mode (DeepSeek-V3: D = 192 for q and k, 128 nope + 64 rope dims,
// DV = 128 for v, o and dO) runs fbt_main<192, 128>: S^T over three
// 64-dim column blocks, dP^T over two; D = rowsum(dO o O) over DV; dV
// (two blocks) and dK, dQ (three) as above. Shared memory: K 24 KB, V
// 16 KB, 2 stages of Q (24 KB) and dO (16 KB), dS^T 8 KB, the dQ rows
// 51 KB (FbtSmem<192, 128>::BYTES = 184,360). The dK and dV fragments take
// 160 f32 registers a thread over the walk, beside the 64 of S^T and
// dP^T; ptxas's report says whether it spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace idkd {

constexpr int FBT_TILE = 64;        // keys per block; query rows per tile
constexpr int FBT_STAGES = 2;       // Q / dO ring depth
constexpr int FBT_THREADS = 160;    // 1 consumer warpgroup + 1 producer warp
constexpr int FBT_CONSUMERS = 128;
constexpr float FBT_LOG2E = 1.4426950408889634f;

template <int D, int DV = D>
struct FbtSmem {
  static constexpr int NB = (D + 63) / 64;          // 64-dim column blocks
  static constexpr int NBV = (DV + 63) / 64;        // of V, dO
  static constexpr int TILE = NB * FBT_TILE * 128;  // a 64-row bf16 tile
  static constexpr int TILE_V = NBV * FBT_TILE * 128;   // of V or dO
  static constexpr int STAGE = TILE + TILE_V;       // Q, then dO
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int STAGES = V + TILE_V;        // the Q / dO ring
  static constexpr int DS = STAGES + FBT_STAGES * STAGE;    // dS^T bf16
  static constexpr int DQS = D + 8;         // dQ row stride (floats); only
                                            // columns < D are written
  static constexpr int DQ = DS + FBT_TILE * 128;
  static constexpr int LD = DQ + FBT_TILE * DQS * 4;   // (lse, D) rows
  static constexpr int BAR = LD + FBT_STAGES * FBT_TILE * 8;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * FBT_STAGES) + 1024;
  static_assert(DS % 1024 == 0 && DQ % 16 == 0 && LD % 16 == 0,
                "swizzled tiles on 1024 bytes, bulk copies on 16");
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

// One wgmma per 16 head dims: acc (64 x 64) = A B^T with A, B the 64-row
// K-major tiles (keys against query rows), D dims deep.
template <int D>
__device__ __forceinline__ void fbt_scores(float (&acc)[32], const uint8_t* A,
                                           const uint8_t* Bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int nb = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n64k16_ss<0, 0>(acc,
                             sw128_desc(A + nb * FBT_TILE * 128 + off, 16),
                             sw128_desc(Bt + nb * FBT_TILE * 128 + off, 16),
                             kk > 0);
  }
}

// acc[nb] (64 keys x 64 dims) += A (64 keys x 64 rows, registers) . T
// (64 rows x NB column blocks, MN-major from a TMA tile)
template <int NB>
__device__ __forceinline__ void fbt_accumulate(float (&acc)[NB][32],
                                               const uint32_t (&a)[4][4],
                                               const uint8_t* T) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs_tb(
          acc[nb], a[kk],
          sw128_desc(T + nb * FBT_TILE * 128 + kk * 16 * 128, 1024), 1);
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

// MODE (FA_CAUSAL, FA_CROSS, FA_PREFIX): the mask, a template parameter so
// that the causal kernel's mask and register use stay the self-attention
// kernel's (as a runtime flag it made fbt_main<64> spill and run slower,
// PERF.md)
template <int D, int DV, int MODE>
__global__ void __launch_bounds__(FBT_THREADS, D == 64 ? 2 : 1)
fbt_main(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tdo,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const float2* __restrict__ ld, float* __restrict__ dq_acc,
         float* __restrict__ dk_part, float* __restrict__ dv_part, int Sq,
         int Sk, int Sp, int H, int KVH, int window, float scale_log2,
         int prefix) {
  using L = FbtSmem<D, DV>;
  constexpr int NB = L::NB, NBV = L::NBV;
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
  const int t_begin = FBT_FIRST_TILE(MODE, kt, k0, prefix),
            t_end = q_last / FBT_TILE;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < FBT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FBT_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // ------------------------------------------------ producer warp
    if (lane == 0) {
      mbar_expect_tx(kv_full, L::TILE + L::TILE_V);
      for (int nb = 0; nb < NB; ++nb)
        tma_load_4d(smem + L::K + nb * FBT_TILE * 128, &tk, kv_full, nb * 64,
                    kvh, k0, b);
      for (int nb = 0; nb < NBV; ++nb)
        tma_load_4d(smem + L::V + nb * FBT_TILE * 128, &tv, kv_full, nb * 64,
                    kvh, k0, b);
      const float2* ld_bh = ld + ((size_t)b * H + h) * Sp;
      for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
        const int s = i % FBT_STAGES;
        mbar_wait(&empty[s], ((i / FBT_STAGES) & 1) ^ 1);
        uint8_t* Qs = smem + L::STAGES + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE + FBT_TILE * 8);
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(Qs + nb * FBT_TILE * 128, &tq, &full[s], nb * 64, h,
                      t * FBT_TILE, b);
        for (int nb = 0; nb < NBV; ++nb)
          tma_load_4d(Qs + L::TILE + nb * FBT_TILE * 128, &tdo, &full[s],
                      nb * 64, h, t * FBT_TILE, b);
        bulk_load(smem + L::LD + s * FBT_TILE * 8, ld_bh + t * FBT_TILE,
                  FBT_TILE * 8, &full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroup
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r_a = 16 * warp + g, r_b = r_a + 8;   // the thread's key rows
  const int kp_a = k0 + r_a, kp_b = k0 + r_b;
  const uint8_t* Ks = smem + L::K;
  const uint8_t* Vs = smem + L::V;
  uint8_t* dST = smem + L::DS;
  float* dQs = reinterpret_cast<float*>(smem + L::DQ);

  float dk[NB][32], dv[NBV][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = 0.0f;
#pragma unroll
  for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[nb][i] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
    const int s = i % FBT_STAGES;
    mbar_wait(&full[s], (i / FBT_STAGES) & 1);
    const uint8_t* Qs = smem + L::STAGES + s * L::STAGE;
    const uint8_t* dOs = Qs + L::TILE;
    const float2* lds =
        reinterpret_cast<const float2*>(smem + L::LD + s * FBT_TILE * 8);
    const int q0 = t * FBT_TILE;

    // S^T = K Q^T and dP^T = V dO^T
    float sc[32], dp[32];
    wgmma_fence();
    fbt_scores<D>(sc, Ks, Qs);
    fbt_scores<DV>(dp, Vs, dOs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T on the fragments: element 4j + e is key row r_a
    // (e < 2) or r_b, query column 8j + c2 + (e & 1)
    const bool need_mask = FBT_NEED_MASK(MODE);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c2 + (e & 1);
        const float2 l = lds[col];
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -l.x));
        if (need_mask) {
          const int qp = q0 + col, kp = e < 2 ? kp_a : kp_b;
          if (FBT_MASKED(MODE, qp, kp)) p = 0.0f;
        }
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - l.y);
      }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kk][x] = pack_bf16x2(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        da[kk][x] = pack_bf16x2(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) fence_regs(dv[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dk[nb]);
    wgmma_fence();
    fbt_accumulate<NBV>(dv, pa, dOs);
    fbt_accumulate<NB>(dk, da, Qs);
    wgmma_commit();

    // dS^T into shared memory, bf16 with the 128-byte swizzle (rows =
    // keys, 64 query columns); the previous tile's dQ product has read it
    // and its dQ rows have left dQs
    if (warp == 0) bulk_wait_read<0>();
    named_barrier(1, FBT_CONSUMERS);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = x & 1 ? r_b : r_a, chunk = 2 * kk + (x >> 1);
        *reinterpret_cast<uint32_t*>(dST + row * 128 +
                                     ((chunk ^ (row & 7)) << 4) + 2 * c2) =
            da[kk][x];
      }
    fence_proxy_async();
    named_barrier(1, FBT_CONSUMERS);
    wgmma_wait<0>();   // dV and dK done: pa, da and their tiles are free
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) fence_regs(dv[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dk[nb]);
    mbar_arrive(&empty[s]);   // Q, dO and the (lse, D) rows are read

    // dQ (64 rows x D) = dS K, one 64-column half at a time
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
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
      for (int j = 0; j < 8; ++j) {
        const int d = nb * 64 + 8 * j + c2;
        if (d >= D) continue;          // D = 96: the zero-filled columns
        *reinterpret_cast<float2*>(dQs + r_a * L::DQS + d) =
            make_float2(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(dQs + r_b * L::DQS + d) =
            make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
    }
    fence_proxy_async();
    named_barrier(1, FBT_CONSUMERS);
    if (warp == 0) {
      float* dst = dq_acc + (((size_t)b * H + h) * Sp + q0) * D;
      for (int r = lane; r < FBT_TILE; r += 32)
        bulk_reduce_add_f32(dst + (size_t)r * D, dQs + r * L::DQS, D * 4);
      bulk_commit();
    }
  }
  if (warp == 0) bulk_wait<0>();

  // the block's dK (unscaled) and dV into the per-query-head partials,
  // (B, Sk, H, D) and (B, Sk, H, DV)
  const size_t ka = ((size_t)b * Sk + kp_a) * H + h;
  const size_t kb = ka + 8 * (size_t)H;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = nb * 64 + 8 * j + c2;
      if (d >= D) continue;
      if (kp_a < Sk)
        *reinterpret_cast<float2*>(dk_part + ka * D + d) =
            make_float2(dk[nb][4 * j], dk[nb][4 * j + 1]);
      if (kp_b < Sk)
        *reinterpret_cast<float2*>(dk_part + kb * D + d) =
            make_float2(dk[nb][4 * j + 2], dk[nb][4 * j + 3]);
    }
#pragma unroll
  for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = nb * 64 + 8 * j + c2;
      if (d >= DV) continue;
      if (kp_a < Sk)
        *reinterpret_cast<float2*>(dv_part + ka * DV + d) =
            make_float2(dv[nb][4 * j], dv[nb][4 * j + 1]);
      if (kp_b < Sk)
        *reinterpret_cast<float2*>(dv_part + kb * DV + d) =
            make_float2(dv[nb][4 * j + 2], dv[nb][4 * j + 3]);
    }
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

template <int D, int DV = D>
cudaError_t fbt_launch(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float2* ld, float* dq_acc, float* dk_part,
                       float* dv_part, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int KVH, int window,
                       int mode, int prefix, cudaStream_t stream) {
  const int q_tiles = (Sq + FBT_TILE - 1) / FBT_TILE, Sp = q_tiles * FBT_TILE;
  const int k_tiles = (Sk + FBT_TILE - 1) / FBT_TILE;
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
  int smem, threads;
  decltype(&fbt_main<64, 64, FA_CAUSAL>) main_kernel;
  if constexpr (D == 256) {
    smem = Fbt256::BYTES;
    threads = Fbt256::THREADS;
    main_kernel = mode == FA_PREFIX  ? fbt_main256<FA_PREFIX>
                  : mode == FA_CROSS ? fbt_main256<FA_CROSS>
                                     : fbt_main256<FA_CAUSAL>;
  } else {
    smem = FbtSmem<D, DV>::BYTES;
    threads = FBT_THREADS;
    main_kernel = mode == FA_PREFIX  ? fbt_main<D, DV, FA_PREFIX>
                  : mode == FA_CROSS ? fbt_main<D, DV, FA_CROSS>
                                     : fbt_main<D, DV, FA_CAUSAL>;
  }
  err = cudaFuncSetAttribute(main_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  main_kernel<<<dim3(H, B, k_tiles), threads, smem, stream>>>(
      mq, mdo, mk, mv, ld, dq_acc, dk_part, dv_part, Sq, Sk, Sp, H, KVH,
      window, scale * FBT_LOG2E, prefix);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long nq4 = (long long)B * Sq * H * (D / 4);
  const long long nk4 = (long long)B * Sk * KVH * (D / 4);
  const long long nv4 = (long long)B * Sk * KVH * (DV / 4);
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
// from the forward. Scratch (f32): ld (B, H, Sp, 2), dq_acc (B, H, Sp, D)
// with Sp = Sq rounded up to 64, dk_part (B, Sk, H, D) and dv_part (B,
// Sk, H, DV). DV = D in {64, 96, 128, 256}, or (D, DV) = (192, 128);
// H % KVH == 0; causal 1: Sk == Sq, window 0 = full causal, prefix
// 0 <= P <= Sk (0: none; P > 0 with window 0 only); causal 0: every key
// visible (window 0, prefix 0). Three launches; returns cudaGetLastError()
// after them (cudaErrorInvalidValue for a shape the kernel does not take
// or a tensor map the driver refuses).
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
