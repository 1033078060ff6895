// flash_attention, bf16 on Hopper's tensor cores (sm_90a): grouped-query
// attention with an online softmax, causal with a per-layer sliding
// window or the prefix-LM mask, or bidirectional over a key set of its own
// length (cross-attention), with ragged tails. The bf16 variant of the port's
// flash_attention (the f32 variant, and bf16 at head_dim 32, run
// csrc/flash_attention.cu).
//
// Replaces, with flash_attention.cu, the Pallas TPU kernel
// flash_attention_pallas / _flash_kernel in
// src/repro/kernels/flash_attention/kernel.py, and computes the same
// function as that file's SIMT kernel and as flash_attention_plain:
// causal, per q row qp the keys kp with kp <= qp and, when window > 0,
// qp - window < kp (Sk = Sq); prefix-LM (PaliGemma's, flash_mask.cuh),
// also every kp < P for a row qp < P; not causal, every key kp < Sk; keys
// past Sk and rows past Sq masked; q (B, Sq, H, D), k/v (B, Sk, KVH, D)
// bf16, head h reading kv head h / (H / KVH) in place; scores scaled by
// 1/sqrt(D); softmax statistics in f32; output bf16; D in {64, 96, 128,
// 256}.
//
// Bound on the H100. At Hymba's shape (B 8, S 2176, 25/5 heads x 64) a
// call is 0.12 TFLOP (global) / 0.09 TFLOP (window 1024) against 55 MB
// of q/k/v/o: bound by the bf16 tensor cores (989 TFLOP/s), and at
// D = 64 nearly as much by the exponentials (one per score, on the SFU).
// Cross-attention at MusicGen's shape (B 2, Sq 1500, Sk 64, 24 heads x
// 64) is 1.2 GFLOP against 19 MB: bound by bytes, q and o. PaliGemma's
// layer (B 2, S 512 with a 256-position prefix, 8/1 heads x 256) is 2.7
// GFLOP against 9.4 MB: bytes and operations about even (0.003 ms each).
//
// Design. One block owns a 128-row q tile of one (b, h): two consumer
// warpgroups own 64 rows each, and one producer warp streams the key
// tiles. The grid walks q tiles from the last (the longest causal row
// range) to the first.
//  * Copies: TMA. The Q tile is loaded once; 128-key K and V tiles run
//    through a ring of 3 shared-memory stages guarded by full/empty
//    mbarriers, so the next tile's copy overlaps this tile's math
//    (64-key tiles in 2 stages at D = 256, below). Every
//    tile is a stack of 128-byte rows (64 head dims) with 128-byte
//    swizzle; D = 128 is two such column blocks. Rows past Sq (Q) and Sk
//    (K, V) read zeros: the maps' row extents are Sq and Sk, so a
//    128-key box over a 64-key set is half zeros (and still counts the
//    whole box's bytes on the mbarrier).
//  * D = 96 is two column blocks too, the second half empty: the tensor
//    maps keep the true innermost extent 96 with a 64-wide box, so TMA
//    fills columns 96..127 of the second box with zeros (and still counts
//    the whole box's bytes on the mbarrier). Q.K^T runs its 6 true depth
//    steps; P.V's second block multiplies 32 zero columns of V, which
//    costs 128/96 of the true P.V work and is never stored: the epilogue
//    writes columns < D only (the next head's data starts at column D).
//  * D = 256 (PaliGemma): four column blocks. 128-key tiles in 3 stages
//    would take a 64 KB Q tile and 3 x 128 KB of K and V, and O's
//    accumulator 128 f32 registers a thread beside 64 of scores; so the
//    key tile is 64 keys in 2 stages (Q 64 KB + 2 x 64 KB = 192 KB,
//    FtSmem<256>::BYTES = 197,672 bytes), the scores an m64n64k16 (32
//    registers a thread) and O 128. With a producer warp (288 threads)
//    ptxas capped each thread at 168 registers and spilled ~340 bytes,
//    so at D = 256 the producer is a warpgroup and setmaxnreg moves
//    registers from it (40) to the consumers (232), as head_select_tc.cu
//    does; ptxas's report is in build/kernels/libflash_attention_tc-*.log.
//  * Scores: S = Q.K^T is a wgmma m64n128k16 (m64n64k16 at D = 256) per
//    16 head dims, Q (A) and K (B) both K-major from shared memory, f32
//    accumulators.
//  * Online softmax on the accumulator fragment: a thread holds two rows
//    (r and r + 8) and 32 of their 128 scores; the row max is reduced
//    over the quad of threads sharing the row by two shuffles, then
//    exp2 of the scaled scores on the SFU and the rescale of O by
//    exp(m_old - m_new). The row sums stay per thread until the end.
//  * P.V: P is rounded to bf16 and fed as wgmma's register A operand
//    (the accumulator layout of a 16-key slice is the A fragment
//    layout); V is the B operand, MN-major (wgmma's bf16 transpose)
//    straight from the TMA tile; O accumulates in f32 registers.
//  * Overlap: the two warpgroups interleave on the SM, one's softmax
//    beside the other's products. (Issuing a tile's scores with the
//    previous tile's P.V inside one warpgroup measured no faster on the
//    H100; PERF.md.)
//  * Skipped tiles: the key tiles outside [the first key the window lets
//    the tile's first row see, the last key its last row sees (causal:
//    its diagonal; prefix-LM: the prefix's last key instead, for a tile
//    that starts in the prefix, where that is farther) or the last key]
//    are never loaded; a warpgroup skips the math of a tile that is
//    masked for all its 64 rows. The mask (kp <= qp when causal, or
//    kp <= the row's last key under the prefix, the window, kp < Sk) is
//    applied only on tiles that straddle the diagonal, the prefix's end,
//    the window's edge or Sk. A zero-filled key past Sk scores 0, not
//    -inf: the Sk test is what keeps it out of the softmax.
//  * -1e30 masking, as the reference: a row whose first visited tile is
//    all masked gathers weight-1 garbage that its first unmasked tile
//    scales by exp2((-1e30 - m) * c) = 0; every row reaches its diagonal
//    (causal; the prefix only adds keys before and past it) or sees key
//    0 in its first tile (not causal).
//
// bf16 P adds ~2^-9 relative error per weight; the check against the
// plain f32 version stays at one bf16 ulp of the output (2e-2).
//
// f32 keeps the SIMT kernel on purpose: its tolerance (2e-5) rules out
// TF32 tiles, that kernel already beats scaled_dot_product_attention in
// f32, and the full-width paths run f32 only in tests and reduced checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mask.cuh"
#include "hopper.cuh"
#include "select_common.cuh"

namespace idkd {

constexpr int FT_ROWS = 128;     // q rows per block (2 consumer warpgroups)
constexpr int FT_ROW_BYTES = 128;  // one 64-dim row of bf16

template <int D>
struct FtSmem {
  static constexpr int NB = (D + 63) / 64;                 // column blocks
  static constexpr int KEYS = D > 128 ? 64 : 128;          // keys per tile
  static constexpr int STAGES = D > 128 ? 2 : 3;           // K/V ring depth
  // 2 consumer warpgroups and a producer warp, or at D = 256 a producer
  // warpgroup whose registers setmaxnreg hands to the consumers
  static constexpr int THREADS = D > 128 ? 384 : 288;
  static constexpr int Q_BYTES = NB * FT_ROWS * FT_ROW_BYTES;
  static constexpr int KV_BYTES = NB * KEYS * FT_ROW_BYTES;  // K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "past the H100's shared memory a block");
};

// A consumer thread's rows and the mask's parameters.
struct FtRows {
  int a, b;        // the thread's two q rows (a and a + 8)
  int c0, c1;      // its warpgroup's 64 rows
  int col;         // its column within each 8-key group
  int Sk, window, prefix;
  float scale_log2;
};

// The last key row qp sees: its diagonal, or under the prefix-LM mask
// fa_last_key's (cross-attention does not ask).
template <int MODE>
__device__ __forceinline__ int ft_last(int qp, int prefix) {
  return MODE == FA_PREFIX ? fa_last_key(qp, prefix) : qp;
}

// Issue S = Q K^T for one KEYS-key tile: 64 x KEYS f32 scores of the
// warpgroup's rows, one wgmma per 16 head dims (no commit).
template <int D>
__device__ __forceinline__ void ft_scores(float (&sc)[FtSmem<D>::KEYS / 2],
                                          const uint8_t* Qw,
                                          const uint8_t* Ks) {
  constexpr int KEYS = FtSmem<D>::KEYS;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int nb = kk / 4, off = (kk % 4) * 32;
    const uint64_t da =
        sw128_desc(Qw + nb * FT_ROWS * FT_ROW_BYTES + off, 16);
    const uint64_t db = sw128_desc(Ks + nb * KEYS * FT_ROW_BYTES + off, 16);
    if constexpr (KEYS == 128)
      wgmma_m64n128k16_ss(sc, da, db, kk > 0);
    else
      wgmma_m64n64k16_ss<0, 0>(sc, da, db, kk > 0);
  }
}

// Issue O += P V for one tile, P from registers (no commit).
template <int D>
__device__ __forceinline__ void ft_pv(
    float (&oacc)[FtSmem<D>::NB][32],
    const uint32_t (&pa)[FtSmem<D>::KEYS / 16][4], const uint8_t* Vs) {
  constexpr int KEYS = FtSmem<D>::KEYS;
#pragma unroll
  for (int nb = 0; nb < FtSmem<D>::NB; ++nb)
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      const uint64_t db = sw128_desc(
          Vs + nb * KEYS * FT_ROW_BYTES + kk * 16 * FT_ROW_BYTES, 1024);
      wgmma_m64n64k16_rs_tb(oacc[nb], pa[kk], db, 1);
    }
}

// Mask the tile's scores where it straddles the diagonal (or the prefix's
// end), the window's edge or Sk; fold them into the running (m, l) of the
// thread's two rows; leave exp2((s - m) * c) in sc and the rescale factors
// of O in al_*. FA_CROSS: only keys past Sk are masked (the window is 0);
// FA_PREFIX: the window is 0.
template <int MODE, int KEYS>
__device__ __forceinline__ void ft_softmax(float (&sc)[KEYS / 2],
                                           const FtRows& r, int k0,
                                           float& m_a, float& m_b,
                                           float& l_a, float& l_b,
                                           float& al_a, float& al_b) {
  constexpr int N8 = KEYS / 8;   // the tile's 8-key accumulator groups
  const bool need_mask =
      MODE == FA_CROSS
          ? k0 + KEYS > r.Sk
          : k0 + KEYS - 1 > ft_last<MODE>(r.c0, r.prefix) ||
                k0 + KEYS > r.Sk ||
                (MODE == FA_CAUSAL && r.window > 0 &&
                 r.c1 - k0 >= r.window);
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + r.col + (e & 1);
        const int qp = e < 2 ? r.a : r.b;
        const bool ok =
            MODE == FA_CROSS
                ? kp < r.Sk
                : kp <= ft_last<MODE>(qp, r.prefix) && kp < r.Sk &&
                      (MODE == FA_PREFIX || r.window <= 0 ||
                       qp - kp < r.window);
        if (!ok) sc[4 * j + e] = NEG;
      }
  }
  float mx_a = NEG, mx_b = NEG;
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  const float c = r.scale_log2;
  al_a = fast_exp2((m_a - mn_a) * c);
  al_b = fast_exp2((m_b - mn_b) * c);
  m_a = mn_a;
  m_b = mn_b;
  float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    sc[4 * j] = fast_exp2((sc[4 * j] - mn_a) * c);
    sc[4 * j + 1] = fast_exp2((sc[4 * j + 1] - mn_a) * c);
    sc[4 * j + 2] = fast_exp2((sc[4 * j + 2] - mn_b) * c);
    sc[4 * j + 3] = fast_exp2((sc[4 * j + 3] - mn_b) * c);
    ps_a += sc[4 * j] + sc[4 * j + 1];
    ps_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l_a = l_a * al_a + ps_a;
  l_b = l_b * al_b + ps_b;
}

// P as the A operand: the 16-key slice kk is accumulator n8 tiles 2kk and
// 2kk + 1, in the A fragment's register order, rounded to bf16.
template <int KEYS>
__device__ __forceinline__ void ft_pack(const float (&sc)[KEYS / 2],
                                        uint32_t (&pa)[KEYS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// LSE: write each row's log-sum-exp to lse (the training forward's); a
// template parameter, so the round's kernel is compiled without the store
// (a runtime test of the pointer cost 2.5% there, PERF.md). MODE
// (FA_CAUSAL, FA_CROSS, FA_PREFIX): the mask, a template parameter too,
// so that the causal kernel stays the self-attention kernel it was.
template <int D, bool LSE, int MODE>
__global__ void __launch_bounds__(FtSmem<D>::THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Sk, int H,
                          int KVH, int window, float scale_log2,
                          int prefix) {
  using L = FtSmem<D>;
  constexpr int NB = L::NB;
  constexpr int KEYS = L::KEYS;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FT_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q_last = min(q0 + FT_ROWS, Sq) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / KEYS;
  const int t_end =
      (MODE == FA_CROSS ? Sk - 1 : ft_last<MODE>(q_last, prefix)) / KEYS;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (L::THREADS > 288 ? warp >= 8 : warp == 8) {
    // ------------------------------- producer warp (warpgroup at D = 256)
    if constexpr (L::THREADS > 288) setmaxnreg_dec<40>();
    if (lane == 0 && (L::THREADS == 288 || warp == 8)) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int nb = 0; nb < NB; ++nb)
        tma_load_4d(Qs + nb * FT_ROWS * FT_ROW_BYTES, &tq, q_full, nb * 64,
                    h, q0, b);
      for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        uint8_t* Ks = smem + L::Q_BYTES + s * L::STAGE_BYTES;
        uint8_t* Vs = Ks + L::KV_BYTES;
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(Ks + nb * KEYS * FT_ROW_BYTES, &tk, &full[s],
                      nb * 64, kvh, t * KEYS, b);
          tma_load_4d(Vs + nb * KEYS * FT_ROW_BYTES, &tv, &full[s],
                      nb * 64, kvh, t * KEYS, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------- consumer warpgroups
  if constexpr (L::THREADS > 288) setmaxnreg_inc<232>();
  const int wg = warp / 4;             // 0 or 1: rows 64*wg .. 64*wg + 63
  const int wrow = 16 * (warp % 4) + lane / 4;
  FtRows r;
  r.a = q0 + 64 * wg + wrow;           // this thread's two rows
  r.b = r.a + 8;
  r.c0 = q0 + 64 * wg;                 // the warpgroup's row range
  r.c1 = r.c0 + 63;
  r.col = 2 * (lane % 4);              // this thread's column in an n8
  r.Sk = Sk;
  r.window = window;
  r.prefix = prefix;
  r.scale_log2 = scale_log2;
  const uint8_t* Qw = Qs + wg * 64 * FT_ROW_BYTES;

  // the key tiles [ta, tb] this warpgroup computes: the block's range
  // without the tiles masked for all its 64 rows, which it only waits for
  // and releases
  int ta = t_begin;
  const int tb = MODE == FA_CROSS
                     ? t_end
                     : min(t_end, ft_last<MODE>(r.c1, prefix) / KEYS);
  if (r.c0 >= Sq) ta = t_end + 1;
  while (ta <= tb && window > 0 && ta * KEYS + KEYS - 1 <= r.c0 - window)
    ++ta;
  auto stage = [&](int t) { return (t - t_begin) % STAGES; };
  auto parity = [&](int t) { return ((t - t_begin) / STAGES) & 1; };
  auto kv = [&](int t) {
    return smem + L::Q_BYTES + stage(t) * L::STAGE_BYTES;
  };

  float oacc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[nb][i] = 0.0f;
  float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f, al_a, al_b;
  float sc[KEYS / 2];
  uint32_t pa[KEYS / 16][4];

  mbar_wait(q_full, 0);
  for (int t = t_begin; t <= t_end; ++t) {
    mbar_wait(&full[stage(t)], parity(t));
    if (ta <= t && t <= tb) {
      wgmma_fence();
      ft_scores<D>(sc, Qw, kv(t));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      ft_softmax<MODE, KEYS>(sc, r, t * KEYS, m_a, m_b, l_a, l_b, al_a,
                             al_b);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          oacc[nb][4 * j] *= al_a;
          oacc[nb][4 * j + 1] *= al_a;
          oacc[nb][4 * j + 2] *= al_b;
          oacc[nb][4 * j + 3] *= al_b;
        }
      ft_pack<KEYS>(sc, pa);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(oacc[nb]);
      wgmma_fence();
      ft_pv<D>(oacc, pa, kv(t) + L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(oacc[nb]);
    }
    mbar_arrive(&empty[stage(t)]);
  }

  // the quad's partial row sums, then O / l in bf16
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  if constexpr (LSE) {
    // the rows' log-sum-exp of the scaled scores, for the backward pass:
    // m is in raw score units, l sums exp((s - m) * scale)
    if (r.col == 0) {
      const float scale = scale_log2 * 0.6931471805599453f;
      float* lr = lse + ((size_t)b * H + h) * Sq;
      if (r.a < Sq) lr[r.a] = m_a * scale + logf(l_a);
      if (r.b < Sq) lr[r.b] = m_b * scale + logf(l_b);
    }
  }
  const size_t row_stride = (size_t)H * D;
  __nv_bfloat16* oa = o + ((size_t)b * Sq + r.a) * row_stride + (size_t)h * D;
  __nv_bfloat16* ob = oa + 8 * row_stride;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = nb * 64 + 8 * j + r.col;
      if (d >= D) continue;            // D = 96: the zero-filled columns
      if (r.a < Sq)
        *reinterpret_cast<uint32_t*>(oa + d) = pack_bf16x2(
            oacc[nb][4 * j] * inv_a, oacc[nb][4 * j + 1] * inv_a);
      if (r.b < Sq)
        *reinterpret_cast<uint32_t*>(ob + d) = pack_bf16x2(
            oacc[nb][4 * j + 2] * inv_b, oacc[nb][4 * j + 3] * inv_b);
    }
}

template <int D, bool LSE>
auto ft_kernel(int mode) {
  return mode == FA_PREFIX  ? flash_attention_tc_kernel<D, LSE, FA_PREFIX>
         : mode == FA_CROSS ? flash_attention_tc_kernel<D, LSE, FA_CROSS>
                            : flash_attention_tc_kernel<D, LSE, FA_CAUSAL>;
}

template <int D>
cudaError_t ft_launch(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Sk, int H, int KVH,
                      int window, int mode, int prefix,
                      cudaStream_t stream) {
  // q (B, Sq, H, D) and k/v (B, Sk, KVH, D) as 4-D maps, innermost first
  CUtensorMap mq, mk, mv;
  const cuuint64_t dq[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq,
                            (cuuint64_t)B};
  const cuuint64_t sq[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                            (cuuint64_t)Sq * H * D * 2};
  const cuuint64_t dk[4] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)Sk,
                            (cuuint64_t)B};
  const cuuint64_t sk[3] = {(cuuint64_t)D * 2, (cuuint64_t)KVH * D * 2,
                            (cuuint64_t)Sk * KVH * D * 2};
  const cuuint32_t bq[4] = {64, 1, FT_ROWS, 1};
  const cuuint32_t bk[4] = {64, 1, FtSmem<D>::KEYS, 1};
  if (!make_map_bf16(&mq, q, 4, dq, sq, bq) ||
      !make_map_bf16(&mk, k, 4, dk, sk, bk) ||
      !make_map_bf16(&mv, v, 4, dk, sk, bk))
    return cudaErrorInvalidValue;
  const int smem = FtSmem<D>::BYTES;
  auto kernel = lse != nullptr ? ft_kernel<D, true>(mode)
                               : ft_kernel<D, false>(mode);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FT_ROWS - 1) / FT_ROWS, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<grid, FtSmem<D>::THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, KVH,
      window, scale_log2, prefix);
  return cudaGetLastError();
}

}  // namespace idkd

// bf16 q/o (B, Sq, H, D), k/v (B, Sk, KVH, D), contiguous, 16-byte
// aligned; D in {64, 96, 128, 256}; H % KVH == 0; causal 1: Sk == Sq,
// window 0 = full causal, prefix 0 <= P <= Sk (0: none; P > 0 with window
// 0 only); causal 0: every key visible (window 0, prefix 0); lse null, or
// (B, H, Sq) f32 for the rows' log-sum-exp (training only). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernel does not take or a tensor map the driver refuses).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int Sq, int Sk, int H,
                                         int KVH, int D, int window,
                                         int causal, int prefix,
                                         void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0 ||
      !idkd::fa_mode_ok(Sq, Sk, window, causal, prefix))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int m = !causal ? idkd::FA_CROSS
                        : prefix > 0 ? idkd::FA_PREFIX : idkd::FA_CAUSAL;
  switch (D) {
    case 64:
      return (int)idkd::ft_launch<64>(q, k, v, o, l, B, Sq, Sk, H, KVH,
                                      window, m, prefix, s);
    case 96:
      return (int)idkd::ft_launch<96>(q, k, v, o, l, B, Sq, Sk, H, KVH,
                                      window, m, prefix, s);
    case 128:
      return (int)idkd::ft_launch<128>(q, k, v, o, l, B, Sq, Sk, H, KVH,
                                       window, m, prefix, s);
    case 256:
      return (int)idkd::ft_launch<256>(q, k, v, o, l, B, Sq, Sk, H, KVH,
                                       window, m, prefix, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
