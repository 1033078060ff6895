// flash_attention's backward pass, bf16 on Hopper's tensor cores (sm_90a):
// the gradients of causal grouped-query attention with a per-layer
// sliding window and a ragged tail, given the forward's output O and its
// rows' log-sum-exp. The bf16 variant of the port's attention backward,
// for head_dim 64 and 128 (f32, and bf16 at head_dim 32, run
// csrc/flash_attention_bwd.cu).
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
// q/o/dO (B, S, H, D), k/v (B, S, KVH, D) bf16; head h reads kv head
// h / (H / KVH); key kp is visible to row qp iff kp <= qp and, when
// window > 0, qp - window < kp; lse (B, H, S) f32; gradients bf16.
//
// Bound on the H100. Five products of the (causal, windowed) score
// matrix's size, 2.5x the forward's matmul work: at Hymba's training
// shape (B 2, S 2176, 25/5 heads x 64) 76 GFLOP global, 54 GFLOP at
// window 1024, against ~28 MB of inputs and outputs: bound by the bf16
// tensor cores (989 TFLOP/s), and at D = 64 nearly as much by the one
// exponential per score on the SFU.
//
// Design: three kernels a call.
//  * fbt_prep: one warp per (b, h, row): D = rowsum(dO o O) and the
//    row's lse * log2(e) side by side in an f32 (B, H, Sp, 2) array
//    (Sp = S rounded up to 64; padding rows get lse = 1e30, so P = 0),
//    and the row of the f32 dQ accumulator (B, H, Sp, D) zeroed.
//  * fbt_main: one block per (b, query head h, 64-key tile), 850 blocks
//    at Hymba's training shape, key tiles that see the most query tiles
//    first. One consumer warpgroup owns the 64 keys; one producer warp
//    loads the key tile's K and V once by TMA, then streams 64-row Q and
//    dO tiles (128-byte swizzle, as flash_attention_tc.cu) with their
//    rows' (lse, D) through a ring of 2 shared-memory stages guarded by
//    full / empty mbarriers, from the diagonal to the window's far edge.
//    Per query tile, all on the accumulator fragments of the warpgroup's
//    64 keys:
//      S^T = K Q^T and dP^T = V dO^T: wgmma, both operands K-major;
//      P^T = exp2(S^T scale log2e - lse log2e), masked only on the tiles
//        that straddle the diagonal or the window's edge; dS^T =
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
//    to per-query-head f32 partials (B, S, H, D).
//  * fbt_finish: dK = scale * (the group's G partials summed in a fixed
//    order), dV likewise unscaled, dQ = scale * accumulator, to bf16.
// dK and dV are the same from run to run; dQ's additions from the key
// tiles arrive in the order the blocks run, so its last bits vary.
// Registers: at D = 64 two blocks share an SM (one warpgroup each; ptxas
// gives fbt_main 168 registers a thread, no spills); at D = 128 the dK
// and dV fragments take 128 registers, dQ's two 64-column halves are
// formed one after the other, and one block runs per SM (254 registers,
// no spills). ptxas's report is in
// build/kernels/libflash_attention_bwd_tc-*.log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace idkd {

constexpr int FBT_TILE = 64;        // keys per block; query rows per tile
constexpr int FBT_STAGES = 2;       // Q / dO ring depth
constexpr int FBT_THREADS = 160;    // 1 consumer warpgroup + 1 producer warp
constexpr int FBT_CONSUMERS = 128;
constexpr float FBT_LOG2E = 1.4426950408889634f;

template <int D>
struct FbtSmem {
  static constexpr int NB = D / 64;                 // 64-dim column blocks
  static constexpr int TILE = NB * FBT_TILE * 128;  // a 64-row bf16 tile
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int STAGES = 2 * TILE;   // stage s: Q, then dO
  static constexpr int DS = STAGES + FBT_STAGES * 2 * TILE;  // dS^T bf16
  static constexpr int DQS = D + 8;         // dQ row stride (floats)
  static constexpr int DQ = DS + FBT_TILE * 128;
  static constexpr int LD = DQ + FBT_TILE * DQS * 4;   // (lse, D) rows
  static constexpr int BAR = LD + FBT_STAGES * FBT_TILE * 8;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * FBT_STAGES) + 1024;
  static_assert(DS % 1024 == 0 && DQ % 16 == 0 && LD % 16 == 0,
                "swizzled tiles on 1024 bytes, bulk copies on 16");
};

// D and lse * log2(e) per (b, h, row), rows padded to Sp; the dQ
// accumulator's rows zeroed. One warp per row.
template <int D>
__global__ void __launch_bounds__(256)
fbt_prep(const __nv_bfloat16* __restrict__ o,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, float2* __restrict__ ld,
         float* __restrict__ dq_acc, long long rows, int S, int Sp, int H) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = (int)(row % Sp);
  const long long bh = row / Sp;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  float acc = 0.0f;
  if (s < S) {
    const size_t off = (((size_t)b * S + s) * H + h) * D;
#pragma unroll
    for (int d = 2 * lane; d < D; d += 64) {
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
    ld[row] = s < S ? make_float2(lse[(size_t)bh * S + s] * FBT_LOG2E, acc)
                    : make_float2(1e30f, 0.0f);
}

// One wgmma per 16 head dims: acc (64 x 64) = A B^T with A, B the 64-row
// K-major tiles (keys against query rows).
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
// (64 rows x D, MN-major from a TMA tile)
template <int D>
__device__ __forceinline__ void fbt_accumulate(float (&acc)[D / 64][32],
                                               const uint32_t (&a)[4][4],
                                               const uint8_t* T) {
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs_tb(
          acc[nb], a[kk],
          sw128_desc(T + nb * FBT_TILE * 128 + kk * 16 * 128, 1024), 1);
}

template <int D>
__global__ void __launch_bounds__(FBT_THREADS, D == 64 ? 2 : 1)
fbt_main(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tdo,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const float2* __restrict__ ld, float* __restrict__ dq_acc,
         float* __restrict__ dk_part, float* __restrict__ dv_part, int S,
         int Sp, int H, int KVH, int window, float scale_log2) {
  using L = FbtSmem<D>;
  constexpr int NB = L::NB;
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
  const int k_last = min(k0 + FBT_TILE, S) - 1;
  const int q_last = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const int t_begin = kt, t_end = q_last / FBT_TILE;

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

  // ------------------------------------------------ consumer warpgroup
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r_a = 16 * warp + g, r_b = r_a + 8;   // the thread's key rows
  const int kp_a = k0 + r_a, kp_b = k0 + r_b;
  const uint8_t* Ks = smem + L::K;
  const uint8_t* Vs = smem + L::V;
  uint8_t* dST = smem + L::DS;
  float* dQs = reinterpret_cast<float*>(smem + L::DQ);

  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
    const int s = i % FBT_STAGES;
    mbar_wait(&full[s], (i / FBT_STAGES) & 1);
    const uint8_t* Qs = smem + L::STAGES + s * 2 * L::TILE;
    const uint8_t* dOs = Qs + L::TILE;
    const float2* lds =
        reinterpret_cast<const float2*>(smem + L::LD + s * FBT_TILE * 8);
    const int q0 = t * FBT_TILE;

    // S^T = K Q^T and dP^T = V dO^T
    float sc[32], dp[32];
    wgmma_fence();
    fbt_scores<D>(sc, Ks, Qs);
    fbt_scores<D>(dp, Vs, dOs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T on the fragments: element 4j + e is key row r_a
    // (e < 2) or r_b, query column 8j + c2 + (e & 1)
    const bool need_mask =
        t == kt || (window > 0 && q0 + FBT_TILE - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c2 + (e & 1);
        const float2 l = lds[col];
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -l.x));
        if (need_mask) {
          const int qp = q0 + col, kp = e < 2 ? kp_a : kp_b;
          if (kp > qp || (window > 0 && qp - kp >= window)) p = 0.0f;
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
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dv[nb]);
      fence_regs(dk[nb]);
    }
    wgmma_fence();
    fbt_accumulate<D>(dv, pa, dOs);
    fbt_accumulate<D>(dk, da, Qs);
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
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dv[nb]);
      fence_regs(dk[nb]);
    }
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

  // the block's dK (unscaled) and dV into the per-query-head partials
  const size_t row_stride = (size_t)H * D;
  const size_t off_a = ((size_t)b * S + kp_a) * row_stride + (size_t)h * D;
  const size_t off_b = off_a + 8 * row_stride;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = nb * 64 + 8 * j + c2;
      if (kp_a < S) {
        *reinterpret_cast<float2*>(dk_part + off_a + d) =
            make_float2(dk[nb][4 * j], dk[nb][4 * j + 1]);
        *reinterpret_cast<float2*>(dv_part + off_a + d) =
            make_float2(dv[nb][4 * j], dv[nb][4 * j + 1]);
      }
      if (kp_b < S) {
        *reinterpret_cast<float2*>(dk_part + off_b + d) =
            make_float2(dk[nb][4 * j + 2], dk[nb][4 * j + 3]);
        *reinterpret_cast<float2*>(dv_part + off_b + d) =
            make_float2(dv[nb][4 * j + 2], dv[nb][4 * j + 3]);
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

// dq (B, S, H, D) from the accumulator (B, H, Sp, D); dk, dv
// (B, S, KVH, D) from the partials (B, S, H, D), each group's G heads
// summed in order. Four dims a thread.
template <int D>
__global__ void __launch_bounds__(256)
fbt_finish(const float* __restrict__ dq_acc,
           const float* __restrict__ dk_part,
           const float* __restrict__ dv_part, __nv_bfloat16* __restrict__ dq,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           long long nq4, long long nk4, int S, int Sp, int H, int KVH,
           float scale) {
  constexpr int D4 = D / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int d = 4 * (int)(e % D4);
  if (e < nq4) {
    const long long r = e / D4;            // (b, s, h)
    const int h = (int)(r % H);
    const long long bs = r / H;
    const int s = (int)(bs % S);
    const long long b = bs / S;
    const float4 v = *reinterpret_cast<const float4*>(
        dq_acc + (((size_t)b * H + h) * Sp + s) * D + d);
    fbt_store4(dq + (size_t)r * D + d, v, scale);
  }
  if (e < nk4) {
    const long long r = e / D4;            // (b, s, kvh)
    const int kvh = (int)(r % KVH);
    const long long bs = r / KVH;
    const int G = H / KVH;
    const float* pk = dk_part + ((size_t)bs * H + (size_t)kvh * G) * D + d;
    const float* pv = dv_part + ((size_t)bs * H + (size_t)kvh * G) * D + d;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < G; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(pk + (size_t)g * D);
      const float4 c = *reinterpret_cast<const float4*>(pv + (size_t)g * D);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    fbt_store4(dk + (size_t)r * D + d, sk, scale);
    fbt_store4(dv + (size_t)r * D + d, sv, 1.0f);
  }
}

template <int D>
cudaError_t fbt_launch(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float2* ld, float* dq_acc, float* dk_part,
                       float* dv_part, void* dq, void* dk, void* dv, int B,
                       int S, int H, int KVH, int window,
                       cudaStream_t stream) {
  const int tiles = (S + FBT_TILE - 1) / FBT_TILE, Sp = tiles * FBT_TILE;
  CUtensorMap mq, mdo, mk, mv;
  const cuuint64_t dq_dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                                 (cuuint64_t)B};
  const cuuint64_t sq[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                            (cuuint64_t)S * H * D * 2};
  const cuuint64_t dk_dims[4] = {(cuuint64_t)D, (cuuint64_t)KVH,
                                 (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t sk[3] = {(cuuint64_t)D * 2, (cuuint64_t)KVH * D * 2,
                            (cuuint64_t)S * KVH * D * 2};
  const cuuint32_t box[4] = {64, 1, FBT_TILE, 1};
  if (!make_map_bf16(&mq, q, 4, dq_dims, sq, box) ||
      !make_map_bf16(&mdo, dout, 4, dq_dims, sq, box) ||
      !make_map_bf16(&mk, k, 4, dk_dims, sk, box) ||
      !make_map_bf16(&mv, v, 4, dk_dims, sk, box))
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sp;
  fbt_prep<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, ld, dq_acc, rows, S, Sp,
      H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = FbtSmem<D>::BYTES;
  err = cudaFuncSetAttribute(fbt_main<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  fbt_main<D><<<dim3(H, B, tiles), FBT_THREADS, smem, stream>>>(
      mq, mdo, mk, mv, ld, dq_acc, dk_part, dv_part, S, Sp, H, KVH, window,
      scale * FBT_LOG2E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long nq4 = (long long)B * S * H * (D / 4);
  const long long nk4 = (long long)B * S * KVH * (D / 4);
  fbt_finish<D><<<(unsigned)((nq4 + 255) / 256), 256, 0, stream>>>(
      dq_acc, dk_part, dv_part, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), nq4,
      nk4, S, Sp, H, KVH, scale);
  return cudaGetLastError();
}

}  // namespace idkd

// bf16 q/o/dout/dq (B, S, H, D), k/v/dk/dv (B, S, KVH, D), contiguous,
// 16-byte aligned; lse (B, H, S) f32 from the forward. Scratch (f32):
// ld (B, H, Sp, 2), dq_acc (B, H, Sp, D) with Sp = S rounded up to 64,
// dk_part and dv_part (B, S, H, D). D in {64, 128}; H % KVH == 0; window
// 0 = full causal. Three launches; returns cudaGetLastError() after them
// (cudaErrorInvalidValue for a shape the kernel does not take or a
// tensor map the driver refuses).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ld, void* dq_acc, void* dk_part,
    void* dv_part, void* dq, void* dk, void* dv, int B, int S, int H, int KVH,
    int D, int window, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* ldp = static_cast<float2*>(ld);
  float* acc = static_cast<float*>(dq_acc);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  if (D == 64)
    return (int)idkd::fbt_launch<64>(q, k, v, o, dout, l, ldp, acc, pk, pv,
                                     dq, dk, dv, B, S, H, KVH, window, s);
  if (D == 128)
    return (int)idkd::fbt_launch<128>(q, k, v, o, dout, l, ldp, acc, pk, pv,
                                      dq, dk, dv, B, S, H, KVH, window, s);
  return (int)cudaErrorInvalidValue;
}
