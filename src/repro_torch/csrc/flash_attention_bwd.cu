// flash_attention's backward pass for Hopper (sm_90a): the gradients of
// grouped-query attention, causal with a per-layer sliding window or the
// prefix-LM mask, or bidirectional over a key set of its own length
// (cross-attention), with ragged tails, given the forward's output O and
// its rows' log-sum-exp.
//
// The JAX package has no backward Pallas kernel: its training
// differentiates chunked_attention (src/repro/models/attention.py) with
// XLA. The port runs flash_attention.cu / flash_attention_tc.cu in the
// forward pass (the replacement of flash_attention_pallas in
// src/repro/kernels/flash_attention/kernel.py), so its backward is a
// kernel too: the FlashAttention-2 formulas, the same as
// flash_attention_bwd_plain in kernels/flash_attention/ops.py:
//   D     = rowsum(dO o O)                                (fab_delta)
//   P     = exp(Q K^T * scale - lse), masked as the forward masks
//   dV    = P^T dO,  dS = P o (dO V^T - D)
//   dK    = dS^T Q * scale, summed over the group's query heads (fab_dkdv)
//   dQ    = dS K * scale                                  (fab_dq)
// q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, DV), o/dO (B, Sq, H,
// DV), float32 or bfloat16, DV = D except in MLA's mode (DeepSeek-V3's
// multi-head latent attention: (D, DV) = (192, 128), (48, 32) reduced),
// where Q K^T and dS K run over D and dO V^T, P^T dO over DV; head h
// reads kv head h / (H / KVH); causal (Sk = Sq): key kp is visible to row
// qp iff kp <= qp and, when window > 0, qp - window < kp, and with a
// prefix P > 0 also iff qp, kp < P (flash_mask.cuh); not causal: every key
// kp < Sk. Math in f32; gradients in the inputs' dtype.
//
// This is the SIMT variant: f32, and bf16 at head_dim 32. bf16 at
// head_dim 64, 96, 128 and 256 runs flash_attention_bwd_tc.cu on the tensor cores
// (P computed once, five products); this kernel keeps f32 math
// throughout, which f32 training's tolerance (1e-4 of max |grad|)
// needs and bf16 tensor-core operands would break.
//
// Design (a first, simple kernel):
//  * fab_delta: one warp per (b, s, h) row.
//  * fab_dkdv: one block per (b, kv head, 64-key tile) owns dK and dV of
//    its keys in registers and walks the group's query heads and the
//    query tiles that see its keys (from the diagonal, or the first row
//    when not causal or when the tile starts in the prefix, to the
//    window's far edge or the last row): no atomics, each key's sums in
//    one fixed order. Four threads share a key: each recomputes the
//    scores of a quarter of the walked tile's rows and owns a quarter of
//    the head dims.
//  * fab_dq: one block per (b, h, 64-row query tile), over the key tiles
//    the forward visits; four threads share a row, as in the forward.
//  Tiles sit in shared memory as f32 with rows padded by 4 floats, so
//  the float4 reads of eight rows fall in distinct banks. The walked
//  tile (query rows in fab_dkdv, keys in fab_dq) is 64 rows up to
//  head_dim 128 and 32 at 256: four 64-row f32 tiles of 256 dims would
//  take fb_smem_bytes = 301,568 bytes, past the H100's 232,448 a block;
//  with the walked tiles at 32 rows they take 218,368 (bf16 tiles would
//  fit 64 rows, but round the f32 inputs this variant exists to keep).
//  Each thread then holds 64 + 64 accumulator floats (dK, dV) at 256.
//
// Bound on the H100. The backward does 2.5x the forward's causal matmul
// work (five products of Q K^T's size against two); at Hymba's shape it
// is bound by operations. These kernels recompute P and dO V^T in both
// passes (seven products) on the SIMT units in f32, so they run far from
// that bound; PERF.md has their times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mask.cuh"
#include "select_common.cuh"

namespace idkd {

constexpr int FB_ROWS = 64;      // query rows (fab_dq) or keys (fab_dkdv)
constexpr int FB_THREADS = 256;  // four threads per row / key

// The walked side's tile: query rows (fab_dkdv) or keys (fab_dq); 32 when
// 64 would pass the H100's shared memory (D = DV = 256).
template <int D, int DV>
__host__ __device__ constexpr int fb_walk() { return D + DV > 320 ? 32 : 64; }

template <typename T>
__device__ __forceinline__ T fb_from_f(float x);
template <>
__device__ __forceinline__ float fb_from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 fb_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Two owned 64-row tiles, two walked tiles (one of each D dims, the other
// DV), the (64, walk) P and dS rows padded by 4, and the walked query
// rows' lse and D. MLA's (192, 128) takes 203,264 bytes.
template <int D, int DV>
constexpr size_t fb_smem_bytes() {
  constexpr int W = fb_walk<D, DV>();
  return sizeof(float) * ((FB_ROWS + W) * (D + 4 + DV + 4) +
                          2 * FB_ROWS * (W + 4) + 2 * W);
}

// Rows [s0, s0 + N) of head `head` of a (B, S, heads, D) tensor into an
// f32 tile of row stride D + 4; rows past S read zeros (S is the
// tensor's own length: Sq for q and dO, Sk for k and v).
template <typename T, int D, int N>
__device__ __forceinline__ void fb_load(float* dst, const T* src, int b,
                                        int s0, int head, int S, int heads) {
  const size_t row = (size_t)heads * D;
  const T* base = src + (size_t)b * S * row + (size_t)head * D;
  for (int e = threadIdx.x; e < N * D; e += FB_THREADS) {
    const int r = e / D, d = e % D, s = s0 + r;
    dst[r * (D + 4) + d] = s < S ? to_f(base[(size_t)s * row + d]) : 0.0f;
  }
}

// N / 4 dot products of row `a` of tile A with rows 4i + j of the N-row
// tile X.
template <int D, int N>
__device__ __forceinline__ void fb_dots(float (&out)[N / 4], const float* A,
                                        int a, const float* X, int j) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) out[i] = 0.0f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 av = *reinterpret_cast<const float4*>(&A[a * LD + 4 * d4]);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 xv =
          *reinterpret_cast<const float4*>(&X[(4 * i + j) * LD + 4 * d4]);
      out[i] = fmaf(av.x, xv.x, out[i]);
      out[i] = fmaf(av.y, xv.y, out[i]);
      out[i] = fmaf(av.z, xv.z, out[i]);
      out[i] = fmaf(av.w, xv.w, out[i]);
    }
  }
}

// acc[dims j + 4c] += sum over the N-row tile's rows of W[w][row] * X[row]
// (W's rows N + 4 floats apart).
template <int D, int N>
__device__ __forceinline__ void fb_accumulate(float (&acc)[D / 4],
                                              const float* W, int w,
                                              const float* X, int j) {
  constexpr int LD = D + 4;
  constexpr int CH = D / 16;
#pragma unroll 4
  for (int r = 0; r < N; ++r) {
    const float p = W[w * (N + 4) + r];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 xv =
          *reinterpret_cast<const float4*>(&X[r * LD + 4 * (j + 4 * c)]);
      acc[4 * c + 0] = fmaf(p, xv.x, acc[4 * c + 0]);
      acc[4 * c + 1] = fmaf(p, xv.y, acc[4 * c + 1]);
      acc[4 * c + 2] = fmaf(p, xv.z, acc[4 * c + 2]);
      acc[4 * c + 3] = fmaf(p, xv.w, acc[4 * c + 3]);
    }
  }
}

__device__ __forceinline__ bool fb_visible(int qp, int kp, int Sq, int Sk,
                                           int window, bool causal,
                                           int prefix) {
  return qp < Sq && kp < Sk && (!causal || kp <= fa_last_key(qp, prefix)) &&
         (window <= 0 || qp - kp < window);
}

// D = rowsum(dO o O) per (b, h, s), f32 (B, H, S): one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
fab_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, int B, int S, int H, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (long long)B * S * H) return;
  const int lane = threadIdx.x % 32;
  const T* po = o + row * D;
  const T* pd = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(po[d]), to_f(pd[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;          // b * S + s
    const int s = (int)(bs % S), b = (int)(bs / S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// dK, dV of one (b, kv head, 64-key tile).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(FB_THREADS)
fab_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
         int KVH, int window, bool causal, int prefix, float scale) {
  constexpr int LD = D + 4, LV = DV + 4;
  constexpr int CH = D / 16, CV = DV / 16;
  constexpr int W = fb_walk<D, DV>();   // query rows per walked tile
  constexpr int LP = W + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + FB_ROWS * LD;
  float* Qs = Vs + FB_ROWS * LV;
  float* Os = Qs + W * LD;              // dO tile
  float* Ps = Os + W * LV;              // P[key][row]
  float* Ds = Ps + FB_ROWS * LP;        // dS[key][row]
  float* Ls = Ds + FB_ROWS * LP;        // the q tile's lse
  float* Es = Ls + W;                   // and its D

  const int k0 = blockIdx.x * FB_ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int r = tid >> 2;               // the thread's key in the tile
  const int j = tid & 3;
  const int kp = k0 + r;

  fb_load<T, D, FB_ROWS>(Ks, k, b, k0, kvh, Sk, KVH);
  fb_load<T, DV, FB_ROWS>(Vs, v, b, k0, kvh, Sk, KVH);

  // query tiles that see a key of this tile: from the first row that sees
  // its first key (causal: the diagonal, or row 0 for a tile that starts
  // in the prefix) or the first row, to the last row the window lets
  // reach the tile's last key
  const int k_last = min(k0 + FB_ROWS, Sk) - 1;
  const int q_last = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int t_begin = causal ? fa_first_row(k0, prefix) / W : 0;
  const int t_end = q_last / W;

  float dka[4 * CH], dva[4 * CV];
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) dka[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4 * CV; ++i) dva[i] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lrow = lse + ((size_t)b * H + h) * Sq;
    const float* erow = delta + ((size_t)b * H + h) * Sq;
    for (int t = t_begin; t <= t_end; ++t) {
      const int q0 = t * W;
      __syncthreads();  // the previous tile's reads are done
      fb_load<T, D, W>(Qs, q, b, q0, h, Sq, H);
      fb_load<T, DV, W>(Os, dout, b, q0, h, Sq, H);
      if (tid < W) {
        const int s = q0 + tid;
        Ls[tid] = s < Sq ? lrow[s] : 0.0f;
        Es[tid] = s < Sq ? erow[s] : 0.0f;
      }
      __syncthreads();

      float sc[W / 4], dp[W / 4];
      fb_dots<D, W>(sc, Ks, r, Qs, j);
      fb_dots<DV, W>(dp, Vs, r, Os, j);
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const int row = 4 * i + j;
        const bool ok = fb_visible(q0 + row, kp, Sq, Sk, window, causal,
                                   prefix);
        const float p = ok ? expf(sc[i] * scale - Ls[row]) : 0.0f;
        Ps[r * LP + row] = p;
        Ds[r * LP + row] = p * (dp[i] - Es[row]);
      }
      __syncwarp();  // the key's four threads share their P and dS rows
      fb_accumulate<DV, W>(dva, Ps, r, Os, j);
      fb_accumulate<D, W>(dka, Ds, r, Qs, j);
    }
  }

  if (kp < Sk) {
    const size_t row = ((size_t)b * Sk + kp) * KVH + kvh;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d = 4 * (j + 4 * c);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dk[row * D + d + x] = fb_from_f<T>(dka[4 * c + x] * scale);
    }
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int d = 4 * (j + 4 * c);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dv[row * DV + d + x] = fb_from_f<T>(dva[4 * c + x]);
    }
  }
}

// dQ of one (b, h, 64-row query tile).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(FB_THREADS)
fab_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int Sq, int Sk, int H, int KVH, int window,
       bool causal, int prefix, float scale) {
  constexpr int LD = D + 4, LV = DV + 4;
  constexpr int CH = D / 16;
  constexpr int W = fb_walk<D, DV>();   // keys per walked tile
  constexpr int LP = W + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + FB_ROWS * LD;
  float* Ks = Os + FB_ROWS * LV;
  float* Vs = Ks + W * LD;
  float* Ds = Vs + W * LV;              // dS[row][key]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_ROWS;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 2;               // the thread's row in the tile
  const int j = tid & 3;
  const int qp = q0 + r;

  fb_load<T, D, FB_ROWS>(Qs, q, b, q0, h, Sq, H);
  fb_load<T, DV, FB_ROWS>(Os, dout, b, q0, h, Sq, H);
  const float l_r = qp < Sq ? lse[((size_t)b * H + h) * Sq + qp] : 0.0f;
  const float e_r = qp < Sq ? delta[((size_t)b * H + h) * Sq + qp] : 0.0f;

  // the key tiles the forward visits
  const int q_last = min(q0 + FB_ROWS, Sq) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / W;
  const int t_end = (causal ? fa_last_key(q_last, prefix) : Sk - 1) / W;

  float dqa[4 * CH];
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) dqa[i] = 0.0f;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * W;
    __syncthreads();
    fb_load<T, D, W>(Ks, k, b, k0, kvh, Sk, KVH);
    fb_load<T, DV, W>(Vs, v, b, k0, kvh, Sk, KVH);
    __syncthreads();

    float sc[W / 4], dp[W / 4];
    fb_dots<D, W>(sc, Qs, r, Ks, j);
    fb_dots<DV, W>(dp, Os, r, Vs, j);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const int key = 4 * i + j;
      const bool ok = fb_visible(qp, k0 + key, Sq, Sk, window, causal,
                                 prefix);
      const float p = ok ? expf(sc[i] * scale - l_r) : 0.0f;
      Ds[r * LP + key] = p * (dp[i] - e_r);
    }
    __syncwarp();
    fb_accumulate<D, W>(dqa, Ds, r, Ks, j);
  }

  if (qp < Sq) {
    const size_t off = (((size_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d = 4 * (j + 4 * c);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dq[off + d + x] = fb_from_f<T>(dqa[4 * c + x] * scale);
    }
  }
}

template <typename T, int D, int DV = D>
cudaError_t fab_launch(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int KVH, int window,
                       bool causal, int prefix, cudaStream_t stream) {
  const size_t smem = fb_smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      fab_dkdv<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fab_dq<T, D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  const long long rows = (long long)B * Sq * H;
  fab_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, Sq, H,
      DV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int k_tiles = (Sk + FB_ROWS - 1) / FB_ROWS;
  fab_dkdv<T, D, DV><<<dim3(k_tiles, KVH, B), FB_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KVH, window,
      causal, prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int q_tiles = (Sq + FB_ROWS - 1) / FB_ROWS;
  fab_dq<T, D, DV><<<dim3(q_tiles, H, B), FB_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Sq, Sk, H, KVH, window, causal, prefix, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fab_dispatch(int D, int DV, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B,
                         int Sq, int Sk, int H, int KVH, int window,
                         bool causal, int prefix, cudaStream_t s) {
#define FAB_CASE(DIM)                                                     \
  case DIM:                                                               \
    return fab_launch<T, DIM>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, \
                              Sq, Sk, H, KVH, window, causal, prefix, s);
  // MLA's mode: qk head dim D, v head dim DV
  if (D == 48 && DV == 32)
    return fab_launch<T, 48, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Sq, Sk, H, KVH, window, causal, prefix, s);
  if (D == 192 && DV == 128)
    return fab_launch<T, 192, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, Sq, Sk, H, KVH, window, causal, prefix,
                                   s);
  if (DV != D) return cudaErrorInvalidValue;
  switch (D) {
    FAB_CASE(32)
    FAB_CASE(64)
    FAB_CASE(96)
    FAB_CASE(128)
    FAB_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FAB_CASE
}

}  // namespace idkd

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// q/dq (B, Sq, H, D), o/dout (B, Sq, H, DV), k/dk (B, Sk, KVH, D), v/dv
// (B, Sk, KVH, DV), contiguous; lse (B, H, Sq) f32 from the forward; delta
// (B, H, Sq) f32 scratch; DV = D in {32, 64, 96, 128, 256}, or (D, DV) in
// {(48, 32), (192, 128)}; H % KVH == 0; causal 1: Sk == Sq, window 0 =
// full causal, prefix 0 <= P <= Sk (0: none; P > 0 with window 0 only);
// causal 0: every key visible (window 0, prefix 0). Three launches;
// returns cudaGetLastError() after them.
extern "C" int flash_attention_bwd_launch(int dtype, const void* q,
                                          const void* k, const void* v,
                                          const void* o, const void* dout,
                                          const void* lse, void* delta,
                                          void* dq, void* dk, void* dv,
                                          int B, int Sq, int Sk, int H,
                                          int KVH, int D, int DV,
                                          int window, int causal, int prefix,
                                          void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0 ||
      !idkd::fa_mode_ok(Sq, Sk, window, causal, prefix))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* e = static_cast<float*>(delta);
  const bool c = causal != 0;
  if (dtype == 0)
    return (int)idkd::fab_dispatch<float>(D, DV, q, k, v, o, dout, l, e, dq, dk,
                                          dv, B, Sq, Sk, H, KVH, window, c,
                                          prefix, s);
  if (dtype == 1)
    return (int)idkd::fab_dispatch<__nv_bfloat16>(D, DV, q, k, v, o, dout, l, e,
                                                  dq, dk, dv, B, Sq, Sk, H,
                                                  KVH, window, c, prefix, s);
  return (int)cudaErrorInvalidValue;
}
