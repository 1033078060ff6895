// flash_attention's backward pass for Hopper (sm_90a): the gradients of
// causal grouped-query attention with a per-layer sliding window and a
// ragged tail, given the forward's output O and its rows' log-sum-exp.
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
// q/o/dO (B, S, H, D), k/v (B, S, KVH, D), float32 or bfloat16; head h
// reads kv head h / (H / KVH); key kp is visible to row qp iff kp <= qp
// and, when window > 0, qp - window < kp. Math in f32; gradients in the
// inputs' dtype.
//
// This is the SIMT variant: f32, and bf16 at head_dim 32. bf16 at
// head_dim 64 and 128 runs flash_attention_bwd_tc.cu on the tensor cores
// (P computed once, five products); this kernel keeps f32 math
// throughout, which f32 training's tolerance (1e-4 of max |grad|)
// needs and bf16 tensor-core operands would break.
//
// Design (a first, simple kernel):
//  * fab_delta: one warp per (b, s, h) row.
//  * fab_dkdv: one block per (b, kv head, 64-key tile) owns dK and dV of
//    its keys in registers and walks the group's query heads and the
//    query tiles that see its keys (from the diagonal to the window's
//    far edge): no atomics, each key's sums in one fixed order. Four
//    threads share a key: each recomputes the scores of 16 of the tile's
//    64 rows and owns a quarter of the head dims.
//  * fab_dq: one block per (b, h, 64-row query tile), over the key tiles
//    the forward visits; four threads share a row, as in the forward.
//  Tiles sit in shared memory as f32 with rows padded by 4 floats, so
//  the float4 reads of eight rows fall in distinct banks.
//
// Bound on the H100. The backward does 2.5x the forward's causal matmul
// work (five products of Q K^T's size against two); at Hymba's shape it
// is bound by operations. These kernels recompute P and dO V^T in both
// passes (seven products) on the SIMT units in f32, so they run far from
// that bound; PERF.md has their times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "select_common.cuh"

namespace idkd {

constexpr int FB_ROWS = 64;      // query rows (fab_dq) or keys (fab_dkdv)
constexpr int FB_TILE = 64;      // the other side's tile
constexpr int FB_THREADS = 256;  // four threads per row / key
constexpr int FB_LP = FB_TILE + 4;

template <typename T>
__device__ __forceinline__ T fb_from_f(float x);
template <>
__device__ __forceinline__ float fb_from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 fb_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t fb_smem_bytes() {
  return sizeof(float) *
         (4 * FB_ROWS * (D + 4) + 2 * FB_ROWS * FB_LP + 2 * FB_TILE);
}

// Rows [s0, s0 + 64) of head `head` of a (B, S, heads, D) tensor into an
// f32 tile of row stride D + 4; rows past S read zeros.
template <typename T, int D>
__device__ __forceinline__ void fb_load(float* dst, const T* src, int b,
                                        int s0, int head, int S, int heads) {
  const size_t row = (size_t)heads * D;
  const T* base = src + (size_t)b * S * row + (size_t)head * D;
  for (int e = threadIdx.x; e < FB_ROWS * D; e += FB_THREADS) {
    const int r = e / D, d = e % D, s = s0 + r;
    dst[r * (D + 4) + d] = s < S ? to_f(base[(size_t)s * row + d]) : 0.0f;
  }
}

// 16 dot products of row `a` of tile A with rows 4i + j of tile X.
template <int D>
__device__ __forceinline__ void fb_dots(float (&out)[16], const float* A,
                                        int a, const float* X, int j) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = 0.0f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 av = *reinterpret_cast<const float4*>(&A[a * LD + 4 * d4]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float4 xv =
          *reinterpret_cast<const float4*>(&X[(4 * i + j) * LD + 4 * d4]);
      out[i] = fmaf(av.x, xv.x, out[i]);
      out[i] = fmaf(av.y, xv.y, out[i]);
      out[i] = fmaf(av.z, xv.z, out[i]);
      out[i] = fmaf(av.w, xv.w, out[i]);
    }
  }
}

// acc[dims j + 4c] += sum over the tile's 64 rows of W[w][row] * X[row].
template <int D>
__device__ __forceinline__ void fb_accumulate(float (&acc)[D / 4],
                                              const float* W, int w,
                                              const float* X, int j) {
  constexpr int LD = D + 4;
  constexpr int CH = D / 16;
#pragma unroll 4
  for (int r = 0; r < FB_TILE; ++r) {
    const float p = W[w * FB_LP + r];
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

__device__ __forceinline__ bool fb_visible(int qp, int kp, int S,
                                           int window) {
  return kp <= qp && qp < S && kp < S && (window <= 0 || qp - kp < window);
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
template <typename T, int D>
__global__ void __launch_bounds__(FB_THREADS)
fab_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KVH,
         int window, float scale) {
  constexpr int LD = D + 4;
  constexpr int CH = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + FB_ROWS * LD;
  float* Qs = Vs + FB_ROWS * LD;
  float* Os = Qs + FB_TILE * LD;        // dO tile
  float* Ps = Os + FB_TILE * LD;        // P[key][row]
  float* Ds = Ps + FB_ROWS * FB_LP;     // dS[key][row]
  float* Ls = Ds + FB_ROWS * FB_LP;     // the q tile's lse
  float* Es = Ls + FB_TILE;             // and its D

  const int k0 = blockIdx.x * FB_ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int r = tid >> 2;               // the thread's key in the tile
  const int j = tid & 3;
  const int kp = k0 + r;

  fb_load<T, D>(Ks, k, b, k0, kvh, S, KVH);
  fb_load<T, D>(Vs, v, b, k0, kvh, S, KVH);

  // query tiles that see a key of this tile: from the diagonal to the
  // last row the window lets reach the tile's last key
  const int k_last = min(k0 + FB_ROWS, S) - 1;
  const int q_last = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const int t_begin = k0 / FB_TILE;
  const int t_end = q_last / FB_TILE;

  float dka[4 * CH], dva[4 * CH];
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) dka[i] = dva[i] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lrow = lse + ((size_t)b * H + h) * S;
    const float* erow = delta + ((size_t)b * H + h) * S;
    for (int t = t_begin; t <= t_end; ++t) {
      const int q0 = t * FB_TILE;
      __syncthreads();  // the previous tile's reads are done
      fb_load<T, D>(Qs, q, b, q0, h, S, H);
      fb_load<T, D>(Os, dout, b, q0, h, S, H);
      if (tid < FB_TILE) {
        const int s = q0 + tid;
        Ls[tid] = s < S ? lrow[s] : 0.0f;
        Es[tid] = s < S ? erow[s] : 0.0f;
      }
      __syncthreads();

      float sc[16], dp[16];
      fb_dots<D>(sc, Ks, r, Qs, j);
      fb_dots<D>(dp, Vs, r, Os, j);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = 4 * i + j;
        const bool ok = fb_visible(q0 + row, kp, S, window);
        const float p = ok ? expf(sc[i] * scale - Ls[row]) : 0.0f;
        Ps[r * FB_LP + row] = p;
        Ds[r * FB_LP + row] = p * (dp[i] - Es[row]);
      }
      __syncwarp();  // the key's four threads share their P and dS rows
      fb_accumulate<D>(dva, Ps, r, Os, j);
      fb_accumulate<D>(dka, Ds, r, Qs, j);
    }
  }

  if (kp < S) {
    const size_t off = (((size_t)b * S + kp) * KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d = 4 * (j + 4 * c);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        dk[off + d + x] = fb_from_f<T>(dka[4 * c + x] * scale);
        dv[off + d + x] = fb_from_f<T>(dva[4 * c + x]);
      }
    }
  }
}

// dQ of one (b, h, 64-row query tile).
template <typename T, int D>
__global__ void __launch_bounds__(FB_THREADS)
fab_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int S, int H, int KVH, int window, float scale) {
  constexpr int LD = D + 4;
  constexpr int CH = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + FB_ROWS * LD;
  float* Ks = Os + FB_ROWS * LD;
  float* Vs = Ks + FB_TILE * LD;
  float* Ds = Vs + FB_TILE * LD;        // dS[row][key]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_ROWS;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 2;               // the thread's row in the tile
  const int j = tid & 3;
  const int qp = q0 + r;

  fb_load<T, D>(Qs, q, b, q0, h, S, H);
  fb_load<T, D>(Os, dout, b, q0, h, S, H);
  const float l_r = qp < S ? lse[((size_t)b * H + h) * S + qp] : 0.0f;
  const float e_r = qp < S ? delta[((size_t)b * H + h) * S + qp] : 0.0f;

  const int q_last = min(q0 + FB_ROWS, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / FB_TILE;
  const int t_end = q_last / FB_TILE;

  float dqa[4 * CH];
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) dqa[i] = 0.0f;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * FB_TILE;
    __syncthreads();
    fb_load<T, D>(Ks, k, b, k0, kvh, S, KVH);
    fb_load<T, D>(Vs, v, b, k0, kvh, S, KVH);
    __syncthreads();

    float sc[16], dp[16];
    fb_dots<D>(sc, Qs, r, Ks, j);
    fb_dots<D>(dp, Os, r, Vs, j);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = 4 * i + j;
      const bool ok = fb_visible(qp, k0 + key, S, window);
      const float p = ok ? expf(sc[i] * scale - l_r) : 0.0f;
      Ds[r * FB_LP + key] = p * (dp[i] - e_r);
    }
    __syncwarp();
    fb_accumulate<D>(dqa, Ds, r, Ks, j);
  }

  if (qp < S) {
    const size_t off = (((size_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d = 4 * (j + 4 * c);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dq[off + d + x] = fb_from_f<T>(dqa[4 * c + x] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t fab_launch(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int S, int H, int KVH, int window,
                       cudaStream_t stream) {
  const size_t smem = fb_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fab_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fab_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  const long long rows = (long long)B * S * H;
  fab_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, S, H,
      D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (S + FB_ROWS - 1) / FB_ROWS;
  fab_dkdv<T, D><<<dim3(tiles, KVH, B), FB_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KVH, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fab_dq<T, D><<<dim3(tiles, H, B), FB_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, KVH, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fab_dispatch(int D, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B,
                         int S, int H, int KVH, int window, cudaStream_t s) {
  switch (D) {
    case 32:
      return fab_launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               S, H, KVH, window, s);
    case 64:
      return fab_launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               S, H, KVH, window, s);
    case 128:
      return fab_launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                S, H, KVH, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace idkd

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// q/o/dout/dq (B, S, H, D), k/v/dk/dv (B, S, KVH, D), contiguous; lse
// (B, H, S) f32 from the forward; delta (B, H, S) f32 scratch; D in {32,
// 64, 128}; H % KVH == 0; window 0 = full causal. Three launches; returns
// cudaGetLastError() after them.
extern "C" int flash_attention_bwd_launch(int dtype, const void* q,
                                          const void* k, const void* v,
                                          const void* o, const void* dout,
                                          const void* lse, void* delta,
                                          void* dq, void* dk, void* dv,
                                          int B, int S, int H, int KVH,
                                          int D, int window, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* e = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)idkd::fab_dispatch<float>(D, q, k, v, o, dout, l, e, dq, dk,
                                          dv, B, S, H, KVH, window, s);
  if (dtype == 1)
    return (int)idkd::fab_dispatch<__nv_bfloat16>(D, q, k, v, o, dout, l, e,
                                                  dq, dk, dv, B, S, H, KVH,
                                                  window, s);
  return (int)cudaErrorInvalidValue;
}
