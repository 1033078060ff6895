// flash_attention for Hopper (sm_90a): grouped-query attention with an
// online softmax, causal with a per-layer sliding window or the prefix-LM
// mask, or bidirectional over a key set of its own length
// (cross-attention), with ragged tails.
//
// Replaces the Pallas TPU kernel flash_attention_pallas / _flash_kernel in
// src/repro/kernels/flash_attention/kernel.py, and computes what the
// model's chunked_attention (src/repro/models/attention.py) computes on
// the decoder path, which the Pallas kernel alone does not. causal: per
// q row qp the keys kp with kp <= qp and, when window > 0,
// qp - window < kp (Sk = Sq); with a prefix P > 0 (PaliGemma's prefix-LM
// mask, flash_mask.cuh) also every kp < P for a row qp < P. Not causal
// (the Pallas kernel's causal=False): every key kp < Sk. Keys past Sk and
// rows past Sq are masked. q (B, Sq, H, D), k/v (B, Sk, KVH, D), float32 or bfloat16; head
// h reads kv head h / (H / KVH) without a copy; math in f32 with q scaled
// by 1/sqrt(D) first; output in q's dtype.
//
// Design. The TPU kernel carries (m, l, acc) in VMEM scratch across a
// sequential key grid axis. Here one block owns one (b, h, 64-row q tile)
// and walks the key tiles from the first that the window reaches to the
// last key its last row sees (its diagonal, or for a tile that starts in
// the prefix the prefix's last key if that is farther), or to the last
// key (not causal);
// tiles that are masked for every row of the block are never visited (the
// Pallas kernel's pl.when). Q, K and V tiles
// sit in shared memory as f32; four threads share a q row: each computes
// the scores of 16 of the tile's 64 keys and owns a quarter of the output
// dims, so (m, l) and acc live in registers. Masked scores are -1e30, not
// -inf, as in the reference: a row whose first visited tile is all masked
// accumulates weight-1 garbage that the first unmasked tile multiplies by
// exp(-1e30 - m) = 0, exactly as in chunked_attention; every row reaches
// its diagonal (the prefix only adds keys), or (not causal) sees key 0 in
// its first tile, so every row ends with a real maximum.
//
// Variants. This SIMT kernel serves float32 and bf16 at head_dim 32;
// bf16 at head_dim 64, 96, 128 and 256 runs flash_attention_tc.cu on the
// tensor cores. At head_dim 256 (PaliGemma) the three f32 tiles and the
// P rows take fa_smem_bytes<256> = 217,088 bytes of the H100's 232,448 a
// block, and each thread holds 64 output floats. f32 stays here on purpose: its tolerance (2e-5) rules out TF32
// tiles, this kernel already beats scaled_dot_product_attention in f32
// at Hymba's shape (8.6 vs 20.3 ms, PERF.md), and the full-width paths
// run f32 only in tests and the reduced checks.
//
// Bound on the H100. At Hymba's shape (S = 2176, H = 25, D = 64) the
// work is 4*S*S*D/2 flops per head for causal rows: bound by operations
// (1.8 ms at the f32 FMA rate). This kernel reads shared memory at about
// one float4 per four FMAs and reaches ~14 TFLOP/s, a fifth of that rate.
// Cross-attention at MusicGen's shape (Sq 1500, Sk 64, 24 heads x 64) is
// bound by bytes instead: q and o are read and written once, and the key
// set is one tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mask.cuh"
#include "select_common.cuh"

namespace idkd {

constexpr int FA_ROWS = 64;      // q rows per block
constexpr int FA_KEYS = 64;      // keys per tile
constexpr int FA_THREADS = 256;  // four threads per q row
constexpr int FA_LP = FA_KEYS + 4;

template <int D>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * (3 * FA_ROWS * (D + 4) + FA_ROWS * FA_LP);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// LSE: write each row's log-sum-exp to lse (the training forward's); a
// template parameter, so the round's kernel is compiled without the store
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk, int H,
                       int KVH, int window, bool causal, int prefix,
                       float scale) {
  constexpr int LD = D + 4;       // tile row stride in floats (16-byte rows,
                                  // conflict-free float4 reads)
  constexpr int CH = D / 16;      // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + FA_ROWS * LD;
  float* Vs = Ks + FA_KEYS * LD;
  float* Ps = Vs + FA_KEYS * LD;

  const int q0 = blockIdx.x * FA_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 2;         // q row in the tile
  const int j = tid & 3;          // keys 4*i + j, output chunks j + 4*i
  const int qp = q0 + r;
  const int q_seen = fa_last_key(qp, prefix);   // the row's last key

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KVH * D;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * kv_stride + (size_t)kvh * D;

  for (int e = tid; e < FA_ROWS * D; e += FA_THREADS) {
    const int rr = e / D, d = e % D, s = q0 + rr;
    Qs[rr * LD + d] = s < Sq ? to_f(qb[(size_t)s * q_stride + d]) * scale
                             : 0.0f;
  }

  // key tiles [t_begin, t_end]: from the first key that the window lets
  // the tile's first row see, to the last key its last row sees (causal:
  // the diagonal or the prefix's end) or the last key
  const int q_last = min(q0 + FA_ROWS, Sq) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / FA_KEYS;
  const int t_end = (causal ? fa_last_key(q_last, prefix) : Sk - 1) /
                    FA_KEYS;

  float m_run = NEG, l_run = 0.0f;
  float acc[4 * CH];
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) acc[i] = 0.0f;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * FA_KEYS;
    __syncthreads();  // the previous tile's K/V reads are done
    for (int e = tid; e < FA_KEYS * D; e += FA_THREADS) {
      const int kk = e / D, d = e % D, s = k0 + kk;
      const bool in = s < Sk;
      Ks[kk * LD + d] = in ? to_f(kb[(size_t)s * kv_stride + d]) : 0.0f;
      Vs[kk * LD + d] = in ? to_f(vb[(size_t)s * kv_stride + d]) : 0.0f;
    }
    __syncthreads();

    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * LD + 4 * d4]);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[(4 * i + j) * LD + 4 * d4]);
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }

    float tmax = NEG;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int kp = k0 + 4 * i + j;
      const bool ok = kp < Sk && (!causal || kp <= q_seen) &&
                      (window <= 0 || qp - kp < window);
      sc[i] = ok ? sc[i] : NEG;
      tmax = fmaxf(tmax, sc[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = expf(sc[i] - m_new);
      Ps[r * FA_LP + 4 * i + j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 4 * CH; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's four threads share their P entries

#pragma unroll 4
    for (int kk = 0; kk < FA_KEYS; ++kk) {
      const float p = Ps[r * FA_LP + kk];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[kk * LD + 4 * (j + 4 * c)]);
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
  }

  if (qp < Sq) {
    const float inv = 1.0f / fmaxf(l_run, 1e-30f);
    T* ob = o + ((size_t)b * Sq + qp) * q_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d = 4 * (j + 4 * c);
#pragma unroll
      for (int x = 0; x < 4; ++x) ob[d + x] = from_f<T>(acc[4 * c + x] * inv);
    }
    // the row's log-sum-exp of its scaled scores, for the backward pass
    if constexpr (LSE) {
      if (j == 0) lse[((size_t)b * H + h) * Sq + qp] = m_run + logf(l_run);
    }
  }
}

template <typename T, int D>
cudaError_t fa_launch(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Sk, int H, int KVH,
                      int window, bool causal, int prefix,
                      cudaStream_t stream) {
  const size_t smem = fa_smem_bytes<D>();
  auto kernel = lse != nullptr ? flash_attention_kernel<T, D, true>
                               : flash_attention_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FA_ROWS - 1) / FA_ROWS, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KVH,
      window, causal, prefix, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fa_dispatch(int D, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int Sq, int Sk, int H,
                        int KVH, int window, bool causal, int prefix,
                        cudaStream_t s) {
  switch (D) {
    case 32:
      return fa_launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, KVH, window,
                              causal, prefix, s);
    case 64:
      return fa_launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, KVH, window,
                              causal, prefix, s);
    case 96:
      return fa_launch<T, 96>(q, k, v, o, lse, B, Sq, Sk, H, KVH, window,
                              causal, prefix, s);
    case 128:
      return fa_launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, KVH, window,
                               causal, prefix, s);
    case 256:
      return fa_launch<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, KVH, window,
                               causal, prefix, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace idkd

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). q/o (B, Sq, H,
// D), k/v (B, Sk, KVH, D), contiguous; D in {32, 64, 96, 128, 256};
// H % KVH == 0; causal 1: Sk == Sq, window 0 = full causal, prefix
// 0 <= P <= Sk (0: none; P > 0 with window 0 only); causal 0: every key
// visible (window 0, prefix 0). lse: null, or (B, H, Sq) f32 that receives each row's
// log-sum-exp of its scaled scores (the training forward's; the label
// round passes null and writes nothing more). Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      void* lse, int B, int Sq, int Sk,
                                      int H, int KVH, int D, int window,
                                      int causal, int prefix, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0 ||
      !idkd::fa_mode_ok(Sq, Sk, window, causal, prefix))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)idkd::fa_dispatch<float>(D, q, k, v, o,
                                         static_cast<float*>(lse), B, Sq, Sk,
                                         H, KVH, window, causal != 0, prefix,
                                         s);
  if (dtype == 1)
    return (int)idkd::fa_dispatch<__nv_bfloat16>(
        D, q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H, KVH, window,
        causal != 0, prefix, s);
  return (int)cudaErrorInvalidValue;
}
