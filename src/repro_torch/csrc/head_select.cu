// head_select for Hopper (sm_90a): fused classifier head + OoD detector +
// top-k sparse soft label, for L nodes in one launch.
//
// Replaces the Pallas TPU kernel head_select_pallas / _head_kernel in
// src/repro/kernels/head_select/kernel.py. What it computes, per node l
// and row r of hidden[l] (N, D) against the head w[l] (D, C) + bias[l]:
//   s = hidden @ w + bias                 (f32, never written to memory)
//   (m, z) online softmax stats at T=1 -> conf = 1/z (MSP) or m + log z
//   running top-k of the raw logits s with their class indices
//   vals = softmax(top-k logits / T)      (the renormalized payload)
// Ties in the top-k go to the lowest class index, as lax.top_k does.
//
// Design. The TPU kernel walks the vocabulary as a sequential grid axis
// and carries (m, z, top-k) in VMEM scratch between grid steps. Hopper
// blocks run in no order, so the walk over C becomes a loop inside the
// block: a block owns ROWS rows of one node and streams all C columns
// through shared memory in TC-wide tiles, each a ROWS x TC tile of scores
// built by a D-tiled SIMT f32 product (each thread holds a 4x4 sub-tile).
// After each tile one thread per row folds the tile into its (m, z) and
// its register top-k, and finalizes the row after the last tile.
//
// Variants. This SIMT kernel serves float32 (and bf16 only when called
// as the "simt" variant, to time it); bf16 runs head_select_tc.cu on the
// tensor cores, with the column split this kernel lacks. f32 stays here
// on purpose: the ResNet main path (L=16, N=256, D=64, C=10: 64 blocks,
// a few microseconds of launch) and the f32 card-vs-CPU checks (1e-6)
// run it, and TF32 tiles would not hold those tolerances.
//
// Bound on the H100. At an LM head the product is bound by operations:
// 2*N*D*C (Qwen3-1.7B's head, N=512, D=2048, C=151936: 319 GFLOP, 4.8 ms
// at the f32 FMA rate). This kernel reaches ~12.5 TFLOP/s where it has
// blocks enough (Hymba's head, 65,536 rows: 538 ms in bf16), a fifth of
// the FMA rate; at 512 rows it runs 8 blocks on 132 SMs (525 ms, PERF.md).
// head_select_tc.cu is the design for those shapes. At the main-path
// shape it is launch-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "select_common.cuh"

namespace idkd {

constexpr int ROWS = 64;     // rows per block
constexpr int TC = 64;       // columns per tile
constexpr int TD = 32;       // depth per shared-memory stage
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_select_kernel(const T* __restrict__ hidden, const T* __restrict__ w,
                   const float* __restrict__ bias, int N, int D, int C, int k,
                   float temperature, int energy, float* __restrict__ conf,
                   float* __restrict__ vals, int* __restrict__ idx) {
  const int l = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const T* H = hidden + (size_t)l * N * D;
  const T* W = w + (size_t)l * D * C;
  const float* B = bias ? bias + (size_t)l * C : nullptr;

  __shared__ float Hs[ROWS][TD + 1];
  __shared__ float Ws[TD][TC];
  __shared__ float S[ROWS][TC + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16*j, j < 4
  const int ty = tid / 16;  // rows 4*ty + i, i < 4

  // per-row running state, owned by thread tid < ROWS for row row0 + tid
  float m_run = NEG, z_run = 0.0f, thr = NEG;
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = NEG;
    ti[j] = 0;
  }

  for (int c0 = 0; c0 < C; c0 += TC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += TD) {
      for (int e = tid; e < ROWS * TD; e += THREADS) {
        const int r = e / TD, d = e % TD;
        const int gr = row0 + r, gd = d0 + d;
        Hs[r][d] = (gr < N && gd < D) ? to_f(H[(size_t)gr * D + gd]) : 0.0f;
      }
      for (int e = tid; e < TD * TC; e += THREADS) {
        const int d = e / TC, c = e % TC;
        const int gd = d0 + d, gc = c0 + c;
        Ws[d][c] = (gd < D && gc < C) ? to_f(W[(size_t)gd * C + gc]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < TD; ++d) {
        float hv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = Hs[4 * ty + i][d];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Ws[d][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, gc = c0 + c;
        S[4 * ty + i][c] = gc < C ? acc[i][j] + (B ? B[gc] : 0.0f) : NEG;
      }
    __syncthreads();

    if (tid < ROWS) {
      const int ncols = min(TC, C - c0);
      float tmax = NEG;
      for (int c = 0; c < ncols; ++c) tmax = fmaxf(tmax, S[tid][c]);
      const float m_new = fmaxf(m_run, tmax);
      float zs = 0.0f;
      for (int c = 0; c < ncols; ++c) zs += expf(S[tid][c] - m_new);
      z_run = z_run * expf(m_run - m_new) + zs;
      m_run = m_new;
      for (int c = 0; c < ncols; ++c) {
        const float v = S[tid][c];
        if (v > thr) thr = topk_insert(tv, ti, k, v, c0 + c);
      }
    }
    __syncthreads();
  }

  if (tid < ROWS && row0 + tid < N) {
    const size_t row = (size_t)l * N + row0 + tid;
    finalize_row(m_run, z_run, tv, ti, k, temperature, energy, conf + row,
                 vals + row * k, idx + row * k);
  }
}

template <typename T>
cudaError_t launch(const void* hidden, const void* w, const void* bias,
                   int L, int N, int D, int C, int k, float temperature,
                   int energy, void* conf, void* vals, void* idx,
                   cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, L);
  head_select_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(w),
      static_cast<const float*>(bias), N, D, C, k, temperature, energy,
      static_cast<float*>(conf), static_cast<float*>(vals),
      static_cast<int*>(idx));
  return cudaGetLastError();
}

}  // namespace idkd

// dtype: 0 = float32, 1 = bfloat16 (hidden and w); bias is float32 or
// null. Outputs conf (L*N), vals/idx (L*N*k). Returns cudaGetLastError()
// after the launch.
extern "C" int head_select_launch(int dtype, const void* hidden,
                                  const void* w, const void* bias, int L,
                                  int N, int D, int C, int k,
                                  float temperature, int energy, void* conf,
                                  void* vals, void* idx, void* stream) {
  if (k < 1 || k > idkd::KMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)idkd::launch<float>(hidden, w, bias, L, N, D, C, k,
                                    temperature, energy, conf, vals, idx, s);
  if (dtype == 1)
    return (int)idkd::launch<__nv_bfloat16>(hidden, w, bias, L, N, D, C, k,
                                            temperature, energy, conf, vals,
                                            idx, s);
  return (int)cudaErrorInvalidValue;
}
