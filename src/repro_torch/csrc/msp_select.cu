// msp_select for Hopper (sm_90a): one pass over (N, C) logit rows giving
// the OoD detector confidence and the top-k sparse soft label.
//
// Replaces the Pallas TPU kernel msp_select_pallas / _msp_kernel in
// src/repro/kernels/msp_select/kernel.py. Per row of logits l:
//   conf = max softmax(l) = 1/z (MSP) or logsumexp(l) (energy), at T=1
//   top-k of softmax(l / T), renormalized over the top-k
// The TPU kernel keeps the whole row resident in VMEM. At an LM vocab
// (C = 151,936) a 4-byte row is 594 KB, more than a block's 227 KB of
// shared memory, so this kernel streams the row instead: each thread
// walks a strided share of the columns keeping an online (m, z) at T=1
// and a register top-k of the raw logits. softmax(l/T) is monotonic in
// l, so its top-k is the top-k of the logits, and the renormalized
// payload is exp((l_j - l_0)/T) / sum over the top-k: one pass, exact up
// to float error. Ties go to the lowest column, as lax.top_k does.
//
// Rows are reduced by a warp (C < 2048) or by eight warps (wider rows):
// (m, z) combine by shuffles, and the top-k by k rounds of a
// (value desc, index asc) argmax over the threads' list heads, the
// winner popping its head.
//
// Bound on the H100: every logit is read once and only O(k) per row is
// written, so the kernel is bound by bytes: at N=512, C=151,936 that is
// 311 MB in f32 (93 us at 3.35 TB/s). This first version reads with
// scalar loads; vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "select_common.cuh"

namespace idkd {

constexpr int MSP_THREADS = 256;

// (v, i) ranks ahead of (w, j): larger value, then lower index
__device__ __forceinline__ bool ahead(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <typename T, int WPR>
__global__ void __launch_bounds__(MSP_THREADS)
msp_kernel(const T* __restrict__ logits, int N, int C, int k,
           float temperature, int energy, float* __restrict__ conf,
           float* __restrict__ vals, int* __restrict__ idx) {
  constexpr int TPR = 32 * WPR;                  // threads per row
  constexpr int RPB = MSP_THREADS / TPR;         // rows per block
  const int tid = threadIdx.x;
  const int local_row = tid / TPR;
  const int t = tid % TPR;
  const int warp_in_row = t / 32;
  const int lane = tid % 32;
  const int row = blockIdx.x * RPB + local_row;
  const bool live = row < N;
  const T* x = logits + (size_t)(live ? row : 0) * C;

  float m = NEG, z = 0.0f, thr = NEG;
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = NEG;
    ti[j] = 0;
  }
  if (live) {
    for (int c = t; c < C; c += TPR) {
      const float v = to_f(x[c]);
      if (v > m) {
        z = z * expf(m - v) + 1.0f;
        m = v;
      } else {
        z += expf(v - m);
      }
      if (v > thr) thr = topk_insert(tv, ti, k, v, c);
    }
  }

  // ---- (m, z): warp shuffle, then across the row's warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float oz = __shfl_xor_sync(0xffffffffu, z, off);
    const float nm = fmaxf(m, om);
    z = z * expf(m - nm) + oz * expf(om - nm);
    m = nm;
  }
  __shared__ float sm[RPB][WPR], sz[RPB][WPR];
  __shared__ float sv[RPB][WPR];
  __shared__ int si[RPB][WPR];
  if (WPR > 1) {
    if (lane == 0) {
      sm[local_row][warp_in_row] = m;
      sz[local_row][warp_in_row] = z;
    }
    __syncthreads();
    float gm = NEG;
#pragma unroll
    for (int q = 0; q < WPR; ++q) gm = fmaxf(gm, sm[local_row][q]);
    float gz = 0.0f;
#pragma unroll
    for (int q = 0; q < WPR; ++q)
      gz += sz[local_row][q] * expf(sm[local_row][q] - gm);
    m = gm;
    z = gz;
  }

  // ---- top-k: k rounds of argmax over the threads' list heads
  float out_v[KMAX];
  int out_i[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      float bv = tv[0];
      int bi = ti[0];
      int bt = t;  // owner of the best head
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
        if (ahead(ov, oi, bv, bi) || (ov == bv && oi == bi && ot < bt)) {
          bv = ov;
          bi = oi;
          bt = ot;
        }
      }
      if (WPR > 1) {
        __syncthreads();  // previous round's reads of sv/si are done
        if (lane == 0) {
          sv[local_row][warp_in_row] = bv;
          si[local_row][warp_in_row] = bi;
          sm[local_row][warp_in_row] = __int_as_float(bt);
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < WPR; ++q) {
          const float qv = sv[local_row][q];
          const int qi = si[local_row][q];
          const int qt = __float_as_int(sm[local_row][q]);
          if (ahead(qv, qi, bv, bi) || (qv == bv && qi == bi && qt < bt)) {
            bv = qv;
            bi = qi;
            bt = qt;
          }
        }
      }
      out_v[r] = bv;
      out_i[r] = bi;
      if (t == bt) {  // pop the winning head
#pragma unroll
        for (int j = 0; j < KMAX - 1; ++j) {
          tv[j] = tv[j + 1];
          ti[j] = ti[j + 1];
        }
        tv[KMAX - 1] = NEG;
        ti[KMAX - 1] = 0;
      }
    }
  }

  if (live && t == 0) {
    finalize_row(m, z, out_v, out_i, k, temperature, energy, conf + row,
                 vals + (size_t)row * k, idx + (size_t)row * k);
  }
}

template <typename T, int WPR>
cudaError_t launch_msp(const void* logits, int N, int C, int k,
                       float temperature, int energy, void* conf, void* vals,
                       void* idx, cudaStream_t stream) {
  constexpr int RPB = MSP_THREADS / (32 * WPR);
  msp_kernel<T, WPR><<<(N + RPB - 1) / RPB, MSP_THREADS, 0, stream>>>(
      static_cast<const T*>(logits), N, C, k, temperature, energy,
      static_cast<float*>(conf), static_cast<float*>(vals),
      static_cast<int*>(idx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* logits, int N, int C, int k,
                     float temperature, int energy, void* conf, void* vals,
                     void* idx, cudaStream_t stream) {
  if (C >= 2048)
    return launch_msp<T, 8>(logits, N, C, k, temperature, energy, conf, vals,
                            idx, stream);
  return launch_msp<T, 1>(logits, N, C, k, temperature, energy, conf, vals,
                          idx, stream);
}

}  // namespace idkd

// dtype: 0 = float32, 1 = bfloat16 logits (N, C), row-major. Outputs
// conf (N) f32, vals (N, k) f32, idx (N, k) int32. Returns
// cudaGetLastError() after the launch.
extern "C" int msp_select_launch(int dtype, const void* logits, int N, int C,
                                 int k, float temperature, int energy,
                                 void* conf, void* vals, void* idx,
                                 void* stream) {
  if (k < 1 || k > idkd::KMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)idkd::dispatch<float>(logits, N, C, k, temperature, energy,
                                      conf, vals, idx, s);
  if (dtype == 1)
    return (int)idkd::dispatch<__nv_bfloat16>(logits, N, C, k, temperature,
                                              energy, conf, vals, idx, s);
  return (int)cudaErrorInvalidValue;
}
