// Shared device helpers of the head_select and msp_select kernels:
// input conversion, the running top-k inserts, and the per-row finalizer.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace idkd {

// Masked / empty slots. Finite, like the Pallas kernels' NEG_INF, so that
// exp(NEG - m) is 0 and NEG - NEG never makes a NaN.
constexpr float NEG = -1e30f;
constexpr int KMAX = 16;  // largest top-k the kernels take

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Insert (v, c) into the descending list tv/ti of length k (unrolled, so
// the list stays in registers). Strict '>': a candidate equal to a kept
// value goes behind it. Callers offer candidates in increasing index
// order, so ties keep the lowest index first, as lax.top_k does. Once
// placed, the rest of the list shifts down one slot. Returns the new
// k-th value (the admission threshold).
__device__ __forceinline__ float topk_insert(float (&tv)[KMAX],
                                             int (&ti)[KMAX], int k,
                                             float v, int c) {
  bool shifting = false;
  float thr = NEG;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      if (shifting || v > tv[j]) {
        const float ov = tv[j];
        const int oc = ti[j];
        tv[j] = v;
        ti[j] = c;
        v = ov;
        c = oc;
        shifting = true;
      }
      if (j == k - 1) thr = tv[j];
    }
  }
  return thr;
}

// Insert (v, c) into the list tv/ti of length k ordered by (value desc,
// index asc), whatever order the candidates come in: the merge of top-k
// lists built over interleaved or separate column sets. (v, c) enters
// iff it precedes the k-th entry (thr_v, thr_i), which the call updates.
__device__ __forceinline__ void topk_insert_ordered(float (&tv)[KMAX],
                                                    int (&ti)[KMAX], int k,
                                                    float v, int c,
                                                    float& thr_v,
                                                    int& thr_i) {
  if (!(v > thr_v || (v == thr_v && c < thr_i))) return;
  bool shifting = false;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      if (shifting || v > tv[j] || (v == tv[j] && c < ti[j])) {
        const float ov = tv[j];
        const int oc = ti[j];
        tv[j] = v;
        ti[j] = c;
        v = ov;
        c = oc;
        shifting = true;
      }
      if (j == k - 1) {
        thr_v = tv[j];
        thr_i = ti[j];
      }
    }
  }
}

// Detector confidence at T=1 from the online-softmax stats (MSP 1/z or
// energy m + log z), and the top-k renormalized at temperature T:
// vals_j = exp((l_j - l_0)/T) / sum_j' exp((l_j' - l_0)/T), which equals
// the top-k of softmax(l/T) renormalized over the top-k.
__device__ __forceinline__ void finalize_row(float m, float z,
                                             const float (&tv)[KMAX],
                                             const int (&ti)[KMAX], int k,
                                             float temperature, int energy,
                                             float* conf, float* vals,
                                             int* idx) {
  const float zc = fmaxf(z, 1e-30f);
  *conf = energy ? m + logf(zc) : 1.0f / zc;
  float e[KMAX];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      e[j] = expf((tv[j] - tv[0]) / temperature);
      s += e[j];
    }
  }
  s = fmaxf(s, 1e-30f);
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      vals[j] = e[j] / s;
      idx[j] = ti[j];
    }
  }
}

}  // namespace idkd
