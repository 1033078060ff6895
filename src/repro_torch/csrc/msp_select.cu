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
// Bound on the H100: every logit is read once and only O(k) per row is
// written, so the kernel is bound by bytes: LM-3's 65,536 x 32,001 bf16
// logits are 4.19 GB, 1.25 ms at 3.35 TB/s. The design streams them:
//  - 16-byte loads (8 bf16 or 4 f32), four in flight per thread, marked
//    evict-first; a row of odd bf16 width starts off a 16-byte boundary,
//    so each row has a scalar head up to the boundary and a scalar tail;
//  - one online (m, z) rescale per vector, not per element, with the
//    exponentials on the SFU (__expf);
//  - the top-k is what costs (python -m repro_torch.kernels.ablate times
//    the pass without it, and with a per-thread threshold alone; PERF.md
//    has the numbers): with a per-thread threshold some lane of the warp
//    still inserts at nearly every step, and the warp runs the insert for
//    it. So a logit enters only if it also beats the warp's bar: the k-th
//    largest of the lanes' list heads, refreshed by a bitonic sort over
//    the lanes after iterations 0, 1, 3, 7, 15 and every 16th; one copy
//    of the insert code then takes the vector element by element in
//    index order;
//  - one warp per row and eight rows per block, so that (m, z) and the
//    top-k (k rounds of a (value desc, index asc) argmax over the lanes'
//    list heads) merge by shuffles alone. With too few rows to fill the
//    card (fewer than MSP_WARP_ROWS) a wide row takes a whole block of
//    eight warps instead; one thread merges their lists.
// Ties go to the lowest column, as lax.top_k does: a thread offers its
// columns in increasing order with a strict '>', and the merges rank by
// (value desc, index asc).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_common.cuh"

namespace idkd {

constexpr int MSP_THREADS = 256;
constexpr int MSP_WARP_ROWS = 4096;  // fewer rows than this (and C >= 2048):
                                     // eight warps per row

// (v, i) ranks ahead of (w, j): larger value, then lower index
__device__ __forceinline__ bool ahead(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// 16 bytes of logits as floats
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Fold V consecutive logits, columns c0.., into the thread's (m, z) and
// its top-k list (thr = the list's k-th value). A logit enters the list
// only if it beats both thr and the warp's bar thr_w; the inserts of a
// vector go through one copy of the insert code (the vector rotates).
template <int V>
__device__ __forceinline__ void absorb(const float (&v)[V], int c0, int k,
                                       float& m, float& z, float (&tv)[KMAX],
                                       int (&ti)[KMAX], float& thr,
                                       float thr_w) {
  float vm = v[0];
#pragma unroll
  for (int i = 1; i < V; ++i) vm = fmaxf(vm, v[i]);
  if (vm > m) {
    z *= __expf(m - vm);
    m = vm;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) z += __expf(v[i] - m);
  if (vm > thr && vm > thr_w) {
    float w[V];
#pragma unroll
    for (int i = 0; i < V; ++i) w[i] = v[i];
#pragma unroll 1
    for (int i = 0; i < V; ++i) {
      if (w[0] > thr && w[0] > thr_w)
        thr = topk_insert(tv, ti, k, w[0], c0 + i);
#pragma unroll
      for (int j = 0; j < V - 1; ++j) w[j] = w[j + 1];
    }
  }
}

// The warp's bar: the k-th largest of the lanes' list heads (a bitonic
// sort over the lanes, descending). k lanes hold a logit at least this
// large, all at lower columns than any logit still to come, so a later
// logit that does not beat it is not in the row's top-k, ties included.
__device__ __forceinline__ float warp_bar(float head, int k) {
  const int lane = threadIdx.x % 32;
  float x = head;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, stride);
      const bool desc = (lane & size) == 0, lower = (lane & stride) == 0;
      x = (desc == lower) ? fmaxf(x, y) : fminf(x, y);
    }
  }
  return __shfl_sync(0xffffffffu, x, k - 1);
}

// k rounds of a warp argmax over the lanes' sorted lists (the winner pops
// its head): every lane ends with the warp's top-k in out_v / out_i.
__device__ __forceinline__ void warp_topk(float (&tv)[KMAX], int (&ti)[KMAX],
                                          int k, float (&out_v)[KMAX],
                                          int (&out_i)[KMAX]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      float bv = tv[0];
      int bi = ti[0];
      int bt = lane;  // owner of the best head
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
      out_v[r] = bv;
      out_i[r] = bi;
      if (lane == bt) {  // pop the winning head
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
}

__device__ __forceinline__ void warp_mz(float& m, float& z) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float oz = __shfl_xor_sync(0xffffffffu, z, off);
    const float nm = fmaxf(m, om);
    z = z * __expf(m - nm) + oz * __expf(om - nm);
    m = nm;
  }
}

template <typename T, int WPR>
__global__ void __launch_bounds__(MSP_THREADS)
msp_kernel(const T* __restrict__ logits, int N, int C, int k,
           float temperature, int energy, float* __restrict__ conf,
           float* __restrict__ vals, int* __restrict__ idx) {
  constexpr int V = 16 / sizeof(T);              // logits per 16 bytes
  constexpr int TPR = 32 * WPR;                  // threads per row
  constexpr int RPB = MSP_THREADS / TPR;         // rows per block
  static_assert(WPR == 1 || RPB == 1, "a multi-warp row owns its block");
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  if (row >= N) return;  // whole warps (WPR 1) or the whole block
  const T* x = logits + (size_t)row * C;
  const int mis = (int)((reinterpret_cast<uintptr_t>(x) & 15) / sizeof(T));
  const int head = min(C, mis ? V - mis : 0);
  const int nvec = (C - head) / V;
  const int tail0 = head + nvec * V;

  float m = NEG, z = 0.0f, thr = NEG;
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = NEG;
    ti[j] = 0;
  }
  float thr_w = NEG;  // the warp's bar, raised as the row streams by
  if (t < head) {
    const float v[1] = {to_f(x[t])};
    absorb(v, t, k, m, z, tv, ti, thr, thr_w);
  }
  const T* body = x + head;
  int base = 0;
  for (int it = 0; base + 4 * TPR <= nvec; base += 4 * TPR, ++it) {
    const int vi = base + t;  // four loads in flight
    float a[V], b[V], c[V], d[V];
    load16(body + (size_t)vi * V, a);
    load16(body + (size_t)(vi + TPR) * V, b);
    load16(body + (size_t)(vi + 2 * TPR) * V, c);
    load16(body + (size_t)(vi + 3 * TPR) * V, d);
    absorb(a, head + vi * V, k, m, z, tv, ti, thr, thr_w);
    absorb(b, head + (vi + TPR) * V, k, m, z, tv, ti, thr, thr_w);
    absorb(c, head + (vi + 2 * TPR) * V, k, m, z, tv, ti, thr, thr_w);
    absorb(d, head + (vi + 3 * TPR) * V, k, m, z, tv, ti, thr, thr_w);
    if ((it & (it + 1)) == 0 || (it & 15) == 15)  // 0, 1, 3, 7, 15, 31, ..
      thr_w = fmaxf(thr_w, warp_bar(tv[0], k));
  }
  for (int vi = base + t; vi < nvec; vi += TPR) {
    float a[V];
    load16(body + (size_t)vi * V, a);
    absorb(a, head + vi * V, k, m, z, tv, ti, thr, thr_w);
  }
  if (t < C - tail0) {
    const float v[1] = {to_f(x[tail0 + t])};
    absorb(v, tail0 + t, k, m, z, tv, ti, thr, thr_w);
  }

  warp_mz(m, z);
  float out_v[KMAX];
  int out_i[KMAX];
  warp_topk(tv, ti, k, out_v, out_i);

  if (WPR > 1) {  // merge the row's warps: one shared-memory step
    __shared__ float sv[WPR][KMAX], smz[WPR][2];
    __shared__ int si[WPR][KMAX];
    const int warp = t / 32, lane = t % 32;
    if (lane == 0) {
      smz[warp][0] = m;
      smz[warp][1] = z;
    }
    if (lane < k) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j == lane) {
          sv[warp][j] = out_v[j];
          si[warp][j] = out_i[j];
        }
    }
    __syncthreads();
    if (t != 0) return;
    m = NEG;
#pragma unroll
    for (int q = 0; q < WPR; ++q) m = fmaxf(m, smz[q][0]);
    z = 0.0f;
#pragma unroll
    for (int q = 0; q < WPR; ++q) z += smz[q][1] * __expf(smz[q][0] - m);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      out_v[j] = NEG;
      out_i[j] = 0;
    }
    float thr_v = NEG;
    int thr_i = 0x7fffffff;
    for (int q = 0; q < WPR; ++q)
      for (int j = 0; j < k; ++j)
        topk_insert_ordered(out_v, out_i, k, sv[q][j], si[q][j], thr_v,
                            thr_i);
  }

  if (t == 0) {
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
  if (C >= 2048 && N < MSP_WARP_ROWS)
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
