// ssd_scan for Hopper (sm_90a): the Mamba-2 SSD chunked scan, y only.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas / _ssd_kernel in
// src/repro/kernels/ssd_scan/kernel.py, and computes the y of the model's
// ssd_chunked (src/repro/models/ssm.py) from its prologue's outputs:
// xdt (B, S, H, P) = x * dt, dta (B, S, H) = dt * -exp(a_log), and b, c
// (B, S, G, N) grouped, head h reading group h / (H / G) without a
// per-head copy. All f32. Per chunk of `chunk` positions, with cum the
// within-chunk cumulative sum of dta:
//   y[t]   = sum_{u<=t} (c_t . b_u) exp(cum_t - cum_u) xdt_u    (intra)
//          + exp(cum_t) c_t . state                           (inter)
//   state <- exp(cum_end) state + sum_u exp(cum_end - cum_u) xdt_u (x) b_u
// The ragged tail of the last chunk reads as zeros, as the reference's
// padding does. No initial state in, no final state out.
//
// Design. The TPU kernel walks chunks as a sequential grid axis with the
// (P x N) state in VMEM scratch. Here one block owns one (b, h) and walks
// the chunks in order with the state in shared memory. One thread per
// chunk position t (chunk <= 256): a block scan gives cum; the thread
// keeps y[t, :] (P floats) in registers, adds the inter term from the
// state, then walks u <= t over 64-row shared-memory tiles of b and xdt
// for the intra term (only t >= u is ever exponentiated). The same tiles
// feed the state update: each thread owns P*N/256 state entries. c rows
// of the whole chunk stay in shared memory (row stride N + 4, so the
// threads' float4 reads of their own rows do not collide); at N = 128
// that is 132 KB, which is why the kernel takes dynamic shared memory.
//
// Bound on the H100. At Hymba's shape (P = 64, N = 16, chunk = 256) each
// (b, h) chunk does about chunk^2 (N + P) / 2 FMAs against chunk (P + 2N)
// floats read: bound by operations. This kernel runs on the f32 FMA units
// (the TPU kernel's MXU products become SIMT loops); the tensor-core form
// is later work.

#include <cuda_runtime.h>

namespace idkd {

constexpr int SSD_THREADS = 256;  // one per chunk position; chunk <= 256
constexpr int SSD_TU = 64;        // u rows per shared-memory tile
constexpr int SSD_SD = 32;        // state entries per thread: P*N <= 8192

inline size_t ssd_smem_bytes(int P, int N) {
  return sizeof(float) * (2 * SSD_THREADS + SSD_THREADS * (N + 4) +
                          SSD_TU * N + SSD_TU * P + P * N);
}

template <int P>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ dta,
                const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ y, int S, int H, int G, int N,
                int chunk) {
  extern __shared__ float4 smem4[];
  const int NS = N + 4;
  float* cum = reinterpret_cast<float*>(smem4);  // [256]
  float* wend = cum + SSD_THREADS;               // [256] exp(cum_end - cum)
  float* Cs = wend + SSD_THREADS;                // [256][NS]
  float* Bs = Cs + SSD_THREADS * NS;             // [TU][N]
  float* Xs = Bs + SSD_TU * N;                   // [TU][P]
  float* St = Xs + SSD_TU * P;                   // [P][N]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int t = threadIdx.x;
  const int PN = P * N;

  const size_t x_stride = (size_t)H * P;
  const size_t bc_stride = (size_t)G * N;
  const float* xb = xdt + (size_t)b * S * x_stride + (size_t)h * P;
  const float* db = dta + (size_t)b * S * H + h;
  const float* bb = bm + (size_t)b * S * bc_stride + (size_t)g * N;
  const float* cb = cm + (size_t)b * S * bc_stride + (size_t)g * N;
  float* yb = y + (size_t)b * S * x_stride + (size_t)h * P;

  for (int e = t; e < PN; e += SSD_THREADS) St[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int len = min(chunk, S - c0);
    __syncthreads();  // the previous chunk is done with cum, Cs and St
    cum[t] = (t < len) ? db[(size_t)(c0 + t) * H] : 0.0f;
    for (int e = t; e < chunk * N; e += SSD_THREADS) {
      const int tt = e / N, n = e % N;
      Cs[tt * NS + n] = tt < len ? cb[(size_t)(c0 + tt) * bc_stride + n]
                                 : 0.0f;
    }
    __syncthreads();
    for (int off = 1; off < chunk; off <<= 1) {  // inclusive block scan
      const float add = (t >= off && t < chunk) ? cum[t - off] : 0.0f;
      __syncthreads();
      cum[t] += add;
      __syncthreads();
    }
    const float cum_end = cum[chunk - 1];
    const float cum_t = cum[t];
    wend[t] = expf(cum_end - cum_t);

    // inter term from the state carried in
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.0f;
    if (t < len) {
      for (int n = 0; n < N; ++n) {
        const float cn = Cs[t * NS + n];
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = fmaf(cn, St[p * N + n], acc[p]);
      }
      const float e = expf(cum_t);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] *= e;
    }

    float sd[SSD_SD];
#pragma unroll
    for (int i = 0; i < SSD_SD; ++i) sd[i] = 0.0f;

    for (int u0 = 0; u0 < len; u0 += SSD_TU) {
      const int tu = min(SSD_TU, len - u0);
      __syncthreads();  // the previous tile's Bs/Xs reads are done
      for (int e = t; e < SSD_TU * N; e += SSD_THREADS) {
        const int uu = e / N, n = e % N;
        Bs[e] = uu < tu ? bb[(size_t)(c0 + u0 + uu) * bc_stride + n] : 0.0f;
      }
      for (int e = t; e < SSD_TU * P; e += SSD_THREADS) {
        const int uu = e / P, p = e % P;
        Xs[e] = uu < tu ? xb[(size_t)(c0 + u0 + uu) * x_stride + p] : 0.0f;
      }
      __syncthreads();

      // intra term: u in [u0, min(u0 + tu, t + 1))
      if (t < len) {
        const int u_hi = min(u0 + tu, t + 1);
        for (int u = u0; u < u_hi; ++u) {
          const float* brow = Bs + (u - u0) * N;
          float dot = 0.0f;
          for (int n = 0; n < N; n += 4) {
            const float4 cv = *reinterpret_cast<const float4*>(&Cs[t * NS + n]);
            const float4 bv = *reinterpret_cast<const float4*>(&brow[n]);
            dot = fmaf(cv.x, bv.x, dot);
            dot = fmaf(cv.y, bv.y, dot);
            dot = fmaf(cv.z, bv.z, dot);
            dot = fmaf(cv.w, bv.w, dot);
          }
          const float gw = dot * expf(cum_t - cum[u]);
          const float* xrow = Xs + (u - u0) * P;
#pragma unroll
          for (int p = 0; p < P; p += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(&xrow[p]);
            acc[p + 0] = fmaf(gw, xv.x, acc[p + 0]);
            acc[p + 1] = fmaf(gw, xv.y, acc[p + 1]);
            acc[p + 2] = fmaf(gw, xv.z, acc[p + 2]);
            acc[p + 3] = fmaf(gw, xv.w, acc[p + 3]);
          }
        }
      }

      // this tile's part of the state update
#pragma unroll
      for (int i = 0; i < SSD_SD; ++i) {
        const int e = t + SSD_THREADS * i;
        if (e < PN) {
          const int p = e / N, n = e % N;
          float s = 0.0f;
          for (int uu = 0; uu < tu; ++uu)
            s = fmaf(wend[u0 + uu] * Xs[uu * P + p], Bs[uu * N + n], s);
          sd[i] += s;
        }
      }
    }

    if (t < len) {
      float* yrow = yb + (size_t)(c0 + t) * x_stride;
#pragma unroll
      for (int p = 0; p < P; p += 4)
        *reinterpret_cast<float4*>(&yrow[p]) =
            make_float4(acc[p], acc[p + 1], acc[p + 2], acc[p + 3]);
    }
    __syncthreads();  // every thread has read St for its inter term
    const float dec = expf(cum_end);
#pragma unroll
    for (int i = 0; i < SSD_SD; ++i) {
      const int e = t + SSD_THREADS * i;
      if (e < PN) St[e] = St[e] * dec + sd[i];
    }
  }
}

template <int P>
cudaError_t ssd_launch(const float* xdt, const float* dta, const float* b,
                       const float* c, float* y, int B, int S, int H, int G,
                       int N, int chunk, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<P><<<grid, SSD_THREADS, smem, stream>>>(
      xdt, dta, b, c, y, S, H, G, N, chunk);
  return cudaGetLastError();
}

}  // namespace idkd

// xdt/y (B, S, H, P), dta (B, S, H), b/c (B, S, G, N): float32,
// contiguous. P in {16, 32, 64}; N a multiple of 4 with P*N <= 8192;
// 1 <= chunk <= 256; H % G == 0. xdt, b, c and y 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(const void* xdt, const void* dta,
                               const void* b, const void* c, void* y, int B,
                               int S, int H, int P, int G, int N, int chunk,
                               void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 || N < 4 || N % 4 != 0 ||
      chunk < 1 || chunk > idkd::SSD_THREADS ||
      P * N > idkd::SSD_THREADS * idkd::SSD_SD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* d = static_cast<const float*>(dta);
  const float* bp = static_cast<const float*>(b);
  const float* cp = static_cast<const float*>(c);
  float* yp = static_cast<float*>(y);
  switch (P) {
    case 16: return (int)idkd::ssd_launch<16>(x, d, bp, cp, yp, B, S, H, G, N, chunk, s);
    case 32: return (int)idkd::ssd_launch<32>(x, d, bp, cp, yp, B, S, H, G, N, chunk, s);
    case 64: return (int)idkd::ssd_launch<64>(x, d, bp, cp, yp, B, S, H, G, N, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
