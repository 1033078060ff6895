// ssd_scan's backward pass for Hopper (sm_90a): the gradients of the
// Mamba-2 SSD scan's y with respect to xdt, dta, b and c.
//
// The JAX package has no backward Pallas kernel: its training
// differentiates ssd_chunked (src/repro/models/ssm.py) with XLA. The
// port runs ssd_scan.cu in the forward pass (the replacement of
// ssd_scan_pallas in src/repro/kernels/ssd_scan/kernel.py), so its
// backward is a kernel too, the same function as ssd_scan_bwd_plain in
// kernels/ssd_scan/ops.py. Per (b, h), with a_t = exp(dta_t), the forward
// state h_t = a_t h_{t-1} + xdt_t (x) b_t (P x N) and
// y_t = h_t c_t; given dy, the reverse state is
// g_s = a_{s+1} g_{s+1} + dy_s (x) c_s, and
//   dxdt_s = g_s b_s,          db_s = sum_h g_s^T xdt_s,
//   dc_t   = sum_h h_t^T dy_t, ddta_u = sum_{t >= u} dcum_t,
//   dcum_t = dy_t . (a_t h_{t-1} c_t) - xdt_t . (a_{t+1} g_{t+1} b_t).
// dcum_t is dy_t . y_t - xdt_t . dxdt_t with the diagonal term
// (c_t . b_t)(xdt_t . dy_t), which the two products share, taken out
// before the subtraction: it is the largest part of each product where
// the decays are steep, and would otherwise cancel in f32. The reverse
// cumulative sum runs in double.
//
// Design (a first, simple kernel). One block per (b, h), 4 P threads:
// thread (p, q) keeps state entries (p, q*N/4 .. q*N/4 + N/4) in
// registers and walks the sequence forward (h, dc and the first half of
// dcum), then backward (g, dxdt, db, the second half and the cumulative
// sum), 32 positions of xdt, dy, dta, b and c staged in shared memory at
// a time. Sums over n use the four threads of a p row (two shuffles);
// sums over p use three shuffles within a warp, then one pass over the
// warps' partials per tile. dc and db are written per head; a second
// kernel sums them over each group's heads.
//
// Bound on the H100. The function reads xdt, dy, dta, b, c and writes
// dxdt, ddta, db, dc once (B S (3 H P + 2 H + 4 G N) floats: 0.051 ms at
// Hymba's training shape, B 2, S 2176, H 50, P 64, N 16); its least
// work is two rank-1 updates and three readouts of the (P x N) state per
// position and head, 10 N P flops. Each block here is sequential over S,
// and the grid (B H blocks) is smaller than the card at B 2; PERF.md has
// the times.

#include <cuda_runtime.h>

namespace idkd {

constexpr int SB_Q = 32;       // positions staged per tile

__device__ __forceinline__ float sb_sum_over_p(float v) {
  // lanes 4i + q of a warp hold rows p = 8 * warp + i: sum the 8 rows
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float sb_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct SbSmem {
  float *x, *dy, *b, *c, *da, *part, *tpart;
};

__device__ __forceinline__ SbSmem sb_carve(float* smem, int P, int N,
                                           int nw) {
  SbSmem s;
  s.x = smem;
  s.dy = s.x + SB_Q * P;
  s.b = s.dy + SB_Q * P;
  s.c = s.b + SB_Q * N;
  s.da = s.c + SB_Q * N;
  s.part = s.da + SB_Q;           // (SB_Q, nw, N) sums over a warp's p
  s.tpart = s.part + SB_Q * nw * N;   // (SB_Q, nw) dcum halves
  return s;
}

// Stage positions [t0, t0 + SB_Q) of head h (and its group g); zeros
// past S.
__device__ __forceinline__ void sb_stage(const SbSmem& sm, const float* xdt,
                                         const float* dy, const float* dta,
                                         const float* bm, const float* cm,
                                         int b, int h, int g, int t0, int S,
                                         int H, int G, int P, int N) {
  const int nt = blockDim.x;
  for (int e = threadIdx.x; e < SB_Q * P; e += nt) {
    const int tt = e / P, p = e % P, t = t0 + tt;
    const size_t off = (((size_t)b * S + t) * H + h) * P + p;
    sm.x[e] = t < S ? xdt[off] : 0.0f;
    sm.dy[e] = t < S ? dy[off] : 0.0f;
  }
  for (int e = threadIdx.x; e < SB_Q * N; e += nt) {
    const int tt = e / N, n = e % N, t = t0 + tt;
    const size_t off = (((size_t)b * S + t) * G + g) * N + n;
    sm.b[e] = t < S ? bm[off] : 0.0f;
    sm.c[e] = t < S ? cm[off] : 0.0f;
  }
  for (int tt = threadIdx.x; tt < SB_Q; tt += nt) {
    const int t = t0 + tt;
    sm.da[tt] = t < S ? dta[((size_t)b * S + t) * H + h] : 0.0f;
  }
}

// NT = N / 4 state entries per thread.
template <int NT>
__global__ void ssd_bwd_scan(const float* __restrict__ xdt,
                             const float* __restrict__ dta,
                             const float* __restrict__ bm,
                             const float* __restrict__ cm,
                             const float* __restrict__ dy,
                             float* __restrict__ dxdt,
                             float* __restrict__ ddta,
                             float* __restrict__ dbh,
                             float* __restrict__ dch, int S, int H, int G,
                             int P) {
  constexpr int N = 4 * NT;
  extern __shared__ float4 smem4[];
  const int nw = blockDim.x / 32;
  const SbSmem sm = sb_carve(reinterpret_cast<float*>(smem4), P, N, nw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p = tid >> 2, q = tid & 3;
  const int n0 = q * NT;
  const int tiles = (S + SB_Q - 1) / SB_Q;

  float st[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) st[i] = 0.0f;

  // ---- forward in time: h_t, dc_t per head, dcum's first half
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * SB_Q;
    __syncthreads();
    sb_stage(sm, xdt, dy, dta, bm, cm, b, h, g, t0, S, H, G, P, N);
    __syncthreads();
    for (int tt = 0; tt < SB_Q; ++tt) {
      if (t0 + tt >= S) break;                 // uniform over the block
      const float a = expf(sm.da[tt]);
      const float xp = sm.x[tt * P + p], dyp = sm.dy[tt * P + p];
      const float* bt = sm.b + tt * N + n0;
      const float* ct = sm.c + tt * N + n0;
      float s1 = 0.0f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float hd = a * st[i];
        s1 = fmaf(ct[i], hd, s1);
        st[i] = fmaf(xp, bt[i], hd);
      }
      const float t1 = sb_warp_sum(dyp * s1);
      if (lane == 0) sm.tpart[tt * nw + warp] = t1;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float v = sb_sum_over_p(st[i] * dyp);
        if (lane < 4) sm.part[(tt * nw + warp) * N + n0 + i] = v;
      }
    }
    __syncthreads();
    for (int e = tid; e < SB_Q * N; e += blockDim.x) {
      const int tt = e / N, n = e % N, t = t0 + tt;
      if (t >= S) continue;
      float acc = 0.0f;
      for (int w = 0; w < nw; ++w) acc += sm.part[(tt * nw + w) * N + n];
      dch[(((size_t)b * S + t) * H + h) * N + n] = acc;
    }
    for (int tt = tid; tt < SB_Q; tt += blockDim.x) {
      const int t = t0 + tt;
      if (t >= S) continue;
      float acc = 0.0f;
      for (int w = 0; w < nw; ++w) acc += sm.tpart[tt * nw + w];
      ddta[((size_t)b * S + t) * H + h] = acc;   // dcum's first half
    }
  }

  // ---- backward in time: g_s, dxdt_s, db_s per head, the second half,
  // and ddta as the reverse cumulative sum of dcum
#pragma unroll
  for (int i = 0; i < NT; ++i) st[i] = 0.0f;
  float a_next = 0.0f;                          // exp(dta_{s+1})
  double run = 0.0;                             // thread 0's running sum
  for (int tile = tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * SB_Q;
    __syncthreads();
    sb_stage(sm, xdt, dy, dta, bm, cm, b, h, g, t0, S, H, G, P, N);
    __syncthreads();
    for (int tt = SB_Q - 1; tt >= 0; --tt) {
      if (t0 + tt >= S) continue;              // uniform over the block
      const float xp = sm.x[tt * P + p], dyp = sm.dy[tt * P + p];
      const float* bt = sm.b + tt * N + n0;
      const float* ct = sm.c + tt * N + n0;
      float s2 = 0.0f, dx = 0.0f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float gd = a_next * st[i];
        s2 = fmaf(bt[i], gd, s2);
        st[i] = fmaf(dyp, ct[i], gd);
        dx = fmaf(bt[i], st[i], dx);
      }
      dx += __shfl_xor_sync(0xffffffffu, dx, 1);
      dx += __shfl_xor_sync(0xffffffffu, dx, 2);
      if (q == 0) dxdt[(((size_t)b * S + t0 + tt) * H + h) * P + p] = dx;
      const float t2 = sb_warp_sum(xp * s2);
      if (lane == 0) sm.tpart[tt * nw + warp] = t2;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float v = sb_sum_over_p(st[i] * xp);
        if (lane < 4) sm.part[(tt * nw + warp) * N + n0 + i] = v;
      }
      a_next = expf(sm.da[tt]);
    }
    __syncthreads();
    for (int e = tid; e < SB_Q * N; e += blockDim.x) {
      const int tt = e / N, n = e % N, t = t0 + tt;
      if (t >= S) continue;
      float acc = 0.0f;
      for (int w = 0; w < nw; ++w) acc += sm.part[(tt * nw + w) * N + n];
      dbh[(((size_t)b * S + t) * H + h) * N + n] = acc;
    }
    if (tid == 0) {
      for (int tt = SB_Q - 1; tt >= 0; --tt) {
        const int t = t0 + tt;
        if (t >= S) continue;
        float second = 0.0f;
        for (int w = 0; w < nw; ++w) second += sm.tpart[tt * nw + w];
        float* slot = ddta + ((size_t)b * S + t) * H + h;
        run += (double)*slot - (double)second;
        *slot = (float)run;
      }
    }
  }
}

// db, dc (B, S, G, N) = the per-head partials (B, S, H, N) summed over
// each group's H / G heads, one thread per output entry.
__global__ void ssd_bwd_group_sum(const float* __restrict__ dbh,
                                  const float* __restrict__ dch,
                                  float* __restrict__ db,
                                  float* __restrict__ dc, long long total,
                                  int H, int G, int N) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int n = (int)(e % N);
  const long long bsg = e / N;
  const int g = (int)(bsg % G);
  const long long bs = bsg / G;
  const int R = H / G;
  const float* pb = dbh + (bs * H + (long long)g * R) * N + n;
  const float* pc = dch + (bs * H + (long long)g * R) * N + n;
  float sb = 0.0f, sc = 0.0f;
  for (int r = 0; r < R; ++r) {
    sb += pb[(long long)r * N];
    sc += pc[(long long)r * N];
  }
  db[e] = sb;
  dc[e] = sc;
}

template <int NT>
cudaError_t sb_launch(const float* xdt, const float* dta, const float* bm,
                      const float* cm, const float* dy, float* dxdt,
                      float* ddta, float* dbh, float* dch, int B, int S,
                      int H, int G, int P, cudaStream_t stream) {
  constexpr int N = 4 * NT;
  const int threads = 4 * P;
  const int nw = threads / 32;
  const size_t smem =
      sizeof(float) * (SB_Q * (2 * P + 2 * N + 1) + SB_Q * nw * (N + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_scan<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_scan<NT><<<dim3(H, B), threads, smem, stream>>>(
      xdt, dta, bm, cm, dy, dxdt, ddta, dbh, dch, S, H, G, P);
  return cudaGetLastError();
}

}  // namespace idkd

// xdt, dy, dxdt (B, S, H, P); dta, ddta (B, S, H); b, c, db, dc
// (B, S, G, N); dbh, dch (B, S, H, N) scratch; all f32, contiguous.
// P in {16, 32, 64}; N in {4, 8, 12, 16, 32, 64, 128}; H % G == 0. Two
// launches; returns cudaGetLastError() after them.
extern "C" int ssd_scan_bwd_launch(const void* xdt, const void* dta,
                                   const void* b, const void* c,
                                   const void* dy, void* dxdt, void* ddta,
                                   void* db, void* dc, void* dbh, void* dch,
                                   int B, int S, int H, int P, int G, int N,
                                   void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 ||
      !(P == 16 || P == 32 || P == 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* a = static_cast<const float*>(dta);
  const float* bm = static_cast<const float*>(b);
  const float* cm = static_cast<const float*>(c);
  const float* g = static_cast<const float*>(dy);
  float* dx = static_cast<float*>(dxdt);
  float* da = static_cast<float*>(ddta);
  float* pb = static_cast<float*>(dbh);
  float* pc = static_cast<float*>(dch);
  cudaError_t err;
  switch (N) {
#define SB_CASE(NT)                                                      \
  case 4 * NT:                                                           \
    err = idkd::sb_launch<NT>(x, a, bm, cm, g, dx, da, pb, pc, B, S, H, G, \
                              P, s);                                     \
    break;
    SB_CASE(1) SB_CASE(2) SB_CASE(3) SB_CASE(4) SB_CASE(8) SB_CASE(16)
    SB_CASE(32)
#undef SB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * S * G * N;
  idkd::ssd_bwd_group_sum<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      pb, pc, static_cast<float*>(db), static_cast<float*>(dc), total, H, G,
      N);
  return (int)cudaGetLastError();
}
