// Shared device code of the SSD scan kernels (csrc/ssd_scan.cu, the
// forward, and csrc/ssd_scan_bwd.cu, its backward): the tile length, the
// 3xTF32 tensor-core products, the within-tile cumulative sum in double,
// the operand loaders, and the two passes that forward and backward
// share: the tile states (pass 1) and the state passing over tiles
// (pass 2). The design notes are in ssd_scan.cu's header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace idkd {

constexpr int SSD_Q = 64;          // positions per tile
constexpr int SSD_THREADS = 128;   // four warps (passes 1 and 3)
constexpr int SSD_HT = 4;          // heads per block (passes 1 and 3)
constexpr int SSD_PASS_THREADS = 256;

// ------------------------------------------------------------ 3xTF32
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {  // a 16 x 8 row-major A fragment, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8 x 8 column-major B fragment, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// a0 (row g, col q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4),
// with g = lane / 4 and q = lane % 4
__device__ __forceinline__ void frag_a(FragA& f, float a0, float a1, float a2,
                                       float a3) {
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
}

// b0 (row q, col g), b1 (q + 4, g)
__device__ __forceinline__ void frag_b(FragB& f, float b0, float b1) {
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b at f32 accuracy; d0 (row g, col 2q), d1 (g, 2q + 1),
// d2 (g + 8, 2q), d3 (g + 8, 2q + 1). The small terms go first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The same, the three products summed in a fresh accumulator and added to
// d by an f32 add that rounds to nearest. The tensor cores' adder aligns
// its terms to the largest one and truncates, so an mma that accumulates
// into d errs by up to an f32 ulp of |d| each time, always towards zero:
// over a depth-64 product (24 mma) that bias made the backward's
// gradients 4-9x less exact than the f32 recurrence. Here each depth-8
// step truncates once, relative to its own partial sum.
__device__ __forceinline__ void mma3_rn(float (&d)[4], const FragA& a,
                                        const FragB& b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// ------------------------------------------------------------ helpers
// cum[hh * Q + u]: the inclusive sum of dta over positions s0..s0 + u of
// head h0 + hh (zeros past len and past the last head), one warp per head.
// In double: the decays take differences cum_t - cum_u of sums that reach
// |cum| ~ 1e3 within a tile, and an f32 sum would carry |cum| * 6e-8 of
// absolute error into every exponent, more than the f32 recurrence's own
// error. The differences are rounded to f32 only as exp's argument.
template <int THREADS = SSD_THREADS>
__device__ __forceinline__ void tile_cumsum(const float* __restrict__ dta,
                                            int b, int S, int H, int s0,
                                            int len, int h0, int nh,
                                            double* cum) {
  const int tid = threadIdx.x;
  for (int e = tid; e < SSD_HT * SSD_Q; e += THREADS) {
    const int u = e / SSD_HT, hh = e % SSD_HT;
    cum[hh * SSD_Q + u] =
        (u < len && hh < nh) ? dta[((size_t)b * S + s0 + u) * H + h0 + hh]
                             : 0.0f;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int hh = warp; hh < SSD_HT; hh += THREADS / 32) {
    double v0 = cum[hh * SSD_Q + lane], v1 = cum[hh * SSD_Q + 32 + lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o0 = __shfl_up_sync(0xffffffffu, v0, off);
      const double o1 = __shfl_up_sync(0xffffffffu, v1, off);
      if (lane >= off) {
        v0 += o0;
        v1 += o1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    cum[hh * SSD_Q + lane] = v0;
    cum[hh * SSD_Q + 32 + lane] = v1;
  }
  __syncthreads();
}

// rows [0, ROWS) x columns [n0, n0 + NS) of a (.., N) row-major operand
// whose row r starts at src + r * rstride, into dst with row stride ds;
// zeros at rows >= len and columns >= N. N % 4 == 0, 16-byte aligned rows.
// Every load is issued before the first store, so that they overlap.
template <int NS, int ROWS, int THREADS = SSD_THREADS>
__device__ __forceinline__ void load_slice(float* dst, int ds,
                                           const float* __restrict__ src,
                                           size_t rstride, int len, int n0,
                                           int N) {
  constexpr int TOTAL = ROWS * (NS / 4);
  constexpr int PER = (TOTAL + THREADS - 1) / THREADS;
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / (NS / 4), n = n0 + 4 * (e % (NS / 4));
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < TOTAL && r < len && n < N)
      v[i] = *reinterpret_cast<const float4*>(src + r * rstride + n);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / (NS / 4), n = 4 * (e % (NS / 4));
    if (e < TOTAL) *reinterpret_cast<float4*>(dst + r * ds + n) = v[i];
  }
}

// xdt rows [0, Q) of a head, whose row 0 is at xrow0, into Xs (row stride
// XS), zeros past len; every load issued before the first store
template <int P, int XS, int THREADS = SSD_THREADS>
__device__ __forceinline__ void load_x(float* Xs,
                                       const float* __restrict__ xrow0,
                                       size_t rstride, int len) {
  constexpr int PER = SSD_Q * (P / 4) / THREADS;
  static_assert(PER * THREADS == SSD_Q * (P / 4), "whole float4s a thread");
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int u = e / (P / 4), p = 4 * (e % (P / 4));
    v[i] = u < len ? *reinterpret_cast<const float4*>(xrow0 + u * rstride + p)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int u = e / (P / 4), p = 4 * (e % (P / 4));
    *reinterpret_cast<float4*>(Xs + u * XS + p) = v[i];
  }
}

// ------------------------------------------------------------ pass 1
// Tile states S (P x N) of tiles 0..nt-1 (all full: nt = S/Q tiles - 1)
// into states (B, nt, H, P, N), and each tile's cum_end into (B, nt, H).
// BWD (the backward's kernel, ssd_scan_bwd.cu) doubles the grid's y:
// blocks nt..2nt-1 write the reverse states of tiles 1..nt (the last may
// be ragged), R = sum_t exp(cum_t) dy_t (x) c_t, into rstates (B, nt, H,
// P, N): the same product with dy for xdt, c for b and exp(cum_t) for
// the weights.
template <int P, int NS, bool BWD>
__device__ __forceinline__ void chunk_states(
    const float* __restrict__ xdt, const float* __restrict__ dta,
    const float* __restrict__ bm, float* __restrict__ states,
    float* __restrict__ cum_end, int S, int H, int G, int N, int nt,
    const float* __restrict__ dy, const float* __restrict__ cm,
    float* __restrict__ rstates) {
  constexpr int XS = P + 8;          // conflict-free A loads (X^T)
  constexpr int BS = NS + 8;     // conflict-free B loads
  constexpr int NTS = NS / 8;    // 8-wide column tiles of a slice
  constexpr int TILES = (P / 16) * NTS, TPW = (TILES + 3) / 4;
  static_assert(4 % NTS == 0, "a warp keeps one column tile");
  __shared__ double cum[SSD_HT * SSD_Q];
  __shared__ __align__(16) float Xs[SSD_Q * XS];
  __shared__ __align__(16) float Bs[SSD_Q * BS];
  __shared__ float w[SSD_Q];

  const bool rev = BWD && (int)blockIdx.y >= nt;
  const int h0 = blockIdx.x * SSD_HT, b = blockIdx.z;
  const int ci = rev ? blockIdx.y - nt + 1 : blockIdx.y;
  const int nh = min(SSD_HT, H - h0);
  const int s0 = ci * SSD_Q;
  const int len = rev ? min(SSD_Q, S - s0) : SSD_Q;
  const int rep = H / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n_slices = (N + NS - 1) / NS;
  if (rev) {
    xdt = dy;
    bm = cm;
    states = rstates;
  }
  const int oi = rev ? ci - 1 : ci;   // the output's tile index
  tile_cumsum(dta, b, S, H, s0, len, h0, nh, cum);

  const float* x_tile = xdt + ((size_t)b * S + s0) * H * P;
  int b_group = -1, b_slice = -1;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh, grp = h / rep;
    const double* crow = cum + hh * SSD_Q;
    const double cend = crow[SSD_Q - 1];
    __syncthreads();  // the previous head is done with Xs and w
    if (threadIdx.x < SSD_Q)
      w[threadIdx.x] = rev ? expf((float)crow[threadIdx.x])
                           : expf((float)(cend - crow[threadIdx.x]));
    if (!rev && threadIdx.x == 0)
      cum_end[((size_t)b * nt + ci) * H + h] = (float)cend;
    load_x<P, XS>(Xs, x_tile + (size_t)h * P, (size_t)H * P, len);
    float* dst = states + (((size_t)b * nt + oi) * H + h) * P * N;
    for (int sl = 0; sl < n_slices; ++sl) {
      if (grp != b_group || sl != b_slice) {  // uniform over the block
        __syncthreads();
        load_slice<NS, SSD_Q>(
            Bs, BS, bm + ((size_t)b * S + s0) * G * N + (size_t)grp * N,
            (size_t)G * N, len, sl * NS, N);
        b_group = grp;
        b_slice = sl;
      }
      __syncthreads();
      // the slice's (P / 16) x (NS / 8) output tiles, dealt to the warps:
      // warp w takes column tile w % NTS of row tiles (w + 4 i) / NTS
      float acc[TPW][4];
#pragma unroll
      for (int i = 0; i < TPW; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] = 0.0f;
      const int n8 = 8 * (warp % NTS) + g;
#pragma unroll 2
      for (int ks = 0; ks < SSD_Q / 8; ++ks) {
        const int u = 8 * ks + q;
        const float w0 = w[u], w1 = w[u + 4];
        FragB fb;
        frag_b(fb, Bs[u * BS + n8], Bs[(u + 4) * BS + n8]);
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int id = warp + 4 * i;
          if (id < TILES) {
            const int p = 16 * (id / NTS) + g;
            FragA fa;
            frag_a(fa, w0 * Xs[u * XS + p], w0 * Xs[u * XS + p + 8],
                   w1 * Xs[(u + 4) * XS + p], w1 * Xs[(u + 4) * XS + p + 8]);
            if constexpr (BWD)
              mma3_rn(acc[i], fa, fb);
            else
              mma3(acc[i], fa, fb);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int id = warp + 4 * i;
        const int p = 16 * (id / NTS) + g;
        const int n = sl * NS + 8 * (id % NTS) + 2 * q;
        if (id < TILES && n < N) {
          *reinterpret_cast<float2*>(dst + (size_t)p * N + n) =
              make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(dst + (size_t)(p + 8) * N + n) =
              make_float2(acc[i][2], acc[i][3]);
        }
      }
    }
  }
}

template <int P, int NS>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_states(const float* __restrict__ xdt, const float* __restrict__ dta,
                 const float* __restrict__ bm, float* __restrict__ states,
                 float* __restrict__ cum_end, int S, int H, int G, int N,
                 int nt) {
  chunk_states<P, NS, false>(xdt, dta, bm, states, cum_end, S, H, G, N, nt,
                             nullptr, nullptr, nullptr);
}

// ------------------------------------------------------------ pass 2
// In place: states[b, c] <- the state after tiles 0..c, i.e. the state
// entering tile c + 1.
__global__ void __launch_bounds__(SSD_PASS_THREADS)
ssd_state_passing(float* __restrict__ states,
                  const float* __restrict__ cum_end, int H, int PN, int nt) {
  const int e = blockIdx.x * SSD_PASS_THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float run = 0.0f;
#pragma unroll 4
  for (int c = 0; c < nt; ++c) {
    const size_t at = ((size_t)b * nt + c) * H + h;
    run = fmaf(run, expf(cum_end[at]), states[at * PN + e]);
    states[at * PN + e] = run;
  }
}

}  // namespace idkd
