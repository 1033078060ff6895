// ssd_scan for Hopper (sm_90a): the Mamba-2 SSD chunked scan, y only.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas / _ssd_kernel in
// src/repro/kernels/ssd_scan/kernel.py (:60), and computes the y of the
// model's ssd_chunked (src/repro/models/ssm.py) from its prologue's
// outputs: xdt (B, S, H, P) = x * dt, dta (B, S, H) = dt * -exp(a_log),
// and b, c (B, S, G, N) grouped, head h reading group h / (H / G) without
// a per-head copy. All f32. With cum the cumulative sum of dta within a
// tile of positions,
//   y[t] = sum_{u<=t in tile} (c_t . b_u) exp(cum_t - cum_u) xdt_u   (intra)
//        + exp(cum_t) c_t . state_in                              (inter)
// and a tile's state after it is exp(cum_end) state_in + S, with
//   S = sum_u exp(cum_end - cum_u) xdt_u (x) b_u.
// In exact arithmetic y does not depend on the tile length, so the kernel
// tiles by its own Q = 64 whatever `chunk` the caller's model uses; the
// ragged tail reads as zeros. No initial state in, no final state out.
//
// Design. The TPU kernel walks a (b, h)'s chunks as a sequential grid
// axis, state in VMEM. Only the (P x N) state recurrence is sequential,
// so here the scan is three kernels, two of them parallel over tiles:
//  1. ssd_chunk_states, grid (head tile, tile, b): a warp scan gives cum
//     for the block's 4 heads; per head S = (w o xdt)^T . b, a (P x Q) .
//     (Q x N) product, and the tile's cum_end. The last tile needs none.
//  2. ssd_state_passing, grid (P*N / 256, h, b): one thread per state
//     entry walks the tiles, state <- exp(cum_end) state + S, in place:
//     the buffer then holds each tile's state_in.
//  3. ssd_chunk_scan, grid (head tile, tile, b): CB = C . B^T (Q x Q,
//     depth N) once per group for the block's heads, kept in shared
//     memory; per head, M = CB o L_h (L_h[t, u] = exp(cum_t - cum_u) for
//     u <= t, only the causal 16 x 8 tiles visited) and
//     y = M . xdt_h + (exp(cum_t) o C) . state_in^T.
// The decay is never factored as exp(cum_t) exp(-cum_u): cum reaches
// about -2000 within a 64-tile at Hymba's A = -50, and exp(-cum_u) would
// overflow. exp(cum_t) alone is at most 1.
//
// The products run on the tensor cores as mma.sync m16n8k8 in TF32 with
// the 3xTF32 split (x = hi + lo, hi = tf32(x), lo = tf32(x - hi);
// a.b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, f32 accumulation), which keeps
// f32 accuracy: plain TF32 keeps ~3 digits and fails the float64 check.
// mma.sync, not wgmma: M is formed in registers from CB and the decays
// (wgmma in TF32 wants both operands K-major in shared memory, so M would
// make a round trip through it), and 16 x 8 tiles let a warp visit only
// the causal part of the triangle.
// Operand tiles live in shared memory with row strides padded so that a
// fragment's 32 loads hit 32 banks. N is taken in slices of 16 columns
// (N <= 16) or 32, zero-padded past N, so any N that is a multiple of 4
// with P*N <= 8192 fits.
//
// Bound on the H100. The function reads xdt, dta, b, c and writes y once:
// 452 MB at Hymba's shape (B 8, S 2176, H 50, P 64, N 16), 0.135 ms at
// 3.35 TB/s. The tile states are the decomposition's own traffic: pass 1
// writes (B, S/Q - 1, H, P, N) f32, pass 2 reads and rewrites it, pass 3
// reads it: 4 x 54 MB at Hymba (Q = 64), 4 x 390 MB at Mamba-2-780M's
// N = 128, where they outweigh the function's own 405 MB. A longer Q
// halves them but doubles CB and the shared memory per block. Measured
// on the H100 (PERF.md, python -m repro_torch.kernels.ablate): pass 3
// takes most of the time, its products (3 mma each) about a third of it;
// staging the next head's xdt in registers during this head's products
// was tried and was slower (it doubled the registers), and so were more
// heads a block.

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

// ------------------------------------------------------------ helpers
// cum[hh * Q + u]: the inclusive sum of dta over positions s0..s0 + u of
// head h0 + hh (zeros past len and past the last head), one warp per head.
// In double: the decays take differences cum_t - cum_u of sums that reach
// |cum| ~ 1e3 within a tile, and an f32 sum would carry |cum| * 6e-8 of
// absolute error into every exponent, more than the f32 recurrence's own
// error. The differences are rounded to f32 only as exp's argument.
__device__ __forceinline__ void tile_cumsum(const float* __restrict__ dta,
                                            int b, int S, int H, int s0,
                                            int len, int h0, int nh,
                                            double* cum) {
  const int tid = threadIdx.x;
  for (int e = tid; e < SSD_HT * SSD_Q; e += SSD_THREADS) {
    const int u = e / SSD_HT, hh = e % SSD_HT;
    cum[hh * SSD_Q + u] =
        (u < len && hh < nh) ? dta[((size_t)b * S + s0 + u) * H + h0 + hh]
                             : 0.0f;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int hh = warp; hh < SSD_HT; hh += SSD_THREADS / 32) {
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
template <int NS, int ROWS>
__device__ __forceinline__ void load_slice(float* dst, int ds,
                                           const float* __restrict__ src,
                                           size_t rstride, int len, int n0,
                                           int N) {
  constexpr int TOTAL = ROWS * (NS / 4);
  constexpr int PER = (TOTAL + SSD_THREADS - 1) / SSD_THREADS;
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * SSD_THREADS;
    const int r = e / (NS / 4), n = n0 + 4 * (e % (NS / 4));
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < TOTAL && r < len && n < N)
      v[i] = *reinterpret_cast<const float4*>(src + r * rstride + n);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * SSD_THREADS;
    const int r = e / (NS / 4), n = 4 * (e % (NS / 4));
    if (e < TOTAL) *reinterpret_cast<float4*>(dst + r * ds + n) = v[i];
  }
}

// xdt rows [0, Q) of a head, whose row 0 is at xrow0, into Xs (row stride
// XS), zeros past len; every load issued before the first store
template <int P, int XS>
__device__ __forceinline__ void load_x(float* Xs,
                                       const float* __restrict__ xrow0,
                                       size_t rstride, int len) {
  constexpr int PER = SSD_Q * (P / 4) / SSD_THREADS;
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * SSD_THREADS;
    const int u = e / (P / 4), p = 4 * (e % (P / 4));
    v[i] = u < len ? *reinterpret_cast<const float4*>(xrow0 + u * rstride + p)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * SSD_THREADS;
    const int u = e / (P / 4), p = 4 * (e % (P / 4));
    *reinterpret_cast<float4*>(Xs + u * XS + p) = v[i];
  }
}

// ------------------------------------------------------------ pass 1
// Tile states S (P x N) of tiles 0..nt-1 (all full: nt = S/Q tiles - 1)
// into states (B, nt, H, P, N), and each tile's cum_end into (B, nt, H).
template <int P, int NS>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_states(const float* __restrict__ xdt, const float* __restrict__ dta,
                 const float* __restrict__ bm, float* __restrict__ states,
                 float* __restrict__ cum_end, int S, int H, int G, int N,
                 int nt) {
  constexpr int XS = P + 8;          // conflict-free A loads (X^T)
  constexpr int BS = NS + 8;     // conflict-free B loads
  constexpr int NTS = NS / 8;    // 8-wide column tiles of a slice
  constexpr int TILES = (P / 16) * NTS, TPW = (TILES + 3) / 4;
  static_assert(4 % NTS == 0, "a warp keeps one column tile");
  __shared__ double cum[SSD_HT * SSD_Q];
  __shared__ __align__(16) float Xs[SSD_Q * XS];
  __shared__ __align__(16) float Bs[SSD_Q * BS];
  __shared__ float w[SSD_Q];

  const int h0 = blockIdx.x * SSD_HT, ci = blockIdx.y, b = blockIdx.z;
  const int nh = min(SSD_HT, H - h0);
  const int s0 = ci * SSD_Q;
  const int rep = H / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n_slices = (N + NS - 1) / NS;
  tile_cumsum(dta, b, S, H, s0, SSD_Q, h0, nh, cum);

  const float* x_tile = xdt + ((size_t)b * S + s0) * H * P;
  int b_group = -1, b_slice = -1;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh, grp = h / rep;
    const double* crow = cum + hh * SSD_Q;
    const double cend = crow[SSD_Q - 1];
    __syncthreads();  // the previous head is done with Xs and w
    if (threadIdx.x < SSD_Q)
      w[threadIdx.x] = expf((float)(cend - crow[threadIdx.x]));
    if (threadIdx.x == 0) cum_end[((size_t)b * nt + ci) * H + h] = (float)cend;
    load_x<P, XS>(Xs, x_tile + (size_t)h * P, (size_t)H * P, SSD_Q);
    float* dst = states + (((size_t)b * nt + ci) * H + h) * P * N;
    for (int sl = 0; sl < n_slices; ++sl) {
      if (grp != b_group || sl != b_slice) {  // uniform over the block
        __syncthreads();
        load_slice<NS, SSD_Q>(
            Bs, BS, bm + ((size_t)b * S + s0) * G * N + (size_t)grp * N,
            (size_t)G * N, SSD_Q, sl * NS, N);
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

// ------------------------------------------------------------ pass 3
template <int P, int NS>
struct ScanSmem {
  static constexpr int XS = P + 8;        // conflict-free B loads of X
  static constexpr int CS = NS + 4;   // conflict-free C, B, state loads
  static constexpr int MS = SSD_Q + 4;    // conflict-free CB loads
  static constexpr int CUM = 0;                 // doubles
  static constexpr int X = CUM + 2 * SSD_HT * SSD_Q;
  static constexpr int C = X + SSD_Q * XS;
  static constexpr int BST = C + SSD_Q * CS;  // B slice, then state slice
  static constexpr int CB = BST + SSD_Q * CS;
  static constexpr int FLOATS = CB + SSD_Q * MS;
};

template <int P, int NS>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_scan(const float* __restrict__ xdt, const float* __restrict__ dta,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ states, float* __restrict__ y,
               int S, int H, int G, int N, int nt) {
  using L = ScanSmem<P, NS>;
  constexpr int XS = L::XS, CS = L::CS, MS = L::MS;
  constexpr int NT = P / 16;  // 8-wide column tiles in a warp's half of P
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  double* cum = reinterpret_cast<double*>(sm + L::CUM);
  float* Xs = sm + L::X;
  float* Cs = sm + L::C;
  float* Bs = sm + L::BST;
  float* CBs = sm + L::CB;

  const int h0 = blockIdx.x * SSD_HT, ci = blockIdx.y, b = blockIdx.z;
  const int nh = min(SSD_HT, H - h0);
  const int s0 = ci * SSD_Q, len = min(SSD_Q, S - s0);
  const int rep = H / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n_slices = (N + NS - 1) / NS;
  // warp w: 16-row t tiles {w % 2, 3 - w % 2} (3 + 7 = 5 + 5 k steps of
  // the causal triangle), columns [w / 2 * P / 2, (w / 2 + 1) * P / 2)
  const int tpair = warp % 2, pc0 = (warp / 2) * (P / 2);
  const size_t bc_rows = (size_t)G * N;
  const float* b_tile = bm + ((size_t)b * S + s0) * bc_rows;
  const float* c_tile = cm + ((size_t)b * S + s0) * bc_rows;
  tile_cumsum(dta, b, S, H, s0, len, h0, nh, cum);
  const float* x_tile = xdt + ((size_t)b * S + s0) * H * P;
  const float* st_tile =
      ci > 0 ? states + ((size_t)b * nt + ci - 1) * H * P * N : nullptr;

  int cb_group = -1, c_group = -1, c_slice = -1;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh, grp = h / rep;
    const double* crow = cum + hh * SSD_Q;
    if (grp != cb_group) {  // CB = C . B^T, lower 16 x 8 tiles only
      float cb[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) cb[j][i] = 0.0f;
      for (int sl = 0; sl < n_slices; ++sl) {
        __syncthreads();  // earlier readers of Cs, Bs and CBs are done
        load_slice<NS, SSD_Q>(Cs, CS, c_tile + (size_t)grp * N, bc_rows, len,
                              sl * NS, N);
        load_slice<NS, SSD_Q>(Bs, CS, b_tile + (size_t)grp * N, bc_rows, len,
                              sl * NS, N);
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < NS / 8; ++ks) {
          const int n = 8 * ks + q, t = 16 * warp + g;
          FragA fa;
          frag_a(fa, Cs[t * CS + n], Cs[(t + 8) * CS + n],
                 Cs[t * CS + n + 4], Cs[(t + 8) * CS + n + 4]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j <= 2 * warp + 1) {
              FragB fb;
              frag_b(fb, Bs[(8 * j + g) * CS + n], Bs[(8 * j + g) * CS + n + 4]);
              mma3(cb[j], fa, fb);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j <= 2 * warp + 1) {
          const int t = 16 * warp + g, u = 8 * j + 2 * q;
          *reinterpret_cast<float2*>(CBs + t * MS + u) =
              make_float2(cb[j][0], cb[j][1]);
          *reinterpret_cast<float2*>(CBs + (t + 8) * MS + u) =
              make_float2(cb[j][2], cb[j][3]);
        }
      }
      cb_group = c_group = grp;
      c_slice = n_slices - 1;
    }
    __syncthreads();  // the previous head is done with Xs; CBs written
    load_x<P, XS>(Xs, x_tile + (size_t)h * P, (size_t)H * P, len);
    __syncthreads();

    float acc[2][NT][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt8 = 0; nt8 < NT; ++nt8)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][nt8][i] = 0.0f;

    // intra: M . X over the causal k steps of each t tile
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tt = j ? 3 - tpair : tpair;
      const int tA = 16 * tt + g, tB = tA + 8;
      const double cA = crow[tA], cB = crow[tB];
      for (int ks = 0; ks <= 2 * tt + 1; ++ks) {
        const int u = 8 * ks + q;
        const double cu0 = crow[u], cu1 = crow[u + 4];
        FragA fa;
        frag_a(fa,
               u <= tA ? CBs[tA * MS + u] * expf((float)(cA - cu0)) : 0.0f,
               u <= tB ? CBs[tB * MS + u] * expf((float)(cB - cu0)) : 0.0f,
               u + 4 <= tA ? CBs[tA * MS + u + 4] * expf((float)(cA - cu1))
                           : 0.0f,
               u + 4 <= tB ? CBs[tB * MS + u + 4] * expf((float)(cB - cu1))
                           : 0.0f);
#pragma unroll
        for (int nt8 = 0; nt8 < NT; ++nt8) {
          const int p = pc0 + 8 * nt8 + g;
          FragB fb;
          frag_b(fb, Xs[u * XS + p], Xs[(u + 4) * XS + p]);
          mma3(acc[j][nt8], fa, fb);
        }
      }
    }

    // inter: (exp(cum_t) o C) . state_in^T; tile 0 enters with no state
    if (ci > 0) {
      const float* st = st_tile + (size_t)h * P * N;
      for (int sl = 0; sl < n_slices; ++sl) {
        __syncthreads();  // earlier readers of Cs and Bs are done
        if (grp != c_group || sl != c_slice) {
          load_slice<NS, SSD_Q>(Cs, CS, c_tile + (size_t)grp * N, bc_rows,
                                len, sl * NS, N);
          c_group = grp;
          c_slice = sl;
        }
        load_slice<NS, P>(Bs, CS, st, (size_t)N, P, sl * NS, N);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int tt = j ? 3 - tpair : tpair;
          const int tA = 16 * tt + g, tB = tA + 8;
          const float eA = expf((float)crow[tA]), eB = expf((float)crow[tB]);
#pragma unroll
          for (int ks = 0; ks < NS / 8; ++ks) {
            const int n = 8 * ks + q;
            FragA fa;
            frag_a(fa, eA * Cs[tA * CS + n], eB * Cs[tB * CS + n],
                   eA * Cs[tA * CS + n + 4], eB * Cs[tB * CS + n + 4]);
#pragma unroll
            for (int nt8 = 0; nt8 < NT; ++nt8) {
              const int p = pc0 + 8 * nt8 + g;
              FragB fb;
              frag_b(fb, Bs[p * CS + n], Bs[p * CS + n + 4]);
              mma3(acc[j][nt8], fa, fb);
            }
          }
        }
      }
    }

    float* yb = y + ((size_t)b * S + s0) * H * P + (size_t)h * P;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tt = j ? 3 - tpair : tpair;
      const int tA = 16 * tt + g, tB = tA + 8;
#pragma unroll
      for (int nt8 = 0; nt8 < NT; ++nt8) {
        const int p = pc0 + 8 * nt8 + 2 * q;
        if (tA < len)
          *reinterpret_cast<float2*>(yb + (size_t)tA * H * P + p) =
              make_float2(acc[j][nt8][0], acc[j][nt8][1]);
        if (tB < len)
          *reinterpret_cast<float2*>(yb + (size_t)tB * H * P + p) =
              make_float2(acc[j][nt8][2], acc[j][nt8][3]);
      }
    }
  }
}

template <int P, int NS>
cudaError_t ssd_launch(const float* xdt, const float* dta, const float* b,
                       const float* c, float* y, float* states,
                       float* cum_end, int B, int S, int H, int G, int N,
                       cudaStream_t stream) {
  const int tiles = (S + SSD_Q - 1) / SSD_Q, nt = tiles - 1;
  const int htiles = (H + SSD_HT - 1) / SSD_HT;
  cudaError_t err;
  if (nt > 0) {
    ssd_chunk_states<P, NS><<<dim3(htiles, nt, B), SSD_THREADS, 0, stream>>>(
        xdt, dta, b, states, cum_end, S, H, G, N, nt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int PN = P * N;
    ssd_state_passing<<<dim3((PN + SSD_PASS_THREADS - 1) / SSD_PASS_THREADS,
                             H, B),
                        SSD_PASS_THREADS, 0, stream>>>(states, cum_end, H,
                                                       PN, nt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = sizeof(float) * ScanSmem<P, NS>::FLOATS;
  err = cudaFuncSetAttribute(ssd_chunk_scan<P, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<P, NS><<<dim3(htiles, tiles, B), SSD_THREADS, smem,
                           stream>>>(xdt, dta, b, c, states, y, S, H, G, N,
                                     nt);
  return cudaGetLastError();
}

// State columns per slice: 16 where N <= 16 (Hymba), so that no product
// runs on zero padding; 32 above, so that fewer slices (each a pair of
// barriers) cover a large N.
template <int P>
cudaError_t ssd_dispatch(const float* xdt, const float* dta, const float* b,
                         const float* c, float* y, float* states,
                         float* cum_end, int B, int S, int H, int G, int N,
                         cudaStream_t stream) {
  if (N <= 16)
    return ssd_launch<P, 16>(xdt, dta, b, c, y, states, cum_end, B, S, H, G,
                             N, stream);
  return ssd_launch<P, 32>(xdt, dta, b, c, y, states, cum_end, B, S, H, G, N,
                           stream);
}

}  // namespace idkd

// xdt/y (B, S, H, P), dta (B, S, H), b/c (B, S, G, N): float32,
// contiguous, 16-byte aligned. P in {16, 32, 64}; N a multiple of 4 with
// P*N <= 8192; H % G == 0. Scratch: states (B, ceil(S/64) - 1, H, P, N)
// and cum_end (B, ceil(S/64) - 1, H) f32 (unused when S <= 64). Issues
// the three passes on `stream`; returns the first launch error.
extern "C" int ssd_scan_launch(const void* xdt, const void* dta,
                               const void* b, const void* c, void* y,
                               void* states, void* cum_end, int B, int S,
                               int H, int P, int G, int N, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 || N < 4 || N % 4 != 0 ||
      P * N > 8192 || B > 65535 || (S + idkd::SSD_Q - 1) / idkd::SSD_Q > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* d = static_cast<const float*>(dta);
  const float* bp = static_cast<const float*>(b);
  const float* cp = static_cast<const float*>(c);
  float* yp = static_cast<float*>(y);
  float* st = static_cast<float*>(states);
  float* ce = static_cast<float*>(cum_end);
  switch (P) {
    case 16: return (int)idkd::ssd_dispatch<16>(x, d, bp, cp, yp, st, ce, B, S, H, G, N, s);
    case 32: return (int)idkd::ssd_dispatch<32>(x, d, bp, cp, yp, st, ce, B, S, H, G, N, s);
    case 64: return (int)idkd::ssd_dispatch<64>(x, d, bp, cp, yp, st, ce, B, S, H, G, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
