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
// Passes 1 and 2 and the helpers live in ssd_common.cuh, which the
// backward (ssd_scan_bwd.cu) shares.
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

#include "ssd_common.cuh"

namespace idkd {

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
