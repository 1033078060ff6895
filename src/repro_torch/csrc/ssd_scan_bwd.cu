// ssd_scan's backward pass for Hopper (sm_90a): the gradients of the
// Mamba-2 SSD scan's y with respect to xdt, dta, b and c.
//
// The JAX package has no backward Pallas kernel: its training
// differentiates ssd_chunked (src/repro/models/ssm.py) with XLA. The
// port runs ssd_scan.cu in the forward pass (the replacement of
// ssd_scan_pallas in src/repro/kernels/ssd_scan/kernel.py), so its
// backward is a kernel too: the function of ssd_scan_bwd_plain in
// kernels/ssd_scan/ops.py, computed by the passes that
// ssd_scan_bwd_passes_plain states in plain PyTorch. xdt, dy, dxdt
// (B, S, H, P), dta, ddta (B, S, H), b, c, db, dc (B, S, G, N), f32.
//
// Math. The forward's tiles of Q = 64 positions (ssd_scan.cu). Within a
// tile, with cum the inclusive cumulative sum of dta (in double, as the
// forward), L[t, u] = exp(cum_t - cum_u) for u <= t, M = (C B^T) o L, and
// w_s = exp(cum_end - cum_s):
//   y<   = M' X + exp(cum) o (C state_in^T)     (M' = M strictly lower)
//   dx>  = M'^T dY + w o (B G_next^T)
//   dxdt = dx> + (c_t . b_t) dy_t
//   R    = L o (dY X^T)
//   dc   = sum_h R B + exp(cum) o (dY state_in)
//   db   = sum_h R^T C + w o (X G_next)
//   dcum_t = dy_t . y<_t - xdt_t . dx>_t,  ddta = reverse cumsum of dcum
// where state_in is the state entering the tile from the left and
// G_next the reverse state entering it from the right:
// G_next[i] = R_{i+1} + exp(cum_end_{i+1}) G_next[i+1], with a tile's
// reverse state R_i = sum_t exp(cum_t) dy_t (x) c_t. y< and dx> hold only
// strictly earlier and strictly later positions, so dcum never forms
// dy.y - xdt.dxdt and then removes their shared diagonal term (which
// cancels in f32 where decays are steep). Every decay is exp of a
// difference of cumulative sums that is <= 0, never exp(cum_t) exp(-cum_u)
// (cum reaches about -2000 within a tile at Hymba's A = -50).
//
// Design: four kernels a call, two of them parallel over tiles.
//  1. ssd_bwd_chunk_states (chunk_states in ssd_common.cuh, the
//     forward's pass 1, with a second half of the grid): the forward
//     states of tiles 0..T-2 and the reverse states of tiles 1..T-1,
//     3xTF32 mma.sync (mma3_rn: each depth-8 step summed apart and
//     added to the accumulator in f32, see ssd_common.cuh).
//  2. ssd_bwd_state_passing: one thread per state entry walks the tiles,
//     left to right for state_in and right to left for G_next, in place.
//  3. ssd_bwd_tile, grid (head tile, tile, b): per group C B^T once; per
//     head M' (in shared memory), y< and dx> (their row dot products
//     with dY and X give dcum; dx> gives dxdt), then R in M''s place,
//     and dc and db per head. Every product runs on mma.sync m16n8k8 in
//     3xTF32 (mma3_rn, as pass 1), its A operand formed on the
//     fly where it is a scaled matrix (exp(cum) o C, w o B, ...).
//     Eight warps, so that the SM has sixteen to hide the fragments'
//     latency (the block's shared memory admits two blocks): in each
//     product warp w owns the 16-row tiles {w % 2, 3 - w % 2} (equal work
//     under the causal masks) and every fourth 8-column tile (every
//     second for dc and db, which run side by side on two halves of the
//     block).
//  4. ssd_bwd_finish: db and dc summed over each group's heads from the
//     per-head partials, in double; ddta as the reverse cumulative sum in double,
//     from each tile's dcum total and its positions' dcum.
// No atomics: every sum runs in a fixed order and the gradients are the
// same from run to run.
//
// Bound on the H100. The function reads xdt, dy, dta, b, c and writes
// dxdt, ddta, db, dc once (B S (3 H P + 2 H + 4 G N) floats: 0.051 ms at
// Hymba's training shape, B 2, S 2176, H 50, P 64, N 16), so it is bound
// by bytes. The tile states are the decomposition's own traffic: two
// (B, T - 1, H, P, N) f32 buffers written by pass 1, read and rewritten
// by pass 2 and read by pass 3 (8 x 27 MB at Hymba's shape), plus the
// per-head db / dc partials (B, S, H, N) written and read once. PERF.md
// has the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace idkd {

// ------------------------------------------------------------ pass 1
// The forward's tile states of tiles 0..nt-1 (blocks y < nt) and the
// reverse states of tiles 1..nt (y >= nt); see chunk_states.
template <int P, int NS>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_bwd_chunk_states(const float* __restrict__ xdt,
                     const float* __restrict__ dta,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ dy, float* __restrict__ fwd,
                     float* __restrict__ rev, float* __restrict__ cum_end,
                     int S, int H, int G, int N, int nt) {
  chunk_states<P, NS, true>(xdt, dta, bm, fwd, cum_end, S, H, G, N, nt, dy,
                            cm, rev);
}

// ------------------------------------------------------------ pass 2
// z < B: states <- the state after each tile (the forward's pass 2).
// z >= B: rev[j] holds R of tile j + 1; in place, right to left,
// rev[j] <- G_next of tile j = R_{j+1} + exp(cum_end_{j+1}) G_next[j+1].
__global__ void __launch_bounds__(SSD_PASS_THREADS)
ssd_bwd_state_passing(float* __restrict__ fwd, float* __restrict__ rev,
                      const float* __restrict__ cum_end, int B, int H,
                      int PN, int nt) {
  const int e = blockIdx.x * SSD_PASS_THREADS + threadIdx.x;
  const int h = blockIdx.y;
  const bool right = (int)blockIdx.z >= B;
  const int b = right ? blockIdx.z - B : blockIdx.z;
  if (e >= PN) return;
  float run = 0.0f;
  if (!right) {
#pragma unroll 4
    for (int c = 0; c < nt; ++c) {
      const size_t at = ((size_t)b * nt + c) * H + h;
      run = fmaf(run, expf(cum_end[at]), fwd[at * PN + e]);
      fwd[at * PN + e] = run;
    }
  } else {
#pragma unroll 4
    for (int j = nt - 1; j >= 0; --j) {
      const size_t at = ((size_t)b * nt + j) * H + h;
      const float decay = j + 1 < nt ? expf(cum_end[at + H]) : 0.0f;
      run = fmaf(run, decay, rev[at * PN + e]);
      rev[at * PN + e] = run;
    }
  }
}

// ------------------------------------------------------------ pass 3
// acc[j] (16 rows from r0, the 8 columns n0 + 8 nstep j) += A . B over
// k in [kb, ke) (multiples of 8), for the first nj of NT8 column tiles;
// A and B given element-wise: fa(row, k), fb(k, col).
template <int NT8, typename FA, typename FB>
__device__ __forceinline__ void sb_mma(float (&acc)[NT8][4], int nj, int r0,
                                       int kb, int ke, int n0, int nstep,
                                       FA fa, FB fb) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  for (int k = kb; k < ke; k += 8) {
    const int ka = k + q;
    FragA a;
    frag_a(a, fa(r0 + g, ka), fa(r0 + g + 8, ka), fa(r0 + g, ka + 4),
           fa(r0 + g + 8, ka + 4));
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      if (j < nj) {
        const int n = n0 + 8 * nstep * j + g;
        FragB bf;
        frag_b(bf, fb(ka, n), fb(ka + 4, n));
        mma3_rn(acc[j], a, bf);
      }
    }
  }
}

template <int NT8>
__device__ __forceinline__ void sb_zero(float (&acc)[NT8][4]) {
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

constexpr int SB_THREADS = 256;   // eight warps (pass 3)

// Shared memory of ssd_bwd_tile, in floats. Row strides are 4 mod 32,
// so that A-operand fragment loads (rows g, columns q) hit 32 banks.
template <int P, int NS>
struct BwdSmem {
  static constexpr int XS = P + 4;        // X, dY rows
  static constexpr int NSS = NS + 4;      // C, B rows; state rows
  static constexpr int MS = SSD_Q + 4;    // C B^T and R rows
  static constexpr int CUM = 0;                     // doubles [HT][Q]
  static constexpr int RED = CUM + 2 * SSD_HT * SSD_Q;  // doubles [2]
  static constexpr int EC = RED + 4;                // exp(cum_t)
  static constexpr int W = EC + SSD_Q;              // exp(cum_end - cum_t)
  static constexpr int PART = W + SSD_Q;            // dcum parts [8][Q]
  static constexpr int X = PART + 8 * SSD_Q;
  static constexpr int DY = X + SSD_Q * XS;
  static constexpr int C = DY + SSD_Q * XS;
  static constexpr int B = C + SSD_Q * NSS;
  static constexpr int ST = B + SSD_Q * NSS;        // state_in (P x N)
  static constexpr int GN = ST + P * NSS;           // G_next (P x N)
  static constexpr int CB = GN + P * NSS;
  static constexpr int R = CB + SSD_Q * MS;
  static constexpr int FLOATS = R + SSD_Q * MS;
  static_assert(X % 4 == 0 && XS % 4 == 0 && NSS % 4 == 0,
                "16-byte aligned rows");
  static_assert(FLOATS * 4 <= 232448, "fits one block's shared memory");
};

// Per (head tile, tile, b): dxdt, db and dc per head, dcum per position
// (double) and the tile's dcum total (double). NS: N padded to a
// multiple of 16 (zeros past N); the whole state width is resident.
// Warp w works on the 16-row tiles {tp, 3 - tp} (tp = w % 2: equal
// causal work) and on the 8-column tiles cg, cg + 4, ... (cg = w / 2) of
// each Q x P product; in R, on its causal column tiles that are cg mod
// 4; dc on warps with cg < 2 and db beside it on the others.
template <int P, int NS>
__global__ void __launch_bounds__(SB_THREADS)
ssd_bwd_tile(const float* __restrict__ xdt, const float* __restrict__ dta,
             const float* __restrict__ bm, const float* __restrict__ cm,
             const float* __restrict__ dy, const float* __restrict__ fwd,
             const float* __restrict__ rev, float* __restrict__ dxdt,
             float* __restrict__ dbh, float* __restrict__ dch,
             double* __restrict__ dcum, double* __restrict__ tile_tot,
             int S, int H, int G, int N, int nt) {
  using L = BwdSmem<P, NS>;
  constexpr int XS = L::XS, NSS = L::NSS, MS = L::MS;
  constexpr int PJ = P >= 64 ? P / 32 : 1;   // a warp's column tiles of P
  constexpr int NJ = NS / 16;                // and of dc's or db's NS
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  double* cum = reinterpret_cast<double*>(sm + L::CUM);
  double* red = reinterpret_cast<double*>(sm + L::RED);
  float* ec = sm + L::EC;
  float* wv = sm + L::W;
  float* part = sm + L::PART;
  float* Xs = sm + L::X;
  float* DYs = sm + L::DY;
  float* Cs = sm + L::C;
  float* Bs = sm + L::B;
  float* STs = sm + L::ST;
  float* GNs = sm + L::GN;
  float* CBs = sm + L::CB;
  float* Rs = sm + L::R;

  const int h0 = blockIdx.x * SSD_HT, ci = blockIdx.y, b = blockIdx.z;
  const int T = nt + 1;
  const int nh = min(SSD_HT, H - h0);
  const int s0 = ci * SSD_Q, len = min(SSD_Q, S - s0);
  const int rep = H / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int tpair = warp % 2, cg = warp / 2;
  // this warp's column tiles of P: cg, cg + 4, ... below P / 8
  const int pj = cg < P / 8 ? (P / 8 - cg + 3) / 4 : 0;
  const bool has_in = ci > 0, has_next = ci < T - 1;
  const size_t bc_rows = (size_t)G * N;
  const float* b_tile = bm + ((size_t)b * S + s0) * bc_rows;
  const float* c_tile = cm + ((size_t)b * S + s0) * bc_rows;
  const float* x_tile = xdt + ((size_t)b * S + s0) * H * P;
  const float* dy_tile = dy + ((size_t)b * S + s0) * H * P;
  tile_cumsum<SB_THREADS>(dta, b, S, H, s0, len, h0, nh, cum);

  int cb_group = -1;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh, grp = h / rep;
    const double* crow = cum + hh * SSD_Q;
    const bool new_group = grp != cb_group;
    __syncthreads();  // the previous head is done with every buffer
    if (new_group) {
      load_slice<NS, SSD_Q, SB_THREADS>(Cs, NSS, c_tile + (size_t)grp * N,
                                        bc_rows, len, 0, N);
      load_slice<NS, SSD_Q, SB_THREADS>(Bs, NSS, b_tile + (size_t)grp * N,
                                        bc_rows, len, 0, N);
    }
    load_x<P, XS, SB_THREADS>(Xs, x_tile + (size_t)h * P, (size_t)H * P,
                              len);
    load_x<P, XS, SB_THREADS>(DYs, dy_tile + (size_t)h * P, (size_t)H * P,
                              len);
    if (has_in)
      load_slice<NS, P, SB_THREADS>(
          STs, NSS, fwd + (((size_t)b * nt + ci - 1) * H + h) * P * N,
          (size_t)N, P, 0, N);
    if (has_next)
      load_slice<NS, P, SB_THREADS>(
          GNs, NSS, rev + (((size_t)b * nt + ci) * H + h) * P * N,
          (size_t)N, P, 0, N);
    if (tid < SSD_Q) {
      ec[tid] = expf((float)crow[tid]);
      wv[tid] = expf((float)(crow[SSD_Q - 1] - crow[tid]));
    }
    __syncthreads();

    if (new_group) {  // CB = C B^T: row tile w % 4, its causal column
                      // tiles of the parity w / 4
      const int rt = warp % 4, par = warp / 4;
      float cb[4][4];
      sb_zero(cb);
      sb_mma<4>(
          cb, rt + 1, 16 * rt, 0, NS, 8 * par, 2,
          [&](int t, int n) { return Cs[t * NSS + n]; },
          [&](int n, int u) { return Bs[u * NSS + n]; });
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j <= rt) {
          const int t = 16 * rt + g, u = 8 * (par + 2 * j) + 2 * q;
          *reinterpret_cast<float2*>(CBs + t * MS + u) =
              make_float2(cb[j][0], cb[j][1]);
          *reinterpret_cast<float2*>(CBs + (t + 8) * MS + u) =
              make_float2(cb[j][2], cb[j][3]);
        }
      }
      cb_group = grp;
      __syncthreads();
    }

    // M' = (C B^T) o L, strictly lower, once per head; in the R buffer,
    // which R takes over after the two products that read M'
    for (int e = tid; e < SSD_Q * SSD_Q; e += SB_THREADS) {
      const int t = e / SSD_Q, u = e % SSD_Q;
      Rs[t * MS + u] =
          u < t ? CBs[t * MS + u] * expf((float)(crow[t] - crow[u])) : 0.0f;
    }
    __syncthreads();
    const float* Ms = Rs;

    // y< = M' X + exp(cum) o (C state_in^T); its row dots with dY
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tt = i ? 3 - tpair : tpair;
      float acc[PJ][4];
      sb_zero(acc);
      if (pj > 0) {
        sb_mma<PJ>(
            acc, pj, 16 * tt, 0, 16 * tt + 16, 8 * cg, 4,
            [&](int t, int u) { return Ms[t * MS + u]; },
            [&](int u, int p) { return Xs[u * XS + p]; });
        if (has_in)
          sb_mma<PJ>(
              acc, pj, 16 * tt, 0, NS, 8 * cg, 4,
              [&](int t, int n) { return ec[t] * Cs[t * NSS + n]; },
              [&](int n, int p) { return STs[p * NSS + n]; });
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = 16 * tt + g + 8 * r;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          if (j < pj) {
            const int p = 8 * (cg + 4 * j) + 2 * q;
            s = fmaf(acc[j][2 * r], DYs[t * XS + p], s);
            s = fmaf(acc[j][2 * r + 1], DYs[t * XS + p + 1], s);
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (q == 0) part[cg * SSD_Q + t] = s;
      }
    }

    // dx> = M'^T dY + w o (B G_next^T); its row dots with X; dxdt
    float* dx_out = dxdt + ((size_t)b * S + s0) * H * P + (size_t)h * P;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tt = i ? 3 - tpair : tpair;
      float acc[PJ][4];
      sb_zero(acc);
      if (pj > 0) {
        sb_mma<PJ>(
            acc, pj, 16 * tt, 16 * tt, SSD_Q, 8 * cg, 4,
            [&](int s, int t) { return Ms[t * MS + s]; },
            [&](int t, int p) { return DYs[t * XS + p]; });
        if (has_next)
          sb_mma<PJ>(
              acc, pj, 16 * tt, 0, NS, 8 * cg, 4,
              [&](int s, int n) { return wv[s] * Bs[s * NSS + n]; },
              [&](int n, int p) { return GNs[p * NSS + n]; });
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = 16 * tt + g + 8 * r;
        const float diag = CBs[s * MS + s];
        float d = 0.0f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          if (j < pj) {
            const int p = 8 * (cg + 4 * j) + 2 * q;
            const float x0 = Xs[s * XS + p], x1 = Xs[s * XS + p + 1];
            d = fmaf(acc[j][2 * r], x0, d);
            d = fmaf(acc[j][2 * r + 1], x1, d);
            if (s < len)
              *reinterpret_cast<float2*>(dx_out + (size_t)s * H * P + p) =
                  make_float2(fmaf(diag, DYs[s * XS + p], acc[j][2 * r]),
                              fmaf(diag, DYs[s * XS + p + 1],
                                   acc[j][2 * r + 1]));
          }
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if (q == 0) part[(4 + cg) * SSD_Q + s] = d;
      }
    }
    __syncthreads();  // the products are done with M'; the dcum parts
                      // are complete

    // R = L o (dY X^T): row tile tt's causal column tiles 0..2tt+1 that
    // are cg mod 4
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tt = i ? 3 - tpair : tpair;
      const int nj = (cg < 2 * tt + 2) + (cg + 4 < 2 * tt + 2);
      float acc[2][4];
      sb_zero(acc);
      if (nj > 0)
        sb_mma<2>(
            acc, nj, 16 * tt, 0, P, 8 * cg, 4,
            [&](int t, int p) { return DYs[t * XS + p]; },
            [&](int p, int u) { return Xs[u * XS + p]; });
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < nj) {
          const int u = 8 * (cg + 4 * j) + 2 * q;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = 16 * tt + g + 8 * r;
            const float l0 =
                u <= t ? expf((float)(crow[t] - crow[u])) : 0.0f;
            const float l1 =
                u + 1 <= t ? expf((float)(crow[t] - crow[u + 1])) : 0.0f;
            *reinterpret_cast<float2*>(Rs + t * MS + u) =
                make_float2(acc[j][2 * r] * l0, acc[j][2 * r + 1] * l1);
          }
        }
      }
    }
    __syncthreads();  // R is complete

    // dc (per head) = R B + exp(cum) o (dY state_in) on warps cg < 2;
    // db (per head) = R^T C + w o (X G_next) on the others; each on the
    // 8-column tiles of NS that are cg mod 2
    const size_t nrow = (size_t)H * N;
    const bool is_dc = cg < 2;
    float* g_out = (is_dc ? dch : dbh) + ((size_t)b * S + s0) * nrow +
                   (size_t)h * N;
    const int nc0 = 8 * (cg % 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tt = i ? 3 - tpair : tpair;
      float acc[NJ][4];
      sb_zero(acc);
      if (is_dc) {
        sb_mma<NJ>(
            acc, NJ, 16 * tt, 0, 16 * tt + 16, nc0, 2,
            [&](int t, int u) { return Rs[t * MS + u]; },
            [&](int u, int n) { return Bs[u * NSS + n]; });
        if (has_in)
          sb_mma<NJ>(
              acc, NJ, 16 * tt, 0, P, nc0, 2,
              [&](int t, int p) { return ec[t] * DYs[t * XS + p]; },
              [&](int p, int n) { return STs[p * NSS + n]; });
      } else {
        sb_mma<NJ>(
            acc, NJ, 16 * tt, 16 * tt, SSD_Q, nc0, 2,
            [&](int s, int t) { return Rs[t * MS + s]; },
            [&](int t, int n) { return Cs[t * NSS + n]; });
        if (has_next)
          sb_mma<NJ>(
              acc, NJ, 16 * tt, 0, P, nc0, 2,
              [&](int s, int p) { return wv[s] * Xs[s * XS + p]; },
              [&](int p, int n) { return GNs[p * NSS + n]; });
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = 16 * tt + g + 8 * r, n = nc0 + 16 * j + 2 * q;
          if (t < len && n < N)
            *reinterpret_cast<float2*>(g_out + (size_t)t * nrow + n) =
                make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        }
    }

    // dcum_t = dy_t . y<_t - xdt_t . dx>_t in double, its four column
    // groups' parts summed in order; the tile's total
    if (tid < SSD_Q) {
      double v = 0.0;
      if (tid < len) {
        double yd = 0.0, xd = 0.0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yd += (double)part[c * SSD_Q + tid];
          xd += (double)part[(4 + c) * SSD_Q + tid];
        }
        v = yd - xd;
        dcum[((size_t)b * S + s0 + tid) * H + h] = v;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp] = v;
    }
    __syncthreads();
    if (tid == 0) tile_tot[((size_t)b * T + ci) * H + h] = red[0] + red[1];
  }
}

// ------------------------------------------------------------ pass 4
// Blocks [0, gs_blocks): db, dc (B, S, G, N) = the per-head partials
// (B, S, H, N) summed over each group's H / G heads in double, one
// thread per entry. Blocks after them, one per (tile, b): ddta at the tile's
// positions, the reverse cumulative sum of dcum in double: the totals of
// the later tiles, then the tile's positions from its end.
__global__ void __launch_bounds__(256)
ssd_bwd_finish(const float* __restrict__ dbh, const float* __restrict__ dch,
               float* __restrict__ db, float* __restrict__ dc,
               const double* __restrict__ dcum,
               const double* __restrict__ tile_tot,
               float* __restrict__ ddta, long long total, int gs_blocks,
               int S, int H, int G, int N, int T) {
  if ((int)blockIdx.x < gs_blocks) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    const int n = (int)(e % N);
    const long long bsg = e / N;
    const int g = (int)(bsg % G);
    const long long bs = bsg / G;
    const int R = H / G;
    const float* pb = dbh + (bs * H + (long long)g * R) * N + n;
    const float* pc = dch + (bs * H + (long long)g * R) * N + n;
    double sb = 0.0, sc = 0.0;   // up to 128 heads: an f32 sum's
    for (int r = 0; r < R; ++r) {  // rounding would rival the products'
      sb += pb[(long long)r * N];
      sc += pc[(long long)r * N];
    }
    db[e] = (float)sb;
    dc[e] = (float)sc;
    return;
  }
  const int k = blockIdx.x - gs_blocks;
  const int ci = k % T, b = k / T;
  const int s_lo = ci * SSD_Q, s_hi = min(S, s_lo + SSD_Q);
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    double run = 0.0;
    for (int j = ci + 1; j < T; ++j)
      run += tile_tot[((size_t)b * T + j) * H + h];
    for (int s = s_hi - 1; s >= s_lo; --s) {
      const size_t at = ((size_t)b * S + s) * H + h;
      run += dcum[at];
      ddta[at] = (float)run;
    }
  }
}

template <int P, int NS1, int NS>
cudaError_t sb_launch(const float* xdt, const float* dta, const float* bm,
                      const float* cm, const float* dy, float* dxdt,
                      float* ddta, float* db, float* dc, float* dbh,
                      float* dch, float* fwd, float* rev, float* cum_end,
                      double* dcum, double* tot, int B, int S, int H, int G,
                      int N, cudaStream_t stream) {
  const int T = (S + SSD_Q - 1) / SSD_Q, nt = T - 1;
  const int htiles = (H + SSD_HT - 1) / SSD_HT;
  cudaError_t err;
  if (nt > 0) {
    ssd_bwd_chunk_states<P, NS1>
        <<<dim3(htiles, 2 * nt, B), SSD_THREADS, 0, stream>>>(
            xdt, dta, bm, cm, dy, fwd, rev, cum_end, S, H, G, N, nt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int PN = P * N;
    ssd_bwd_state_passing<<<
        dim3((PN + SSD_PASS_THREADS - 1) / SSD_PASS_THREADS, H, 2 * B),
        SSD_PASS_THREADS, 0, stream>>>(fwd, rev, cum_end, B, H, PN, nt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = sizeof(float) * BwdSmem<P, NS>::FLOATS;
  err = cudaFuncSetAttribute(ssd_bwd_tile<P, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_tile<P, NS><<<dim3(htiles, T, B), SB_THREADS, smem, stream>>>(
      xdt, dta, bm, cm, dy, fwd, rev, dxdt, dbh, dch, dcum, tot, S, H, G, N,
      nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)B * S * G * N;
  const int gs_blocks = (int)((total + 255) / 256);
  ssd_bwd_finish<<<gs_blocks + T * B, 256, 0, stream>>>(
      dbh, dch, db, dc, dcum, tot, ddta, total, gs_blocks, S, H, G, N, T);
  return cudaGetLastError();
}

// NS1: pass 1's state slice (the forward's: 16 for N <= 16, else 32);
// NS: pass 3's resident state width, N rounded up to 16.
template <int P>
cudaError_t sb_dispatch(int N, const float* xdt, const float* dta,
                        const float* bm, const float* cm, const float* dy,
                        float* dxdt, float* ddta, float* db, float* dc,
                        float* dbh, float* dch, float* fwd, float* rev,
                        float* cum_end, double* dcum, double* tot, int B,
                        int S, int H, int G, cudaStream_t s) {
#define SB_ARGS                                                           \
  xdt, dta, bm, cm, dy, dxdt, ddta, db, dc, dbh, dch, fwd, rev, cum_end,  \
      dcum, tot, B, S, H, G, N, s
  if (N <= 16) return sb_launch<P, 16, 16>(SB_ARGS);
  if (N <= 32) return sb_launch<P, 32, 32>(SB_ARGS);
  if (N <= 64) return sb_launch<P, 32, 64>(SB_ARGS);
  return sb_launch<P, 32, 128>(SB_ARGS);
#undef SB_ARGS
}

}  // namespace idkd

// xdt, dy, dxdt (B, S, H, P); dta, ddta (B, S, H); b, c, db, dc
// (B, S, G, N); all f32, contiguous, 16-byte aligned. Scratch: dbh, dch
// (B, S, H, N) f32; fwd, rev (B, T - 1, H, P, N) f32 and cum_end
// (B, T - 1, H) f32 with T = ceil(S / 64) (unused when T = 1); dcum
// (B, S, H) and tot (B, T, H) float64. P in {16, 32, 64}; N a multiple of
// 4 up to 128; H % G == 0. Four launches (two when S <= 64); returns the
// first launch error.
extern "C" int ssd_scan_bwd_launch(const void* xdt, const void* dta,
                                   const void* b, const void* c,
                                   const void* dy, void* dxdt, void* ddta,
                                   void* db, void* dc, void* dbh, void* dch,
                                   void* fwd, void* rev, void* cum_end,
                                   void* dcum, void* tot, int B, int S,
                                   int H, int P, int G, int N, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 || N < 4 || N % 4 != 0 ||
      N > 128 || B > 32767 || (S + idkd::SSD_Q - 1) / idkd::SSD_Q > 32767)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* a = static_cast<const float*>(dta);
  const float* bm = static_cast<const float*>(b);
  const float* cm = static_cast<const float*>(c);
  const float* g = static_cast<const float*>(dy);
  float* dx = static_cast<float*>(dxdt);
  float* da = static_cast<float*>(ddta);
  float* dbp = static_cast<float*>(db);
  float* dcp = static_cast<float*>(dc);
  float* pb = static_cast<float*>(dbh);
  float* pc = static_cast<float*>(dch);
  float* f = static_cast<float*>(fwd);
  float* r = static_cast<float*>(rev);
  float* ce = static_cast<float*>(cum_end);
  double* dcu = static_cast<double*>(dcum);
  double* tt = static_cast<double*>(tot);
  switch (P) {
#define SB_CASE(PP)                                                       \
  case PP:                                                                \
    return (int)idkd::sb_dispatch<PP>(N, x, a, bm, cm, g, dx, da, dbp,    \
                                      dcp, pb, pc, f, r, ce, dcu, tt, B, S, \
                                      H, G, s);
    SB_CASE(16) SB_CASE(32) SB_CASE(64)
#undef SB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
