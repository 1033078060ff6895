// head_select, bf16 on Hopper's tensor cores (sm_90a): fused classifier
// head + OoD detector + top-k sparse soft label, for L nodes in one
// launch. The bf16 variant of the port's head_select (the f32 variant
// runs csrc/head_select.cu).
//
// Replaces, with head_select.cu, the Pallas TPU kernel head_select_pallas
// / _head_kernel in src/repro/kernels/head_select/kernel.py, and computes
// the same function as that file's SIMT kernel and as head_select_plain,
// per node l and row r of hidden[l] (N, D) against the head w[l] (D, C):
//   s = hidden @ w + bias                 (f32, never written to memory)
//   (m, z) online softmax stats at T=1 -> conf = 1/z (MSP) or m + log z
//   the top-k of the raw logits with their class indices, ties to the
//   lowest index, renormalized at T by the shared finalize_row.
// The head arrives K-major: wt[l] (C, D), D a multiple of 8 (16-byte rows
// for TMA); the wrapper makes that copy of an untied (D, C) head, whose
// C-long rows are not 16-byte multiples, and passes a tied head's
// embedding table as it is.
//
// Bound on the H100. At Hymba's head (4 nodes x 16,384 rows, D 1600,
// C 32,001) the product is 6.7 TFLOP against 0.6 GB: bound by the bf16
// tensor cores (6.8 ms at 989 TFLOP/s). At Qwen3-1.7B's head (512 rows,
// D 2048, C 151,936) it is 0.32 TFLOP, and 512 rows are only 4 row tiles.
//
// Design. A block owns a 128-row tile of one node and a slice of the
// vocabulary, walked in 256-column tiles: two consumer warpgroups own 64
// rows each, and a producer warpgroup (one thread of it) streams the
// operands; setmaxnreg moves registers from the producer (40) to the
// consumers (232), whose 128 accumulators and epilogue then fit.
//  * Copies: TMA. For each column tile, 64-deep slices of the hidden
//    tile (A, 128 x 64) and of the head (B, 256 x 64) run through a ring
//    of 4 shared-memory stages (3 when k > 8: the top-k lists take the
//    room of the fourth) guarded by full/empty mbarriers. Depth past D
//    and rows past N or C read zeros, so ragged D (48) is zero-padded in
//    shared memory for free.
//  * Product: wgmma m64n256k16, both operands K-major from shared memory
//    with 128-byte swizzle, f32 accumulators (128 per thread); one
//    wgmma group stays in flight while the previous stage is released.
//  * Epilogue on the accumulator fragment, per column tile: a thread
//    holds two rows and 64 columns of each. It folds them into its own
//    per-row (m, z) and tests each logit against its own top-k
//    threshold; the rare candidate that passes is inserted into the
//    thread's sorted list in shared memory (strict '>', columns offered
//    in increasing order: ties keep the lowest index). The four threads
//    of a row merge (m, z) by shuffles and their lists by (value desc,
//    index asc) at the end, so lax.top_k's ties survive.
//  * Column split: when the row tiles of all nodes cannot fill the card,
//    the wrapper splits C into slices over blocks; each slice writes its
//    (m, z, top-k logits, indices) to scratch and head_select_merge
//    combines them as merge_head_stats does (m = max m_i, z = sum
//    z_i exp(m_i - m), the top-k of the union, ties to the lowest index),
//    then finalizes (or, in the raw_stats mode of the vocab-sharded
//    round, writes the merged carry unfinalized). Slices vary fastest in the grid, so the blocks that
//    run together share row tiles: at Hymba's head (512 row tiles) C is
//    cut in two only so that one wave's hidden tiles, re-read once per
//    column tile, fit the L2 (kernels/head_select/ops._column_splits).
//
// Products of bf16 values are exact in f32, so this kernel differs from
// the SIMT one only in summation order.
//
// f32 keeps the SIMT kernel: the ResNet main path (C = 10, a few
// microseconds of launch) and the f32 card-vs-CPU checks (1e-6) run it,
// and TF32 tiles would not hold those tolerances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "select_common.cuh"

namespace idkd {

constexpr int HT_ROWS = 128;     // rows per block (2 consumer warpgroups)
constexpr int HT_COLS = 256;     // columns per tile
constexpr int HT_DEPTH = 64;     // depth per stage: one 128-byte row
constexpr int HT_THREADS = 384;  // 2 consumer + 1 producer warpgroups
constexpr int HT_A_BYTES = HT_ROWS * 128;
constexpr int HT_B_BYTES = HT_COLS * 128;
constexpr int HT_STAGE_BYTES = HT_A_BYTES + HT_B_BYTES;
constexpr int HT_LIST_STRIDE = 2 * 256;  // between a list's slots
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int ht_bar_off(int k, int stages) {
  return stages * HT_STAGE_BYTES + 2 * k * 256 * 8;
}
__host__ __device__ constexpr int ht_smem_bytes(int k, int stages) {
  return ht_bar_off(k, stages) + 8 * 2 * stages + 1024;
}

// Insert (v, c) into one thread's sorted list (slots `HT_LIST_STRIDE`
// apart), known to beat its k-th entry; returns the new k-th value.
__device__ __forceinline__ float list_insert(float* lv, int* li, int k,
                                             float v, int c) {
  int j = k - 1;
  while (j > 0) {
    const float u = lv[(j - 1) * HT_LIST_STRIDE];
    if (!(v > u)) break;
    lv[j * HT_LIST_STRIDE] = u;
    li[j * HT_LIST_STRIDE] = li[(j - 1) * HT_LIST_STRIDE];
    --j;
  }
  lv[j * HT_LIST_STRIDE] = v;
  li[j * HT_LIST_STRIDE] = c;
  return lv[(k - 1) * HT_LIST_STRIDE];
}

template <int STAGES>
__global__ void __launch_bounds__(HT_THREADS, 1)
head_select_tc_kernel(const __grid_constant__ CUtensorMap th,
                      const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ bias, int N, int D, int C,
                      int k, int slice_w, int nsplit, float temperature,
                      int energy, int raw, float* __restrict__ conf,
                      float* __restrict__ vals, int* __restrict__ idx,
                      float* __restrict__ zout, float* __restrict__ pm,
                      float* __restrict__ pz, float* __restrict__ pv,
                      int* __restrict__ pi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lists_v = reinterpret_cast<float*>(smem + STAGES * HT_STAGE_BYTES);
  int* lists_i = reinterpret_cast<int*>(lists_v + k * HT_LIST_STRIDE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + ht_bar_off(k, STAGES));
  uint64_t* empty = full + STAGES;

  const int sl = blockIdx.x;          // slices vary fastest: blocks that
  const int row0 = blockIdx.y * HT_ROWS;  // run together share row tiles
  const int l = blockIdx.z;
  const int c_begin = sl * slice_w;
  const int c_end = min(C, c_begin + slice_w);
  const int n_ct = (c_end - c_begin + HT_COLS - 1) / HT_COLS;
  const int n_kb = (D + HT_DEPTH - 1) / HT_DEPTH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ------------------------------------------- producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int ct = 0; ct < n_ct; ++ct)
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* As = smem + s * HT_STAGE_BYTES;
          mbar_expect_tx(&full[s], HT_STAGE_BYTES);
          tma_load_3d(As, &th, &full[s], kb * HT_DEPTH, row0, l);
          tma_load_3d(As + HT_A_BYTES, &tw, &full[s], kb * HT_DEPTH,
                      c_begin + ct * HT_COLS, l);
        }
    }
    return;
  }

  // -------------------------------------------- consumer warpgroups
  setmaxnreg_inc<232>();
  const int tid = threadIdx.x;            // 0..255
  const int wg = warp / 4;
  const int wrow = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int col_q = 2 * (lane % 4);
  const float* bl = bias ? bias + (size_t)l * C : nullptr;
  float* my_v[2] = {lists_v + tid, lists_v + 256 + tid};
  int* my_i[2] = {lists_i + tid, lists_i + 256 + tid};
  for (int j = 0; j < k; ++j)
    for (int hh = 0; hh < 2; ++hh) {
      my_v[hh][j * HT_LIST_STRIDE] = NEG;
      my_i[hh][j * HT_LIST_STRIDE] = 0;
    }
  float m_run[2] = {NEG, NEG}, z_run[2] = {0.0f, 0.0f}, thr[2] = {NEG, NEG};

  float acc[128];
  int it = 0;
  for (int ct = 0; ct < n_ct; ++ct) {
    int prev = -1;
    for (int kb = 0; kb < n_kb; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* As = smem + s * HT_STAGE_BYTES;
      const uint8_t* Bs = As + HT_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sw128_desc(As + wg * 64 * 128 + kk * 32, 16);
        const uint64_t db = sw128_desc(Bs + kk * 32, 16);
        wgmma_m64n256k16_ss(acc, da, db, kb > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    // epilogue: bias, mask past the slice, (m, z) and the top-k test.
    // Columns past the slice are -inf, not NEG: a slice whose columns
    // are all NEG-biased padding (the vocab-sharded round's last slice)
    // then keeps z = its width, as the reference's carry does.
    const int c0 = c_begin + ct * HT_COLS;
    const float past = __int_as_float(0xff800000);
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + col_q + (e & 1);
        acc[4 * j + e] = col < c_end
                             ? acc[4 * j + e] + (bl ? __ldg(bl + col) : 0.0f)
                             : past;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        tmax = fmaxf(tmax,
                     fmaxf(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]));
      const float mn = fmaxf(m_run[hh], tmax);
      float zs = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        zs += fast_exp2((acc[4 * j + 2 * hh] - mn) * LOG2E) +
              fast_exp2((acc[4 * j + 2 * hh + 1] - mn) * LOG2E);
      z_run[hh] = z_run[hh] * fast_exp2((m_run[hh] - mn) * LOG2E) + zs;
      m_run[hh] = mn;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * j + 2 * hh + e];
          if (v > thr[hh])
            thr[hh] = list_insert(my_v[hh], my_i[hh], k, v,
                                  c0 + 8 * j + col_q + e);
        }
    }
  }

  // the row's four threads: (m, z) by shuffles, top-k lists by lane 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[hh], x);
      const float zo = __shfl_xor_sync(0xffffffffu, z_run[hh], x);
      const float mn = fmaxf(m_run[hh], mo);
      z_run[hh] = z_run[hh] * fast_exp2((m_run[hh] - mn) * LOG2E) +
                  zo * fast_exp2((mo - mn) * LOG2E);
      m_run[hh] = mn;
    }
  __syncwarp();
  if (lane % 4 != 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + wrow + 8 * hh;
    if (row >= N) continue;
    float tv[KMAX];
    int ti[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      tv[j] = NEG;
      ti[j] = 0;
    }
    float thr_v = NEG;
    int thr_i = 0;
    for (int q = 0; q < 4; ++q)
      for (int j = 0; j < k; ++j)
        topk_insert_ordered(tv, ti, k, my_v[hh][q + j * HT_LIST_STRIDE],
                            my_i[hh][q + j * HT_LIST_STRIDE], thr_v, thr_i);
    const size_t r = (size_t)l * N + row;
    if (nsplit == 1 && raw) {
      write_raw_row(m_run[hh], z_run[hh], tv, ti, k, conf + r, zout + r,
                    vals + r * k, idx + r * k);
    } else if (nsplit == 1) {
      finalize_row(m_run[hh], z_run[hh], tv, ti, k, temperature, energy,
                   conf + r, vals + r * k, idx + r * k);
    } else {
      const size_t p = r * nsplit + sl;
      pm[p] = m_run[hh];
      pz[p] = z_run[hh];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) {
          pv[p * k + j] = tv[j];
          pi[p * k + j] = ti[j];
        }
    }
  }
}

// One thread per row: merge the slices' (m, z, top-k) and finalize, or
// in the raw mode write the merged carry unfinalized.
__global__ void head_select_merge_kernel(const float* __restrict__ pm,
                                         const float* __restrict__ pz,
                                         const float* __restrict__ pv,
                                         const int* __restrict__ pi,
                                         int rows, int nsplit, int k,
                                         float temperature, int energy,
                                         int raw, float* __restrict__ conf,
                                         float* __restrict__ vals,
                                         int* __restrict__ idx,
                                         float* __restrict__ zout) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const size_t p0 = (size_t)r * nsplit;
  float m = NEG;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pm[p0 + s]);
  float z = 0.0f;
  for (int s = 0; s < nsplit; ++s) z += pz[p0 + s] * expf(pm[p0 + s] - m);
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = NEG;
    ti[j] = 0;
  }
  float thr_v = NEG;
  int thr_i = 0;
  for (int s = 0; s < nsplit; ++s)
    for (int j = 0; j < k; ++j)
      topk_insert_ordered(tv, ti, k, pv[(p0 + s) * k + j],
                          pi[(p0 + s) * k + j], thr_v, thr_i);
  if (raw)
    write_raw_row(m, z, tv, ti, k, conf + r, zout + r, vals + (size_t)r * k,
                  idx + (size_t)r * k);
  else
    finalize_row(m, z, tv, ti, k, temperature, energy, conf + r,
                 vals + (size_t)r * k, idx + (size_t)r * k);
}

}  // namespace idkd

// hidden (L, N, D) and wt (L, C, D) bf16, contiguous, 16-byte aligned, D a
// multiple of 8; bias f32 (L, C) or null. The vocabulary is cut into
// nsplit slices of slice_w columns (a multiple of 256); with nsplit > 1
// the partials pm/pz (L*N*nsplit) and pv/pi (L*N*nsplit*k) are scratch
// and a second kernel merges them. Outputs conf (L*N), vals/idx (L*N*k);
// with raw != 0 (the raw_stats mode) m goes to conf, z to z (L*N) and the
// top-k raw logits to vals, unfinalized, whatever nsplit. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue
// for arguments the kernel does not take or a refused tensor map).
extern "C" int head_select_tc_launch(const void* hidden, const void* wt,
                                     const void* bias, int L, int N, int D,
                                     int C, int k, int slice_w, int nsplit,
                                     float temperature, int energy, int raw,
                                     void* conf, void* vals, void* idx,
                                     void* z, void* pm, void* pz, void* pv,
                                     void* pi, void* stream) {
  using namespace idkd;
  if (k < 1 || k > KMAX || L < 1 || N < 1 || C < k || D < 1 || D % 8 ||
      slice_w < HT_COLS || slice_w % HT_COLS || nsplit < 1 ||
      (long long)slice_w * nsplit < C ||
      (long long)slice_w * (nsplit - 1) >= C ||
      (nsplit > 1 && (!pm || !pz || !pv || !pi)) || (raw && !z))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mh, mw;
  const cuuint64_t dh[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L};
  const cuuint64_t sh[2] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint64_t dw[3] = {(cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)L};
  const cuuint64_t sw[2] = {(cuuint64_t)D * 2, (cuuint64_t)C * D * 2};
  const cuuint32_t bh[3] = {HT_DEPTH, HT_ROWS, 1};
  const cuuint32_t bw[3] = {HT_DEPTH, HT_COLS, 1};
  if (!make_map_bf16(&mh, hidden, 3, dh, sh, bh) ||
      !make_map_bf16(&mw, wt, 3, dw, sw, bw))
    return (int)cudaErrorInvalidValue;
  // four stages when the top-k lists leave room for them (k <= 8)
  const bool four = ht_smem_bytes(k, 4) <= 232448;
  const int smem = ht_smem_bytes(k, four ? 4 : 3);
  auto kernel = four ? head_select_tc_kernel<4> : head_select_tc_kernel<3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsplit, (N + HT_ROWS - 1) / HT_ROWS, L);
  kernel<<<grid, HT_THREADS, smem, s>>>(
      mh, mw, static_cast<const float*>(bias), N, D, C, k, slice_w, nsplit,
      temperature, energy, raw, static_cast<float*>(conf),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(z), static_cast<float*>(pm),
      static_cast<float*>(pz),
      static_cast<float*>(pv), static_cast<int*>(pi));
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const int rows = L * N;
  head_select_merge_kernel<<<(rows + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pz),
      static_cast<const float*>(pv), static_cast<const int*>(pi), rows,
      nsplit, k, temperature, energy, raw, static_cast<float*>(conf),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(z));
  return (int)cudaGetLastError();
}
