// The masks of the port's four flash_attention kernels: their modes and
// the prefix-LM mask's tile ranges.
//
// causal: key kp is visible to row qp iff kp <= qp (and, with a window,
// qp - window < kp); Sk == Sq. prefix: PaliGemma's prefix-LM mask, the
// one chunked_attention (src/repro/models/attention.py) applies with
// prefix_len P: kp <= qp, or both qp and kp below P, so the prefix attends
// bidirectionally and the rest causally (no window; Sk == Sq; the
// wrappers clamp P to Sk, so P >= S is every key for every row). cross:
// every key kp < Sk, for any Sk.
#pragma once

namespace idkd {

constexpr int FA_CAUSAL = 0;
constexpr int FA_CROSS = 1;
constexpr int FA_PREFIX = 2;

// The last key row qp sees under the causal (prefix 0) or prefix-LM mask:
// its diagonal, or the prefix's last key for a row of the prefix. Each row
// sees the keys [0, fa_last_key(qp)] (without a window), and the function
// does not decrease in qp, so a tile of rows [q0, q1] sees keys up to
// fa_last_key(q1) and all its rows see the keys up to fa_last_key(q0).
__host__ __device__ __forceinline__ int fa_last_key(int qp, int prefix) {
  return qp < prefix ? prefix - 1 : qp;
}

// The first row that sees key kp: row 0 for a key of the prefix, else its
// diagonal. It does not decrease in kp either: a key tile's first key
// gives the first row its walk over query tiles starts from.
__host__ __device__ __forceinline__ int fa_first_row(int kp, int prefix) {
  return kp < prefix ? 0 : kp;
}

// Whether a launch's (causal, window, prefix) combination is one the
// kernels take (see ops.py's _check_mode).
__host__ __forceinline__ bool fa_mode_ok(int Sq, int Sk, int window,
                                         int causal, int prefix) {
  if (causal && Sk != Sq) return false;
  if (!causal && window > 0) return false;
  return prefix >= 0 && prefix <= Sk &&
         (prefix == 0 || (causal && window <= 0));
}

}  // namespace idkd
