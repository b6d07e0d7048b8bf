// Check-node arithmetic shared by the layered min-sum kernels
// (layered_minsum.cu, streamed_minsum.cu, gather_minsum.cu): the
// integer-exact forms of the reference's CUDA_{MS,OMS,NMS,2NMS}_SIMD.cu,
// identical to the plain PyTorch version (ops/layered.py::_cn_update,
// _f_consts).
//
// For one check with contributions c_j = clamp(APP - msg, +-sat_var):
//   a_j     = |clamp(c_j, +-sat_msg)| ('pre') or |c_j| ('post')
//   min1/2  = running two-min over a_j, in edge order
//   parity  = XOR of (c_j > 0)
//   msg_j   = +-f1 for the min edge (a_j == min1), +-f2 otherwise, with the
//             sign of parity ^ (c_j > 0), clamped to +-sat_msg under 'pre'.
//
// Every decode library is built for one (algorithm, minclamp) pair:
// kernels/_lib.py::defines passes -DMINSUM_ALGO=<Algo> -DMINSUM_PRE=<0|1>,
// a kernel takes the pair as template parameters and calls the forms below
// with them, so it carries that pair's arithmetic alone, with no per-edge
// select, and its C entry refuses any other pair (built_pair).

#pragma once

#if !defined(MINSUM_ALGO) || !defined(MINSUM_PRE)
#error "build one (algorithm, minclamp) pair: -DMINSUM_ALGO=0-3 -DMINSUM_PRE=0|1"
#endif

namespace minsum {

enum Algo { MS = 0, OMS = 1, NMS = 2, NMS2 = 3 };

// the constants of the check-node update, run-time values of the spec
struct CnSpec {
  int offset, nms_f, nms_f2, sat_var, sat_msg;
};

// true for the pair this library was built for; the C entries check the
// pair they are passed with it
__host__ inline bool built_pair(int algo, int minclamp_pre) {
  return algo == MINSUM_ALGO && minclamp_pre == MINSUM_PRE;
}

__device__ __forceinline__ int clampi(int x, int s) { return min(max(x, -s), s); }

// edge j of a check; min1 and min2 start at 0 and sat_var + 1
__device__ __forceinline__ void two_min(int j, int a, int& min1, int& min2) {
  if (j == 0) {
    min1 = a;
  } else {
    // running two-min, order-identical to CUDA_MS_SIMD.cu:168-170
    min2 = min(min2, max(a, min1));
    min1 = min(min1, a);
  }
}

// The magnitude the two-min sees (cn_abs), the message magnitudes f1 for
// the min edge and f2 for the others (cn_f) and the new c2v message of an
// edge (cn_msg), for the pair (ALGO, PRE).  Under 'pre', cn_f clamps f1
// and f2 to +-sat_msg and cn_msg does not clamp the message: the clamp is
// odd (clampi(-x, s) == -clampi(x, s)), so the pair computes the clamped
// message above.  For MS and OMS f1 and f2 already lie in [0, sat_msg], so
// there the clamp is left out.  These need sat_msg > 0, which the C entries
// check.

template <int ALGO, bool PRE>
__device__ __forceinline__ int cn_abs(int c, const CnSpec& s) {
  // |clampi(c, sat_msg)| == min(|c|, sat_msg), as sat_msg > 0
  if constexpr (PRE) return min(abs(c), s.sat_msg);
  else return abs(c);
}

template <int ALGO, bool PRE>
__device__ __forceinline__ void cn_f(int min1, int min2, const CnSpec& s,
                                     int& f1, int& f2) {
  if constexpr (ALGO == MS) {
    f1 = min(min2, s.sat_msg);
    f2 = min(min1, s.sat_msg);
  } else if constexpr (ALGO == OMS) {
    f1 = min(max(min2 - s.offset, 0), s.sat_msg);
    f2 = min(max(min1 - s.offset, 0), s.sat_msg);
  } else {
    f1 = (min2 * (ALGO == NMS ? s.nms_f : s.nms_f2)) >> 5;
    f2 = (min1 * s.nms_f) >> 5;
    if constexpr (PRE) {
      f1 = clampi(f1, s.sat_msg);
      f2 = clampi(f2, s.sat_msg);
    }
  }
}

// f1 and f2 from cn_f<ALGO, PRE>
template <int ALGO, bool PRE>
__device__ __forceinline__ int cn_msg(int c, bool parity, int min1, int f1,
                                      int f2, const CnSpec& s) {
  const int mag = (cn_abs<ALGO, PRE>(c, s) == min1) ? f1 : f2;
  return (parity != (c > 0)) ? mag : -mag;
}

// The same from the edge's magnitude a = cn_abs<ALGO, PRE>(c), computed
// once for the two-min, and a word whose sign bit is parity != (c > 0)
// (streamed_minsum.cu keeps the parity as the sign bit of the XOR of the
// negated contributions, so the word is that XOR with -c).
template <int ALGO, bool PRE>
__device__ __forceinline__ int cn_msg(int a, int sign, int min1, int f1,
                                      int f2) {
  const int mag = (a == min1) ? f1 : f2;
  return sign < 0 ? mag : -mag;
}

}  // namespace minsum
