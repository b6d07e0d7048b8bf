// AVX-512BW layered min-sum decoder: 64 frames per vector, OpenMP over
// 64-frame blocks.  The framework's NATIVE CPU runtime component (the
// reference ships hand-SIMD per target, D8-D10; this is the TPU-framework
// counterpart: ONE runtime-parameterized kernel — runtime H tables,
// MS/OMS/NMS/2NMS via the same nms_f/offset parameters as LayeredSpec,
// per-LANE early-termination freeze, which the reference's SSE decoders
// do not have).
//
// Semantics are exactly golden/decoder.py::decode_golden (the scalar spec
// pinned against the reference's compiled decoders by tools/refcheck):
//   contrib = sat(v - m, sv); a = |sat(contrib, sm)| ('pre') or |contrib|;
//   running two-min; parity ^= (contrib > 0); f1/f2 per algo;
//   mag = (a == min1) ? f1 : f2; m' = (parity^pos) ? +mag : -mag
//   ('pre' clamps m' to +-sm); v' = sat(contrib + m', sv).
// Early termination freezes a lane at the end of its first iteration
// whose every check parity was 0 (identical to the JAX paths' per-lane
// freeze).  Bit-exactness is enforced by tests/test_torch_native.py (the
// port's copy of ldpcgputegra_tpu/native/simd_decoder.cpp).
//
// Not derived from the reference's CDecoder_*_SSE sources: written from
// this repo's golden spec; the structural ideas (frame-per-lane layout,
// two-min trick) are the standard fixed-point min-sum formulation both
// share.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int ldpc_simd_lanes() {
#if defined(__AVX512BW__)
  return 64;
#else
  return 0;
#endif
}

#if defined(__AVX512BW__)
#include <immintrin.h>

namespace {

using V = __m512i;
using M = __mmask64;

struct Params {
  int algo, iters, offset, pre, early, sv, sm, nf, nf2;
};

inline V clamp_sv(V x, V svp, V svn) {
  return _mm512_max_epi8(_mm512_min_epi8(x, svp), svn);
}

// bytes a in 0..127 -> (a * f) >> 5, f in 1..32 (fits int16 throughout)
inline V scale32(V a, V f16) {
  const V zero = _mm512_setzero_si512();
  V lo = _mm512_unpacklo_epi8(a, zero);
  V hi = _mm512_unpackhi_epi8(a, zero);
  lo = _mm512_srli_epi16(_mm512_mullo_epi16(lo, f16), 5);
  hi = _mm512_srli_epi16(_mm512_mullo_epi16(hi, f16), 5);
  return _mm512_packs_epi16(lo, hi);
}

inline void f_consts(const Params& p, V min1, V min2, V* f1, V* f2) {
  const V sm = _mm512_set1_epi8((char)p.sm);
  switch (p.algo) {
    case 0:  // MS
      *f1 = _mm512_min_epu8(min2, sm);
      *f2 = _mm512_min_epu8(min1, sm);
      return;
    case 1: {  // OMS: min(max(x - offset, 0), sm)
      const V off = _mm512_set1_epi8((char)p.offset);
      *f1 = _mm512_min_epu8(_mm512_subs_epu8(min2, off), sm);
      *f2 = _mm512_min_epu8(_mm512_subs_epu8(min1, off), sm);
      return;
    }
    case 2: {  // NMS: (x * nf) >> 5
      const V f = _mm512_set1_epi16((short)p.nf);
      *f1 = scale32(min2, f);
      *f2 = scale32(min1, f);
      return;
    }
    default: {  // 2NMS: min2 * nf2, min1 * nf
      const V fa = _mm512_set1_epi16((short)p.nf2);
      const V fb = _mm512_set1_epi16((short)p.nf);
      *f1 = scale32(min2, fa);
      *f2 = scale32(min1, fb);
      return;
    }
  }
}

constexpr int kMaxDeg = 64;

// One 64-frame block; var/msgs are [rows][64] int8.  Returns iterations
// executed (== iters unless every valid lane froze earlier).
int decode_block(const int32_t* class_degs, const int32_t* class_counts,
                 int n_classes, const int32_t* edges, int8_t* var,
                 int8_t* msgs, const Params& p, M valid) {
  const V zero = _mm512_setzero_si512();
  const V svp = _mm512_set1_epi8((char)p.sv);
  const V svn = _mm512_set1_epi8((char)(-p.sv));
  const V smp = _mm512_set1_epi8((char)p.sm);
  const V smn = _mm512_set1_epi8((char)(-p.sm));
  const V init_min = _mm512_set1_epi8(127);

  M act = p.early ? valid : valid;  // lanes still decoding
  int used = p.iters;
  for (int it = 0; it < p.iters; ++it) {
    M unsat = 0;
    const int32_t* e = edges;
    int8_t* mrow = msgs;
    for (int cls = 0; cls < n_classes; ++cls) {
      const int deg = class_degs[cls];
      const int count = class_counts[cls];
      for (int c = 0; c < count; ++c) {
        V contrib[kMaxDeg], absa[kMaxDeg];
        M pos[kMaxDeg];
        V min1 = init_min, min2 = init_min;
        M parity = 0;
        for (int j = 0; j < deg; ++j) {
          V v = _mm512_loadu_si512(var + (size_t)e[j] * 64);
          V m = _mm512_loadu_si512(mrow + (size_t)j * 64);
          V vc = clamp_sv(_mm512_subs_epi8(v, m), svp, svn);
          contrib[j] = vc;
          V a = _mm512_abs_epi8(vc);
          if (p.pre) a = _mm512_min_epu8(a, smp);
          absa[j] = a;
          pos[j] = _mm512_cmpgt_epi8_mask(vc, zero);
          parity ^= pos[j];
          // running two-min: min2 = min(min2, max(a, min1)); min1 = min
          min2 = _mm512_min_epu8(min2, _mm512_max_epu8(a, min1));
          min1 = _mm512_min_epu8(min1, a);
        }
        V f1, f2;
        f_consts(p, min1, min2, &f1, &f2);
        unsat |= parity;
        for (int j = 0; j < deg; ++j) {
          M is_min = _mm512_cmpeq_epi8_mask(absa[j], min1);
          V mag = _mm512_mask_blend_epi8(is_min, f2, f1);
          V neg = _mm512_sub_epi8(zero, mag);
          M s = parity ^ pos[j];
          V m_new = _mm512_mask_blend_epi8(s, neg, mag);
          if (p.pre) {
            m_new = _mm512_max_epi8(_mm512_min_epi8(m_new, smp), smn);
          }
          V v_new = clamp_sv(_mm512_adds_epi8(contrib[j], m_new), svp, svn);
          int8_t* vrow = var + (size_t)e[j] * 64;
          int8_t* mr = mrow + (size_t)j * 64;
          if (p.early) {
            // frozen lanes keep their old APP and messages
            V v_old = _mm512_loadu_si512(vrow);
            V m_old = _mm512_loadu_si512(mr);
            v_new = _mm512_mask_blend_epi8(act, v_old, v_new);
            m_new = _mm512_mask_blend_epi8(act, m_old, m_new);
          }
          _mm512_storeu_si512(vrow, v_new);
          _mm512_storeu_si512(mr, m_new);
        }
        e += deg;
        mrow += (size_t)deg * 64;
      }
    }
    if (p.early) {
      act &= unsat;
      if (act == 0) {
        used = it + 1;
        break;
      }
    }
  }
  return used;
}

}  // namespace

extern "C" void ldpc_decode_simd(
    const int32_t* class_degs, const int32_t* class_counts, int n_classes,
    const int32_t* edges, int n_edges, const int8_t* llr, int frames, int n,
    int8_t* out_bits, int algo, int iters, int offset, int minclamp_pre,
    int early_term, int sat_var, int sat_msg, int nms_f, int nms_f2,
    int32_t* iters_used) {
  Params p{algo,       iters,   offset, minclamp_pre, early_term,
           sat_var,    sat_msg, nms_f,  nms_f2};
  const int n_blocks = (frames + 63) / 64;
  int32_t used_max = 0;
#pragma omp parallel for schedule(dynamic) reduction(max : used_max)
  for (int b = 0; b < n_blocks; ++b) {
    const int b0 = b * 64;
    const int nb = frames - b0 < 64 ? frames - b0 : 64;
    std::vector<int8_t> var((size_t)n * 64);
    std::vector<int8_t> msgs((size_t)n_edges * 64, 0);
    // transpose in: frame-major -> lane-per-frame rows (padded lanes 0)
    for (int i = 0; i < n; ++i) {
      int8_t* row = var.data() + (size_t)i * 64;
      for (int l = 0; l < nb; ++l) row[l] = llr[(size_t)(b0 + l) * n + i];
      for (int l = nb; l < 64; ++l) row[l] = 0;
    }
    M valid = nb == 64 ? ~(M)0 : (((M)1 << nb) - 1);
    int used = decode_block(class_degs, class_counts, n_classes, edges,
                            var.data(), msgs.data(), p, valid);
    if (used > used_max) used_max = used;
    // hard decision (v > 0), transpose out
    for (int i = 0; i < n; ++i) {
      const int8_t* row = var.data() + (size_t)i * 64;
      for (int l = 0; l < nb; ++l) {
        out_bits[(size_t)(b0 + l) * n + i] = row[l] > 0 ? 1 : 0;
      }
    }
  }
  if (iters_used) *iters_used = used_max;
}

#else  // no AVX-512BW

extern "C" void ldpc_decode_simd(const int32_t*, const int32_t*, int,
                                 const int32_t*, int, const int8_t*, int,
                                 int, int8_t*, int, int, int, int, int, int,
                                 int, int, int, int32_t* iters_used) {
  if (iters_used) *iters_used = -1;  // unavailable; callers gate on
                                     // ldpc_simd_lanes() != 0
}

#endif
