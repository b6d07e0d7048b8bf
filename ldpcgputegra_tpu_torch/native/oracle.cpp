// Scalar fixed-point layered min-sum oracle (native golden model).
//
// C++ re-implementation of the semantics of the reference's scalar oracle
// CDecoder_OMS_fixed_x86::decode_8bits (code/ldpc_decoder_arm/CDecoder/OMS/
// CDecoder_OMS_fixed_x86.cpp:60-150) and the GPU kernel variant math
// (code/gpu_fixed/decoder_{ms,oms,nms,2nms}/cuda/*.cu), matching the Python
// golden model in golden/decoder.py bit for bit.  Used through ctypes as the
// fast bit-exactness oracle for every decoder path (the NumPy model is
// ~100x slower and remains the readable specification).
//
// The port's copy of ldpcgputegra_tpu/native/oracle.cpp.  Built with
// simd_decoder.cpp and awgn.cpp into one library by golden/native.py at
// first use (g++ -O3 -fPIC -march=native -fopenmp).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline int sat(int v, int s) { return v < -s ? -s : (v > s ? s : v); }

enum Algo { MS = 0, OMS = 1, NMS = 2, TWO_NMS = 3 };

// nms_f / nms_f2: NMS normalization factors in 1/32 units (x86 reference
// `-NMS <factor>` fixed path, VECTOR_MUL + DIV32; CUDA defaults 24 / 28).
inline void f_consts(int algo, int offset, int min1, int min2, int sat_msg,
                     int nms_f, int nms_f2, int* f1, int* f2) {
  switch (algo) {
    case MS:
      *f1 = min2 < sat_msg ? min2 : sat_msg;
      *f2 = min1 < sat_msg ? min1 : sat_msg;
      return;
    case OMS: {
      int a = min2 - offset, b = min1 - offset;
      a = a < 0 ? 0 : a;
      b = b < 0 ? 0 : b;
      *f1 = a < sat_msg ? a : sat_msg;
      *f2 = b < sat_msg ? b : sat_msg;
      return;
    }
    case NMS:
      *f1 = (min2 * nms_f) >> 5;
      *f2 = (min1 * nms_f) >> 5;
      return;
    case TWO_NMS:
      *f1 = (min2 * nms_f2) >> 5;
      *f2 = (min1 * nms_f) >> 5;
      return;
  }
  *f1 = *f2 = 0;
}

}  // namespace

extern "C" {

// Decode `frames` frames of int8 LLRs (frame-major [frames, n]).
// classes: n_classes pairs (deg, count); edges: flat check-major VN table.
// minclamp_pre: 1 = x86-oracle semantics (|v| clamped to msg range before
// the min reduction), 0 = GPU-kernel semantics.
// Returns per-frame iterations used in iters_used (if non-null).
void ldpc_decode_golden(const int32_t* class_degs, const int32_t* class_counts,
                        int n_classes, const int32_t* edges, int n_edges,
                        const int8_t* llr, int frames, int n, int8_t* out_bits,
                        int algo, int iters, int offset, int minclamp_pre,
                        int early_term, int sat_var, int sat_msg,
                        int nms_f, int nms_f2, int32_t* iters_used) {
  const int kSatVar = sat_var;
  const int kSatMsg = sat_msg;
  std::vector<int> v(n);
  std::vector<int> msgs(n_edges);
  std::vector<int> contrib(256);
  for (int f = 0; f < frames; ++f) {
    const int8_t* in = llr + (size_t)f * n;
    int8_t* out = out_bits + (size_t)f * n;
    for (int i = 0; i < n; ++i) v[i] = in[i];
    std::fill(msgs.begin(), msgs.end(), 0);
    int used = iters;
    for (int it = 0; it < iters; ++it) {
      int ov_sign = 0;
      const int32_t* e = edges;
      int* mg = msgs.data();
      for (int c = 0; c < n_classes; ++c) {
        const int deg = class_degs[c];
        const int count = class_counts[c];
        if ((int)contrib.size() < deg) contrib.resize(deg);
        for (int chk = 0; chk < count; ++chk) {
          int min1 = kSatVar + 1, min2 = kSatVar + 1, parity = 0;
          for (int j = 0; j < deg; ++j) {
            int vc = sat(v[e[j]] - mg[j], kSatVar);
            contrib[j] = vc;
            int a = minclamp_pre ? abs(sat(vc, kSatMsg)) : abs(vc);
            if (a < min1) {
              min2 = min1;
              min1 = a;
            } else if (a < min2) {
              min2 = a;
            }
            parity ^= (vc > 0) ? 1 : 0;
          }
          int f1, f2;
          f_consts(algo, offset, min1, min2, kSatMsg, nms_f, nms_f2,
                   &f1, &f2);
          for (int j = 0; j < deg; ++j) {
            int vc = contrib[j];
            int a = minclamp_pre ? abs(sat(vc, kSatMsg)) : abs(vc);
            int mag = (a == min1) ? f1 : f2;
            int s = parity ^ ((vc > 0) ? 1 : 0);
            int m = s ? mag : -mag;
            if (minclamp_pre) m = sat(m, kSatMsg);
            mg[j] = m;
            v[e[j]] = sat(vc + m, kSatVar);
          }
          ov_sign |= parity;
          e += deg;
          mg += deg;
        }
      }
      if (early_term && ov_sign == 0) {
        used = it + 1;
        break;
      }
    }
    for (int i = 0; i < n; ++i) out[i] = v[i] > 0 ? 1 : 0;
    if (iters_used) iters_used[f] = used;
  }
}

// Accumulate encoder core (GenericEncoder/staircase semantics,
// GenericEncoder.cpp:38-78): parity accumulation par[pos] ^= info[bit]
// over a flat scatter list, then the running-XOR staircase chain.
// Serves both the DVB table encoder and the H-derived staircase encoder
// (their precomputed scatter pairs have identical structure).
void ldpc_encode_accumulate(const int32_t* scatter_pos,
                            const int32_t* scatter_bit, int64_t n_scatter,
                            const int8_t* info, int frames, int k, int nmk,
                            int8_t* out, int n) {
  std::vector<int8_t> par(nmk);
  for (int f = 0; f < frames; ++f) {
    const int8_t* u = info + (size_t)f * k;
    int8_t* o = out + (size_t)f * n;
    std::fill(par.begin(), par.end(), 0);
    for (int64_t s = 0; s < n_scatter; ++s) {
      par[scatter_pos[s]] ^= u[scatter_bit[s]] & 1;
    }
    int8_t acc = 0;
    for (int i = 0; i < nmk; ++i) {
      acc ^= par[i];
      par[i] = acc;
    }
    for (int i = 0; i < k; ++i) o[i] = u[i] & 1;
    for (int i = 0; i < nmk; ++i) o[k + i] = par[i];
  }
}

// Syndrome check: returns number of frames whose hard bits satisfy H.
int ldpc_syndrome_ok(const int32_t* class_degs, const int32_t* class_counts,
                     int n_classes, const int32_t* edges, const int8_t* bits,
                     int frames, int n, int8_t* ok_out) {
  int n_ok = 0;
  for (int f = 0; f < frames; ++f) {
    const int8_t* b = bits + (size_t)f * n;
    const int32_t* e = edges;
    int ok = 1;
    for (int c = 0; c < n_classes && ok; ++c) {
      const int deg = class_degs[c];
      const int count = class_counts[c];
      for (int chk = 0; chk < count; ++chk) {
        int p = 0;
        for (int j = 0; j < deg; ++j) p ^= b[e[j]] & 1;
        e += deg;
        if (p) {
          ok = 0;
          e += (size_t)(count - chk - 1) * deg;
          break;
        }
      }
    }
    if (ok_out) ok_out[f] = (int8_t)ok;
    n_ok += ok;
  }
  return n_ok;
}

}  // extern "C"
