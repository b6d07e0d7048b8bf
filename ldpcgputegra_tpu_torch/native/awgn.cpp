// Counter-based AWGN + BPSK/QPSK + int8 quantization, vectorizable and
// OpenMP-parallel: the native counterpart of the reference's MKL AWGN
// generator (C2, ``code/x86/CChanel/*MKL*``) for this framework's native
// Monte-Carlo path.
//
// Generator: Philox4x32-10 (counter-based like the JAX channel's
// threefry, so every sample is a pure function of (seed, stream, frame,
// position) — deterministic, seekable, order-independent).  The STREAM
// differs from the JAX channel's threefry stream; the two channels are
// statistically identical (same N(tx, sigma^2) + identical trunc-quantize
// semantics; the port's copy of ldpcgputegra_tpu/native/awgn.cpp is held
// byte for byte against the JAX package's build by tests/test_torch_native.py),
// so points measured with either channel estimate the same FER/BER.
//
// Quantization matches quant.quantize_llr exactly in semantics:
// q = (int8) clip(factor * y, -sat, +sat)  (C float->int cast truncates
// toward zero, same as XLA's convert).
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline void philox_round(uint32_t c[4], const uint32_t k[2]) {
  const uint64_t p0 = 0xD2511F53ull * c[0];
  const uint64_t p1 = 0xCD9E8D57ull * c[2];
  const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c[1] ^ k[0];
  const uint32_t n1 = (uint32_t)p1;
  const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c[3] ^ k[1];
  const uint32_t n3 = (uint32_t)p0;
  c[0] = n0; c[1] = n1; c[2] = n2; c[3] = n3;
}

// 4 uint32 words from (key=(seed), counter=(stream_lo, stream_hi, frame,
// block)) — Philox4x32-10
inline void philox(uint64_t seed, uint64_t stream, uint32_t frame,
                   uint32_t block, uint32_t out[4]) {
  uint32_t c[4] = {(uint32_t)stream, (uint32_t)(stream >> 32), frame,
                   block};
  uint32_t k[2] = {(uint32_t)seed, (uint32_t)(seed >> 32)};
  for (int r = 0; r < 10; ++r) {
    philox_round(c, k);
    k[0] += 0x9E3779B9u;
    k[1] += 0xBB67AE85u;
  }
  out[0] = c[0]; out[1] = c[1]; out[2] = c[2]; out[3] = c[3];
}

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv32 = 2.3283064365386963e-10f;  // 2^-32

}  // namespace

extern "C" void ldpc_awgn_quantize(
    uint64_t seed, uint64_t stream, const int8_t* coded /*nullable*/,
    int frames, int n, float amp, float sigma, float factor, int sat,
    int8_t* out) {
  const float satf = (float)sat;
  const int n4 = (n + 3) & ~3;  // whole philox blocks
#pragma omp parallel
  {
    std::vector<uint32_t> w((size_t)n4);
    std::vector<float> u1((size_t)n4 / 2), u2((size_t)n4 / 2);
    std::vector<float> rr((size_t)n4 / 2), cc((size_t)n4 / 2),
        ss((size_t)n4 / 2);
    std::vector<float> z((size_t)n4);
#pragma omp for schedule(static)
    for (int f = 0; f < frames; ++f) {
      // pass 1: integer-only philox fill (scalar 64-bit multiplies)
      for (int b0 = 0; b0 < n4; b0 += 4) {
        philox(seed, stream, (uint32_t)f, (uint32_t)(b0 >> 2),
               w.data() + b0);
      }
      // pass 2: Box-Muller with CONTIGUOUS transcendental loops so
      // GCC can use libmvec's vector logf/sinf/cosf (-ffast-math)
      const int n2 = n4 / 2;
      const uint32_t* ww = w.data();
      float* p1 = u1.data();
      float* p2 = u2.data();
      float* pr = rr.data();
      float* pc = cc.data();
      float* ps = ss.data();
      float* zz = z.data();
      for (int h = 0; h < n2; ++h) {
        p1[h] = ((float)ww[2 * h] + 0.5f) * kInv32;
        p2[h] = kTwoPi * (((float)ww[2 * h + 1] + 0.5f) * kInv32);
      }
#pragma omp simd
      for (int h = 0; h < n2; ++h) pr[h] = sqrtf(-2.0f * logf(p1[h]));
#pragma omp simd
      for (int h = 0; h < n2; ++h) pc[h] = cosf(p2[h]);
#pragma omp simd
      for (int h = 0; h < n2; ++h) ps[h] = sinf(p2[h]);
      for (int h = 0; h < n2; ++h) {
        zz[2 * h] = pr[h] * pc[h];
        zz[2 * h + 1] = pr[h] * ps[h];
      }
      // pass 3: modulate + quantize (trunc toward zero, like XLA)
      const int8_t* cw = coded ? coded + (size_t)f * n : nullptr;
      int8_t* o = out + (size_t)f * n;
      if (cw) {
#pragma omp simd
        for (int i = 0; i < n; ++i) {
          const float tx = cw[i] ? amp : -amp;
          float v = factor * (tx + sigma * zz[i]);
          v = v > satf ? satf : (v < -satf ? -satf : v);
          o[i] = (int8_t)v;
        }
      } else {
#pragma omp simd
        for (int i = 0; i < n; ++i) {
          float v = factor * (sigma * zz[i] - amp);
          v = v > satf ? satf : (v < -satf ? -satf : v);
          o[i] = (int8_t)v;
        }
      }
    }
  }
}
