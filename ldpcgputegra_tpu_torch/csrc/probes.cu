// Probes of the card's ceilings on Hopper (sm_90a): the integer ALU rate on
// the decoder's operation mix, on a clip-accumulate chain and on the same mix
// in packed int8x4, and the device-memory copy rate.
//
// Replaces the TPU kernels ldpcgputegra_tpu/bench/vpu_probe.py::_mix_kernel
// and _peak_kernel (K6, launched there through _probe_fn) and _copy_fn (K7).
// Built with nvcc into a shared library with a plain C interface and called
// through ctypes (ldpcgputegra_tpu_torch/bench/vpu_probe.py), on PyTorch's
// current stream.
//
// K6, mapping: one thread per element of x, CHAINS independent chains per
// thread, each `reps` repetitions long.  CHAINS is a template parameter so
// that the chains live in registers (a runtime count would index a
// per-thread array and send it to local memory); `reps` is a runtime
// argument so that nvcc cannot fold the loop, and every chain feeds the
// output so that none is dropped.  The repetition loop is unrolled UNROLL
// times inside a loop that is not unrolled, so the SASS of one loop body is
// UNROLL repetitions (vpu_probe.py::sass_per_rep reads it).  What bounds it:
// the int32 issue rate (SMs x 64 lanes x clock on the data sheet), if the
// chains give the scheduler enough independent instructions; the probe
// measures what it sustains, which is the point.
//
// The operation counts stay the JAX probe's algorithmic ones (14 for the
// mix, 3 for the peak chain; 4 x 14 for the packed mix), so a rate is in the
// unit of kernels/_lib.py::OPS_PER_EDGE.
//
// K7: `y = x + 1` over int32, one 16-byte load and store a thread over a
// grid that covers the array (which moves more bytes a second than 8 CTAs an
// SM striding over it, PERF.md §6); the thread after the last whole int4
// does the tail (fewer than 4 elements).  Bound by the device-memory rate;
// the +1 keeps it from being a plain copy.
//
// TPU workarounds with no counterpart here: the (8,128)-tiled block shapes
// and vmem_limit_bytes of the mix probe, and the 1 MiB BlockSpec blocks of
// the copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // threads per CTA (mirrored in bench/vpu_probe.py)
constexpr int UNROLL = 4;   // repetitions per loop body (mirrored there too)

__device__ __forceinline__ int clip127(int x) { return min(max(x, -127), 127); }

// One repetition of one chain of the decode mix (vpu_probe.py:88-95):
// sub, clip(2), abs, cmp, xor, max, min, min, cmp, select, add, clip(2).
__device__ __forceinline__ void mix_step(int& v, int& p, int& mn, int m) {
  const int c = clip127(v - m);
  const int a = abs(c);
  p ^= static_cast<int>(c > 0);
  const int mn2 = min(max(a, mn), 31);
  const int mn3 = min(mn2, a);
  const int mag = (a == mn3) ? mn2 : mn3;
  v = clip127(c + mag);
  mn = mn3;
}

// The same 14 operations on four int8 lanes at once, saturating:
// __vsubss4, __vmaxs4/__vmins4 (clip), __vabsss4, __vcmpgts4, xor,
// __vmaxs4, __vmins4, __vmins4, __vcmpeq4, a bitwise select, __vaddss4 and
// __vmaxs4/__vmins4 (clip).  The parity bytes are 0x00 or 0xff.
constexpr unsigned kM127 = 0x81818181u;  // -127 in each byte
constexpr unsigned kP127 = 0x7f7f7f7fu;
constexpr unsigned kP31 = 0x1f1f1f1fu;

__device__ __forceinline__ void mix4_step(unsigned& v, unsigned& p,
                                          unsigned& mn, unsigned m) {
  const unsigned c = __vmins4(__vmaxs4(__vsubss4(v, m), kM127), kP127);
  const unsigned a = __vabsss4(c);
  p ^= __vcmpgts4(c, 0u);
  const unsigned mn2 = __vmins4(__vmaxs4(a, mn), kP31);
  const unsigned mn3 = __vmins4(mn2, a);
  const unsigned eq = __vcmpeq4(a, mn3);
  const unsigned mag = (mn2 & eq) | (mn3 & ~eq);
  v = __vmins4(__vmaxs4(__vaddss4(c, mag), kM127), kP127);
  mn = mn3;
}

template <int CHAINS>
__global__ void __launch_bounds__(BLOCK)
probe_mix_kernel(const int* __restrict__ x, int* __restrict__ out, int n,
                 int reps) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int x0 = x[i];
  int v[CHAINS], p[CHAINS], mn[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    v[c] = x0 + c;
    p[c] = 0;
    mn[c] = 128;
  }
  int r = 0;
#pragma unroll 1
  for (; r + UNROLL <= reps; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) mix_step(v[c], p[c], mn[c], 3 + c);
    }
  }
#pragma unroll 1
  for (; r < reps; ++r) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mix_step(v[c], p[c], mn[c], 3 + c);
  }
  int acc = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc = acc + v[c] + p[c] + mn[c];
  out[i] = acc;
}

template <int CHAINS>
__global__ void __launch_bounds__(BLOCK)
probe_mix4_kernel(const int* __restrict__ x, int* __restrict__ out, int n,
                  int reps) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const unsigned x0 = static_cast<unsigned>(x[i]);
  unsigned v[CHAINS], p[CHAINS], mn[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    v[c] = __vaddss4(x0, 0x01010101u * c);
    p[c] = 0u;
    mn[c] = kP127;
  }
  int r = 0;
#pragma unroll 1
  for (; r + UNROLL <= reps; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
        mix4_step(v[c], p[c], mn[c], 0x01010101u * (3 + c));
    }
  }
#pragma unroll 1
  for (; r < reps; ++r) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      mix4_step(v[c], p[c], mn[c], 0x01010101u * (3 + c));
  }
  unsigned acc = 0u;  // the packed words summed as 32-bit integers
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc = acc + v[c] + p[c] + mn[c];
  out[i] = static_cast<int>(acc);
}

// CHAINS independent clip-accumulate chains (vpu_probe.py:44-64): add,
// max, min per repetition; the output is the sum of the accumulators.
template <int CHAINS>
__global__ void __launch_bounds__(BLOCK)
probe_peak_kernel(const int* __restrict__ x, int* __restrict__ out, int n,
                  int reps) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int x0 = x[i];
  int a[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) a[c] = x0 + c;
  int r = 0;
#pragma unroll 1
  for (; r + UNROLL <= reps; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) a[c] = clip127(a[c] + 3);
    }
  }
#pragma unroll 1
  for (; r < reps; ++r) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) a[c] = clip127(a[c] + 3);
  }
  int acc = a[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) acc = acc + a[c];
  out[i] = acc;
}

__global__ void __launch_bounds__(BLOCK)
probe_copy_kernel(const int* __restrict__ x, int* __restrict__ y, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const size_t n4 = n / 4;
  if (i < n4) {
    int4 w = reinterpret_cast<const int4*>(x)[i];
    w.x += 1;
    w.y += 1;
    w.z += 1;
    w.w += 1;
    reinterpret_cast<int4*>(y)[i] = w;
  } else if (i == n4) {
    for (size_t j = 4 * n4; j < n; ++j) y[j] = x[j] + 1;
  }
}

template <int C>
cudaError_t launch_mix(const int* x, int* out, int n, int reps, int packed,
                       cudaStream_t st) {
  const int grid = (n + BLOCK - 1) / BLOCK;
  if (packed)
    probe_mix4_kernel<C><<<grid, BLOCK, 0, st>>>(x, out, n, reps);
  else
    probe_mix_kernel<C><<<grid, BLOCK, 0, st>>>(x, out, n, reps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_peak(const int* x, int* out, int n, int reps,
                        cudaStream_t st) {
  probe_peak_kernel<C><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, st>>>(x, out, n,
                                                                   reps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of the mix probe (packed: the int8x4 form) over n elements, on
// `stream`; chains is 1, 2, 4, 8 or 16.  Returns a cudaError_t (0 on
// success).
int probe_mix_launch(const void* x, void* out, int n, int chains, int reps,
                     int packed, void* stream) {
  if (n <= 0 || reps < 0) return cudaErrorInvalidValue;
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return launch_mix<1>(xi, o, n, reps, packed, st);
    case 2: return launch_mix<2>(xi, o, n, reps, packed, st);
    case 4: return launch_mix<4>(xi, o, n, reps, packed, st);
    case 8: return launch_mix<8>(xi, o, n, reps, packed, st);
    case 16: return launch_mix<16>(xi, o, n, reps, packed, st);
    default: return cudaErrorInvalidValue;
  }
}

// One launch of the peak probe; chains is 1, 2, 4, 8, 16 or 32.
int probe_peak_launch(const void* x, void* out, int n, int chains, int reps,
                      void* stream) {
  if (n <= 0 || reps < 0) return cudaErrorInvalidValue;
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return launch_peak<1>(xi, o, n, reps, st);
    case 2: return launch_peak<2>(xi, o, n, reps, st);
    case 4: return launch_peak<4>(xi, o, n, reps, st);
    case 8: return launch_peak<8>(xi, o, n, reps, st);
    case 16: return launch_peak<16>(xi, o, n, reps, st);
    case 32: return launch_peak<32>(xi, o, n, reps, st);
    default: return cudaErrorInvalidValue;
  }
}

// y = x + 1 over n int32 elements, one int4 a thread; x and y 16-byte
// aligned.
int probe_copy_launch(const void* x, void* y, long long n, void* stream) {
  const long long grid = ((n + 3) / 4 + BLOCK - 1) / BLOCK;  // ceil(n / 4)
  if (n <= 0 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  probe_copy_kernel<<<static_cast<unsigned>(grid), BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(y),
      static_cast<size_t>(n));
  return cudaGetLastError();
}

const char* probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
