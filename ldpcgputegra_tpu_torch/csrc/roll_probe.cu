// The odd-Z roll probe on Hopper (sm_90a): a chain of dependent cyclic
// rotations of an int32 [Z][256] slab along Z, +1 after each.
//
// Replaces the TPU kernel tools/profile_1944.py::roll_microkernel (K8), which
// timed pltpu.roll (or its slice-and-concatenate form) of one slab at
// Z in {24, 81, 88, 96} to ask whether an odd Z costs the decode kernel
// extra.  On the card the question becomes what the mod-Z index costs: the
// QC kernel (csrc/layered_minsum.cu) indexes VN col * Z + (shift + z) mod Z.
// Built with nvcc into a shared library with a plain C interface and called
// through ctypes (ldpcgputegra_tpu_torch/bench/profile_1944.py).
//
// Mapping: one CTA per slab and one slab per SM, so the probe loads the
// card and not one SM.  The slab lives in shared memory in two buffers
// (2 x Z x 256 x 4 bytes: 196,608 B at Z = 96, above the 48 KB default, so
// the launch sets cudaFuncAttributeMaxDynamicSharedMemorySize).  Thread
// (t, ty) writes dst[z][t] = src[(z - s_k) mod Z][t] + 1 for z = ty, ty + 4,
// ..., then the CTA synchronises and the buffers swap.  The shift list s_k
// is the JAX probe's ((7k) mod Z, or 1 where that is 0), read from shared
// memory.  Two index forms, a template parameter:
//   FORM 0 "wrap": r = z - s; r += (r < 0) ? Z : 0 (the compare-and-correct
//                  index of the QC kernel);
//   FORM 1 "mod":  r = (z - s + Z) % Z, a division by a runtime Z.
// What bounds it: shared-memory bandwidth, 2 x Z x 256 x 4 bytes a roll on
// each SM at 128 bytes a clock.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 256;  // slab width (mirrored in bench/profile_1944.py)
constexpr int TY = 4;    // thread rows a CTA

__host__ __device__ inline size_t roll_smem_bytes(int Z, int n_rolls) {
  return sizeof(int) * (2 * static_cast<size_t>(Z) * TB + n_rolls);
}

template <int FORM>
__global__ void __launch_bounds__(TB * TY)
probe_roll_kernel(const int* __restrict__ x, int* __restrict__ y,
                  const int* __restrict__ shifts, int Z, int n_rolls) {
  extern __shared__ __align__(16) int smem[];
  int* src = smem;                     // [Z][TB]
  int* dst = smem + Z * TB;            // [Z][TB]
  int* s_shift = smem + 2 * Z * TB;    // [n_rolls]
  const int t = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TB + t, nthreads = TB * TY;
  const size_t base = static_cast<size_t>(blockIdx.x) * Z * TB;
  for (int i = tid; i < Z * TB; i += nthreads) src[i] = x[base + i];
  for (int i = tid; i < n_rolls; i += nthreads) s_shift[i] = shifts[i];
  __syncthreads();
  for (int k = 0; k < n_rolls; ++k) {
    const int s = s_shift[k];
    for (int z = ty; z < Z; z += TY) {
      int r;
      if (FORM == 0) {
        r = z - s;
        r += (r < 0) ? Z : 0;
      } else {
        r = (z - s + Z) % Z;
      }
      dst[z * TB + t] = src[r * TB + t] + 1;
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
  for (int i = tid; i < Z * TB; i += nthreads) y[base + i] = src[i];
}

template <int FORM>
cudaError_t launch_roll(const int* x, int* y, const int* shifts, int Z,
                        int n_rolls, int n_slabs, cudaStream_t st) {
  const size_t smem = roll_smem_bytes(Z, n_rolls);
  cudaError_t err = cudaFuncSetAttribute(
      probe_roll_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  probe_roll_kernel<FORM><<<n_slabs, dim3(TB, TY), smem, st>>>(x, y, shifts,
                                                               Z, n_rolls);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// n_rolls rotations of each of n_slabs [Z][256] int32 slabs of x into y,
// with shifts[n_rolls]; form 0 is "wrap", 1 is "mod".  Returns a
// cudaError_t (0 on success).
int probe_roll_launch(const void* x, void* y, const void* shifts, int Z,
                      int n_rolls, int n_slabs, int form, void* stream) {
  if (Z <= 0 || n_rolls < 0 || n_slabs <= 0) return cudaErrorInvalidValue;
  const int* xi = static_cast<const int*>(x);
  int* yo = static_cast<int*>(y);
  const int* sh = static_cast<const int*>(shifts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return launch_roll<0>(xi, yo, sh, Z, n_rolls, n_slabs, st);
    case 1: return launch_roll<1>(xi, yo, sh, Z, n_rolls, n_slabs, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* roll_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
