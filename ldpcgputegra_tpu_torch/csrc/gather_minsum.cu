// Layered min-sum decoding over arbitrary conflict-free layers on Hopper
// (sm_90a): the non-QC ("gather") path.
//
// Replaces the three TPU kernels of ldpcgputegra_tpu/kernels/pallas_gather.py
// that compute the same thing: _build_kernel (unrolled gathers),
// _build_chunked_kernel (the same, looped over check chunks with the VN
// index table streamed into SMEM) and _build_streamed_chunked_kernel (the
// same, with the messages streamed through HBM).  Those differ only in TPU
// workarounds (Mosaic compile size, VMEM size, VREG tiling); one kernel that
// reads a per-edge VN index table covers all three.  Built with nvcc into a
// shared library with a plain C interface and called through ctypes
// (ldpcgputegra_tpu_torch/kernels/gather.py), on PyTorch's current stream.
//
// Mapping: one CTA of 512 threads decodes a tile of TB codewords (TB = 32,
// 16 or 8, a template parameter).  Thread t works on codeword t % TB of the
// tile and on checks t / TB, t / TB + 512 / TB, ... of the current layer.
// The checks of one layer touch pairwise-disjoint VNs, so they run in
// parallel with a result bit-identical to the reference's sequential check
// loop; a __syncthreads() separates layers.  Layers may differ in degree
// (irregular codes); the per-check contribution array is unrolled to DMAX
// (8, 16 or 32, a template parameter) so that it stays in registers.  DMAX
// is the smallest that holds the code's degrees: a single DMAX = 32 needs
// 128 registers a thread against 64 at DMAX = 8, one CTA per SM instead of
// two, and ran 1.4-2.9x slower on the H100 (PERF.md).
//
// The wrapper picks TB (kernels/gather.py::pick_tile): the kernel is bound
// by latency, each lane walking its checks of a layer one after the other,
// so the narrowest tile (the most lanes) wins until the lanes outnumber the
// layer's checks.
//
// Memory: the tile's APP array lives in shared memory, [N][TB] int8, within
// the 227 KB a block can use: TB = 32 up to N = 7260, 16 up to 14524, 8 up
// to 29052 (20000x10000 at TB = 8: 160 000 B).  The VN index table
// (one uint16 per edge, deg-major within a layer: 24 KB at 4000x2000,
// 120 KB at 20000x10000) is read through the read-only cache, so it needs
// no room beside the APP tile.  The c2v messages live in global memory,
// [tile][E][TB] int8 with E edge slots in the same deg-major order, so the
// 512 / TB checks and TB codewords of one warp-wide access are 32 contiguous
// bytes.  Iteration 0 reads no messages (they start at zero), so the buffer
// needs no clearing.
//
// What bounds it: each edge of each codeword costs one int8 message read
// and one write in global memory per iteration (2 bytes), one index read
// shared by the TB codewords of a warp, two shared-memory APP accesses and
// ~20 integer operations.
//
// Early termination: as in layered_minsum.cu, a codeword whose on-the-fly
// parity is zero over a whole iteration is frozen, so its output is its
// hard decision at the end of that iteration (the TPU kernels' snapshot);
// the CTA leaves once all of its codewords are frozen, and iters_used is
// the max over CTAs of the iterations run (atomicMax into one int32).
//
// TPU workarounds that have no counterpart here: the int32 [N, 8, 128] APP,
// sublane widths 8/4/2, fori_loop chunking and the SMEM index DMA groups,
// the win/io/stream io modes, 4-row message alignment, and the 1024-codeword
// batch padding (a ragged B masks its last tile).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minsum_common.cuh"

namespace {

using namespace minsum;

constexpr int NTHREADS = 512;  // threads per CTA

struct Params {
  const int8_t* llr;      // [B, N] frame-major
  uint8_t* bits;          // [B, N] frame-major
  int8_t* msgs;           // [ceil(B / TB)][E][TB]
  int* iters_out;         // scalar, zeroed before the launch
  const int* row_ptr;     // [L + 1] first edge slot of each layer
  const int* n_checks;    // [L] checks of each layer
  const int* deg;         // [L] degree of each layer
  const uint16_t* vn;     // [E] VN of each edge slot; slot row_ptr[l] + j*G + g
  int n_layers, n_edges, N, B, iters, early_term;
  CnSpec cn;
};

__host__ __device__ inline size_t app_bytes(int N, int tb) {
  return (static_cast<size_t>(N) * tb + 15) & ~static_cast<size_t>(15);
}

// mirrored in kernels/gather.py::smem_bytes
__host__ inline size_t smem_bytes(int N, int tb) {
  return app_bytes(N, tb) + sizeof(int) * tb;
}

template <int TB, int DMAX>
__global__ void __launch_bounds__(NTHREADS) gather_minsum_kernel(Params p) {
  constexpr int TY = NTHREADS / TB;  // check lanes
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* app = reinterpret_cast<int8_t*>(smem);                    // [N][TB]
  int* s_unsat = reinterpret_cast<int*>(smem + app_bytes(p.N, TB));  // [TB]

  const int tid = threadIdx.x, tx = tid % TB, ty = tid / TB;
  const int tile0 = blockIdx.x * TB;
  const int nb = min(TB, p.B - tile0);  // codewords in this tile
  const int N = p.N;
  const CnSpec cn = p.cn;
  const int sv = cn.sat_var;
  int8_t* mtile = p.msgs + static_cast<size_t>(blockIdx.x) * p.n_edges * TB + tx;

  // frame-major LLRs -> node-major APP tile; consecutive threads read
  // consecutive bytes of one frame
  for (int i = tid; i < nb * N; i += NTHREADS) {
    const int bl = i / N, n = i - bl * N;
    app[n * TB + bl] = p.llr[static_cast<size_t>(tile0 + bl) * N + n];
  }
  __syncthreads();

  bool active = tx < nb;
  int iters_run = 0;
  for (int it = 0; it < p.iters; ++it) {
    if (p.early_term) {
      if (!__syncthreads_or(active)) break;  // the whole tile converged
      if (ty == 0) s_unsat[tx] = 0;  // visible after the first layer's barrier
    }
    iters_run = it + 1;
    int unsat = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      const int e0 = __ldg(p.row_ptr + l);
      const int G = __ldg(p.n_checks + l), deg = __ldg(p.deg + l);
      if (active) {
        for (int g = ty; g < G; g += TY) {
          int c[DMAX];
          int min1 = 0, min2 = sv + 1, parity = 0;
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
              const int slot = e0 + j * G + g;
              const int v = __ldg(p.vn + slot);
              const int m = it ? static_cast<int>(mtile[slot * TB]) : 0;
              const int cj = clampi(static_cast<int>(app[v * TB + tx]) - m, sv);
              c[j] = cj;
              two_min(j, cn_abs(cj, cn), min1, min2);
              parity ^= (cj > 0);
            }
          }
          int f1, f2;
          cn_f(min1, min2, cn, f1, f2);
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
              const int slot = e0 + j * G + g;
              const int v = __ldg(p.vn + slot);
              const int m = cn_msg(c[j], parity, min1, f1, f2, cn);
              mtile[slot * TB] = static_cast<int8_t>(m);
              app[v * TB + tx] = static_cast<int8_t>(clampi(c[j] + m, sv));
            }
          }
          unsat |= parity;
        }
      }
      __syncthreads();
    }
    if (p.early_term) {
      if (active && unsat) s_unsat[tx] = 1;
      __syncthreads();
      if (active && s_unsat[tx] == 0) active = false;  // converged: freeze
    }
  }
  __syncthreads();
  if (tid == 0) atomicMax(p.iters_out, iters_run);
  for (int i = tid; i < nb * N; i += NTHREADS) {
    const int bl = i / N, n = i - bl * N;
    p.bits[static_cast<size_t>(tile0 + bl) * N + n] = app[n * TB + bl] > 0;
  }
}

template <int TB, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = smem_bytes(p.N, TB);
  cudaError_t err = cudaFuncSetAttribute(
      gather_minsum_kernel<TB, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + TB - 1) / TB), block(NTHREADS);
  gather_minsum_kernel<TB, DMAX><<<grid, block, smem, st>>>(p);
  return cudaGetLastError();
}

template <int TB>
cudaError_t launch_tile(const Params& p, int dmax, cudaStream_t st) {
  switch (dmax) {
    case 8: return launch<TB, 8>(p, st);
    case 16: return launch<TB, 16>(p, st);
    case 32: return launch<TB, 32>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch one decode on `stream` with a tile of `tile` codewords per CTA and
// contribution arrays of `dmax` (>= every layer's degree); returns a
// cudaError_t (0 on success).
int gather_minsum_launch(const void* llr, void* bits, void* msgs,
                         void* iters_out, const void* row_ptr,
                         const void* n_checks, const void* deg, const void* vn,
                         int n_layers, int n_edges, int N, int B, int tile,
                         int dmax, int algo, int minclamp_pre, int iters,
                         int early_term, int offset, int nms_f, int nms_f2,
                         int sat_var, int sat_msg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const int8_t*>(llr), static_cast<uint8_t*>(bits),
           static_cast<int8_t*>(msgs), static_cast<int*>(iters_out),
           static_cast<const int*>(row_ptr), static_cast<const int*>(n_checks),
           static_cast<const int*>(deg), static_cast<const uint16_t*>(vn),
           n_layers, n_edges, N, B, iters, early_term,
           CnSpec{algo, minclamp_pre, offset, nms_f, nms_f2, sat_var, sat_msg}};
  if (B <= 0 || N <= 0 || N > 65535 || n_layers <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(iters_out, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 32: return launch_tile<32>(p, dmax, st);
    case 16: return launch_tile<16>(p, dmax, st);
    case 8: return launch_tile<8>(p, dmax, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* gather_minsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
