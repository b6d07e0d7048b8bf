// Layered min-sum decoding of QC-LDPC codes on Hopper (sm_90a).
//
// Replaces the TPU kernel ldpcgputegra_tpu/kernels/pallas_layered.py::
// _build_kernel: a whole layered decode, all iterations and all block-rows,
// in one launch.  Built with nvcc into a shared library with a plain C
// interface and called through ctypes (ldpcgputegra_tpu_torch/kernels/
// layered.py), on PyTorch's current stream.
//
// Mapping: one CTA decodes a tile of TB = 32 codewords.  threadIdx.x is the
// codeword in the tile (one warp spans the tile), threadIdx.y walks the Z
// checks of a block-row (check z = ty, ty + TY, ...).  The checks of one
// block-row touch pairwise-disjoint VNs, so they run in parallel with a
// result bit-identical to the reference's sequential check loop; a
// __syncthreads() separates block-rows.
//
// Memory: the tile's APP array lives in shared memory, [N][TB] int8
// (2304 x 32 = 72 KB at 2304x1152).  The c2v messages live in global
// memory, [E][B] int8 with E = sum over block-rows of Z * deg (check-major
// edge slots, the reference's order), codeword fastest, so a warp's load of
// one edge slot is 32 contiguous bytes.  Iteration 0 reads no messages (they
// start at zero), so the buffer needs no clearing.
//
// What bounds it: each edge of each codeword costs one int8 message read
// and one write in global memory per iteration (2 bytes), plus ~20 integer
// operations; the APP reads and writes stay in shared memory.  At the
// bench shape (2304x1152, B = 8192) the messages are 60 MB, more than the
// 50 MB L2, so the message stream goes to HBM.
//
// Early termination: a codeword's test is the on-the-fly parity of its
// contributions, ORed over all checks of one iteration.  A codeword whose
// parity is all zero is frozen (no further APP or message writes), so its
// output is its hard decision at the end of that iteration.  The CTA leaves
// the iteration loop once all of its codewords are frozen; iters_used is the
// max over CTAs of the iterations run, by atomicMax into one int32.
//
// TPU workarounds that have no counterpart here: the int32 APP kept for
// sublane rolls, the Zp padding and _roll_mod (an odd Z is a plain mod-Z
// index), the 128-lane batch padding (a ragged B masks its last tile), the
// VMEM tile pick, and the SMEM iteration cell accumulated over grid steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minsum_common.cuh"

namespace {

using namespace minsum;

constexpr int TB = 32;       // codewords per CTA (mirrored in kernels/layered.py)
constexpr int TY = 16;       // check lanes per CTA
constexpr int MAX_DEG = 32;  // largest check degree (mirrored in kernels/layered.py)

struct Params {
  const int8_t* llr;     // [B, N] frame-major
  uint8_t* bits;         // [B, N] frame-major
  int8_t* msgs;          // [E, B]
  int* iters_out;        // scalar, zeroed before the launch
  const int* row_ptr;    // [L + 1] block-row edge ranges into cols/shifts
  const int* cols;       // [n_edges] block-column of each block edge
  const int* shifts;     // [n_edges] cyclic shift of each block edge
  int n_layers, n_edges, N, Z, B, iters, early_term;
  CnSpec cn;
};

__host__ __device__ inline size_t app_bytes(int N) {
  return (static_cast<size_t>(N) * TB + 15) & ~static_cast<size_t>(15);
}

__host__ inline size_t smem_bytes(int N, int n_edges, int n_layers) {
  return app_bytes(N) + sizeof(int) * (2 * n_edges + n_layers + 1 + TB);
}

__global__ void __launch_bounds__(TB * TY)
layered_minsum_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* app = reinterpret_cast<int8_t*>(smem);                 // [N][TB]
  int* s_vn0 = reinterpret_cast<int*>(smem + app_bytes(p.N));    // cols * Z
  int* s_shift = s_vn0 + p.n_edges;
  int* s_row = s_shift + p.n_edges;                              // [L + 1]
  int* s_unsat = s_row + p.n_layers + 1;                         // [TB]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TB + tx, nthreads = TB * TY;
  const int tile0 = blockIdx.x * TB;
  const int nb = min(TB, p.B - tile0);  // codewords in this tile
  const int b = tile0 + tx;
  const int N = p.N, Z = p.Z, B = p.B;
  const CnSpec cn = p.cn;
  const int sv = cn.sat_var;

  for (int i = tid; i < p.n_edges; i += nthreads) {
    s_vn0[i] = p.cols[i] * Z;
    s_shift[i] = p.shifts[i];
  }
  for (int i = tid; i <= p.n_layers; i += nthreads) s_row[i] = p.row_ptr[i];
  // frame-major LLRs -> node-major APP tile; consecutive threads read
  // consecutive bytes of one frame
  for (int i = tid; i < nb * N; i += nthreads) {
    const int bl = i / N, n = i - bl * N;
    app[n * TB + bl] = p.llr[static_cast<size_t>(tile0 + bl) * N + n];
  }
  __syncthreads();

  bool active = tx < nb;
  int iters_run = 0;
  for (int it = 0; it < p.iters; ++it) {
    if (p.early_term) {
      if (!__syncthreads_or(active)) break;  // the whole tile converged
      if (ty == 0) s_unsat[tx] = 0;  // visible after the first block-row's barrier
    }
    iters_run = it + 1;
    int unsat = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      const int e0 = s_row[l], deg = s_row[l + 1] - e0;
      const size_t slot0 = static_cast<size_t>(Z) * e0;
      if (active) {
        for (int z = ty; z < Z; z += TY) {
          int8_t* mrow = p.msgs + (slot0 + static_cast<size_t>(z) * deg) * B + b;
          int c[MAX_DEG];
          int min1 = 0, min2 = sv + 1, parity = 0;
          for (int j = 0; j < deg; ++j) {
            int r = s_shift[e0 + j] + z;
            r -= (r >= Z) ? Z : 0;
            const int vn = s_vn0[e0 + j] + r;
            const int m = it ? static_cast<int>(mrow[static_cast<size_t>(j) * B]) : 0;
            const int cj = clampi(static_cast<int>(app[vn * TB + tx]) - m, sv);
            c[j] = cj;
            two_min(j, cn_abs(cj, cn), min1, min2);
            parity ^= (cj > 0);
          }
          int f1, f2;
          cn_f(min1, min2, cn, f1, f2);
          for (int j = 0; j < deg; ++j) {
            int r = s_shift[e0 + j] + z;
            r -= (r >= Z) ? Z : 0;
            const int vn = s_vn0[e0 + j] + r;
            const int m = cn_msg(c[j], parity, min1, f1, f2, cn);
            mrow[static_cast<size_t>(j) * B] = static_cast<int8_t>(m);
            app[vn * TB + tx] = static_cast<int8_t>(clampi(c[j] + m, sv));
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
  for (int i = tid; i < nb * N; i += nthreads) {
    const int bl = i / N, n = i - bl * N;
    p.bits[static_cast<size_t>(tile0 + bl) * N + n] = app[n * TB + bl] > 0;
  }
}

}  // namespace

extern "C" {

// Launch one decode on `stream`; returns a cudaError_t (0 on success).
int layered_minsum_launch(const void* llr, void* bits, void* msgs,
                          void* iters_out, const void* row_ptr,
                          const void* cols, const void* shifts, int n_layers,
                          int n_edges, int N, int Z, int B, int algo,
                          int minclamp_pre, int iters, int early_term,
                          int offset, int nms_f, int nms_f2, int sat_var,
                          int sat_msg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const int8_t*>(llr), static_cast<uint8_t*>(bits),
           static_cast<int8_t*>(msgs), static_cast<int*>(iters_out),
           static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
           static_cast<const int*>(shifts), n_layers, n_edges, N, Z, B,
           iters, early_term,
           CnSpec{algo, minclamp_pre, offset, nms_f, nms_f2, sat_var, sat_msg}};
  if (B <= 0 || N <= 0 || Z <= 0 || n_layers <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, n_edges, n_layers);
  cudaError_t err = cudaFuncSetAttribute(
      layered_minsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(iters_out, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + TB - 1) / TB), block(TB, TY);
  layered_minsum_kernel<<<grid, block, smem, st>>>(p);
  return cudaGetLastError();
}

const char* layered_minsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
