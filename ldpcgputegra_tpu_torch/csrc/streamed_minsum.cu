// Layered min-sum decoding of codes whose APP array does not fit shared
// memory, on Hopper (sm_90a): the DVB-S2 path (the Z=360 QC views of the
// staircase codes, 16200 and 64800 bits) and synthqc-256x128x6-z1024
// (262144 bits).
//
// Replaces ldpcgputegra_tpu/kernels/pallas_streamed.py::_build_streamed_kernel
// (K2): a whole layered decode in one launch, all iterations and all layers,
// with the four algorithms, minclamp pre and post, deficient circulants,
// sub-pass layers, col_perm views and early termination.  K2 keeps the APP
// on chip and streams the messages through HBM with a two-slot DMA pipeline,
// an in-kernel batch-tile loop, int32 rolls of one slab at a time and
// 128-lane batch padding: TPU workarounds with no counterpart here.  Built
// with nvcc into a shared library with a plain C interface and called
// through ctypes (ldpcgputegra_tpu_torch/kernels/streamed.py), on PyTorch's
// current stream.
//
// Why the APP leaves shared memory: a block can use 227 KB, and one
// codeword's APP is 15.8 KB at 16200, 63.3 KB at 64800 and 256 KB at
// synthqc, so the tiles of the other two kernels (32 or 8 codewords) do not
// fit.  Here the APP is a scratch buffer in device memory that the wrapper
// allocates, [ceil(B / TB)][N][TB] int8 with the codeword fastest (33 MB at
// 64800 and B = 512, under the 50 MB L2).  It is written during the launch,
// so it is read through a plain pointer, never __ldg or a const __restrict__
// one (the non-coherent path could return stale bytes).  One CTA owns its
// codewords' APP, so a __syncthreads() between layers is all the layered
// order needs: it makes the CTA's global writes visible to the CTA.
//
// Mapping (the gather kernel's, gather_minsum.cu): one CTA of 512 threads
// decodes a tile of TB codewords (a template parameter); thread t works on
// codeword t % TB and on checks t / TB, t / TB + 512 / TB, ... of the
// current layer, walking per-edge tables (codes/convert.py::edge_tables,
// int32 VN ids): a sub-pass layer is just its committed checks, and the
// deficient-circulant edge is a VN id of -1 whose contribution is -sat_var
// and which writes nothing, so there is no QC special case, and any
// conflict-free layers decode.  The checks of a layer touch
// pairwise-disjoint VNs, so they run in parallel with a result
// bit-identical to the reference's sequential check loop.  The VN ids of a
// QC block-row are consecutive in z, so there the 512 / TB checks and TB
// codewords of one warp-wide APP or message access are 32 contiguous bytes.
// The contribution array is unrolled to DMAX (8, 16 or 32, a template
// parameter), the smallest that holds the code's degrees (30 at
// 64800x6480-dvbs2).
//
// col_perm is applied here, as the LLRs are loaded and the bits stored
// (app[n] = llr[perm[n]], bits[perm[n]] = app[n] > 0), so the view costs no
// extra pass over the batch.
//
// What bounds it: each edge of each codeword costs the 21 integer operations
// of a min-sum edge update (kernels/_lib.py::OPS_PER_EDGE), an int8 APP read
// and write and an int8 message read and write in device memory per
// iteration.  At 64800x32400, B = 512, 10 iterations that is 1.16e9 edge
// updates, 1.5 ms of int32 issue on the H100 against 0.02 ms for the LLRs
// and bits.  In practice each lane waits on device memory for every check
// it walks, one after the other (PERF.md), so the design issues all of a
// check's loads before it uses any, and the tile (kernels/streamed.py::
// pick_tile) is the narrowest whose CTAs all fit the card at once: the most
// check lanes.
//
// Offsets: a CTA's APP and message base pointers are size_t (E x B reaches
// 8e8 at 64800x6480-dvbs2, B = 4096); offsets inside one tile are int, and
// the launch refuses n_edges * tile or N * tile of 2^31 or more.
//
// Early termination: as in the other two kernels, a codeword whose parity is
// zero over a whole iteration is frozen (K2's snapshot: same bits), the CTA
// leaves once all of its codewords are frozen, and iters_used is the max
// over CTAs of the iterations run (atomicMax into one int32, zeroed here
// before the launch).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minsum_common.cuh"

namespace {

using namespace minsum;

constexpr int NTHREADS = 512;  // threads per CTA

struct Params {
  const int8_t* llr;   // [B, N] frame-major
  uint8_t* bits;       // [B, N] frame-major
  int8_t* app;         // [ceil(B / TB)][N][TB] scratch, written in the launch
  int8_t* msgs;        // [ceil(B / TB)][E][TB] scratch
  int* iters_out;      // scalar
  const int* row_ptr;  // [L + 1] first edge slot of each layer
  const int* n_checks; // [L] committed checks of each layer
  const int* deg;      // [L] degree of each layer
  const int* vn;       // [E] VN of each slot (-1: pinned); row_ptr[l] + j*G + g
  const int* perm;     // [N] view column -> base column, or null
  int n_layers, N, B, iters, early_term;
  size_t n_edges;
  CnSpec cn;
};

// at DMAX = 8 two CTAs share an SM (64 registers a thread; pick_tile counts
// on it)
template <int TB, int DMAX>
__global__ void __launch_bounds__(NTHREADS, DMAX == 8 ? 2 : 1)
    streamed_minsum_kernel(Params p) {
  constexpr int TY = NTHREADS / TB;  // check lanes
  __shared__ int s_unsat[TB];

  const int tid = threadIdx.x, tx = tid % TB, ty = tid / TB;
  const int tile0 = blockIdx.x * TB;
  const int nb = min(TB, p.B - tile0);  // codewords in this tile
  const int N = p.N;
  const CnSpec cn = p.cn;
  const int sv = cn.sat_var;
  // this CTA's APP and messages; offsets within them fit an int (checked
  // at launch)
  int8_t* app = p.app + static_cast<size_t>(blockIdx.x) * N * TB;
  int8_t* at = app + tx;
  int8_t* mt = p.msgs + static_cast<size_t>(blockIdx.x) * p.n_edges * TB + tx;

  // frame-major LLRs -> node-major APP; consecutive threads read
  // consecutive view columns of one frame
  for (int i = tid; i < nb * N; i += NTHREADS) {
    const int bl = i / N, n = i - bl * N;
    const int src = p.perm ? __ldg(p.perm + n) : n;
    app[n * TB + bl] = p.llr[static_cast<size_t>(tile0 + bl) * N + src];
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
          // Every load of a check is issued before any is used: the VN ids
          // and messages, then the APP bytes, in loops of loads alone.  A
          // load whose value a branch or a later address needs stalls the
          // warp until it lands, so loads mixed with their uses cost a
          // memory round trip per edge; here a check waits for two.  A
          // pinned edge (v < 0) reads VN 0 and its message slot and uses
          // neither: its contribution is -sat_var.
          int v[DMAX], a[DMAX], c[DMAX];
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
              const int slot = e0 + j * G + g;
              v[j] = __ldg(p.vn + slot);
              c[j] = it ? mt[slot * TB] : 0;
            }
          }
#pragma unroll
          for (int j = 0; j < DMAX; ++j)
            if (j < deg) a[j] = at[max(v[j], 0) * TB];
          int min1 = 0, min2 = sv + 1, parity = 0;
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
              c[j] = v[j] < 0 ? -sv : clampi(a[j] - c[j], sv);
              two_min(j, cn_abs(c[j], cn), min1, min2);
              parity ^= (c[j] > 0);
            }
          }
          int f1, f2;
          cn_f(min1, min2, cn, f1, f2);
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg && v[j] >= 0) {
              const int m = cn_msg(c[j], parity, min1, f1, f2, cn);
              mt[(e0 + j * G + g) * TB] = static_cast<int8_t>(m);
              at[v[j] * TB] = static_cast<int8_t>(clampi(c[j] + m, sv));
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
    const int dst = p.perm ? __ldg(p.perm + n) : n;
    p.bits[static_cast<size_t>(tile0 + bl) * N + dst] = app[n * TB + bl] > 0;
  }
}

template <int TB, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const dim3 grid((p.B + TB - 1) / TB), block(NTHREADS);
  streamed_minsum_kernel<TB, DMAX><<<grid, block, 0, st>>>(p);
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
// contribution arrays of `dmax` (>= every layer's degree); `app` and `msgs`
// are scratch of ceil(B / tile) * N * tile and ceil(B / tile) * n_edges *
// tile bytes; `perm` may be null.  Returns a cudaError_t (0 on success).
int streamed_minsum_launch(const void* llr, void* bits, void* app, void* msgs,
                           void* iters_out, const void* row_ptr,
                           const void* n_checks, const void* deg,
                           const void* vn, const void* perm, int n_layers,
                           long long n_edges, int N, int B, int tile, int dmax,
                           int algo, int minclamp_pre, int iters, int early_term,
                           int offset, int nms_f, int nms_f2, int sat_var,
                           int sat_msg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const int8_t*>(llr), static_cast<uint8_t*>(bits),
           static_cast<int8_t*>(app), static_cast<int8_t*>(msgs),
           static_cast<int*>(iters_out), static_cast<const int*>(row_ptr),
           static_cast<const int*>(n_checks), static_cast<const int*>(deg),
           static_cast<const int*>(vn), static_cast<const int*>(perm),
           n_layers, N, B, iters, early_term, static_cast<size_t>(n_edges),
           CnSpec{algo, minclamp_pre, offset, nms_f, nms_f2, sat_var, sat_msg}};
  if (B <= 0 || N <= 0 || n_layers <= 0 || n_edges <= 0 ||
      n_edges * tile >= (1LL << 31) ||
      static_cast<long long>(N) * tile >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(iters_out, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 32: return launch_tile<32>(p, dmax, st);
    case 16: return launch_tile<16>(p, dmax, st);
    case 8: return launch_tile<8>(p, dmax, st);
    case 4: return launch_tile<4>(p, dmax, st);
    case 2: return launch_tile<2>(p, dmax, st);
    case 1: return launch_tile<1>(p, dmax, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* streamed_minsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
