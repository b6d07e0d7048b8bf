// Layered min-sum decoding of QC-LDPC codes on Hopper (sm_90a).
//
// Replaces the TPU kernel ldpcgputegra_tpu/kernels/pallas_layered.py::
// _build_kernel: a whole layered decode, all iterations and all block-rows,
// in one launch.  Built with nvcc into a shared library with a plain C
// interface and called through ctypes (ldpcgputegra_tpu_torch/kernels/
// layered.py), on PyTorch's current stream.
//
// What bounds it on this card: not the 21 integer operations of an edge
// update, nor the bytes, but the latency of each check lane's accesses.  A
// CTA walks a block-row's Z checks on its check lanes, one round of checks
// after another, and a __syncthreads() ends every block-row; every round
// waits for its message loads to come back from device memory (the
// messages, 2 bytes an edge an iteration, outgrow the 50 MB L2 at large
// batches).  So the time of a decode is about (CTAs an SM) x (rounds a
// block-row) x (one memory round trip), and the design cuts each factor:
//
//  * The tile, TB codewords a CTA (32, 16, 8 or 4, a template parameter), is
//    picked by the wrapper from the batch and the card's SM count
//    (kernels/layered.py::pick_tile): a narrow tile gives more check lanes
//    (512 / TB), so fewer rounds a block-row, and more CTAs to fill the
//    card.  The first port fixed TB = 32: 16 lanes, 6 rounds at Z = 96, and
//    32 CTAs for 132 SMs at a batch of 1024.
//  * All of a check's loads are issued before any is used: its messages,
//    then its APP bytes, each in a loop of loads alone, so a round waits for
//    one memory round trip, not one per edge.
//  * The contributions live in registers: the edge loops are unrolled to
//    DMAX (8, 16 or 32, a template parameter, the smallest that holds the
//    code's degrees), so no array is indexed at run time (no local memory).
//  * The algorithm and the minclamp placement are template parameters (the
//    compile-time forms of minsum_common.cuh), and a library is built for
//    one pair (MINSUM_ALGO, MINSUM_PRE): a round carries that pair's
//    check-node arithmetic alone, with no per-edge select.
//  * The QC structure: a check's VNs are its block-row's columns and
//    shifts, read once per block-row from shared memory, and its lane walks
//    z = ty, ty + lanes, ... with r += lanes; r -= (r >= Z) ? Z : 0, so an
//    address costs an add and a compare; there is no per-edge VN table.
//    Message offsets are 32-bit inside the CTA's own [E][TB] block.
//
// Mapping: one CTA of 512 threads decodes a tile of TB codewords; thread t
// works on column t % (TB / W) of the tile and on checks ty = t / (TB / W),
// ty + lanes, ... of the current block-row.  The checks of one block-row
// touch pairwise-disjoint VNs, so they run in parallel with a result
// bit-identical to the reference's sequential check loop; a __syncthreads()
// separates block-rows.  W is the codewords a thread holds: at DMAX 8 (every
// QC code of the registry) 4, packed in one 32-bit shared-memory and message
// access and unpacked to int32 arithmetic (the same edge update four times
// over, not int8x4 SIMD arithmetic), which cuts the loads, stores and
// addresses of an edge by 4 and ran 1.1-1.35x faster than one codeword a
// thread on the H100 (PERF.md); at DMAX 16 and 32, 1.
//
// Memory: the tile's APP array lives in shared memory, [N][TB] int8.  The
// c2v messages live in device memory, [ceil(B / TB)][E][TB] int8, the
// codeword fastest, with E = Z x (block edges) slots in block-row order and
// degree-major inside a block-row (edge j of check z is slot Z * e0 + j * Z
// + z), so the lanes and codewords of one warp-wide access are contiguous
// bytes.  Iteration 0 reads no messages (they start at zero), so the buffer
// needs no clearing.
//
// Early termination: a codeword's test is the on-the-fly parity of its
// contributions, ORed over all checks of one iteration.  A codeword whose
// parity is all zero is frozen (no further APP writes), so its output is its
// hard decision at the end of that iteration.  The CTA leaves the iteration
// loop once all of its codewords are frozen; iters_used is the max over CTAs
// of the iterations run, by atomicMax into one int32.
//
// The convergence mask (ok, the phase-1 output of two-phase early
// termination, decoder/twophase.py; pallas_layered.py's syndrome_pass): when
// the caller passes an ok array, a CTA walks every block-row once more after
// the iteration loop, each check lane reading its checks' APP words through
// the same r walk as the decode and XORing their hard decisions, and writes
// ok[b] = 1 where codeword b satisfies every check.  About three operations
// an edge, once, against 21 an edge update an iteration.  A runtime branch
// after the loop, not a template parameter: the decode loop's code and the
// number of builds stay as they are.  It does not combine with early
// termination (the launch refuses both), as in the JAX package.
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

constexpr int NTHREADS = 512;  // threads per CTA (mirrored in kernels/layered.py)

struct Params {
  const int8_t* llr;     // [B, N] frame-major
  uint8_t* bits;         // [B, N] frame-major
  int8_t* msgs;          // [ceil(B / TB)][E][TB]
  int* iters_out;        // scalar, zeroed before the launch
  uint8_t* ok;           // [B] 1 where the output satisfies every check; null: none
  const int* row_ptr;    // [L + 1] block-row edge ranges into cols/shifts
  const int* cols;       // [n_edges] block-column of each block edge
  const int* shifts;     // [n_edges] cyclic shift of each block edge
  int n_layers, n_edges, N, Z, B, iters, early_term;
  CnSpec cn;
};

__host__ __device__ inline size_t app_bytes(int N, int tb) {
  return (static_cast<size_t>(N) * tb + 15) & ~static_cast<size_t>(15);
}

// mirrored in kernels/layered.py::smem_bytes
__host__ inline size_t smem_bytes(int N, int n_edges, int n_layers, int tb) {
  return app_bytes(N, tb) + sizeof(int) * (2 * n_edges + n_layers + 1 + tb);
}

// the W bytes of one access: int8_t for W = 1, four packed in a uint32_t
template <int W> struct Word { using T = int8_t; };
template <> struct Word<4> { using T = uint32_t; };

template <int W>
__device__ __forceinline__ int byte_of(typename Word<W>::T w, int k) {
  if constexpr (W == 1) return static_cast<int>(w);
  else return static_cast<int>(static_cast<int8_t>(w >> (8 * k)));
}

// one CTA an SM (up to 128 registers a thread, and no spill: PERF.md has
// each build's count); kernels/layered.py::ctas_per_sm counts on it
template <int TB, int W, int DMAX, int ALGO, bool PRE>
__global__ void __launch_bounds__(NTHREADS, 1)
layered_minsum_kernel(Params p) {
  using T = typename Word<W>::T;
  constexpr int COLS = TB / W;         // threads across the tile
  constexpr int TY = NTHREADS / COLS;  // check lanes
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* app = reinterpret_cast<int8_t*>(smem);                      // [N][TB]
  int* s_vn0 = reinterpret_cast<int*>(smem + app_bytes(p.N, TB));    // cols * Z
  int* s_shift = s_vn0 + p.n_edges;
  int* s_row = s_shift + p.n_edges;                                   // [L + 1]
  int* s_unsat = s_row + p.n_layers + 1;                              // [TB]

  const int tid = threadIdx.x, cx = tid % COLS, ty = tid / COLS;
  const int tile0 = blockIdx.x * TB;
  const int nb = min(TB, p.B - tile0);  // codewords in this tile
  const int N = p.N, Z = p.Z;
  const CnSpec cn = p.cn;
  const int sv = cn.sat_var;
  // this thread's column of the APP tile and of the CTA's message block;
  // offsets inside them fit an int (checked at launch)
  T* at = reinterpret_cast<T*>(app) + cx;
  T* mt = reinterpret_cast<T*>(p.msgs + static_cast<size_t>(blockIdx.x) *
                                            Z * p.n_edges * TB) + cx;

  for (int i = tid; i < p.n_edges; i += NTHREADS) {
    s_vn0[i] = p.cols[i] * Z;
    s_shift[i] = p.shifts[i];
  }
  for (int i = tid; i <= p.n_layers; i += NTHREADS) s_row[i] = p.row_ptr[i];
  // frame-major LLRs -> node-major APP tile; consecutive threads read
  // consecutive bytes of one frame; a ragged tile's missing codewords are 0
  for (int i = tid; i < TB * N; i += NTHREADS) {
    const int bl = i / N, n = i - bl * N;
    app[n * TB + bl] =
        bl < nb ? p.llr[static_cast<size_t>(tile0 + bl) * N + n] : 0;
  }
  __syncthreads();

  // bit k: codeword cx * W + k is in the tile and not yet frozen
  unsigned active = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) active |= (cx * W + k < nb ? 1u : 0u) << k;
  int iters_run = 0;
  for (int it = 0; it < p.iters; ++it) {
    if (p.early_term) {
      if (!__syncthreads_or(active != 0)) break;  // the whole tile converged
      if (tid < TB) s_unsat[tid] = 0;  // visible after the first block-row's barrier
    }
    iters_run = it + 1;
    unsigned unsat = 0;  // bit k: codeword k's parity was not zero
    for (int l = 0; l < p.n_layers; ++l) {
      const int e0 = s_row[l], deg = s_row[l + 1] - e0;
      const int slot0 = Z * e0;
      if (active && ty < Z) {
        // W = 4: the bytes of frozen (or missing) codewords, whose APP a
        // store keeps; their messages are never read again
        uint32_t keep = 0;
#pragma unroll
        for (int k = 0; k < W; ++k)
          keep |= (active >> k & 1u) ? 0u : 0xffu << (8 * k);
        // r[j]: the row of block edge j's circulant that check z reads
        int r[DMAX];
#pragma unroll
        for (int j = 0; j < DMAX; ++j) {
          if (j < deg) {
            r[j] = s_shift[e0 + j] + ty;
            r[j] -= (r[j] >= Z) ? Z : 0;
          }
        }
        for (int z = ty; z < Z; z += TY) {
          // every load of the check first: messages, then APP words
          T mw[DMAX], aw[DMAX];
          int v[DMAX];
#pragma unroll
          for (int j = 0; j < DMAX; ++j)
            if (j < deg) mw[j] = it ? mt[(slot0 + j * Z + z) * COLS] : T(0);
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
              v[j] = (s_vn0[e0 + j] + r[j]) * COLS;
              aw[j] = at[v[j]];
            }
          }
          int c[DMAX][W];
          int min1[W], min2[W], parity[W];
#pragma unroll
          for (int k = 0; k < W; ++k) {
            min1[k] = 0;
            min2[k] = sv + 1;
            parity[k] = 0;
          }
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
#pragma unroll
              for (int k = 0; k < W; ++k) {
                const int cj = clampi(byte_of<W>(aw[j], k) -
                                          byte_of<W>(mw[j], k), sv);
                c[j][k] = cj;
                two_min(j, cn_abs<ALGO, PRE>(cj, cn), min1[k], min2[k]);
                parity[k] ^= (cj > 0);
              }
            }
          }
          int f1[W], f2[W];
#pragma unroll
          for (int k = 0; k < W; ++k)
            cn_f<ALGO, PRE>(min1[k], min2[k], cn, f1[k], f2[k]);
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
              if constexpr (W == 1) {
                const int m = cn_msg<ALGO, PRE>(c[j][0], parity[0], min1[0],
                                                f1[0], f2[0], cn);
                mt[(slot0 + j * Z + z) * COLS] = static_cast<int8_t>(m);
                at[v[j]] = static_cast<int8_t>(clampi(c[j][0] + m, sv));
              } else {
                uint32_t mo = 0, ao = 0;
#pragma unroll
                for (int k = 0; k < W; ++k) {
                  const int m = cn_msg<ALGO, PRE>(c[j][k], parity[k], min1[k],
                                                  f1[k], f2[k], cn);
                  mo |= (static_cast<uint32_t>(m) & 0xffu) << (8 * k);
                  ao |= (static_cast<uint32_t>(clampi(c[j][k] + m, sv)) & 0xffu)
                        << (8 * k);
                }
                mt[(slot0 + j * Z + z) * COLS] = mo;
                at[v[j]] = (ao & ~keep) | (aw[j] & keep);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < W; ++k) unsat |= static_cast<unsigned>(parity[k]) << k;
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < deg) {
              r[j] += TY;
              r[j] -= (r[j] >= Z) ? Z : 0;
            }
          }
        }
      }
      __syncthreads();
    }
    if (p.early_term) {
      unsat &= active;
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (unsat >> k & 1u) s_unsat[cx * W + k] = 1;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < W; ++k)  // converged: freeze
        if ((active >> k & 1u) && s_unsat[cx * W + k] == 0) active &= ~(1u << k);
    }
  }
  __syncthreads();
  if (tid == 0) atomicMax(p.iters_out, iters_run);
  if (p.ok) {
    // the true syndrome of the output: bit k of unsat is codeword cx * W + k
    // with an unsatisfied check among this lane's
    if (tid < TB) s_unsat[tid] = 0;
    unsigned unsat = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      const int e0 = s_row[l], deg = s_row[l + 1] - e0;
      int r[DMAX];
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < deg) {
          r[j] = s_shift[e0 + j] + ty;
          r[j] -= (r[j] >= Z) ? Z : 0;
        }
      }
      for (int z = ty; z < Z; z += TY) {
        T aw[DMAX];
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          if (j < deg) aw[j] = at[(s_vn0[e0 + j] + r[j]) * COLS];
        unsigned parity = 0;  // bit k: this check's parity in codeword k
#pragma unroll
        for (int j = 0; j < DMAX; ++j) {
          if (j < deg) {
#pragma unroll
            for (int k = 0; k < W; ++k)
              parity ^= static_cast<unsigned>(byte_of<W>(aw[j], k) > 0) << k;
            r[j] += TY;
            r[j] -= (r[j] >= Z) ? Z : 0;
          }
        }
        unsat |= parity;
      }
    }
    __syncthreads();  // the zeroed flags are visible
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (unsat >> k & 1u) s_unsat[cx * W + k] = 1;
    __syncthreads();
    if (tid < nb) p.ok[tile0 + tid] = s_unsat[tid] == 0;
  }
  for (int i = tid; i < nb * N; i += NTHREADS) {
    const int bl = i / N, n = i - bl * N;
    p.bits[static_cast<size_t>(tile0 + bl) * N + n] = app[n * TB + bl] > 0;
  }
}

template <int TB, int W, int DMAX, int ALGO, bool PRE>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = smem_bytes(p.N, p.n_edges, p.n_layers, TB);
  cudaError_t err = cudaFuncSetAttribute(
      layered_minsum_kernel<TB, W, DMAX, ALGO, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + TB - 1) / TB), block(NTHREADS);
  layered_minsum_kernel<TB, W, DMAX, ALGO, PRE><<<grid, block, smem, st>>>(p);
  return cudaGetLastError();
}

// four codewords a thread at DMAX 8, one at 16 and 32
template <int TB, int ALGO, bool PRE>
cudaError_t launch_tile(const Params& p, int dmax, cudaStream_t st) {
  switch (dmax) {
    case 8: return launch<TB, 4, 8, ALGO, PRE>(p, st);
    case 16: return launch<TB, 1, 16, ALGO, PRE>(p, st);
    case 32: return launch<TB, 1, 32, ALGO, PRE>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int ALGO, bool PRE>
cudaError_t launch_variant(const Params& p, int tile, int dmax,
                           cudaStream_t st) {
  switch (tile) {
    case 32: return launch_tile<32, ALGO, PRE>(p, dmax, st);
    case 16: return launch_tile<16, ALGO, PRE>(p, dmax, st);
    case 8: return launch_tile<8, ALGO, PRE>(p, dmax, st);
    case 4: return launch_tile<4, ALGO, PRE>(p, dmax, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch one decode on `stream` with a tile of `tile` codewords per CTA and
// contribution arrays of `dmax` (>= every block-row's degree); `msgs` is
// scratch of ceil(B / tile) * Z * n_edges * tile bytes; `ok` is null or B
// bytes for the convergence mask (not with early_term).  Returns a
// cudaError_t (0 on success).  `algo` and `minclamp_pre` must be this
// library's pair.
int layered_minsum_launch(const void* llr, void* bits, void* msgs,
                          void* iters_out, void* ok, const void* row_ptr,
                          const void* cols, const void* shifts, int n_layers,
                          int n_edges, int N, int Z, int B, int tile, int dmax, int algo, int minclamp_pre, int iters,
                          int early_term, int offset, int nms_f, int nms_f2,
                          int sat_var, int sat_msg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const int8_t*>(llr), static_cast<uint8_t*>(bits),
           static_cast<int8_t*>(msgs), static_cast<int*>(iters_out),
           static_cast<uint8_t*>(ok), static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
           static_cast<const int*>(shifts), n_layers, n_edges, N, Z, B,
           iters, early_term, CnSpec{offset, nms_f, nms_f2, sat_var, sat_msg}};
  if (!built_pair(algo, minclamp_pre) || B <= 0 || N <= 0 || Z <= 0 ||
      n_layers <= 0 || n_edges <= 0 || (ok && early_term) ||
      static_cast<long long>(Z) * n_edges * tile >= (1LL << 31) ||
      static_cast<long long>(N) * tile >= (1LL << 31) ||
      sat_var <= 0 || sat_var > 127 || sat_msg <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(iters_out, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  return launch_variant<MINSUM_ALGO, MINSUM_PRE>(p, tile, dmax, st);
}

const char* layered_minsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
