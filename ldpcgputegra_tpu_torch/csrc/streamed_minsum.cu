// Layered min-sum decoding of the codes whose APP array outgrows the QC
// kernel's tiles, on Hopper (sm_90a): the DVB-S2 path (the Z=360 QC views of
// the staircase codes, 16200 and 64800 bits) and synthqc-256x128x6-z1024
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
// What bounds it on this card: about half the instructions a round issues
// and half the latency of its rounds.  A CTA walks a layer's checks on its
// check lanes, one round after another, a __syncthreads() ends every
// layer, and a round waits for its loads.  At 64800x32400 a one-CTA wave
// (B = 128) takes 1.19-1.28 ms and two CTAs an SM over two waves (B = 512)
// 3.72-3.73 ms, so a second CTA on an SM adds about 0.6 ms of issue to a
// wave and the other ~0.6 ms is the rounds' latency (PERF.md §6; before
// the compile-time pair, 0.95 and 0.98 ms of a 1.935-ms wave).  The first
// port kept the APP in device memory for every code, so a round waited for
// two dependent device-memory trips (the VN ids and messages, then the APP
// bytes at those ids), and on 64800x6480-dvbs2 (about 90 committed checks
// of degree 30 a layer) a third of the lanes worked, each walking 30 edges.
// The design:
//
//  * APP placement, a template parameter.  Where tile x N bytes fit the
//    232,448 B a block may use, the APP lives in shared memory, [N][TB]
//    int8: 64800 bits at tiles 1 and 2, 16200 up to 8.  Otherwise (synthqc,
//    256 KB a codeword) it is a scratch buffer in device memory that the
//    wrapper allocates, [ceil(B / TB)][N][TB] int8 with the codeword
//    fastest; it is written during the launch, so it is read through a
//    plain pointer, never __ldg (the non-coherent path could return stale
//    bytes).  Either way one CTA owns its codewords' APP, so a
//    __syncthreads() between layers is all the layered order needs.
//  * K lanes a check (1, 2 or 4, a template parameter), for layers with
//    fewer checks than lanes: lane s of a check walks its edges s, s + K,
//    ..., and the K partial results merge by warp shuffles (min1 = min of
//    the min1s, min2 = min(min of the min2s, max of the min1s), parity by
//    XOR), which is bit-exact: the running two-min yields the smallest and
//    second-smallest magnitude in any order, and a message compares its
//    own magnitude with min1.  A lane holds DMAX / K contributions.
//  * All of a check's loads issued before any is used: the VN ids and
//    messages, then the APP bytes, in loops of loads alone.
//  * The contributions are unrolled to DMAX (8, 16 or 32, a template
//    parameter, the smallest that holds the code's degrees), so they stay
//    in registers.
//  * The algorithm and the minclamp placement are template parameters too
//    (the compile-time forms of minsum_common.cuh), and a library is built
//    for one pair (MINSUM_ALGO, MINSUM_PRE): a round carries that
//    pair's check-node arithmetic alone.  Each edge's magnitude is computed
//    once, for the two-min and its message, and the parity is the sign bit
//    of the XOR of the negated contributions, so each message's sign is
//    one XOR with that word.
//  * Only the VN id and message accesses are conditional.  An edge past
//    the layer's degree, or of a lane without a live check, reads as a
//    pinned edge (VN id -1), which moves neither the two-min nor the
//    parity; in shared memory a pinned edge's APP byte lies in a pad
//    before the APP.  Per-edge branches around the arithmetic cost more
//    instructions than the one dummy edge of a degree-7 check at DMAX 8.
//  * The APP's shared-memory address and the CTA's message base are kept
//    in registers (opaque to the compiler, which otherwise rebuilt them at
//    every access, four to six instructions each).
// 77.38 SASS instructions an edge update (57.50 on the integer-ALU pipe)
// became 43.38 (31.25) in the build 64800x32400 takes (bench/sass.py).
// The wrapper picks (placement, tile, K) from the code, the batch and the
// card's SM count (kernels/streamed.py::pick_tile), charging the shared
// memory, registers and CTAs an SM of the variant it launches.
//
// Mapping: one CTA of 512 threads decodes a tile of TB codewords.  In a
// warp the codeword is the fastest index (TB of them), then the check
// (32 / (TB K) of them), then the check's lane (K); check lanes walk
// checks g, g + 512 / (TB K), ... of the current layer, warp-uniformly
// where K > 1 (the shuffles need the whole warp) or the APP is in shared
// memory.  The per-edge tables
// (codes/convert.py::edge_tables, int32 VN ids, degree-major within a
// layer) make a sub-pass layer just its committed checks, and the
// deficient-circulant edge a VN id of -1 whose contribution is -sat_var and
// which writes nothing, so there is no QC special case, and any
// conflict-free layers decode.  The checks of a layer touch
// pairwise-disjoint VNs, so they run in parallel with a result
// bit-identical to the reference's sequential check loop.  The VN ids of a
// QC block-row are consecutive in the check, so there one warp-wide APP or
// message access is a few runs of contiguous bytes.
//
// col_perm is applied as the LLRs are loaded and the bits stored (app[n] =
// llr[perm[n]], bits[perm[n]] = app[n] > 0), so the view costs no extra
// pass over the batch.
//
// Offsets: a CTA's message (and device-memory APP) base pointers are size_t
// (E x B reaches 8e8 at 64800x6480-dvbs2, B = 4096); offsets inside one
// tile are int, and the launch refuses n_edges * tile or N * tile of 2^31
// or more.
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

constexpr int NTHREADS = 512;  // threads per CTA (mirrored in kernels/streamed.py)
constexpr int NO_MIN = 1 << 20;  // a min1 above every magnitude
// Shared memory before the APP: a pinned edge (VN id -1) of codeword tx
// reads and writes byte tx - TB of it, so that neither its load nor its
// store needs a test (mirrored in kernels/streamed.py::smem_bytes)
constexpr int APP_PAD = 16;

struct Params {
  const int8_t* llr;   // [B, N] frame-major
  uint8_t* bits;       // [B, N] frame-major
  int8_t* app;         // [ceil(B / TB)][N][TB] scratch, or null (shared memory)
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

// mirrored in kernels/streamed.py::smem_bytes
__host__ __device__ inline size_t app_bytes(int N, int tb) {
  return APP_PAD + ((static_cast<size_t>(N) * tb + 15) & ~static_cast<size_t>(15));
}

// The shared-memory APP by 32-bit shared-memory address: through a generic
// pointer every access would carry the generic-to-shared conversion
// (gather_minsum.cu found the shared window's base rebuilt per access).
__device__ __forceinline__ int lds_s8(uint32_t a) {
  int v;
  asm volatile("ld.shared.s8 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts8(uint32_t a, int v) {
  asm volatile("st.shared.b8 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// two CTAs an SM where a lane's DMAX / K contributions allow it (64
// registers a thread); kernels/streamed.py::ctas_per_sm counts on it
template <int TB, int DMAX, int K, bool SMEM_APP, int ALGO, bool PRE>
__global__ void __launch_bounds__(NTHREADS, DMAX / K <= 8 ? 2 : 1)
    streamed_minsum_kernel(Params p) {
  constexpr int D = DMAX / K;             // edges a lane holds
  constexpr int GW = 32 / (TB * K);       // checks a warp walks at once
  constexpr int TY = NTHREADS / (TB * K); // checks a CTA walks at once
  static_assert(TB * K <= 32, "a check's lanes and codewords span one warp");
  static_assert(!SMEM_APP || TB <= APP_PAD, "a pinned edge's byte in the pad");
  // warp-uniform rounds where the lanes of a check shuffle, and where the
  // APP is in shared memory (measured faster there, PERF.md); else a lane
  // walks its own checks, as at K = 1 with the APP in device memory
  constexpr bool UNIFORM = K > 1 || SMEM_APP;
  extern __shared__ __align__(16) unsigned char smem[];  // pad, [N][TB] if SMEM_APP
  __shared__ int s_unsat[TB];

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane % TB;             // codeword
  const int g0 = (tid >> 5) * GW;       // the warp's first check
  const int gw = (lane / TB) % GW;      // this thread's check in the warp
  const int sub = K > 1 ? lane / (TB * GW) : 0;  // its lane of the check
  const int tile0 = blockIdx.x * TB;
  const int nb = min(TB, p.B - tile0);  // codewords in this tile
  const int N = p.N;
  const CnSpec cn = p.cn;
  const int sv = cn.sat_var;
  // this CTA's APP and messages; offsets within them fit an int (checked
  // at launch).  In shared memory the thread's column of the APP is also
  // kept as a shared-memory address, whose pad holds the pinned edges.
  int8_t* app;
  if constexpr (SMEM_APP) app = reinterpret_cast<int8_t*>(smem + APP_PAD);
  else app = p.app + static_cast<size_t>(blockIdx.x) * N * TB;
  int8_t* at = app + tx;
  // (opaque, so that the compiler keeps it in a register: rebuilt from the
  // shared window's base it costs four instructions an access)
  uint32_t as = SMEM_APP ? static_cast<uint32_t>(__cvta_generic_to_shared(at)) : 0u;
  asm("" : "+r"(as));
  int8_t* mt = p.msgs + static_cast<size_t>(blockIdx.x) * p.n_edges * TB + tx;
  asm("" : "+l"(mt));  // kept, not rebuilt from the parameters at each access

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
      if (tid < TB) s_unsat[tid] = 0;  // visible after the first layer's barrier
    }
    iters_run = it + 1;
    uint32_t unsat = 0;  // bit 31: a check of this lane's was unsatisfied
    for (int l = 0; l < p.n_layers; ++l) {
      const int e0 = __ldg(p.row_ptr + l);
      const int G = __ldg(p.n_checks + l), deg = __ldg(p.deg + l);
      // UNIFORM: every lane of a warp runs the same rounds, idle where its
      // check is past the layer's or its codeword is frozen; else a lane
      // walks its own checks, and a frozen codeword's lanes skip the layer
      const int first = UNIFORM ? g0 : (active ? tid / TB : G);
      for (int gb = first; gb < G; gb += TY) {
        const int g = UNIFORM ? gb + gw : gb;
        const bool live = !UNIFORM || (active && g < G);
        // Every load of a check is issued before any is used: the VN ids
        // and messages, then the APP bytes, in loops of loads alone.  A
        // load whose value a branch or a later address needs stalls the
        // warp until it lands, so loads mixed with their uses cost a
        // memory round trip per edge; here a check waits for two (one
        // where the APP is in shared memory).  A pinned edge (v < 0)
        // uses neither its APP byte nor its message: its contribution is
        // -sat_var.  In shared memory it reads and writes its byte of the
        // pad; in device memory it reads VN 0 and writes nothing.  An
        // edge past the layer's degree, and every edge of a lane with no
        // live check this round, reads as a pinned edge and writes no
        // message: its magnitude is the largest and its sign not
        // positive, so it moves neither the two-min nor the parity of a
        // check of two edges or more (kernels/streamed.py refuses less).
        // So only the VN id and message accesses are conditional; the
        // branch around each edge's loads also keeps them ahead of the
        // loop that uses them (without it the compiler moved each APP
        // load up to its VN id's, and the round ran 2x slower, PERF.md).
        int v[D], c[D], a[D];
        uint32_t sa[D];  // SMEM_APP: the shared-memory address of the byte
        // slot of edge q of this lane: s0 + q * sk
        const int s0 = e0 + sub * G + g, sk = K * G;
#pragma unroll
        for (int q = 0; q < D; ++q) {
          v[q] = -1;
          c[q] = 0;
          if (live && q * K + sub < deg) {
            const int slot = s0 + q * sk;
            v[q] = __ldg(p.vn + slot);
            if (it) c[q] = mt[slot * TB];
          }
        }
#pragma unroll
        for (int q = 0; q < D; ++q) {
          if constexpr (SMEM_APP) {
            sa[q] = as + v[q] * TB;
            a[q] = lds_s8(sa[q]);
          } else {
            a[q] = at[max(v[q], 0) * TB];
          }
        }
        // contributions, their magnitudes (kept for the messages), the
        // two-min, and the parity as the sign bit of pw: the XOR of the
        // negated contributions, whose sign bits are c > 0
        int min1 = NO_MIN, min2 = sv + 1;
        uint32_t pw = 0;
#pragma unroll
        for (int q = 0; q < D; ++q) {
          const bool pinned = SMEM_APP ? sa[q] < as : v[q] < 0;
          c[q] = pinned ? -sv : clampi(a[q] - c[q], sv);
          a[q] = cn_abs<ALGO, PRE>(c[q], cn);
          two_min(q, a[q], min1, min2);
          pw ^= static_cast<uint32_t>(-c[q]);
        }
        if constexpr (K > 1) {
          // merge the check's K lanes: XOR across the lane bits of `sub`
#pragma unroll
          for (int o = 16; o >= 32 / K; o >>= 1) {
            const int m1 = __shfl_xor_sync(0xffffffffu, min1, o);
            const int m2 = __shfl_xor_sync(0xffffffffu, min2, o);
            pw ^= __shfl_xor_sync(0xffffffffu, pw, o);
            min2 = min(min(min2, m2), max(min1, m1));
            min1 = min(min1, m1);
          }
        }
        int f1, f2;
        cn_f<ALGO, PRE>(min1, min2, cn, f1, f2);
        // the stores compute their message addresses anew: an opaque copy
        // of s0 keeps the loads' 64-bit addresses from living across the
        // check (as in gather_minsum.cu, where they spilled)
        int s1 = s0;
        asm("" : "+r"(s1));
#pragma unroll
        for (int q = 0; q < D; ++q) {
          // the sign bit of pw ^ -c is parity != (c > 0)
          const int m = cn_msg<ALGO, PRE>(
              a[q], static_cast<int>(pw ^ static_cast<uint32_t>(-c[q])), min1,
              f1, f2);
          if (live && q * K + sub < deg)
            mt[(s1 + q * sk) * TB] = static_cast<int8_t>(m);
          const int na = clampi(c[q] + m, sv);
          if constexpr (SMEM_APP) sts8(sa[q], na);
          else if (v[q] >= 0) at[v[q] * TB] = static_cast<int8_t>(na);
        }
        // a lane with no live check has pw's sign bit clear
        unsat |= pw;
      }
      __syncthreads();
    }
    if (p.early_term) {
      if (active && (unsat >> 31)) s_unsat[tx] = 1;
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

template <int TB, int DMAX, int K, bool SMEM_APP, int ALGO, bool PRE>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = SMEM_APP ? app_bytes(p.N, TB) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      streamed_minsum_kernel<TB, DMAX, K, SMEM_APP, ALGO, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + TB - 1) / TB), block(NTHREADS);
  streamed_minsum_kernel<TB, DMAX, K, SMEM_APP, ALGO, PRE>
      <<<grid, block, smem, st>>>(p);
  return cudaGetLastError();
}

// the variants that kernels/streamed.py::VARIANTS lists: K > 1 only at
// DMAX 16 and 32 and tiles up to 8; shared memory only at tiles up to 8
template <int TB, bool SMEM_APP, int ALGO, bool PRE>
cudaError_t launch_tile(const Params& p, int dmax, int k, cudaStream_t st) {
  if (k == 1) {
    switch (dmax) {
      case 8: return launch<TB, 8, 1, SMEM_APP, ALGO, PRE>(p, st);
      case 16: return launch<TB, 16, 1, SMEM_APP, ALGO, PRE>(p, st);
      case 32: return launch<TB, 32, 1, SMEM_APP, ALGO, PRE>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if constexpr (TB <= 8) {
    switch (dmax * 8 + k) {
      case 16 * 8 + 2: return launch<TB, 16, 2, SMEM_APP, ALGO, PRE>(p, st);
      case 16 * 8 + 4: return launch<TB, 16, 4, SMEM_APP, ALGO, PRE>(p, st);
      case 32 * 8 + 2: return launch<TB, 32, 2, SMEM_APP, ALGO, PRE>(p, st);
      case 32 * 8 + 4: return launch<TB, 32, 4, SMEM_APP, ALGO, PRE>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <int ALGO, bool PRE>
cudaError_t launch_variant(const Params& p, int tile, int dmax, int k,
                           int smem_app, cudaStream_t st) {
  if (smem_app) {
    switch (tile) {
      case 8: return launch_tile<8, true, ALGO, PRE>(p, dmax, k, st);
      case 4: return launch_tile<4, true, ALGO, PRE>(p, dmax, k, st);
      case 2: return launch_tile<2, true, ALGO, PRE>(p, dmax, k, st);
      case 1: return launch_tile<1, true, ALGO, PRE>(p, dmax, k, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (tile) {
    case 32: return launch_tile<32, false, ALGO, PRE>(p, dmax, k, st);
    case 16: return launch_tile<16, false, ALGO, PRE>(p, dmax, k, st);
    case 8: return launch_tile<8, false, ALGO, PRE>(p, dmax, k, st);
    case 4: return launch_tile<4, false, ALGO, PRE>(p, dmax, k, st);
    case 2: return launch_tile<2, false, ALGO, PRE>(p, dmax, k, st);
    case 1: return launch_tile<1, false, ALGO, PRE>(p, dmax, k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch one decode on `stream` with a tile of `tile` codewords per CTA,
// `k` lanes a check, contribution arrays of `dmax` (>= every layer's
// degree) and the APP in shared memory (`smem_app` 1) or in `app`, scratch
// of ceil(B / tile) * N * tile bytes; `msgs` is scratch of ceil(B / tile) *
// n_edges * tile bytes; `perm` may be null.  `algo` and `minclamp_pre` must
// be this library's pair.  Returns a cudaError_t (0 on success).
int streamed_minsum_launch(const void* llr, void* bits, void* app, void* msgs,
                           void* iters_out, const void* row_ptr,
                           const void* n_checks, const void* deg,
                           const void* vn, const void* perm, int n_layers,
                           long long n_edges, int N, int B, int tile, int dmax,
                           int k, int smem_app, int algo, int minclamp_pre,
                           int iters, int early_term, int offset, int nms_f,
                           int nms_f2, int sat_var, int sat_msg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const int8_t*>(llr), static_cast<uint8_t*>(bits),
           static_cast<int8_t*>(app), static_cast<int8_t*>(msgs),
           static_cast<int*>(iters_out), static_cast<const int*>(row_ptr),
           static_cast<const int*>(n_checks), static_cast<const int*>(deg),
           static_cast<const int*>(vn), static_cast<const int*>(perm),
           n_layers, N, B, iters, early_term, static_cast<size_t>(n_edges),
           CnSpec{offset, nms_f, nms_f2, sat_var, sat_msg}};
  if (!built_pair(algo, minclamp_pre) || B <= 0 || N <= 0 || n_layers <= 0 ||
      n_edges <= 0 || n_edges * tile >= (1LL << 31) ||
      static_cast<long long>(N) * tile >= (1LL << 31) ||
      sat_var <= 0 || sat_var > 127 || sat_msg <= 0 ||
      (!smem_app && app == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(iters_out, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  return launch_variant<MINSUM_ALGO, MINSUM_PRE>(p, tile, dmax, k, smem_app,
                                                 st);
}

const char* streamed_minsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
