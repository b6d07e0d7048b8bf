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
// What bounds it on this card.  At the sweep's shape (4000x2000, a batch of
// 4096) the instructions it issues: the first port compiled to 67.88 SASS
// instructions an edge update, 45.62 on the integer-ALU pipe, against the
// 21 operations the arithmetic needs, and ran at about 79% of the issue
// floor they imply.  At the other shapes the latency of each check lane's
// round (its loads, then its arithmetic) and how many CTAs fill the card:
// 20000x10000 at a batch of 1024 ran one under-filled wave of 8-codeword
// tiles, and two-phase early termination's phase 2 decodes a few hundred
// frames.  The design (PERF.md has the numbers):
//
//  * The algorithm and the minclamp placement are template parameters (the
//    compile-time forms of minsum_common.cuh), and a library is built for
//    one pair (MINSUM_ALGO, MINSUM_PRE): a build carries that pair's
//    check-node arithmetic and no per-edge select.
//  * Four codewords a thread (W = 4).  One 32-bit shared-memory APP
//    access and one 32-bit message access serve four codewords, with one
//    VN id load and one address; the bytes are
//    unpacked to int32 arithmetic (one PRMT each, sign-extending), not
//    int8x4 SIMD, which Hopper emulates (0.83x the int32 rate).  The
//    contributions stay packed, four int8 in a register (|c| <= sat_var <=
//    127), and the four parities come from the packed word in three
//    instructions (positive_bits), where a bool a codeword took five each.
//    The first port's one codeword a thread ran 1.30-3.27x slower at every
//    measured shape (PERF.md) and is gone.
//  * All of a check's loads are issued before any is used: the VN ids and
//    the messages, then the APP words, each in a loop of loads alone, so a
//    round waits for two memory trips, not two per edge.  The ids stay in
//    registers, as 32-bit shared-memory addresses, for the write-back.
//  * K lanes a check (1, 2 or 4, a template parameter): lane s of a check
//    walks its edges s, s + K, ..., and the K partial two-mins and
//    parities merge by warp shuffles, which is bit-exact: the running
//    two-min yields the smallest and second-smallest magnitude in any
//    order, and a message compares its own magnitude with min1 (as in
//    streamed_minsum.cu).  K spreads a short layer over more lanes, and it
//    halves a lane's registers: at DMAX 8 four codewords a thread with one
//    lane a check (8 edges, 32 contributions) spilled at 64 registers, with
//    two (4 edges) it fits and ran fastest at every measured shape.
//  * The tile, TB codewords a CTA (32, 16, 8 or 4, a template parameter),
//    is picked by the wrapper with K from the code, the batch and the
//    card's SM count (kernels/gather.py::pick_tile): narrow tiles fill the
//    card at small batches and shrink the APP (tile 4 takes 80 KB at
//    20000x10000, so two CTAs share an SM).
//  * Offsets inside a CTA's own message block are 32-bit; its base pointer
//    is size_t, and the launch refuses n_edges * tile of 2^31 or more.
//    The stores compute their message addresses anew instead of keeping
//    the loads' 64-bit ones, which spilled.

// Mapping: one CTA of 512 threads decodes a tile of TB codewords.  In a
// warp the codeword column is the fastest index (COLS = TB / W of them,
// W codewords each), then the check (GW = 32 / (COLS K) of them), then the
// check's lane (K); the warps walk checks g0, g0 + 512 / (COLS K), ... of
// the current layer warp-uniformly (the shuffles need the whole warp).
// The checks of one layer touch pairwise-disjoint VNs, so they run in
// parallel with a result bit-identical to the reference's sequential check
// loop; a __syncthreads() separates layers.  Layers may differ in degree
// (irregular codes); the edge loops are unrolled to DMAX / K (DMAX = 8, 16
// or 32, the smallest that holds the code's degrees), so nothing is indexed
// at run time.
//
// Memory: the tile's APP array lives in shared memory, [N][TB] int8, within
// the 227 KB a block can use: TB = 32 up to N = 7260, 16 up to 14524, 8 up
// to 29052, 4 up to 58104.  The VN index table (one uint16 per edge,
// degree-major within a layer: edge j of check g is slot row_ptr[l] + j G +
// g; 24 KB at 4000x2000) is read through the read-only cache.  The c2v
// messages live in device memory, [ceil(B / TB)][E][TB] int8, the codeword
// fastest, so the checks and codewords of one warp-wide access are
// contiguous bytes.  Iteration 0 reads no messages (they start at zero), so
// the buffer needs no clearing.
//
// Early termination: as in layered_minsum.cu, a codeword whose on-the-fly
// parity is zero over a whole iteration is frozen, so its output is its
// hard decision at the end of that iteration (the TPU kernels' snapshot);
// a frozen codeword inside a packed word keeps its APP byte (the store
// writes the live bytes alone).  The CTA leaves once all of its codewords
// are frozen, and iters_used is the max over CTAs of the iterations run
// (atomicMax into one int32).
//
// TPU workarounds that have no counterpart here: the int32 [N, 8, 128] APP,
// sublane widths 8/4/2, fori_loop chunking and the SMEM index DMA groups,
// the win/io/stream io modes, 4-row message alignment, and the 1024-codeword
// batch padding (a ragged B masks its last tile).

#include <cuda_runtime.h>
#include <stdint.h>

#include "minsum_common.cuh"

// The builds, (tile, lanes a check, DMAX); mirrored in
// kernels/gather.py::BUILDS.  A lane holds DMAX / K <= 8 edges (its 32
// packed contributions fit 64 registers a thread), and each (tile, K) is
// the pick of some code and batch.
#define GATHER_VARIANTS(X)                                              \
  X(32, 2, 8) X(16, 2, 8) X(8, 2, 8) X(4, 2, 8)                         \
  X(32, 4, 8) X(16, 4, 8)                                               \
  X(32, 2, 16)                                                          \
  X(32, 4, 16) X(16, 4, 16) X(8, 4, 16) X(4, 4, 16)                     \
  X(32, 4, 32) X(16, 4, 32) X(8, 4, 32) X(4, 4, 32)

namespace {

using namespace minsum;

constexpr int NTHREADS = 512;    // threads per CTA (mirrored in kernels/gather.py)
constexpr int W = 4;             // codewords a thread, one packed word
constexpr int NO_MIN = 1 << 20;  // a min1 above every magnitude

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

// byte k of w, sign-extended: one PRMT (selector nibbles k, then k | 8,
// which replicates the byte's sign)
__device__ __forceinline__ int sbyte(uint32_t w, int k) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(w), "r"(0u), "r"(0x8880u | (k * 0x1111u)));
  return r;
}

// the low bytes of four ints in one word: three PRMTs
__device__ __forceinline__ uint32_t pack4(const int (&b)[4]) {
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// bit 7 of byte k set where byte k of w, a packed contribution in
// [-127, 127], is > 0 (its low 7 bits are not zero and its sign bit is);
// the other bits are garbage.  (w | 0x80..) - 0x01.. borrows within no
// byte, as every byte is at least 0x80.
__device__ __forceinline__ uint32_t positive_bits(uint32_t w) {
  return ~w & ((w | 0x80808080u) - 0x01010101u);
}

// The APP tile by 32-bit shared-memory address.  Through a generic pointer
// the compiler rebuilt the tile's shared-window base for every access
// under register pressure (S2R SR_CgaCtaId, MOV, LEA, IMAD: four
// instructions an access); the ids are kept as these addresses instead.
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void sts8(uint32_t a, int v) {
  asm volatile("st.shared.b8 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// two CTAs an SM (64 registers a thread); kernels/gather.py::ctas_per_sm
// counts on it
template <int TB, int K, int DMAX, int ALGO, bool PRE>
__global__ void __launch_bounds__(NTHREADS, 2)
    gather_minsum_kernel(Params p) {
  constexpr int D = DMAX / K;              // edges a lane holds
  constexpr int COLS = TB / W;             // threads across the tile
  constexpr int GW = 32 / (COLS * K);      // checks a warp walks at once
  constexpr int TY = NTHREADS / (COLS * K);  // checks a CTA walks at once
  constexpr unsigned ALL = (1u << W) - 1;
  static_assert(COLS * K <= 32, "a check's lanes and columns span one warp");
  static_assert(D <= 8, "packed contributions: 8 edges a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* app = reinterpret_cast<int8_t*>(smem);                    // [N][TB]
  int* s_unsat = reinterpret_cast<int*>(smem + app_bytes(p.N, TB));  // [TB]

  const int tid = threadIdx.x, lane = tid & 31;
  const int cx = lane % COLS;                    // codeword column
  const int g0 = (tid >> 5) * GW;                // the warp's first check
  const int gw = (lane / COLS) % GW;             // this thread's check in it
  const int sub = K > 1 ? lane / (COLS * GW) : 0;  // its lane of the check
  const int tile0 = blockIdx.x * TB;
  const int nb = min(TB, p.B - tile0);  // codewords in this tile
  const int N = p.N;
  const CnSpec cn = p.cn;
  const int sv = cn.sat_var;
  // this thread's column of the APP tile (a shared-memory address) and of
  // the CTA's message block; offsets inside the block fit an int (checked
  // at launch)
  const uint32_t at =
      static_cast<uint32_t>(__cvta_generic_to_shared(app)) + cx * W;
  uint32_t* mt = reinterpret_cast<uint32_t*>(p.msgs + static_cast<size_t>(blockIdx.x) *
                                            p.n_edges * TB) + cx;

  // frame-major LLRs -> node-major APP tile, one frame at a time:
  // consecutive threads read consecutive bytes of it; a ragged tile's
  // missing codewords are 0
  for (int bl = 0; bl < TB; ++bl) {
    for (int n = tid; n < N; n += NTHREADS)
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
      if (tid < TB) s_unsat[tid] = 0;  // visible after the first layer's barrier
    }
    iters_run = it + 1;
    unsigned unsat = 0;  // bit k: codeword k's parity was not zero
    for (int l = 0; l < p.n_layers; ++l) {
      const int e0 = __ldg(p.row_ptr + l);
      const int G = __ldg(p.n_checks + l), deg = __ldg(p.deg + l);
      for (int gb = g0; gb < G; gb += TY) {
        const int g = gb + gw;
        const bool live = active && g < G;
        // slot of edge q of this lane: s0 + q * sk
        const int s0 = e0 + sub * G + g, sk = K * G;
        // every load of the check first: VN ids and messages, then APP
        // words, each in a loop of loads alone
        uint32_t v[D];  // the shared-memory address of edge q's APP word
        uint32_t mw[D], aw[D];
#pragma unroll
        for (int q = 0; q < D; ++q) {
          if (live && q * K + sub < deg) {
            const int slot = s0 + q * sk;
            v[q] = at + static_cast<uint32_t>(__ldg(p.vn + slot)) * TB;
            mw[q] = it ? mt[slot * COLS] : 0u;
          }
        }
#pragma unroll
        for (int q = 0; q < D; ++q)
          if (live && q * K + sub < deg) aw[q] = lds32(v[q]);
        // contributions (packed, byte k for codeword k), two-mins and
        // parities: the parity of codeword k is bit 8 k + 7 of pw, the
        // positive_bits of each packed contribution XORed
        uint32_t c4[D];
        int min1[W], min2[W];
        uint32_t pw = 0;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          min1[k] = NO_MIN;
          min2[k] = sv + 1;
        }
#pragma unroll
        for (int q = 0; q < D; ++q) {
          if (live && q * K + sub < deg) {
            int ck[W];
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const int cj = clampi(sbyte(aw[q], k) - sbyte(mw[q], k), sv);
              ck[k] = cj;
              two_min(q, cn_abs<ALGO, PRE>(cj, cn), min1[k], min2[k]);
            }
            c4[q] = pack4(ck);
            pw ^= positive_bits(c4[q]);
          }
        }
        if constexpr (K > 1) {
          // merge the check's K lanes: XOR across the lane bits of `sub`
#pragma unroll
          for (int o = 16; o >= 32 / K; o >>= 1) {
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const int m1 = __shfl_xor_sync(0xffffffffu, min1[k], o);
              const int m2 = __shfl_xor_sync(0xffffffffu, min2[k], o);
              min2[k] = min(min(min2[k], m2), max(min1[k], m1));
              min1[k] = min(min1[k], m1);
            }
            pw ^= __shfl_xor_sync(0xffffffffu, pw, o);
          }
        }
        bool par[W];
#pragma unroll
        for (int k = 0; k < W; ++k) par[k] = pw >> (8 * k + 7) & 1u;
        int f1[W], f2[W];
#pragma unroll
        for (int k = 0; k < W; ++k) cn_f<ALGO, PRE>(min1[k], min2[k], cn, f1[k], f2[k]);
        // the stores compute their message addresses anew: an opaque copy
        // of s0 keeps the loads' 64-bit addresses from living across the
        // check (they spilled to local memory, PERF.md)
        int s1 = s0;
        asm("" : "+r"(s1));
#pragma unroll
        for (int q = 0; q < D; ++q) {
          if (live && q * K + sub < deg) {
            int mk[W], ak[W];
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const int cj = sbyte(c4[q], k);
              mk[k] = cn_msg<ALGO, PRE>(cj, par[k], min1[k], f1[k], f2[k], cn);
              ak[k] = clampi(cj + mk[k], sv);
            }
            const int slot = s1 + q * sk;
            mt[slot * COLS] = pack4(mk);
            if (active == ALL) {
              sts32(v[q], pack4(ak));
            } else {
              // a frozen (or missing) codeword keeps its APP byte
#pragma unroll
              for (int k = 0; k < W; ++k)
                if (active >> k & 1u) sts8(v[q] + k, ak[k]);
            }
          }
        }
        if (live) {
#pragma unroll
          for (int k = 0; k < W; ++k) unsat |= static_cast<unsigned>(par[k]) << k;
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
  for (int bl = 0; bl < nb; ++bl) {
    uint8_t* dst = p.bits + static_cast<size_t>(tile0 + bl) * N;
    for (int n = tid; n < N; n += NTHREADS) dst[n] = app[n * TB + bl] > 0;
  }
}

template <int TB, int K, int DMAX, int ALGO, bool PRE>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = smem_bytes(p.N, TB);
  cudaError_t err = cudaFuncSetAttribute(
      gather_minsum_kernel<TB, K, DMAX, ALGO, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + TB - 1) / TB), block(NTHREADS);
  gather_minsum_kernel<TB, K, DMAX, ALGO, PRE><<<grid, block, smem, st>>>(p);
  return cudaGetLastError();
}

template <int ALGO, bool PRE>
cudaError_t launch_variant(const Params& p, int tile, int k, int dmax,
                           cudaStream_t st) {
#define GATHER_CASE(TB, K, DMAX)                \
  if (tile == TB && k == K && dmax == DMAX)     \
    return launch<TB, K, DMAX, ALGO, PRE>(p, st);
  GATHER_VARIANTS(GATHER_CASE)
#undef GATHER_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch one decode on `stream` in the build (tile codewords per CTA, k
// lanes a check, contribution arrays of dmax >= every layer's degree);
// `msgs` is scratch of ceil(B / tile) * n_edges * tile bytes.  `algo` and
// `minclamp_pre` must be this library's pair.  Returns a cudaError_t (0 on
// success).
int gather_minsum_launch(const void* llr, void* bits, void* msgs,
                         void* iters_out, const void* row_ptr,
                         const void* n_checks, const void* deg, const void* vn,
                         int n_layers, int n_edges, int N, int B, int tile,
                         int k, int dmax, int algo, int minclamp_pre,
                         int iters, int early_term, int offset, int nms_f,
                         int nms_f2, int sat_var, int sat_msg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const int8_t*>(llr), static_cast<uint8_t*>(bits),
           static_cast<int8_t*>(msgs), static_cast<int*>(iters_out),
           static_cast<const int*>(row_ptr), static_cast<const int*>(n_checks),
           static_cast<const int*>(deg), static_cast<const uint16_t*>(vn),
           n_layers, n_edges, N, B, iters, early_term,
           CnSpec{offset, nms_f, nms_f2, sat_var, sat_msg}};
  if (!built_pair(algo, minclamp_pre) || B <= 0 || N <= 0 || N > 65535 ||
      n_layers <= 0 || n_edges <= 0 ||
      static_cast<long long>(n_edges) * tile >= (1LL << 31) ||
      sat_var <= 0 || sat_var > 127 || sat_msg <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(iters_out, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  return launch_variant<MINSUM_ALGO, MINSUM_PRE>(p, tile, k, dmax, st);
}

const char* gather_minsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
