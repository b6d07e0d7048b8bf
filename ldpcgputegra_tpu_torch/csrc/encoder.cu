// The table and staircase encoders' arithmetic on Hopper (sm_90a): info
// bits [B, K] to codewords [B, N] of the accumulate form.
//
// It replaces no TPU kernel: the JAX package encodes with NumPy on the host
// (ldpcgputegra_tpu/channel/encoder.py).  In PyTorch the same encode ran as
// six kernels, each a pass over int32 temporaries of B x (table entries) or
// B x (parity bits): a gather of the info bits by table entry, an
// index_add_ into parity sums, a running sum, the casts, `& 1` and a cat
// (0.525 ms at 16200x10800 B=512 on an H100).  Built with nvcc into a
// shared library with a plain C interface and called through ctypes
// (ldpcgputegra_tpu_torch/kernels/encoder.py), on PyTorch's current stream,
// so that a CUDA graph captures it.
//
// What it computes, for frame b: c[b, :K] = u[b]; s_j, the XOR of the low
// bits of parity row j's info bytes; c[b, K + j] = p_j = s_0 ^ ... ^ s_j.
// The table lists each row's info bits, row after row, in CSR form
// (row_ptr[M + 1], cols[E] of int16 or int32).  So p_j is the XOR of the
// table's first row_ptr[j + 1] entries: one prefix XOR over the entries
// gives every parity bit, whatever the rows' degrees.  XOR does not depend
// on order, so this is the bytes of the scatter and the running sum mod 2.
//
// What bounds it: bytes, B x K info bytes read and B x N codeword bytes
// written (13.8 MB, 4.1 us at 3.35 TB/s at 16200x10800 B=512); the table
// (86 KB there) is read by every CTA, from the L2.  The design: one CTA a
// frame.  It copies the frame's info bytes in 8-byte words into shared
// memory and into the codeword's systematic part (a codeword row is only
// 8-byte aligned; other alignments go a byte a thread).  Each warp then
// takes a contiguous run of 32-entry chunks of the table.  A lane reads
// one entry, so the warp's read is one coalesced 64- or 128-byte load
// (lanes that each walked 32 rows would read 32 lines at once), and
// gathers the entry's info byte from shared memory.  A ballot packs the
// chunk's 32 low bits into a word, and its popcount keeps the warp's
// running XOR; lane i keeps chunk i's word of 32, and one store writes the
// 32.  After a barrier the scan: a lane a chunk, each warp turns its words
// into their prefix XOR over the whole table (five shift-XOR steps within
// a word, the parities of the words before it by a ballot and the warps
// before it from shared memory), and parity byte j is bit (e & 31) of word
// e >> 5, e = row_ptr[j + 1] - 1, written by a warp 32 bytes at a time.
// Shared memory: K bytes (rounded up to 16) and 4 bytes a chunk, 16.3 KB
// at 16200x10800 and 81 KB at K = 58320.  On an H100 at 16200x10800
// B=512 it takes 22.5 us, 5.5x the byte bound: the gathers' bank
// conflicts (32 random bytes of the frame a warp load) and the table's
// loads fill the shared-memory pipe.  A chunk's prefix XOR in the serial
// loop took 33 us; four entries a lane, 23.6.  512 threads, not 256: the
// same at 16200x10800, 80 us against 99 at 64800x32400 (each warp's
// chain of chunks half as long).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENCODE_BLOCK = 512;  // threads a CTA
constexpr int ENCODE_WARPS = ENCODE_BLOCK / 32;
constexpr int ENCODE_UNROLL = 4;  // a lane's gathers in flight
constexpr long long ENCODE_SMEM_MAX = 232448;  // a CTA's on Hopper

// The dynamic shared memory of a CTA: the info bytes, a word a 32-entry
// chunk of the table, a word a warp.
long long smem_bytes(long long K, long long E) {
  return (K + 15) / 16 * 16 + 4 * ((E + 31) / 32) + 4 * ENCODE_WARPS;
}

// Bit r of the result: the XOR of bits 0..r of w.
__device__ __forceinline__ unsigned prefix_xor(unsigned w) {
  w ^= w << 1;
  w ^= w << 2;
  w ^= w << 4;
  w ^= w << 8;
  w ^= w << 16;
  return w;
}

template <typename Col>
__global__ void __launch_bounds__(ENCODE_BLOCK)
accumulate_encode_kernel(const uint8_t* __restrict__ u,
                         uint8_t* __restrict__ out,
                         const int* __restrict__ row_ptr,
                         const Col* __restrict__ cols, int K, int N, int E) {
  extern __shared__ uint4 smem[];
  uint8_t* info = reinterpret_cast<uint8_t*>(smem);
  const int chunks = (E + 31) / 32;
  unsigned* words = reinterpret_cast<unsigned*>(info + (K + 15) / 16 * 16);
  unsigned* warp_xor = words + chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* src = u + static_cast<long long>(blockIdx.x) * K;
  uint8_t* dst = out + static_cast<long long>(blockIdx.x) * N;

  // the info bytes into shared memory and into the systematic part
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       7) == 0) {
    head = K & ~7;
    const uint2* s8 = reinterpret_cast<const uint2*>(src);
    uint2* d8 = reinterpret_cast<uint2*>(dst);
    uint2* i8 = reinterpret_cast<uint2*>(info);
    for (int i = tid; i < K / 8; i += ENCODE_BLOCK) {
      const uint2 v = __ldg(s8 + i);
      i8[i] = v;
      d8[i] = v;
    }
  }
  for (int i = head + tid; i < K; i += ENCODE_BLOCK) {
    const uint8_t v = src[i];
    info[i] = v;
    dst[i] = v;
  }
  __syncthreads();

  // the warp's chunks [c0, c1): words[c], the low bits of entries 32 c to
  // 32 c + 31 (a ballot); run, the XOR of the warp's bits so far in bit 0
  const int per_warp = (chunks + ENCODE_WARPS - 1) / ENCODE_WARPS;
  const int c0 = min(chunks, warp * per_warp);
  const int c1 = min(chunks, c0 + per_warp);
  unsigned run = 0;
  for (int g = c0; g < c1; g += 32) {
    unsigned mine = 0;  // the word of chunk g + lane
#pragma unroll
    for (int i = 0; i < 32; i += ENCODE_UNROLL) {
      unsigned bit[ENCODE_UNROLL];
#pragma unroll
      for (int j = 0; j < ENCODE_UNROLL; ++j) {
        const int e = (g + i + j) * 32 + lane;
        bit[j] = g + i + j < c1 && e < E ? info[__ldg(cols + e)] : 0u;
      }
#pragma unroll
      for (int j = 0; j < ENCODE_UNROLL; ++j) {
        const unsigned w = __ballot_sync(0xffffffffu, bit[j] & 1u);
        run ^= __popc(w);
        if (lane == i + j) mine = w;
      }
    }
    if (g + lane < c1) words[g + lane] = mine;
  }
  if (lane == 0) warp_xor[warp] = run & 1u;
  __syncthreads();

  // each word to its prefix XOR over the whole table: bit r of words[c],
  // the XOR of the bits of entries 0 through 32 c + r; a lane a chunk
  unsigned carry = 0;  // the XOR of the bits before chunk g
  for (int w = 0; w < warp; ++w) carry ^= warp_xor[w];
  for (int g = c0; g < c1; g += 32) {
    const int c = g + lane;
    const unsigned w = c < c1 ? words[c] : 0u;
    const unsigned odd = __ballot_sync(0xffffffffu, __popc(w) & 1u);
    const unsigned before = carry ^ (__popc(odd & ((1u << lane) - 1u)) & 1u);
    if (c < c1) words[c] = prefix_xor(w) ^ (0u - before);
    carry ^= __popc(odd) & 1u;
  }
  __syncthreads();

  // parity bit j: the XOR of the table's first row_ptr[j + 1] entries
  const int M = N - K;
  for (int j = tid; j < M; j += ENCODE_BLOCK) {
    const int e = __ldg(row_ptr + j + 1) - 1;
    dst[K + j] = e < 0 ? 0 : (words[e >> 5] >> (e & 31)) & 1u;
  }
}

template <typename Col>
cudaError_t launch(const void* u, void* out, const void* row_ptr,
                   const void* cols, long long B, int K, int N, int E,
                   cudaStream_t st) {
  const int smem = static_cast<int>(smem_bytes(K, E));
  cudaError_t err = cudaFuncSetAttribute(
      accumulate_encode_kernel<Col>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  accumulate_encode_kernel<Col><<<static_cast<unsigned>(B), ENCODE_BLOCK,
                                  smem, st>>>(
      static_cast<const uint8_t*>(u), static_cast<uint8_t*>(out),
      static_cast<const int*>(row_ptr), static_cast<const Col*>(cols), K, N,
      E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The codewords [B, N] (int8, rows N bytes apart) of the info bits `u`
// [B, K] (int8, rows K bytes apart) into `out`, from the parity table
// row_ptr[N - K + 1] (int32) and cols[E] (int16 where col_bytes is 2, int32
// where it is 4), on `stream`: one CTA a frame.  Returns a cudaError_t (0 on
// success).
int accumulate_encode_launch(const void* u, void* out, const void* row_ptr,
                             const void* cols, int col_bytes, long long B,
                             int K, int N, int E, void* stream) {
  if (B <= 0 || B > 0x7fffffffLL || K <= 0 || N <= K || E < 0 ||
      smem_bytes(K, E) > ENCODE_SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (col_bytes == 2)
    return launch<int16_t>(u, out, row_ptr, cols, B, K, N, E, st);
  if (col_bytes == 4)
    return launch<int32_t>(u, out, row_ptr, cols, B, K, N, E, st);
  return cudaErrorInvalidValue;
}

const char* encoder_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
