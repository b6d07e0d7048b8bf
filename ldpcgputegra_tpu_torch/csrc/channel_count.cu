// The two passes around the decoder in a simulation batch, on Hopper
// (sm_90a): the AWGN channel with the LLR quantizer, and the error count.
//
// They replace no TPU kernel.  The JAX package wrote this chain in plain
// jax.numpy and left its fusion to XLA; in PyTorch the same chain ran as
// about ten kernels, each a pass over the frame block (the zero codeword,
// its map to symbols, the scaling of the noise, the sum, the quantizer's
// scale, clamp and cast; the count's compare, row sum and two sums).
// Built with nvcc into a shared library with a plain C interface and called
// through ctypes (ldpcgputegra_tpu_torch/kernels/channel.py), on PyTorch's
// current stream, so that a CUDA graph captures them.
//
// awgn_quantize: int8 LLRs of the all-zero codeword from the standard
// normal draws `noise` (torch.randn, float32, made by the caller so that
// the generator's stream stays the plain path's): y = -amp + sigma * n,
// q = y * factor, clamped to +-sat, truncated toward zero.  Each operation
// is rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), in the
// plain chain's order, so the bytes are the plain chain's.  sigma and the
// factor are read from device memory (the channel's 0-d scalars), so one
// captured graph serves every SNR point.  Bound by bytes: 4 read and 1
// written an element.  Each thread of a grid that fills the SMs reads 64
// contiguous bytes as four 16-byte streaming loads (the noise is read
// once) and writes its 16 LLRs in one 16-byte store, in a grid-stride
// loop; the last numel % 16 elements go one a thread.
// awgn_quantize_coded: the same for coded bits (one byte a bit, nonzero
// for 1), each element's symbol +amp for a 1 and -amp for a 0, the rest
// as above in the same float order; the 16 bits of a thread's 16 LLRs
// come in one more 16-byte load.  6 bytes an element.  Both forms are one
// body compiled with a flag, false for the all-zero form.
//
// count_errors: the frames' bit errors against the all-zero codeword, as
// (BE, FE) int64: BE the nonzero bytes of the first `cols` columns of each
// row, FE the rows with any.  Bound by bytes: 1 read an element.  A row of
// at most 512 16-byte words (8 KB) is counted by one warp, eight rows a CTA
// at once; a longer row by a CTA of 64-512 threads (the fewest that read
// it in 8 words each).  A thread keeps 4 loads in flight, so that its
// registers let 4 CTAs of 512 threads share an SM.  In a grid-stride
// loop over the rows: the bytes before a row's first 16-byte boundary and
// after its last one go one a thread.  A row's count is reduced in its
// warp, or across the CTA's warps (one barrier a row, the partials in a
// buffer that alternates between rows); each CTA keeps its BE and FE in
// registers and adds them to the output with one atomic each at its end.
// A warp a short row keeps most of a CTA from waiting at a barrier: on an
// H100 at 4000x2000 B=4096 a CTA a row took 10.8 us, a warp a row 7.4.
// The output is zeroed on the same stream before the kernel.  Integer
// sums, so the result is exact whatever order the atomics land in.
// count_errors_ref: the same against reference frames (the bits sent):
// a byte is an error where it differs from the reference's, read as the
// nonzero bytes of the two 16-byte words' XOR.  Each reference row lies
// at the same offset from a 16-byte boundary as its frame's row (the
// wrapper copies both where they do not).  2 bytes an element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int AWGN_BLOCK = 256;  // threads a CTA of awgn_quantize
constexpr int SM_THREADS = 2048;  // resident threads an SM
constexpr int SM_CTAS = 32;  // resident CTAs an SM
constexpr int COUNT_MAX_WARPS = 16;  // count_errors' largest CTA, 512 threads
constexpr int COUNT_WARP_ROWS_BLOCK = 256;  // its CTA where a warp takes a row
constexpr int WARP_ROW_WORDS = 512;  // the longest row a warp takes, in words
constexpr int COUNT_MIN_CTAS = 4;  // CTAs of count_errors an SM holds at least
constexpr int COUNT_UNROLL = 4;  // 16-byte loads of a thread in flight

__device__ __forceinline__ int quantize_at(float sym, float n, float sigma,
                                           float factor, float sat) {
  const float y = __fadd_rn(sym, __fmul_rn(sigma, n));
  const float q = fminf(fmaxf(__fmul_rn(y, factor), -sat), sat);
  return __float2int_rz(q);
}

// The symbol of byte `byte` of the four bits in `word`: -amp in the
// all-zero form, else +amp for a nonzero byte.
template <bool kCoded>
__device__ __forceinline__ float symbol(unsigned word, int byte, float amp) {
  return kCoded && ((word >> (8 * byte)) & 0xffu) ? amp : -amp;
}

// Four LLRs into one 32-bit word, the first in the lowest byte; `bits`
// holds their four bits (read in the coded form only).
template <bool kCoded>
__device__ __forceinline__ unsigned quantize4(float4 v, unsigned bits,
                                              float sigma, float factor,
                                              float amp, float sat) {
  const unsigned a =
      quantize_at(symbol<kCoded>(bits, 0, amp), v.x, sigma, factor, sat) & 0xff;
  const unsigned b =
      quantize_at(symbol<kCoded>(bits, 1, amp), v.y, sigma, factor, sat) & 0xff;
  const unsigned c =
      quantize_at(symbol<kCoded>(bits, 2, amp), v.z, sigma, factor, sat) & 0xff;
  const unsigned d =
      quantize_at(symbol<kCoded>(bits, 3, amp), v.w, sigma, factor, sat) & 0xff;
  return a | (b << 8) | (c << 16) | (d << 24);
}

template <bool kCoded>
__device__ __forceinline__ void awgn_quantize_body(
    const float* __restrict__ noise, const uint8_t* __restrict__ bits,
    int8_t* __restrict__ llr, long long n, const float* __restrict__ scalars,
    float amp, float sat) {
  const float sigma = __ldg(scalars);
  const float factor = __ldg(scalars + 1);
  const long long n16 = n / 16;
  const long long first = static_cast<long long>(blockIdx.x) * AWGN_BLOCK +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * AWGN_BLOCK;
  const float4* src = reinterpret_cast<const float4*>(noise);
  uint4* dst = reinterpret_cast<uint4*>(llr);
  for (long long i = first; i < n16; i += stride) {
    const float4 v0 = __ldcs(src + 4 * i);
    const float4 v1 = __ldcs(src + 4 * i + 1);
    const float4 v2 = __ldcs(src + 4 * i + 2);
    const float4 v3 = __ldcs(src + 4 * i + 3);
    const uint4 b = kCoded ? __ldg(reinterpret_cast<const uint4*>(bits) + i)
                           : make_uint4(0, 0, 0, 0);
    uint4 out;
    out.x = quantize4<kCoded>(v0, b.x, sigma, factor, amp, sat);
    out.y = quantize4<kCoded>(v1, b.y, sigma, factor, amp, sat);
    out.z = quantize4<kCoded>(v2, b.z, sigma, factor, amp, sat);
    out.w = quantize4<kCoded>(v3, b.w, sigma, factor, amp, sat);
    dst[i] = out;
  }
  const long long t = 16 * n16 + first;
  if (t < n) {
    const float sym = kCoded && bits[t] ? amp : -amp;
    llr[t] = static_cast<int8_t>(quantize_at(sym, noise[t], sigma, factor,
                                             sat));
  }
}

__global__ void __launch_bounds__(AWGN_BLOCK)
awgn_quantize_kernel(const float* __restrict__ noise,
                     int8_t* __restrict__ llr, long long n,
                     const float* __restrict__ scalars, float amp,
                     float sat) {
  awgn_quantize_body<false>(noise, nullptr, llr, n, scalars, amp, sat);
}

__global__ void __launch_bounds__(AWGN_BLOCK)
awgn_quantize_coded_kernel(const float* __restrict__ noise,
                           const uint8_t* __restrict__ bits,
                           int8_t* __restrict__ llr, long long n,
                           const float* __restrict__ scalars, float amp,
                           float sat) {
  awgn_quantize_body<true>(noise, bits, llr, n, scalars, amp, sat);
}

// Nonzero bytes of a 16-byte word, times 8.
__device__ __forceinline__ unsigned nonzero8(uint4 w) {
  return __popc(__vcmpne4(w.x, 0u)) + __popc(__vcmpne4(w.y, 0u)) +
         __popc(__vcmpne4(w.z, 0u)) + __popc(__vcmpne4(w.w, 0u));
}

// Bytes that differ between two 16-byte words, as their XOR.
__device__ __forceinline__ uint4 xor16(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// This thread's share of the nonzero bytes among the first `cols` bytes of
// `row` (with kRef: of the bytes that differ from `ref`'s, which lies at
// the same offset from a 16-byte boundary), which `lanes` threads count
// together (this one is `lane`): the bytes before the first 16-byte
// boundary and after the last one a thread each, the 16-byte words
// between them COUNT_UNROLL loads at a time in flight.
template <bool kRef>
__device__ __forceinline__ unsigned row_share(const uint8_t* row,
                                              const uint8_t* ref,
                                              long long cols, int lane,
                                              int lanes) {
  const long long head = min(
      cols, static_cast<long long>(
                (16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
  const long long n16 = (cols - head) / 16;
  const long long tail = cols - head - 16 * n16;
  const long long last = head + 16 * n16 + lane;
  unsigned c = 0;
  if (lane < head) c += row[lane] != (kRef ? ref[lane] : 0);
  if (lane < tail) c += row[last] != (kRef ? ref[last] : 0);
  const uint4* words = reinterpret_cast<const uint4*>(row + head);
  const uint4* refs =
      kRef ? reinterpret_cast<const uint4*>(ref + head) : nullptr;
  unsigned c8 = 0;
  for (long long i = lane; i < n16; i += COUNT_UNROLL * lanes) {
    uint4 w[COUNT_UNROLL];
#pragma unroll
    for (int j = 0; j < COUNT_UNROLL; ++j) {
      const long long k = i + static_cast<long long>(j) * lanes;
      w[j] = k < n16 ? __ldcs(words + k) : make_uint4(0, 0, 0, 0);
      if (kRef && k < n16) w[j] = xor16(w[j], __ldcs(refs + k));
    }
#pragma unroll
    for (int j = 0; j < COUNT_UNROLL; ++j) c8 += nonzero8(w[j]);
  }
  return c + (c8 >> 3);
}

// The count of a CTA's rows, added to `out`; kWarpRows: a warp a row,
// else the CTA a row (see the top of the file); kRef: against `ref`'s
// rows, `ref_stride` bytes apart.
template <bool kWarpRows, bool kRef>
__device__ __forceinline__ void count_rows(const uint8_t* __restrict__ bits,
                                           long long stride,
                                           const uint8_t* __restrict__ ref,
                                           long long ref_stride,
                                           long long rows, long long cols,
                                           unsigned long long* __restrict__ out) {
  __shared__ unsigned part[2][COUNT_MAX_WARPS];
  __shared__ unsigned long long sums[2][COUNT_MAX_WARPS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, warps = blockDim.x >> 5;
  const int lanes = kWarpRows ? 32 : blockDim.x;
  const int group = kWarpRows ? warp : 0;  // the row of the CTA's rows
  const int at_once = kWarpRows ? warps : 1;
  unsigned long long be = 0;  // a row's first thread: its rows' sums
  unsigned long long fe = 0;
  int parity = 0;
  for (long long r0 = static_cast<long long>(blockIdx.x) * at_once; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * at_once, parity ^= 1) {
    const long long r = r0 + group;
    unsigned c = r < rows ? row_share<kRef>(bits + r * stride,
                                            kRef ? ref + r * ref_stride
                                                 : nullptr,
                                            cols, tid % lanes, lanes)
                          : 0;
    c = __reduce_add_sync(0xffffffffu, c);
    if (!kWarpRows) {
      if ((tid & 31) == 0) part[parity][warp] = c;
      __syncthreads();
      c = 0;
      if (tid == 0)
        for (int k = 0; k < warps; ++k) c += part[parity][k];
    }
    if (tid % lanes == 0) {
      be += c;
      fe += c != 0;
    }
  }
  if ((tid & 31) == 0) {
    sums[0][warp] = be;
    sums[1][warp] = fe;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < warps; ++k) {
      be += sums[0][k];
      fe += sums[1][k];
    }
    if (be) atomicAdd(out, be);
    if (fe) atomicAdd(out + 1, fe);
  }
}

template <bool kWarpRows>
__global__ void __launch_bounds__(kWarpRows ? COUNT_WARP_ROWS_BLOCK
                                            : COUNT_MAX_WARPS * 32,
                                  COUNT_MIN_CTAS)
count_errors_kernel(const uint8_t* __restrict__ bits, long long rows,
                    long long stride, long long cols,
                    unsigned long long* __restrict__ out) {
  count_rows<kWarpRows, false>(bits, stride, nullptr, 0, rows, cols, out);
}

template <bool kWarpRows>
__global__ void __launch_bounds__(kWarpRows ? COUNT_WARP_ROWS_BLOCK
                                            : COUNT_MAX_WARPS * 32,
                                  COUNT_MIN_CTAS)
count_errors_ref_kernel(const uint8_t* __restrict__ bits,
                        const uint8_t* __restrict__ ref, long long rows,
                        long long stride, long long ref_stride,
                        long long cols, unsigned long long* __restrict__ out) {
  count_rows<kWarpRows, true>(bits, stride, ref, ref_stride, rows, cols, out);
}

// The current device's SM count, 0 where it cannot be read.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The grid of awgn_quantize over n elements: the current device's SMs x
// the CTAs an SM holds, or fewer where n needs fewer; 0 where the SM count
// cannot be read.
unsigned awgn_grid(long long n) {
  const int sms = sm_count();
  if (sms <= 0) return 0;
  const long long need = (n / 16 + AWGN_BLOCK - 1) / AWGN_BLOCK;
  const long long full = static_cast<long long>(sms) *
                         (SM_THREADS / AWGN_BLOCK);
  return static_cast<unsigned>(need < 1 ? 1 : need < full ? need : full);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The count's launch: the output zeroed on `st`, then one kernel (kRef:
// against `ref`).
template <bool kRef>
int launch_count(const void* bits, long long stride, const void* ref,
                 long long ref_stride, long long rows, long long cols,
                 void* out, cudaStream_t st) {
  const int sms = sm_count();
  if (rows <= 0 || cols < 0 || cols > stride || sms <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(long long), st);
  if (err != cudaSuccess) return err;
  const uint8_t* b = static_cast<const uint8_t*>(bits);
  const uint8_t* r = static_cast<const uint8_t*>(ref);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const long long words = cols / 16;
  if (words <= WARP_ROW_WORDS) {
    const int T = COUNT_WARP_ROWS_BLOCK, at_once = T / 32;
    const long long need = (rows + at_once - 1) / at_once;
    const long long full = static_cast<long long>(sms) * (SM_THREADS / T);
    const unsigned grid = static_cast<unsigned>(need < full ? need : full);
    if constexpr (kRef)
      count_errors_ref_kernel<true><<<grid, T, 0, st>>>(
          b, r, rows, stride, ref_stride, cols, o);
    else
      count_errors_kernel<true><<<grid, T, 0, st>>>(b, rows, stride, cols, o);
  } else {
    int T = 64;  // the least of 64-512 threads that reads a row in 8 words each
    while (T < COUNT_MAX_WARPS * 32 && 8LL * T < words) T *= 2;
    const long long full = static_cast<long long>(sms) *
                           min(SM_CTAS, SM_THREADS / T);
    const unsigned grid = static_cast<unsigned>(rows < full ? rows : full);
    if constexpr (kRef)
      count_errors_ref_kernel<false><<<grid, T, 0, st>>>(
          b, r, rows, stride, ref_stride, cols, o);
    else
      count_errors_kernel<false><<<grid, T, 0, st>>>(b, rows, stride, cols, o);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// LLRs of the n elements of `noise` into `llr` (int8), with sigma and the
// factor at scalars[0] and scalars[1] (device memory), on `stream`, over a
// grid of the current device's SMs x the CTAs an SM holds.  Both pointers
// on a 16-byte boundary.  Returns a cudaError_t (0 on success).
int awgn_quantize_launch(const void* noise, void* llr, long long n,
                         const void* scalars, float amp, float sat,
                         void* stream) {
  const unsigned grid = awgn_grid(n);
  if (n <= 0 || grid == 0 || !aligned16(noise) || !aligned16(llr))
    return cudaErrorInvalidValue;
  awgn_quantize_kernel<<<grid, AWGN_BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(noise), static_cast<int8_t*>(llr), n,
      static_cast<const float*>(scalars), amp, sat);
  return cudaGetLastError();
}

// The same for the n coded bits `bits` (one byte a bit, nonzero for 1):
// each LLR's symbol is +amp for a 1, -amp for a 0.  The three pointers on
// a 16-byte boundary.
int awgn_quantize_coded_launch(const void* noise, const void* bits,
                               void* llr, long long n, const void* scalars,
                               float amp, float sat, void* stream) {
  const unsigned grid = awgn_grid(n);
  if (n <= 0 || grid == 0 || !aligned16(noise) || !aligned16(bits) ||
      !aligned16(llr))
    return cudaErrorInvalidValue;
  awgn_quantize_coded_kernel<<<grid, AWGN_BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(noise), static_cast<const uint8_t*>(bits),
      static_cast<int8_t*>(llr), n, static_cast<const float*>(scalars), amp,
      sat);
  return cudaGetLastError();
}

// (BE, FE) of the first `cols` columns of the `rows` rows of `bits` (one
// byte a bit, rows `stride` bytes apart) into out[0], out[1] (int64), on
// `stream`: the output is zeroed there, then one kernel counts.
int count_errors_launch(const void* bits, long long rows, long long stride,
                        long long cols, void* out, void* stream) {
  return launch_count<false>(bits, stride, nullptr, 0, rows, cols, out,
                             static_cast<cudaStream_t>(stream));
}

// The same against the reference frames `ref` (rows `ref_stride` bytes
// apart): the bytes that differ.  Each reference row at the same offset
// from a 16-byte boundary as its frame's row.
int count_errors_ref_launch(const void* bits, const void* ref,
                            long long rows, long long stride,
                            long long ref_stride, long long cols, void* out,
                            void* stream) {
  if (cols > ref_stride ||
      ((reinterpret_cast<uintptr_t>(bits) - reinterpret_cast<uintptr_t>(ref)) &
       15) ||
      (rows > 1 && ((stride - ref_stride) & 15)))
    return cudaErrorInvalidValue;
  return launch_count<true>(bits, stride, ref, ref_stride, rows, cols, out,
                            static_cast<cudaStream_t>(stream));
}

const char* channel_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
