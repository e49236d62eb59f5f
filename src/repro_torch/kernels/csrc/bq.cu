// Block-quantization (bq) codec kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/bq.py:
//   bq_encode          <- bq_encode_pallas        (_encode_kernel, _encode24_kernel)
//   bq_decode          <- bq_decode_pallas        (_decode_kernel, _decode24_kernel)
//   bq_gather_decode   <- bq_gather_decode_pallas (XLA gather + bq_decode_pallas)
//
// Layout: a row is BLOCK = 128 consecutive f32 values with one f32 scale.
// One warp owns one row; each lane holds four consecutive values, so every
// load and store is one vector access per lane, neighbouring lanes on
// neighbouring addresses.  The per-row max-abs is a warp-shuffle reduction.
//
// All kernels are memory-bound (a few flops per byte): the bound on an H100
// is bytes moved over 3.35 TB/s.  The design reads each input byte once and
// writes each output byte once with coalesced vector accesses; nothing is
// staged through shared memory.  The gather-decode reads the block table
// inside the kernel, so the compressed pool rows are never copied into a
// gathered temporary first (the TPU version gathers in XLA, then decodes).
//
// Arithmetic is pinned to IEEE round-to-nearest so the result is bit-exact
// with the plain PyTorch version (repro_torch/kernels/ref.py):
//   q = clip(rint((x / scale) * qmax), -qmax, qmax)   (__fdiv_rn, __fmul_rn)
//   x = q * (scale * inv_qmax)                         (__fmul_rn)
// Build without --use_fast_math.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int ROWS_PER_CTA = 8;               // 8 warps of 32 lanes
constexpr int THREADS = ROWS_PER_CTA * 32;

__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  float q = rintf(__fmul_rn(__fdiv_rn(x, scale), qmax));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int>(q);
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const float* __restrict__ x, void* __restrict__ q_hi,
              uint8_t* __restrict__ q_lo, float* __restrict__ scale,
              long long m, float qmax) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= m) return;                       // uniform across the warp
  const float4 v = reinterpret_cast<const float4*>(x + row * BLOCK)[lane];
  float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                     fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax == 0.0f ? 1.0f : amax;
  if (lane == 0) scale[row] = s;
  const int q0 = quantize(v.x, s, qmax), q1 = quantize(v.y, s, qmax);
  const int q2 = quantize(v.z, s, qmax), q3 = quantize(v.w, s, qmax);
  if constexpr (BITS == 4) {
    // first value of each pair in the high nibble
    uchar2 p;
    p.x = static_cast<unsigned char>(((q0 + 8) << 4) | (q1 + 8));
    p.y = static_cast<unsigned char>(((q2 + 8) << 4) | (q3 + 8));
    reinterpret_cast<uchar2*>(static_cast<uint8_t*>(q_hi) + row * (BLOCK / 2))[lane] = p;
  } else if constexpr (BITS == 8) {
    reinterpret_cast<char4*>(static_cast<int8_t*>(q_hi) + row * BLOCK)[lane] =
        make_char4(q0, q1, q2, q3);
  } else if constexpr (BITS == 16) {
    reinterpret_cast<short4*>(static_cast<int16_t*>(q_hi) + row * BLOCK)[lane] =
        make_short4(q0, q1, q2, q3);
  } else {
    // 24-bit mantissa: arithmetic shift for the int16 high plane, the low
    // byte unsigned
    reinterpret_cast<short4*>(static_cast<int16_t*>(q_hi) + row * BLOCK)[lane] =
        make_short4(q0 >> 8, q1 >> 8, q2 >> 8, q3 >> 8);
    reinterpret_cast<uchar4*>(q_lo + row * BLOCK)[lane] =
        make_uchar4(q0 & 0xFF, q1 & 0xFF, q2 & 0xFF, q3 & 0xFF);
  }
}

// Decode pool/wire row `src` into output row `dst` (one warp, four values
// per lane).
template <int BITS>
__device__ __forceinline__ void decode_row(const void* __restrict__ q_hi,
                                           const uint8_t* __restrict__ q_lo,
                                           const float* __restrict__ scale,
                                           long long src, float* __restrict__ out,
                                           long long dst, int lane,
                                           float inv_qmax) {
  const float mul = __fmul_rn(scale[src], inv_qmax);
  int q0, q1, q2, q3;
  if constexpr (BITS == 4) {
    const uchar2 p = reinterpret_cast<const uchar2*>(
        static_cast<const uint8_t*>(q_hi) + src * (BLOCK / 2))[lane];
    q0 = (p.x >> 4) - 8; q1 = (p.x & 0xF) - 8;
    q2 = (p.y >> 4) - 8; q3 = (p.y & 0xF) - 8;
  } else if constexpr (BITS == 8) {
    const char4 p = reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(q_hi) + src * BLOCK)[lane];
    q0 = p.x; q1 = p.y; q2 = p.z; q3 = p.w;
  } else if constexpr (BITS == 16) {
    const short4 p = reinterpret_cast<const short4*>(
        static_cast<const int16_t*>(q_hi) + src * BLOCK)[lane];
    q0 = p.x; q1 = p.y; q2 = p.z; q3 = p.w;
  } else {
    const short4 h = reinterpret_cast<const short4*>(
        static_cast<const int16_t*>(q_hi) + src * BLOCK)[lane];
    const uchar4 l = reinterpret_cast<const uchar4*>(q_lo + src * BLOCK)[lane];
    q0 = h.x * 256 + l.x; q1 = h.y * 256 + l.y;
    q2 = h.z * 256 + l.z; q3 = h.w * 256 + l.w;
  }
  reinterpret_cast<float4*>(out + dst * BLOCK)[lane] = make_float4(
      __fmul_rn(static_cast<float>(q0), mul), __fmul_rn(static_cast<float>(q1), mul),
      __fmul_rn(static_cast<float>(q2), mul), __fmul_rn(static_cast<float>(q3), mul));
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const void* __restrict__ q_hi, const uint8_t* __restrict__ q_lo,
              const float* __restrict__ scale, float* __restrict__ out,
              long long m, float inv_qmax) {
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= m) return;
  decode_row<BITS>(q_hi, q_lo, scale, row, out, row, threadIdx.x & 31, inv_qmax);
}

// Output row r = e * rows_per_block + j decodes pool row
// idx[e] * rows_per_block + j.  An id outside [0, n_blocks) reads nothing
// and decodes to NaN, so a bad table is loud and never reads out of bounds.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
gather_decode_kernel(const void* __restrict__ q_hi,
                     const uint8_t* __restrict__ q_lo,
                     const float* __restrict__ scale,
                     const int32_t* __restrict__ idx, long long n_idx,
                     long long n_blocks, long long rows_per_block,
                     float* __restrict__ out, float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= n_idx * rows_per_block) return;
  const long long e = row / rows_per_block;
  const long long j = row - e * rows_per_block;
  const long long id = idx[e];
  if (id < 0 || id >= n_blocks) {
    const float nan = __int_as_float(0x7fc00000);
    reinterpret_cast<float4*>(out + row * BLOCK)[lane] =
        make_float4(nan, nan, nan, nan);
    return;
  }
  decode_row<BITS>(q_hi, q_lo, scale, id * rows_per_block + j, out, row,
                   lane, inv_qmax);
}

inline unsigned grid_for(long long rows) {
  return static_cast<unsigned>((rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
}

}  // namespace

extern "C" {

int bq_encode(const float* x, void* q_hi, uint8_t* q_lo, float* scale,
              long long m, int bits, float qmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(m);
  switch (bits) {
    case 4: encode_kernel<4><<<g, THREADS, 0, s>>>(x, q_hi, q_lo, scale, m, qmax); break;
    case 8: encode_kernel<8><<<g, THREADS, 0, s>>>(x, q_hi, q_lo, scale, m, qmax); break;
    case 16: encode_kernel<16><<<g, THREADS, 0, s>>>(x, q_hi, q_lo, scale, m, qmax); break;
    case 24: encode_kernel<24><<<g, THREADS, 0, s>>>(x, q_hi, q_lo, scale, m, qmax); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int bq_decode(const void* q_hi, const uint8_t* q_lo, const float* scale,
              float* out, long long m, int bits, float inv_qmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(m);
  switch (bits) {
    case 4: decode_kernel<4><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, out, m, inv_qmax); break;
    case 8: decode_kernel<8><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, out, m, inv_qmax); break;
    case 16: decode_kernel<16><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, out, m, inv_qmax); break;
    case 24: decode_kernel<24><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, out, m, inv_qmax); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int bq_gather_decode(const void* q_hi, const uint8_t* q_lo, const float* scale,
                     const int32_t* idx, long long n_idx, long long n_blocks,
                     long long rows_per_block, float* out, int bits,
                     float inv_qmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(n_idx * rows_per_block);
  switch (bits) {
    case 4: gather_decode_kernel<4><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, idx, n_idx, n_blocks, rows_per_block, out, inv_qmax); break;
    case 8: gather_decode_kernel<8><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, idx, n_idx, n_blocks, rows_per_block, out, inv_qmax); break;
    case 16: gather_decode_kernel<16><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, idx, n_idx, n_blocks, rows_per_block, out, inv_qmax); break;
    case 24: gather_decode_kernel<24><<<g, THREADS, 0, s>>>(q_hi, q_lo, scale, idx, n_idx, n_blocks, rows_per_block, out, inv_qmax); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
