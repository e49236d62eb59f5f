// Block-quantization (bq) codec kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/bq.py:
//   bq_encode          <- bq_encode_pallas        (_encode_kernel, _encode24_kernel)
//   bq_decode          <- bq_decode_pallas        (_decode_kernel, _decode24_kernel)
//   bq_gather_decode   <- bq_gather_decode_pallas (XLA gather + bq_decode_pallas)
//   bq_decode_add_encode <- bq_decode_add_encode_pallas (_dae_kernel, _dae24_kernel
//                           with the sum; _daew_kernel, _daew24_kernel wire-only)
//   bq_decode_add      <- bq_decode_add_pallas    (_da_kernel, _da24_kernel)
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
// The fused ring hops read the received wire row and the local f32 row once
// each, decode and add in registers and re-encode from registers; the
// wire-only form never writes the f32 sum at all.
//
// Arithmetic is pinned to IEEE round-to-nearest so the result is bit-exact
// with the plain PyTorch version (repro_torch/kernels/ref.py):
//   q = clip(rint((x / scale) * qmax), -qmax, qmax)   (__fdiv_rn, __fmul_rn)
//   x = q * (scale * inv_qmax)                         (__fmul_rn)
//   s = x + local                                      (__fadd_rn)
// The fused ring hops spell the multiply and the add out as separate
// round-to-nearest intrinsics, so nvcc cannot contract them into an FMA
// (which would round once instead of twice and break bit-equality).
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

// A NaN (an overflowed sum's inf / inf) stays NaN through the clamp, as in
// torch.clamp, and converts to 0 like the plain version's cast on the card.
__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  float q = rintf(__fmul_rn(__fdiv_rn(x, scale), qmax));
  if (q == q) q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int>(q);
}

__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + (threadIdx.x >> 5);
}

// Store the four mantissas of one lane into wire row `row`.
template <int BITS>
__device__ __forceinline__ void store_q(void* __restrict__ q_hi,
                                        uint8_t* __restrict__ q_lo,
                                        long long row, int lane,
                                        int q0, int q1, int q2, int q3) {
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

// Load the four mantissas of one lane from wire row `row`.
template <int BITS>
__device__ __forceinline__ int4 load_q(const void* __restrict__ q_hi,
                                       const uint8_t* __restrict__ q_lo,
                                       long long row, int lane) {
  if constexpr (BITS == 4) {
    const uchar2 p = reinterpret_cast<const uchar2*>(
        static_cast<const uint8_t*>(q_hi) + row * (BLOCK / 2))[lane];
    return make_int4((p.x >> 4) - 8, (p.x & 0xF) - 8,
                     (p.y >> 4) - 8, (p.y & 0xF) - 8);
  } else if constexpr (BITS == 8) {
    const char4 p = reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(q_hi) + row * BLOCK)[lane];
    return make_int4(p.x, p.y, p.z, p.w);
  } else if constexpr (BITS == 16) {
    const short4 p = reinterpret_cast<const short4*>(
        static_cast<const int16_t*>(q_hi) + row * BLOCK)[lane];
    return make_int4(p.x, p.y, p.z, p.w);
  } else {
    const short4 h = reinterpret_cast<const short4*>(
        static_cast<const int16_t*>(q_hi) + row * BLOCK)[lane];
    const uchar4 l = reinterpret_cast<const uchar4*>(q_lo + row * BLOCK)[lane];
    return make_int4(h.x * 256 + l.x, h.y * 256 + l.y,
                     h.z * 256 + l.z, h.w * 256 + l.w);
  }
}

// Decoded values of one lane of wire row `row`: q * (scale * inv_qmax).
template <int BITS>
__device__ __forceinline__ float4 decode4(const void* __restrict__ q_hi,
                                          const uint8_t* __restrict__ q_lo,
                                          const float* __restrict__ scale,
                                          long long row, int lane,
                                          float inv_qmax) {
  const float mul = __fmul_rn(scale[row], inv_qmax);
  const int4 q = load_q<BITS>(q_hi, q_lo, row, lane);
  return make_float4(
      __fmul_rn(static_cast<float>(q.x), mul), __fmul_rn(static_cast<float>(q.y), mul),
      __fmul_rn(static_cast<float>(q.z), mul), __fmul_rn(static_cast<float>(q.w), mul));
}

// Encode one lane's four values of row `row`: per-row max-abs by warp
// shuffle (1.0 for an all-zero row), then quantize and store.
template <int BITS>
__device__ __forceinline__ void encode4(float4 v, void* __restrict__ q_hi,
                                        uint8_t* __restrict__ q_lo,
                                        float* __restrict__ scale,
                                        long long row, int lane, float qmax) {
  float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                     fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax == 0.0f ? 1.0f : amax;
  if (lane == 0) scale[row] = s;
  store_q<BITS>(q_hi, q_lo, row, lane, quantize(v.x, s, qmax),
                quantize(v.y, s, qmax), quantize(v.z, s, qmax),
                quantize(v.w, s, qmax));
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const float* __restrict__ x, void* __restrict__ q_hi,
              uint8_t* __restrict__ q_lo, float* __restrict__ scale,
              long long m, float qmax) {
  const long long row = warp_row();
  if (row >= m) return;                       // uniform across the warp
  const int lane = threadIdx.x & 31;
  const float4 v = reinterpret_cast<const float4*>(x + row * BLOCK)[lane];
  encode4<BITS>(v, q_hi, q_lo, scale, row, lane, qmax);
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const void* __restrict__ q_hi, const uint8_t* __restrict__ q_lo,
              const float* __restrict__ scale, float* __restrict__ out,
              long long m, float inv_qmax) {
  const long long row = warp_row();
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  reinterpret_cast<float4*>(out + row * BLOCK)[lane] =
      decode4<BITS>(q_hi, q_lo, scale, row, lane, inv_qmax);
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
  const long long row = warp_row();
  if (row >= n_idx * rows_per_block) return;
  const long long e = row / rows_per_block;
  const long long j = row - e * rows_per_block;
  const long long id = idx[e];
  float4 v;
  if (id < 0 || id >= n_blocks) {
    const float nan = __int_as_float(0x7fc00000);
    v = make_float4(nan, nan, nan, nan);
  } else {
    v = decode4<BITS>(q_hi, q_lo, scale, id * rows_per_block + j, lane,
                      inv_qmax);
  }
  reinterpret_cast<float4*>(out + row * BLOCK)[lane] = v;
}

// One fused ring hop: s = local + decode(wire), then encode(s) into the
// outgoing wire; WANT_SUM also stores s (the all-reduce tail's form).
template <int BITS, bool WANT_SUM>
__global__ void __launch_bounds__(THREADS)
decode_add_encode_kernel(const void* __restrict__ q_hi,
                         const uint8_t* __restrict__ q_lo,
                         const float* __restrict__ scale,
                         const float* __restrict__ local,
                         void* __restrict__ o_hi, uint8_t* __restrict__ o_lo,
                         float* __restrict__ o_scale, float* __restrict__ sum,
                         long long m, float qmax, float inv_qmax) {
  const long long row = warp_row();
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  const float4 d = decode4<BITS>(q_hi, q_lo, scale, row, lane, inv_qmax);
  const float4 l = reinterpret_cast<const float4*>(local + row * BLOCK)[lane];
  const float4 s = make_float4(__fadd_rn(d.x, l.x), __fadd_rn(d.y, l.y),
                               __fadd_rn(d.z, l.z), __fadd_rn(d.w, l.w));
  if constexpr (WANT_SUM)
    reinterpret_cast<float4*>(sum + row * BLOCK)[lane] = s;
  encode4<BITS>(s, o_hi, o_lo, o_scale, row, lane, qmax);
}

// The last reduce-scatter hop: local + decode(wire), no re-encode.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
decode_add_kernel(const void* __restrict__ q_hi, const uint8_t* __restrict__ q_lo,
                  const float* __restrict__ scale,
                  const float* __restrict__ local, float* __restrict__ out,
                  long long m, float inv_qmax) {
  const long long row = warp_row();
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  const float4 d = decode4<BITS>(q_hi, q_lo, scale, row, lane, inv_qmax);
  const float4 l = reinterpret_cast<const float4*>(local + row * BLOCK)[lane];
  reinterpret_cast<float4*>(out + row * BLOCK)[lane] =
      make_float4(__fadd_rn(d.x, l.x), __fadd_rn(d.y, l.y),
                  __fadd_rn(d.z, l.z), __fadd_rn(d.w, l.w));
}

inline unsigned grid_for(long long rows) {
  return static_cast<unsigned>((rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
}

// Dispatch a launch over the runtime rate: LAUNCH(B) is expanded with B the
// compile-time rate.
#define BQ_BY_BITS(bits, LAUNCH)                                 \
  switch (bits) {                                                \
    case 4: LAUNCH(4); break;                                    \
    case 8: LAUNCH(8); break;                                    \
    case 16: LAUNCH(16); break;                                  \
    case 24: LAUNCH(24); break;                                  \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }                                                              \
  return static_cast<int>(cudaGetLastError())

}  // namespace

extern "C" {

int bq_encode(const float* x, void* q_hi, uint8_t* q_lo, float* scale,
              long long m, int bits, float qmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define L(B) encode_kernel<B><<<grid_for(m), THREADS, 0, s>>>(x, q_hi, q_lo, scale, m, qmax)
  BQ_BY_BITS(bits, L);
#undef L
}

int bq_decode(const void* q_hi, const uint8_t* q_lo, const float* scale,
              float* out, long long m, int bits, float inv_qmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define L(B) decode_kernel<B><<<grid_for(m), THREADS, 0, s>>>(q_hi, q_lo, scale, out, m, inv_qmax)
  BQ_BY_BITS(bits, L);
#undef L
}

int bq_gather_decode(const void* q_hi, const uint8_t* q_lo, const float* scale,
                     const int32_t* idx, long long n_idx, long long n_blocks,
                     long long rows_per_block, float* out, int bits,
                     float inv_qmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define L(B)                                                                 \
  gather_decode_kernel<B><<<grid_for(n_idx * rows_per_block), THREADS, 0, s>>>( \
      q_hi, q_lo, scale, idx, n_idx, n_blocks, rows_per_block, out, inv_qmax)
  BQ_BY_BITS(bits, L);
#undef L
}

// `sum` null selects the wire-only form.
int bq_decode_add_encode(const void* q_hi, const uint8_t* q_lo,
                         const float* scale, const float* local, void* o_hi,
                         uint8_t* o_lo, float* o_scale, float* sum,
                         long long m, int bits, float qmax, float inv_qmax,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define L(B)                                                                   \
  if (sum != nullptr)                                                           \
    decode_add_encode_kernel<B, true><<<grid_for(m), THREADS, 0, s>>>(          \
        q_hi, q_lo, scale, local, o_hi, o_lo, o_scale, sum, m, qmax, inv_qmax); \
  else                                                                          \
    decode_add_encode_kernel<B, false><<<grid_for(m), THREADS, 0, s>>>(         \
        q_hi, q_lo, scale, local, o_hi, o_lo, o_scale, sum, m, qmax, inv_qmax)
  BQ_BY_BITS(bits, L);
#undef L
}

int bq_decode_add(const void* q_hi, const uint8_t* q_lo, const float* scale,
                  const float* local, float* out, long long m, int bits,
                  float inv_qmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define L(B)                                                      \
  decode_add_kernel<B><<<grid_for(m), THREADS, 0, s>>>(q_hi, q_lo, scale, \
                                                       local, out, m, inv_qmax)
  BQ_BY_BITS(bits, L);
#undef L
}

}  // extern "C"
