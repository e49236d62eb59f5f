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
//
// All kernels are memory-bound (a few flops per byte): the bound on an H100
// is bytes moved over 3.35 TB/s.  Each reads every input byte once and
// writes every output byte once with coalesced vector accesses; nothing is
// staged through shared memory.
//
// Encode and decode (one kernel each, for the block form and the flat
// form).  A lane moves 16 bytes of payload: 4 f32 values (a warp per row)
// or 8 bf16 / f16 values (a half-warp per row); the grid covers every row
// at once.  On the main path they run on the TP all-gather's activations
// (1179648 bf16 values, 4.8-9.5 MB a call), where a call with a cold L2 is
// held by the DRAM round trip and the ramp of its grid more than by
// bandwidth.  So the design moves fewer bytes and issues fewer
// instructions per value:
//   * the flat form fuses the layout work around the codec into the
//     kernel.  Encode reads the payload in its own type (bf16 and f16
//     converted to f32 in registers, exactly) and reads positions past its
//     end as 0, so no f32 copy and no padded copy is written first.
//     Decode writes the payload's type (rounded to nearest even) straight
//     to its place in the gathered tensor: shard s's value f goes to
//     (f / inner) * shards * inner + s * inner + f % inner, so no f32
//     blocks, no cast and no movedim copy are written, and the tile
//     padding is never read;
//   * the encode's quantize drops the clamp, which never binds (the scale
//     is the row's own max-abs), and rounds in the conversion: at the
//     path's shape the fused encode went from 4.07 to 3.72 us of kernel
//     time, so the instructions issued after the data lands are part of
//     its time.
// Tried and dropped, both slower in probe runs at the path's shapes: a
// persistent one-wave grid in which each thread issues the loads of its
// next 2-4 rows before reducing any (and 8 values a lane for f32); and a
// per-row reciprocal with an exact check in place of the IEEE divide
// (more instructions than the divide's own fast path: 4.34 us).
// On an H100 80GB HBM3 at 700 W with the L2 flushed (chip_smoke.py), the
// fused encode takes 3.72 us (38 % of its 1.42 us byte bound) where the
// cast, padded copy and block encode it replaces take 12.9 us of kernels,
// and the fused decode 5.0-5.4 us (52-56 % of 2.84 us) where the block
// decode, cast and movedim copy take 17 us.  The block forms keep the
// parent's times (4.8 / 6.6 us at 9216 / 18432 rows, rate 16).
// The fused ring hops (decode_add_encode, decode_add) and the gather-decode
// give one warp a row (a lane owns 4 values, encode4/decode4).  The
// gather-decode reads the block table inside the kernel, so the compressed
// pool rows are never copied into a gathered temporary first (the TPU
// version gathers in XLA, then decodes).  The fused ring hops read the
// received wire row and the local f32 row once each, decode and add in
// registers and re-encode from registers; the wire-only form never writes
// the f32 sum at all.
//
// Arithmetic is pinned to IEEE round-to-nearest so the result is bit-exact
// with the plain PyTorch version (repro_torch/kernels/ref.py):
//   q = clip(rint((x / scale) * qmax), -qmax, qmax)   (__fdiv_rn, __fmul_rn)
//   x = q * (scale * inv_qmax)                         (__fmul_rn)
//   s = x + local                                      (__fadd_rn)
// The fused ring hops spell the multiply and the add out as separate
// round-to-nearest intrinsics, so nvcc cannot contract them into an FMA
// (which would round once instead of twice and break bit-equality).  The
// row max-abs is exact in any order, so the half-warp and the warp
// reductions give the same scale.  The quantize of a row by its own
// max-abs needs no clamp: |x / scale| <= 1.
// Build without --use_fast_math.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// quantize where scale is the max-abs of x's own row: |x / scale| <= 1,
// so the clamp never binds, and the one conversion rounds half to even
// (a NaN x converts to 0 either way).  Fewer instructions per value than
// quantize, for the same integers.
__device__ __forceinline__ int quantize_in_row(float x, float scale,
                                               float qmax) {
  return __float2int_rn(__fmul_rn(__fdiv_rn(x, scale), qmax));
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

// --------------------------------------------------------------------------
// encode and decode (Pallas #1, #2), block form and flat form: one kernel
// each, templated on the payload type T.  A lane moves 16 bytes of payload,
// V = 16 / sizeof(T) consecutive values (4 of f32, 8 of bf16 or f16), so a
// row is 128 / V lanes (a warp for f32, a half-warp for the 16-bit types)
// and every payload load or store is one 16-byte access a lane.
// --------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16-bit payload bits <-> f32 (exact one way, rounded to nearest even the
// other)
template <typename T>
__device__ __forceinline__ float bits16_to_f32(uint32_t b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __uint_as_float(b << 16);
  else
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

template <typename T>
__device__ __forceinline__ uint32_t f32_to_bits16(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    return __half_as_ushort(__float2half_rn(v));
}

// Values [f0, f0 + V) of x as f32; positions at or past `n` read as 0 (the
// tile padding), so a row wholly past n reads nothing.  `vec`: x is 16-byte
// aligned, so a chunk wholly below n is one 16-byte load.
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* __restrict__ x, long long f0,
                                       long long n, bool vec, float (&v)[V]) {
  if (vec && f0 + V <= n) {
    const uint4 u = *reinterpret_cast<const uint4*>(x + f0);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (V == 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(w[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = bits16_to_f32<T>(w[k] & 0xFFFFu);
        v[2 * k + 1] = bits16_to_f32<T>(w[k] >> 16);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = f0 + j < n ? to_f32<T>(x[f0 + j]) : 0.0f;
}

// V values to out[i0 .. i0 + V), 16-byte aligned: one 16-byte store.
template <typename T, int V>
__device__ __forceinline__ void store_out(T* __restrict__ out, long long i0,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = f32_to_bits16<T>(v[2 * k]) | f32_to_bits16<T>(v[2 * k + 1]) << 16;
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint32_t pack_u8(int a, int b, int c, int d) {
  return (a & 0xFF) | (b & 0xFF) << 8 | (c & 0xFF) << 16 |
         static_cast<uint32_t>(d & 0xFF) << 24;
}

__device__ __forceinline__ uint32_t pack_u16(int a, int b) {
  return (a & 0xFFFF) | static_cast<uint32_t>(b & 0xFFFF) << 16;
}

// Store the V mantissas of lane `hl` (values V hl .. V hl + V - 1) of wire
// row `row`, in store_q's byte layout.
template <int BITS, int V>
__device__ __forceinline__ void store_qv(void* __restrict__ q_hi,
                                         uint8_t* __restrict__ q_lo,
                                         long long row, int hl,
                                         const int (&q)[V]) {
  if constexpr (V == 4) {
    store_q<BITS>(q_hi, q_lo, row, hl, q[0], q[1], q[2], q[3]);
  } else if constexpr (BITS == 4) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w |= static_cast<uint32_t>(((q[2 * k] + 8) << 4) | (q[2 * k + 1] + 8))
           << (8 * k);
    reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(q_hi) +
                                row * (BLOCK / 2))[hl] = w;
  } else if constexpr (BITS == 8) {
    reinterpret_cast<uint2*>(static_cast<int8_t*>(q_hi) + row * BLOCK)[hl] =
        make_uint2(pack_u8(q[0], q[1], q[2], q[3]),
                   pack_u8(q[4], q[5], q[6], q[7]));
  } else if constexpr (BITS == 16) {
    reinterpret_cast<uint4*>(static_cast<int16_t*>(q_hi) + row * BLOCK)[hl] =
        make_uint4(pack_u16(q[0], q[1]), pack_u16(q[2], q[3]),
                   pack_u16(q[4], q[5]), pack_u16(q[6], q[7]));
  } else {
    reinterpret_cast<uint4*>(static_cast<int16_t*>(q_hi) + row * BLOCK)[hl] =
        make_uint4(pack_u16(q[0] >> 8, q[1] >> 8), pack_u16(q[2] >> 8, q[3] >> 8),
                   pack_u16(q[4] >> 8, q[5] >> 8), pack_u16(q[6] >> 8, q[7] >> 8));
    reinterpret_cast<uint2*>(q_lo + row * BLOCK)[hl] =
        make_uint2(pack_u8(q[0], q[1], q[2], q[3]),
                   pack_u8(q[4], q[5], q[6], q[7]));
  }
}

// Load the V mantissas of lane `hl` of wire row `row` (load_q's arithmetic).
template <int BITS, int V>
__device__ __forceinline__ void load_qv(const void* __restrict__ q_hi,
                                        const uint8_t* __restrict__ q_lo,
                                        long long row, int hl, int (&q)[V]) {
  if constexpr (V == 4) {
    const int4 r = load_q<BITS>(q_hi, q_lo, row, hl);
    q[0] = r.x; q[1] = r.y; q[2] = r.z; q[3] = r.w;
  } else if constexpr (BITS == 4) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(
        static_cast<const uint8_t*>(q_hi) + row * (BLOCK / 2))[hl];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = (w >> (8 * k)) & 0xFF;
      q[2 * k] = (b >> 4) - 8;
      q[2 * k + 1] = (b & 0xF) - 8;
    }
  } else if constexpr (BITS == 8) {
    const uint2 w = reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(q_hi) + row * BLOCK)[hl];
    const uint32_t h[2] = {w.x, w.y};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      q[j] = static_cast<int8_t>((h[j / 4] >> (8 * (j % 4))) & 0xFF);
  } else {
    const uint4 w = reinterpret_cast<const uint4*>(
        static_cast<const int16_t*>(q_hi) + row * BLOCK)[hl];
    const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      q[j] = static_cast<int16_t>((h[j / 2] >> (16 * (j % 2))) & 0xFFFF);
    if constexpr (BITS == 24) {
      const uint2 l2 = reinterpret_cast<const uint2*>(q_lo + row * BLOCK)[hl];
      const uint32_t l[2] = {l2.x, l2.y};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        q[j] = q[j] * 256 + static_cast<int>((l[j / 4] >> (8 * (j % 4))) & 0xFF);
    }
  }
}

// n values of x (f32, bf16 or f16) -> m rows of wire; row r is values
// [128 r, 128 r + 128) and values at or past n are 0.  A row is 128 / V
// lanes; its max-abs is a shuffle reduction over them (1.0 for an all-zero
// row).  A warp's rows past m load nothing and store nothing, but take part
// in the shuffles.
template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const T* __restrict__ x, long long n, int vec,
              void* __restrict__ q_hi, uint8_t* __restrict__ q_lo,
              float* __restrict__ scale, long long m, float qmax) {
  constexpr int V = 16 / sizeof(T), LANES = BLOCK / V;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int hl = threadIdx.x % LANES;
  if ((t & ~31ll) / LANES >= m) return;       // uniform across the warp
  const long long row = t / LANES;
  const bool live = row < m;
  float v[V];
  load_x<T, V>(x, row * BLOCK + hl * V, live ? n : 0, vec, v);
  float amax = fabsf(v[0]);
#pragma unroll
  for (int j = 1; j < V; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!live) return;
  const float s = amax == 0.0f ? 1.0f : amax;
  if (hl == 0) scale[row] = s;
  int q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) q[j] = quantize_in_row(v[j], s, qmax);
  store_qv<BITS, V>(q_hi, q_lo, row, hl, q);
}

// Wire of `shards` stacked encodes of n values each (shard s owns rows
// [s m, s m + m); blockIdx.y is the shard) -> out in T.  Shard s's value f
// goes to out[(f / inner) * shards * inner + s * inner + f % inner]: the
// shards joined along the axis whose trailing size is `inner` (with one
// shard, out[f]).  A thread decodes V values; the tile padding past n is
// never read.
template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const void* __restrict__ q_hi, const uint8_t* __restrict__ q_lo,
              const float* __restrict__ scale, T* __restrict__ out,
              long long m, long long n, long long inner, float inv_qmax) {
  constexpr int V = 16 / sizeof(T);
  const long long f0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (f0 >= n) return;
  const long long s = blockIdx.y, shards = gridDim.y;
  const long long row = s * m + f0 / BLOCK;
  int q[V];
  load_qv<BITS, V>(q_hi, q_lo, row, (f0 % BLOCK) / V, q);
  const float mul = __fmul_rn(scale[row], inv_qmax);
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __fmul_rn(static_cast<float>(q[j]), mul);
  // (o, i): f0's outer index and its place in the inner run; 32-bit
  // division where it fits
  long long o = 0, i = f0;
  if (shards > 1) {
    o = n <= 0xFFFFFFFFll
            ? static_cast<uint32_t>(f0) / static_cast<uint32_t>(inner)
            : f0 / inner;
    i = f0 - o * inner;
  }
  if (i + V <= inner && f0 + V <= n && (shards == 1 || inner % V == 0)) {
    store_out<T, V>(out, (o * shards + s) * inner + i, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {                // the ragged tail, or shards
    if (f0 + j >= n) break;                    // of odd width
    out[(o * shards + s) * inner + i] = from_f32<T>(v[j]);
    if (++i == inner) { i = 0; ++o; }
  }
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

template <typename T, int BITS>
int launch_encode(const void* x, long long n, int vec, void* q_hi,
                  uint8_t* q_lo, float* scale, long long m, float qmax,
                  cudaStream_t s) {
  constexpr long long rows_per_block = THREADS / (BLOCK / (16 / sizeof(T)));
  encode_kernel<T, BITS><<<static_cast<unsigned>(
                               (m + rows_per_block - 1) / rows_per_block),
                           THREADS, 0, s>>>(
      static_cast<const T*>(x), n, vec, q_hi, q_lo, scale, m, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
int launch_decode(const void* q_hi, const uint8_t* q_lo, const float* scale,
                  void* out, long long m, long long n, long long shards,
                  long long inner, float inv_qmax, cudaStream_t s) {
  constexpr long long vals_per_block = THREADS * (16 / sizeof(T));
  const dim3 grid(static_cast<unsigned>((n + vals_per_block - 1) /
                                        vals_per_block),
                  static_cast<unsigned>(shards));
  decode_kernel<T, BITS><<<grid, THREADS, 0, s>>>(
      q_hi, q_lo, scale, static_cast<T*>(out), m, n, inner, inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch a launcher over the runtime value type (codes of kernels/bq.py
// _DTYPE_CODE) and rate.
#define BQ_BY_TYPE_AND_BITS(dtype, bits, FN, ...)                        \
  switch (dtype * 32 + bits) {                                           \
    case 0 * 32 + 4: return FN<float, 4>(__VA_ARGS__);                   \
    case 0 * 32 + 8: return FN<float, 8>(__VA_ARGS__);                   \
    case 0 * 32 + 16: return FN<float, 16>(__VA_ARGS__);                 \
    case 0 * 32 + 24: return FN<float, 24>(__VA_ARGS__);                 \
    case 1 * 32 + 4: return FN<__nv_bfloat16, 4>(__VA_ARGS__);           \
    case 1 * 32 + 8: return FN<__nv_bfloat16, 8>(__VA_ARGS__);           \
    case 1 * 32 + 16: return FN<__nv_bfloat16, 16>(__VA_ARGS__);         \
    case 1 * 32 + 24: return FN<__nv_bfloat16, 24>(__VA_ARGS__);         \
    case 2 * 32 + 4: return FN<__half, 4>(__VA_ARGS__);                  \
    case 2 * 32 + 8: return FN<__half, 8>(__VA_ARGS__);                  \
    case 2 * 32 + 16: return FN<__half, 16>(__VA_ARGS__);                \
    case 2 * 32 + 24: return FN<__half, 24>(__VA_ARGS__);                \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }

}  // namespace

extern "C" {

// n values of x (dtype 0 f32, 1 bf16, 2 f16) -> m rows of wire; values at
// or past n encode as 0.  `vec`: x is 16-byte aligned.  The block form is
// dtype 0 with n = 128 m.
int bq_encode(const void* x, int dtype, long long n, int vec, void* q_hi,
              uint8_t* q_lo, float* scale, long long m, int bits, float qmax,
              void* stream) {
  BQ_BY_TYPE_AND_BITS(dtype, bits, launch_encode, x, n, vec, q_hi, q_lo,
                      scale, m, qmax, static_cast<cudaStream_t>(stream))
}

// Wire of `shards` x m rows -> shards x n values in dtype (0 f32, 1 bf16,
// 2 f16), shard s's value f at (f / inner) * shards * inner + s * inner +
// f % inner.  The block form is dtype 0, one shard, n = inner = 128 m.
int bq_decode(const void* q_hi, const uint8_t* q_lo, const float* scale,
              void* out, int dtype, long long m, long long n,
              long long shards, long long inner, int bits, float inv_qmax,
              void* stream) {
  BQ_BY_TYPE_AND_BITS(dtype, bits, launch_decode, q_hi, q_lo, scale, out, m,
                      n, shards, inner, inv_qmax,
                      static_cast<cudaStream_t>(stream))
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
