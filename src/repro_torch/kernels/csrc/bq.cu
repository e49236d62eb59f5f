// Block-quantization (bq) codec kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/bq.py:
//   bq_encode          <- bq_encode_pallas        (_encode_kernel, _encode24_kernel)
//   bq_decode          <- bq_decode_pallas        (_decode_kernel, _decode24_kernel)
//   bq_gather_decode   <- bq_gather_decode_pallas (XLA gather + bq_decode_pallas)
//                         (in f32, or the paged KV read's slice and cast)
//   bq_decode_add_encode <- bq_decode_add_encode_pallas (_dae_kernel, _dae24_kernel
//                           with the sum; _daew_kernel, _daew24_kernel wire-only)
//                         (+ bq_decode_add_encode_view: wire-only, local read
//                           through a shard view)
//   bq_decode_add      <- bq_decode_add_pallas    (_da_kernel, _da24_kernel)
//                         (+ bq_decode_add_view: the TP reduce-scatter's form)
//   bq_encode_view: the encode kernel reading a shard view (the TP
//                   reduce-scatter's first hop)
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
// The TP reduce-scatter and the paged KV read (Pallas #4 and #5
// redesigned) get the same treatment.  The reduce-scatter's chunks are
// read in place through a shard view (View: chunk k's value f is
// x[(f / I) * shards * I + k * I + f % I], decode_kernel's layout read
// instead of written), so no movedim copy, f32 zeros and cast copy of the
// payload are written first: the first hop is encode_kernel on a ViewSrc,
// a middle hop decode_add_encode_kernel on a ViewLocal, and the last hop
// decode_add_view_kernel, which adds the decoded wire to the chunk's own
// values and writes the payload's type straight to the chunk-shaped output
// (no f32 sum, no cast).  The KV read (gather_decode_kernel) writes
// each token's first `width` values in the model's type, so the f32
// gathered rows and their cast are never written.  Both new kernels give a
// lane 16 bytes of output and the grid covers every value at once (the
// flat decode's shape).  On an H100 80GB HBM3 at 700 W, L2 flushed
// (chip_smoke.py), the fused decode-add takes 4.77 us at the 9216-row
// chunk of a bf16 [2, 1024, 1152] activation, 12 % above a streaming
// kernel moving its bytes (4.25 us), and the KV read 3.72 us at the
// serving table (8 x 37 blocks, bf16; the floor 3.05 us), so another body
// has little to win: 8 bytes a lane (the block decode-add's warp per row)
// and two or four 16-byte vectors a lane were slower in probe runs not
// kept here.  The fused end of the reduce-scatter (view encode + fused
// decode-add) takes 7.4 us of kernels where the six launches it replaces
// took 28.2 us.  The f32 gather-decode is the same kernel at full width,
// one pool row a token.
// The block-form ring hops (decode_add_encode, decode_add) give one warp
// a row (a lane owns 4 values, encode4/decode4).  The gather-decode reads
// the block table inside the kernel, so the compressed pool rows are never
// copied into a gathered temporary first (the TPU version gathers in XLA,
// then decodes).  The fused ring hops read the received wire row and the
// local f32 row once each, decode and add in registers and re-encode from
// registers; the wire-only form never writes the f32 sum at all.
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

// The local operand of the block-form ring hops: (M, 128) f32 rows.
struct RowsLocal {
  const float* __restrict__ p;
  __device__ __forceinline__ float4 operator()(long long row, int lane) const {
    return reinterpret_cast<const float4*>(p + row * BLOCK)[lane];
  }
};

// One fused ring hop: s = local + decode(wire), then encode(s) into the
// outgoing wire; WANT_SUM also stores s (the all-reduce tail's form).
// `local(row, lane)` gives the lane's four local values of row `row`: the
// f32 block rows (RowsLocal) or a shard view of the payload (ViewLocal).
template <int BITS, bool WANT_SUM, typename Local>
__global__ void __launch_bounds__(THREADS)
decode_add_encode_kernel(const void* __restrict__ q_hi,
                         const uint8_t* __restrict__ q_lo,
                         const float* __restrict__ scale, Local local,
                         void* __restrict__ o_hi, uint8_t* __restrict__ o_lo,
                         float* __restrict__ o_scale, float* __restrict__ sum,
                         long long m, float qmax, float inv_qmax) {
  const long long row = warp_row();
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  const float4 d = decode4<BITS>(q_hi, q_lo, scale, row, lane, inv_qmax);
  const float4 l = local(row, lane);
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

// V values of T at p as f32, one vector load of V * sizeof(T) bytes (16,
// or 8 for four 16-bit values); p is aligned to it.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[V]) {
  constexpr int W = V * static_cast<int>(sizeof(T)) / 4;   // 32-bit words
  static_assert(W == 4 || W == 2, "a vector load is 8 or 16 bytes");
  uint32_t w[W];
  if constexpr (W == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __uint_as_float(w[j]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[2 * k] = bits16_to_f32<T>(w[k] & 0xFFFFu);
      v[2 * k + 1] = bits16_to_f32<T>(w[k] >> 16);
    }
  }
}

// Values [f0, f0 + V) of x as f32; positions at or past `n` read as 0 (the
// tile padding), so a row wholly past n reads nothing.  `vec`: x is 16-byte
// aligned, so a chunk wholly below n is one 16-byte load.
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* __restrict__ x, long long f0,
                                       long long n, bool vec, float (&v)[V]) {
  if (vec && f0 + V <= n) {
    load_vec<T, V>(x + f0, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = f0 + j < n ? to_f32<T>(x[f0 + j]) : 0.0f;
}

// Chunk `index` of a payload split `shards` ways along an axis whose
// trailing size per chunk is `inner` (I), read in place: the chunk's value
// f is x[(f / I) * shards * I + index * I + f % I], the layout the
// all-gather's decode_kernel writes, read instead of written.  n values;
// positions at or past n read as 0 (the tile padding).  `vec`: x's base is
// aligned to the kernel's vector loads and I is a multiple of their width,
// so V values from a multiple of V never leave one run of I and load as
// one vector.  `div32`: the payload has under 2^32 values, so the division
// by I is 32-bit.
struct View {
  long long n, shards, index, inner;
  int vec, div32;
};

__device__ __forceinline__ long long view_at(const View& w, long long f) {
  const long long o =
      w.div32 ? static_cast<uint32_t>(f) / static_cast<uint32_t>(w.inner)
              : f / w.inner;
  return (o * w.shards + w.index) * w.inner + (f - o * w.inner);
}

// Values [f0, f0 + V) of the view as f32 (f0 a multiple of V).
template <typename T, int V>
__device__ __forceinline__ void load_view(const T* __restrict__ x,
                                          const View& w, long long f0,
                                          float (&v)[V]) {
  if (w.vec && f0 + V <= w.n) {
    load_vec<T, V>(x + view_at(w, f0), v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = f0 + j < w.n ? to_f32<T>(x[view_at(w, f0 + j)]) : 0.0f;
}

// Where encode_kernel reads its payload: n contiguous values (FlatSrc), or
// wire rows [lo, lo + m) of a shard view (ViewSrc, f_lo = 128 lo).  Rows
// past m read as 0.
template <typename T>
struct FlatSrc {
  const T* __restrict__ x;
  long long n;
  int vec;
  template <int V>
  __device__ __forceinline__ void load(long long f0, bool live,
                                       float (&v)[V]) const {
    load_x<T, V>(x, f0, live ? n : 0, vec, v);
  }
};

template <typename T>
struct ViewSrc {
  const T* __restrict__ x;
  View w;
  long long f_lo;
  template <int V>
  __device__ __forceinline__ void load(long long f0, bool live,
                                       float (&v)[V]) const {
    if (live) {
      load_view<T, V>(x, w, f_lo + f0, v);
      return;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.0f;
  }
};

// The local operand of the view-form ring hop: a lane's four values of
// wire row `row` of a shard view.
template <typename T>
struct ViewLocal {
  const T* __restrict__ x;
  View w;
  long long f_lo;
  __device__ __forceinline__ float4 operator()(long long row, int lane) const {
    float v[4];
    load_view<T, 4>(x, w, f_lo + row * BLOCK + lane * 4, v);
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

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

// The payload (f32, bf16 or f16; `src`: n contiguous values, or a shard
// view) -> m rows of wire; row r is values [128 r, 128 r + 128) and values
// at or past n are 0.  A row is 128 / V lanes; its max-abs is a shuffle
// reduction over them (1.0 for an all-zero row).  A warp's rows past m
// load nothing and store nothing, but take part in the shuffles.
template <typename T, int BITS, typename Src>
__global__ void __launch_bounds__(THREADS)
encode_kernel(Src src, void* __restrict__ q_hi, uint8_t* __restrict__ q_lo,
              float* __restrict__ scale, long long m, float qmax) {
  constexpr int V = 16 / sizeof(T), LANES = BLOCK / V;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int hl = threadIdx.x % LANES;
  if ((t & ~31ll) / LANES >= m) return;       // uniform across the warp
  const long long row = t / LANES;
  const bool live = row < m;
  float v[V];
  src.template load<V>(row * BLOCK + hl * V, live, v);
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

// The last reduce-scatter hop, fused with the layout around it (Pallas #4
// redesigned): wire rows [lo, hi) of this rank's chunk (row r of the wire
// is chunk row lo + r) plus the chunk's own values read in place through
// the shard view, summed in f32 (the decode's multiply rounded, then the
// add) and written in T straight to values [f_lo, f_hi) of the
// chunk-shaped output (f_lo = 128 lo, f_hi = min(128 hi, n)): no f32 sum,
// no cast and no copy of the parts.  A lane moves 16 bytes of output (V
// values of one wire row); the grid covers every value at once.
template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
decode_add_view_kernel(const void* __restrict__ q_hi,
                       const uint8_t* __restrict__ q_lo,
                       const float* __restrict__ scale,
                       const T* __restrict__ x, View w, long long f_lo,
                       long long f_hi, T* __restrict__ out, float inv_qmax) {
  constexpr int V = 16 / sizeof(T);
  const long long d =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * V;
  const long long f0 = f_lo + d;
  if (f0 >= f_hi) return;
  const long long row = d / BLOCK;
  int q[V];
  load_qv<BITS, V>(q_hi, q_lo, row, (d % BLOCK) / V, q);
  const float mul = __fmul_rn(scale[row], inv_qmax);
  float v[V];
  load_view<T, V>(x, w, f0, v);
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = __fadd_rn(__fmul_rn(static_cast<float>(q[j]), mul), v[j]);
  if (f0 + V <= f_hi) {
    store_out<T, V>(out, f0, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)                  // the chunk's ragged tail
    if (f0 + j < f_hi) out[f0 + j] = from_f32<T>(v[j]);
}

// Mantissa `col` of wire row `row` (load_q's arithmetic, one value).
template <int BITS>
__device__ __forceinline__ int load_q1(const void* __restrict__ q_hi,
                                       const uint8_t* __restrict__ q_lo,
                                       long long row, int col) {
  if constexpr (BITS == 4) {
    const int b = static_cast<const uint8_t*>(q_hi)[row * (BLOCK / 2) + col / 2];
    return (col & 1 ? b & 0xF : b >> 4) - 8;
  } else if constexpr (BITS == 8) {
    return static_cast<const int8_t*>(q_hi)[row * BLOCK + col];
  } else if constexpr (BITS == 16) {
    return static_cast<const int16_t*>(q_hi)[row * BLOCK + col];
  } else {
    return static_cast<const int16_t*>(q_hi)[row * BLOCK + col] * 256 +
           q_lo[row * BLOCK + col];
  }
}

// The paged KV read, fused with its slice and cast (Pallas #5 redesigned):
// pool rows are `rows` per token and `tokens` per block; the output holds,
// for table entry e and token t of its block, the first `width` values of
// the token's rows (width <= 128 rows), decoded and written in T:
// out[((e * tokens) + t) * width + c] decodes value c % 128 of pool row
// (idx[e] * tokens + t) * rows + c / 128.  A lane writes 16 bytes of output
// (V values of one pool row when width is a multiple of V, else value by
// value); the grid covers every output value at once.  An id outside
// [0, n_blocks) reads nothing and writes NaN.
template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
gather_decode_kernel(const void* __restrict__ q_hi,
                          const uint8_t* __restrict__ q_lo,
                          const float* __restrict__ scale,
                          const int32_t* __restrict__ idx, long long n_out,
                          long long n_blocks, long long tokens,
                          long long rows, long long width,
                          T* __restrict__ out, float inv_qmax) {
  constexpr int V = 16 / sizeof(T);
  const long long f0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (f0 >= n_out) return;
  const bool d32 = n_out <= 0xFFFFFFFFll;
  const float nan = __int_as_float(0x7fc00000);
  float v[V];
  // (token, value in the token) of output value f, and the pool row and
  // the id it reads (-1 for an id outside the pool)
  auto locate = [&](long long f, long long& row, int& col) {
    const long long tok =
        d32 ? static_cast<uint32_t>(f) / static_cast<uint32_t>(width)
            : f / width;
    const long long c = f - tok * width;
    const long long e =
        d32 ? static_cast<uint32_t>(tok) / static_cast<uint32_t>(tokens)
            : tok / tokens;
    const long long id = idx[e];
    col = static_cast<int>(c % BLOCK);
    row = id < 0 || id >= n_blocks
              ? -1
              : (id * tokens + (tok - e * tokens)) * rows + c / BLOCK;
  };
  if (width % V == 0) {                        // uniform across the grid
    long long row;
    int col;
    locate(f0, row, col);
    if (row < 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = nan;
    } else {
      int q[V];
      load_qv<BITS, V>(q_hi, q_lo, row, col / V, q);
      const float mul = __fmul_rn(scale[row], inv_qmax);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = __fmul_rn(static_cast<float>(q[j]), mul);
    }
    if (f0 + V <= n_out) {
      store_out<T, V>(out, f0, v);
      return;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (f0 + j >= n_out) break;
      long long row;
      int col;
      locate(f0 + j, row, col);
      v[j] = row < 0 ? nan
                     : __fmul_rn(static_cast<float>(load_q1<BITS>(q_hi, q_lo, row, col)),
                                 __fmul_rn(scale[row], inv_qmax));
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (f0 + j < n_out) out[f0 + j] = from_f32<T>(v[j]);
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

template <typename T, int BITS, typename Src>
int launch_encode_from(Src src, void* q_hi, uint8_t* q_lo, float* scale,
                       long long m, float qmax, cudaStream_t s) {
  constexpr long long rows_per_block = THREADS / (BLOCK / (16 / sizeof(T)));
  encode_kernel<T, BITS><<<static_cast<unsigned>(
                               (m + rows_per_block - 1) / rows_per_block),
                           THREADS, 0, s>>>(src, q_hi, q_lo, scale, m, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
int launch_encode(const void* x, long long n, int vec, void* q_hi,
                  uint8_t* q_lo, float* scale, long long m, float qmax,
                  cudaStream_t s) {
  return launch_encode_from<T, BITS>(
      FlatSrc<T>{static_cast<const T*>(x), n, vec}, q_hi, q_lo, scale, m,
      qmax, s);
}

// A View of x for loads of V values: vector loads when x's base is aligned
// to them and every run of `inner` holds whole vectors.
template <typename T, int V>
View make_view(const void* x, long long n, long long shards, long long index,
               long long inner) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % (V * sizeof(T)) == 0 && inner % V == 0;
  return View{n, shards, index, inner, aligned,
              n * shards <= 0xFFFFFFFFll};
}

template <typename T, int BITS>
int launch_encode_view(const void* x, long long n, long long shards,
                       long long index, long long inner, long long f_lo,
                       void* q_hi, uint8_t* q_lo, float* scale, long long m,
                       float qmax, cudaStream_t s) {
  return launch_encode_from<T, BITS>(
      ViewSrc<T>{static_cast<const T*>(x),
                 make_view<T, 16 / sizeof(T)>(x, n, shards, index, inner),
                 f_lo},
      q_hi, q_lo, scale, m, qmax, s);
}

template <typename T, int BITS>
int launch_dae_view(const void* q_hi, const uint8_t* q_lo, const float* scale,
                    const void* x, long long n, long long shards,
                    long long index, long long inner, long long f_lo,
                    void* o_hi, uint8_t* o_lo, float* o_scale, long long m,
                    float qmax, float inv_qmax, cudaStream_t s) {
  decode_add_encode_kernel<BITS, false><<<grid_for(m), THREADS, 0, s>>>(
      q_hi, q_lo, scale,
      ViewLocal<T>{static_cast<const T*>(x),
                   make_view<T, 4>(x, n, shards, index, inner), f_lo},
      o_hi, o_lo, o_scale, nullptr, m, qmax, inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
int launch_decode_add_view(const void* q_hi, const uint8_t* q_lo,
                           const float* scale, const void* x, long long n,
                           long long shards, long long index, long long inner,
                           long long f_lo, long long f_hi, void* out,
                           float inv_qmax, cudaStream_t s) {
  constexpr long long vals_per_block = THREADS * (16 / sizeof(T));
  decode_add_view_kernel<T, BITS><<<static_cast<unsigned>(
                                        (f_hi - f_lo + vals_per_block - 1) /
                                        vals_per_block),
                                    THREADS, 0, s>>>(
      q_hi, q_lo, scale, static_cast<const T*>(x),
      make_view<T, 16 / sizeof(T)>(x, n, shards, index, inner), f_lo, f_hi,
      static_cast<T*>(out), inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
int launch_gather(const void* q_hi, const uint8_t* q_lo,
                       const float* scale, const int32_t* idx, long long n_out,
                       long long n_blocks, long long tokens, long long rows,
                       long long width, void* out, float inv_qmax,
                       cudaStream_t s) {
  constexpr long long vals_per_block = THREADS * (16 / sizeof(T));
  gather_decode_kernel<T, BITS><<<static_cast<unsigned>(
                                           (n_out + vals_per_block - 1) /
                                           vals_per_block),
                                       THREADS, 0, s>>>(
      q_hi, q_lo, scale, idx, n_out, n_blocks, tokens, rows, width,
      static_cast<T*>(out), inv_qmax);
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
        q_hi, q_lo, scale, RowsLocal{local}, o_hi, o_lo, o_scale, sum, m, qmax, \
        inv_qmax);                                                              \
  else                                                                          \
    decode_add_encode_kernel<B, false><<<grid_for(m), THREADS, 0, s>>>(         \
        q_hi, q_lo, scale, RowsLocal{local}, o_hi, o_lo, o_scale, sum, m, qmax, \
        inv_qmax)
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

// Chunk `index` of x (dtype 0 f32, 1 bf16, 2 f16) split `shards` ways,
// trailing size `inner` per chunk, n values (see View) -> m rows of wire
// from chunk value f_lo = 128 lo on; values at or past n encode as 0.
int bq_encode_view(const void* x, int dtype, long long n, long long shards,
                   long long index, long long inner, long long f_lo,
                   void* q_hi, uint8_t* q_lo, float* scale, long long m,
                   int bits, float qmax, void* stream) {
  BQ_BY_TYPE_AND_BITS(dtype, bits, launch_encode_view, x, n, shards, index,
                      inner, f_lo, q_hi, q_lo, scale, m, qmax,
                      static_cast<cudaStream_t>(stream))
}

// The wire-only fused ring hop with its local operand, wire rows [lo, lo +
// m) of a chunk, read through the view (f_lo = 128 lo).
int bq_decode_add_encode_view(const void* q_hi, const uint8_t* q_lo,
                              const float* scale, const void* x, int dtype,
                              long long n, long long shards, long long index,
                              long long inner, long long f_lo, void* o_hi,
                              uint8_t* o_lo, float* o_scale, long long m,
                              int bits, float qmax, float inv_qmax,
                              void* stream) {
  BQ_BY_TYPE_AND_BITS(dtype, bits, launch_dae_view, q_hi, q_lo, scale, x, n,
                      shards, index, inner, f_lo, o_hi, o_lo, o_scale, m, qmax,
                      inv_qmax, static_cast<cudaStream_t>(stream))
}

// The fused last reduce-scatter hop: values [f_lo, f_hi) of the chunk-shaped
// out (the dtype of x) = the chunk's values through the view + the decoded
// wire, whose row 0 holds chunk values [f_lo, f_lo + 128).
int bq_decode_add_view(const void* q_hi, const uint8_t* q_lo,
                       const float* scale, const void* x, int dtype,
                       long long n, long long shards, long long index,
                       long long inner, long long f_lo, long long f_hi,
                       void* out, int bits, float inv_qmax, void* stream) {
  BQ_BY_TYPE_AND_BITS(dtype, bits, launch_decode_add_view, q_hi, q_lo, scale,
                      x, n, shards, index, inner, f_lo, f_hi, out, inv_qmax,
                      static_cast<cudaStream_t>(stream))
}

// The gather-decode into `width` values per token in dtype: n_out = entries
// x tokens x width output values.  The f32 form of whole pool rows is
// dtype 0, rows 1, width 128.
int bq_gather_decode(const void* q_hi, const uint8_t* q_lo,
                     const float* scale, const int32_t* idx, long long n_out,
                     long long n_blocks, long long tokens, long long rows,
                     long long width, void* out, int dtype, int bits,
                     float inv_qmax, void* stream) {
  BQ_BY_TYPE_AND_BITS(dtype, bits, launch_gather, q_hi, q_lo, scale, idx,
                      n_out, n_blocks, tokens, rows, width, out, inv_qmax,
                      static_cast<cudaStream_t>(stream))
}

}  // extern "C"
