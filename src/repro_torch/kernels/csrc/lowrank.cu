// Low-rank (plr codec) matrix products for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/lowrank.py:
//   lowrank_mm_tall, lowrank_mm_at_b, lowrank_mm_small_k <- matmul_pallas (_mm_kernel)
//
// The plr codec (PowerSGD) runs three f32 products per exchange on the
// matrix view M (m x ncols, ncols <= 512) of a flat gradient and a factor of
// rank r <= 64.  At gemma3-1b's per-rank gradient (m about 1.05 M rows of
// 512) each product moves about 2.2 GB, and the TPU kernel's design does not
// carry over: it keeps the whole padded contraction dim resident per row
// tile and pads the factor to 128 lanes, so M^T @ P^ would hold a
// 1.05 M-wide block in fast memory.  Here each product has its own kernel:
//
//   (a) tall:    C (m x n) = A (m x k) @ B (k x n), A row-major and tall
//                (k <= 512), B small (n <= 64): P = M @ Q.
//   (b) at_b:    C (k x n) = A^T @ B with A (m x k) row-major, read in its
//                own layout (never transposed in memory), B (m x n), a
//                reduction over m: Q' = M^T @ P^.
//   (c) small_k: C (m x n) = A (m x k) @ B (k x n) with k <= 64 and
//                n <= 512: the reconstruction P^ @ Q'^T.
//
// Arithmetic is f32 with an f32 accumulator on the CUDA cores (no TF32, no
// tensor cores).  What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s f32):
// at r = 8 each moves about 2.2 GB for about 9 GFLOP, so all three are
// bound by device memory (about 0.65 ms); at r = 64 (a) and (c) do 69 GFLOP
// and are bound by f32 FMA throughput.  The designs, simple first:
//
//   (a) One warp per row (RPW rows per warp at small n, to reuse each B
//       value).  B is staged transposed in shared memory once per block;
//       lane l reads A[row][l + 32 j], so every warp load is 128 contiguous
//       bytes and every shared-memory read conflict-free.  The n partial
//       sums of a row are reduced across the warp by a transposing
//       butterfly: each shuffle step halves the values a lane holds, so an
//       n-wide row costs about n shuffles instead of 5 n.  Blocks are
//       persistent (grid-stride over rows).
//   (b) Two passes, deterministic: the rows are cut into fixed slabs (a
//       function of m alone, never of the card), one block per slab; thread
//       t holds columns t and t + 256 of A for all n outputs in registers
//       and walks the slab's rows in order, P^'s rows staged in shared
//       memory.  Each block writes its partial (n x k) to scratch that the
//       wrapper allocates; the second pass sums the slabs in slab order.
//       No atomics, so a call repeats bit for bit.
//   (c) One warp per row (two rows per step), B in shared memory; lane l
//       owns columns 4 l + 128 t and stores them as float4, so every store
//       is 16 bytes and a warp writes 512 contiguous bytes.  It takes n a
//       multiple of 4 and a contiguous, 16-byte aligned C (the plr codec's
//       widths are 128, 256 and 512, its outputs fresh or at offset 0).
//       A's few values per row are read by all lanes at once (one
//       broadcast load each).
//
// Ragged edges (m, k, n, row strides; n in steps of 4 in (c)) are masked in
// every kernel.  Each C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int AT_B_ROWS = 32;        // P^ rows staged per step in (b)
constexpr int SMALL_K_RPW = 2;       // rows per warp step in (c)
constexpr int SMALL_K_CPL = 16;      // columns per lane in (c): n <= 512

// Transposing warp reduction of NP per-lane partial sums.  After it, lane
// `lane` holds the full sums of max(1, NP / 32) consecutive columns
// starting at column_of<NP>(lane); lanes of one group hold the same sums.
template <int CNT, int O, int NP>
__device__ __forceinline__ void transpose_reduce(float (&v)[NP], int lane) {
  if constexpr (O > 0) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      transpose_reduce<H, O / 2, NP>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      transpose_reduce<1, O / 2, NP>(v, lane);
    }
  }
}

template <int NP>
__device__ __forceinline__ int log2_np() {
  return NP >= 64 ? 6 : NP >= 32 ? 5 : NP >= 16 ? 4 : 3;
}

// First column whose sum lane `lane` holds, and whether it stores it (one
// lane per group).
template <int NP>
__device__ __forceinline__ int column_of(int lane) {
  constexpr int VPL = NP > 32 ? NP / 32 : 1;
  const int shift = NP > 32 ? 0 : 5 - log2_np<NP>();
  return (lane >> shift) * VPL;
}

template <int NP>
__device__ __forceinline__ bool stores(int lane) {
  constexpr int GROUP = NP >= 32 ? 1 : 32 / NP;
  return (lane & (GROUP - 1)) == 0;
}

// ---- (a) tall A x small B ------------------------------------------------

template <int NP>
__global__ void __launch_bounds__(THREADS)
mm_tall_kernel(const float* __restrict__ a, long long m, int k, long long lda,
               const float* __restrict__ b, long long ldb_k, long long ldb_n,
               int n, float* __restrict__ c, long long ldc) {
  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);          // [NP][k], B^T
  for (int i = threadIdx.x; i < NP * k; i += THREADS) {
    const int col = i / k, kk = i - col * k;
    bt[i] = col < n ? b[kk * ldb_k + col * ldb_n] : 0.f;
  }
  __syncthreads();

  constexpr int RPW = NP >= 32 ? 1 : 32 / NP;
  constexpr int VPL = NP > 32 ? NP / 32 : 1;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * RPW;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5)) * RPW;
       r0 < m; r0 += stride) {
    float acc[RPW][NP];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int j = 0; j < NP; ++j) acc[r][j] = 0.f;
#pragma unroll 4
    for (int kk = lane; kk < k; kk += 32) {
      float av[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        av[r] = r0 + r < m ? __ldg(a + (r0 + r) * lda + kk) : 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float bv = bt[j * k + kk];
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r][j] = fmaf(av[r], bv, acc[r][j]);
      }
    }
    const int col0 = column_of<NP>(lane);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      transpose_reduce<NP, 16, NP>(acc[r], lane);
      if (r0 + r < m && stores<NP>(lane)) {
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          if (col0 + i < n) c[(r0 + r) * ldc + col0 + i] = acc[r][i];
      }
    }
  }
}

// ---- (b) A^T @ B, A row-major: per-slab partials, then a fixed-order sum --

template <int NP, int KPT>
__global__ void __launch_bounds__(THREADS)
mm_at_b_partial_kernel(const float* __restrict__ a, long long m, int k,
                       long long lda, const float* __restrict__ b,
                       long long ldb, int n, float* __restrict__ part,
                       long long rows_per_slab) {
  __shared__ float4 ps4[AT_B_ROWS * NP / 4];
  float* ps = reinterpret_cast<float*>(ps4);            // [AT_B_ROWS][NP]
  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_slab;
  const long long hi = lo + rows_per_slab < m ? lo + rows_per_slab : m;
  float acc[KPT][NP];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[j][q] = 0.f;

  for (long long r0 = lo; r0 < hi; r0 += AT_B_ROWS) {
    const int rows = hi - r0 < AT_B_ROWS ? static_cast<int>(hi - r0) : AT_B_ROWS;
    __syncthreads();
    for (int i = threadIdx.x; i < AT_B_ROWS * NP; i += THREADS) {
      const int rr = i / NP, q = i - rr * NP;
      ps[i] = rr < rows && q < n ? b[(r0 + rr) * ldb + q] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < rows; ++rr) {
      float av[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = threadIdx.x + j * THREADS;
        av[j] = kk < k ? __ldg(a + (r0 + rr) * lda + kk) : 0.f;
      }
      const float4* prow = reinterpret_cast<const float4*>(ps + rr * NP);
#pragma unroll
      for (int q4 = 0; q4 < NP / 4; ++q4) {
        const float4 p = prow[q4];
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          acc[j][4 * q4 + 0] = fmaf(av[j], p.x, acc[j][4 * q4 + 0]);
          acc[j][4 * q4 + 1] = fmaf(av[j], p.y, acc[j][4 * q4 + 1]);
          acc[j][4 * q4 + 2] = fmaf(av[j], p.z, acc[j][4 * q4 + 2]);
          acc[j][4 * q4 + 3] = fmaf(av[j], p.w, acc[j][4 * q4 + 3]);
        }
      }
    }
  }
  // partials as [slab][n][k]: neighbouring threads store neighbouring k
  float* out = part + static_cast<long long>(blockIdx.x) * n * k;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kk = threadIdx.x + j * THREADS;
    if (kk < k) {
#pragma unroll
      for (int q = 0; q < NP; ++q)
        if (q < n) out[static_cast<long long>(q) * k + kk] = acc[j][q];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mm_at_b_sum_kernel(const float* __restrict__ part, int slabs, int k, int n,
                   float* __restrict__ c, long long ldc) {
  const int i = blockIdx.x * THREADS + threadIdx.x;      // over [n][k]
  if (i >= n * k) return;
  const int q = i / k, kk = i - q * k;
  float s = 0.f;
  for (int t = 0; t < slabs; ++t)                         // slab order
    s += part[static_cast<long long>(t) * n * k + i];
  c[kk * ldc + q] = s;
}

// ---- (c) small-k product, bound by its writes ---------------------------

__global__ void __launch_bounds__(THREADS)
mm_small_k_kernel(const float* __restrict__ a, long long m, int k,
                  long long lda, const float* __restrict__ b, long long ldb_k,
                  long long ldb_n, int n, float* __restrict__ c,
                  long long ldc) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);           // [k][n]
  for (int i = threadIdx.x; i < k * n; i += THREADS) {
    const int kk = i / n, col = i - kk * n;
    bs[i] = b[kk * ldb_k + col * ldb_n];
  }
  __syncthreads();

  constexpr int RPW = SMALL_K_RPW, CPL = SMALL_K_CPL;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * RPW;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5)) * RPW;
       r0 < m; r0 += stride) {
    float acc[RPW][CPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[r][t] = 0.f;
    for (int j = 0; j < k; ++j) {
      float av[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        av[r] = r0 + r < m ? __ldg(a + (r0 + r) * lda + j) : 0.f;
      const float* brow = bs + j * n;
#pragma unroll
      for (int t = 0; t < CPL / 4; ++t) {
        const int c0 = 4 * lane + 128 * t;
        if (c0 < n) {
          const float4 bv = *reinterpret_cast<const float4*>(brow + c0);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            acc[r][4 * t + 0] = fmaf(av[r], bv.x, acc[r][4 * t + 0]);
            acc[r][4 * t + 1] = fmaf(av[r], bv.y, acc[r][4 * t + 1]);
            acc[r][4 * t + 2] = fmaf(av[r], bv.z, acc[r][4 * t + 2]);
            acc[r][4 * t + 3] = fmaf(av[r], bv.w, acc[r][4 * t + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (r0 + r >= m) break;
      float* crow = c + (r0 + r) * ldc;
#pragma unroll
      for (int t = 0; t < CPL / 4; ++t) {
        const int c0 = 4 * lane + 128 * t;
        if (c0 < n)
          *reinterpret_cast<float4*>(crow + c0) = make_float4(
              acc[r][4 * t], acc[r][4 * t + 1], acc[r][4 * t + 2],
              acc[r][4 * t + 3]);
      }
    }
  }
}

// Blocks that fill the card once (persistent grid), at most `needed`.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long long needed,
                            int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return e;
  long long g = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (needed < g) g = needed > 0 ? needed : 1;
  *grid = static_cast<int>(g);
  return cudaSuccess;
}

template <int NP>
int launch_tall(const float* a, long long m, int k, long long lda,
                const float* b, long long ldb_k, long long ldb_n, int n,
                float* c, long long ldc, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(NP) * k * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mm_tall_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  constexpr int RPW = NP >= 32 ? 1 : 32 / NP;
  int grid = 0;
  e = persistent_grid(mm_tall_kernel<NP>, smem,
                      (m + WARPS * RPW - 1) / (WARPS * RPW), &grid);
  if (e != cudaSuccess) return e;
  mm_tall_kernel<NP><<<grid, THREADS, smem, stream>>>(a, m, k, lda, b, ldb_k,
                                                      ldb_n, n, c, ldc);
  return cudaGetLastError();
}

template <int NP, int KPT>
int launch_at_b(const float* a, long long m, int k, long long lda,
                const float* b, long long ldb, int n, float* c,
                long long ldc, float* part, int slabs,
                long long rows_per_slab, cudaStream_t stream) {
  mm_at_b_partial_kernel<NP, KPT><<<slabs, THREADS, 0, stream>>>(
      a, m, k, lda, b, ldb, n, part, rows_per_slab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mm_at_b_sum_kernel<<<(n * k + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      part, slabs, k, n, c, ldc);
  return cudaGetLastError();
}

template <int NP>
int launch_at_b_np(const float* a, long long m, int k, long long lda,
                   const float* b, long long ldb, int n, float* c,
                   long long ldc, float* part, int slabs,
                   long long rows_per_slab, cudaStream_t stream) {
  if (k <= THREADS)
    return launch_at_b<NP, 1>(a, m, k, lda, b, ldb, n, c, ldc, part, slabs,
                              rows_per_slab, stream);
  return launch_at_b<NP, 2>(a, m, k, lda, b, ldb, n, c, ldc, part, slabs,
                            rows_per_slab, stream);
}

}  // namespace

extern "C" {

// (a): k <= 512, n <= 64; B read through (ldb_k, ldb_n) strides.
int lowrank_mm_tall(const float* a, long long m, int k, long long lda,
                    const float* b, long long ldb_k, long long ldb_n, int n,
                    float* c, long long ldc, cudaStream_t stream) {
  if (k < 1 || k > 512 || n < 1 || n > 64) return cudaErrorInvalidValue;
  if (n <= 8)
    return launch_tall<8>(a, m, k, lda, b, ldb_k, ldb_n, n, c, ldc, stream);
  if (n <= 16)
    return launch_tall<16>(a, m, k, lda, b, ldb_k, ldb_n, n, c, ldc, stream);
  if (n <= 32)
    return launch_tall<32>(a, m, k, lda, b, ldb_k, ldb_n, n, c, ldc, stream);
  return launch_tall<64>(a, m, k, lda, b, ldb_k, ldb_n, n, c, ldc, stream);
}

// (b): C (k x n) = A^T @ B for A (m x k) row-major, k <= 512, n <= 64;
// `part` holds slabs * n * k floats, slab s covering rows
// [s * rows_per_slab, (s + 1) * rows_per_slab).
int lowrank_mm_at_b(const float* a, long long m, int k, long long lda,
                    const float* b, long long ldb, int n, float* c,
                    long long ldc, float* part, int slabs,
                    long long rows_per_slab, cudaStream_t stream) {
  if (k < 1 || k > 2 * THREADS || n < 1 || n > 64 || slabs < 1)
    return cudaErrorInvalidValue;
  if (n <= 8)
    return launch_at_b_np<8>(a, m, k, lda, b, ldb, n, c, ldc, part, slabs,
                             rows_per_slab, stream);
  if (n <= 16)
    return launch_at_b_np<16>(a, m, k, lda, b, ldb, n, c, ldc, part, slabs,
                              rows_per_slab, stream);
  if (n <= 32)
    return launch_at_b_np<32>(a, m, k, lda, b, ldb, n, c, ldc, part, slabs,
                              rows_per_slab, stream);
  return launch_at_b_np<64>(a, m, k, lda, b, ldb, n, c, ldc, part, slabs,
                            rows_per_slab, stream);
}

// (c): k <= 64, n <= 512 with n % 4 == 0 and C 16-byte aligned, ldc == n
// (float4 stores; the wrapper refuses any other output).
int lowrank_mm_small_k(const float* a, long long m, int k, long long lda,
                       const float* b, long long ldb_k, long long ldb_n,
                       int n, float* c, cudaStream_t stream) {
  if (k < 1 || k > 64 || n < 1 || n > 32 * SMALL_K_CPL || n % 4 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(k) * n * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mm_small_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int grid = 0;
  e = persistent_grid(mm_small_k_kernel, smem,
                      (m + WARPS * SMALL_K_RPW - 1) / (WARPS * SMALL_K_RPW),
                      &grid);
  if (e != cudaSuccess) return e;
  mm_small_k_kernel<<<grid, THREADS, smem, stream>>>(a, m, k, lda, b, ldb_k,
                                                     ldb_n, n, c, n);
  return cudaGetLastError();
}

}  // extern "C"
