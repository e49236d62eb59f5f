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
// tensor cores: the reference accumulates in f32).  What bounds them on an
// H100 (3.35 TB/s, 67 TFLOP/s f32): at r = 8 each moves about 2.2 GB for
// about 9 GFLOP, so all three are bound by device memory (about 0.65 ms);
// at r = 64 (a) and (c) do 69 GFLOP and are bound by f32 FMA throughput
// (about 1.03 ms).
//
//   (a) and (c) are one register-tiled GEMM, mm_panel_kernel: a tall A
//       times a small B, the two differing only in which of k and n is
//       large.  Each block keeps its BN columns of B (k x BN, read once from
//       any strides, zero past k and n; 128 KB at most) in shared memory and
//       walks BM-row panels of A (persistent grid, panels interleaved across
//       blocks; in (c) the grid is a multiple of the n / BN column slices,
//       one slice per block).  A streams through shared memory in BK-deep
//       slices by cp.async with an L2 prefetch of 256 bytes, 2-3 stages in
//       flight, one pipeline across panels; a staged row's 16-byte chunks
//       are XOR-permuted by the row's low bits, so the rows read at once
//       fall in distinct banks without padding.  Each thread holds a TM x
//       TN block of C in registers (float4 groups of columns 4 tx + 4 g TX)
//       and per 4 k-steps loads TM + TN float4s for 4 TM TN FMAs: 16 FMAs a
//       load at 8 x 8, against one 4-byte load per FMA in a dot-product
//       kernel.  (a)'s instances let each warp stage and read its own rows
//       of A, so a warp waits on a warp barrier, not on the whole block,
//       every slice.  Each form has two instances: one for the ranks the
//       plr ladder sends (2, 4, 8) and one for any rank up to 64, tuned at
//       64 (a narrower rank runs it with B's columns or k past r zero).
//       At r = 8 the design is about bytes: 16-byte loads of 256
//       contiguous bytes per row, and (c)'s float4 stores, 256 contiguous bytes per half-warp.  A row
//       slice of A that is not 16-byte aligned (odd rank, P^[r0:r1]) loads
//       by 4-byte cp.async instead.  Every output is one serial FMA chain
//       over k, in k order, in one thread (no split-k, shuffles or atomics),
//       so a call repeats bit for bit and the chain is k roundings long.
//   (b) Two passes, deterministic: the rows are cut into fixed slabs (a
//       function of m alone, never of the card), one block per slab; thread
//       t holds columns t and t + 256 of A for all n outputs in registers
//       and walks the slab's rows in order, P^'s rows staged in shared
//       memory.  Each block writes its partial (n x k) to scratch that the
//       wrapper allocates; the second pass sums the slabs in slab order.
//       No atomics, so a call repeats bit for bit.
//
// Ragged edges (m, k, n, row strides) are masked in every kernel; (c) takes
// n a multiple of 4 and a contiguous, 16-byte aligned C (the plr codec's
// widths are 128, 256 and 512).  Each C entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int AT_B_ROWS = 32;        // P^ rows staged per step in (b)

// ---- cp.async: global -> shared, zero-filling past src_bytes --------------

// 16 bytes, with a hint to fetch the 256 bytes around them into L2: the
// next k slices of the same rows follow a few steps later
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- (a) and (c): tall A (m x k) @ small B (k x n), register-tiled ---------

// Offset of A's (row, kk) in a staged slice (kk < BK): rows of BK floats,
// a row's 16-byte chunks XOR-permuted by the row's two low bits, so the 4
// consecutive rows a quarter-warp reads at one kk fall in distinct banks
// without padding.
template <int BK>
__device__ __forceinline__ int a_off(int row, int kk) {
  constexpr int KEY = BK / 4 >= 4 ? 3 : BK / 4 - 1;
  return row * BK + ((((kk >> 2) ^ (row & KEY)) << 2) | (kk & 3));
}

// NT threads, each a TM x TN block of the BM x BN tile (BM = NT / (BN / TN)
// * TM); A in BK-deep slices, STAGES of them in the pipeline; B (k x BN)
// resident; WARPA: each warp stages its own rows of A.
template <int NT, int BN, int TM, int TN, int BK, int STAGES, int MINB,
          bool WARPA>
__global__ void __launch_bounds__(NT, MINB)
mm_panel_kernel(const float* __restrict__ a, long long m, int k,
                long long lda, bool vec_a, const float* __restrict__ b,
                long long ldb_k, long long ldb_n, int n,
                float* __restrict__ c, long long ldc, bool vec_c,
                int slices, long long blocks_per_slice) {
  constexpr int TX = BN / TN, TY = NT / TX, BM = TY * TM;
  constexpr int G4 = TN / 4, CH = BK / 4;
  // WARPA: warp w stages and reads rows [w WR, (w + 1) WR) of the panel on
  // its own (a warp barrier per step, not a block barrier)
  constexpr int TYW = 32 / TX, WR = TYW * TM, RS = WARPA ? TYW : TY;
  static_assert(TN % 4 == 0 && BN % TN == 0 && NT % TX == 0 && 32 % TX == 0,
                "tile");
  static_assert(BK % 4 == 0 && (WARPA ? 32 : NT) % CH == 0 &&
                (WARPA ? WR : BM) * CH % (WARPA ? 32 : NT) == 0, "slice");
  extern __shared__ float4 smem4[];
  const int ks = (k + BK - 1) / BK;                       // k slices
  float* as = reinterpret_cast<float*>(smem4);            // [STAGES][BM][BK]
  float* bs = as + STAGES * BM * BK;                     // [ks * BK][BN]

  const int slice = static_cast<int>(blockIdx.x % slices);
  const long long pb = blockIdx.x / slices;
  const int col0 = slice * BN;

  // this block's columns of B, resident; coalesced in whichever of B's
  // dimensions is contiguous
  const int kb = ks * BK;
  const bool kk_fast = ldb_k == 1 && ldb_n != 1;
  for (int i = threadIdx.x; i < kb * BN; i += NT) {
    int kk, col;
    if (kk_fast) {
      col = i / kb;
      kk = i - col * kb;
    } else {
      kk = i / BN;
      col = i - kk * BN;
    }
    const int gc = col0 + col;
    bs[kk * BN + col] =
        kk < k && gc < n ? __ldg(b + kk * ldb_k + gc * ldb_n) : 0.f;
  }
  if constexpr (WARPA) __syncthreads();     // the loop syncs warps only

  // panels pb, pb + blocks_per_slice, ...: the blocks in flight read
  // neighbouring panels (contiguous shares of m per block, and splitting
  // the last round's rows among all blocks, were both slower)
  const long long panels = (m + BM - 1) / BM;
  const long long tiles =
      pb < panels ? (panels - 1 - pb) / blocks_per_slice + 1 : 0;
  const long long steps = tiles * ks;

  // Steps run over (panel t, k slice j) in order; the issue side keeps its
  // own counters (no 64-bit division in the loop).  issue() stages A's
  // slice ij of panel it into stage istage, zero-filled past m and k.
  long long it = 0;
  int ij = 0, istage = 0;
  auto issue = [&]() {
    const int kb0 = ij * BK;
    const long long r0 = (pb + it * blocks_per_slice) * BM;
    float* dst = as + istage * (BM * BK);
    // the P threads that stage rows [w0, w0 + R): the whole block, or
    // under WARPA the warp's own rows (it then waits on its copies alone)
    constexpr int P = WARPA ? 32 : NT, R = WARPA ? WR : BM;
    const int id = threadIdx.x % P, w0 = threadIdx.x / P * R;
    if (vec_a && r0 + BM <= m && kb0 + BK <= k) {
      // a full tile: each thread's chunks sit at fixed offsets, no masks
      const int row = w0 + id / CH, ch = id % CH;
      const float* src = a + (r0 + row) * lda + kb0 + ch * 4;
      const long long step = static_cast<long long>(P / CH) * lda;
#pragma unroll
      for (int u = 0; u < R * CH / P; ++u)
        cp_async16(dst + a_off<BK>(row + u * (P / CH), ch * 4),
                   src + u * step, 16);
    } else if (vec_a) {
#pragma unroll
      for (int u = 0; u < R * CH / P; ++u) {
        const int i = id + u * P;
        const int row = w0 + i / CH, kk = kb0 + (i % CH) * 4;
        const long long gr = r0 + row;
        const int bytes = gr < m && kk < k ? 4 * min(4, k - kk) : 0;
        cp_async16(dst + a_off<BK>(row, kk - kb0),
                   bytes ? a + gr * lda + kk : a, bytes);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < R * BK / P; ++u) {
        const int i = id + u * P;
        const int row = w0 + i / BK, kk = kb0 + i % BK;
        const long long gr = r0 + row;
        const bool in = gr < m && kk < k;
        cp_async4(dst + a_off<BK>(row, kk - kb0),
                  in ? a + gr * lda + kk : a, in ? 4 : 0);
      }
    }
  };
  long long issued = 0;
  auto issue_next = [&]() {
    if (issued < steps) {
      issue();
      ++issued;
      if (++ij == ks) {
        ij = 0;
        ++it;
      }
      istage = istage + 1 == STAGES ? 0 : istage + 1;
    }
    cp_async_commit();
  };

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = WARPA ? ty / TYW * WR + ty % TYW : ty;  // C row of acc[0]
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_next();
  long long t = 0;
  int j = 0, stage = 0;
  for (long long st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    if constexpr (WARPA)
      __syncwarp();
    else
      __syncthreads();            // step st landed; step st - 1 is consumed
    issue_next();

    const float* at = as + stage * (BM * BK);
    const float* bt = bs + j * BK * BN + tx * 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      // copied to scalars, not kept as float4s: nvcc then allocates the
      // FMA block's registers better, and tall r = 64 runs faster
      float av[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            at + a_off<BK>(row0 + i * RS, k4));
        av[i][0] = v.x;
        av[i][1] = v.y;
        av[i][2] = v.z;
        av[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              bt + (k4 + q) * BN + g * 4 * TX);
          bv[4 * g] = v.x;
          bv[4 * g + 1] = v.y;
          bv[4 * g + 2] = v.z;
          bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = av[i][q];
#pragma unroll
          for (int jj = 0; jj < TN; ++jj)
            acc[i][jj] = fmaf(x, bv[jj], acc[i][jj]);
        }
      }
    }

    if (j == ks - 1) {            // the panel's last k slice: store, reset
      const long long r0 = (pb + t * blocks_per_slice) * BM;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long row = r0 + row0 + i * RS;
        if (row < m) {
          float* crow = c + row * ldc;
#pragma unroll
          for (int g = 0; g < G4; ++g) {
            const int col = col0 + tx * 4 + g * 4 * TX;
            if (vec_c) {
              if (col < n)
                *reinterpret_cast<float4*>(crow + col) =
                    make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                acc[i][4 * g + 2], acc[i][4 * g + 3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (col + e < n) crow[col + e] = acc[i][4 * g + e];
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;
      }
    }
    if (++j == ks) {
      j = 0;
      ++t;
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
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

// Blocks that fill the card once (persistent grid), at most `needed`.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long long needed, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  long long g = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (needed < g) g = needed > 0 ? needed : 1;
  *grid = static_cast<int>(g);
  return cudaSuccess;
}

// (a) and (c): A's rows load as float4 when A and its row stride are
// 16-byte aligned, C's as float4 when C, ldc and n are.
template <int NT, int BN, int TM, int TN, int BK, int STAGES, int MINB,
          bool WARPA>
int launch_panel(const float* a, long long m, int k, long long lda,
                 const float* b, long long ldb_k, long long ldb_n, int n,
                 float* c, long long ldc, cudaStream_t stream) {
  constexpr int BM = NT / (BN / TN) * TM;
  auto kernel = mm_panel_kernel<NT, BN, TM, TN, BK, STAGES, MINB, WARPA>;
  const int ks = (k + BK - 1) / BK;
  const size_t smem =
      (static_cast<size_t>(ks) * BK * BN +
       static_cast<size_t>(STAGES) * BM * BK) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int slices = (n + BN - 1) / BN;
  const long long panels = (m + BM - 1) / BM;
  int grid = 0;
  e = persistent_grid(kernel, NT, smem, panels * slices, &grid);
  if (e != cudaSuccess) return e;
  const long long per_slice = grid / slices > 0 ? grid / slices : 1;
  const bool vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 4 == 0;
  const bool vec_c = reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                     ldc % 4 == 0 && n % 4 == 0;
  kernel<<<static_cast<int>(per_slice * slices), NT, smem, stream>>>(
      a, m, k, lda, vec_a, b, ldb_k, ldb_n, n, c, ldc, vec_c, slices,
      per_slice);
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

// (a): k <= 512, n <= 64; B read through (ldb_k, ldb_n) strides.  n <= 8
// (the plr ladder's ranks) is bound by bytes: 1 x 4 per thread, BK = 64
// (256 contiguous bytes per row and slice).  Any wider n runs the r = 64
// instance, bound by FMA: 8 x 8 per thread, warp-private A slices, 12 warps
// (B's 128 KB leaves room for BK = 16 only).
int lowrank_mm_tall(const float* a, long long m, int k, long long lda,
                    const float* b, long long ldb_k, long long ldb_n, int n,
                    float* c, long long ldc, cudaStream_t stream) {
  if (k < 1 || k > 512 || n < 1 || n > 64) return cudaErrorInvalidValue;
  if (n <= 8)
    return launch_panel<256, 8, 1, 4, 64, 2, 2, true>(
        a, m, k, lda, b, ldb_k, ldb_n, n, c, ldc, stream);
  return launch_panel<384, 64, 8, 8, 16, 2, 1, true>(
      a, m, k, lda, b, ldb_k, ldb_n, n, c, ldc, stream);
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
// (float4 stores; the wrapper refuses any other output).  128-column
// slices, 8 x 8 per thread, one block per SM; BK = 8 for k <= 8 (the plr
// ladder's ranks), else BK = 32 in 12 warps (the r = 64 instance).
int lowrank_mm_small_k(const float* a, long long m, int k, long long lda,
                       const float* b, long long ldb_k, long long ldb_n,
                       int n, float* c, cudaStream_t stream) {
  if (k < 1 || k > 64 || n < 1 || n > 512 || n % 4 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return cudaErrorInvalidValue;
  if (k <= 8)
    return launch_panel<256, 128, 8, 8, 8, 3, 1, false>(
        a, m, k, lda, b, ldb_k, ldb_n, n, c, n, stream);
  return launch_panel<384, 128, 8, 8, 32, 3, 1, false>(
      a, m, k, lda, b, ldb_k, ldb_n, n, c, n, stream);
}

}  // extern "C"
