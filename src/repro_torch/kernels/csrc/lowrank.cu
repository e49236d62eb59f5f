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
//   (b) Two passes, deterministic.  Every A value is used by one thread
//       only (its column's n outputs), so (b) is a stream of A at HBM's
//       rate with 4 n FMAs per 16 bytes beside it, and what it needs is
//       bytes in flight (about 25 KB per SM at 3.35 TB/s and a microsecond
//       of latency) and no stall of that stream.  The rows are cut into
//       fixed slabs (a function of m alone, never of the card), one block
//       per slab, and a block into row groups of 128 threads; thread c of a
//       group holds columns 4c .. 4c + 3 of A (16-byte copies: 128 threads
//       span a 512-wide row) against n columns of B in registers.  Each
//       group streams its own rows of A and, beside them, their rows of B
//       through a cp.async ring of its own, with a named barrier of its
//       128 threads per stage (B is read by all of them) and no block
//       barrier, so P^ never stalls the stream of A.  For n <= 8: two
//       groups of 4-row stages, 4 deep, two blocks per SM, so 96 KB of A
//       is in flight per SM, with registers to spare (two blocks of four
//       groups would cap a thread at 64 registers, and spill).  At the end
//       group 1 hands its sums to group 0 through shared memory.  Each
//       block writes its partial (n x k) to scratch that the wrapper
//       allocates; the second pass is wide: 32 float4 outputs per block,
//       16 lanes each summing every 16th slab in order, then the lanes in
//       lane order.  No atomics: the order is fixed by (m, k, n), so a
//       call repeats bit for bit, and the chain into an output is a
//       group's rows + the group adds + a lane's slabs + the lane adds
//       (1073 at the training step's 1051352 rows, r <= 8;
//       lowrank.at_b_depth).
//
// Ragged edges (m, k, n, row strides) are masked in every kernel; (c) takes
// n a multiple of 4 and a contiguous, 16-byte aligned C (the plr codec's
// widths are 128, 256 and 512).  Each C entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// (b): threads across a row (4 columns each, k <= 512); pass 2's float4
// outputs per block and slab lanes per output
constexpr int AT_B_COLS = 128, AT_B_UNITS = 32, AT_B_LANES = 16;

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

// Named barrier over the nt threads of one row group (id 0 is
// __syncthreads's)
__device__ __forceinline__ void group_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nt) : "memory");
}

// Slab s (rows [s rps, (s + 1) rps) of A) is one block of G row groups of
// AT_B_COLS * NS threads.  The block walks its slab in stages of G RS
// rows, group g summing rows g RS .. g RS + RS - 1 of each stage; thread
// (c, ns) of a group holds columns 4c .. 4c + 3 of A against B's columns
// [ns NP, (ns + 1) NP) in registers.  Each group streams its rows of A and
// of B through its own STAGES-deep cp.async ring (a named barrier per
// stage, no block barrier); at the end groups 1 .. G - 1 hand their sums
// to group 0 through shared memory, added in group order.
template <int NP, int NS, int G, int RS, int STAGES, int MINB>
__global__ void __launch_bounds__(AT_B_COLS * NS * G, MINB)
mm_at_b_partial_kernel(const float* __restrict__ a, long long m, int k,
                       long long lda, bool vec_a,
                       const float* __restrict__ b, long long ldb, int n,
                       float* __restrict__ part, long long rows_per_slab) {
  constexpr int GT = AT_B_COLS * NS;              // threads of a group
  constexpr int NB = NP * NS;                     // B columns staged
  constexpr int A_ST = RS * AT_B_COLS * 4, B_ST = RS * NB;
  constexpr int GSM = STAGES * (A_ST + B_ST);     // floats per group
  static_assert(RS % NS == 0 && NP % 4 == 0, "tile");
  static_assert((G - 1) * 4 * NP * GT <= G * GSM, "room for the sums");
  extern __shared__ float4 smem4[];
  const int g = threadIdx.x / GT, t = threadIdx.x % GT;
  const int c = t % AT_B_COLS, ns = NS == 1 ? 0 : t / AT_B_COLS;
  const int kk = 4 * c;                           // this thread's columns
  float* as = reinterpret_cast<float*>(smem4) + g * GSM;  // [STAGES][RS][512]
  float* bs = as + STAGES * A_ST;                          // [STAGES][RS][NB]

  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_slab;
  const long long hi = lo + rows_per_slab < m ? lo + rows_per_slab : m;
  const int steps = static_cast<int>((hi - lo + G * RS - 1) / (G * RS));

  // stage `issued` of this group: A's chunk c of rows ns, ns + NS, ... and
  // B's RS rows, zero-filled past the slab, k and n
  int issued = 0, istage = 0;
  auto issue = [&]() {
    if (issued < steps) {
      const long long r0 =
          lo + static_cast<long long>(issued) * (G * RS) + g * RS;
      float* ad = as + istage * A_ST + kk;
#pragma unroll
      for (int j = 0; j < RS / NS; ++j) {
        const int i = ns + j * NS;
        const long long gr = r0 + i;
        const bool in = gr < hi && kk < k;
        const float* src = a + gr * lda + kk;
        if (vec_a) {
          const int bytes = in ? 4 * min(4, k - kk) : 0;
          cp_async16(ad + i * (AT_B_COLS * 4), bytes ? src : a, bytes);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = in && kk + e < k;
            cp_async4(ad + i * (AT_B_COLS * 4) + e, ok ? src + e : a,
                      ok ? 4 : 0);
          }
        }
      }
      float* bd = bs + istage * B_ST;
      for (int i = t; i < B_ST; i += GT) {
        const int rr = i / NB, q = i - rr * NB;
        const long long gr = r0 + rr;
        const bool ok = gr < hi && q < n;
        cp_async4(bd + i, ok ? b + gr * ldb + q : b, ok ? 4 : 0);
      }
      ++issued;
      istage = istage + 1 == STAGES ? 0 : istage + 1;
    }
    cp_async_commit();
  };

  float acc[4][NP];                       // [column kk + e][B column]
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[e][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();
  int stage = 0;
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    group_sync(1 + g, GT);        // stage st landed; stage st - 1 consumed
    issue();
    const float* at = as + stage * A_ST + kk;
    const float* bt = bs + stage * B_ST + ns * NP;
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(at + i * (AT_B_COLS * 4));
#pragma unroll
      for (int q4 = 0; q4 < NP / 4; ++q4) {
        const float4 p = *reinterpret_cast<const float4*>(bt + i * NB + 4 * q4);
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = 4 * q4 + u;
          acc[0][q] = fmaf(v.x, pv[u], acc[0][q]);
          acc[1][q] = fmaf(v.y, pv[u], acc[1][q]);
          acc[2][q] = fmaf(v.z, pv[u], acc[2][q]);
          acc[3][q] = fmaf(v.w, pv[u], acc[3][q]);
        }
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  if constexpr (G > 1) {
    // the stages are free: groups 1 .. G - 1 leave their sums there,
    // group 0 adds them in group order
    float* red = reinterpret_cast<float*>(smem4);
    __syncthreads();
    if (g > 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < NP; ++q)
          red[(((g - 1) * 4 + e) * NP + q) * GT + t] = acc[e][q];
    }
    __syncthreads();
    if (g > 0) return;
    for (int h = 1; h < G; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < NP; ++q)
          acc[e][q] += red[(((h - 1) * 4 + e) * NP + q) * GT + t];
  }
  // the slab's partial as [n][kp], kp = k rounded up to 4 (float4 stores)
  if (kk < k) {
    const int kp = (k + 3) & ~3;
    float* out = part + static_cast<long long>(blockIdx.x) * n * kp + kk;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int col = ns * NP + q;
      if (col < n)
        *reinterpret_cast<float4*>(out + static_cast<long long>(col) * kp) =
            make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
    }
  }
}

// Pass 2: C (k x n) from the slabs' partials.  A block takes AT_B_UNITS
// float4s of the [n][kp] partial; lane l of each sums slabs l, l +
// AT_B_LANES, ... in order, then lane 0 adds the lanes in lane order.
__global__ void __launch_bounds__(AT_B_UNITS * AT_B_LANES)
mm_at_b_sum_kernel(const float* __restrict__ part, int slabs, int k, int n,
                   float* __restrict__ c, long long ldc) {
  __shared__ float4 red[AT_B_LANES][AT_B_UNITS];
  const int kq = (k + 3) / 4, units = n * kq;
  const int ul = threadIdx.x % AT_B_UNITS, lane = threadIdx.x / AT_B_UNITS;
  const int u = blockIdx.x * AT_B_UNITS + ul;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (u < units) {
    const float4* p = reinterpret_cast<const float4*>(part) + u;
#pragma unroll 4
    for (int t = lane; t < slabs; t += AT_B_LANES) {
      const float4 v = __ldg(p + static_cast<long long>(t) * units);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  red[lane][ul] = s;
  __syncthreads();
  if (lane != 0 || u >= units) return;
  for (int l = 1; l < AT_B_LANES; ++l) {
    const float4 v = red[l][ul];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int q = u / kq, kk = 4 * (u - q * kq);
  const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (kk + e < k) c[(kk + e) * ldc + q] = sv[e];
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

// (b): pass 1 over `slabs` slabs of rows_per_slab rows into `part`
// (slabs * n * kp floats), then pass 2 into C.  A's rows stage as 16-byte
// copies when A and its row stride are 16-byte aligned, else 4 bytes at a
// time.
template <int NP, int NS, int G, int RS, int STAGES, int MINB>
int launch_at_b(const float* a, long long m, int k, long long lda,
                const float* b, long long ldb, int n, float* c,
                long long ldc, float* part, int slabs,
                long long rows_per_slab, cudaStream_t stream) {
  auto kernel = mm_at_b_partial_kernel<NP, NS, G, RS, STAGES, MINB>;
  constexpr size_t smem = static_cast<size_t>(G) * STAGES *
                          (RS * AT_B_COLS * 4 + RS * NP * NS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const bool vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 4 == 0;
  kernel<<<slabs, AT_B_COLS * NS * G, smem, stream>>>(
      a, m, k, lda, vec_a, b, ldb, n, part, rows_per_slab);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int units = n * ((k + 3) / 4);
  mm_at_b_sum_kernel<<<(units + AT_B_UNITS - 1) / AT_B_UNITS,
                       AT_B_UNITS * AT_B_LANES, 0, stream>>>(
      part, slabs, k, n, c, ldc);
  return cudaGetLastError();
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
// `part` holds slabs * n * kp floats (kp = k rounded up to 4), slab s
// covering rows [s * rows_per_slab, (s + 1) * rows_per_slab).  n <= 8 (the
// plr ladder's ranks) is bound by bytes: 2 row groups of 128 threads per
// slab, two blocks per SM.  Any wider n runs one untuned instance: a group
// of 512 threads, four per column quad, 16 of B's columns each.
int lowrank_mm_at_b(const float* a, long long m, int k, long long lda,
                    const float* b, long long ldb, int n, float* c,
                    long long ldc, float* part, int slabs,
                    long long rows_per_slab, cudaStream_t stream) {
  if (k < 1 || k > 4 * AT_B_COLS || n < 1 || n > 64 || slabs < 1 ||
      rows_per_slab < 1)
    return cudaErrorInvalidValue;
  if (n <= 8)
    return launch_at_b<8, 1, 2, 4, 4, 2>(a, m, k, lda, b, ldb, n, c, ldc,
                                         part, slabs, rows_per_slab, stream);
  return launch_at_b<16, 4, 1, 8, 3, 1>(a, m, k, lda, b, ldb, n, c, ldc, part,
                                        slabs, rows_per_slab, stream);
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
