// Tile-consensus N:M compacted matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nm_spmm.py: nm_spmm_pallas (body
// _kernel, selection _selection_onehot).  For x (T, D), w (D, N) and the
// optional channel scale (D,), tokens are cut into consensus tiles of `tile`
// rows (the last one may be shorter).  Per tile:
//   score = |x| * scale (float32); pooled[c] = sqrt(sum over the tile's
//   tokens of score^2); in every contiguous group of m channels keep the top
//   n pooled channels (first occurrence wins a tie), shared by the whole
//   tile; then out = x[:, kept] @ w[kept, :] with a float32 accumulator, in
//   x's dtype.  Only the G*n = D*n/m surviving columns are contracted.
//
// What bounds it on the H100: at the one-shot prefill's T = 2048 tokens
// (Qwen2-7B gate: D = 3584, N = 18944, 8:16) the compacted product does
// 2 * T * (D/2) * N = 139 GFLOP over 136 MB of weights, about 1000
// operations per weight byte, far above the card's ~295 bf16 operations per
// byte: the tensor cores are the bound (0.14 ms at 989 TFLOP/s).  The TPU
// kernel compacts x and w inside every grid step with one-hot matmuls (a
// gather does not vectorise on the TPU); on Hopper a gather is a plain
// indexed load, so the design is two kernels:
//
//  1. consensus_select_kernel: one block per (256 channels, tile).  Each
//     thread pools one channel over the tile's tokens (coalesced across the
//     threads), one thread per group runs the n rounds of strict-'>' argmax,
//     writes the tile's kept channel ids ascending into idx (n_tiles, G*n),
//     and the block gathers the kept columns into xc (T, G*n).  The sum of
//     squares is accumulated in double and rounded once to float: a float
//     square is exact in double, and the order of the sum then changes the
//     double only in its last bits, which the round to float almost always
//     removes; so the selection agrees with the plain version's
//     (core/nm.py tile_consensus_channels) on the same input, except with
//     negligible probability.
//  2. the GEMM: one block per 64x128 output tile, k walked in 32-wide steps
//     with cp.async double buffering and WMMA bf16 16x16x16 products
//     (float32 accumulate).  The B tile's row r is w[idx[tile][k0 + r], :],
//     N-contiguous, so it streams in 16-byte cp.async copies like a dense
//     row.  A block's 64 tokens never straddle two consensus tiles: the
//     launch walks (tile, 64-row block inside the tile), so every row of a
//     block shares one index list.
//
// float32 inputs take a CUDA-core FMA GEMM (no TF32) with the same
// selection.  Not yet: wgmma, TMA, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// ---------------------------------------------------------------- selection
constexpr int SEL_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(SEL_THREADS)
consensus_select_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        int* __restrict__ idx, T* __restrict__ xc, int T_, int D, int n,
                        int m, int tile) {
  __shared__ float pooled[SEL_THREADS];
  __shared__ int kept[SEL_THREADS];              // absolute kept channel ids
  const int gpb = SEL_THREADS / m;               // groups per block
  const int G = D / m, kc = G * n;
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, G - g0);               // groups this block owns
  const int ti = blockIdx.y;
  const int r0 = ti * tile, r1 = min(T_, r0 + tile);

  // 1. pool: thread i owns channel g0*m + i
  const int i = threadIdx.x;
  if (i < ng * m) {
    const int c = g0 * m + i;
    const float sc = scale != nullptr ? scale[c] : 1.f;
    double acc = 0.0;
    for (int r = r0; r < r1; ++r) {
      const float s = __fmul_rn(fabsf(to_f(x[(size_t)r * D + c])), sc);
      acc += (double)s * (double)s;              // exact square, summed in double
    }
    pooled[i] = __fsqrt_rn(__double2float_rn(acc));
  }
  __syncthreads();

  // 2. select: one thread per group, n rounds of first-occurrence argmax
  if (i < ng) {
    const float* pg = pooled + i * m;
    uint32_t keep = 0u;
    for (int round = 0; round < n; ++round) {
      int best = -1;
      float bestv = 0.f;
      for (int j = 0; j < m; ++j) {
        if ((keep >> j) & 1u) continue;
        if (best < 0 || pg[j] > bestv) { best = j; bestv = pg[j]; }
      }
      keep |= 1u << best;
    }
    int k = 0;
    for (int j = 0; j < m; ++j)                  // ascending channel order
      if ((keep >> j) & 1u) {
        const int ch = (g0 + i) * m + j;
        kept[i * n + k] = ch;
        idx[(size_t)ti * kc + (size_t)(g0 + i) * n + k] = ch;
        ++k;
      }
  }
  __syncthreads();

  // 3. compact: xc[r, g0*n + k] = x[r, kept[k]] for the tile's rows
  const int cols = ng * n;
  for (int e = threadIdx.x; e < (r1 - r0) * cols; e += SEL_THREADS) {
    const int r = r0 + e / cols, k = e % cols;
    xc[(size_t)r * kc + (size_t)g0 * n + k] = x[(size_t)r * D + kept[k]];
  }
}

// ------------------------------------------------------------------ copies
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage 16 bytes (V elements) of one row: columns [c, c+V) of `row`, a
// pointer to the row's first element (null: a row outside the operand),
// cp.async when the whole vector is inside and aligned, else element by
// element with zero fill.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* __restrict__ row, int c, int cols,
                                        bool vec_ok) {
  constexpr int V = 16 / sizeof(T);
  if (row != nullptr && vec_ok && c + V <= cols) {
    cp_async16(dst, row + c);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      dst[e] = (row != nullptr && c + e < cols) ? row[c + e] : from_f<T>(0.f);
  }
}

// The block's rows: blockIdx.x walks (consensus tile, BM-row block inside
// it), so all rows of a block share the tile's index list.
struct RowBlock {
  int tile, r0, r1;
};
template <int BM_>
__device__ __forceinline__ RowBlock row_block(int T_, int tile) {
  const int per_tile = (tile + BM_ - 1) / BM_;
  RowBlock rb;
  rb.tile = blockIdx.x / per_tile;
  const int tile_r0 = rb.tile * tile;
  rb.r0 = tile_r0 + (blockIdx.x % per_tile) * BM_;
  rb.r1 = min(T_, min(tile_r0 + tile, rb.r0 + BM_));
  return rb;
}

// ---------------------------------------------------------------- bf16 GEMM
constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256;  // 8 warps, 2 x 4 of 32x32
constexpr int LDX = BK + 8;       // bf16: 80-byte rows, 32-byte aligned fragments
constexpr int LDW = BN + 8;       // bf16: 272-byte rows
constexpr int STAGE = BM * LDX + BK * LDW;                  // bf16 elements per stage
constexpr int SMEM = 2 * STAGE * 2;
constexpr int LDE = 16 + 4;       // float per-warp epilogue fragment

__global__ void __launch_bounds__(THREADS)
spmm_bf16_kernel(const bf16* __restrict__ xc, const bf16* __restrict__ w,
                 const int* __restrict__ idx, bf16* __restrict__ out, int T_, int kc, int N,
                 int tile) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* stages = reinterpret_cast<bf16*>(smem);

  const RowBlock rb = row_block<BM>(T_, tile);
  const int* tidx = idx + (size_t)rb.tile * kc;
  const int col0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;
  const bool xvec = (kc % 8 == 0) && ((reinterpret_cast<uintptr_t>(xc) & 15) == 0);
  const bool wvec = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);

  auto load_stage = [&](int buf, int k0) {
    bf16* xs = stages + buf * STAGE;
    bf16* ws = xs + BM * LDX;
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gr = rb.r0 + r;
      stage16(xs + r * LDX + c, gr < rb.r1 ? xc + (size_t)gr * kc : nullptr, k0 + c, kc,
              xvec);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bf16* row = k0 + r < kc ? w + (size_t)tidx[k0 + r] * N : nullptr;
      stage16(ws + r * LDW + c, row, col0 + c, N, wvec);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_tiles = (kc + BK - 1) / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xs = stages + (kt & 1) * STAGE;
    const bf16* ws = xs + BM * LDX;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wr + 16 * i) * LDX + kk, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * LDW + wc + 16 * j, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();                            // stage free for the next load
  }

  // epilogue: each warp passes its fragments one at a time through a 16x16
  // float scratch (reusing the stages) and rounds them to bf16
  float* es = reinterpret_cast<float*>(smem) + warp * 16 * LDE;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(es, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = rb.r0 + wr + 16 * i + e / 16, gc = col0 + wc + 16 * j + e % 16;
        if (gr < rb.r1 && gc < N)
          out[(size_t)gr * N + gc] = __float2bfloat16(es[(e / 16) * LDE + e % 16]);
      }
      __syncwarp();
    }
}

// ------------------------------------------------------------- float32 GEMM
constexpr int BM32 = 64, BN32 = 64, BK32 = 64, THREADS32 = 256;
constexpr int LDX32 = BK32 + 4;
constexpr int LDW32 = BN32 + 4;

__global__ void __launch_bounds__(THREADS32)
spmm_f32_kernel(const float* __restrict__ xc, const float* __restrict__ w,
                const int* __restrict__ idx, float* __restrict__ out, int T_, int kc, int N,
                int tile) {
  __shared__ __align__(16) float xs[BM32 * LDX32];
  __shared__ __align__(16) float ws[BK32 * LDW32];
  const RowBlock rb = row_block<BM32>(T_, tile);
  const int* tidx = idx + (size_t)rb.tile * kc;
  const int col0 = blockIdx.y * BN32;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;   // 4x4 outputs each
  const bool xvec = (kc % 4 == 0) && ((reinterpret_cast<uintptr_t>(xc) & 15) == 0);
  const bool wvec = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < kc; k0 += BK32) {
    for (int i = threadIdx.x; i < BM32 * BK32 / 4; i += THREADS32) {
      const int r = i / (BK32 / 4), c = (i % (BK32 / 4)) * 4;
      const int gr = rb.r0 + r;
      stage16(xs + r * LDX32 + c, gr < rb.r1 ? xc + (size_t)gr * kc : nullptr, k0 + c, kc,
              xvec);
    }
    for (int i = threadIdx.x; i < BK32 * BN32 / 4; i += THREADS32) {
      const int r = i / (BN32 / 4), c = (i % (BN32 / 4)) * 4;
      const float* row = k0 + r < kc ? w + (size_t)tidx[k0 + r] * N : nullptr;
      stage16(ws + r * LDW32 + c, row, col0 + c, N, wvec);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK32; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * LDX32 + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k * LDW32 + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = rb.r0 + ty + 16 * i, gc = col0 + tx + 16 * j;
      if (gr < rb.r1 && gc < N) out[(size_t)gr * N + gc] = acc[i][j];
    }
}

template <typename T>
int launch_select(const void* x, const float* scale, int* idx, void* xc, int T_, int D, int n,
                  int m, int tile, cudaStream_t s) {
  const int gpb = SEL_THREADS / m, G = D / m;
  dim3 grid((G + gpb - 1) / gpb, (T_ + tile - 1) / tile);
  consensus_select_kernel<T><<<grid, SEL_THREADS, 0, s>>>((const T*)x, scale, idx, (T*)xc, T_,
                                                          D, n, m, tile);
  return (int)cudaGetLastError();
}

int row_blocks(int T_, int tile, int bm) {
  const int n_tiles = (T_ + tile - 1) / tile, per_tile = (tile + bm - 1) / bm;
  return n_tiles * per_tile;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers;
// scale may be null.  `idx` (n_tiles, D*n/m) int32 and `xc` (T, D*n/m) in
// x's dtype are caller-allocated scratch that receive the kept channel ids
// and the compacted activations.  Requires 0 < n <= m <= 32 and D % m == 0
// (the wrapper checks).  Launches the selection and the GEMM on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int nm_spmm_bf16(const void* x, const void* w, const float* scale, int* idx,
                            void* xc, void* out, int T, int D, int N, int n, int m, int tile,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_select<bf16>(x, scale, idx, xc, T, D, n, m, tile, s);
  if (rc != 0) return rc;
  const int kc = D / m * n;
  dim3 grid(row_blocks(T, tile, BM), (N + BN - 1) / BN);
  spmm_bf16_kernel<<<grid, THREADS, 0, s>>>((const bf16*)xc, (const bf16*)w, idx, (bf16*)out,
                                            T, kc, N, tile);
  return (int)cudaGetLastError();
}

extern "C" int nm_spmm_f32(const void* x, const void* w, const float* scale, int* idx,
                           void* xc, void* out, int T, int D, int N, int n, int m, int tile,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_select<float>(x, scale, idx, xc, T, D, n, m, tile, s);
  if (rc != 0) return rc;
  const int kc = D / m * n;
  dim3 grid(row_blocks(T, tile, BM32), (N + BN32 - 1) / BN32);
  spmm_f32_kernel<<<grid, THREADS32, 0, s>>>((const float*)xc, (const float*)w, idx,
                                             (float*)out, T, kc, N, tile);
  return (int)cudaGetLastError();
}

// The selection pass alone: idx and xc as above, for checking the chosen
// channels against the plain version.
extern "C" int nm_spmm_select_bf16(const void* x, const float* scale, int* idx, void* xc, int T,
                                   int D, int n, int m, int tile, void* stream) {
  return launch_select<bf16>(x, scale, idx, xc, T, D, n, m, tile, (cudaStream_t)stream);
}

extern "C" int nm_spmm_select_f32(const void* x, const float* scale, int* idx, void* xc, int T,
                                  int D, int n, int m, int tile, void* stream) {
  return launch_select<float>(x, scale, idx, xc, T, D, n, m, tile, (cudaStream_t)stream);
}
