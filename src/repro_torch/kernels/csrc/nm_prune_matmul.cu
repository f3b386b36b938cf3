// Fused per-token Amber N:M prune + GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/nm_prune_matmul.py:
// nm_prune_matmul_pallas (body _kernel, selection nm_prune.py
// _select_topn_mask).  Computes, per token row of x (T, D):
//   score = |x| * scale (float32), keep the top n of every contiguous group
//   of m channels (first occurrence wins a tie), zero the rest, then
//   out = x_pruned @ w (+ bias) with a float32 accumulator.
//
// What bounds it on the H100: at the serving path's prefill chunk
// (T = 256 tokens) the product does 2*T*D*N operations on D*N weights, about
// 256 operations per weight byte, under the card's ~295 bf16 operations per
// byte, so the weight read from device memory is the bound (LLaMA-3.1-8B
// gate/down: 117 MB per launch).  The design answers that in two steps:
//
//  1. nm_select_kernel: one thread per (token, group) runs the selection
//     once and writes the group's pruned channels to a scratch copy of x.
//     That costs |x| bytes written and read once (7 MB at T=256, D=14336:
//     ~6% of the weight read), where masking inside the GEMM would redo
//     the selection, or re-apply it, in every one of the N/BN column blocks
//     — on this card that per-tile work, not the bytes, was the cost.
//  2. the GEMM: one block per 64x128 output tile walks k in 32-wide tiles,
//     double-buffered with cp.async so the next x and w tiles stream in
//     while the tensor cores (WMMA bf16 16x16x16, float32 accumulate) work
//     on the current ones.  The token tile is blockIdx.x (the fastest launch
//     order), so the T/64 blocks that share a weight tile run together and
//     re-read it from L2, not from device memory.
//
// float32 inputs take a CUDA-core FMA GEMM with the same selection step.
// Not yet: wgmma, TMA, a persistent schedule.

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
// One thread per (row, group): n rounds of argmax over the m scores, a
// strict '>' keeping the lowest index on ties — the JAX package's iterative
// first-occurrence argmax, so the masks are bit-identical.
template <typename T>
__global__ void nm_select_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                 T* __restrict__ xp, int T_, int D, int n, int m) {
  const int groups = D / m;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)T_ * groups) return;
  const int r = (int)(idx / groups), g = (int)(idx % groups);
  const T* px = x + (size_t)r * D + (size_t)g * m;
  float s[32];
  for (int j = 0; j < m; ++j)
    s[j] = fabsf(to_f(px[j])) * (scale != nullptr ? scale[g * m + j] : 1.f);
  uint32_t keep = 0u;
  for (int round = 0; round < n; ++round) {
    int best = -1;
    float bestv = 0.f;
    for (int j = 0; j < m; ++j) {
      if ((keep >> j) & 1u) continue;
      if (best < 0 || s[j] > bestv) { best = j; bestv = s[j]; }
    }
    keep |= 1u << best;
  }
  T* po = xp + (size_t)r * D + (size_t)g * m;
  for (int j = 0; j < m; ++j) po[j] = ((keep >> j) & 1u) ? px[j] : from_f<T>(0.f);
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

// Stage 16 bytes (V elements) of row r, columns [c, c+V) of a row-major
// (rows, cols) matrix: cp.async when the whole vector is inside and
// aligned, else element by element with zero fill.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* __restrict__ src, int r, int c,
                                        int rows, int cols, bool vec_ok) {
  constexpr int V = 16 / sizeof(T);
  if (r < rows && vec_ok && c + V <= cols) {
    cp_async16(dst, src + (size_t)r * cols + c);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      dst[e] = (r < rows && c + e < cols) ? src[(size_t)r * cols + c + e] : from_f<T>(0.f);
  }
}

// ---------------------------------------------------------------- bf16 GEMM
constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256;  // 8 warps, 2 x 4 of 32x32
constexpr int LDX = BK + 8;       // bf16: 80-byte rows, 32-byte aligned fragments
constexpr int LDW = BN + 8;       // bf16: 272-byte rows
constexpr int STAGE = BM * LDX + BK * LDW;                  // bf16 elements per stage
constexpr int SMEM = 2 * STAGE * 2;
constexpr int LDE = 16 + 4;       // float per-warp epilogue fragment

__global__ void __launch_bounds__(THREADS)
nm_matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ bias, bf16* __restrict__ out, int T_,
                      int D, int N) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* stages = reinterpret_cast<bf16*>(smem);

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;
  const bool xvec = (D % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool wvec = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);

  auto load_stage = [&](int buf, int k0) {
    bf16* xs = stages + buf * STAGE;
    bf16* ws = xs + BM * LDX;
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      stage16(xs + r * LDX + c, x, row0 + r, k0 + c, T_, D, xvec);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      stage16(ws + r * LDW + c, w, k0 + r, col0 + c, D, N, wvec);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_tiles = (D + BK - 1) / BK;
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

  // epilogue: each warp passes its fragments one at a time through a
  // 16x16 float scratch (reusing the stages), adds the bias on the f32 sum
  float* es = reinterpret_cast<float*>(smem) + warp * 16 * LDE;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(es, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + wr + 16 * i + e / 16, gc = col0 + wc + 16 * j + e % 16;
        if (gr < T_ && gc < N) {
          float v = es[(e / 16) * LDE + e % 16];
          if (bias != nullptr) v += bias[gc];
          out[(size_t)gr * N + gc] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
}

// ------------------------------------------------------------- float32 GEMM
constexpr int BM32 = 64, BN32 = 64, BK32 = 64, THREADS32 = 256;
constexpr int LDX32 = BK32 + 4;
constexpr int LDW32 = BN32 + 4;

__global__ void __launch_bounds__(THREADS32)
nm_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int T_, int D,
                     int N) {
  __shared__ __align__(16) float xs[BM32 * LDX32];
  __shared__ __align__(16) float ws[BK32 * LDW32];
  const int row0 = blockIdx.x * BM32;
  const int col0 = blockIdx.y * BN32;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;   // 4x4 outputs each
  const bool xvec = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool wvec = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < D; k0 += BK32) {
    for (int i = threadIdx.x; i < BM32 * BK32 / 4; i += THREADS32) {
      const int r = i / (BK32 / 4), c = (i % (BK32 / 4)) * 4;
      stage16(xs + r * LDX32 + c, x, row0 + r, k0 + c, T_, D, xvec);
    }
    for (int i = threadIdx.x; i < BK32 * BN32 / 4; i += THREADS32) {
      const int r = i / (BN32 / 4), c = (i % (BN32 / 4)) * 4;
      stage16(ws + r * LDW32 + c, w, k0 + r, col0 + c, D, N, wvec);
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
      const int gr = row0 + ty + 16 * i, gc = col0 + tx + 16 * j;
      if (gr < T_ && gc < N)
        out[(size_t)gr * N + gc] = acc[i][j] + (bias != nullptr ? bias[gc] : 0.f);
    }
}

template <typename T>
int launch_select(const void* x, const float* scale, void* xp, int T_, int D, int n, int m,
                  cudaStream_t stream) {
  const long long work = (long long)T_ * (D / m);
  const int threads = 256;
  nm_select_kernel<T><<<(unsigned)((work + threads - 1) / threads), threads, 0, stream>>>(
      (const T*)x, scale, (T*)xp, T_, D, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers;
// scale and bias may be null; `xp` is caller-allocated scratch shaped like
// x that receives the pruned activations.  Launches the selection and the
// GEMM on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int nm_prune_matmul_bf16(const void* x, const void* w, const float* scale,
                                    const float* bias, void* xp, void* out, int T, int D,
                                    int N, int n, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_select<bf16>(x, scale, xp, T, D, n, m, s);
  if (rc != 0) return rc;
  dim3 grid((T + BM - 1) / BM, (N + BN - 1) / BN);
  nm_matmul_bf16_kernel<<<grid, THREADS, 0, s>>>((const bf16*)xp, (const bf16*)w, bias,
                                                 (bf16*)out, T, D, N);
  return (int)cudaGetLastError();
}

extern "C" int nm_prune_matmul_f32(const void* x, const void* w, const float* scale,
                                   const float* bias, void* xp, void* out, int T, int D,
                                   int N, int n, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_select<float>(x, scale, xp, T, D, n, m, s);
  if (rc != 0) return rc;
  dim3 grid((T + BM32 - 1) / BM32, (N + BN32 - 1) / BN32);
  nm_matmul_f32_kernel<<<grid, THREADS32, 0, s>>>((const float*)xp, (const float*)w, bias,
                                                  (float*)out, T, D, N);
  return (int)cudaGetLastError();
}

// The selection pass alone (replaces the TPU kernel repro/kernels/nm_prune.py:
// nm_prune_pallas): out (T, D), in x's dtype, is x with all but the top n of
// every group of m channels by |x| * scale zeroed.  It is bound by reading x
// and writing out once (4 bytes per bf16 element); one thread per (token,
// group) keeps the group's scores in registers.
extern "C" int nm_prune_bf16(const void* x, const float* scale, void* out, int T, int D, int n,
                             int m, void* stream) {
  return launch_select<bf16>(x, scale, out, T, D, n, m, (cudaStream_t)stream);
}

extern "C" int nm_prune_f32(const void* x, const float* scale, void* out, int T, int D, int n,
                            int m, void* stream) {
  return launch_select<float>(x, scale, out, T, D, n, m, (cudaStream_t)stream);
}
