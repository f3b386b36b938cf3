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
//  1. the selection runs once and writes the pruned channels to a scratch
//     copy of x: |x| bytes written and read once (7 MB at T=256, D=14336:
//     ~6% of the weight read), where masking inside the GEMM would redo the
//     selection in every one of the N/BN column blocks.
//     nm_select_vec_kernel moves x and the result as 16-byte vectors and the
//     scale as float4, keeps a chunk's scores in registers, and finds each
//     group's n-th largest score with a sorting network instead of n serial
//     rounds of argmax; a grid-stride walk loads the next chunk before
//     selecting in this one.  Bound: 4 bytes a bf16 element.  Other group
//     widths and unaligned pointers take nm_select_kernel (one thread per
//     group, n rounds of strict-'>' argmax); both give the same masks.
//  2. the GEMM, nm_matmul_wgmma_kernel: one block per 256 x 128 output tile
//     (the whole 256-token chunk, so each weight tile is read from device
//     memory once), four consumer warpgroups of 64 rows and a producer warp
//     that keeps a 4-stage ring of 48 KB (x 256 x 64, w 64 x 128) full with
//     TMA under full/empty mbarriers; m64n128k16 wgmmas from shared memory
//     (x K-major, w MN-major as stored: no transposed copy) accumulate in
//     float32 registers, one k step's products in flight while the next is
//     issued.  It is launched as a programmatic dependent of the selection
//     pass: its producer issues the first ring of w tiles while the pass
//     may still run, then waits for it (griddepcontrol) before loading x.
//     Where the output tiles fill under half the SMs (q and down at T=256:
//     32 tiles) k is split so that about one block runs per SM; the slices
//     write float32 partials to a workspace the wrapper allocates, and
//     nm_splitk_reduce_kernel (a programmatic dependent of the GEMM, so its
//     launch overlaps the GEMM's epilogue) adds them in slice order with
//     the bias and rounds once to bf16 (deterministic: no atomics).  Unsplit, the
//     epilogue adds the bias to the float32 sum and rounds once, as the
//     WMMA kernel does.
//     Shapes the TMA cannot take (w not 16-byte aligned, D or N not a
//     multiple of 8) go to nm_matmul_bf16_kernel: one block per 64 x 128
//     tile, k in 32-wide steps double-buffered with cp.async, WMMA bf16
//     16x16x16 products.  A shape dispatch between two hand kernels, not a
//     fallback to the plain version.
//
// What bounds it now (chip_smoke.py phase 2a on an H100): the GEMM multiplies
// the pruned zeros too (2 T D N operations, 30 GFLOP for gate: as long on
// the tensor cores as its 117 MB of weights take to read), it fills 112 of
// 132 SMs at gate's 112 tiles, and the selection pass adds its own stream.
//
// float32 inputs take a CUDA-core FMA GEMM with the same selection step.
// Not yet: a persistent (stream-k) schedule, TMA multicast of the x tile
// across a cluster, a TMA-store epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

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
// first-occurrence argmax, so the masks are bit-identical.  `keep_out`, when
// not null, receives the selection itself, one byte per channel (1 = kept):
// the training backward's mask, in which a kept channel whose value is 0
// still passes its gradient.  Every serving call passes null.
template <typename T>
__global__ void nm_select_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                 T* __restrict__ xp, uint8_t* __restrict__ keep_out, int T_,
                                 int D, int n, int m) {
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
  if (keep_out != nullptr) {
    uint8_t* pk = keep_out + (size_t)r * D + (size_t)g * m;
    for (int j = 0; j < m; ++j) pk[j] = (uint8_t)((keep >> j) & 1u);
  }
}

// The same selection, vectorised: one thread per E = max(M, 16 / sizeof(T))
// consecutive elements of a row (whole groups in whole 16-byte vectors).  x
// comes in and the result goes out as uint4, the scale as float4.  Each
// group's mask comes from hopper::nm_keep (a sorting network in place of n
// serial rounds of argmax; bit-identical for finite scores).  Bound by the 4
// bytes a bf16 element moves (read once, written once); `keep_out` as in
// nm_select_kernel (one more byte an element where it is not null).
template <typename T>
__device__ __forceinline__ float word_elem(const uint32_t* w, int j) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(((w[j >> 1] >> ((j & 1) * 16)) & 0xFFFFu) << 16);
  else
    return __uint_as_float(w[j]);
}

template <typename T, int M>
__global__ void __launch_bounds__(256)
nm_select_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     T* __restrict__ xp, uint8_t* __restrict__ keep_out, unsigned chunks, int D,
                     int n) {
  constexpr int V = 16 / sizeof(T);              // elements per 16-byte vector
  constexpr int E = M > V ? M : V;               // elements per chunk
  constexpr int NW = E * sizeof(T) / 4;          // 32-bit words per chunk
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");   // the GEMM may launch
  const unsigned per_row = (unsigned)D / E;      // chunks per row
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  auto load = [&](uint32_t (&w)[NW], unsigned c) {
#pragma unroll
    for (int k = 0; k < NW / 4; ++k) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + (size_t)c * E) + k);
      w[4 * k] = u.x, w[4 * k + 1] = u.y, w[4 * k + 2] = u.z, w[4 * k + 3] = u.w;
    }
  };
  if (i >= chunks) return;
  uint32_t w[NW];
  load(w, i);
  // a grid-stride walk that loads the next chunk before selecting in this
  // one, so the pass's compute hides under its memory traffic
  for (; i < chunks; i += stride) {
    uint32_t nxt[NW];
    const bool more = i + stride < chunks;
    if (more) load(nxt, i + stride);
    const size_t e0 = (size_t)i * E;
    const int c0 = (int)(i % per_row) * E;
    float s[E];                                  // |x| * scale (no scale: * 1, exact)
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 sc = scale != nullptr ? __ldg(reinterpret_cast<const float4*>(scale + c0) + k)
                                         : make_float4(1.f, 1.f, 1.f, 1.f);
      s[4 * k] = fabsf(word_elem<T>(w, 4 * k)) * sc.x;
      s[4 * k + 1] = fabsf(word_elem<T>(w, 4 * k + 1)) * sc.y;
      s[4 * k + 2] = fabsf(word_elem<T>(w, 4 * k + 2)) * sc.z;
      s[4 * k + 3] = fabsf(word_elem<T>(w, 4 * k + 3)) * sc.w;
    }
    uint32_t keep = 0u;
#pragma unroll
    for (int g = 0; g < E / M; ++g) keep |= hopper::nm_keep<M>(s + g * M, n) << (g * M);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if constexpr (sizeof(T) == 2)
        w[k] &= (((keep >> (2 * k)) & 1u) ? 0x0000FFFFu : 0u) |
                (((keep >> (2 * k + 1)) & 1u) ? 0xFFFF0000u : 0u);
      else
        w[k] = ((keep >> k) & 1u) ? w[k] : 0u;
    }
#pragma unroll
    for (int k = 0; k < NW / 4; ++k)
      reinterpret_cast<uint4*>(xp + e0)[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2],
                                                        w[4 * k + 3]);
    if (keep_out != nullptr) {
#pragma unroll
      for (int j = 0; j < E; ++j) keep_out[e0 + j] = (uint8_t)((keep >> j) & 1u);
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = nxt[k];
    }
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

// ---------------------------------------------------------- bf16 wgmma GEMM
// One block per 256 x 128 output tile (and k slice, when split): four
// consumer warpgroups of 64 rows each and one producer warp.  The producer's
// lane 0 keeps a ring of GSTAGES stages full with TMA: the pruned x tile
// (256 x 64, K-major) and the w tile (64 x 128 as two 64-column chunks, N
// contiguous as w is stored: the MN-major B operand).  The consumers run
// m64n128k16 wgmmas from shared memory into float32 registers, one k step's
// group in flight while the next is issued, and hand a stage back through
// its empty barrier.
constexpr int GM = 256, GN = 128, GK = 64, GSTAGES = 4, GWG = 4;
constexpr int G_THREADS = GWG * 128 + 32;
constexpr int G_XTILE = GM * GK * 2;             // 32 KB
constexpr int G_WCHUNK = GK * 128;               // 8 KB: 64 k rows x 64 columns
constexpr int G_STAGE = G_XTILE + 2 * G_WCHUNK;  // 48 KB
constexpr int G_SMEM = GSTAGES * G_STAGE + 1024;

__global__ void __launch_bounds__(G_THREADS, 1)
nm_matmul_wgmma_kernel(__grid_constant__ const CUtensorMap xmap,
                       __grid_constant__ const CUtensorMap wmap, const float* __restrict__ bias,
                       bf16* __restrict__ out, float* __restrict__ part, int T_, int N,
                       int k_steps, int steps_per_split) {
  using namespace hopper;
  extern __shared__ unsigned char gsmem_raw[];
  unsigned char* sm = align1024(gsmem_raw);
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES];
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN, split = blockIdx.z;
  const int ks0 = split * steps_per_split;
  const int n_steps = min(k_steps, ks0 + steps_per_split) - ks0;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GWG * 4);              // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == GWG) {                                // producer warp
    if (lane == 0) {
      // the first ring of w tiles does not depend on the selection pass
      // that writes x (launched just before, with this kernel allowed to
      // start early): issue it, then wait for that pass before any x
      const int first = min(GSTAGES, n_steps);
      for (int j = 0; j < first; ++j) {
        const int k0 = (ks0 + j) * GK;
        unsigned char* st = sm + j * G_STAGE;
        mbar_arrive_expect_tx(&full[j], G_STAGE);
        tma_load_2d(st + G_XTILE, &wmap, &full[j], n0, k0);
        tma_load_2d(st + G_XTILE + G_WCHUNK, &wmap, &full[j], n0 + 64, k0);
      }
      asm volatile("griddepcontrol.wait;" ::: "memory");
      for (int j = 0; j < first; ++j)
        tma_load_2d(sm + j * G_STAGE, &xmap, &full[j], (ks0 + j) * GK, m0);
      for (int j = first; j < n_steps; ++j) {
        const int s = j % GSTAGES, k0 = (ks0 + j) * GK;
        mbar_wait(&empty[s], (j / GSTAGES - 1) & 1);
        unsigned char* st = sm + s * G_STAGE;
        mbar_arrive_expect_tx(&full[s], G_STAGE);
        tma_load_2d(st, &xmap, &full[s], k0, m0);
        tma_load_2d(st + G_XTILE, &wmap, &full[s], n0, k0);
        tma_load_2d(st + G_XTILE + G_WCHUNK, &wmap, &full[s], n0 + 64, k0);
      }
    }
    return;
  }

  const int warp = (threadIdx.x % 128) / 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_steps; ++j) {
    const int s = j % GSTAGES;
    mbar_wait(&full[s], (j / GSTAGES) & 1);
    // every warpgroup runs its products, rows past T included (they are
    // zeros from the TMA and never stored): a branch around wgmma would
    // make the compiler serialize them
    const unsigned char* xs = sm + s * G_STAGE + wg * 64 * 128;
    const unsigned char* ws = sm + s * G_STAGE + G_XTILE;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
      wgmma_m64n128k16_ss<1>(acc, desc_k_major(xs + kk * 32),
                             desc_mn_major(ws + kk * 16 * 128, G_WCHUNK), 1);
    wgmma_commit();
    wgmma_wait<1>();                              // step j - 1's products are done
    fence_regs(acc);
    __syncwarp();
    if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % GSTAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // the split-k reduce may launch while the blocks write their partials
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // epilogue: bias on the float32 sum and one round to bf16, or the float32
  // partial of this k slice
  const int rbase = m0 + wg * 64 + warp * 16 + lane / 4;
  const int cbase = n0 + 2 * (lane % 4);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = rbase + 8 * hr;
    if (row >= T_) continue;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int col = cbase + 8 * j;
      if (col >= N) continue;                     // N % 8 == 0: col + 1 < N too
      float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
      if (part != nullptr) {
        *reinterpret_cast<float2*>(part + ((size_t)split * T_ + row) * N + col) =
            make_float2(v0, v1);
      } else {
        if (bias != nullptr) v0 += bias[col], v1 += bias[col + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// out = bf16(sum of the k slices' float32 partials, in slice order, + bias):
// the split-k reduce, deterministic (hopper::splitk_reduce_bf16).
__global__ void __launch_bounds__(256)
nm_splitk_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                        bf16* __restrict__ out, int T_, int N, int splits) {
  hopper::splitk_reduce_bf16(part, bias, out, T_, N, splits);
}

// Test-only known answer for hopper.cuh (no model path calls it): one
// m64n128k16 wgmma of a (64 x 16) by b (16 x 128), both row-major bf16,
// staged into the 128-byte swizzle by ordinary stores; out (64 x 128) f32.
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   float* __restrict__ out) {
  using namespace hopper;
  __shared__ unsigned char raw[3 * 8192 + 1024];
  unsigned char* sa = align1024(raw);             // 64 rows of 16 k (K-major)
  unsigned char* sb = sa + 8192;                  // 16 k rows x 2 chunks of 64 n
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 2; i += 128) {
    const int r = i / 2, c = i % 2;
    *reinterpret_cast<uint4*>(sa + r * 128 + ((c ^ (r % 8)) * 16)) =
        *reinterpret_cast<const uint4*>(a + r * 16 + c * 8);
  }
  for (int i = t; i < 16 * 16; i += 128) {
    const int r = i / 16, p = i % 16;
    *reinterpret_cast<uint4*>(sb + (p / 8) * 8192 + r * 128 + (((p % 8) ^ (r % 8)) * 16)) =
        *reinterpret_cast<const uint4*>(b + r * 128 + p * 8);
  }
  fence_proxy_async();
  __syncthreads();
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wgmma_fence();
  fence_regs(d);
  wgmma_m64n128k16_ss<1>(d, desc_k_major(sa), desc_mn_major(sb, 8192), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(warp * 16 + lane / 4 + 8 * (i / 2)) * 128 + 8 * j + 2 * (lane % 4) + i % 2] =
          d[4 * j + i];
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

// Streaming multiprocessors of the current device.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0)
    return 132;
  return sms;
}

template <typename T, int M>
int launch_select_vec(const void* x, const float* scale, void* xp, uint8_t* keep,
                      long long elems, int D, int n, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int E = M > V ? M : V;
  const unsigned chunks = (unsigned)(elems / E);
  // two blocks an SM: about three chunks a thread at the serving chunk's sizes
  const unsigned blocks = std::min((chunks + 255) / 256, 2u * sm_count());
  nm_select_vec_kernel<T, M><<<blocks, 256, 0, stream>>>((const T*)x, scale, (T*)xp, keep,
                                                         chunks, D, n);
  return (int)cudaGetLastError();
}

// The selection: the vectorised kernel where m is a power of two, every
// thread's span holds whole groups of a row, the pointers are 16-byte
// aligned and x has under 2^31 elements; else one thread per group.  `keep`
// (null, or T x D bytes) receives the selection.
template <typename T>
int launch_select(const void* x, const float* scale, void* xp, uint8_t* keep, int T_, int D,
                  int n, int m, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int span = m > V ? m : V;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xp) |
                         reinterpret_cast<uintptr_t>(scale)) & 15) == 0;
  const long long elems = (long long)T_ * D;
  if (aligned && D % span == 0 && elems < (1LL << 31)) {
    switch (m) {
      case 1: return launch_select_vec<T, 1>(x, scale, xp, keep, elems, D, n, stream);
      case 2: return launch_select_vec<T, 2>(x, scale, xp, keep, elems, D, n, stream);
      case 4: return launch_select_vec<T, 4>(x, scale, xp, keep, elems, D, n, stream);
      case 8: return launch_select_vec<T, 8>(x, scale, xp, keep, elems, D, n, stream);
      case 16: return launch_select_vec<T, 16>(x, scale, xp, keep, elems, D, n, stream);
      case 32: return launch_select_vec<T, 32>(x, scale, xp, keep, elems, D, n, stream);
      default: break;
    }
  }
  const long long work = (long long)T_ * (D / m);
  const int threads = 256;
  nm_select_kernel<T><<<(unsigned)((work + threads - 1) / threads), threads, 0, stream>>>(
      (const T*)x, scale, (T*)xp, keep, T_, D, n, m);
  return (int)cudaGetLastError();
}

// The bf16 GEMM's plan: 0 = the WMMA kernel (w not 16-byte aligned, or a row
// of x or w not a whole number of 16-byte pieces: TMA cannot take those),
// else the wgmma kernel in that many k slices.  A grid of output tiles that
// fills under half the SMs is split along k (at least 8 k steps a slice) so
// that about one block runs per SM; the partials then go through the
// ordered reduce.
int gemm_plan(const void* w, int T_, int D, int N) {
  if ((reinterpret_cast<uintptr_t>(w) & 15) || D % 8 || N % 8) return 0;
  const int sms = sm_count();
  const int tiles = ((T_ + GM - 1) / GM) * ((N + GN - 1) / GN);
  const int k_steps = (D + GK - 1) / GK;
  if (2 * tiles > sms) return 1;
  const int splits = max(1, min(min(sms / tiles, k_steps / 8), 8));
  const int per = (k_steps + splits - 1) / splits;
  return (k_steps + per - 1) / per;               // no empty slice
}

int launch_gemm(const void* xp, const void* w, const float* bias, void* out, float* part,
                int T_, int D, int N, int splits, cudaStream_t s) {
  CUtensorMap xm, wm;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)T_};
  const cuuint64_t xstr[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {GK, GM};
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)D};
  const cuuint64_t wstr[1] = {(cuuint64_t)N * 2};
  const cuuint32_t wbox[2] = {64, GK};
  int rc = hopper::encode_bf16_sw128(&xm, xp, 2, xdims, xstr, xbox);
  if (rc == 0) rc = hopper::encode_bf16_sw128(&wm, w, 2, wdims, wstr, wbox);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(nm_matmul_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int k_steps = (D + GK - 1) / GK;
  const int per = (k_steps + splits - 1) / splits;
  // may start while the stream's previous kernel (the selection) runs
  e = hopper::launch_dependent(nm_matmul_wgmma_kernel,
                               dim3((T_ + GM - 1) / GM, (N + GN - 1) / GN, splits),
                               dim3(G_THREADS), G_SMEM, s, xm, wm, bias, (bf16*)out, part, T_,
                               N, k_steps, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers;
// scale and bias may be null; `xp` is caller-allocated scratch shaped like
// x that receives the pruned activations, `part` a float32 workspace of
// plan * T * N elements when nm_prune_matmul_bf16_plan returns plan > 1
// (else unused, may be null), `keep` null or T * D bytes that receive the
// selection (1 = kept; the training backward's mask), `plan` the GEMM's plan
// to take: -1 for this call's own (nm_prune_matmul_bf16_plan), else one
// that call gave for the same D (a column shard takes the unsharded call's,
// so its float32 sums run in the same order; a plan above 0 needs a w the
// TMA takes).  Launches the selection, the GEMM (and the split-k reduce) on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int nm_prune_matmul_bf16_plan(const void* w, int T, int D, int N) {
  return gemm_plan(w, T, D, N);
}

extern "C" int nm_prune_matmul_bf16(const void* x, const void* w, const float* scale,
                                    const float* bias, void* xp, void* out, float* part,
                                    uint8_t* keep, int T, int D, int N, int n, int m,
                                    int plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (plan > 0 && ((reinterpret_cast<uintptr_t>(w) & 15) || D % 8 || N % 8))
    return (int)cudaErrorInvalidValue;
  int rc = launch_select<bf16>(x, scale, xp, keep, T, D, n, m, s);
  if (rc != 0) return rc;
  const int splits = plan < 0 ? gemm_plan(w, T, D, N) : plan;
  if (splits == 0) {                              // the shape route: WMMA
    dim3 grid((T + BM - 1) / BM, (N + BN - 1) / BN);
    nm_matmul_bf16_kernel<<<grid, THREADS, 0, s>>>((const bf16*)xp, (const bf16*)w, bias,
                                                   (bf16*)out, T, D, N);
    return (int)cudaGetLastError();
  }
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  rc = launch_gemm(xp, w, bias, out, splits > 1 ? part : nullptr, T, D, N, splits, s);
  if (rc != 0 || splits == 1) return rc;
  const long long quads = (long long)T * N / 4;
  const cudaError_t e = hopper::launch_dependent(
      nm_splitk_reduce_kernel, dim3((unsigned)((quads + 255) / 256)), dim3(256), 0, s,
      (const float*)part, bias, (bf16*)out, T, N, splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Test-only known answers for hopper.cuh.  mode 0: one m64n128k16 wgmma, a
// (64 x 16) @ b (16 x 128) -> out (64 x 128); mode 1: the wgmma GEMM's
// pipelined k loop in one slice, a (M x K) @ b (K x N) -> out (M x N), with
// K and N multiples of 8.  Inputs row-major bf16, out float32.
extern "C" int wgmma_probe_bf16(const void* a, const void* b, float* out, int mode, int M,
                                int K, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    if (M != 64 || K != 16 || N != 128) return (int)cudaErrorInvalidValue;
    wgmma_probe_kernel<<<1, 128, 0, s>>>((const bf16*)a, (const bf16*)b, out);
    return (int)cudaGetLastError();
  }
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  return launch_gemm(a, b, nullptr, nullptr, out, M, K, N, 1, s);
}

extern "C" int nm_prune_matmul_f32(const void* x, const void* w, const float* scale,
                                   const float* bias, void* xp, void* out, uint8_t* keep,
                                   int T, int D, int N, int n, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_select<float>(x, scale, xp, keep, T, D, n, m, s);
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
// group) keeps the group's scores in registers.  `keep`, when not null,
// receives the selection (T * D bytes, 1 = kept): the training backward's
// mask; null wherever autograd records nothing.
extern "C" int nm_prune_bf16(const void* x, const float* scale, void* out, uint8_t* keep, int T,
                             int D, int n, int m, void* stream) {
  return launch_select<bf16>(x, scale, out, keep, T, D, n, m, (cudaStream_t)stream);
}

extern "C" int nm_prune_f32(const void* x, const float* scale, void* out, uint8_t* keep, int T,
                            int D, int n, int m, void* stream) {
  return launch_select<float>(x, scale, out, keep, T, D, n, m, (cudaStream_t)stream);
}
