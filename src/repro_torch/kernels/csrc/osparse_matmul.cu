// Outstanding-sparse projection and W8A8 int8 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/osparse_matmul.py:
// osparse_matmul_pallas (with _pruned_smoothed and _quantize) and
// repro/kernels/w8a8_matmul.py: w8a8_matmul_pallas.  The chain, per token
// row of x (T, D):
//   xs = x / smooth                                   (float32, IEEE divide)
//   optionally keep the top n of every group of m channels by |xs| * amber
//     (first occurrence wins a tie) and zero the rest
//   scale = act_scale (static, per tensor) or max(absmax(row), 1e-8) / 127
//   q = clamp(rint(xs / scale), -127, 127)            (half to even)
//   out = float(q @ wq) * scale * w_scale[col] (+ bias[col])   float32
// wq is stored K-major: one (N, D) int8 buffer, row n holding output
// channel n's D weights (the caller's (D, N) tensor is its transposed view).
// 8-bit wgmma takes K-major operands only.
//
// What bounds it on the H100: the weight read.  At the serving path's
// prefill chunk (T = 256) the int8 product does 2 T D N operations on D N
// weight bytes, 512 operations a byte, under the card's ~590 int8 operations
// per byte of bandwidth (LLaMA-3.1-8B gate: 58.7 MB, 17.5 us at 3.35 TB/s);
// in decode (T <= 16) it is the weight read alone.  The routes, chosen in
// Python (kernels/w8a8_matmul.py: gemm_plan), all bit-identical:
//
//  * wgmma (T > 16): a quantize pass (osparse_quant_vec_kernel: one block
//    per token row, 16-byte loads, hopper::nm_keep's selection, a block
//    reduce of the row's absmax when per token) writes int8 xq and the row
//    scales; then w8a8_wgmma_kernel, launched as its programmatic dependent:
//    one block per 256-row x 128-column output tile (all T <= 256 rows of a
//    column slab, so each wq tile leaves device memory once per call), one
//    producer warp keeping a 4-stage ring of 48 KB full with TMA (xq 256 x
//    128, wq 128 x 128, both K-major, 128-byte swizzled) and four consumer
//    warpgroups running m64n128k32 s8 wgmmas into int32 registers.  The
//    producer streams the first ring of wq tiles before griddepcontrol.wait
//    and reads xq only after it.  An unsplit block dequantizes from its
//    registers.  Where the column slabs cannot fill half the card (q/k/v/o)
//    k is split over a thread-block cluster: each block parks
//    its int32 partial tile in its own shared memory, and after a cluster
//    barrier each block sums its share of the rows from every block of the
//    cluster (DSMEM) and writes them, dequantized.  Integer sums are exact in
//    any order; nothing is left in device memory between launches.
//  * swap_fused (T <= 16, static per-tensor scale: the decode projections):
//    one launch.  Swap AB: 64 rows of wq are the wgmma's M operand and the T
//    tokens (padded to 8 or 16 with zeros) its N operand, so no tensor-core
//    row is wasted on padding tokens and the bound is the weight read.  One
//    producer warp streams 64 x 128 wq tiles through an 8-stage TMA ring
//    while the consumer warpgroup smooths, selects (group widths up to 16)
//    and quantizes the few x rows into the swizzled B tile in shared memory;
//    m64n8k32 / m64n16k32 wgmmas follow.  k is split over a cluster (as
//    above) until the 64-row tiles fill the card, and the cluster also
//    spans up to 8 row tiles of one split: their blocks need the same B
//    tile, so each quantizes 1/share of it and copies the rest from the
//    others' shared memory (quantizing it all in every block cost as much
//    as the weight stream at gate's shape).  The accumulator holds out
//    transposed: w_scale is indexed by accumulator row.
//  * swap (T <= 16 with int8 xq: w8a8_matmul, or per-token scales, which need
//    the whole row's absmax first): the quantize pass, then the same kernel
//    copying its xq slice into the B tile.
//  * simple (D not a multiple of 16 or wq not 16-byte aligned: shapes TMA
//    cannot take): the scalar quantize pass (osparse_quant_kernel, which also
//    takes the group widths the vectorised pass does not) and a dp4a kernel,
//    32 x 64 output tiles, bytes staged through shared memory with bounds
//    checks.  A shape route between hand kernels, not a fallback.
//
// The epilogue multiplies in the JAX package's order,
// __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), then __fadd_rn(bias):
// no FMA contraction, so the output is bit-identical to the plain version.
// Not yet: a persistent schedule (the swap route's 224 gate blocks sit two
// to an SM on 92 SMs and one on 40), a TMA-store epilogue.  Multicasting the
// xq tile to two column slabs of a cluster did not pay at T = 256 and was
// dropped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// The int8 code of v under scale: clamp(rint(v / scale), -127, 127).
__device__ __forceinline__ int quant_code(float v, float scale) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

// float(acc) * xs * ws (+ bias), rounded at each step as the plain version.
__device__ __forceinline__ float dequant(int acc, float xs, float ws,
                                         const float* __restrict__ bias, int col) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  return bias != nullptr ? __fadd_rn(v, bias[col]) : v;
}

// ------------------------------------------------- quantize pass (scalar)
constexpr int QTHREADS = 256;
constexpr int PLAIN_CHUNK = 16;   // channels per thread-chunk when not pruning

// Chunk c of row xr, smoothed and (when pruning) N:M-masked, into v[0, len):
// n rounds of strict-'>' argmax, any group width up to 32.
template <typename T>
__device__ __forceinline__ int pruned_chunk(const T* __restrict__ xr,
                                            const float* __restrict__ smooth,
                                            const float* __restrict__ amber, int c, int D,
                                            int n, int m, bool prune, float* v) {
  const int width = prune ? m : PLAIN_CHUNK;
  const int c0 = c * width;
  const int len = min(width, D - c0);
  for (int j = 0; j < len; ++j) v[j] = __fdiv_rn(to_f(xr[c0 + j]), smooth[c0 + j]);
  if (!prune) return len;
  float s[32];
  for (int j = 0; j < len; ++j)
    s[j] = amber != nullptr ? __fmul_rn(fabsf(v[j]), amber[c0 + j]) : fabsf(v[j]);
  uint32_t keep = 0u;
  for (int round = 0; round < n; ++round) {
    int best = -1;
    float bestv = 0.f;
    for (int j = 0; j < len; ++j) {
      if ((keep >> j) & 1u) continue;
      if (best < 0 || s[j] > bestv) { best = j; bestv = s[j]; }
    }
    keep |= 1u << best;
  }
  for (int j = 0; j < len; ++j)
    if (!((keep >> j) & 1u)) v[j] = 0.f;
  return len;
}

// The row's absmax over the block's threads (every thread gets it).
__device__ __forceinline__ float block_max(float v, float* warp_max) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  v = warp_max[0];
  for (int w = 1; w < QTHREADS / 32; ++w) v = fmaxf(v, warp_max[w]);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(QTHREADS)
osparse_quant_kernel(const T* __restrict__ x, const float* __restrict__ smooth,
                     const float* __restrict__ amber, const float* __restrict__ act_scale,
                     int8_t* __restrict__ xq, float* __restrict__ row_scale, int D, int n,
                     int m, int prune, int per_token) {
  __shared__ float warp_max[QTHREADS / 32];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");   // the GEMM may launch
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * D;
  const int width = prune ? m : PLAIN_CHUNK;
  const int chunks = (D + width - 1) / width;
  float v[32];
  float scale;
  if (per_token) {
    float amax = 0.f;
    for (int c = threadIdx.x; c < chunks; c += QTHREADS) {
      const int len = pruned_chunk(xr, smooth, amber, c, D, n, m, prune, v);
      for (int j = 0; j < len; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    scale = __fdiv_rn(fmaxf(block_max(amax, warp_max), 1e-8f), 127.f);
    if (threadIdx.x == 0) row_scale[row] = scale;
  } else {
    scale = *act_scale;
  }
  int8_t* qr = xq + (size_t)row * D;
  for (int c = threadIdx.x; c < chunks; c += QTHREADS) {
    const int len = pruned_chunk(xr, smooth, amber, c, D, n, m, prune, v);
    for (int j = 0; j < len; ++j) qr[c * width + j] = (int8_t)quant_code(v[j], scale);
  }
}

// --------------------------------------------- quantize pass (vectorised)
// Element j of a chunk held as 32-bit words.
template <typename T>
__device__ __forceinline__ float word_elem(const uint32_t* w, int j) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(((w[j >> 1] >> ((j & 1) * 16)) & 0xFFFFu) << 16);
  else
    return __uint_as_float(w[j]);
}

// One block per token row; each thread takes chunks of E = max(M, 16)
// channels (whole groups in whole 16-byte vectors): x as uint4, smooth
// and amber as float4, the selection by hopper::nm_keep (M = 0: none), the
// codes out as 32-bit words.  Per token the row is swept twice: the absmax,
// then the codes.  Bound by reading x and writing xq once (3 bytes a bf16
// channel).
template <typename T, int M>
__global__ void __launch_bounds__(QTHREADS)
osparse_quant_vec_kernel(const T* __restrict__ x, const float* __restrict__ smooth,
                         const float* __restrict__ amber, const float* __restrict__ act_scale,
                         int8_t* __restrict__ xq, float* __restrict__ row_scale, int D, int n,
                         int per_token) {
  constexpr int V = 16 / sizeof(T);
  constexpr int E = M > 16 ? M : 16;
  __shared__ float warp_max[QTHREADS / 32];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");   // the GEMM may launch
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * D;
  const int chunks = D / E;
  auto chunk = [&](int c, float (&v)[E]) {
    const int c0 = c * E;
#pragma unroll
    for (int k = 0; k < E / V; ++k) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr + c0) + k);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < V; ++j) v[k * V + j] = word_elem<T>(w, j);
    }
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 sm = __ldg(reinterpret_cast<const float4*>(smooth + c0) + k);
      v[4 * k] = __fdiv_rn(v[4 * k], sm.x);
      v[4 * k + 1] = __fdiv_rn(v[4 * k + 1], sm.y);
      v[4 * k + 2] = __fdiv_rn(v[4 * k + 2], sm.z);
      v[4 * k + 3] = __fdiv_rn(v[4 * k + 3], sm.w);
    }
    if constexpr (M > 0) {
      float s[E];                                // |xs| * amber (no amber: * 1, exact)
#pragma unroll
      for (int k = 0; k < E / 4; ++k) {
        const float4 a = amber != nullptr
                             ? __ldg(reinterpret_cast<const float4*>(amber + c0) + k)
                             : make_float4(1.f, 1.f, 1.f, 1.f);
        s[4 * k] = __fmul_rn(fabsf(v[4 * k]), a.x);
        s[4 * k + 1] = __fmul_rn(fabsf(v[4 * k + 1]), a.y);
        s[4 * k + 2] = __fmul_rn(fabsf(v[4 * k + 2]), a.z);
        s[4 * k + 3] = __fmul_rn(fabsf(v[4 * k + 3]), a.w);
      }
      uint32_t keep = 0u;
#pragma unroll
      for (int g = 0; g < E / M; ++g) keep |= hopper::nm_keep<M>(s + g * M, n) << (g * M);
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = ((keep >> j) & 1u) ? v[j] : 0.f;
    }
  };
  float scale;
  if (per_token) {
    float amax = 0.f;
    for (int c = threadIdx.x; c < chunks; c += QTHREADS) {
      float v[E];
      chunk(c, v);
#pragma unroll
      for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    scale = __fdiv_rn(fmaxf(block_max(amax, warp_max), 1e-8f), 127.f);
    if (threadIdx.x == 0) row_scale[row] = scale;
  } else {
    scale = __ldg(act_scale);
  }
  uint32_t* qr = reinterpret_cast<uint32_t*>(xq + (size_t)row * D);
  for (int c = threadIdx.x; c < chunks; c += QTHREADS) {
    float v[E];
    chunk(c, v);
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      uint32_t word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= ((uint32_t)quant_code(v[4 * k + b], scale) & 0xFFu) << (8 * b);
      qr[c * (E / 4) + k] = word;
    }
  }
}

// ------------------------------------------------ prefill GEMM (wgmma)
constexpr int P_M = 256, P_N = 128, P_K = 128, P_STAGES = 4, P_WG = 4;
constexpr int P_THREADS = P_WG * 128 + 32;
constexpr int P_XTILE = P_M * P_K;                // 32 KB
constexpr int P_WTILE = P_N * P_K;                // 16 KB
constexpr int P_STAGE = P_XTILE + P_WTILE;        // 48 KB
constexpr int P_SMEM = P_STAGES * P_STAGE + 1024;
// int32 row stride of the parked partial tile: 544 bytes, so the 64-bit
// stores of a half-warp (4 rows x 32 bytes) meet all 32 banks once
constexpr int P_RED_LD = P_N + 8;
static_assert(P_M * P_RED_LD * 4 <= P_STAGES * P_STAGE, "partial tile must fit the ring");

// out rows [m0, m0 + 256) x columns [n0, n0 + 128) of xq (T, D) @ wq^T, wq
// (N, D) K-major; k steps [ks0, ks0 + steps_per_split) of this block's
// cluster rank; gridDim.x = the cluster size = the k split.  xmap's box is
// x_rows (the rows T needs, in 64s, at most 256) x 128 bytes: warpgroups past
// them multiply whatever their shared memory holds, into rows never stored.
__global__ void __launch_bounds__(P_THREADS, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const float* __restrict__ xs,
                  int xs_stride, const float* __restrict__ ws, const float* __restrict__ bias,
                  float* __restrict__ out, int T_, int N, int k_steps, int steps_per_split,
                  int x_rows) {
  using namespace hopper;
  extern __shared__ unsigned char p_smem_raw[];
  unsigned char* sm = align1024(p_smem_raw);
  __shared__ __align__(8) uint64_t full[P_STAGES], empty[P_STAGES];
  const uint32_t split = blockIdx.x, splits = gridDim.x;
  const int n0 = blockIdx.y * P_N, m0 = blockIdx.z * P_M;
  const int ks0 = split * steps_per_split;
  const int n_steps = max(0, min(k_steps, ks0 + steps_per_split) - ks0);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const uint32_t stage_bytes = x_rows * P_K + P_WTILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P_WG * 4);             // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == P_WG) {                               // producer warp
    if (lane == 0) {
      // the first ring of wq tiles does not depend on the quantize pass that
      // writes xq (launched just before, with this kernel allowed to start
      // early): issue it, then wait for that pass before any xq
      prefetch_tensormap(&wmap);
      prefetch_tensormap(&xmap);
      const int first = min(P_STAGES, n_steps);
      for (int j = 0; j < first; ++j) {
        unsigned char* st = sm + j * P_STAGE;
        mbar_arrive_expect_tx(&full[j], stage_bytes);
        tma_load_2d(st + P_XTILE, &wmap, &full[j], (ks0 + j) * P_K, n0);
      }
      asm volatile("griddepcontrol.wait;" ::: "memory");
      for (int j = 0; j < first; ++j)
        tma_load_2d(sm + j * P_STAGE, &xmap, &full[j], (ks0 + j) * P_K, m0);
      for (int j = first; j < n_steps; ++j) {
        const int s = j % P_STAGES, k0 = (ks0 + j) * P_K;
        mbar_wait(&empty[s], (j / P_STAGES - 1) & 1);
        unsigned char* st = sm + s * P_STAGE;
        mbar_arrive_expect_tx(&full[s], stage_bytes);
        tma_load_2d(st, &xmap, &full[s], k0, m0);
        tma_load_2d(st + P_XTILE, &wmap, &full[s], k0, n0);
      }
    }
    __syncwarp();
  } else {
    const int warp = (threadIdx.x % 128) / 32;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % P_STAGES;
      mbar_wait(&full[s], (j / P_STAGES) & 1);
      // every warpgroup runs its products, rows past T included (zeros from
      // the TMA, or whatever lies past x_rows; never stored): a branch around
      // wgmma would serialise them
      const unsigned char* xs_t = sm + s * P_STAGE + wg * 64 * P_K;
      const unsigned char* ws_t = sm + s * P_STAGE + P_XTILE;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < P_K / 32; ++kk)
        wgmma_m64n128k32_s8(acc, desc_k_major(xs_t + kk * 32), desc_k_major(ws_t + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();                            // step j - 1's products are done
      fence_regs(acc);
      __syncwarp();
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % P_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const int rbase = wg * 64 + warp * 16 + lane / 4, cbase = 2 * (lane % 4);
    if (splits == 1) {                            // unsplit: dequantize from the registers
      asm volatile("griddepcontrol.wait;" ::: "memory");   // row scales of the pass
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + rbase + 8 * hr;
        if (row >= T_) continue;
        const float xsr = xs[(size_t)row * xs_stride];
#pragma unroll
        for (int j = 0; j < P_N / 8; ++j) {
          const int col = n0 + cbase + 8 * j;
          const float v0 = dequant(acc[4 * j + 2 * hr], xsr, col < N ? ws[col] : 0.f, bias,
                                   col < N ? col : 0);
          const float v1 = dequant(acc[4 * j + 2 * hr + 1], xsr,
                                   col + 1 < N ? ws[col + 1] : 0.f, bias,
                                   col + 1 < N ? col + 1 : 0);
          float* o = out + (size_t)row * N + col;
          if (N % 2 == 0 && col < N)
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          else if (col < N) {
            o[0] = v0;
            if (col + 1 < N) o[1] = v1;
          }
        }
      }
      return;
    }
    named_barrier(1, P_WG * 128);                 // no warpgroup still reads the ring
    int* red = reinterpret_cast<int*>(sm);
#pragma unroll
    for (int j = 0; j < P_N / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<int2*>(red + (rbase + 8 * hr) * P_RED_LD + cbase + 8 * j) =
            make_int2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
  if (splits == 1) return;                        // the producer warp of an unsplit block
  cluster_sync();                                 // every block's partial is parked
  asm volatile("griddepcontrol.wait;" ::: "memory");   // row scales of the quantize pass
  // this block's share of the rows: the cluster's partials summed, dequantized
  const int* red = reinterpret_cast<const int*>(sm);
  const int r0 = split * P_M / splits, r1 = (split + 1) * P_M / splits;
  for (int e = threadIdx.x; e < (r1 - r0) * (P_N / 4); e += P_THREADS) {
    const int r = r0 + e / (P_N / 4), c = (e % (P_N / 4)) * 4;
    const int row = m0 + r, col = n0 + c;
    if (row >= T_ || col >= N) continue;
    int4 a = ld_cluster_v4(red + r * P_RED_LD + c, 0);
    for (uint32_t q = 1; q < splits; ++q) {
      const int4 b = ld_cluster_v4(red + r * P_RED_LD + c, q);
      a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
    }
    const float xsr = xs[(size_t)row * xs_stride];
    float* o = out + (size_t)row * N + col;
    if (N % 4 == 0) {                             // col + 3 < N, 16-byte aligned
      *reinterpret_cast<float4*>(o) =
          make_float4(dequant(a.x, xsr, ws[col], bias, col),
                      dequant(a.y, xsr, ws[col + 1], bias, col + 1),
                      dequant(a.z, xsr, ws[col + 2], bias, col + 2),
                      dequant(a.w, xsr, ws[col + 3], bias, col + 3));
    } else {
      const int v[4] = {a.x, a.y, a.z, a.w};
      for (int i = 0; i < 4 && col + i < N; ++i)
        o[i] = dequant(v[i], xsr, ws[col + i], bias, col + i);
    }
  }
  __syncwarp();
  cluster_sync();                                 // no block leaves while others read it
}

// --------------------------------------------- decode GEMM (swap AB)
constexpr int S_ROWS = 64, S_K = 128, S_STAGES = 8;
constexpr int S_THREADS = 128 + 32;
constexpr int S_WTILE = S_ROWS * S_K;             // 8 KB

// The group-of-M keep mask over 16 channels (groups of M <= 16 tile them).
template <int M>
__device__ __forceinline__ uint32_t keep16(const float (&s)[16], int n) {
  uint32_t keep = 0u;
#pragma unroll
  for (int g = 0; g < 16 / M; ++g) keep |= hopper::nm_keep<M>(s + g * M, n) << (g * M);
  return keep;
}

// 16 channels of one token row as the swap route's B-tile fill loads them:
// x (int8 xq: one 16-byte vector; bf16: two; float32: four), smooth and
// amber as float4.
template <typename TIN>
struct Piece {
  uint4 x[16 * sizeof(TIN) / 16];
  float4 sm[4], am[4];
};

// The swap route's B tile holds, for each k step j of the block, a chunk of
// the NT token rows (zeros for rows >= T and channels >= D) of channels
// [(ks0 + j) * 128, + 128), NT rows x 128 bytes in the 128-byte swizzle.
template <int NT>
__device__ __forceinline__ unsigned char* x_unit(unsigned char* xt, int j, int r, int u) {
  return xt + j * (NT * S_K) + r * S_K + ((u ^ (r % 8)) * 16);
}

// This block's share of the B tile: the chunks j = sy, sy + share, ... of
// its k steps, rows < T, 16 channels (one 16-byte unit) a thread at a time
// with the next unit's loads in flight.  TIN int8: xq copied.  Else the
// chain on x: smooth, select (group widths 2-16), quantize with the static
// scale.  x, smooth and amber 16-byte aligned.
template <typename TIN, int NT>
__device__ __forceinline__ void fill_share(unsigned char* xt, const TIN* __restrict__ x,
                                           const float* __restrict__ smooth,
                                           const float* __restrict__ amber, float scale,
                                           int T_, int D, int ks0, int n_steps, int sy,
                                           int share, int n, int m, int prune) {
  constexpr int NV = 16 * sizeof(TIN) / 16;
  const int per_chunk = T_ * 8;
  const int total = (n_steps > sy ? (n_steps - sy + share - 1) / share : 0) * per_chunk;
  auto chunk_of = [&](int i) { return sy + (i / per_chunk) * share; };
  auto load = [&](Piece<TIN>& a, int i) {
    const int r = (i % per_chunk) / 8, k = (ks0 + chunk_of(i)) * S_K + 16 * (i % 8);
    const bool ok = k < D;
    const uint4* px = reinterpret_cast<const uint4*>(x + (size_t)r * D + k);
#pragma unroll
    for (int q = 0; q < NV; ++q) a.x[q] = ok ? __ldg(px + q) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (sizeof(TIN) > 1) {
      const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a.sm[q] = ok ? __ldg(reinterpret_cast<const float4*>(smooth + k) + q) : one;
        a.am[q] = ok && prune && amber != nullptr
                      ? __ldg(reinterpret_cast<const float4*>(amber + k) + q)
                      : one;
      }
    }
  };
  auto store = [&](const Piece<TIN>& a, int i) {
    uint4 out;
    if constexpr (sizeof(TIN) == 1) {
      out = a.x[0];
    } else {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(a.x);
      const float* sm = reinterpret_cast<const float*>(a.sm);
      const float* am = reinterpret_cast<const float*>(a.am);
      float v[16], sc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = __fdiv_rn(word_elem<TIN>(w, j), sm[j]);
        sc[j] = __fmul_rn(fabsf(v[j]), am[j]);   // |xs| * amber (no amber: * 1, exact)
      }
      if (prune) {
        uint32_t keep;
        switch (m) {
          case 2: keep = keep16<2>(sc, n); break;
          case 4: keep = keep16<4>(sc, n); break;
          case 8: keep = keep16<8>(sc, n); break;
          default: keep = keep16<16>(sc, n); break;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = ((keep >> j) & 1u) ? v[j] : 0.f;
      }
      uint32_t q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        q[c] = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          q[c] |= ((uint32_t)quant_code(v[4 * c + b], scale) & 0xFFu) << (8 * b);
      }
      out = make_uint4(q[0], q[1], q[2], q[3]);
    }
    *reinterpret_cast<uint4*>(x_unit<NT>(xt, chunk_of(i), (i % per_chunk) / 8, i % 8)) = out;
  };
  int i = threadIdx.x;
  if (i >= total) return;
  Piece<TIN> cur;
  load(cur, i);
  for (; i < total; i += 128) {
    Piece<TIN> nxt;
    const bool more = i + 128 < total;
    if (more) load(nxt, i + 128);
    store(cur, i);
    if (more) cur = nxt;
  }
}

template <int NT>
__device__ __forceinline__ void wgmma_swap(int (&d)[NT / 2], uint64_t a, uint64_t b) {
  if constexpr (NT == 8)
    hopper::wgmma_m64n8k32_s8(d, a, b, 1);
  else
    hopper::wgmma_m64n16k32_s8(d, a, b, 1);
}

// out[:, n0 + row] for rows [n0, n0 + 64) of wq (N, D) K-major, all T <= NT
// tokens; k steps [ks0, ks0 + steps_per_split) of this block's split.  The
// cluster is gridDim.x (the k split) x `share` blocks of consecutive row
// tiles: the `share` blocks of one split need the same B tile, so each fills
// 1/share of its chunks and copies the rest from the others' shared memory.
// xs: the static scale (xs_stride 0) or per-token row scales (stride 1).
template <typename TIN, int NT>
__global__ void __launch_bounds__(S_THREADS, 2)
w8a8_swap_kernel(const __grid_constant__ CUtensorMap wmap, const TIN* __restrict__ x,
                 const float* __restrict__ smooth, const float* __restrict__ amber,
                 const float* __restrict__ xs, int xs_stride, const float* __restrict__ ws,
                 const float* __restrict__ bias, float* __restrict__ out, int T_, int D, int N,
                 int n, int m, int prune, int k_steps, int steps_per_split, int share) {
  using namespace hopper;
  constexpr int RED_LD = NT + 1;
  extern __shared__ unsigned char s_smem_raw[];
  unsigned char* ring = align1024(s_smem_raw);
  unsigned char* xt = ring + S_STAGES * S_WTILE;
  int* red = reinterpret_cast<int*>(xt + NT * steps_per_split * S_K);   // 64 x RED_LD
  __shared__ __align__(8) uint64_t full[S_STAGES], empty[S_STAGES];
  const uint32_t split = blockIdx.x, splits = gridDim.x;
  const int sy = blockIdx.y % share;              // this block's place in its fill group
  const int n0 = blockIdx.y * S_ROWS;
  const int ks0 = split * steps_per_split;
  const int n_steps = max(0, min(k_steps, ks0 + steps_per_split) - ks0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);                    // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                                // producer warp: the wq stream
    if (share > 1) cluster_arrive();              // (the shared fill's cluster phase)
    if (lane == 0) {
      prefetch_tensormap(&wmap);
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % S_STAGES;
        if (j >= S_STAGES) mbar_wait(&empty[s], (j / S_STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], S_WTILE);
        tma_load_2d(ring + s * S_WTILE, &wmap, &full[s], (ks0 + j) * S_K, n0);
      }
    }
    __syncwarp();
    if (share > 1) cluster_wait();
  } else {
    // rows T..NT-1 of every chunk are zeros; this block's share of the rest
    for (int i = threadIdx.x; i < NT * 8 * n_steps; i += 128) {
      const int r = (i / 8) % NT;
      if (r >= T_)
        *reinterpret_cast<uint4*>(x_unit<NT>(xt, i / (8 * NT), r, i % 8)) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");   // x or xq of the kernel before
    fill_share<TIN, NT>(xt, x, smooth, amber, sizeof(TIN) == 1 ? 0.f : __ldg(xs), T_, D, ks0,
                        n_steps, sy, share, n, m, prune);
    if (share > 1) {
      __syncwarp();
      cluster_sync();                             // every share is in place
      // the other blocks' shares, four 16-byte units in flight a thread
      const int total = n_steps * T_ * 8;
      for (int base = threadIdx.x; base < total; base += 4 * 128) {
        unsigned char* p[4];
        int4 v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = base + 128 * b, j = i / (T_ * 8), owner = j % share;
          p[b] = i < total && owner != sy ? x_unit<NT>(xt, j, (i % (T_ * 8)) / 8, i % 8)
                                          : nullptr;
          if (p[b] != nullptr) v[b] = ld_cluster_v4(p[b], split + owner * splits);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (p[b] != nullptr) *reinterpret_cast<int4*>(p[b]) = v[b];
      }
    }
    fence_proxy_async();                          // generic stores -> wgmma reads
    named_barrier(1, 128);
    int acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % S_STAGES;
      mbar_wait(&full[s], (j / S_STAGES) & 1);
      const unsigned char* a = ring + s * S_WTILE;
      const unsigned char* b = xt + j * (NT * S_K);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < S_K / 32; ++kk)
        wgmma_swap<NT>(acc, desc_k_major(a + kk * 32), desc_k_major(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      __syncwarp();
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % S_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // acc[4j + i] = D[wq row][token]: row 16 warp + lane/4 + 8 (i/2), token
    // 8j + 2 (lane%4) + i%2
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(16 * warp + lane / 4 + 8 * (i / 2)) * RED_LD + 8 * j + 2 * (lane % 4) + i % 2] =
            acc[4 * j + i];
  }
  cluster_sync();
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int r0 = split * S_ROWS / splits, r1 = (split + 1) * S_ROWS / splits;
  for (int e = threadIdx.x; e < (r1 - r0) * NT; e += S_THREADS) {
    const int tok = e / (r1 - r0), r = r0 + e % (r1 - r0), col = n0 + r;
    if (tok >= T_ || col >= N) continue;
    int part[8];                                  // every rank's load in flight at once
#pragma unroll
    for (uint32_t q = 0; q < 8; ++q)
      part[q] = q < splits ? ld_cluster_s32(red + r * RED_LD + tok, q + sy * splits) : 0;
    int a = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) a += part[q];
    out[(size_t)tok * N + col] = dequant(a, xs[(size_t)tok * xs_stride], ws[col], bias, col);
  }
  __syncwarp();
  cluster_sync();
}

// ------------------------------------------------ simple GEMM (dp4a)
constexpr int Q_M = 32, Q_N = 64, Q_K = 32, Q_THREADS = 256;

// xq (T, D) int8 @ wq^T, wq (N, D) K-major, any D and alignment: 32 x 64
// output tiles, k in 32-byte steps staged as words with bounds checks; each
// thread one row, eight columns, dp4a.
__global__ void __launch_bounds__(Q_THREADS)
w8a8_simple_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   const float* __restrict__ xs, int xs_stride, const float* __restrict__ ws,
                   const float* __restrict__ bias, float* __restrict__ out, int T_, int D,
                   int N) {
  __shared__ int xa[Q_M][Q_K / 4 + 1], wb[Q_N][Q_K / 4 + 1];
  const int n0 = blockIdx.x * Q_N, m0 = blockIdx.y * Q_M;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
  int acc[8] = {};
  for (int k0 = 0; k0 < D; k0 += Q_K) {
    for (int i = threadIdx.x; i < (Q_M + Q_N) * (Q_K / 4); i += Q_THREADS) {
      const int r = i / (Q_K / 4), w = i % (Q_K / 4);
      const bool is_x = r < Q_M;
      const int8_t* src = is_x ? xq : wq;
      const int gr = is_x ? m0 + r : n0 + r - Q_M, rows = is_x ? T_ : N;
      uint32_t word = 0u;
      for (int b = 0; b < 4; ++b) {
        const int k = k0 + 4 * w + b;
        if (gr < rows && k < D) word |= (uint32_t)(uint8_t)src[(size_t)gr * D + k] << (8 * b);
      }
      (is_x ? xa[r] : wb[r - Q_M])[w] = (int)word;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < Q_K / 4; ++w) {
      const int a = xa[tr][w];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __dp4a(a, wb[tc + 8 * j][w], acc[j]);
    }
    __syncthreads();
  }
  const int row = m0 + tr;
  if (row >= T_) return;
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tc + 8 * j;
    if (col < N)
      out[(size_t)row * N + col] = dequant(acc[j], xs[(size_t)row * xs_stride], ws[col], bias,
                                           col);
  }
}

// ------------------------------------------------------------- launches
// Routes of kernels/w8a8_matmul.py: gemm_plan (the codes it passes).
enum Route { SIMPLE = 0, WGMMA = 1, SWAP = 2, SWAP_FUSED = 3 };

template <typename T, int M>
int launch_quant_vec(const void* x, const float* smooth, const float* amber,
                     const float* act_scale, void* xq, float* row_scale, int T_, int D, int n,
                     int per_token, cudaStream_t s) {
  osparse_quant_vec_kernel<T, M><<<T_, QTHREADS, 0, s>>>(
      (const T*)x, smooth, amber, act_scale, (int8_t*)xq, row_scale, D, n, per_token);
  return (int)cudaGetLastError();
}

// The quantize pass: the vectorised kernel where the group width is a power
// of two <= 32 (or no selection), a chunk of max(m, 16) channels tiles D and
// the pointers are 16-byte aligned; else the scalar kernel.  Both give the
// same codes.
template <typename T>
int launch_quantize(const void* x, const float* smooth, const float* amber,
                    const float* act_scale, void* xq, float* row_scale, int T_, int D, int n,
                    int m, int prune, int per_token, cudaStream_t s) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(smooth) |
                         reinterpret_cast<uintptr_t>(amber)) & 15) == 0;
  const int span = prune && m > 16 ? m : 16;
  if (aligned && D % span == 0) {
    if (!prune)
      return launch_quant_vec<T, 0>(x, smooth, amber, act_scale, xq, row_scale, T_, D, n,
                                    per_token, s);
    switch (m) {
      case 2: return launch_quant_vec<T, 2>(x, smooth, amber, act_scale, xq, row_scale, T_, D,
                                            n, per_token, s);
      case 4: return launch_quant_vec<T, 4>(x, smooth, amber, act_scale, xq, row_scale, T_, D,
                                            n, per_token, s);
      case 8: return launch_quant_vec<T, 8>(x, smooth, amber, act_scale, xq, row_scale, T_, D,
                                            n, per_token, s);
      case 16: return launch_quant_vec<T, 16>(x, smooth, amber, act_scale, xq, row_scale, T_,
                                              D, n, per_token, s);
      case 32: return launch_quant_vec<T, 32>(x, smooth, amber, act_scale, xq, row_scale, T_,
                                              D, n, per_token, s);
      default: break;
    }
  }
  osparse_quant_kernel<T><<<T_, QTHREADS, 0, s>>>((const T*)x, smooth, amber, act_scale,
                                                  (int8_t*)xq, row_scale, D, n, m, prune,
                                                  per_token);
  return (int)cudaGetLastError();
}

// A 2-d tensor map over the (rows, D) int8 matrix at p, boxes of 128 bytes
// x box_rows rows.
int encode_rows(CUtensorMap* map, const void* p, int rows, int D, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {(cuuint32_t)P_K, (cuuint32_t)box_rows};
  return hopper::encode_u8_sw128(map, p, 2, dims, strides, box);
}

int launch_wgmma(const void* xq, const void* wq, const float* xs, int xs_stride,
                 const float* ws, const float* bias, float* out, int T_, int D, int N,
                 int splits, bool dependent, cudaStream_t s) {
  const int x_rows = T_ >= P_M ? P_M : (T_ + 63) / 64 * 64;
  CUtensorMap xm, wm;
  int rc = encode_rows(&xm, xq, T_, D, x_rows);
  if (rc == 0) rc = encode_rows(&wm, wq, N, D, P_N);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(w8a8_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int k_steps = (D + P_K - 1) / P_K;
  const int per = (k_steps + splits - 1) / splits;
  e = hopper::launch_cluster(w8a8_wgmma_kernel,
                             dim3(splits, (N + P_N - 1) / P_N, (T_ + P_M - 1) / P_M),
                             dim3(P_THREADS), P_SMEM, s, dim3(splits, 1), dependent, xm, wm,
                             xs, xs_stride, ws, bias, out, T_, N, k_steps, per, x_rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TIN, int NT>
int launch_swap_nt(const void* x, const void* wq, const float* smooth, const float* amber,
                   const float* xs, int xs_stride, const float* ws, const float* bias,
                   float* out, int T_, int D, int N, int n, int m, int prune, int splits,
                   int share, bool dependent, cudaStream_t s) {
  CUtensorMap wm;
  int rc = encode_rows(&wm, wq, N, D, S_ROWS);
  if (rc != 0) return rc;
  const int k_steps = (D + S_K - 1) / S_K;
  const int per = (k_steps + splits - 1) / splits;
  const int tiles = (N + S_ROWS - 1) / S_ROWS;
  const int smem = S_STAGES * S_WTILE + NT * per * S_K + S_ROWS * (NT + 1) * 4 + 1024;
  cudaError_t e = cudaFuncSetAttribute(w8a8_swap_kernel<TIN, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = hopper::launch_cluster(w8a8_swap_kernel<TIN, NT>,
                             dim3(splits, (tiles + share - 1) / share * share), dim3(S_THREADS),
                             smem, s, dim3(splits, share), dependent, wm, (const TIN*)x, smooth,
                             amber, xs, xs_stride, ws, bias, out, T_, D, N, n, m, prune,
                             k_steps, per, share);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The swap route: `cluster` = splits x share blocks (share: the row tiles
// whose blocks split the B-tile fill between them).
template <typename TIN>
int launch_swap(const void* x, const void* wq, const float* smooth, const float* amber,
                const float* xs, int xs_stride, const float* ws, const float* bias,
                float* out, int T_, int D, int N, int n, int m, int prune, int splits,
                int cluster, bool dependent, cudaStream_t s) {
  if (T_ > 16 || splits < 1 || cluster % splits) return (int)cudaErrorInvalidValue;
  const int share = cluster / splits;
  if (T_ <= 8)
    return launch_swap_nt<TIN, 8>(x, wq, smooth, amber, xs, xs_stride, ws, bias, out, T_, D,
                                  N, n, m, prune, splits, share, dependent, s);
  return launch_swap_nt<TIN, 16>(x, wq, smooth, amber, xs, xs_stride, ws, bias, out, T_, D, N,
                                 n, m, prune, splits, share, dependent, s);
}

int launch_simple(const void* xq, const void* wq, const float* xs, int xs_stride,
                  const float* ws, const float* bias, float* out, int T_, int D, int N,
                  cudaStream_t s) {
  const dim3 grid((N + Q_N - 1) / Q_N, (T_ + Q_M - 1) / Q_M);
  w8a8_simple_kernel<<<grid, Q_THREADS, 0, s>>>((const int8_t*)xq, (const int8_t*)wq, xs,
                                                xs_stride, ws, bias, out, T_, D, N);
  return (int)cudaGetLastError();
}

// The int8 GEMM of xq (T, D) with scales xs (stride 0: one static scale).
int launch_gemm(const void* xq, const void* wq, const float* xs, int xs_stride,
                const float* ws, const float* bias, float* out, int T_, int D, int N,
                int route, int splits, int cluster, bool dependent, cudaStream_t s) {
  switch (route) {
    case SIMPLE:
      return launch_simple(xq, wq, xs, xs_stride, ws, bias, out, T_, D, N, s);
    case WGMMA:
      return launch_wgmma(xq, wq, xs, xs_stride, ws, bias, out, T_, D, N, splits, dependent,
                          s);
    case SWAP:
      return launch_swap<int8_t>(xq, wq, nullptr, nullptr, xs, xs_stride, ws, bias, out, T_, D,
                                 N, 0, 1, 0, splits, cluster, dependent, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_osparse(const void* x, const void* wq, const float* smooth, const float* amber,
                   const float* w_scale, const float* act_scale, const float* bias,
                   void* xq, float* row_scale, float* out, int T_, int D, int N, int n, int m,
                   int prune, int per_token, int route, int splits, int cluster,
                   cudaStream_t s) {
  if (route == SWAP_FUSED) {                      // one launch: quantized in the GEMM
    const bool width_ok = !prune || m == 2 || m == 4 || m == 8 || m == 16;
    if (per_token || !width_ok) return (int)cudaErrorInvalidValue;
    return launch_swap<T>(x, wq, smooth, amber, act_scale, 0, w_scale, bias, out, T_, D, N, n,
                          m, prune, splits, cluster, false, s);
  }
  int rc;
  if (route == SIMPLE) {
    osparse_quant_kernel<T><<<T_, QTHREADS, 0, s>>>((const T*)x, smooth, amber, act_scale,
                                                    (int8_t*)xq, row_scale, D, n, m, prune,
                                                    per_token);
    rc = (int)cudaGetLastError();
  } else {
    rc = launch_quantize<T>(x, smooth, amber, act_scale, xq, row_scale, T_, D, n, m, prune,
                            per_token, s);
  }
  if (rc != 0) return rc;
  const float* xs = per_token ? row_scale : act_scale;
  return launch_gemm(xq, wq, xs, per_token ? 1 : 0, w_scale, bias, out, T_, D, N, route,
                     splits, cluster, route != SIMPLE, s);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers; wq
// is the (N, D) K-major int8 buffer.  amber and bias (float32) may be null;
// act_scale is a device pointer to the 0-d float32 static scale (null when
// per_token).  xq (T, D) int8 and row_scale (T,) float32 are caller-allocated
// scratch (unused on the swap_fused route).  out is (T, N) float32.  `route`,
// `splits` and `cluster` are gemm_plan's.  Launches on `stream`, does not synchronise,
// and returns the first CUDA error.
extern "C" int osparse_matmul_bf16(const void* x, const void* wq, const float* smooth,
                                   const float* amber, const float* w_scale,
                                   const float* act_scale, const float* bias, void* xq,
                                   float* row_scale, float* out, int T, int D, int N, int n,
                                   int m, int prune, int per_token, int route, int splits,
                                   int cluster, void* stream) {
  return launch_osparse<bf16>(x, wq, smooth, amber, w_scale, act_scale, bias, xq, row_scale,
                              out, T, D, N, n, m, prune, per_token, route, splits, cluster,
                              (cudaStream_t)stream);
}

extern "C" int osparse_matmul_f32(const void* x, const void* wq, const float* smooth,
                                  const float* amber, const float* w_scale,
                                  const float* act_scale, const float* bias, void* xq,
                                  float* row_scale, float* out, int T, int D, int N, int n,
                                  int m, int prune, int per_token, int route, int splits,
                                  int cluster, void* stream) {
  return launch_osparse<float>(x, wq, smooth, amber, w_scale, act_scale, bias, xq, row_scale,
                               out, T, D, N, n, m, prune, per_token, route, splits, cluster,
                               (cudaStream_t)stream);
}

// The quantize pass of the wgmma and swap routes alone: xq (T, D) int8 and,
// per token, row_scale (T,), so the int8 codes can be held against the plain
// version's.
extern "C" int osparse_quantize_bf16(const void* x, const float* smooth, const float* amber,
                                     const float* act_scale, void* xq, float* row_scale,
                                     int T, int D, int n, int m, int prune, int per_token,
                                     void* stream) {
  return launch_quantize<bf16>(x, smooth, amber, act_scale, xq, row_scale, T, D, n, m, prune,
                               per_token, (cudaStream_t)stream);
}

extern "C" int osparse_quantize_f32(const void* x, const float* smooth, const float* amber,
                                    const float* act_scale, void* xq, float* row_scale,
                                    int T, int D, int n, int m, int prune, int per_token,
                                    void* stream) {
  return launch_quantize<float>(x, smooth, amber, act_scale, xq, row_scale, T, D, n, m, prune,
                                per_token, (cudaStream_t)stream);
}

// xq (T, D) int8 @ wq (the (N, D) K-major buffer) -> float32 * x_scale[0] *
// w_scale[col]: the GEMM alone on gemm_plan's route (simple, wgmma or swap),
// the scalar x_scale read on the device.
extern "C" int w8a8_matmul(const void* xq, const void* wq, const float* x_scale,
                           const float* w_scale, float* out, int T, int D, int N, int route,
                           int splits, int cluster, void* stream) {
  return launch_gemm(xq, wq, x_scale, 0, w_scale, nullptr, out, T, D, N, route, splits,
                     cluster, false, (cudaStream_t)stream);
}
