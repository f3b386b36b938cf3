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
//  1. consensus_select_kernel: one block per (up to 256 bytes of channels of
//     a row, tile).  The pool reads x once with 16-byte loads, 16 rows at a
//     time across the block (each thread sums its 8 or 4 channels over every
//     16th row of the tile), and the 16 partial sums of a channel are added
//     in a fixed order; one thread per channel ranks it in its group (the n
//     rounds of first-occurrence argmax, NaN first as torch.argmax has it),
//     writes the tile's kept channel ids ascending into idx
//     (n_tiles, G*n), and the block gathers the kept columns into xc
//     (T, G*n).  The sum of squares is accumulated in double and rounded
//     once to float: a float square is exact in double, and the order of
//     the sum then changes the double only in its last bits, which the
//     round to float almost always removes; so the selection agrees with the
//     plain version's (core/nm.py tile_consensus_channels) on the same
//     input, except with negligible probability.  It is bound by bytes: x
//     read once, xc written once.
//  2. spmm_wgmma_kernel (bf16, a w the TMA and 16-byte copies can take): one
//     block per (BM-row block inside a consensus tile, 128 output columns,
//     k slice), BM = 256 (a whole 256-token consensus tile, so each gathered
//     weight row leaves the L2 once per tile) or 128 for short tiles.  A
//     producer warpgroup keeps a 4-stage ring full: the compacted x tile
//     (BM x 64, K-major) by one TMA load, and the 64 gathered weight rows
//     w[idx[tile][k0 + r], n0:n0 + 128] by 16-byte cp.async copies written
//     straight into the 128-byte-swizzled MN-major slots that TMA would write
//     for a dense w (16-byte unit u of row r at u ^ (r % 8)); Hopper's TMA
//     cannot gather.  The ids of a k step's rows are loaded a step ahead (two
//     coalesced loads a lane, handed out by shuffles): a gather that waits
//     on its own index load starves the tensor cores, and so does a single
//     producer warp.  The stage's full barrier counts the 128 producer
//     threads' cp.async arrivals plus the TMA's bytes.  Two consumer
//     warpgroups of BM/2 rows run m64n128k16 wgmmas from shared memory
//     (after a proxy fence: cp.async writes are generic-proxy writes), one k
//     step in flight, and the epilogue leaves through shared memory in
//     16-byte stores.  The launch walks the consensus tiles of one column slab next
//     to one another, so the tiles' overlapping kept rows meet in the L2.  A
//     grid that fills under half the SMs splits k into float32 partials,
//     reduced in slice order (spmm_splitk_reduce_kernel, no atomics).  The
//     GEMM is a programmatic dependent launch of the selection: its barrier
//     set-up overlaps the selection's tail; its loads wait for it.
//  3. spmm_bf16_kernel (bf16 the TMA cannot take: w not 16-byte aligned, N or
//     G*n not a multiple of 8): 64x128 WMMA tiles, double-buffered cp.async.
//     spmm_f32_kernel: float32 on the CUDA cores (no TF32).
//
// The wrapper (kernels/nm_spmm.py: gemm_plan) picks the GEMM route and the
// k split; this file launches what it is told.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// ---------------------------------------------------------------- selection
constexpr int SEL_THREADS = 256;
constexpr int SEL_UNITS = 16;                        // 16-byte units of a block's span
constexpr int SEL_ROWS = SEL_THREADS / SEL_UNITS;    // rows read at once

template <typename T>
__global__ void __launch_bounds__(SEL_THREADS)
consensus_select_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        int* __restrict__ idx, T* __restrict__ xc, int T_, int D, int n,
                        int m, int tile) {
  constexpr int V = 16 / sizeof(T);                  // channels of a 16-byte unit
  constexpr int SPAN = SEL_UNITS * V;                // channels a block may own
  __shared__ double part[SEL_ROWS][SPAN];
  __shared__ float pooled[SPAN];
  __shared__ int kept[SPAN];                         // absolute kept channel ids
  __shared__ int keepf[SPAN];                        // channel of the span kept?
  // the GEMM launched after this kernel may start its set-up now
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int gpb = SPAN / m;                          // groups per block
  const int G = D / m, kc = G * n;
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, G - g0);                   // groups this block owns
  const int span = ng * m, c_lo = g0 * m;
  const int ti = blockIdx.y;
  const int r0 = ti * tile, r1 = min(T_, r0 + tile);

  // 1. pool: thread (u, lr) sums channels c_lo + u*V .. +V over rows
  //    r0 + lr, r0 + lr + 16, ...; a whole aligned unit is one 16-byte load
  const int u = threadIdx.x % SEL_UNITS, lr = threadIdx.x / SEL_UNITS;
  const int cu = u * V;                              // first channel of the unit in the span
  const int nv = max(0, min(V, span - cu));          // its channels inside the span
  const bool vec = nv == V && (((reinterpret_cast<uintptr_t>(x) & 15) | (D % V) | (c_lo % V)) == 0);
  float sc[V];
  double acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sc[e] = e < nv ? (scale != nullptr ? scale[c_lo + cu + e] : 1.f) : 0.f;
    acc[e] = 0.0;
  }
  if (nv > 0) {
#pragma unroll 4
    for (int r = r0 + lr; r < r1; r += SEL_ROWS) {
      const T* src = x + (size_t)r * D + c_lo + cu;
      alignas(16) T v[V];
      if (vec) {
        *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = e < nv ? src[e] : from_f<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float s = __fmul_rn(fabsf(to_f(v[e])), sc[e]);
        acc[e] += (double)s * (double)s;             // exact square, summed in double
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[lr][cu + e] = acc[e];
  __syncthreads();
  for (int i = threadIdx.x; i < span; i += SEL_THREADS) {
    double s = 0.0;
#pragma unroll
    for (int l = 0; l < SEL_ROWS; ++l) s += part[l][i];
    pooled[i] = __fsqrt_rn(__double2float_rn(s));
  }
  __syncthreads();

  // 2. select, one thread per channel: channel i is kept when fewer than n
  //    channels of its group rank above it, in torch.argmax's order: NaN
  //    above every number, then the larger score, a tie (NaN with NaN too)
  //    to the lower channel.  A strict total order, so every group keeps
  //    exactly n: the channels of the n rounds of first-occurrence argmax;
  //    ids ascending in the group
  for (int i = threadIdx.x; i < span; i += SEL_THREADS) {
    const int gb = i - i % m;
    const float p = pooled[i];
    const bool pn = isnan(p);
    int rank = 0;
    for (int j = gb; j < gb + m; ++j) {
      const float q = pooled[j];
      rank += isnan(q) ? (!pn || j < i) : (!pn && (q > p || (q == p && j < i)));
    }
    keepf[i] = rank < n;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < span; i += SEL_THREADS) {
    if (!keepf[i]) continue;
    const int gi = i / m;
    int k = 0;
    for (int j = gi * m; j < i; ++j) k += keepf[j];
    kept[gi * n + k] = c_lo + i;
    idx[(size_t)ti * kc + (size_t)(g0 + gi) * n + k] = c_lo + i;
  }
  __syncthreads();

  // 3. compact: xc[r, (g0+gi)*n + k] = x[r, kept[gi*n + k]], one thread per
  //    (row, group), consecutive threads on consecutive groups; a group of
  //    16 bytes of output (8:16 in bf16) leaves in one store.  The row's span
  //    was just read, so the gathered reads hit the cache.
  const bool vec_out = n == V && kc % V == 0 && (g0 * n) % V == 0 &&
                       (reinterpret_cast<uintptr_t>(xc) & 15) == 0;
  for (int e = threadIdx.x; e < (r1 - r0) * ng; e += SEL_THREADS) {
    const int r = r0 + e / ng, gi = e % ng;
    const T* xr = x + (size_t)r * D;
    T* dst = xc + (size_t)r * kc + (size_t)(g0 + gi) * n;
    if (vec_out) {
      alignas(16) T v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = xr[kept[gi * V + k]];
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int k = 0; k < n; ++k) dst[k] = xr[kept[gi * n + k]];
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

// ---------------------------------------------------------- bf16 wgmma GEMM
constexpr int GN = 128, GK = 64, GWG = 2;
constexpr int G_WCHUNK = GK * 128;                     // 8 KB: 64 k rows x 64 columns
constexpr int EPI_LD = GN * 2 + 16;                    // bytes per staged output row

constexpr int PW = 4;                                  // producer warps: a warpgroup
constexpr int GSTAGES = 4;

template <int MT>                                      // m64 tiles per consumer warpgroup
struct GemmSmem {
  static constexpr int BM = GWG * 64 * MT;
  static constexpr int THREADS = GWG * 128 + 32 * PW;
  static constexpr int XTILE = BM * GK * 2;
  static constexpr int STAGE = XTILE + 2 * G_WCHUNK;
  static constexpr int BYTES = GSTAGES * STAGE + 1024;  // + alignment slack
  static_assert(64 * MT * EPI_LD <= STAGE, "a warpgroup's output rows fit a stage");
};

template <int MT>
__global__ void __launch_bounds__(GemmSmem<MT>::THREADS, 1)
spmm_wgmma_kernel(__grid_constant__ const CUtensorMap xmap, const bf16* __restrict__ w,
                  const int* __restrict__ idx, bf16* __restrict__ out, float* __restrict__ part,
                  int T_, int kc, int N, int tile, int k_steps, int steps_per_split) {
  using L = GemmSmem<MT>;
  using namespace hopper;
  extern __shared__ unsigned char gsmem_raw[];
  unsigned char* sm = align1024(gsmem_raw);
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES];
  const RowBlock rb = row_block<L::BM>(T_, tile);
  const int n0 = blockIdx.y * GN, split = blockIdx.z;
  const int ks0 = split * steps_per_split;
  const int n_steps = min(k_steps, ks0 + steps_per_split) - ks0;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 32 * PW + 1);                // the producer lanes' copies + the TMA
      mbar_init(&empty[s], GWG * 4);                   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == GWG) {                                     // the producer warps
    // idx and xc are the selection's output (the kernel launched just before)
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int* tidx = idx + (size_t)rb.tile * kc;
    const int pt = threadIdx.x - GWG * 128, pw = pt / 32;
    // thread: 16-byte unit u of a 256-byte row slice, of rows
    // 2 (PW i + pw) + rp of the B tile
    const int u = lane % 16, rp = lane / 16;
    const int col = n0 + u * 8;
    const bool col_ok = col < N;                       // N % 8 == 0: the whole unit
    // the ids of rows lane and 32 + lane of a k step, loaded a step ahead
    auto ids = [&](int k0, int& a, int& b) {
      a = k0 + lane < kc ? __ldg(tidx + k0 + lane) : 0;
      b = k0 + 32 + lane < kc ? __ldg(tidx + k0 + 32 + lane) : 0;
    };
    int id_a, id_b;
    ids(ks0 * GK, id_a, id_b);
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % GSTAGES, k0 = (ks0 + j) * GK;
      const int cur_a = id_a, cur_b = id_b;
      if (j + 1 < n_steps) ids(k0 + GK, id_a, id_b);
      if (j >= GSTAGES) mbar_wait(&empty[s], (j / GSTAGES - 1) & 1);
      unsigned char* st = sm + s * L::STAGE;
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[s], L::XTILE);
        tma_load_2d(st, &xmap, &full[s], k0, rb.r0);   // rows past T arrive as zeros
      }
      // row r of the B tile is w[idx[k0 + r], n0:n0 + 128] (zeros past kc or N),
      // 16-byte unit u at chunk u / 8, swizzled slot (u % 8) ^ (r % 8)
      unsigned char* ws = st + L::XTILE + (u / 8) * G_WCHUNK;
#pragma unroll
      for (int i = 0; i < 32 / PW; ++i) {
        const int r = 2 * (PW * i + pw) + rp;
        const int id = __shfl_sync(0xffffffffu, i < 16 / PW ? cur_a : cur_b, r & 31);
        const bool ok = col_ok && k0 + r < kc;
        const bf16* src = ok ? w + (size_t)id * N + col : w;
        cp_async16_zfill(ws + r * 128 + (((u % 8) ^ (r % 8)) << 4), src, ok ? 16 : 0);
      }
      cp_async_mbar_arrive(&full[s]);
    }
    return;
  }

  const int warp = (threadIdx.x % 128) / 32;
  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
  for (int j = 0; j < n_steps; ++j) {
    const int s = j % GSTAGES;
    mbar_wait(&full[s], (j / GSTAGES) & 1);
    fence_proxy_async();                               // the cp.async rows, for wgmma
    // every warpgroup runs its products, rows past the block's included
    // (never stored): a branch around wgmma would make ptxas serialise it
    const unsigned char* xs = sm + s * L::STAGE + wg * MT * 64 * 128;
    const unsigned char* ws = sm + s * L::STAGE + L::XTILE;
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_m64n128k16_ss<1>(acc[mt], desc_k_major(xs + mt * 64 * 128 + kk * 32),
                               desc_mn_major(ws + kk * 16 * 128, G_WCHUNK), 1);
    wgmma_commit();
    wgmma_wait<1>();                                   // step j - 1's products are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    __syncwarp();
    if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % GSTAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
  // the split-k reduce may launch while the blocks write their partials
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const int rl0 = wg * MT * 64 + warp * 16 + lane / 4;  // first row (in the block) of the thread
  const int cq = 2 * (lane % 4);
  if (part != nullptr) {                               // this k slice's float32 partial
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = rb.r0 + rl0 + mt * 64 + 8 * hr;
        if (row >= rb.r1) continue;
#pragma unroll
        for (int j = 0; j < GN / 8; ++j) {
          const int col = n0 + 8 * j + cq;
          if (col < N)
            *reinterpret_cast<float2*>(part + ((size_t)split * T_ + row) * N + col) =
                make_float2(acc[mt][4 * j + 2 * hr], acc[mt][4 * j + 2 * hr + 1]);
        }
      }
    return;
  }
  // epilogue: bf16 rows through shared memory (the ring is free once every
  // consumer's last products are done), then whole 16-byte stores
  named_barrier(1, GWG * 128);
  unsigned char* stg = sm + wg * L::STAGE;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = mt * 64 + warp * 16 + lane / 4 + 8 * hr;
#pragma unroll
      for (int j = 0; j < GN / 8; ++j)
        *reinterpret_cast<uint32_t*>(stg + r * EPI_LD + (8 * j + cq) * 2) =
            pack_bf16(acc[mt][4 * j + 2 * hr], acc[mt][4 * j + 2 * hr + 1]);
    }
  named_barrier(2 + wg, 128);
  for (int i = threadIdx.x % 128; i < MT * 64 * (GN / 8); i += 128) {
    const int r = i / (GN / 8), cu = i % (GN / 8);
    const int row = rb.r0 + wg * MT * 64 + r, col = n0 + cu * 8;
    if (row < rb.r1 && col < N)
      *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
          *reinterpret_cast<const uint4*>(stg + r * EPI_LD + cu * 16);
  }
}

// out = bf16(sum of the k slices' float32 partials, in slice order): the
// split-k reduce, deterministic (hopper::splitk_reduce_bf16, no bias).
__global__ void __launch_bounds__(256)
spmm_splitk_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ out, int T_, int N,
                          int splits) {
  hopper::splitk_reduce_bf16(part, nullptr, out, T_, N, splits);
}

// ------------------------------------------------------ bf16 WMMA GEMM
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
  constexpr int SPAN = SEL_UNITS * 16 / (int)sizeof(T);
  const int gpb = SPAN / m, G = D / m;
  dim3 grid((G + gpb - 1) / gpb, (T_ + tile - 1) / tile);
  consensus_select_kernel<T><<<grid, SEL_THREADS, 0, s>>>((const T*)x, scale, idx, (T*)xc, T_,
                                                          D, n, m, tile);
  return (int)cudaGetLastError();
}

int row_blocks(int T_, int tile, int bm) {
  const int n_tiles = (T_ + tile - 1) / tile, per_tile = (tile + bm - 1) / bm;
  return n_tiles * per_tile;
}

template <int MT>
int launch_wgmma(const void* xc, const void* w, const int* idx, void* out, float* part, int T_,
                 int kc, int N, int tile, int splits, cudaStream_t s) {
  using L = GemmSmem<MT>;
  CUtensorMap xm;
  const cuuint64_t dims[2] = {(cuuint64_t)kc, (cuuint64_t)T_};
  const cuuint64_t strides[1] = {(cuuint64_t)kc * 2};
  const cuuint32_t box[2] = {GK, L::BM};
  int rc = hopper::encode_bf16_sw128(&xm, xc, 2, dims, strides, box);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(spmm_wgmma_kernel<MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int k_steps = (kc + GK - 1) / GK;
  const int per = (k_steps + splits - 1) / splits;
  // may start while the selection, the stream's previous kernel, runs
  e = hopper::launch_dependent(spmm_wgmma_kernel<MT>,
                               dim3(row_blocks(T_, tile, L::BM), (N + GN - 1) / GN, splits),
                               dim3(L::THREADS), L::BYTES, s, xm, (const bf16*)w, idx,
                               (bf16*)out, splits > 1 ? part : nullptr, T_, kc, N, tile, k_steps,
                               per);
  if (e != cudaSuccess) return (int)e;
  if (splits == 1) return (int)cudaGetLastError();
  const long long quads = (long long)T_ * N / 4;
  e = hopper::launch_dependent(spmm_splitk_reduce_kernel, dim3((unsigned)((quads + 255) / 256)),
                               dim3(256), 0, s, (const float*)part, (bf16*)out, T_, N, splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers;
// scale may be null.  `idx` (n_tiles, D*n/m) int32 and `xc` (T, D*n/m) in
// x's dtype are caller-allocated scratch that receive the kept channel ids
// and the compacted activations.  Requires 0 < n <= m <= 32 and D % m == 0
// (the wrapper checks).  `bm` is the bf16 GEMM's route from the wrapper's
// plan: 0 = the WMMA kernel, 128 or 256 = the wgmma kernel with that row
// block in `splits` k slices (> 1: `part` is a float32 workspace of
// splits * T * N elements).  Launches the selection and the GEMM on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int nm_spmm_bf16(const void* x, const void* w, const float* scale, int* idx,
                            void* xc, void* out, float* part, int T, int D, int N, int n, int m,
                            int tile, int bm, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_select<bf16>(x, scale, idx, xc, T, D, n, m, tile, s);
  if (rc != 0) return rc;
  const int kc = D / m * n;
  if (bm == 0) {
    dim3 grid(row_blocks(T, tile, BM), (N + BN - 1) / BN);
    spmm_bf16_kernel<<<grid, THREADS, 0, s>>>((const bf16*)xc, (const bf16*)w, idx, (bf16*)out,
                                              T, kc, N, tile);
    return (int)cudaGetLastError();
  }
  if (splits < 1 || (splits > 1 && part == nullptr) || (bm != 128 && bm != 256))
    return (int)cudaErrorInvalidValue;
  return bm == 256 ? launch_wgmma<2>(xc, w, idx, out, part, T, kc, N, tile, splits, s)
                   : launch_wgmma<1>(xc, w, idx, out, part, T, kc, N, tile, splits, s);
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
// channels against the plain version and timing it.
extern "C" int nm_spmm_select_bf16(const void* x, const float* scale, int* idx, void* xc, int T,
                                   int D, int n, int m, int tile, void* stream) {
  return launch_select<bf16>(x, scale, idx, xc, T, D, n, m, tile, (cudaStream_t)stream);
}

extern "C" int nm_spmm_select_f32(const void* x, const float* scale, int* idx, void* xc, int T,
                                  int D, int n, int m, int tile, void* stream) {
  return launch_select<float>(x, scale, idx, xc, T, D, n, m, tile, (cudaStream_t)stream);
}
