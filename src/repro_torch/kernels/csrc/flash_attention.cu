// Attention over contiguous K/V (causal or not, optional sliding-window band)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel, softmax helpers softmax_init /
// softmax_update / softmax_finalize).  q (B, T, Hq, hd) attends to k/v
// (B, S, Hkv, hd) — the port's layout, read in place, no head-repeated KV:
// query head h reads KV head h / (Hq / Hkv).  S == T for causal or banded
// attention; a non-causal call with no band may take any S (keys longer or
// shorter than the queries: cross-attention).  Key p is visible to query t
// when p < S, (causal) p <= t, and (window > 0) p > t - window.  A masked
// key's weight is exactly 0 (bf16 path: its score is -inf and the running
// max starts at -1e30; rows path: score -1e30 and the s > -1e30/2 guard);
// the float32 online softmax divides by max(l, 1e-20), so a row that sees
// no key gives 0.  Key blocks wholly outside a query
// tile's band are skipped, as the TPU kernel's block visibility check does.
//
// What bounds it on the H100: at the one-shot prefill's shape (B = 4,
// Hq = 28, Hkv = 4, T = 512, hd = 128, causal) the kernel moves ~34 MB and
// does ~7.5 GFLOP of visible products: 0.010 ms of memory and 0.008 ms of
// tensor-core time at the data-sheet rates, so it is bound by how well the
// tensor cores are kept fed.  Two paths, chosen by the wrapper's plan
// (kernels/flash_attention.py: flash_plan):
//  * bf16, head_dim a multiple of 8 up to 256, 16-byte-aligned tensors:
//    flash_bf16_kernel, on the wgmma tensor-core path, built for tiles of
//    64, 128 and 256 columns (head_dim <= 64, <= 128, <= 256).  A head_dim
//    below its tile's is padded by the tensor maps, which span the real
//    head_dim: a box's columns past it load as zeros, Q K^T adds exact
//    zeros and the TMA store clips O's extra columns, so device memory
//    moves the real bytes and the tensor cores the tile's work.  One block
//    per (NWG x 64 query rows, query head, batch row), the last (heaviest
//    causal) query tiles launched first; NWG consumer warpgroups (3 at tile
//    64, 2 at 128, 1 at 256) take 64 rows each and share every K/V tile,
//    which one producer warp streams through a 3-stage ring with TMA (4-d
//    tensor maps over the (B, T, H, hd) layout, 128-byte swizzle; rows past
//    T arrive as zeros) under full and empty mbarriers.  At tile 256 a
//    stage is 64 KiB, so Q and the ring take 225 of an SM's 227 KiB, and O
//    is 128 float32 registers a thread (P V two n128 products): a second
//    warpgroup would leave 2 stages and spill under the 224 registers a
//    288-thread block may hold (it was built so and ran slower).  S = Q K^T
//    is a wgmma from shared memory (both K-major); the online softmax runs
//    on the accumulator fragments in the log2 domain (row max and sum
//    across the 4 lanes of a row by shuffles; the visibility test only on
//    tiles that straddle the diagonal, the band edge or T); P is rounded to
//    bf16 in registers and is the A operand of O += P V, with V the
//    MN-major B operand as stored.  S and P never touch shared memory; O
//    stays in registers until the epilogue rounds it into the warpgroup's
//    (then free) Q tile, which leaves by TMA store in whole 128-byte lines.
//    What bounds it now (chip_smoke.py phase 2g on an H100: 0.039 ms
//    against 0.008 ms of tensor-core work) is not the tensor cores but the
//    softmax between a warpgroup's two products and each block's first
//    loads, which nothing else on the SM overlaps.
//  * everything else (float32, head_dim not a multiple of 8, unaligned
//    tensors): one block per (16-row tile, KV head, batch row) on the CUDA
//    cores; the tile flattens (query position, head in the GQA group), so
//    the G = Hq / Hkv heads that share a KV head read each staged 16-key
//    sub-tile once; one warp per row, each lane holding hd / 32 of the
//    query, the accumulator and the value dims.  Products are float32 FMAs (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;                 // masked-score sentinel

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// First key a query tile [q_lo, ...] can see: keys at or below
// q_lo - window are outside every row's band.
__device__ __forceinline__ int band_start(int q_lo, int window, int align) {
  if (window <= 0) return 0;
  const int lo = max(0, q_lo - window + 1);
  return lo - lo % align;
}

__device__ __forceinline__ bool visible(int kp, int qp, int S_, int causal, int window) {
  return kp < S_ && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ------------------------------------------------------ CUDA-core path
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;   // flattened (t, g) rows per block
constexpr int KT = 16;                        // keys per staged sub-tile
constexpr int MAX_HD = 256;
constexpr int DPL = MAX_HD / 32;              // dims per lane (upper bound)

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
attention_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int T_, int S_, int Hq,
                      int Hkv, int hd, int causal, int window, float scale) {
  __shared__ float ks[KT * MAX_HD];
  __shared__ float vs[KT * MAX_HD];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile0 = blockIdx.x * ROWS;
  const int t_lo = tile0 / G;
  const int t_hi = min(T_ - 1, (tile0 + ROWS - 1) / G);

  float qv[ROWS_PER_WARP][DPL], acc[ROWS_PER_WARP][DPL];
  float m_i[ROWS_PER_WARP], l_i[ROWS_PER_WARP];
  int qpos[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int ri = tile0 + warp + WARPS * rr;
    const int t = ri / G, h = kvh * G + ri % G;
    live[rr] = t < T_;
    qpos[rr] = t;
    m_i[rr] = NEG;
    l_i[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[rr][i] = 0.f;
      qv[rr][i] = (live[rr] && d < hd)
          ? to_f(q[(((size_t)b * T_ + t) * Hq + h) * hd + d]) * scale : 0.f;
    }
  }

  const int k_end = causal ? t_hi + 1 : S_;
  const size_t row_stride = (size_t)Hkv * hd;   // elements between key rows
  for (int kbase = band_start(t_lo, window, KT); kbase < k_end; kbase += KT) {
    const int nk = min(KT, k_end - kbase);
    __syncthreads();                            // previous sub-tile consumed
    const size_t base = ((size_t)b * S_ + kbase) * row_stride + (size_t)kvh * hd;
    for (int i = threadIdx.x; i < nk * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd;
      ks[j * hd + d] = to_f(k[base + j * row_stride + d]);
      vs[j * hd + d] = to_f(v[base + j * row_stride + d]);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      if (!live[rr]) continue;
      float s[KT];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < nk) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < hd) dot = fmaf(qv[rr][i], ks[j * hd + d], dot);
          }
          const float sc = warp_sum(dot);
          s[j] = visible(kbase + j, qpos[rr], S_, causal, window) ? sc : NEG;
        } else {
          s[j] = NEG;
        }
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_i[rr], mx);
      const float alpha = expf(m_i[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[j] = (s[j] > NEG / 2) ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l_i[rr] = l_i[rr] * alpha + psum;
      m_i[rr] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          float a = acc[rr][i] * alpha;
#pragma unroll
          for (int j = 0; j < KT; ++j)
            if (j < nk) a = fmaf(s[j], vs[j * hd + d], a);
          acc[rr][i] = a;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    if (!live[rr]) continue;
    const int ri = tile0 + warp + WARPS * rr;
    const int t = ri / G, h = kvh * G + ri % G;
    const float inv = 1.f / fmaxf(l_i[rr], 1e-20f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) out[(((size_t)b * T_ + t) * Hq + h) * hd + d] = from_f<T>(acc[rr][i] * inv);
    }
  }
}

template <typename T>
int launch_rows(const void* q, const void* k, const void* v, void* out, int B, int T_, int S_,
                int Hq, int Hkv, int hd, int causal, int window, float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
  dim3 grid((T_ * G + ROWS - 1) / ROWS, Hkv, B);
  attention_rows_kernel<T><<<grid, WARPS * 32, 0, s>>>((const T*)q, (const T*)k, (const T*)v,
                                                       (T*)out, T_, S_, Hq, Hkv, hd, causal,
                                                       window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 flash path
// One block per (NWG x 64 query rows, query head, batch row), the last query
// tiles (the heaviest under a causal mask) launched first: NWG consumer
// warpgroups of 64 rows each share every staged K/V tile, and one producer
// warp's lane 0 fetches Q and keeps the K/V ring full with TMA loads.
constexpr int FQ = 64;            // query rows per warpgroup
constexpr int FK = 64;            // keys per staged tile
constexpr int FSTAGES = 3;        // K/V ring depth

template <int HD, int NWG>
struct FlashSmem {
  static constexpr int CHUNK_Q = FQ * 128;                // one 64-column chunk of a Q tile
  static constexpr int CHUNK_KV = FK * 128;               // ... of a K or V tile
  static constexpr int Q = NWG * FQ * HD * 2;
  static constexpr int TILE = FK * HD * 2;                // K or V tile bytes
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BYTES = Q + FSTAGES * STAGE + 1024;  // + alignment slack
  static_assert(BYTES <= 227 * 1024, "over the shared memory of an SM");
};

template <int HD, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_bf16_kernel(__grid_constant__ const CUtensorMap qmap,
                  __grid_constant__ const CUtensorMap kmap,
                  __grid_constant__ const CUtensorMap vmap,
                  __grid_constant__ const CUtensorMap omap, int T_, int S_, int Hq, int Hkv,
                  int causal, int window, float scale_log2) {
  using L = FlashSmem<HD, NWG>;
  using namespace hopper;
  constexpr int CH = HD / 64;                 // 64-column chunks per row
  extern __shared__ unsigned char fsmem_raw[];
  unsigned char* fsmem = align1024(fsmem_raw);
  __shared__ __align__(8) uint64_t full[FSTAGES], empty[FSTAGES], qfull;
  unsigned char* qs = fsmem;
  unsigned char* kvs = fsmem + L::Q;

  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (Hq / Hkv);
  // heaviest causal tiles first (without a causal mask every tile walks
  // all ceil(S / 64) key tiles, and the order does not matter)
  const int t0 = (gridDim.z - 1 - blockIdx.z) * (NWG * FQ);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  // the block's key tiles (causal or banded: S == T)
  const int k_begin = band_start(t0, window, FK);
  const int k_end = causal ? min(T_ - 1, t0 + NWG * FQ - 1) + 1 : S_;
  const int n_tiles = (k_end - k_begin + FK - 1) / FK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);          // lane 0 of every consumer warp
    }
    mbar_init(&qfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {                            // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(&qfull, L::Q);
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load_4d(qs + (w * CH + c) * L::CHUNK_Q, &qmap, &qfull, c * 64, h, t0 + w * FQ, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FSTAGES, k0 = k_begin + i * FK;
        if (i >= FSTAGES) mbar_wait(&empty[s], (i / FSTAGES - 1) & 1);
        unsigned char* ks = kvs + s * L::STAGE;
        mbar_arrive_expect_tx(&full[s], L::STAGE);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(ks + c * L::CHUNK_KV, &kmap, &full[s], c * 64, kvh, k0, b);
          tma_load_4d(ks + L::TILE + c * L::CHUNK_KV, &vmap, &full[s], c * 64, kvh, k0, b);
        }
      }
    }
    return;
  }

  // this warpgroup's rows and the key tiles they see
  const int w_lo = t0 + wg * FQ, w_hi = w_lo + FQ - 1;
  const bool live = w_lo < T_;
  const int w_begin = band_start(w_lo, window, FK);
  const int w_end = live ? (causal ? min(T_ - 1, w_hi) + 1 : S_) : 0;
  // this thread's two rows of the tile: r and r + 8
  const int warp = (threadIdx.x % 128) / 32;
  const int row0 = w_lo + warp * 16 + lane / 4;
  const int qd = 2 * (lane % 4);              // first column of a pair in an 8-wide block
  const unsigned char* q_wg = qs + wg * CH * L::CHUNK_Q;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};

  mbar_wait(&qfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % FSTAGES, k0 = k_begin + i * FK;
    const unsigned char* ks = kvs + s * L::STAGE;
    const unsigned char* vs = ks + L::TILE;
    mbar_wait(&full[s], (i / FSTAGES) & 1);
    if (k0 >= w_begin && k0 < w_end) {
      // S = Q K^T: Q and K both K-major (head dims along the 128-byte rows)
      wgmma_fence();
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss<0>(
            sc, desc_k_major(q_wg + (kk / 4) * L::CHUNK_Q + (kk % 4) * 32),
            desc_k_major(ks + (kk / 4) * L::CHUNK_KV + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax on the fragments, in the log2 domain: p = 2^(s c -
      // m c) with c = scale * log2(e) as one FFMA; the visibility test
      // only on tiles that straddle the diagonal, the band edge or S, where
      // a hidden key's score becomes -inf and its weight exactly 0.  The
      // running max starts at -1e30, so it is never -inf.
      const bool edge = k0 + FK > S_ || (causal && k0 + FK - 1 > w_lo) ||
                        (window > 0 && k0 <= w_hi - window);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qpos = row0 + 8 * hr;
        if (edge) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (!visible(k0 + 8 * j + qd + e, qpos, S_, causal, window))
                sc[4 * j + 2 * hr + e] = -INFINITY;
        }
        float mx[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) mx[j] = fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]);
#pragma unroll
        for (int w = 4; w > 0; w /= 2)      // pairwise: short dependence chains
#pragma unroll
          for (int j = 0; j < w; ++j) mx[j] = fmaxf(mx[j], mx[j + w]);
        float m = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float m_new = fmaxf(m_r[hr], m);
        const float alpha = fast_exp2((m_r[hr] - m_new) * scale_log2);
        const float mc = m_new * scale_log2;
        float ps[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hr + e];
            x = fast_exp2(fmaf(x, scale_log2, -mc));
          }
          ps[j] = sc[4 * j + 2 * hr] + sc[4 * j + 2 * hr + 1];
        }
#pragma unroll
        for (int w = 4; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) ps[j] += ps[j + w];
        l_r[hr] = l_r[hr] * alpha + ps[0];  // this thread's share of the row sum
        m_r[hr] = m_new;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j + 2 * hr] *= alpha;
          o[4 * j + 2 * hr + 1] *= alpha;
        }
      }
      // P (rounded to bf16) as the register A operand: k16 step kk covers
      // the S blocks 2kk and 2kk + 1
      uint32_t pa[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: V is the MN-major B operand (head dims along the rows);
      // at HD 256 two n128 products, on V's chunks 0-1 and 2-3 into O's
      // columns 0-127 (o[0..63]) and 128-255 (o[64..127])
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        const uint64_t dv = desc_mn_major(vs + kk * 16 * 128, L::CHUNK_KV);
        if constexpr (HD == 256) {
          wgmma_m64n128k16_rs<1>(*reinterpret_cast<float(*)[64]>(o), a, dv, 1);
          wgmma_m64n128k16_rs<1>(*reinterpret_cast<float(*)[64]>(o + 64), a,
                                 desc_mn_major(vs + 2 * L::CHUNK_KV + kk * 16 * 128,
                                               L::CHUNK_KV),
                                 1);
        } else if constexpr (HD == 128) {
          wgmma_m64n128k16_rs<1>(o, a, dv, 1);
        } else {
          wgmma_m64n64k16_rs<1>(o, a, dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);    // this warp is done with stage s
  }

  if (!live) return;
  // epilogue: O / l rounded to bf16 into this warpgroup's Q tile (free now:
  // its last S product is done), in the same 128-byte-swizzled chunks, then
  // one TMA store per chunk; rows past T are not written
  unsigned char* o_wg = qs + wg * CH * L::CHUNK_Q;
  const int r = warp * 16 + lane / 4;         // row within the warpgroup's tile
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    const int rr = r + 8 * hr;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(o_wg + (j / 8) * L::CHUNK_Q + rr * 128 +
                                   (((j % 8) ^ (rr % 8)) << 4) + qd * 2) =
          pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) tma_store_4d(&omap, o_wg + c * L::CHUNK_Q, c * 64, h, w_lo, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// (hd, H, T, B) view of a (B, T, H, hd) tensor, boxes of 64 dims x 64 rows.
// It spans the real head_dim, so a tile's columns past it load as zeros and
// are clipped from the store.
int flash_map(CUtensorMap* map, const void* p, int B, int T_, int H, int hd) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T_, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)T_ * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return hopper::encode_bf16_sw128(map, p, 4, dims, strides, box);
}

template <int HD, int NWG>
int launch_flash(const void* q, const void* k, const void* v, void* out, int B, int T_, int S_,
                 int Hq, int Hkv, int hd, int causal, int window, float scale, cudaStream_t s) {
  using L = FlashSmem<HD, NWG>;
  CUtensorMap qm, km, vm, om;
  int rc = flash_map(&qm, q, B, T_, Hq, hd);
  if (rc == 0) rc = flash_map(&km, k, B, S_, Hkv, hd);   // rows past S arrive as zeros
  if (rc == 0) rc = flash_map(&vm, v, B, S_, Hkv, hd);
  if (rc == 0) rc = flash_map(&om, out, B, T_, Hq, hd);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(flash_bf16_kernel<HD, NWG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hq, B, (T_ + NWG * FQ - 1) / (NWG * FQ));
  flash_bf16_kernel<HD, NWG><<<grid, NWG * 128 + 32, L::BYTES, s>>>(
      qm, km, vm, om, T_, S_, Hq, Hkv, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  All pointers are device pointers
// to contiguous tensors; q/out (B, T, Hq, hd), k/v (B, S, Hkv, hd); Hq is a
// multiple of Hkv, hd <= 256, and S == T unless causal == 0 and window <= 0
// (the wrapper checks).  `window` <= 0 means no band.  Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// launched).
//
// The wgmma path (the wrapper's flash_plan says when): bf16, 16-byte-aligned
// tensors, hd a multiple of 8 at most `tile_hd`, on the kernel built for
// (tile_hd, nwg) consumer warpgroups: (64, 3), (128, 2) or (256, 1); any
// other pair is refused.
extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v,
                                          void* out, int B, int T, int S, int Hq, int Hkv,
                                          int hd, int causal, int window, float scale,
                                          int tile_hd, int nwg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 0 || hd % 8 != 0 || hd > tile_hd) return (int)cudaErrorInvalidValue;
  if (S != T && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  if (tile_hd == 128 && nwg == 2)             // 8 consumer warps + a producer
    return launch_flash<128, 2>(q, k, v, out, B, T, S, Hq, Hkv, hd, causal, window, scale, s);
  if (tile_hd == 64 && nwg == 3)              // 12 + a producer
    return launch_flash<64, 3>(q, k, v, out, B, T, S, Hq, Hkv, hd, causal, window, scale, s);
  if (tile_hd == 256 && nwg == 1)             // 4 + a producer
    return launch_flash<256, 1>(q, k, v, out, B, T, S, Hq, Hkv, hd, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The CUDA-core rows path (float32, hd not a multiple of 8, unaligned tensors).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int T, int S, int Hq, int Hkv, int hd, int causal,
                                    int window, float scale, void* stream) {
  if (S != T && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  return launch_rows<bf16>(q, k, v, out, B, T, S, Hq, Hkv, hd, causal, window, scale,
                           (cudaStream_t)stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int T, int S, int Hq, int Hkv, int hd, int causal,
                                   int window, float scale, void* stream) {
  if (S != T && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  return launch_rows<float>(q, k, v, out, B, T, S, Hq, Hkv, hd, causal, window, scale,
                            (cudaStream_t)stream);
}
