// Paged KV scatter and paged attention for Hopper (sm_90a).
//
// paged_kv_scatter replaces the TPU kernel
// repro/kernels/paged_attention.py: paged_kv_scatter_pallas (_scatter_call,
// body _scatter_kernel).  It writes chunk rows [pos, pos + chunk_len) of
// k_new/v_new (B, T, Hkv, hd) into the pools (rows, block_size, Hkv, hd)
// through the block table, in place.  A row is dropped when t >= chunk_len,
// when its position is negative, when its logical block is past the table
// width, or when the table entry is -1 or not below the pool's rows.  The
// copy is bit-exact for any element type.  The TPU kernel parks its
// invisible grid steps on a sentinel pool row; this kernel simply skips a
// dropped row, so it never touches that row.
// Bound on the H100: bytes (one read and one write of every kept row: 1 MB
// for a 256-token LLaMA chunk, 0.3 us at 3.35 TB/s).  What a call really
// costs is latency: its launch, and the chain of dependent loads (chunk_len
// and pos, then the table entry) before the first copy.  The design:
//  * one warp per (b, t) row, up to 8 rows to a 256-thread block, so a
//    chunk is 32 blocks and the one-shot prefill's 2048 rows 256; a lane
//    loads all of its 16-byte words of K and V (4 + 4 for a bf16 row of
//    8 x 128) before it stores any, so every load of the row is in flight
//    at once.  A row whose size or base addresses are not 16-byte multiples
//    takes the byte route (the same warp per row, one byte a lane a step);
//  * it is launched as a programmatic dependent (PDL) of the kernel before
//    it on the stream, which produced k_new / v_new: the index chain runs
//    before griddepcontrol.wait, overlapping that kernel's tail and this
//    launch, and only the copy waits.  chunk_len, pos and the table must
//    therefore have been written before that kernel started (by the host,
//    or by an earlier kernel), which the model guarantees: it builds them
//    once per step, before the first layer.  The launch is recorded as a
//    programmatic edge when it is captured in a CUDA graph;
//  * it triggers its dependents (griddepcontrol.launch_dependents) once its
//    stores are issued.
//
// paged_attention replaces repro/kernels/paged_attention.py:
// paged_attention_pallas (body _kernel, visibility _block_visible, softmax
// helpers flash_attention.py softmax_update / softmax_finalize).  Attention
// of q (B, Tq, Hq, hd) over the paged pools: the block walks the row's
// block table, skips -1 entries (and entries >= the pool's rows), stops at
// kv_len (or, causal, past the last query position of the tile), masks
// scores by absolute position (q_offset[b] + t), zeroes V rows past kv_len
// (the NaN fence: unwritten pool rows must never reach the P.V product),
// maps query head h to KV head h / (Hq / Hkv), and runs the float32 online
// softmax whose fully-masked rows come out as zeros (l clamped at 1e-20).
// With window > 0 (the TPU kernel's `window`) a key is visible to query
// position q only if k > q - window: the walk starts at the first key tile
// or block that reaches the band of the query tile's lowest position (the
// tiles below it are never loaded, as _block_visible skips them), edge
// tiles mask the band per score, and a split walk splits the band, not the
// table (the last split takes whatever the band leaves; a split with no
// key writes (max -1e30, sum 0, O 0), which the merge weighs at 0).
// Bound on the H100: bytes (every visible K/V row
// read once) for decode and for the serving path's 256-token chunks (0.002
// ms at 3.35 TB/s); what a call costs beyond that is latency: a row's key
// tiles are walked in order.  Two paths, chosen by the wrapper's plan
// (kernels/paged_attention.py: attention_plan):
//  * paged_wgmma_kernel: bf16, head_dim a multiple of 8 up to 128,
//    16-byte-aligned tensors, a block size TMA can box (a multiple of 8 that
//    divides 64, or a multiple of 64), at most 64 query heads per KV head;
//    chunks and decode alike.  It is built for tiles of 64 and 128 columns:
//    head_dim <= 64 takes the first, up to 128 the second, and a head_dim
//    below its tile's is padded by the tensor maps, which span the real
//    head_dim: a box's columns past it load as zeros (Q K^T adds exact
//    zeros, the O columns past it are never stored; the TMA store clips
//    them and the split merge skips them), so device memory moves only the
//    real bytes and the tensor cores do the tile's work (hd 80: 128 / 80).
//    One block per (query tile, KV head, batch row, key split).  The query
//    tile packs the G = Hq / Hkv heads that share the KV head into the 64
//    wgmma rows (row = token * G + head: 16 tokens at G = 4, 9 at G = 7,
//    one at decode), loaded as one 4-d TMA box over (B, Tq, Hq, hd), so
//    each K/V page leaves device memory once per query tile, not G times.  A producer warp reads the row's
//    table and streams 64-key tiles through a ring of TMA loads: a page of
//    bs rows is a 4-d box over the pool (n_rows, bs, Hkv, hd), and 64 / bs
//    such boxes stack into exactly the 128-byte-swizzled tile one 64-row
//    box would give (bs % 8 == 0 keeps the 1024-byte swizzle atoms
//    aligned); pages that are -1, out of the pool, or wholly past kv_len are
//    not loaded and their bytes are not expected.  It also hands the
//    consumers a 64-bit mask of the tile's readable keys.  Its lanes read
//    the table 32 pages at a time and pass the pages round by shuffles: a
//    tile that waited on its own table read made the producer the limit.
//    One consumer warpgroup per block (two blocks share an SM; a second
//    warpgroup taking alternate key tiles was measured no faster): where
//    the mask is not full it zeroes the V rows of unreadable keys (the NaN
//    fence; generic stores, then a proxy fence before wgmma reads them),
//    then S = Q K^T and O += P V run as wgmma with S, P and O in registers
//    (P the register A operand), the mask and the causal test only on edge
//    tiles, as in flash_attention.cu.  Decode (only B * Hkv query tiles)
//    splits a row's key tiles across blocks: each writes its float32 (max,
//    sum, O) state, and the last block of a query tile (a ticket counter it
//    resets) merges them in split order — deterministic, one launch.
//    Unsplit, O / l leaves by TMA store.
//  * paged_attention_kernel (float32, head_dim not a multiple of 8 or above
//    128, other block sizes, misaligned tensors, G > 64): one block per
//    (query-row tile, KV head, batch row) on the CUDA cores; the tile
//    flattens (query position, head in the GQA group), so the G heads that
//    share a KV head read each staged K/V sub-tile once; one warp per row,
//    each lane holding hd / 32 of the query, the accumulator and the value
//    dims.  When all of a row's
//    queries fit one tile (decode), the walk over the block table is split
//    across `n_split` blocks that write partial (max, sum, acc) states, and
//    a combine kernel merges them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ scatter

constexpr int SCATTER_ROWS = 8;     // rows (warps) of a 256-thread block
constexpr int SCATTER_WORDS = 8;    // 16-byte words of K (and of V) a lane holds at once

// One warp per (b, t) row; VEC: 16-byte words (row_bytes % 16 == 0 and the
// four base pointers 16-byte aligned), else bytes.
template <bool VEC>
__global__ void __launch_bounds__(SCATTER_ROWS * 32) paged_kv_scatter_kernel(
    const unsigned char* __restrict__ kn, const unsigned char* __restrict__ vn,
    unsigned char* __restrict__ kp, unsigned char* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ pos,
    const int* __restrict__ chunk_len, int B, int T, int mb, int bs, int n_rows,
    long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * SCATTER_ROWS + (threadIdx.x >> 5);
  // the index chain, before the wait: its operands predate the producer
  long long dst = -1;
  if (row < (long long)B * T) {
    const int b = (int)(row / T), t = (int)(row - (long long)b * T);
    const int len = chunk_len[b], p0 = pos[b];          // two independent loads
    const int wpos = p0 + t;
    const int lb = wpos >= 0 ? wpos / bs : mb;
    if (t < len && wpos >= 0 && lb < mb) {
      const int pb = table[(size_t)b * mb + lb];
      if (pb >= 0 && pb < n_rows) dst = ((long long)pb * bs + wpos % bs) * row_bytes;
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");     // k_new / v_new are ready
  if (dst >= 0) {
    const long long src = row * row_bytes;
    if (VEC) {
      const uint4* ks = reinterpret_cast<const uint4*>(kn + src);
      const uint4* vs = reinterpret_cast<const uint4*>(vn + src);
      uint4* kd = reinterpret_cast<uint4*>(kp + dst);
      uint4* vd = reinterpret_cast<uint4*>(vp + dst);
      const int words = (int)(row_bytes / 16);
      for (int w0 = 0; w0 < words; w0 += 32 * SCATTER_WORDS) {
        uint4 kr[SCATTER_WORDS], vr[SCATTER_WORDS];
#pragma unroll
        for (int j = 0; j < SCATTER_WORDS; ++j) {
          const int w = w0 + j * 32 + lane;
          if (w < words) {
            kr[j] = ks[w];
            vr[j] = vs[w];
          }
        }
#pragma unroll
        for (int j = 0; j < SCATTER_WORDS; ++j) {
          const int w = w0 + j * 32 + lane;
          if (w < words) {
            kd[w] = kr[j];
            vd[w] = vr[j];
          }
        }
      }
    } else {
      for (long long i = lane; i < row_bytes; i += 32) {
        kp[dst + i] = kn[src + i];
        vp[dst + i] = vn[src + i];
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ---------------------------------------------------------------- attention

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;   // flattened (t, g) rows per block
constexpr int KT = 16;                        // keys per staged sub-tile
constexpr int MAX_HD = 256;
constexpr int DPL = MAX_HD / 32;              // dims per lane (upper bound)
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

// Stage `nk` rows of one KV head of one physical block into shared memory
// as float32; V rows at positions >= kv_len are zeroed.
template <typename T>
__device__ __forceinline__ void stage_kv(float* ks, float* vs, const T* __restrict__ kp,
                                         const T* __restrict__ vp, size_t base,
                                         int row_stride, int hd, int nk, int kbase,
                                         int kvl) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (hd % V == 0) && (row_stride % V == 0) &&
                   (((reinterpret_cast<uintptr_t>(kp + base) |
                      reinterpret_cast<uintptr_t>(vp + base)) & 15) == 0);
  if (vec) {
    const int per_row = hd / V;
    for (int i = threadIdx.x; i < nk * per_row; i += blockDim.x) {
      const int j = i / per_row, c = (i % per_row) * V;
      const size_t off = base + (size_t)j * row_stride + c;
      alignas(16) T kt[V];
      alignas(16) T vt[V];
      *reinterpret_cast<uint4*>(kt) = *reinterpret_cast<const uint4*>(kp + off);
      *reinterpret_cast<uint4*>(vt) = *reinterpret_cast<const uint4*>(vp + off);
      const bool live = kbase + j < kvl;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ks[j * hd + c + e] = to_f(kt[e]);
        vs[j * hd + c + e] = live ? to_f(vt[e]) : 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nk * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd;
      const size_t off = base + (size_t)j * row_stride + d;
      ks[j * hd + d] = to_f(kp[off]);
      vs[j * hd + d] = (kbase + j < kvl) ? to_f(vp[off]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ table,
                       const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                       T* __restrict__ out, int Tq, int Hq, int Hkv, int hd, int bs,
                       int mb, int n_rows, int causal, int window, float scale,
                       int ki_per_split, float* __restrict__ part) {
  __shared__ float ks[KT * MAX_HD];
  __shared__ float vs[KT * MAX_HD];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qoff = q_offset[b], kvl = kv_len[b];
  // split mode: blockIdx.x picks a range of logical blocks, not a row tile
  const bool split = part != nullptr;
  const int tile0 = split ? 0 : blockIdx.x * ROWS;
  const int t_hi = min(Tq - 1, (tile0 + ROWS - 1) / G);
  const int q_hi = qoff + t_hi;                 // last query position of the tile
  // the band's first block: keys below the tile's lowest query position
  // less the window are visible to no row of the tile
  const int ki_base = window > 0 ? max(0, qoff + tile0 / G - window + 1) / bs : 0;
  const int ki_lo = split ? ki_base + blockIdx.x * ki_per_split : ki_base;
  const int ki_hi = split && blockIdx.x + 1 < gridDim.x ? min(mb, ki_lo + ki_per_split) : mb;

  float qv[ROWS_PER_WARP][DPL], acc[ROWS_PER_WARP][DPL];
  float m_i[ROWS_PER_WARP], l_i[ROWS_PER_WARP];
  int qpos[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int ri = tile0 + warp + WARPS * rr;
    const int t = ri / G, h = kvh * G + ri % G;
    live[rr] = t < Tq;
    qpos[rr] = qoff + t;
    m_i[rr] = NEG;
    l_i[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[rr][i] = 0.f;
      qv[rr][i] = (live[rr] && d < hd)
          ? to_f(q[(((size_t)b * Tq + t) * Hq + h) * hd + d]) * scale : 0.f;
    }
  }

  const int row_stride = Hkv * hd;              // elements between pool rows
  for (int ki = ki_lo; ki < ki_hi; ++ki) {
    const int k_lo = ki * bs;
    if (k_lo >= kvl || (causal && k_lo > q_hi)) break;
    const int pb = table[(size_t)b * mb + ki];
    if (pb < 0 || pb >= n_rows) continue;
    for (int sub = 0; sub < bs; sub += KT) {
      const int kbase = k_lo + sub;
      if (kbase >= kvl || (causal && kbase > q_hi)) break;
      const int nk = min(KT, bs - sub);
      __syncthreads();                          // previous sub-tile consumed
      stage_kv(ks, vs, kp, vp, (((size_t)pb * bs + sub) * Hkv + kvh) * hd,
               row_stride, hd, nk, kbase, kvl);
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
            const int kpos = kbase + j;
            const bool ok = kpos < kvl && (!causal || kpos <= qpos[rr]) &&
                            (window <= 0 || kpos > qpos[rr] - window);
            s[j] = ok ? sc : NEG;
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
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    if (!live[rr]) continue;
    const int ri = tile0 + warp + WARPS * rr;
    if (split) {                                  // partial state for the combine
      float* dst = part + ((((size_t)b * Hkv + kvh) * gridDim.x + blockIdx.x) * ROWS + ri)
                              * (2 + hd);
      if (lane == 0) {
        dst[0] = m_i[rr];
        dst[1] = l_i[rr];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) dst[2 + d] = acc[rr][i];
      }
      continue;
    }
    const int t = ri / G, h = kvh * G + ri % G;
    const float inv = 1.f / fmaxf(l_i[rr], 1e-20f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd)
        out[(((size_t)b * Tq + t) * Hq + h) * hd + d] = from_f<T>(acc[rr][i] * inv);
    }
  }
}

// Merge the n_split partial (max, sum, acc) states of every query row of a
// split walk: the online-softmax rescale, then the clamped division.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                               int n_split, int Tq, int Hq, int Hkv, int hd) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t stride = (size_t)ROWS * (2 + hd);             // between splits
  for (int ri = warp; ri < Tq * G; ri += WARPS) {
    const float* base = part + (((size_t)b * Hkv + kvh) * n_split * ROWS + ri) * (2 + hd);
    float mx = NEG;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, base[s * stride]);
    float l = 0.f, acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = base + s * stride;
      const float w = expf(p[0] - mx);
      l += p[1] * w;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc[i] += p[2 + d] * w;
      }
    }
    const int t = ri / G, h = kvh * G + ri % G;
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) out[(((size_t)b * Tq + t) * Hq + h) * hd + d] = from_f<T>(acc[i] * inv);
    }
  }
}

template <typename T>
int launch_attention(const void* q, const void* kp, const void* vp, const int* table,
                     const int* q_offset, const int* kv_len, void* out, int B, int Tq,
                     int Hq, int Hkv, int hd, int bs, int mb, int n_rows, int causal,
                     int window, float scale, int n_split, int per, float* part,
                     void* stream) {
  const int G = Hq / Hkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split > 1 && part != nullptr && Tq * G <= ROWS) {
    if (per < 1) return (int)cudaErrorInvalidValue;
    paged_attention_kernel<T><<<dim3(n_split, Hkv, B), WARPS * 32, 0, s>>>(
        (const T*)q, (const T*)kp, (const T*)vp, table, q_offset, kv_len, (T*)out,
        Tq, Hq, Hkv, hd, bs, mb, n_rows, causal, window, scale, per, part);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    paged_attention_combine_kernel<T><<<dim3(Hkv, B), WARPS * 32, 0, s>>>(
        part, (T*)out, n_split, Tq, Hq, Hkv, hd);
    return (int)cudaGetLastError();
  }
  dim3 grid((Tq * G + ROWS - 1) / ROWS, Hkv, B);
  paged_attention_kernel<T><<<grid, WARPS * 32, 0, s>>>(
      (const T*)q, (const T*)kp, (const T*)vp, table, q_offset, kv_len, (T*)out,
      Tq, Hq, Hkv, hd, bs, mb, n_rows, causal, window, scale, mb, nullptr);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 wgmma path
constexpr int PK = 64;                    // keys per tile
constexpr int P_THREADS = 128 + 32;       // a consumer warpgroup + a producer warp
constexpr int MAX_SPLITS = 16;            // the merge's weights fit the Q tile

template <int HD>
struct PagedSmem {
  static constexpr int CH = HD / 64;                      // 64-column chunks of a row
  static constexpr int CHUNK = 64 * 128;                  // a chunk of a 64-row tile
  static constexpr int TILE = CH * CHUNK;                 // the Q, a K or a V tile
  static constexpr int STAGES = HD == 128 ? 2 : 3;        // K/V ring: two blocks an SM
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BYTES = TILE + STAGES * STAGE + 1024;  // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(P_THREADS, 2)
paged_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                   __grid_constant__ const CUtensorMap kmap,
                   __grid_constant__ const CUtensorMap vmap,
                   __grid_constant__ const CUtensorMap omap, const int* __restrict__ table,
                   const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                   bf16* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
                   int Tq, int Hq, int Hkv, int hd, int bs, int mb, int n_rows, int causal,
                   int window, float scale_log2, int nt, int per) {
  using L = PagedSmem<HD>;
  using namespace hopper;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char psmem_raw[];
  unsigned char* qs = align1024(psmem_raw);
  unsigned char* kvs = qs + L::TILE;
  __shared__ __align__(8) uint64_t full[L::STAGES], empty[L::STAGES], qfull;
  __shared__ uint64_t kmask[L::STAGES];   // bit j: key k0 + j of the staged tile is readable
  __shared__ int ticket;

  const int G = Hq / Hkv, rows = nt * G;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int qt = gridDim.y - 1 - blockIdx.y;             // the heaviest query tiles first
  const int kvh = blockIdx.z % Hkv, b = blockIdx.z / Hkv;
  const int t0 = qt * nt;
  const int qoff = q_offset[b], kvl = max(kv_len[b], 0);
  const int qpos_top = qoff + min(Tq, t0 + nt) - 1;      // the tile's last query position
  // this block's key tiles: split `split` of the tiles below kv_len and,
  // causal, below the tile's last query position; with a window, from the
  // first tile that reaches the band of the tile's first query position
  // (the last split takes the rest of the walk)
  const int k_end = causal ? min(kvl, qpos_top + 1) : kvl;
  const int kt_end = (k_end + PK - 1) / PK;
  const int kt0 = (window > 0 ? max(0, qoff + t0 - window + 1) / PK : 0) + split * per;
  const int n_tiles = max(0, (split + 1 < n_split ? min(kt_end, kt0 + per) : kt_end) - kt0);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);                            // lane 0 of every consumer warp
    }
    mbar_init(&qfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 1) {                                          // the producer warp
    if (lane == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      if (part == nullptr) prefetch_tensormap(&omap);
    }
    if (n_tiles > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&qfull, CH * rows * 128);
#pragma unroll
        for (int c = 0; c < CH; ++c)                      // rows past Tq arrive as zeros
          tma_load_4d(qs + c * L::CHUNK, &qmap, &qfull, c * 64, kvh * G, t0, b);
      }
      const int* trow = table + (size_t)b * mb;
      const int box = bs < PK ? bs : PK;                  // key rows of one page box
      const int pieces = PK / box;
      // piece q of the walk (box rows from key kt0 * PK + q * box): its page,
      // or -1 (unallocated, out of the pool, past the table or wholly past
      // kv_len).  Lane l reads the table entry of piece 32 j + l for the
      // 32 pieces of batch j at once; the pieces go round by shuffles, so no
      // tile waits on a table read of its own
      int batch = -1, pb_lane = -1;
      auto page = [&](int q) {
        if (q / 32 != batch) {
          batch = q / 32;
          const int kp = kt0 * PK + (batch * 32 + lane) * box, ki = kp / bs;
          pb_lane = ki < mb && kp < kvl ? __ldg(trow + ki) : -1;
          if (pb_lane >= n_rows) pb_lane = -1;
        }
        return __shfl_sync(0xffffffffu, pb_lane, q % 32);
      };
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::STAGES, k0 = (kt0 + i) * PK;
        uint64_t mask = 0;
        int loaded = 0;
        for (int p = 0; p < pieces; ++p)
          if (page(i * pieces + p) >= 0) {
            mask |= (box == PK ? ~0ull : ((1ull << box) - 1)) << (p * box);
            ++loaded;
          }
        const int live = kvl - k0;                        // keys of the tile below kv_len
        if (live < PK) mask &= (1ull << live) - 1;        // 0 < live here
        if (i >= L::STAGES) mbar_wait(&empty[s], (i / L::STAGES - 1) & 1);
        if (lane == 0) {
          kmask[s] = mask;                                // published by the arrive below
          mbar_arrive_expect_tx(&full[s], loaded * box * 128 * CH * 2);
        }
        unsigned char* ks = kvs + s * L::STAGE;
        const int r_in = bs > PK ? k0 % bs : 0;           // first row inside the page
        for (int p = 0; p < pieces; ++p) {
          const int pb = page(i * pieces + p);
          if (lane != 0 || pb < 0) continue;
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            tma_load_4d(ks + c * L::CHUNK + p * box * 128, &kmap, &full[s], c * 64, kvh, r_in,
                        pb);
            tma_load_4d(ks + L::TILE + c * L::CHUNK + p * box * 128, &vmap, &full[s], c * 64,
                        kvh, r_in, pb);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows r and r + 8 of the tile,
  // row = token * G + head
  const int warp = threadIdx.x / 32;
  const int ra = warp * 16 + lane / 4;
  const int qd = 2 * (lane % 4);                          // first column of a pair in an 8-wide block
  const int qpos_lo = qoff + t0;
  int qpos[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) qpos[hr] = qpos_lo + (ra + 8 * hr) / G;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(&qfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % L::STAGES, k0 = (kt0 + i) * PK;
    unsigned char* ks = kvs + s * L::STAGE;
    unsigned char* vs = ks + L::TILE;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    const uint64_t km = kmask[s];
    if (km != ~0ull) {
      // the NaN fence: V rows of unreadable keys (past kv_len, or pages not
      // loaded, whose slots hold an older tile) become zeros before P V
      for (int e = threadIdx.x; e < PK * CH * 8; e += 128) {
        const int j = e / (CH * 8), c = (e / 8) % CH;
        if (!((km >> j) & 1ull))
          *reinterpret_cast<uint4*>(vs + c * L::CHUNK + j * 128 + (e % 8) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      named_barrier(1, 128);
    }
    // S = Q K^T: Q and K both K-major (head dims along the 128-byte rows)
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_m64n64k16_ss<0>(sc, desc_k_major(qs + (kk / 4) * L::CHUNK + (kk % 4) * 32),
                            desc_k_major(ks + (kk / 4) * L::CHUNK + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax in the log2 domain, as flash_attention.cu: a hidden
    // key's score becomes -inf (its weight exactly 0) on edge tiles only —
    // an unreadable key, or the causal diagonal
    const bool band = window > 0 && k0 <= qpos_top - window;
    const bool edge = km != ~0ull || (causal && k0 + PK - 1 > qpos_lo) || band;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = 8 * j + qd + e;
            if (!((km >> kj) & 1ull) || (causal && k0 + kj > qpos[hr]) ||
                (band && k0 + kj <= qpos[hr] - window))
              sc[4 * j + 2 * hr + e] = -INFINITY;
          }
      }
      float mx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx[j] = fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]);
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
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
      l_r[hr] = l_r[hr] * alpha + ps[0];                  // this thread's share of the row sum
      m_r[hr] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * hr] *= alpha;
        o[4 * j + 2 * hr + 1] *= alpha;
      }
    }
    // P (rounded to bf16) as the register A operand of O += P V, V the
    // MN-major B operand as stored
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      const uint64_t dv = desc_mn_major(vs + kk * 16 * 128, L::CHUNK);
      if constexpr (HD == 128)
        wgmma_m64n128k16_rs<1>(o, a, dv, 1);
      else
        wgmma_m64n64k16_rs<1>(o, a, dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);                // this warp is done with stage s
  }

  float l_row[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[hr] = l;
  }
  if (part == nullptr) {
    // one split: O / l rounded to bf16 into the (free) Q tile, in its
    // 128-byte-swizzled chunks, then one TMA store of the query tile's box
    // per chunk; tokens past Tq are not written
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float inv = 1.f / fmaxf(l_row[hr], 1e-20f);
      const int r = ra + 8 * hr;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(qs + (j / 8) * L::CHUNK + r * 128 +
                                     (((j % 8) ^ (r % 8)) << 4) + qd * 2) =
            pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
    }
    fence_proxy_async();
    named_barrier(1, 128);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) tma_store_4d(&omap, qs + c * L::CHUNK, c * 64, kvh * G, t0, b);
      bulk_commit();
      bulk_wait_read();
    }
    return;
  }

  // split: this block's float32 state (max, sum, unnormalised O) of its
  // rows, then a ticket; the query tile's last block merges the splits
  const int tile_id = blockIdx.z * gridDim.y + qt;
  const size_t n_ids = (size_t)gridDim.y * gridDim.z;
  float* po = part + ((size_t)tile_id * n_split + split) * 64 * HD;
  float* pml = part + n_ids * n_split * 64 * HD + ((size_t)tile_id * n_split + split) * 64 * 2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = ra + 8 * hr;
    if (r >= rows) continue;
    if (lane % 4 == 0) *reinterpret_cast<float2*>(pml + r * 2) = make_float2(m_r[hr], l_row[hr]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(po + r * HD + 8 * j + qd) =
          make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
  }
  __threadfence();
  named_barrier(1, 128);
  if (threadIdx.x == 0) ticket = atomicAdd(&tickets[tile_id], 1);
  named_barrier(1, 128);
  if (ticket != n_split - 1) return;
  __threadfence();
  const float* po0 = part + (size_t)tile_id * n_split * 64 * HD;
  const float* pml0 = part + n_ids * n_split * 64 * HD + (size_t)tile_id * n_split * 64 * 2;
  // each row's split weights 2^((m_s - max) c) and 1 / sum, once, into the
  // (free) Q tile; then every 8 columns of a row read the splits' O with the
  // loads of several splits in flight
  float* wts = reinterpret_cast<float*>(qs);              // [n_split + 1][64]
  if (threadIdx.x < rows) {
    float2 ml[MAX_SPLITS];                                // every split's (max, sum) at once
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < n_split)
        ml[sp] = __ldcg(reinterpret_cast<const float2*>(pml0 + (sp * 64 + threadIdx.x) * 2));
    float mx = NEG;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < n_split) mx = fmaxf(mx, ml[sp].x);
    float l = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < n_split) {
        const float wgt = fast_exp2((ml[sp].x - mx) * scale_log2);
        wts[sp * 64 + threadIdx.x] = wgt;
        l += ml[sp].y * wgt;
      }
    wts[n_split * 64 + threadIdx.x] = 1.f / fmaxf(l, 1e-20f);
  }
  named_barrier(1, 128);
  // the real head_dim's 8-column groups only: the tile's columns past hd
  // hold the zeros of the padded product and are never stored
  const int g8 = hd / 8;
  for (int e = threadIdx.x; e < rows * g8; e += 128) {
    const int r = e / g8, c8 = (e % g8) * 8;
    const int t = t0 + r / G, h = kvh * G + r % G;
    if (t >= Tq) continue;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp) {
      const float wgt = wts[sp * 64 + r];
      const float4* src = reinterpret_cast<const float4*>(po0 + ((size_t)sp * 64 + r) * HD + c8);
      const float4 a0 = __ldcg(src), a1 = __ldcg(src + 1);
      acc[0] += a0.x * wgt, acc[1] += a0.y * wgt, acc[2] += a0.z * wgt, acc[3] += a0.w * wgt;
      acc[4] += a1.x * wgt, acc[5] += a1.y * wgt, acc[6] += a1.z * wgt, acc[7] += a1.w * wgt;
    }
    const float inv = wts[n_split * 64 + r];
    uint4 v;
    v.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    v.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    v.z = pack_bf16(acc[4] * inv, acc[5] * inv);
    v.w = pack_bf16(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(out + (((size_t)b * Tq + t) * Hq + h) * hd + c8) = v;
  }
  if (threadIdx.x == 0) tickets[tile_id] = 0;             // ready for the next launch
}

// (hd, H, T, B) view of a (B, T, H, hd) bf16 tensor, boxes of 64 dims x G
// heads x nt tokens: the query tile's rows, token-major
int rows_map(CUtensorMap* map, const void* p, int B, int T_, int H, int hd, int G, int nt) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T_, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)T_ * H * hd * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)G, (cuuint32_t)nt, 1};
  return hopper::encode_bf16_sw128(map, p, 4, dims, strides, box);
}

// (hd, Hkv, bs, rows) view of a pool, boxes of 64 dims x 1 head x min(bs,
// 64) rows x 1 page.  The pools live as long as the cache that holds them,
// so their maps are kept, keyed by everything the encoding reads.
struct PoolMap {
  const void* base;
  int rows, bs, hkv, hd;
  CUtensorMap map;
};
constexpr int POOL_MAPS = 256;            // K and V of 128 layers
PoolMap pool_maps[POOL_MAPS];
int pool_maps_next = 0;

int pool_map(CUtensorMap* map, const void* base, int rows, int bs, int hkv, int hd) {
  for (int i = 0; i < POOL_MAPS; ++i) {
    const PoolMap& e = pool_maps[i];
    if (e.base == base && e.rows == rows && e.bs == bs && e.hkv == hkv && e.hd == hd) {
      *map = e.map;
      return 0;
    }
  }
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)hkv, (cuuint64_t)bs, (cuuint64_t)rows};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)hkv * hd * 2,
                                 (cuuint64_t)bs * hkv * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)(bs < PK ? bs : PK), 1};
  const int rc = hopper::encode_bf16_sw128(map, base, 4, dims, strides, box);
  if (rc != 0) return rc;
  pool_maps[pool_maps_next] = PoolMap{base, rows, bs, hkv, hd, *map};
  pool_maps_next = (pool_maps_next + 1) % POOL_MAPS;
  return 0;
}

template <int HD>
int launch_wgmma(const void* q, const void* kp, const void* vp, const int* table,
                 const int* q_offset, const int* kv_len, void* out, float* part, int* tickets,
                 int B, int Tq, int Hq, int Hkv, int hd, int bs, int mb, int n_rows,
                 int causal, int window, float scale, int nt, int n_split, int per,
                 cudaStream_t s) {
  using L = PagedSmem<HD>;
  const int G = Hq / Hkv;
  // the maps span the real head_dim: a box's columns past it load as zeros
  // and are clipped from the store
  CUtensorMap qm, om, km, vm;
  int rc = rows_map(&qm, q, B, Tq, Hq, hd, G, nt);
  if (rc == 0) rc = rows_map(&om, out, B, Tq, Hq, hd, G, nt);
  if (rc == 0) rc = pool_map(&km, kp, n_rows, bs, Hkv, hd);
  if (rc == 0) rc = pool_map(&vm, vp, n_rows, bs, Hkv, hd);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_split, (Tq + nt - 1) / nt, B * Hkv);
  paged_wgmma_kernel<HD><<<grid, P_THREADS, L::BYTES, s>>>(
      qm, km, vm, om, table, q_offset, kv_len, (bf16*)out, n_split > 1 ? part : nullptr,
      tickets, Tq, Hq, Hkv, hd, bs, mb, n_rows, causal, window, scale * 1.4426950408889634f,
      nt, per);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  All pointers are device
// pointers; int arrays are int32.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
// `vec`: row_bytes % 16 == 0 and the four base pointers 16-byte aligned
// (the wrapper checks); otherwise the byte route.  Launched as a
// programmatic dependent of the stream's previous kernel (see the note at
// the top): table, pos and chunk_len must not be written by that kernel.
extern "C" int paged_kv_scatter(const void* k_new, const void* v_new, void* k_pool,
                                void* v_pool, const int* table, const int* pos,
                                const int* chunk_len, int B, int T, int mb, int bs,
                                int n_rows, long long row_bytes, int vec, void* stream) {
  const long long rows = (long long)B * T;
  const dim3 grid((unsigned)((rows + SCATTER_ROWS - 1) / SCATTER_ROWS));
  const dim3 block(SCATTER_ROWS * 32);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto kn = (const unsigned char*)k_new, vn = (const unsigned char*)v_new;
  const auto kp = (unsigned char*)k_pool, vp = (unsigned char*)v_pool;
  const cudaError_t e =
      vec ? hopper::launch_dependent(paged_kv_scatter_kernel<true>, grid, block, 0, s, kn, vn,
                                     kp, vp, table, pos, chunk_len, B, T, mb, bs, n_rows,
                                     row_bytes)
          : hopper::launch_dependent(paged_kv_scatter_kernel<false>, grid, block, 0, s, kn, vn,
                                     kp, vp, table, pos, chunk_len, B, T, mb, bs, n_rows,
                                     row_bytes);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The wgmma path (the wrapper's plan says when): query tiles of `nt`
// tokens, the key tiles of a row (of its window band when window > 0)
// walked in `n_split` splits of `per` tiles, on the kernel built for the
// plan's tile width `tile_hd` (64 or 128; any other is refused) with the
// head_dim `hd` (a multiple of 8, at most tile_hd) padded to it.
// With n_split > 1, `part` is float32 scratch of (B * Hkv * ceil(Tq / nt)) *
// n_split * 64 * (tile_hd + 2) floats and `tickets` int32 counters, one per
// query tile, that are 0 at launch and 0 again after it.
extern "C" int paged_attention_wgmma_bf16(const void* q, const void* k_pool, const void* v_pool,
                                          const int* table, const int* q_offset,
                                          const int* kv_len, void* out, void* part,
                                          int* tickets, int B, int Tq, int Hq, int Hkv, int hd,
                                          int tile_hd, int bs, int mb, int n_rows, int causal,
                                          int window, float scale, int nt, int n_split, int per,
                                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split > MAX_SPLITS || (n_split > 1 && (part == nullptr || tickets == nullptr)) ||
      hd <= 0 || hd % 8 != 0 || hd > tile_hd)
    return (int)cudaErrorInvalidValue;
  if (tile_hd == 128)
    return launch_wgmma<128>(q, k_pool, v_pool, table, q_offset, kv_len, out, (float*)part,
                             tickets, B, Tq, Hq, Hkv, hd, bs, mb, n_rows, causal, window, scale,
                             nt, n_split, per, s);
  if (tile_hd == 64)
    return launch_wgmma<64>(q, k_pool, v_pool, table, q_offset, kv_len, out, (float*)part,
                            tickets, B, Tq, Hq, Hkv, hd, bs, mb, n_rows, causal, window, scale,
                            nt, n_split, per, s);
  return (int)cudaErrorInvalidValue;
}

// The CUDA-core path.  `n_split` > 1 and caller-allocated float32 scratch
// `part` of B * Hkv * n_split * 16 * (2 + hd) floats split a one-tile walk
// into ranges of `per` blocks (from the window band's first block when
// window > 0; the last range takes the rest).
extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const int* table, const int* q_offset,
                                    const int* kv_len, void* out, int B, int Tq, int Hq,
                                    int Hkv, int hd, int bs, int mb, int n_rows,
                                    int causal, int window, float scale, int n_split,
                                    int per, void* part, void* stream) {
  return launch_attention<bf16>(q, k_pool, v_pool, table, q_offset, kv_len, out, B, Tq,
                                Hq, Hkv, hd, bs, mb, n_rows, causal, window, scale, n_split,
                                per, (float*)part, stream);
}

extern "C" int paged_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                   const int* table, const int* q_offset,
                                   const int* kv_len, void* out, int B, int Tq, int Hq,
                                   int Hkv, int hd, int bs, int mb, int n_rows,
                                   int causal, int window, float scale, int n_split,
                                   int per, void* part, void* stream) {
  return launch_attention<float>(q, k_pool, v_pool, table, q_offset, kv_len, out, B, Tq,
                                 Hq, Hkv, hd, bs, mb, n_rows, causal, window, scale, n_split,
                                 per, (float*)part, stream);
}
