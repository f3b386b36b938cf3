// Paged KV scatter and paged attention for Hopper (sm_90a).
//
// paged_kv_scatter replaces the TPU kernel
// repro/kernels/paged_attention.py: paged_kv_scatter_pallas (_scatter_call,
// body _scatter_kernel).  It writes chunk rows [pos, pos + chunk_len) of
// k_new/v_new (B, T, Hkv, hd) into the pools (rows, block_size, Hkv, hd)
// through the block table, in place.  A row is dropped when t >= chunk_len,
// when its logical block is past the table width, or when the table entry
// is -1.  Bound on the H100: bytes only (one read and one write of every
// kept row); one block per (b, t) row copies it with 16-byte accesses.  The
// copy is bit-exact for any element type.  The TPU kernel parks its
// invisible grid steps on a sentinel pool row; this kernel simply returns
// for a dropped row, so it never touches that row.
//
// paged_attention replaces repro/kernels/paged_attention.py:
// paged_attention_pallas (body _kernel, visibility _block_visible, softmax
// helpers flash_attention.py softmax_update / softmax_finalize).  Attention
// of q (B, Tq, Hq, hd) over the paged pools: the block walks the row's
// block table, skips -1 entries, stops at the first block past kv_len (or,
// causal, past the last query position of the tile), masks scores by
// absolute position with -1e30, zeroes V rows past kv_len (the NaN fence:
// unwritten pool rows must never reach the P.V product), maps query head h
// to KV head h / (Hq / Hkv), and runs the float32 online softmax whose
// fully-masked rows come out as zeros (l clamped at 1e-20).  Bound on the
// H100: bytes (every visible K/V row read once) for decode, operations for
// long prefill chunks.  Two paths:
//  * bf16 prefill chunks (Tq >= 16, head_dim 64 or 128): a flash kernel on
//    the tensor cores.  One block per (64-query tile, query head, batch
//    row); each 64-key tile of the row's logical KV is gathered through the
//    block table into shared memory with cp.async, S = Q K^T and O += P V
//    run as WMMA bf16 products with float32 accumulation (P rounded to
//    bf16), and the float32 online softmax runs two lanes per query row.
//  * everything else (decode's Tq = 1, float32): one block per (query-row
//    tile, KV head, batch row); the tile flattens (query position, head in
//    the GQA group), so the G = Hq / Hkv heads that share a KV head read each
//    staged K/V sub-tile once; one warp per row, each lane holding hd / 32
//    of the query, the accumulator and the value dims.  When all of a row's
//    queries fit one tile (decode), the walk over the block table is split
//    across `n_split` blocks that write partial (max, sum, acc) states, and
//    a combine kernel merges them — decode has only B * Hkv tiles, too few
//    to fill the card otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ scatter

__global__ void paged_kv_scatter_kernel(
    const unsigned char* __restrict__ kn, const unsigned char* __restrict__ vn,
    unsigned char* __restrict__ kp, unsigned char* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ pos,
    const int* __restrict__ chunk_len, int T, int mb, int bs, int n_rows,
    long long row_bytes) {
  const int t = blockIdx.x, b = blockIdx.y;
  if (t >= chunk_len[b]) return;
  const int wpos = pos[b] + t;
  if (wpos < 0) return;
  const int lb = wpos / bs;
  if (lb >= mb) return;
  const int pb = table[(size_t)b * mb + lb];
  if (pb < 0 || pb >= n_rows) return;
  const size_t src = ((size_t)b * T + t) * row_bytes;
  const size_t dst = ((size_t)pb * bs + wpos % bs) * row_bytes;
  const bool vec = (row_bytes % 16 == 0) &&
                   (((reinterpret_cast<uintptr_t>(kn + src) |
                      reinterpret_cast<uintptr_t>(vn + src) |
                      reinterpret_cast<uintptr_t>(kp + dst) |
                      reinterpret_cast<uintptr_t>(vp + dst)) & 15) == 0);
  if (vec) {
    const uint4* ks = reinterpret_cast<const uint4*>(kn + src);
    const uint4* vs = reinterpret_cast<const uint4*>(vn + src);
    uint4* kd = reinterpret_cast<uint4*>(kp + dst);
    uint4* vd = reinterpret_cast<uint4*>(vp + dst);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += blockDim.x) {
      kd[i] = ks[i];
      vd[i] = vs[i];
    }
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) {
      kp[dst + i] = kn[src + i];
      vp[dst + i] = vn[src + i];
    }
  }
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

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
                       int mb, int n_rows, int causal, float scale, int ki_per_split,
                       float* __restrict__ part) {
  __shared__ float ks[KT * MAX_HD];
  __shared__ float vs[KT * MAX_HD];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qoff = q_offset[b], kvl = kv_len[b];
  // split mode: blockIdx.x picks a range of logical blocks, not a row tile
  const bool split = part != nullptr;
  const int tile0 = split ? 0 : blockIdx.x * ROWS;
  const int ki_lo = split ? blockIdx.x * ki_per_split : 0;
  const int ki_hi = split ? min(mb, ki_lo + ki_per_split) : mb;
  const int t_hi = min(Tq - 1, (tile0 + ROWS - 1) / G);
  const int q_hi = qoff + t_hi;                 // last query position of the tile

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
            const bool ok = kpos < kvl && (!causal || kpos <= qpos[rr]);
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
                     float scale, int n_split, float* part, void* stream) {
  const int G = Hq / Hkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split > 1 && part != nullptr && Tq * G <= ROWS) {
    const int per = (mb + n_split - 1) / n_split;
    paged_attention_kernel<T><<<dim3(n_split, Hkv, B), WARPS * 32, 0, s>>>(
        (const T*)q, (const T*)kp, (const T*)vp, table, q_offset, kv_len, (T*)out,
        Tq, Hq, Hkv, hd, bs, mb, n_rows, causal, scale, per, part);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    paged_attention_combine_kernel<T><<<dim3(Hkv, B), WARPS * 32, 0, s>>>(
        part, (T*)out, n_split, Tq, Hq, Hkv, hd);
    return (int)cudaGetLastError();
  }
  dim3 grid((Tq * G + ROWS - 1) / ROWS, Hkv, B);
  paged_attention_kernel<T><<<grid, WARPS * 32, 0, s>>>(
      (const T*)q, (const T*)kp, (const T*)vp, table, q_offset, kv_len, (T*)out,
      Tq, Hq, Hkv, hd, bs, mb, n_rows, causal, scale, mb, nullptr);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 flash path
constexpr int FQ = 64;            // query rows per block (4 warps x 16)
constexpr int FK = 64;            // keys per gathered tile
constexpr int FWARPS = 4;

template <int HD>
struct FlashSmem {
  static constexpr int LD = HD + 8;                          // bf16 row stride
  static constexpr int SLD = (HD > FK ? HD : FK) + 4;        // f32 scratch stride
  static constexpr int PLD = FK + 8;                         // bf16 P stride
  static constexpr size_t Q = (size_t)FQ * LD * 2;
  static constexpr size_t KV = (size_t)FK * LD * 2;
  static constexpr size_t SCR = (size_t)FWARPS * 16 * SLD * 4;
  static constexpr size_t P = (size_t)FWARPS * 16 * PLD * 2;
  static constexpr size_t BYTES = Q + 2 * KV + SCR + P + FK * 4;
};

template <int HD>
__global__ void __launch_bounds__(FWARPS * 32)
paged_flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                        const bf16* __restrict__ vp, const int* __restrict__ table,
                        const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                        bf16* __restrict__ out, int Tq, int Hq, int Hkv, int bs, int mb,
                        int n_rows, int causal, float scale) {
  using namespace nvcuda;
  using L = FlashSmem<HD>;
  extern __shared__ __align__(128) unsigned char fsmem[];
  bf16* qs = reinterpret_cast<bf16*>(fsmem);
  bf16* ks = reinterpret_cast<bf16*>(fsmem + L::Q);
  bf16* vs = reinterpret_cast<bf16*>(fsmem + L::Q + L::KV);
  float* scr = reinterpret_cast<float*>(fsmem + L::Q + 2 * L::KV);
  bf16* ps = reinterpret_cast<bf16*>(fsmem + L::Q + 2 * L::KV + L::SCR);
  int* kvalid = reinterpret_cast<int*>(fsmem + L::Q + 2 * L::KV + L::SCR + L::P);

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (Hq / Hkv);
  const int t0 = blockIdx.x * FQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qoff = q_offset[b], kvl = kv_len[b];
  const int q_hi = qoff + min(Tq - 1, t0 + FQ - 1);   // last query position of the tile
  constexpr int VPR = HD / 8;                         // 16-byte vectors per row

  for (int i = threadIdx.x; i < FQ * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < Tq)
      v = *reinterpret_cast<const uint4*>(q + (((size_t)b * Tq + t0 + r) * Hq + h) * HD + c);
    *reinterpret_cast<uint4*>(qs + r * L::LD + c) = v;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], qs + warp * 16 * L::LD + kk * 16, L::LD);

  // two lanes per query row: lane 2r and 2r+1 split the tile's keys and
  // the row's output dims in halves
  const int r = lane >> 1, half = lane & 1;
  const int qpos = qoff + t0 + warp * 16 + r;
  float* sw = scr + warp * 16 * L::SLD;
  bf16* pw = ps + warp * 16 * L::PLD;
  float m_r = NEG, l_r = 0.f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int k0 = 0; k0 < kvl && !(causal && k0 > q_hi); k0 += FK) {
    __syncthreads();                              // previous tile consumed
    for (int i = threadIdx.x; i < FK * VPR; i += blockDim.x) {
      const int j = i / VPR, c = (i % VPR) * 8, p = k0 + j;
      int pb = -1;
      if (p < kvl && p / bs < mb) {
        pb = table[(size_t)b * mb + p / bs];
        if (pb >= n_rows) pb = -1;
      }
      if (c == 0) kvalid[j] = pb >= 0;
      bf16* kd = ks + j * L::LD + c;
      bf16* vd = vs + j * L::LD + c;
      if (pb >= 0) {
        const size_t off = (((size_t)pb * bs + p % bs) * Hkv + kvh) * HD + c;
        cp_async16(kd, kp + off);
        cp_async16(vd, vp + off);
      } else {                                    // unallocated or past kv_len:
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);   // zero V is
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);   // the NaN fence
      }
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int kb = 0; kb < FK / 16; ++kb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kfr;
        wmma::load_matrix_sync(kfr, ks + kb * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(sf, qa[kk], kfr, sf);
      }
      wmma::store_matrix_sync(sw + kb * 16, sf, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();

    float sv[FK / 2];
    float mx = NEG;
#pragma unroll
    for (int jj = 0; jj < FK / 2; ++jj) {
      const int j = half * (FK / 2) + jj;
      const bool ok = kvalid[j] && (!causal || k0 + j <= qpos);
      sv[jj] = ok ? sw[r * L::SLD + j] * scale : NEG;
      mx = fmaxf(mx, sv[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_r, mx);
    const float alpha = expf(m_r - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < FK / 2; ++jj) {
      const float pv = sv[jj] > NEG / 2 ? expf(sv[jj] - m_new) : 0.f;
      psum += pv;
      pw[r * L::PLD + half * (FK / 2) + jj] = __float2bfloat16(pv);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_r = l_r * alpha + psum;
    m_r = m_new;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha;
    __syncwarp();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[FK / 16];
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk)
      wmma::load_matrix_sync(pa[kk], pw + kk * 16, L::PLD);
#pragma unroll
    for (int db = 0; db < HD / 16; ++db) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vfr;
        wmma::load_matrix_sync(vfr, vs + kk * 16 * L::LD + db * 16, L::LD);
        wmma::mma_sync(of, pa[kk], vfr, of);
      }
      wmma::store_matrix_sync(sw + db * 16, of, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] += sw[r * L::SLD + half * (HD / 2) + i];
    __syncwarp();                                 // scratch free for the next S
  }

  if (t0 + warp * 16 + r < Tq) {
    const float inv = 1.f / fmaxf(l_r, 1e-20f);
    bf16* dst = out + (((size_t)b * Tq + t0 + warp * 16 + r) * Hq + h) * HD + half * (HD / 2);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dst[i] = __float2bfloat16(o[i] * inv);
  }
}

template <int HD>
int launch_flash(const void* q, const void* kp, const void* vp, const int* table,
                 const int* q_offset, const int* kv_len, void* out, int B, int Tq, int Hq,
                 int Hkv, int bs, int mb, int n_rows, int causal, float scale, void* stream) {
  using L = FlashSmem<HD>;
  cudaError_t e = cudaFuncSetAttribute(paged_flash_bf16_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Tq + FQ - 1) / FQ, Hq, B);
  paged_flash_bf16_kernel<HD><<<grid, FWARPS * 32, L::BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)kp, (const bf16*)vp, table, q_offset, kv_len, (bf16*)out,
      Tq, Hq, Hkv, bs, mb, n_rows, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  All pointers are device
// pointers; int arrays are int32.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).  The attention
// entries take `n_split` > 1 and caller-allocated float32 scratch `part` of
// B * Hkv * n_split * 16 * (2 + hd) floats to split a one-tile walk.
extern "C" int paged_kv_scatter(const void* k_new, const void* v_new, void* k_pool,
                                void* v_pool, const int* table, const int* pos,
                                const int* chunk_len, int B, int T, int mb, int bs,
                                int n_rows, long long row_bytes, void* stream) {
  dim3 grid(T, B);
  paged_kv_scatter_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)k_new, (const unsigned char*)v_new,
      (unsigned char*)k_pool, (unsigned char*)v_pool, table, pos, chunk_len, T, mb,
      bs, n_rows, row_bytes);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const int* table, const int* q_offset,
                                    const int* kv_len, void* out, int B, int Tq, int Hq,
                                    int Hkv, int hd, int bs, int mb, int n_rows,
                                    int causal, float scale, int n_split, void* part,
                                    void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
                         reinterpret_cast<uintptr_t>(v_pool)) & 15) == 0;
  if (Tq >= 16 && aligned && hd == 128)
    return launch_flash<128>(q, k_pool, v_pool, table, q_offset, kv_len, out, B, Tq, Hq,
                             Hkv, bs, mb, n_rows, causal, scale, stream);
  if (Tq >= 16 && aligned && hd == 64)
    return launch_flash<64>(q, k_pool, v_pool, table, q_offset, kv_len, out, B, Tq, Hq,
                            Hkv, bs, mb, n_rows, causal, scale, stream);
  return launch_attention<bf16>(q, k_pool, v_pool, table, q_offset, kv_len, out, B, Tq,
                                Hq, Hkv, hd, bs, mb, n_rows, causal, scale, n_split,
                                (float*)part, stream);
}

extern "C" int paged_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                   const int* table, const int* q_offset,
                                   const int* kv_len, void* out, int B, int Tq, int Hq,
                                   int Hkv, int hd, int bs, int mb, int n_rows,
                                   int causal, float scale, int n_split, void* part,
                                   void* stream) {
  return launch_attention<float>(q, k_pool, v_pool, table, q_offset, kv_len, out, B, Tq,
                                 Hq, Hkv, hd, bs, mb, n_rows, causal, scale, n_split,
                                 (float*)part, stream);
}
