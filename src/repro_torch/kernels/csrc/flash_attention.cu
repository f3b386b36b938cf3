// Self-attention over contiguous K/V (causal or not, optional sliding-window
// band) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel, softmax helpers softmax_init /
// softmax_update / softmax_finalize).  q (B, T, Hq, hd) attends to k/v
// (B, T, Hkv, hd) of the same length T — the port's layout, read in place,
// no head-repeated KV: query head h reads KV head h / (Hq / Hkv).  Key p is
// visible to query t when p < T, (causal) p <= t, and (window > 0)
// p > t - window.  Masked scores are -1e30 and their weights exactly 0 (the
// s > -1e30/2 guard); the float32 online softmax divides by max(l, 1e-20),
// so a row that sees no key gives 0.  Key blocks wholly outside a query
// tile's band are skipped, as the TPU kernel's block visibility check does.
//
// What bounds it on the H100: at the one-shot prefill's shape (B = 4,
// Hq = 28, Hkv = 4, T = 512, hd = 128, causal) the kernel moves ~34 MB and
// does ~7.5 GFLOP of visible products: a few microseconds each at the
// card's rates, so a first design is bound by how well it keeps the tensor
// cores fed inside a block.  Two paths:
//  * bf16, head_dim 64 or 128: a flash kernel on the tensor cores.  One
//    block per (64-query tile, query head, batch row); each 64-key tile of
//    K and V streams into shared memory with 16-byte cp.async copies (rows
//    past T zero-filled), S = Q K^T and O += P V run as WMMA bf16 products
//    with float32 accumulation (P rounded to bf16), and the float32 online
//    softmax runs two lanes per query row.
//  * everything else (float32, other head sizes): one block per (16-row
//    tile, KV head, batch row) on the CUDA cores; the tile flattens (query
//    position, head in the GQA group), so the G = Hq / Hkv heads that share
//    a KV head read each staged 16-key sub-tile once; one warp per row, each
//    lane holding hd / 32 of the query, the accumulator and the value dims.
//    Products are float32 FMAs (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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

// First key a query tile [q_lo, ...] can see: keys at or below
// q_lo - window are outside every row's band.
__device__ __forceinline__ int band_start(int q_lo, int window, int align) {
  if (window <= 0) return 0;
  const int lo = max(0, q_lo - window + 1);
  return lo - lo % align;
}

__device__ __forceinline__ bool visible(int kp, int qp, int T_, int causal, int window) {
  return kp < T_ && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
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
                      const T* __restrict__ v, T* __restrict__ out, int T_, int Hq, int Hkv,
                      int hd, int causal, int window, float scale) {
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

  const int k_end = causal ? t_hi + 1 : T_;
  const size_t row_stride = (size_t)Hkv * hd;   // elements between key rows
  for (int kbase = band_start(t_lo, window, KT); kbase < k_end; kbase += KT) {
    const int nk = min(KT, k_end - kbase);
    __syncthreads();                            // previous sub-tile consumed
    const size_t base = ((size_t)b * T_ + kbase) * row_stride + (size_t)kvh * hd;
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
          s[j] = visible(kbase + j, qpos[rr], T_, causal, window) ? sc : NEG;
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
int launch_rows(const void* q, const void* k, const void* v, void* out, int B, int T_, int Hq,
                int Hkv, int hd, int causal, int window, float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
  dim3 grid((T_ * G + ROWS - 1) / ROWS, Hkv, B);
  attention_rows_kernel<T><<<grid, WARPS * 32, 0, s>>>((const T*)q, (const T*)k, (const T*)v,
                                                       (T*)out, T_, Hq, Hkv, hd, causal,
                                                       window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 flash path
constexpr int FQ = 64;            // query rows per block (4 warps x 16)
constexpr int FK = 64;            // keys per staged tile
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
  static constexpr size_t BYTES = Q + 2 * KV + SCR + P;
};

template <int HD>
__global__ void __launch_bounds__(FWARPS * 32)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int T_, int Hq, int Hkv,
                  int causal, int window, float scale) {
  using namespace nvcuda;
  using L = FlashSmem<HD>;
  extern __shared__ __align__(128) unsigned char fsmem[];
  bf16* qs = reinterpret_cast<bf16*>(fsmem);
  bf16* ks = reinterpret_cast<bf16*>(fsmem + L::Q);
  bf16* vs = reinterpret_cast<bf16*>(fsmem + L::Q + L::KV);
  float* scr = reinterpret_cast<float*>(fsmem + L::Q + 2 * L::KV);
  bf16* ps = reinterpret_cast<bf16*>(fsmem + L::Q + 2 * L::KV + L::SCR);

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (Hq / Hkv);
  const int t0 = blockIdx.x * FQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_hi = min(T_ - 1, t0 + FQ - 1);          // last query of the tile
  constexpr int VPR = HD / 8;                         // 16-byte vectors per row
  const size_t kv_row = (size_t)Hkv * HD;             // elements between key rows

  for (int i = threadIdx.x; i < FQ * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T_)
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * T_ + t0 + r) * Hq + h) * HD + c);
    *reinterpret_cast<uint4*>(qs + r * L::LD + c) = val;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], qs + warp * 16 * L::LD + kk * 16, L::LD);

  // two lanes per query row: lanes 2r and 2r+1 split the tile's keys and the
  // row's output dims in halves
  const int r = lane >> 1, half = lane & 1;
  const int qpos = t0 + warp * 16 + r;
  float* sw = scr + warp * 16 * L::SLD;
  bf16* pw = ps + warp * 16 * L::PLD;
  float m_r = NEG, l_r = 0.f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  const int k_end = causal ? q_hi + 1 : T_;
  for (int k0 = band_start(t0, window, FK); k0 < k_end; k0 += FK) {
    __syncthreads();                              // previous tile consumed
    for (int i = threadIdx.x; i < FK * VPR; i += blockDim.x) {
      const int j = i / VPR, c = (i % VPR) * 8, p = k0 + j;
      bf16* kd = ks + j * L::LD + c;
      bf16* vd = vs + j * L::LD + c;
      if (p < T_) {
        const size_t off = ((size_t)b * T_ + p) * kv_row + (size_t)kvh * HD + c;
        cp_async16(kd, k + off);
        cp_async16(vd, v + off);
      } else {                                    // past T: zero K and V
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
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
      sv[jj] = visible(k0 + j, qpos, T_, causal, window) ? sw[r * L::SLD + j] * scale : NEG;
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

  if (qpos < T_) {
    const float inv = 1.f / fmaxf(l_r, 1e-20f);
    bf16* dst = out + (((size_t)b * T_ + qpos) * Hq + h) * HD + half * (HD / 2);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dst[i] = __float2bfloat16(o[i] * inv);
  }
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, void* out, int B, int T_, int Hq,
                 int Hkv, int causal, int window, float scale, cudaStream_t s) {
  using L = FlashSmem<HD>;
  cudaError_t e = cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_ + FQ - 1) / FQ, Hq, B);
  flash_bf16_kernel<HD><<<grid, FWARPS * 32, L::BYTES, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, T_, Hq, Hkv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  All pointers are device pointers
// to contiguous tensors; q/out (B, T, Hq, hd), k/v (B, T, Hkv, hd); Hq is a
// multiple of Hkv and hd <= 256 (the wrapper checks).  `window` <= 0 means
// no band.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int T, int Hq, int Hkv, int hd, int causal,
                                    int window, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (aligned && hd == 128)
    return launch_flash<128>(q, k, v, out, B, T, Hq, Hkv, causal, window, scale, s);
  if (aligned && hd == 64)
    return launch_flash<64>(q, k, v, out, B, T, Hq, Hkv, causal, window, scale, s);
  return launch_rows<bf16>(q, k, v, out, B, T, Hq, Hkv, hd, causal, window, scale, s);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int T, int Hq, int Hkv, int hd, int causal,
                                   int window, float scale, void* stream) {
  return launch_rows<float>(q, k, v, out, B, T, Hq, Hkv, hd, causal, window, scale,
                            (cudaStream_t)stream);
}
