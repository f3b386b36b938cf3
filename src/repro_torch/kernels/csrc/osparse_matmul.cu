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
//
// What bounds it on the H100: at the serving path's prefill chunk (T = 256
// tokens) the int8 product does 2*T*D*N operations on D*N weight bytes,
// ~512 operations per weight byte, under the card's ~590 int8 operations
// per byte of bandwidth, so the weight read from device memory is the bound
// (LLaMA-3.1-8B gate: 58.7 MB per launch); in decode (T = 4) it is the
// weight read alone.  The design, split as nm_prune_matmul.cu is (the
// selection fused into every column block of the GEMM cost more than the
// weight read there):
//
//  1. osparse_quant_kernel: one block per token row.  Each thread takes
//     whole N:M groups (16-channel chunks when not pruning), smooths,
//     selects and, per token, reduces the row's absmax over the block, then
//     quantizes in a second sweep.  It writes int8 xq (a quarter of bf16
//     x's bytes) and one float32 scale per row.
//  2. w8a8_gemm_kernel: one block per 64x128 output tile walks k in 64-deep
//     tiles, double-buffered with cp.async, on the tensor cores (WMMA
//     signed char 16x16x16, int32 accumulators; wq stays (D, N) with N
//     contiguous and is read as a row-major B operand).  Shared tiles are
//     stored as 16-byte-wide slices so every WMMA fragment starts 32-byte
//     aligned, padded 64 bytes per slice so the cp.async writes of a warp
//     spread over all banks.  When the tiles cannot fill the card (decode,
//     narrow projections) the k loop is split over blockIdx.z and the
//     int32 partial sums meet in device memory with atomicAdd; integer sums
//     commute, so the result stays bit-identical, and a small kernel
//     applies the dequant epilogue.
//
// The accumulator is an exact integer, and the epilogue multiplies in the
// JAX package's order with __fmul_rn (no FMA contraction with the bias
// add), so the output is bit-identical to the plain version.
// Not yet: wgmma, TMA, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// ------------------------------------------------------------ quantize pass
constexpr int QTHREADS = 256;
constexpr int PLAIN_CHUNK = 16;   // channels per thread-chunk when not pruning

// Chunk c of row xr, smoothed and (when pruning) N:M-masked, into v[0, len).
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
  for (int round = 0; round < n; ++round) {   // strict '>' keeps the lowest index on ties
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

template <typename T>
__global__ void __launch_bounds__(QTHREADS)
osparse_quant_kernel(const T* __restrict__ x, const float* __restrict__ smooth,
                     const float* __restrict__ amber, const float* __restrict__ act_scale,
                     int8_t* __restrict__ xq, float* __restrict__ row_scale, int D, int n,
                     int m, int prune, int per_token) {
  __shared__ float warp_max[QTHREADS / 32];
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
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
    __syncthreads();
    amax = warp_max[0];
    for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
    scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
    if (threadIdx.x == 0) row_scale[row] = scale;
  } else {
    scale = *act_scale;
  }
  int8_t* qr = xq + (size_t)row * D;
  for (int c = threadIdx.x; c < chunks; c += QTHREADS) {
    const int len = pruned_chunk(xr, smooth, amber, c, D, n, m, prune, v);
    for (int j = 0; j < len; ++j) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.f), 127.f);
      qr[c * width + j] = (int8_t)(int)q;
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

// Stage 16 int8 values of row r, columns [c, c+16) of a row-major (rows,
// cols) matrix: cp.async when the whole vector is inside and aligned, else
// byte by byte with zero fill.
__device__ __forceinline__ void stage16(int8_t* dst, const int8_t* __restrict__ src, int r,
                                        int c, int rows, int cols, bool vec_ok) {
  if (r < rows && vec_ok && c + 16 <= cols) {
    cp_async16(dst, src + (size_t)r * cols + c);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[e] = (r < rows && c + e < cols) ? src[(size_t)r * cols + c + e] : (int8_t)0;
  }
}

// ----------------------------------------------------------------- int8 GEMM
constexpr int BM = 64, BN = 128, BK = 64, THREADS = 256;  // 8 warps, 2 x 4 of 32x32
constexpr int SLICE = 16;                  // bytes: one WMMA fragment row
constexpr int A_SLICE = BM * SLICE + 64;   // one 16-wide k slice of the x tile
constexpr int B_SLICE = BK * SLICE + 64;   // one 16-wide n slice of the w tile
constexpr int STAGE = (BK / SLICE) * A_SLICE + (BN / SLICE) * B_SLICE;
constexpr int SMEM = 2 * STAGE;
constexpr int LDE = 16 + 4;                // int per-warp epilogue fragment
static_assert(8 * 16 * LDE * 4 <= SMEM, "epilogue scratch must fit in the stages");

__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn((float)acc, xs), ws);
}

// out = float(xq @ wq) * xs[row * xs_stride] * ws[col] (+ bias[col]), or,
// when `partial` is set, atomicAdd of the int32 sums over this block's k
// range (blockIdx.z of gridDim.z splits) into partial (T, N).
__global__ void __launch_bounds__(THREADS)
w8a8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ xs, int xs_stride, const float* __restrict__ ws,
                 const float* __restrict__ bias, int* __restrict__ partial,
                 float* __restrict__ out, int T_, int D, int N) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM];

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;
  const bool xvec = (D % 16 == 0) && ((reinterpret_cast<uintptr_t>(xq) & 15) == 0);
  const bool wvec = (N % 16 == 0) && ((reinterpret_cast<uintptr_t>(wq) & 15) == 0);

  const int k_tiles = (D + BK - 1) / BK;
  const int per_split = (k_tiles + gridDim.z - 1) / gridDim.z;
  const int kt0 = blockIdx.z * per_split;
  const int kt1 = min(k_tiles, kt0 + per_split);
  if (kt0 >= kt1) return;                   // whole block: no barrier skipped

  auto load_stage = [&](int buf, int k0) {
    int8_t* as = reinterpret_cast<int8_t*>(smem) + buf * STAGE;
    int8_t* bs = as + (BK / SLICE) * A_SLICE;
    for (int i = threadIdx.x; i < BM * BK / 16; i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      stage16(as + (c / SLICE) * A_SLICE + r * SLICE, xq, row0 + r, k0 + c, T_, D, xvec);
    }
    for (int i = threadIdx.x; i < BK * BN / 16; i += THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      stage16(bs + (c / SLICE) * B_SLICE + r * SLICE, wq, k0 + r, col0 + c, D, N, wvec);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  load_stage(0, kt0 * BK);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_stage(buf ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = reinterpret_cast<const int8_t*>(smem) + buf * STAGE;
    const int8_t* bs = as + (BK / SLICE) * A_SLICE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (kk / SLICE) * A_SLICE + (wr + 16 * i) * SLICE,
                               SLICE);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + ((wc + 16 * j) / SLICE) * B_SLICE + kk * SLICE,
                               SLICE);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();                            // stage free for the next load
  }

  // epilogue: each warp passes its fragments one at a time through a 16x16
  // int scratch (reusing the stages)
  int* es = reinterpret_cast<int*>(smem) + warp * 16 * LDE;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(es, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + wr + 16 * i + e / 16, gc = col0 + wc + 16 * j + e % 16;
        if (gr < T_ && gc < N) {
          const int a = es[(e / 16) * LDE + e % 16];
          if (partial != nullptr) {
            atomicAdd(partial + (size_t)gr * N + gc, a);
          } else {
            float v = dequant(a, xs[(size_t)gr * xs_stride], ws[gc]);
            if (bias != nullptr) v = __fadd_rn(v, bias[gc]);
            out[(size_t)gr * N + gc] = v;
          }
        }
      }
      __syncwarp();
    }
}

__global__ void dequant_kernel(const int* __restrict__ partial, const float* __restrict__ xs,
                               int xs_stride, const float* __restrict__ ws,
                               const float* __restrict__ bias, float* __restrict__ out,
                               int T_, int N) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)T_ * N) return;
  const int r = (int)(idx / N), c = (int)(idx % N);
  float v = dequant(partial[idx], xs[(size_t)r * xs_stride], ws[c]);
  if (bias != nullptr) v = __fadd_rn(v, bias[c]);
  out[idx] = v;
}

int launch_gemm(const int8_t* xq, const int8_t* wq, const float* xs, int xs_stride,
                const float* ws, const float* bias, int* partial, float* out, int T_, int D,
                int N, int splits, cudaStream_t stream) {
  dim3 grid((T_ + BM - 1) / BM, (N + BN - 1) / BN, splits);
  if (splits > 1) {
    int rc = (int)cudaMemsetAsync(partial, 0, (size_t)T_ * N * sizeof(int), stream);
    if (rc != 0) return rc;
  }
  w8a8_gemm_kernel<<<grid, THREADS, 0, stream>>>(xq, wq, xs, xs_stride, ws, bias,
                                                 splits > 1 ? partial : nullptr, out, T_, D,
                                                 N);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || splits <= 1) return rc;
  const long long work = (long long)T_ * N;
  dequant_kernel<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(partial, xs, xs_stride,
                                                                      ws, bias, out, T_, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_osparse(const void* x, const void* wq, const float* smooth, const float* amber,
                   const float* w_scale, const float* act_scale, const float* bias,
                   void* xq, float* row_scale, int* partial, float* out, int T_, int D,
                   int N, int n, int m, int prune, int per_token, int splits,
                   cudaStream_t stream) {
  osparse_quant_kernel<T><<<T_, QTHREADS, 0, stream>>>(
      (const T*)x, smooth, amber, act_scale, (int8_t*)xq, row_scale, D, n, m, prune,
      per_token);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const float* xs = per_token ? row_scale : act_scale;
  return launch_gemm((const int8_t*)xq, (const int8_t*)wq, xs, per_token ? 1 : 0, w_scale,
                     bias, partial, out, T_, D, N, splits, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers;
// amber and bias (float32) may be null; act_scale is a device pointer to
// the 0-d float32 static scale (null when per_token).  xq (T, D) int8 and
// row_scale (T,) float32 are caller-allocated scratch; partial (T, N) int32
// is scratch needed only when splits > 1.  out is (T, N) float32.  Launches
// on `stream`, does not synchronise, and returns the first CUDA error.
extern "C" int osparse_matmul_bf16(const void* x, const void* wq, const float* smooth,
                                   const float* amber, const float* w_scale,
                                   const float* act_scale, const float* bias, void* xq,
                                   float* row_scale, int* partial, float* out, int T, int D,
                                   int N, int n, int m, int prune, int per_token, int splits,
                                   void* stream) {
  return launch_osparse<bf16>(x, wq, smooth, amber, w_scale, act_scale, bias, xq, row_scale,
                              partial, out, T, D, N, n, m, prune, per_token, splits,
                              (cudaStream_t)stream);
}

extern "C" int osparse_matmul_f32(const void* x, const void* wq, const float* smooth,
                                  const float* amber, const float* w_scale,
                                  const float* act_scale, const float* bias, void* xq,
                                  float* row_scale, int* partial, float* out, int T, int D,
                                  int N, int n, int m, int prune, int per_token, int splits,
                                  void* stream) {
  return launch_osparse<float>(x, wq, smooth, amber, w_scale, act_scale, bias, xq,
                               row_scale, partial, out, T, D, N, n, m, prune, per_token,
                               splits, (cudaStream_t)stream);
}

// The quantize pass alone: xq (T, D) int8 and, per token, row_scale (T,),
// so the int8 codes can be held against the plain version's.
extern "C" int osparse_quantize_bf16(const void* x, const float* smooth, const float* amber,
                                     const float* act_scale, void* xq, float* row_scale,
                                     int T, int D, int n, int m, int prune, int per_token,
                                     void* stream) {
  osparse_quant_kernel<bf16><<<T, QTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, smooth, amber, act_scale, (int8_t*)xq, row_scale, D, n, m, prune,
      per_token);
  return (int)cudaGetLastError();
}

extern "C" int osparse_quantize_f32(const void* x, const float* smooth, const float* amber,
                                    const float* act_scale, void* xq, float* row_scale,
                                    int T, int D, int n, int m, int prune, int per_token,
                                    void* stream) {
  osparse_quant_kernel<float><<<T, QTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, smooth, amber, act_scale, (int8_t*)xq, row_scale, D, n, m, prune,
      per_token);
  return (int)cudaGetLastError();
}

// xq (T, D) int8 @ wq (D, N) int8 → float32 * x_scale[0] * w_scale[col]:
// the GEMM half alone, with the scalar x_scale read on the device.
extern "C" int w8a8_matmul(const void* xq, const void* wq, const float* x_scale,
                           const float* w_scale, int* partial, float* out, int T, int D, int N,
                           int splits, void* stream) {
  return launch_gemm((const int8_t*)xq, (const int8_t*)wq, x_scale, 0, w_scale, nullptr,
                     partial, out, T, D, N, splits, (cudaStream_t)stream);
}
