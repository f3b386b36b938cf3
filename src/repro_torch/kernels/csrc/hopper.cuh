// Building blocks of the port's Hopper (sm_90a) kernels, written as inline
// PTX (no CuTe/CUTLASS headers: a source that includes this header builds in
// seconds).  flash_attention.cu, nm_prune_matmul.cu, nm_spmm.cu,
// osparse_matmul.cu and paged_attention.cu use them:
//
//  * mbarriers: init, arrive, arrive-expect-tx and a parity wait — the
//    full/empty handshakes of a ring of shared-memory stages;
//  * cp.async 16-byte gathers with zero fill that arrive on an mbarrier;
//  * TMA: 2-d and 4-d tiled loads into shared memory that complete on an
//    mbarrier, a 4-d tiled store, and the host-side encoding of the tensor maps
//    (cuTensorMapEncodeTiled, reached through the runtime's driver entry
//    point, so no -lcuda is needed), bf16 or 8-bit with the 128-byte swizzle;
//  * programmatic dependent launch (a kernel that may start while the one
//    before it on the stream runs, and waits for it with griddepcontrol), and
//    thread-block clusters: a launch with a cluster shape, the cluster
//    barrier and loads from another block's shared memory (DSMEM);
//  * wgmma: the shared-memory matrix descriptor of the 128-byte swizzle for
//    K-major and MN-major operands, fence / commit / wait, the bf16 ->
//    float32 m64nNk16 products (N = 64, 128) with A from shared memory or
//    from registers, and the int8 -> int32 m64nNk32 products (N = 8, 16,
//    128; both operands K-major from shared memory: 8-bit wgmma has no
//    transpose);
//  * ex2.approx, the exponent of the attention kernels' online softmax;
//  * the deterministic split-k reduce of the GEMMs' float32 partials;
//  * the N:M keep mask of one group of M scores (a sorting network), shared
//    by the per-token selections of nm_prune_matmul.cu and osparse_matmul.cu.
//
// Layout every kernel here shares: a tile is stored as 64-element (128-byte)
// column chunks; chunk c of a tile of R rows holds R rows of 128 bytes, the
// 16-byte pieces of row r XOR-swizzled by r % 8 — what TMA writes for a box
// whose inner dimension is 64 bf16 under CU_TENSOR_MAP_SWIZZLE_128B.  Each
// chunk starts on a 1024-byte boundary.  As a K-major operand (K along the
// 128-byte rows) a k16 step is a 32-byte advance of the start address and the
// 8-row groups are 1024 bytes apart (SBO); as an MN-major operand (MN along
// the rows, K down them) a k16 step is 16 rows (2048 bytes), SBO is again
// 1024 bytes and LBO is the distance between 64-wide MN chunks.  An 8-bit
// tile has the same byte geometry: a 128-byte row holds 128 int8 values, a
// k32 step (two 16-byte core-matrix columns) is the same 32-byte advance as
// bf16's k16, so desc_k_major serves both (PTX ISA, "Matrix Descriptor" and
// the K-major 128B-swizzle canonical layout, which are given in bytes).
//
// The accumulator of an m64nN product lives in the 128 threads of a
// warpgroup: thread t (warp w = t / 32, lane l) holds d[4j + i] = D[row][col]
// with row = 16w + l/4 + 8*(i/2), col = 8j + 2*(l%4) + i%2.  A register A
// operand (m64k16) is the same map for a 64 x 16 tile packed two bf16 per
// register: a[0] = (row, k 2(l%4)..+1), a[1] = (row+8, same k), a[2] =
// (row, k 8+2(l%4)..+1), a[3] = (row+8, same k), row = 16w + l/4.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA) and the block.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA traffic before the phase ends.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A wait
// of more than ~2^34 clock cycles (seconds: a phase that can never complete)
// traps, so a broken handshake fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// ------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Starts fetching a tensor map (a kernel parameter) into the TMA unit's
// descriptor cache, ahead of its first load or store.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A 4-d tiled store of a shared-memory box to global memory (elements out of
// range are not written), tracked by the bulk async-group; wait for the
// reads of the shared memory with bulk_wait_read before reusing or leaving it.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ------------------------------------------------------------- cp.async
// A 16-byte copy global -> shared that reads `src_bytes` (16 or 0) and fills
// the rest with zeros: a gather TMA cannot make.  Its writes are generic-proxy
// writes: a reader that feeds them to wgmma runs fence_proxy_async() after it
// has seen them arrive.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// One arrival on `bar` once all of this thread's earlier cp.async copies have
// landed; it counts toward the barrier's expected arrivals (.noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Host: a tensor map of `dtype` over `rank` dims (innermost first; `strides`
// are the byte strides of dims 1..rank-1) with 128-byte swizzled boxes of
// `box` elements; out-of-range elements of a box are filled with zeros.
// Returns 0 or a CUDA error code.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline int encode_sw128(CUtensorMap* map, CUtensorMapDataType dtype, const void* base,
                        int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int encode_bf16_sw128(CUtensorMap* map, const void* base, int rank,
                             const cuuint64_t* dims, const cuuint64_t* strides,
                             const cuuint32_t* box) {
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box);
}

// The same for 8-bit elements (int8 bytes; a 128-byte box row is 128 values).
inline int encode_u8_sw128(CUtensorMap* map, const void* base, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box) {
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rank, dims, strides, box);
}

// Host: launches `kernel` as a programmatic dependent of the stream's
// previous kernel: it may start while that kernel still runs (once the
// kernel executes griddepcontrol.launch_dependents), and must wait for it
// (griddepcontrol.wait) before reading anything it writes.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Host: launches `kernel` in clusters of `cluster.x` x `cluster.y` blocks
// (each grid dimension a multiple of the cluster's), as a programmatic
// dependent of the stream's previous kernel when `dependent` is set (see
// launch_dependent).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                           cudaStream_t stream, dim3 cluster, bool dependent, Args... args) {
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster.x;
  attrs[0].val.clusterDim.y = cluster.y;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = dependent ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------- clusters
// The cluster barrier: a phase completes when every thread of every block of
// the cluster has arrived; shared-memory writes before a thread's arrive are
// visible to the cluster's DSMEM reads after its wait.  Called by whole,
// converged warps; a warp may arrive early and wait later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The int32 at the same shared-memory offset as `p`, in the block of cluster
// rank `rank` (the block's own rank reads its own shared memory).
__device__ __forceinline__ int ld_cluster_s32(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// Four consecutive int32 (16-byte aligned) of the block of cluster rank `rank`.
__device__ __forceinline__ int4 ld_cluster_v4(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// ----------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled operand starting at
// `p`: lbo/sbo in bytes (see the header note), layout type 1 = 128B swizzle.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major (K along the 128-byte rows): LBO unused, 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t desc_k_major(const void* p) { return make_desc(p, 16, 1024); }
// MN-major: 8-row (K) groups 1024 B apart, 64-wide MN chunks `chunk` B apart.
__device__ __forceinline__ uint64_t desc_mn_major(const void* p, uint32_t chunk) {
  return make_desc(p, chunk, 1024);
}

// Synchronises the `count` threads (whole warps) that use barrier `id`
// (1-15; 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's ordinary shared-memory stores before later reads of
// the same bytes by the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Aligns a dynamic shared-memory buffer (allocated 1024 bytes long) to the
// 1024-byte boundary the 128-byte swizzle needs.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 2^x by the MUFU unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one register of two bf16 (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, float32) = A (64 x 16, shared) * B (16 x 64, shared), plus D
// when scale_d != 0.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D (64 x 64, float32) = A (64 x 16, registers) * B (16 x 64, shared),
// plus D
// when scale_d != 0.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D (64 x 128, float32) = A (64 x 16, shared) * B (16 x 128, shared), plus D
// when scale_d != 0.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// ------------------------------------------------------------ int8 wgmma
// D (64 x 8, int32) = A (64 x 32, shared, K-major) * B (32 x 8, shared,
// K-major), plus D when scale_d != 0.  8-bit wgmma has no transpose: both
// operands are K-major.
__device__ __forceinline__ void wgmma_m64n8k32_s8(int (&d)[4], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3 "
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 16, int32) = A (64 x 32, shared, K-major) * B (32 x 16, shared,
// K-major), plus D when scale_d != 0.  8-bit wgmma has no transpose: both
// operands are K-major.
__device__ __forceinline__ void wgmma_m64n16k32_s8(int (&d)[8], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, int32) = A (64 x 32, shared, K-major) * B (32 x 128, shared,
// K-major), plus D when scale_d != 0.  8-bit wgmma has no transpose: both
// operands are K-major.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ------------------------------------------------------------ N:M keep mask
// Bit j set for the n channels of one group of M scores s[0, M) that n rounds
// of strict-'>' argmax would keep (the lowest channel wins a tie; the JAX
// package's first-occurrence rule): those above the group's n-th largest
// score v, and of those equal to v the lowest channels, as many as are left.
// v comes from a bitonic sorting network (descending), so there is no serial
// chain of n rounds; the mask is bit-identical for finite scores.
template <int M>
__device__ __forceinline__ uint32_t nm_keep(const float* s, int n) {
  float t[M];
#pragma unroll
  for (int j = 0; j < M; ++j) t[j] = s[j];
#pragma unroll
  for (int k = 2; k <= M; k <<= 1)
#pragma unroll
    for (int h = k >> 1; h > 0; h >>= 1)
#pragma unroll
      for (int a = 0; a < M; ++a) {
        const int b = a ^ h;
        if (b > a) {
          const float hi = fmaxf(t[a], t[b]), lo = fminf(t[a], t[b]);
          t[a] = (a & k) == 0 ? hi : lo;
          t[b] = (a & k) == 0 ? lo : hi;
        }
      }
  float v = t[0];
#pragma unroll
  for (int k = 1; k < M; ++k) v = k == n - 1 ? t[k] : v;
  uint32_t above = 0u, ties = 0u;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    above |= (s[j] > v ? 1u : 0u) << j;
    ties |= (s[j] == v ? 1u : 0u) << j;
  }
  const int room = n - __popc(above);     // >= 1: v is the n-th largest
  while (__popc(ties) > room) ties &= ~(1u << (31 - __clz(ties)));
  return above | ties;
}

// ------------------------------------------------------- split-k reduce
// The body of the GEMMs' split-k reduce kernels (a programmatic dependent of
// the GEMM: it waits for the partials first).  `part` holds `splits` k slices
// of T x N float32 partials; out = bf16(their sum in slice order, + bias[col]
// when bias is not null), rounded once and deterministic (no atomics).  One
// thread per 4 consecutive outputs; N % 4 == 0.
__device__ __forceinline__ void splitk_reduce_bf16(const float* __restrict__ part,
                                                   const float* __restrict__ bias,
                                                   __nv_bfloat16* __restrict__ out, int T_, int N,
                                                   int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t total = (size_t)T_ * N;
  const size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= total) return;
  float4 a = *reinterpret_cast<const float4*>(part + e);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 b = *reinterpret_cast<const float4*>(part + sp * total + e);
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  }
  if (bias != nullptr) {
    const float* b = bias + e % N;
    a.x += b[0], a.y += b[1], a.z += b[2], a.w += b[3];
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y), hi = __floats2bfloat162_rn(a.z, a.w);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + e) = v;
}

// D (64 x 128, float32) = A (64 x 16, registers) * B (16 x 128, shared),
// plus D
// when scale_d != 0.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

}  // namespace hopper
