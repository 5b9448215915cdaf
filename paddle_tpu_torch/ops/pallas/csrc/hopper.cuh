// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// the bf16 and f16 flash-attention kernels K1-K3 (flash_attention.cu), the
// bf16 and f16 ragged paged attention K4 (ragged_paged_attention.cu) and the
// grouped products K5, K6 and K7 (grouped_matmul.cu). mbarriers, TMA tile
// loads, wgmma shared-memory descriptors and products, warpgroup barriers,
// and the host-side encoding of TMA tensor maps.
//
// Shared-memory tiles are bf16 (or f16: the same two bytes an element, so
// every layout below holds for both) in the 128-byte swizzle that TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B): a tile is cut into panels of 64 columns,
// 128 bytes a row; in a panel, row r starts at r * 128 bytes and its
// 16-byte chunk c sits at chunk c ^ (r % 8). Every panel starts on a
// 1024-byte boundary, where the swizzle pattern repeats. `sw128_offset`
// gives the byte offset of an element in a panel, so threads that stage a
// tile through registers write exactly what TMA would.
//
// wgmma operands are described to the tensor cores by 64-bit descriptors:
// a K-major operand (contraction dimension contiguous, as a Q or K tile, or
// a row tile of lhs) is rows of 128 bytes in groups of 8 rows 1024 bytes
// apart; an MN-major operand (output dimension contiguous, as a V tile or
// an expert's [M, H] matrix) is 64-wide panels `panel_bytes` apart, with
// groups of 8 contraction rows 1024 bytes apart. A k16 step advances a
// K-major descriptor by 32 bytes inside the 128-byte row and an MN-major
// one by 16 rows (2048 bytes). One swizzled tile serves both ways: the
// backward kernels read a Q, dO or K tile K-major in one product and
// MN-major in another. `set_smem_once` raises a kernel's dynamic shared
// memory limit once per kernel and device.
//
// Products: m64n128k16 and m64n64k16, each with A from shared memory
// (`_ss`) or from registers (`_rs`, the m16n8k16 A-fragment layout, into
// which an f32 accumulator packs two values a register). Each takes its
// element type E, bf16 by default or f16 (wgmma's .f16 kind on the same
// shapes; accumulation in f32 either way). Warpgroup
// barriers (`warpgroup_sync`, `warpgroup_any`) are named barriers 1 and 2
// of 128 threads, so one warpgroup waits on its own threads only.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace hopper {

// ------------------------------- shared memory ------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (dynamic shared memory is only
// promised 16-byte alignment; launches ask for 1024 bytes of slack)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// byte offset of bf16 element (row, col), col < 64, in a swizzled panel
__host__ __device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return static_cast<uint32_t>(row * 128 + ((((col >> 3) ^ row) & 7) << 4) +
                               (col & 7) * 2);
}

// ---------------------------------- mbarriers -------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that polls
// 2^26 times (seconds; every wait of these kernels is a tile's load or
// product, microseconds) means a phase that can never complete: the
// kernel traps, so the launch fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 26)) __trap();
  } while (!done);
}

// ------------------------------------ TMA -----------------------------------
// One thread asks for a box of the tensor map at element coordinates
// (innermost first); the box lands in shared memory swizzled, elements past
// the tensor's edges as zeros, and its bytes complete `bar`'s transaction.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory (threads staging a tile) become
// visible to the async proxy (wgmma) after this fence
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ----------------------------------- wgmma ----------------------------------
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return make_desc(addr, 16, 1024);  // the leading offset is unused here
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t panel_bytes) {
  return make_desc(addr, panel_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from touching accumulators, or the A fragments a
// wgmma reads from registers, across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// two f32 values as the bf16 pair of one 32-bit register (lo first),
// rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the same pair in element type E (bf16 or f16), rounded to nearest even
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// two f32 values stored as the E pair at dst (4-byte aligned)
template <typename E>
__device__ __forceinline__ void store2(E* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<E>(lo, hi);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] in f32, bf16 operands. `_ss`: A and
// B from shared memory (scale_d = 0 overwrites D); `_rs`: A from registers
// in the m16n8k16 A-fragment layout of each warp's 16 rows, accumulating.
// TransB = 1 for an MN-major B; TransA = 1 (m64n128k16_ss) for an MN-major
// A, described as an MN-major B is. The accumulator layout: for each 8-column
// chunk c, d[4c + e] sits at row 16 * warp + lane / 4 + 8 * (e / 2) and
// column 8c + 2 * (lane % 4) + e % 2.
template <int TransB, int TransA = 0, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                  uint64_t db, int scale_d) {
#define HOPPER_WGMMA_128_SS(KIND) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %66, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." KIND " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, " \
        "%40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, " \
        "%56, %57, %58, %59, %60, %61, %62, %63" \
        "}, %64, %65, p, 1, 1, %68, %67;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TransB), "n"(TransA))
  if constexpr (std::is_same<E, __half>::value)
    HOPPER_WGMMA_128_SS("f16.f16");
  else
    HOPPER_WGMMA_128_SS("bf16.bf16");
#undef HOPPER_WGMMA_128_SS
}

template <int TransB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
#define HOPPER_WGMMA_64_SS(KIND) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %34, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." KIND " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31" \
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TransB))
  if constexpr (std::is_same<E, __half>::value)
    HOPPER_WGMMA_64_SS("f16.f16");
  else
    HOPPER_WGMMA_64_SS("bf16.bf16");
#undef HOPPER_WGMMA_64_SS
}

template <int TransB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
#define HOPPER_WGMMA_64_RS(KIND) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %37, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." KIND " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31" \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), \
          "n"(TransB))
  if constexpr (std::is_same<E, __half>::value)
    HOPPER_WGMMA_64_RS("f16.f16");
  else
    HOPPER_WGMMA_64_RS("bf16.bf16");
#undef HOPPER_WGMMA_64_RS
}

template <int TransB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
#define HOPPER_WGMMA_128_RS(KIND) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %69, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." KIND " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, " \
        "%40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, " \
        "%56, %57, %58, %59, %60, %61, %62, %63" \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), \
          "n"(TransB))
  if constexpr (std::is_same<E, __half>::value)
    HOPPER_WGMMA_128_RS("f16.f16");
  else
    HOPPER_WGMMA_128_RS("bf16.bf16");
#undef HOPPER_WGMMA_128_RS
}

// ------------------------------ warpgroup barriers --------------------------
// Named barrier 1 + wg (0 is __syncthreads'), over the 128 threads of
// warpgroup wg. The non-aligned form: threads of a warp may arrive apart,
// as after thread 0's TMA issue.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("barrier.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// whether any thread of warpgroup wg passes true (all 128 must call it)
__device__ __forceinline__ bool warpgroup_any(bool v, int wg) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "barrier.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(v)), "r"(1 + wg)
      : "memory");
  return r != 0;
}

// ---------------------------------- helpers ---------------------------------
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------ host: tensor maps ---------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory) once per kernel
// and device, on its first launch: a launch that a CUDA graph captures
// later (jit/cuda_graph.py) then makes no call but the launch itself
inline cudaError_t set_smem_once(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) done.insert({kernel, dev});
  return e;
}

// A tensor map of a tensor of `rank` dimensions, innermost first (dims[0]
// contiguous), byte strides of dimensions 1.., boxes of box[] elements.
// By default bf16 in the 128-byte swizzle (box[0] = 64: one swizzled
// panel row; `map_dtype<E>()` names bf16 or f16); K6 lands f32 tiles
// unswizzled, row-major.
template <typename E>
constexpr CUtensorMapDataType map_dtype() {
  return std::is_same<E, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

inline cudaError_t make_map(
    CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, dtype, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
