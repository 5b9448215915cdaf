// Grouped matrix multiply for Hopper, sm_90a: K5, K6, K7 and K8.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/grouped_matmul.py:
//   K5 `_gmm_fwd`          (pallas_call :178, body :131)
//      out[rows_e] = lhs[rows_e] @ rhs[e] over group-sorted rows; rows past
//      sum(group_sizes) (the sentinel group) come out exactly 0;
//   K6 `_tgmm_fwd`         (:242, body :196)
//      out[e] = lhs[rows_e]^T @ g[rows_e]; an empty expert gets exactly 0;
//   K7 `_gmm_aligned_fwd`  (:283, body :269)
//      K5 on the bm-aligned layout: row block b belongs to block_experts[b];
//   K8 `_tgmm_aligned_fwd` (:335, body :304)
//      K6 on the aligned layout; an expert that owns no block is left
//      unwritten, as on the TPU (the wrapper replaces it with 0 by `where`).
//
// Layouts (row-major): lhs [rows, lhs_cols] and g [rows, n_dim] contiguous;
// rhs [experts, lhs_cols, n_dim] with any element strides (rhs_se, rhs_sk,
// rhs_sn), so gmm's backward passes rhs^T as a strided view and never
// copies it; offsets int32 [experts + 2] = 0, cumsum(group_sizes), rows;
// block_experts int32 [rows / bm], non-decreasing.
//
// Work assignment. The TPU kernels walk a tile list in grid order and
// carry an f32 accumulator from one tile to the next (`_metadata`,
// :56-118, and the scratch at :147-160), because a Pallas out block is
// written whole. Here every thread block owns its output tile outright,
// so nothing is accumulated across blocks and no atomics are needed.
//
// Four designs, chosen by kernel and dtype:
// - bf16 wgmma fed by TMA (`gmm_wgmma_kernel`, its note below): K5 and K7
//   with bf16 lhs and rhs. A persistent grid walks a device-built list of
//   row tiles that never straddle a group (K7's groups are the runs of
//   block_experts), with operands brought in by TMA through a ring of
//   shared-memory stages.
// - a three-way bf16 split on wgmma (`tgmm_split_kernel`, its note below):
//   K6, whose inputs are always f32, to f32 accuracy on the tensor cores.
// - bf16 wgmma over the block runs (`tgmm_aligned_wgmma_kernel`, its
//   note below): K8 with bf16 inputs, K6's persistent walk without the
//   split, operands by TMA through K5's kind of ring.
// - FMA loops: the f32 instances of K5, K7 and K8 ((f32, f32) and the
//   backward's (f32 g, bf16 rhs^T)), whose tolerances the tensor cores'
//   TF32 would miss and which the split design does not take yet. K5/K7
//   run one block per (128 output rows, 128 output columns); the block finds the groups that meet its rows (binary
//   search over offsets, or the runs of block_experts), multiplies each
//   group's rows by its expert's matrix and stores those rows only. K8
//   runs one block per (expert, 128 x 128 tile of [M, H]) and loops over
//   that expert's rows, so the reduction over a variable number of rows
//   has an order that does not depend on scheduling. `bm` is the API's
//   divisibility and layout unit; the CUDA tile height (128) is this
//   file's own and results do not depend on it.
//
// Every load is masked: a row of another group, a row past the group, a
// column past the matrix and a depth past the contraction read as 0 (K6
// masks lhs and g alike).
//
// FMA arithmetic: tiles of 128 x 16 (A) and 16 x 128 (B) are staged in
// shared memory as f32 and multiplied by register-tiled FMA loops: thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + {0..3, 64..67} and
// columns tx*4 + {0..3, 64..67} of the tile, 64 f32 accumulators. Products
// of bf16 values are exact in f32, so this is the f32-accumulated dot of
// the TPU kernels (`preferred_element_type=f32`), with its sums in another
// order. Their outputs are f32 (the bf16 instances run on wgmma).
//
// Bound on this card: operations. At DeepSeekMoE-16B's expert widths
// (M=2048, H=1408) and R = 49152 routed rows, K5 does 2*R*M*H = 2.8e11
// flops against ~0.7 GB of traffic in bf16, far above the H100's ridge of
// ~295 flops per byte. K8 alone is bound by bytes: its f32 output of E*M*H
// values (0.74 GB) takes longer to write than its products take. The FMA loops run at the f32 rate at best (67
// TFLOP/s); the wgmma designs at the bf16 tensor-core rate (989 TFLOP/s,
// six products for K6). PERF.md holds the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// Launch parameters, filled field for field by the Python wrapper's ctypes
// mirror (_Params). At global scope so the extern "C" entry points that
// take it keep external linkage.
struct GmmParams {
  const void* lhs;
  const void* rhs;            // gmm: rhs [E, lhs_cols, n_dim]; tgmm: g
  const int* offsets;         // K5, K6
  const int* block_experts;   // K7, K8
  void* out;
  const int* tiles;           // K5/K7 bf16: the tile list (gmm_tiles_launch)
  long long rhs_se, rhs_sk, rhs_sn;  // element strides of rhs (or g)
  int rows, lhs_cols, n_dim, experts, bm, lhs_dtype, rhs_dtype;
  int max_tiles;              // K5/K7 bf16: entries of the tile list
  int tma_lhs;                // K5/K7 bf16: 1 = lhs by TMA, 0 = registers;
                              // K6: 1 = both by TMA, 0 = by cp.async
  int tma_rhs;                // K5/K7 bf16: a gmm90::Load code
};

namespace {

constexpr int kBM = 128;  // output rows (K5/K7) or lhs columns (K8)
constexpr int kBN = 128;  // output columns
constexpr int kBK = 16;   // contraction depth staged per step
constexpr int kPad = 4;   // keeps float4 rows aligned, spreads banks
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A 2-D operand: element (i, j) at p[i * si + j * sj].
template <typename T>
struct View {
  const T* p;
  long long si, sj;
};

struct Tiles {
  float a[kBK][kBM + kPad];  // A tile, depth-major: a[k][m]
  float b[kBK][kBN + kPad];  // B tile: b[k][n]
};

// Stage A(m0 .. m0+kBM, k0 .. k0+kBK) as a[k][m], 0 outside rows
// [m_lo, m_hi) and depths below k_hi. Neighbouring threads walk the
// operand's contiguous dimension.
template <typename T>
__device__ void stage_a(float (*dst)[kBM + kPad], View<T> a, int m0, int m_lo,
                        int m_hi, int k0, int k_hi) {
  const bool k_fast = a.sj == 1;
  for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
    const int mm = k_fast ? i / kBK : i % kBM;
    const int kk = k_fast ? i % kBK : i / kBM;
    const int m = m0 + mm, k = k0 + kk;
    float v = 0.f;
    if (m >= m_lo && m < m_hi && k < k_hi) v = to_f(a.p[m * a.si + k * a.sj]);
    dst[kk][mm] = v;
  }
}

// Stage B(k0 .. k0+kBK, n0 .. n0+kBN) as b[k][n], 0 past n_hi and k_hi.
template <typename T>
__device__ void stage_b(float (*dst)[kBN + kPad], View<T> b, int n0, int n_hi,
                        int k0, int k_hi) {
  const bool n_fast = b.sj == 1;
  for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
    const int nn = n_fast ? i % kBN : i / kBK;
    const int kk = n_fast ? i / kBN : i % kBK;
    const int n = n0 + nn, k = k0 + kk;
    float v = 0.f;
    if (n < n_hi && k < k_hi) v = to_f(b.p[k * b.si + n * b.sj]);
    dst[kk][nn] = v;
  }
}

__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (j & 3);
}

// acc = A[m0.., k_lo..k_hi) @ B[k_lo..k_hi), n0..] with the masks above.
// Every thread of the block calls it with the same arguments.
template <typename TA, typename TB>
__device__ void product(float (&acc)[8][8], Tiles& s, View<TA> a, int m0,
                        int m_lo, int m_hi, View<TB> b, int n0, int n_hi,
                        int k_lo, int k_hi) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    stage_a(s.a, a, m0, m_lo, m_hi, k0, k_hi);
    stage_b(s.b, b, n0, n_hi, k0, k_hi);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Store the accumulator's rows [m_lo, m_hi) and columns below n_hi.
__device__ void store(const float (&acc)[8][8], float* out, long long ld,
                      int m0, int m_lo, int m_hi, int n0, int n_hi) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + row_of(i);
    if (m < m_lo || m >= m_hi) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + col_of(j);
      if (n < n_hi) out[m * ld + n] = acc[i][j];
    }
  }
}

__device__ void store_zeros(float* out, long long ld, int m_lo, int m_hi,
                            int n0, int n_hi) {
  for (int i = threadIdx.x; i < (m_hi - m_lo) * kBN; i += kThreads) {
    const int m = m_lo + i / kBN, n = n0 + i % kBN;
    if (n < n_hi) out[m * ld + n] = 0.f;
  }
}

template <typename TB>
__device__ __forceinline__ View<TB> expert_matrix(const GmmParams& p, int e) {
  return View<TB>{static_cast<const TB*>(p.rhs) + e * p.rhs_se, p.rhs_sk,
                  p.rhs_sn};
}

// K5. grid (column tiles, row tiles).
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) gmm_kernel(GmmParams p) {
  __shared__ __align__(16) Tiles s;
  const int r0 = blockIdx.y * kBM, r1 = min(r0 + kBM, p.rows);
  const int n0 = blockIdx.x * kBN;
  const View<TA> a{static_cast<const TA*>(p.lhs), p.lhs_cols, 1};
  float* out = static_cast<float*>(p.out);
  const int* offs = p.offsets;
  // the first group that ends past r0
  int lo = 0, hi = p.experts;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (offs[mid + 1] > r0)
      hi = mid;
    else
      lo = mid + 1;
  }
  float acc[8][8];
  for (int e = lo; e < p.experts && offs[e] < r1; ++e) {
    const int g0 = max(r0, offs[e]), g1 = min(r1, offs[e + 1]);
    if (g0 >= g1) continue;  // an empty group
    product(acc, s, a, r0, g0, g1, expert_matrix<TB>(p, e), n0, p.n_dim,
            0, p.lhs_cols);
    store(acc, out, p.n_dim, r0, g0, g1, n0, p.n_dim);
  }
  // rows past sum(group_sizes): the sentinel group, exactly 0
  const int tail = max(r0, min(offs[p.experts], r1));
  if (tail < r1) store_zeros(out, p.n_dim, tail, r1, n0, p.n_dim);
}

// ============== K5 and K7 in bf16: wgmma fed by TMA, persistent ============
// The row tiles never straddle a group: group g's rows [offs[g],
// offs[g+1]) are cut into tiles of 128 rows from offs[g], the last one
// partial, for the E experts and the sentinel group E (rows past
// sum(group_sizes), written as zeros). gmm_tiles_kernel writes the list on
// the device, `max_tiles` = ceil(R / 128) + E entries of (first row, past
// last row, group), unused entries (0, 0, -1); the wrapper's plain twin is
// `_gmm_tiles`. K7 hands the kernel the offsets of the runs of
// block_experts (`_aligned_offsets`: expert e's rows are [bm * first block
// of e, bm * past its last block); the trailing blocks clamped to E - 1
// are E - 1's, so the sentinel group is empty and every row, data or
// not, is computed, with no masking). A run shorter than 128 rows (bm
// of 32 or 64) is a partial tile, whose box also loads rows of the next
// runs and never stores them. A persistent grid of one block per SM walks
// the (tile, 128-column tile) pairs. In a block, warpgroup 0 loads and
// warpgroups 1
// and 2 each multiply 64 of the 128 rows: a ring of kStages stages of
// lhs [128 rows][64 deep] (K-major) and rhs[g] [64 deep][128 columns],
// each guarded by a "full" and an "empty" mbarrier (one arrival from each
// of the 8 computing warps), so loads run ahead of the wgmma m64n128k16
// products across tiles. lhs comes by TMA from a 2-D map [R, M] (a box
// may start at any row; rows of the next group in a partial tile are
// loaded and never stored); rhs from a 3-D map [E, M, H] (MN-major), or,
// for the transposed view [E, K, N] of a contiguous [E, N, K] that
// gmm_aligned's backward passes, from a 3-D map of that storage, read
// K-major as lhs is. An operand that TMA cannot describe (a row pitch or
// base not a multiple of 16 bytes, or rhs strided otherwise) is staged by
// the loader's 128 threads through registers into the MN-major swizzled
// layout; the launch picks the loader per operand (template parameters).
// The accumulators are rounded to bf16 once, to nearest even, and only
// the tile's rows of its own group are stored, from registers, so no
// neighbour's row is overwritten.
namespace gmm90 {
constexpr int kRows = 128, kCols = 128, kDepth = 64, kStages = 4;
constexpr int kThreads = 384;
// how rhs comes in: staged through registers (any strides); by TMA from
// [E, M, H] (MN-major B); by TMA from the storage [E, H, M] of a
// transposed view, read K-major (gmm_aligned's backward passes rhs^T)
enum Load { kRegs = 0, kTmaMn = 1, kTmaK = 2 };
constexpr int kABytes = kRows * kDepth * 2;  // one panel [128][64]
constexpr int kBBytes = kDepth * kCols * 2;  // two panels [64][64]
constexpr size_t kSmem = 1024 + kStages * (kABytes + kBBytes) +
                         2 * kStages * 8;
}  // namespace gmm90

// Where a stage is, and its phase: the ring position counts k steps over
// every tile the block has walked.
template <int kN = gmm90::kStages>
struct Ring {
  uint32_t it = 0;
  __device__ __forceinline__ int stage() const {
    return static_cast<int>(it % kN);
  }
  __device__ __forceinline__ uint32_t phase() const {
    return (it / kN) & 1;
  }
};

// The loader's side of one tile: lhs rows row0.. and rhs[g] columns n0..
// over the whole contraction. All 128 threads of warpgroup 0 call it when
// an operand is staged through registers, thread 0 alone when both come
// by TMA.
template <bool kTmaA, int kLoadB>
__device__ void gmm_load_tile(const GmmParams& p, const CUtensorMap* ta,
                              const CUtensorMap* tb, uint8_t* a_s,
                              uint8_t* b_s, uint64_t* full, uint64_t* empty,
                              Ring<>& ring, int row0, int g, int n0) {
  using namespace hopper;
  using namespace gmm90;
  constexpr bool kTmaB = kLoadB != kRegs;
  const int t = threadIdx.x;
  const bf16* lhs = static_cast<const bf16*>(p.lhs);
  const bf16* rhs = static_cast<const bf16*>(p.rhs) + g * p.rhs_se;
  for (int k0 = 0; k0 < p.lhs_cols; k0 += kDepth, ++ring.it) {
    const int s = ring.stage();
    if (ring.it >= kStages) mbar_wait(&empty[s], ring.phase() ^ 1);
    uint8_t* a = a_s + s * kABytes;
    uint8_t* b = b_s + s * kBBytes;
    if (!kTmaA) {
      for (int i = t; i < kRows * kDepth; i += 128) {
        const int r = i / kDepth, c = i % kDepth;
        const int row = row0 + r, k = k0 + c;
        bf16 v = __float2bfloat16(0.f);
        if (row < p.rows && k < p.lhs_cols)
          v = lhs[static_cast<long long>(row) * p.lhs_cols + k];
        *reinterpret_cast<bf16*>(a + sw128_offset(r, c)) = v;
      }
    }
    if (!kTmaB) {
      for (int i = t; i < kDepth * kCols; i += 128) {
        const int r = i / kCols, c = i % kCols;
        const int k = k0 + r, n = n0 + c;
        bf16 v = __float2bfloat16(0.f);
        if (k < p.lhs_cols && n < p.n_dim) v = rhs[k * p.rhs_sk + n * p.rhs_sn];
        *reinterpret_cast<bf16*>(b + (c / 64) * kDepth * 128 +
                                 sw128_offset(r, c % 64)) = v;
      }
    }
    if (!kTmaA || !kTmaB) fence_proxy_async();
    constexpr uint32_t kTx = (kTmaA ? kABytes : 0) + (kTmaB ? kBBytes : 0);
    if (t == 0 && kTx > 0) {
      mbar_arrive_expect_tx(&full[s], kTx);
      if (kTmaA) tma_load_2d(a, ta, &full[s], k0, row0);
      if (kLoadB == kTmaMn) {
        tma_load_3d(b, tb, &full[s], n0, k0, g);
        tma_load_3d(b + kDepth * 128, tb, &full[s], n0 + 64, k0, g);
      } else if (kLoadB == kTmaK) {  // [128 columns][64 deep], one panel
        tma_load_3d(b, tb, &full[s], k0, n0, g);
      }
    } else {
      mbar_arrive(&full[s]);
    }
  }
}

// A stage is free once each of the 8 computing warps has arrived.
__device__ __forceinline__ void release(uint64_t* empty, int stage) {
  if (stage < 0) return;
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[stage]);
}

// A computing warpgroup's side of one tile: acc = its 64 rows x 128
// columns of the product over the whole contraction. A K-major rhs stage
// is 128 rows of 128 bytes, read as A's are.
template <bool kBKMajor>
__device__ void gmm_mma_tile(float (&acc)[64], const uint8_t* a_s,
                             const uint8_t* b_s, uint64_t* full,
                             uint64_t* empty, Ring<>& ring, int n_k,
                             int cw) {
  using namespace hopper;
  using namespace gmm90;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int ks = 0; ks < n_k; ++ks, ++ring.it) {
    const int s = ring.stage();
    mbar_wait(&full[s], ring.phase());
    const uint32_t a = smem_u32(a_s + s * kABytes) + cw * 64 * 128;
    const uint32_t b = smem_u32(b_s + s * kBBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      if constexpr (kBKMajor)
        wgmma_m64n128k16_ss<0>(acc, desc_k_major(a + kk * 32),
                               desc_k_major(b + kk * 32), 1);
      else
        wgmma_m64n128k16_ss<1>(acc, desc_k_major(a + kk * 32),
                               desc_mn_major(b + kk * 16 * 128, kDepth * 128),
                               1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with it
    release(empty, prev);
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(empty, prev);
}

template <bool kTmaA, int kLoadB>
__global__ void __launch_bounds__(gmm90::kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, GmmParams p) {
  using namespace hopper;
  using namespace gmm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = align1024(smem_raw);
  uint8_t* b_s = a_s + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  // with both operands by TMA one loader thread suffices; threads that
  // stage an operand through registers all arrive
  constexpr bool kStaged = !kTmaA || kLoadB == kRegs;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kStaged ? 128 : 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0 && !kStaged && threadIdx.x != 0) return;

  const int n_col = (p.n_dim + kCols - 1) / kCols;
  const int n_k = (p.lhs_cols + kDepth - 1) / kDepth;
  const int n_items = p.max_tiles * n_col;
  bf16* out = static_cast<bf16*>(p.out);
  const long long ld = p.n_dim;
  const bool pairs = p.n_dim % 2 == 0;  // bf16x2 stores stay aligned
  Ring<> ring;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int tile = w / n_col, n0 = (w % n_col) * kCols;
    const int row0 = p.tiles[3 * tile], row1 = p.tiles[3 * tile + 1];
    const int g = p.tiles[3 * tile + 2];
    if (row0 >= row1) continue;  // an unused entry
    if (wg == 0) {
      if (g < p.experts)
        gmm_load_tile<kTmaA, kLoadB>(p, &ta, &tb, a_s, b_s, full, empty,
                                     ring, row0, g, n0);
      continue;
    }
    const int cw = wg - 1, t = threadIdx.x - 128 * wg, lane = t % 32;
    if (g >= p.experts) {
      // the sentinel group: rows past sum(group_sizes) are exactly 0
      const int lo = row0 + cw * 64, hi = min(lo + 64, row1);
      for (int i = t; i < (hi - lo) * kCols; i += 128) {
        const int r = lo + i / kCols, n = n0 + i % kCols;
        if (n < p.n_dim) out[r * ld + n] = __float2bfloat16(0.f);
      }
      continue;
    }
    float acc[64];
    gmm_mma_tile<kLoadB == kTmaK>(acc, a_s, b_s, full, empty, ring, n_k, cw);
    const int ra = row0 + cw * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      if (r >= row1) continue;
#pragma unroll
      for (int c = 0; c < kCols / 8; ++c) {
        const int n = n0 + 8 * c + 2 * (lane % 4);
        const float x = acc[4 * c + 2 * h], y = acc[4 * c + 2 * h + 1];
        if (pairs && n + 1 < p.n_dim) {
          *reinterpret_cast<__nv_bfloat162*>(out + r * ld + n) =
              __floats2bfloat162_rn(x, y);
        } else {
          if (n < p.n_dim) out[r * ld + n] = __float2bfloat16(x);
          if (n + 1 < p.n_dim) out[r * ld + n + 1] = __float2bfloat16(y);
        }
      }
    }
  }
}

// The K5 tile list from offsets_ext (E + 2 entries): one block scans the
// tile counts of the E + 1 groups chunk by chunk; each thread writes its
// group's tiles.
__global__ void __launch_bounds__(1024) gmm_tiles_kernel(const int* offsets,
                                                         int groups, int rows,
                                                         int max_tiles,
                                                         int* tiles) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  int carry = 0;
  for (int base = 0; base < groups; base += blockDim.x) {
    const int g = base + threadIdx.x;
    int lo = 0, hi = 0;
    if (g < groups) {
      lo = min(max(offsets[g], 0), rows);
      hi = max(min(max(offsets[g + 1], 0), rows), lo);
    }
    const int n = (hi - lo + gmm90::kRows - 1) / gmm90::kRows;
    int incl = n;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      int v = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      if (lane < n_warps) warp_sums[lane] = v;
    }
    __syncthreads();
    const int first = carry + (wid > 0 ? warp_sums[wid - 1] : 0) + incl - n;
    for (int i = 0; i < n; ++i) {
      const int tt = first + i;
      if (tt >= max_tiles) break;
      tiles[3 * tt] = lo + gmm90::kRows * i;
      tiles[3 * tt + 1] = min(lo + gmm90::kRows * (i + 1), hi);
      tiles[3 * tt + 2] = g;
    }
    carry += warp_sums[n_warps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  for (int tt = carry + threadIdx.x; tt < max_tiles; tt += blockDim.x) {
    tiles[3 * tt] = 0;
    tiles[3 * tt + 1] = 0;
    tiles[3 * tt + 2] = -1;
  }
}

template <bool kTmaA, int kLoadB>
cudaError_t launch_gmm_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                             const GmmParams& p, int grid,
                             cudaStream_t stream) {
  auto kernel = gmm_wgmma_kernel<kTmaA, kLoadB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(gmm90::kSmem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, gmm90::kThreads, gmm90::kSmem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

cudaError_t run_gmm_wgmma(const GmmParams& p, cudaStream_t stream) {
  if (p.tiles == nullptr || p.max_tiles < 1) return cudaErrorInvalidValue;
  if (p.rows == 0) return cudaSuccess;
  CUtensorMap ta, tb;
  cudaError_t e = cudaSuccess;
  if (p.tma_lhs) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.lhs_cols),
                                static_cast<cuuint64_t>(p.rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.lhs_cols) * 2};
    const cuuint32_t box[2] = {gmm90::kDepth, gmm90::kRows};
    e = hopper::make_map(&ta, p.lhs, 2, dims, strides, box);
  }
  if (e == cudaSuccess && p.tma_rhs == gmm90::kTmaMn) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.n_dim),
                                static_cast<cuuint64_t>(p.lhs_cols),
                                static_cast<cuuint64_t>(p.experts)};
    const cuuint64_t strides[2] = {
        static_cast<cuuint64_t>(p.n_dim) * 2,
        static_cast<cuuint64_t>(p.n_dim) * p.lhs_cols * 2};
    const cuuint32_t box[3] = {64, gmm90::kDepth, 1};
    e = hopper::make_map(&tb, p.rhs, 3, dims, strides, box);
  } else if (e == cudaSuccess && p.tma_rhs == gmm90::kTmaK) {
    // rhs is the view [E, K, N] of a contiguous [E, N, K]: map the storage
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.lhs_cols),
                                static_cast<cuuint64_t>(p.n_dim),
                                static_cast<cuuint64_t>(p.experts)};
    const cuuint64_t strides[2] = {
        static_cast<cuuint64_t>(p.lhs_cols) * 2,
        static_cast<cuuint64_t>(p.n_dim) * p.lhs_cols * 2};
    const cuuint32_t box[3] = {gmm90::kDepth, gmm90::kCols, 1};
    e = hopper::make_map(&tb, p.rhs, 3, dims, strides, box);
  } else if (p.tma_rhs != gmm90::kRegs) {
    e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(p.max_tiles) *
                          ((p.n_dim + gmm90::kCols - 1) / gmm90::kCols);
  if (items > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  using namespace gmm90;
  switch (p.tma_rhs * 2 + (p.tma_lhs ? 1 : 0)) {
    case kRegs * 2 + 1:
      return launch_gmm_wgmma<true, kRegs>(ta, tb, p, grid, stream);
    case kTmaMn * 2 + 1:
      return launch_gmm_wgmma<true, kTmaMn>(ta, tb, p, grid, stream);
    case kTmaK * 2 + 1:
      return launch_gmm_wgmma<true, kTmaK>(ta, tb, p, grid, stream);
    case kRegs * 2:
      return launch_gmm_wgmma<false, kRegs>(ta, tb, p, grid, stream);
    case kTmaMn * 2:
      return launch_gmm_wgmma<false, kTmaMn>(ta, tb, p, grid, stream);
    default:
      return launch_gmm_wgmma<false, kTmaK>(ta, tb, p, grid, stream);
  }
}

// ========== K6 in f32: a three-way bf16 split on wgmma, persistent =========
// out[e] = lhs[rows_e]^T @ g[rows_e], f32 in and out, to f32 accuracy on
// the bf16 tensor cores. Every f32 operand value x is split into three
// bf16 values, h = bf16(x), m = bf16(x - h), l = bf16(x - h - m) (each
// difference exact in f32, each rounding to nearest even), so x = h + m + l
// to 2^-24 of x. Of the nine products of the two splits the kernel runs
// the six above 2^-24 of the result: hh, hm, mh, hl, lh and mm; products
// of bf16 values are exact and wgmma sums them in f32 accumulators. The
// error is ~1e-6 of the largest |out|, where plain TF32 or one bf16
// product keeps three or two decimal digits (tests/test_torch_grouped_
// matmul.py emulates the scheme on the CPU). Why bf16 and not 3xTF32:
// A(m, k) = lhs[k, m] and B(k, n) = g[k, n] are both MN-major in memory;
// bf16 wgmma reads MN-major operands from shared memory by its transpose
// bits, TF32 wgmma only K-major ones, so 3xTF32 would transpose both
// operands in the split pass. Why three planes: a two-way split (hh, hm,
// mh) leaves ~8e-6 of the largest |out| on the reference test's shapes,
// over its atol of 1e-4 there; the three-way split keeps ~2e-7 (both
// emulated in the same test file).
//
// Bound on this card: operations, the function's 2*R*M*H at the TF32
// rate (0.57 ms at phase 8's traffic); this design's floor is its six
// bf16 products (1.72 ms, as 3xTF32's three at 495 TFLOP/s). Next come
// the f32 loads: an expert's rows are read once per output tile column
// (8.9 GB from L2 at phase 8's traffic), which plain loads through
// registers or cp.async brought in too slowly (with the same products,
// K6 took 4.7 and 5.5 ms that way, 3.6 ms by TMA: PERF.md); and shared
// memory (a 32-row step lands 32 KB, writes 48 KB of split planes, and
// its products read 144 KB). Work: a persistent grid, one block per SM, walks
// the (expert, 128 lhs columns, 128 g columns) items expert-major, so an
// expert's rows stay in L2 while its 176 items run. Items contract over
// their expert's rows [offs[e], offs[e+1]), which start and end anywhere,
// in steps of 32 rows. Warpgroups 0 and 1 load and split: thread 0 issues
// TMA loads of a step's two f32 tiles ([32 rows][128 columns], row-major,
// columns past the matrix zero-filled) into a landing ring of kLand
// slots, kAhead steps ahead (across items: a block's next item's first
// steps follow its last); every one of the 256 threads reads its 8 + 8
// pairs of a landed step (rows of the next expert read as 0), frees the
// slot, and splits them into the six bf16 planes of a stage, in the
// 128-byte swizzle of an MN-major operand. Warpgroups 2 and 3 each own 64
// x 128 outputs in 64 f32 registers and issue a stage's 12 wgmma
// m64n128k16 products (A MN-major by its transpose bit); a ring of
// kStages plane stages with a "full" (256 splitting threads) and an
// "empty" (8 multiplying warps) mbarrier each lets the split run ahead of
// the products, and one item's stores overlap the next item's loads. An
// operand TMA cannot describe (a row pitch or base not a multiple of 16
// bytes, as 333 f32 columns) is landed instead by each thread's own 4- or
// 8-byte cp.async copies, zero-filled past the expert's rows, into the
// same layout (template parameter kTma). Accuracy over long experts:
// wgmma's f32 accumulation loses more per step than an f32 add rounded to
// nearest, so its error grew with the rows summed (1.9e-4 of the largest
// |out| on one 45056-row expert, over the 1e-4 limit). The accumulators
// therefore start from zero every kFlush steps and each chunk is added
// to the output tile in f32, which bounds the error by the square root
// of the chunk count; an expert of up to 1024 rows (phase 8's have
// 692-863) is one chunk and costs nothing. No atomics: a block owns its
// output tile, and the order of the sums is fixed. An empty expert is
// stored as exact zeros.
namespace tgmm90 {
constexpr int kTile = 128, kDepth = 32, kStages = 2, kAhead = 3;
constexpr int kLand = kAhead + 1;
constexpr int kFlush = 32;  // steps (1024 rows) summed in one accumulator
constexpr int kSplitters = 256, kThreads = 512;
constexpr int kPanel = kDepth * 128;        // [32 deep][64 columns] bf16
constexpr int kPlane = 2 * kPanel;          // [32 deep][128 columns]
constexpr int kStage = 6 * kPlane;          // A h, m, l then B h, m, l
constexpr int kRows = kDepth / (kSplitters / 64);  // rows a thread holds: 8
constexpr int kSlot = 2 * kDepth * kTile * 4;      // lhs then g, f32
constexpr size_t kSmem =
    1024 + kStages * kStage + kLand * kSlot + 2 * (kStages + kLand) * 8;
}  // namespace tgmm90

// cp.async of N (4 or 8) bytes from global to shared memory; `bytes` = 0
// writes N zero bytes and reads nothing
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(src), "n"(N), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// this thread's copies of all but the newest N groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Item w of the (expert, lhs column tile, g column tile) walk and its
// expert's rows [lo, hi); `ks` counts its 32-row steps.
struct TgmmStep {
  long long w;
  int ks, e, m0, n0, lo, hi, n_k;
};

__device__ __forceinline__ void tgmm_item(const GmmParams& p, int n_tiles,
                                          int tiles, long long w,
                                          TgmmStep& st) {
  st.w = w;
  st.ks = 0;
  st.e = static_cast<int>(w / tiles);
  const int t = static_cast<int>(w % tiles);
  st.m0 = (t / n_tiles) * tgmm90::kTile;
  st.n0 = (t % n_tiles) * tgmm90::kTile;
  st.lo = min(max(p.offsets[st.e], 0), p.rows);
  st.hi = max(min(p.offsets[st.e + 1], p.rows), st.lo);
  st.n_k = (st.hi - st.lo + tgmm90::kDepth - 1) / tgmm90::kDepth;
}

// The splitters' next step after `st`: its item's next one, or the first
// step of this block's next item with rows. False past the last item.
__device__ __forceinline__ bool tgmm_advance(const GmmParams& p, int n_tiles,
                                             int tiles, long long items,
                                             TgmmStep& st) {
  if (st.ks + 1 < st.n_k) {
    ++st.ks;
    return true;
  }
  for (long long w = st.w + gridDim.x; w < items; w += gridDim.x) {
    tgmm_item(p, n_tiles, tiles, w, st);
    if (st.n_k > 0) return true;
  }
  return false;
}

// Where a splitting thread's pairs of a landing tile are: columns 2 (t %
// 64) + {0, 1} of rows t / 64 + 4 i of the row-major [32][128] f32 tile,
// as TMA lands it.
__device__ __forceinline__ uint32_t tgmm_pair(int i) {
  return ((threadIdx.x / 64 + 4 * i) * tgmm90::kTile +
          2 * (threadIdx.x % 64)) * 4;
}

// The tile without TMA: the thread's own pairs of the [32 rows][128
// columns] f32 tile at (row0, col0) copied into `slot` by cp.async, 0
// outside rows [row0, row_hi) and past column col_hi. `pairs`: 8-byte
// copies stay aligned.
__device__ __forceinline__ void tgmm_copy(uint32_t slot, const float* base,
                                          long long ld, int row0,
                                          int row_hi, int col0, int col_hi,
                                          bool pairs) {
  const int c = col0 + 2 * (threadIdx.x % 64);
#pragma unroll
  for (int i = 0; i < tgmm90::kRows; ++i) {
    const int r = row0 + threadIdx.x / 64 + 4 * i;
    const uint32_t dst = slot + tgmm_pair(i);
    const bool ok0 = r < row_hi && c < col_hi;
    const bool ok1 = r < row_hi && c + 1 < col_hi;
    const float* q = ok0 ? base + r * ld + c : base;
    if (pairs) {
      cp_async<8>(dst, q, ok1 ? 8 : 0);
    } else {
      cp_async<4>(dst, q, ok0 ? 4 : 0);
      cp_async<4>(dst + 4, ok1 ? q + 1 : base, ok1 ? 4 : 0);
    }
  }
}

// The thread's own pairs of a landing tile whose first row is row0; rows
// from row_hi on (the next expert's, which TMA brings in) read as 0.
__device__ __forceinline__ void tgmm_read(float2 (&v)[tgmm90::kRows],
                                          const uint8_t* slot, int row0,
                                          int row_hi) {
#pragma unroll
  for (int i = 0; i < tgmm90::kRows; ++i) {
    const float2 x = *reinterpret_cast<const float2*>(slot + tgmm_pair(i));
    const bool live = row0 + static_cast<int>(threadIdx.x) / 64 + 4 * i <
                      row_hi;
    v[i] = live ? x : make_float2(0.f, 0.f);
  }
}

// Split the thread's values into the h, m and l planes at `planes` (kPlane
// bytes apart), each in the 128-byte swizzle of an MN-major operand.
__device__ __forceinline__ void tgmm_split(const float2 (&v)[tgmm90::kRows],
                                           uint8_t* planes) {
  using namespace tgmm90;
  const int col = 2 * (threadIdx.x % 64);
  uint8_t* at = planes + (col / 64) * kPanel;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const uint32_t off = hopper::sw128_offset(threadIdx.x / 64 + 4 * i,
                                              col % 64);
    float x = v[i].x, y = v[i].y;
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
      *reinterpret_cast<__nv_bfloat162*>(at + part * kPlane + off) = b;
      const float2 f = __bfloat1622float2(b);
      x -= f.x;
      y -= f.y;
    }
  }
}

template <bool kTma>
__global__ void __launch_bounds__(tgmm90::kThreads, 1)
    tgmm_split_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb, GmmParams p) {
  using namespace hopper;
  using namespace tgmm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align1024(smem_raw);
  uint8_t* land = stages + kStages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(land + kLand * kSlot);
  uint64_t* empty = full + kStages;
  uint64_t* land_full = empty + kStages;  // TMA: a landing slot is filled
  uint64_t* land_empty = land_full + kLand;  // ... and read by every thread
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kSplitters);
      mbar_init(&empty[s], 8);
    }
    for (int s = 0; s < kLand; ++s) {
      mbar_init(&land_full[s], 1);
      mbar_init(&land_empty[s], kSplitters);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const float* lhs = static_cast<const float*>(p.lhs);
  const float* g = static_cast<const float*>(p.rhs);
  const int M = p.lhs_cols, H = p.n_dim;
  const int n_tiles = (H + kTile - 1) / kTile;
  const int tiles = ((M + kTile - 1) / kTile) * n_tiles;
  const long long items = static_cast<long long>(p.experts) * tiles;
  Ring<kStages> ring;
  if (threadIdx.x < kSplitters) {
    const bool pairs_a =
        M % 2 == 0 && reinterpret_cast<uintptr_t>(lhs) % 8 == 0;
    const bool pairs_b =
        p.rhs_sk % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 8 == 0;
    TgmmStep st;  // the step being split
    st.w = blockIdx.x - static_cast<long long>(gridDim.x);
    st.ks = st.n_k = 0;
    bool have = tgmm_advance(p, n_tiles, tiles, items, st);
    TgmmStep cp = st;  // the next step to copy
    bool cp_have = have;
    uint32_t copied = 0;
    // TMA: thread 0 fills a slot once every thread has read it. cp.async:
    // one commit group per step, empty past the last, so that waiting for
    // all but the newest kAhead groups means: this step has landed
    auto copy_next = [&]() {
      if (cp_have) {
        const int k = copied % kLand;
        uint8_t* slot = land + k * kSlot;
        const int r0 = cp.lo + cp.ks * kDepth;
        if constexpr (kTma) {
          if (threadIdx.x == 0) {
            if (copied >= kLand)
              mbar_wait(&land_empty[k], (copied / kLand - 1) & 1);
            mbar_arrive_expect_tx(&land_full[k], kSlot);
            tma_load_2d(slot, &ta, &land_full[k], cp.m0, r0);
            tma_load_2d(slot + kSlot / 2, &tb, &land_full[k], cp.n0, r0);
          }
        } else {
          tgmm_copy(smem_u32(slot), lhs, M, r0, cp.hi, cp.m0, M, pairs_a);
          tgmm_copy(smem_u32(slot) + kSlot / 2, g, p.rhs_sk, r0, cp.hi,
                    cp.n0, H, pairs_b);
        }
        cp_have = tgmm_advance(p, n_tiles, tiles, items, cp);
      }
      if constexpr (!kTma) cp_async_commit();
      ++copied;
    };
    for (int d = 0; d < kAhead; ++d) copy_next();
    float2 va[kRows], vb[kRows];
    for (uint32_t j = 0; have; ++j) {
      copy_next();  // step j + kAhead
      const int k = j % kLand;
      if constexpr (kTma)
        mbar_wait(&land_full[k], (j / kLand) & 1);
      else
        cp_async_wait<kAhead>();
      const uint8_t* slot = land + k * kSlot;
      const int r0 = st.lo + st.ks * kDepth;
      tgmm_read(va, slot, r0, st.hi);
      tgmm_read(vb, slot + kSlot / 2, r0, st.hi);
      if constexpr (kTma) mbar_arrive(&land_empty[k]);
      const int s = ring.stage();
      if (ring.it >= kStages) mbar_wait(&empty[s], ring.phase() ^ 1);
      uint8_t* a = stages + s * kStage;
      tgmm_split(va, a);
      tgmm_split(vb, a + 3 * kPlane);
      fence_proxy_async();
      mbar_arrive(&full[s]);
      ++ring.it;
      have = tgmm_advance(p, n_tiles, tiles, items, st);
    }
    if constexpr (!kTma) cp_async_wait<0>();
    return;
  }
  const int ct = threadIdx.x - kSplitters, cw = ct / 128, lane = ct % 32;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    TgmmStep st;
    tgmm_item(p, n_tiles, tiles, w, st);
    float* out = static_cast<float*>(p.out) +
                 static_cast<long long>(st.e) * M * H;
    // chunks of kFlush steps, each summed from zero and added to the
    // output tile (an empty expert: one chunk of no step, stored as 0)
    for (int k0 = 0; k0 < max(st.n_k, 1); k0 += kFlush) {
      const int k1 = min(st.n_k, k0 + kFlush);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = k0; ks < k1; ++ks, ++ring.it) {
        const int s = ring.stage();
        mbar_wait(&full[s], ring.phase());
        const uint32_t a0 = smem_u32(stages + s * kStage) + cw * kPanel;
        const uint32_t b0 = smem_u32(stages + s * kStage + 3 * kPlane);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          // plane q of A / B at + q * kPlane; 16 deep rows = 2048 bytes
          const uint32_t ao = a0 + kk * 2048, bo = b0 + kk * 2048;
          const uint64_t ah = desc_mn_major(ao, kPanel);
          const uint64_t am = desc_mn_major(ao + kPlane, kPanel);
          const uint64_t al = desc_mn_major(ao + 2 * kPlane, kPanel);
          const uint64_t bh = desc_mn_major(bo, kPanel);
          const uint64_t bm = desc_mn_major(bo + kPlane, kPanel);
          const uint64_t bl = desc_mn_major(bo + 2 * kPlane, kPanel);
          wgmma_m64n128k16_ss<1, 1>(acc, am, bm, 1);
          wgmma_m64n128k16_ss<1, 1>(acc, ah, bl, 1);
          wgmma_m64n128k16_ss<1, 1>(acc, al, bh, 1);
          wgmma_m64n128k16_ss<1, 1>(acc, ah, bm, 1);
          wgmma_m64n128k16_ss<1, 1>(acc, am, bh, 1);
          wgmma_m64n128k16_ss<1, 1>(acc, ah, bh, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done with it
        release(empty, prev);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty, prev);
      // the accumulator layout of hopper.cuh: rows are lhs columns m. A
      // later chunk reads back what this thread stored for the earlier.
      const bool add = k0 > 0;
      const int ra = st.m0 + cw * 64 + ((ct % 128) / 32) * 16 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = ra + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int c = 0; c < kTile / 8; ++c) {
          const int n = st.n0 + 8 * c + 2 * (lane % 4);
          float x = acc[4 * c + 2 * h], y = acc[4 * c + 2 * h + 1];
          float* q = out + static_cast<long long>(m) * H + n;
          if (H % 2 == 0 && n + 1 < H) {
            float2* q2 = reinterpret_cast<float2*>(q);
            if (add) {
              const float2 o = *q2;
              x += o.x;
              y += o.y;
            }
            *q2 = make_float2(x, y);
          } else {
            if (n < H) q[0] = add ? q[0] + x : x;
            if (n + 1 < H) q[1] = add ? q[1] + y : y;
          }
        }
      }
    }
  }
}

template <bool kTma>
cudaError_t launch_tgmm_split(const CUtensorMap& ta, const CUtensorMap& tb,
                              const GmmParams& p, int grid,
                              cudaStream_t stream) {
  auto kernel = tgmm_split_kernel<kTma>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tgmm90::kSmem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, tgmm90::kThreads, tgmm90::kSmem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// p.tma_lhs: 1 = both f32 operands by TMA (16-byte aligned bases and row
// pitches), 0 = both by cp.async
cudaError_t run_tgmm_split(const GmmParams& p, cudaStream_t stream) {
  using tgmm90::kDepth;
  using tgmm90::kTile;
  CUtensorMap ta, tb;
  cudaError_t e = cudaSuccess;
  if (p.tma_lhs) {
    const cuuint64_t da[2] = {static_cast<cuuint64_t>(p.lhs_cols),
                              static_cast<cuuint64_t>(p.rows)};
    const cuuint64_t sa[1] = {static_cast<cuuint64_t>(p.lhs_cols) * 4};
    const cuuint64_t db[2] = {static_cast<cuuint64_t>(p.n_dim),
                              static_cast<cuuint64_t>(p.rows)};
    const cuuint64_t sb[1] = {static_cast<cuuint64_t>(p.rhs_sk) * 4};
    const cuuint32_t box[2] = {kTile, kDepth};
    e = hopper::make_map(&ta, p.lhs, 2, da, sa, box,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e == cudaSuccess)
      e = hopper::make_map(&tb, p.rhs, 2, db, sb, box,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(p.experts) *
                          ((p.lhs_cols + kTile - 1) / kTile) *
                          ((p.n_dim + kTile - 1) / kTile);
  const int grid = static_cast<int>(items < sms ? items : sms);
  if (p.tma_lhs) return launch_tgmm_split<true>(ta, tb, p, grid, stream);
  return launch_tgmm_split<false>(ta, tb, p, grid, stream);
}

// ======== K8 in bf16: wgmma fed by TMA, persistent, over block runs ========
// out[e] = sum over e's row blocks of lhs_block^T @ g_block, bf16 in, f32
// out. Products of bf16 values are exact and wgmma sums them in f32
// accumulators, so no split is needed (K6's f32 inputs need three planes).
// Expert e's rows are the run [offsets[e], offsets[e+1]) of its blocks in
// block_experts, computed on the device as K7's (`_aligned_offsets`; the
// trailing blocks clamped to E - 1 are E - 1's rows). A persistent grid of
// one block per SM walks the (expert, 128 lhs columns, 128 g columns)
// items expert-major, as K6 does, so an expert's rows stay in L2 while its
// items run; an expert that owns no block has no step and is left
// unwritten, as on the TPU. Warpgroup 0 loads: steps of 64 rows of lhs
// [64 rows][128 columns] and g [64 rows][128 columns], each two swizzled
// 64-column panels, which are the MN-major A (lhs^T: A(m, k) = lhs[k, m])
// and B (g) of wgmma m64n128k16 read by the transpose bits, through a
// ring of kStages stages with "full" and "empty" mbarriers (loads run
// ahead across items). By TMA from 2-D maps [R, M] and [R, H] (a box may
// start at any row; columns past the matrix zero-filled), thread 0 alone;
// where TMA cannot describe an operand (a row pitch or base not a
// multiple of 16 bytes, as 333 columns) all 128 loader threads stage both
// through registers, rows past the expert as 0 (template parameter kTma).
// Warpgroups 1 and 2 each own 64 lhs columns x 128 g columns in 64 f32
// registers. The last step of an expert whose rows are not a multiple of
// 64 holds rows of the next expert: with TMA, each computing warpgroup
// zeroes those rows of its own A panel before its products (generic
// stores, then a proxy fence). Accuracy over long experts: wgmma's f32
// accumulation loses more per step than an f32 add rounded to nearest
// (1.87e-4 of the largest |out| over a 45056-row expert in K6), so the
// accumulators restart every kFlush steps (1024 rows) and each chunk is
// added to the output tile in f32, as K6 does. Bound: bytes, by the f32
// output (E * M * H * 4 bytes) and the inputs read once.
namespace tgmma90 {
constexpr int kTile = 128, kDepth = 64, kStages = 4;
constexpr int kFlush = 16;  // steps (1024 rows) summed in one accumulator
constexpr int kThreads = 384;
constexpr int kPanel = kDepth * 128;  // [64 rows][64 columns] bf16
constexpr int kOperand = 2 * kPanel;  // [64 rows][128 columns]
constexpr int kStage = 2 * kOperand;  // lhs then g
constexpr size_t kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
}  // namespace tgmma90

// Item w of the walk: expert e, columns m0.. of lhs and n0.. of g, the
// expert's rows [lo, hi) in n_k steps of 64.
struct TgmmAlignedItem {
  int e, m0, n0, lo, hi, n_k;
};

__device__ __forceinline__ TgmmAlignedItem tgmm_aligned_item(
    const GmmParams& p, int n_tiles, int tiles, long long w) {
  TgmmAlignedItem it;
  it.e = static_cast<int>(w / tiles);
  const int t = static_cast<int>(w % tiles);
  it.m0 = (t / n_tiles) * tgmma90::kTile;
  it.n0 = (t % n_tiles) * tgmma90::kTile;
  it.lo = min(max(p.offsets[it.e], 0), p.rows);
  it.hi = max(min(p.offsets[it.e + 1], p.rows), it.lo);
  it.n_k = (it.hi - it.lo + tgmma90::kDepth - 1) / tgmma90::kDepth;
  return it;
}

// Rows r0 .. r0 + 63 (below hi) and columns c0 .. c0 + 127 (below cols) of
// a row-major bf16 [rows, ld] operand into the two swizzled panels at dst,
// 0 elsewhere; by the 128 threads of warpgroup 0.
__device__ __forceinline__ void tgmm_aligned_stage(uint8_t* dst,
                                                   const bf16* src,
                                                   long long ld, int r0,
                                                   int hi, int c0,
                                                   int cols) {
  using namespace tgmma90;
  for (int i = threadIdx.x; i < kDepth * kTile; i += 128) {
    const int r = i / kTile, c = i % kTile;
    const int row = r0 + r, col = c0 + c;
    bf16 v = __float2bfloat16(0.f);
    if (row < hi && col < cols) v = src[row * ld + col];
    *reinterpret_cast<bf16*>(dst + (c / 64) * kPanel +
                             hopper::sw128_offset(r, c % 64)) = v;
  }
}

template <bool kTma>
__global__ void __launch_bounds__(tgmma90::kThreads, 1)
    tgmm_aligned_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                              const __grid_constant__ CUtensorMap tb,
                              GmmParams p) {
  using namespace hopper;
  using namespace tgmma90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int M = p.lhs_cols, H = p.n_dim;
  const int n_tiles = (H + kTile - 1) / kTile;
  const int tiles = ((M + kTile - 1) / kTile) * n_tiles;
  const long long items = static_cast<long long>(p.experts) * tiles;
  const int wg = threadIdx.x / 128;
  Ring<kStages> ring;
  if (wg == 0) {  // the loader
    if (kTma && threadIdx.x != 0) return;
    const bf16* lhs = static_cast<const bf16*>(p.lhs);
    const bf16* g = static_cast<const bf16*>(p.rhs);
    for (long long w = blockIdx.x; w < items; w += gridDim.x) {
      const TgmmAlignedItem it = tgmm_aligned_item(p, n_tiles, tiles, w);
      for (int ks = 0; ks < it.n_k; ++ks, ++ring.it) {
        const int s = ring.stage();
        if (ring.it >= kStages) mbar_wait(&empty[s], ring.phase() ^ 1);
        uint8_t* a = stages + s * kStage;
        uint8_t* b = a + kOperand;
        const int r0 = it.lo + ks * kDepth;
        if constexpr (kTma) {
          mbar_arrive_expect_tx(&full[s], kStage);
          tma_load_2d(a, &ta, &full[s], it.m0, r0);
          tma_load_2d(a + kPanel, &ta, &full[s], it.m0 + 64, r0);
          tma_load_2d(b, &tb, &full[s], it.n0, r0);
          tma_load_2d(b + kPanel, &tb, &full[s], it.n0 + 64, r0);
        } else {
          tgmm_aligned_stage(a, lhs, M, r0, it.hi, it.m0, M);
          tgmm_aligned_stage(b, g, p.rhs_sk, r0, it.hi, it.n0, H);
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  const int cw = wg - 1, ct = threadIdx.x - 128, lane = ct % 32;
  const int t = ct % 128;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const TgmmAlignedItem it = tgmm_aligned_item(p, n_tiles, tiles, w);
    if (it.n_k == 0) continue;  // no block: left unwritten
    float* out = static_cast<float*>(p.out) +
                 static_cast<long long>(it.e) * M * H;
    for (int k0 = 0; k0 < it.n_k; k0 += kFlush) {
      const int k1 = min(it.n_k, k0 + kFlush);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = k0; ks < k1; ++ks, ++ring.it) {
        const int s = ring.stage();
        mbar_wait(&full[s], ring.phase());
        uint8_t* a = stages + s * kStage + cw * kPanel;
        const int valid = it.hi - (it.lo + ks * kDepth);
        if (kTma && valid < kDepth) {
          // rows of the next expert in this warpgroup's A panel: zeros
          for (int i = t; i < (kDepth - valid) * 8; i += 128)
            *reinterpret_cast<uint4*>(a + valid * 128 + 16 * i) =
                make_uint4(0, 0, 0, 0);
          fence_proxy_async();
          warpgroup_sync(cw);
        }
        const uint32_t a0 = smem_u32(a);
        const uint32_t b0 = smem_u32(stages + s * kStage + kOperand);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk)
          wgmma_m64n128k16_ss<1, 1>(acc, desc_mn_major(a0 + kk * 2048, kPanel),
                                    desc_mn_major(b0 + kk * 2048, kPanel), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done with it
        release(empty, prev);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty, prev);
      // rows of the accumulator are lhs columns m; a later chunk reads
      // back what this thread stored for the earlier
      const bool add = k0 > 0;
      const int ra = it.m0 + cw * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = ra + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int c = 0; c < kTile / 8; ++c) {
          const int n = it.n0 + 8 * c + 2 * (lane % 4);
          float x = acc[4 * c + 2 * h], y = acc[4 * c + 2 * h + 1];
          float* q = out + static_cast<long long>(m) * H + n;
          if (H % 2 == 0 && n + 1 < H) {
            float2* q2 = reinterpret_cast<float2*>(q);
            if (add) {
              const float2 o = *q2;
              x += o.x;
              y += o.y;
            }
            *q2 = make_float2(x, y);
          } else {
            if (n < H) q[0] = add ? q[0] + x : x;
            if (n + 1 < H) q[1] = add ? q[1] + y : y;
          }
        }
      }
    }
  }
}

template <bool kTma>
cudaError_t launch_tgmm_aligned_wgmma(const CUtensorMap& ta,
                                      const CUtensorMap& tb,
                                      const GmmParams& p, int grid,
                                      cudaStream_t stream) {
  auto kernel = tgmm_aligned_wgmma_kernel<kTma>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tgmma90::kSmem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, tgmma90::kThreads, tgmma90::kSmem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// p.offsets: the runs of block_experts (E + 2 entries); p.tma_lhs: 1 = both
// operands by TMA, 0 = both staged through registers
cudaError_t run_tgmm_aligned_wgmma(const GmmParams& p, cudaStream_t stream) {
  using tgmma90::kDepth;
  using tgmma90::kTile;
  if (p.offsets == nullptr) return cudaErrorInvalidValue;
  if (p.rows == 0) return cudaSuccess;
  CUtensorMap ta, tb;
  cudaError_t e = cudaSuccess;
  if (p.tma_lhs) {
    const cuuint64_t da[2] = {static_cast<cuuint64_t>(p.lhs_cols),
                              static_cast<cuuint64_t>(p.rows)};
    const cuuint64_t sa[1] = {static_cast<cuuint64_t>(p.lhs_cols) * 2};
    const cuuint64_t db[2] = {static_cast<cuuint64_t>(p.n_dim),
                              static_cast<cuuint64_t>(p.rows)};
    const cuuint64_t sb[1] = {static_cast<cuuint64_t>(p.rhs_sk) * 2};
    const cuuint32_t box[2] = {64, kDepth};
    e = hopper::make_map(&ta, p.lhs, 2, da, sa, box);
    if (e == cudaSuccess) e = hopper::make_map(&tb, p.rhs, 2, db, sb, box);
  }
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(p.experts) *
                          ((p.lhs_cols + kTile - 1) / kTile) *
                          ((p.n_dim + kTile - 1) / kTile);
  const int grid = static_cast<int>(items < sms ? items : sms);
  if (p.tma_lhs)
    return launch_tgmm_aligned_wgmma<true>(ta, tb, p, grid, stream);
  return launch_tgmm_aligned_wgmma<false>(ta, tb, p, grid, stream);
}

// K7. grid (column tiles, row tiles). Runs of equal block_experts inside
// the tile are multiplied one after the other.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) gmm_aligned_kernel(GmmParams p) {
  __shared__ __align__(16) Tiles s;
  const int r0 = blockIdx.y * kBM, r1 = min(r0 + kBM, p.rows);
  const int n0 = blockIdx.x * kBN;
  const View<TA> a{static_cast<const TA*>(p.lhs), p.lhs_cols, 1};
  float* out = static_cast<float*>(p.out);
  const int* be = p.block_experts;
  float acc[8][8];
  for (int r = r0; r < r1;) {
    const int blk = r / p.bm;
    int next = blk + 1;
    while (next * p.bm < r1 && be[next] == be[blk]) ++next;
    const int g1 = min(r1, next * p.bm);
    const int e = min(max(be[blk], 0), p.experts - 1);
    product(acc, s, a, r0, r, g1, expert_matrix<TB>(p, e), n0, p.n_dim,
            0, p.lhs_cols);
    store(acc, out, p.n_dim, r0, r, g1, n0, p.n_dim);
    r = g1;
  }
}

// K8. grid (column tiles, lhs-column tiles, experts). The blocks of expert
// e are the run [b_lo, b_hi) of the non-decreasing block_experts.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) tgmm_aligned_kernel(GmmParams p) {
  __shared__ __align__(16) Tiles s;
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int* be = p.block_experts;
  const int nb = p.rows / p.bm;
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (be[mid] >= e)
      hi = mid;
    else
      lo = mid + 1;
  }
  const int b_lo = lo;
  hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (be[mid] > e)
      hi = mid;
    else
      lo = mid + 1;
  }
  const int b_hi = lo;
  if (b_lo >= b_hi) return;  // no block: left unwritten, as on the TPU
  const View<TA> a{static_cast<const TA*>(p.lhs), 1, p.lhs_cols};
  const View<TB> b{static_cast<const TB*>(p.rhs), p.rhs_sk, p.rhs_sn};
  float acc[8][8];
  product(acc, s, a, m0, 0, p.lhs_cols, b, n0, p.n_dim, b_lo * p.bm,
          b_hi * p.bm);
  float* out = static_cast<float*>(p.out) +
               static_cast<long long>(e) * p.lhs_cols * p.n_dim;
  store(acc, out, p.n_dim, m0, 0, p.lhs_cols, n0, p.n_dim);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, const GmmParams& p,
                   cudaStream_t stream) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// which: 0 = K5, 1 = K6, 2 = K7, 3 = K8. Dtype codes: 0 = f32, 1 = bf16.
int dispatch(int which, const GmmParams* p, void* stream) {
  if (p == nullptr || p->rows < 0 || p->lhs_cols < 1 || p->n_dim < 1 ||
      p->experts < 1 || p->bm < 1 || p->rows % p->bm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned row_tiles = (p->rows + kBM - 1) / kBM;
  const unsigned m_tiles = (p->lhs_cols + kBM - 1) / kBM;
  const unsigned n_tiles = (p->n_dim + kBN - 1) / kBN;
  if (row_tiles > 65535 || m_tiles > 65535 || p->experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int mix = p->lhs_dtype * 2 + p->rhs_dtype;  // 0 ff, 1 fb, 3 bb
  const dim3 rows_grid(n_tiles, row_tiles), expert_grid(n_tiles, m_tiles,
                                                        p->experts);
  switch (which * 4 + mix) {
    case 0 * 4 + 0:
      return launch(gmm_kernel<float, float>, rows_grid, *p, st);
    case 0 * 4 + 1:
      return launch(gmm_kernel<float, bf16>, rows_grid, *p, st);
    case 0 * 4 + 3:  // bf16 on the tensor cores; f32 lhs stays on FMA
      return run_gmm_wgmma(*p, st);
    case 1 * 4 + 0:  // f32 on the tensor cores by a three-way bf16 split
      return run_tgmm_split(*p, st);
    case 2 * 4 + 0:
      return launch(gmm_aligned_kernel<float, float>, rows_grid, *p, st);
    case 2 * 4 + 1:
      return launch(gmm_aligned_kernel<float, bf16>, rows_grid, *p, st);
    case 2 * 4 + 3:  // bf16: K5's kernel over the runs of block_experts
      return run_gmm_wgmma(*p, st);
    case 3 * 4 + 0:
      return launch(tgmm_aligned_kernel<float, float>, expert_grid, *p, st);
    case 3 * 4 + 3:  // bf16 in: wgmma over the block runs (offsets)
      return run_tgmm_aligned_wgmma(*p, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t value (0 on a launch that was accepted); the
// Python wrapper raises on anything else.
int gmm_launch(const GmmParams* p, void* stream) {
  return dispatch(0, p, stream);
}
int tgmm_launch(const GmmParams* p, void* stream) {
  return dispatch(1, p, stream);
}
int gmm_aligned_launch(const GmmParams* p, void* stream) {
  return dispatch(2, p, stream);
}
int tgmm_aligned_launch(const GmmParams* p, void* stream) {
  return dispatch(3, p, stream);
}

// The K5 tile list of `offsets` (groups + 1 entries) into `tiles`
// (3 * max_tiles ints).
int gmm_tiles_launch(const int* offsets, int groups, int rows, int max_tiles,
                     int* tiles, void* stream) {
  if (offsets == nullptr || tiles == nullptr || groups < 1 || rows < 0 ||
      max_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gmm_tiles_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, groups, rows, max_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
