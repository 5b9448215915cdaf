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
// written whole. Here every thread block owns its output tile outright:
// K5/K7 run one block per (128 output rows, 128 output columns); the block
// finds the groups that meet its rows (binary search over offsets, or the
// runs of block_experts), multiplies each group's rows by its expert's
// matrix and stores those rows only. Groups are disjoint in rows, so no
// two blocks write the same element and nothing is accumulated across
// blocks. K6/K8 run one block per (expert, 128 x 128 tile of [M, H]) and
// loop over that expert's rows, so the reduction over a variable number of
// rows needs no atomics and its order does not depend on scheduling. A hot
// expert makes its blocks long: that is left to the PR that makes these
// fast. `bm` is the API's divisibility and layout unit; the CUDA tile
// height (128) is this file's own and results do not depend on it.
//
// Every load is masked: a row of another group, a row past the group, a
// column past the matrix and a depth past the contraction read as 0 (K6
// masks lhs and g alike, as the reference's `where` at :205-206 does).
//
// Arithmetic: tiles of 128 x 16 (A) and 16 x 128 (B) are staged in shared
// memory as f32 and multiplied by register-tiled FMA loops: thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + {0..3, 64..67} and
// columns tx*4 + {0..3, 64..67} of the tile, 64 f32 accumulators. Products
// of bf16 values are exact in f32, so this is the f32-accumulated dot of
// the TPU kernels (`preferred_element_type=f32`), with its sums in another
// order. Outputs are rounded once, to nearest even.
//
// Bound on this card: operations. At DeepSeekMoE-16B's expert widths
// (M=2048, H=1408) and R = 49152 routed rows, K5 does 2*R*M*H = 2.8e11
// flops against ~0.7 GB of traffic in bf16, far above the H100's ridge of
// ~295 flops per byte. These first kernels use no tensor cores: the FMA
// loops run at the f32 rate at best (67 TFLOP/s) and bf16 inputs are
// widened in shared memory. mma/wgmma on bf16 tiles with TMA loads are the
// next step (PERF.md holds the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Launch parameters, filled field for field by the Python wrapper's ctypes
// mirror (_Params). At global scope so the extern "C" entry points that
// take it keep external linkage.
struct GmmParams {
  const void* lhs;
  const void* rhs;            // gmm: rhs [E, lhs_cols, n_dim]; tgmm: g
  const int* offsets;         // K5, K6
  const int* block_experts;   // K7, K8
  void* out;
  long long rhs_se, rhs_sk, rhs_sn;  // element strides of rhs (or g)
  int rows, lhs_cols, n_dim, experts, bm, lhs_dtype, rhs_dtype;
};

namespace {

constexpr int kBM = 128;  // output rows (K5/K7) or lhs columns (K6/K8)
constexpr int kBN = 128;  // output columns
constexpr int kBK = 16;   // contraction depth staged per step
constexpr int kPad = 4;   // keeps float4 rows aligned, spreads banks
constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
template <typename TO>
__device__ void store(const float (&acc)[8][8], TO* out, long long ld, int m0,
                      int m_lo, int m_hi, int n0, int n_hi) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + row_of(i);
    if (m < m_lo || m >= m_hi) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + col_of(j);
      if (n < n_hi) out[m * ld + n] = from_f<TO>(acc[i][j]);
    }
  }
}

template <typename TO>
__device__ void store_zeros(TO* out, long long ld, int m_lo, int m_hi, int n0,
                            int n_hi) {
  for (int i = threadIdx.x; i < (m_hi - m_lo) * kBN; i += kThreads) {
    const int m = m_lo + i / kBN, n = n0 + i % kBN;
    if (n < n_hi) out[m * ld + n] = from_f<TO>(0.f);
  }
}

template <typename TB>
__device__ __forceinline__ View<TB> expert_matrix(const GmmParams& p, int e) {
  return View<TB>{static_cast<const TB*>(p.rhs) + e * p.rhs_se, p.rhs_sk,
                  p.rhs_sn};
}

// K5. grid (column tiles, row tiles).
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads) gmm_kernel(GmmParams p) {
  __shared__ __align__(16) Tiles s;
  const int r0 = blockIdx.y * kBM, r1 = min(r0 + kBM, p.rows);
  const int n0 = blockIdx.x * kBN;
  const View<TA> a{static_cast<const TA*>(p.lhs), p.lhs_cols, 1};
  TO* out = static_cast<TO*>(p.out);
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

// K7. grid (column tiles, row tiles). Runs of equal block_experts inside
// the tile are multiplied one after the other.
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads) gmm_aligned_kernel(GmmParams p) {
  __shared__ __align__(16) Tiles s;
  const int r0 = blockIdx.y * kBM, r1 = min(r0 + kBM, p.rows);
  const int n0 = blockIdx.x * kBN;
  const View<TA> a{static_cast<const TA*>(p.lhs), p.lhs_cols, 1};
  TO* out = static_cast<TO*>(p.out);
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

// K6. grid (column tiles, lhs-column tiles, experts).
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) tgmm_kernel(GmmParams p) {
  __shared__ __align__(16) Tiles s;
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_lo = min(p.offsets[e], p.rows);
  const int k_hi = min(p.offsets[e + 1], p.rows);
  // A(m, k) = lhs[k, m]; B(k, n) = g[k, n]
  const View<TA> a{static_cast<const TA*>(p.lhs), 1, p.lhs_cols};
  const View<TB> b{static_cast<const TB*>(p.rhs), p.rhs_sk, p.rhs_sn};
  float acc[8][8];
  product(acc, s, a, m0, 0, p.lhs_cols, b, n0, p.n_dim, k_lo, k_hi);
  float* out = static_cast<float*>(p.out) +
               static_cast<long long>(e) * p.lhs_cols * p.n_dim;
  store(acc, out, p.n_dim, m0, 0, p.lhs_cols, n0, p.n_dim);
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

using bf16 = __nv_bfloat16;

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
      return launch(gmm_kernel<float, float, float>, rows_grid, *p, st);
    case 0 * 4 + 1:
      return launch(gmm_kernel<float, bf16, float>, rows_grid, *p, st);
    case 0 * 4 + 3:
      return launch(gmm_kernel<bf16, bf16, bf16>, rows_grid, *p, st);
    case 1 * 4 + 0:
      return launch(tgmm_kernel<float, float>, expert_grid, *p, st);
    case 2 * 4 + 0:
      return launch(gmm_aligned_kernel<float, float, float>, rows_grid, *p,
                    st);
    case 2 * 4 + 1:
      return launch(gmm_aligned_kernel<float, bf16, float>, rows_grid, *p, st);
    case 2 * 4 + 3:
      return launch(gmm_aligned_kernel<bf16, bf16, bf16>, rows_grid, *p, st);
    case 3 * 4 + 0:
      return launch(tgmm_aligned_kernel<float, float>, expert_grid, *p, st);
    case 3 * 4 + 3:
      return launch(tgmm_aligned_kernel<bf16, bf16>, expert_grid, *p, st);
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

const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
