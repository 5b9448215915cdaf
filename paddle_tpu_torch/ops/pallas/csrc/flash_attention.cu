// Flash attention for Hopper, sm_90a: forward (K1), dq (K2) and dk/dv (K3).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K1 `_fwd_kernel` (:242, launched by `_fwd` at :386),
//   K2 `_dq_kernel`  (:410, launched by `_bwd` at :575),
//   K3 `_dkv_kernel` (:471, launched by `_bwd` at :640).
// They compute the same functions: attention with an online softmax in
// f32 over k tiles; causal masking with the kv/q length offset
// (q + (Sk - Sq) >= k); segment ids; a row ([.., 1, Sk]) or full additive
// f32 bias; post-softmax dropout from the murmur position hash; native GQA
// (a q head reads its kv head, nothing is replicated). The backward takes
// lse and delta = rowsum(do * o) as inputs and recomputes p = exp(s - lse).
//
// Layouts (row-major, contiguous):
//   q, o, do, dq  [B*Hq, Sq, D]      k, v, dk, dv  [B*Hkv, Sk, D]
//   lse, delta    [B*Hq, Sq] f32     bias [Bb*Hb, rows, Sk] f32, rows 1 or Sq
//   q_seg [B, Sq], kv_seg [B, Sk] int32
// Flat q head bh = b*Hq + h reads kv head b*Hkv + h / (Hq/Hkv).
//
// Work assignment: K1 and K2 run one block per (flat q head, q tile) and
// loop over the live k tiles; K3 runs one block per (flat kv head, k tile)
// and loops over every (q head of the group, q tile) pair, so the GQA
// group is reduced inside the block and dk/dv are written once, with no
// atomics.
//
// Numerics follow the TPU kernels: scores are masked to kMask and clamped
// at it; a row with no segment-live key in a tile adds no p; in bf16 (f16)
// the p of the PV product (K1), p_drop of dv and ds of dq/dk (K2, K3) are
// rounded to bf16 (f16) before their product, as the TPU kernels cast them
// before their MXU dots, and every product accumulates in f32. Rows past
// Sq and keys past Sk (the ragged edge of a tile) are masked out: they
// add nothing and are not written. A tile that is dead by causality or
// that holds no equal segment id adds nothing, as on the TPU.
//
// The visited keys: the backward recomputes p = exp(s - lse) on the
// (64-row q tile, 64-key tile) pairs the forward visits - the key tiles
// below live_k_tiles of the q tile, with segment ids only those holding
// an equal id - and p is exactly 0 outside them. Inside them a row whose
// every visible score is masked by the bias has lse = kMask and p = 1 on
// every key below Sk (the TPU kernels average v over the keys of the
// tiles they visit), so every kernel, FMA or wgmma, visits exactly these
// pairs whatever its own block shape.
//
// Bound on this card: operations. At the training shape (B=4, S=2048,
// Hq=16, Hkv=4, D=128, causal, bf16) K1 does 2 products of 2*Sq*Sk*D/2
// flops per head (68.7 GFLOP), K2 3 (103 GFLOP) and K3 4 (137 GFLOP),
// against 84-118 MB of traffic: far above the H100's ridge of ~295 flops
// per byte, so 0.069, 0.104 and 0.139 ms at 989 TFLOP/s.
//
// Two designs, chosen by an explicit dispatch on dtype in run(). In bf16,
// K1 (`flash_fwd_wgmma_kernel`), K2 (`flash_dq_wgmma_kernel`) and K3
// (`flash_dkv_wgmma_kernel`) run their products on the bf16 tensor cores
// through wgmma, tiles brought in by TMA through rings of shared-memory
// stages, loads overlapped with the products (their notes below). The same
// three kernels, templated on the element type E, serve f16 (what
// auto_cast(dtype="float16") sends them): wgmma's .f16 kind on the same
// m64nNk16 shapes, f16 TMA maps, and P and dS packed to f16 where bf16 packs
// them, with f32 accumulation as in bf16. f16's narrower range matters for
// dS, which the TPU kernels also cast to the input dtype. In f32
// the three run register-tiled FMA loops, at the f32 rate at best (67
// TFLOP/s): 256 threads, tiles of 64 q rows x 64 keys held in shared
// memory as f32, thread (ty, tx) = (tid / 16, tid % 16) owning rows
// ty*4..ty*4+3 and columns tx*4 + 64*j + 0..3 of its output tile, a score
// row in the 16 lanes of one half-warp. The f32 instances stay on FMA
// because the tensor cores' TF32 would miss their tolerances (PERF.md
// holds the times).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

// Launch parameters, filled field for field by the Python wrapper's
// ctypes mirror (_Params). Declared outside the anonymous namespace so the
// extern "C" entry points that take it keep external linkage.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* bias;
  const int* q_seg;
  const int* kv_seg;
  void* out0;      // o (K1), dq (K2), dk (K3)
  void* out1;      // dv (K3)
  float* lse_out;  // lse (K1)
  int bhq, bhkv, sq, sk, hq, hkv, head_dim, dtype;
  int causal, has_bias, bias_bb, bias_hb, bias_rows, has_seg, has_dropout;
  unsigned int threshold, seed;
  float sm_scale, drop_scale;
};

namespace {

// finite stand-in for -inf (the TPU kernels' _MASK_VALUE)
constexpr float kMask = -0.7f * FLT_MAX;
constexpr int kTile = 64;      // q rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // row padding of row-major smem tiles
constexpr int kLP = kTile + kPad;


// element conversions of the FMA kernels, which run in f32 only (run())
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to T and back (the TPU kernels' `.astype(dtype)` before a dot)
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// The dropout keep bit of (flat q head, q position, k position): the
// murmur3-style hash of the TPU kernels' _dropout_keep (:197), in uint32.
__device__ __forceinline__ bool keep_bit(uint32_t bh, uint32_t qi,
                                         uint32_t ki, uint32_t seed,
                                         uint32_t threshold) {
  uint32_t x = qi * 0x9E3779B9u;
  x ^= ki * 0xC2B2AE35u;
  x ^= bh * 0x85EBCA6Bu;
  x ^= seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int half_warp_or(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows row0.. of an [n, D] tensor into dst[kTile][D + kPad] as f32;
// rows at or past n are zero
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int row0, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    dst[r * (D + kPad) + c] =
        g < n ? to_f(src[static_cast<long long>(g) * D + c]) : 0.f;
  }
}

// the same rows transposed, dst[D][kTile]: consecutive threads take
// consecutive rows, so the shared-memory writes do not conflict
template <typename T, int D>
__device__ void load_rows_t(float* dst, const T* src, int row0, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e % kTile, c = e / kTile;
    const int g = row0 + r;
    dst[c * kTile + r] =
        g < n ? to_f(src[static_cast<long long>(g) * D + c]) : 0.f;
  }
}

// acc[i][j] += sum_k A(ty*4+i, k) * B(k, tx*4 + 64*(j/4) + j%4) with
// A row-major (a[i*lda + k]) and B k-major (b[k*ldb + j]).
template <int NJ>
__device__ __forceinline__ void fma_tile_rowA(float (&acc)[4][4 * NJ],
                                              const float* a, int lda,
                                              const float* b, int ldb,
                                              int depth, int ty, int tx) {
  const float* a0 = a + ty * 4 * lda;
  const float* b0 = b + tx * 4;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a0[i * lda + k];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b0 + k * ldb + 64 * jj);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * jj + 0] += av[i] * bv.x;
        acc[i][4 * jj + 1] += av[i] * bv.y;
        acc[i][4 * jj + 2] += av[i] * bv.z;
        acc[i][4 * jj + 3] += av[i] * bv.w;
      }
    }
  }
}

// as fma_tile_rowA with A k-major (a[k*lda + i])
template <int NJ>
__device__ __forceinline__ void fma_tile_colA(float (&acc)[4][4 * NJ],
                                              const float* a, int lda,
                                              const float* b, int ldb,
                                              int depth, int ty, int tx) {
  const float* a0 = a + ty * 4;
  const float* b0 = b + tx * 4;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(a0 + k * lda);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b0 + k * ldb + 64 * jj);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * jj + 0] += av[i] * bv.x;
        acc[i][4 * jj + 1] += av[i] * bv.y;
        acc[i][4 * jj + 2] += av[i] * bv.z;
        acc[i][4 * jj + 3] += av[i] * bv.w;
      }
    }
  }
}

// Per-(q row, key) masking shared by the three kernels, so the backward
// recomputes exactly the forward's scores (_masked_scores, :171).
struct Masker {
  const float* bias_head;  // bias rows of this q head, or null
  const int* kv_seg;       // kv segment ids of this batch row, or null
  int sq, sk, offset, causal, bias_rows;
  float sm_scale;

  __device__ __forceinline__ Masker(const FlashParams& p, const float* bias,
                                    const int* kvseg)
      : bias_head(bias), kv_seg(kvseg), sq(p.sq), sk(p.sk),
        offset(p.sk - p.sq), causal(p.causal), bias_rows(p.bias_rows),
        sm_scale(p.sm_scale) {}

  // The masked, clamped score of (qpos, kpos); *seg_live says whether the
  // pair is in range and (with segment ids) of equal ids. Pairs past the
  // ragged edge score kMask, so they never raise a row's max.
  __device__ __forceinline__ float score(float dot, int qpos, int kpos,
                                         int qseg, bool* seg_live) const {
    const bool in = qpos < sq && kpos < sk;
    float s = dot * sm_scale;
    if (bias_head != nullptr && in)
      s += bias_head[static_cast<long long>(bias_rows == 1 ? 0 : qpos) * sk +
                     kpos];
    bool seg = in;
    if (kv_seg != nullptr) {
      seg = in && qseg == kv_seg[kpos];
      if (!seg) s = kMask;
    }
    *seg_live = seg;
    if (!in || (causal && qpos + offset < kpos)) s = kMask;
    return fmaxf(s, kMask);
  }
};

// bias rows of flat q head bh (the TPU kernels' bias_of)
__device__ __forceinline__ const float* bias_of(const FlashParams& p, int bh) {
  if (!p.has_bias) return nullptr;
  const int bb = p.bias_bb > 1 ? bh / p.hq : 0;
  const int hh = p.bias_hb > 1 ? bh % p.hq : 0;
  return p.bias +
         static_cast<long long>(bb * p.bias_hb + hh) * p.bias_rows * p.sk;
}

// Does the tile (q rows q0.., keys k0..) hold any pair of equal segment
// ids? Block-wide; every thread must call it.
__device__ __forceinline__ bool tile_has_segment(const FlashParams& p,
                                                 const int* qseg,
                                                 const int* kvseg, int q0,
                                                 int k0) {
  int any = 0;
  for (int e = threadIdx.x; e < kTile * kTile && !any; e += kThreads) {
    const int r = q0 + e / kTile, c = k0 + e % kTile;
    any = r < p.sq && c < p.sk && qseg[r] == kvseg[c];
  }
  return __syncthreads_or(any) != 0;
}

// last live k tile + 1 for q rows q0.. under causality (the TPU kernels'
// _causal_live, :227, on this kernel's tiles)
__device__ __forceinline__ int live_k_tiles(const FlashParams& p, int q0) {
  const int nk = (p.sk + kTile - 1) / kTile;
  if (!p.causal) return nk;
  const int last_q = min(q0 + kTile, p.sq) - 1 + (p.sk - p.sq);
  return max(0, min(nk, last_q / kTile + 1));
}

// ============================== K1: forward ===============================
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  constexpr int LD = D + kPad, NJ = D / 64;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][LD]
  float* kt = qs + kTile * LD;                  // [D][kTile]
  float* vs = kt + D * kTile;                   // [kTile][LD]
  float* ps = vs + kTile * LD;                  // [kTile][kLP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = bh / p.hq;
  const int kvh = b * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const T* q = static_cast<const T*>(p.q) + static_cast<long long>(bh) *
                                                p.sq * D;
  const T* k = static_cast<const T*>(p.k) + static_cast<long long>(kvh) *
                                                p.sk * D;
  const T* v = static_cast<const T*>(p.v) + static_cast<long long>(kvh) *
                                                p.sk * D;
  const int* qseg = p.has_seg ? p.q_seg + static_cast<long long>(b) * p.sq
                              : nullptr;
  const int* kvseg = p.has_seg ? p.kv_seg + static_cast<long long>(b) * p.sk
                               : nullptr;
  const Masker mask(p, bias_of(p, bh), kvseg);

  load_rows<T, D>(qs, q, q0, p.sq);
  int qseg_r[4];
  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    qseg_r[i] = (qseg != nullptr && qpos < p.sq) ? qseg[qpos] : 0;
    m[i] = __int_as_float(0xff800000);  // -inf
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = live_k_tiles(p, q0);
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kTile;
    if (qseg != nullptr && !tile_has_segment(p, qseg, kvseg, q0, k0))
      continue;
    __syncthreads();  // every thread is done with the previous tiles
    load_rows_t<T, D>(kt, k, k0, p.sk);
    load_rows<T, D>(vs, v, k0, p.sk);
    __syncthreads();

    float s[4][4] = {};
    fma_tile_rowA<1>(s, qs, LD, kt, kTile, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool live[4];
      float mx = kMask;
      int row_seg = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        s[i][j] = mask.score(s[i][j], qpos, kpos, qseg_r[i], &live[j]);
        mx = fmaxf(mx, s[i][j]);
        row_seg |= live[j];
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // rows with no segment-live key in this tile add no p (:278)
      const bool row_live = qseg == nullptr || half_warp_or(row_seg);
      float psum = 0.f, pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool in = row_live && kpos < p.sk && qpos < p.sq;
        pv[j] = in ? expf(s[i][j] - m_new) : 0.f;
        psum += pv[j];
      }
      psum = half_warp_sum(psum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pa = pv[j];
        if (p.has_dropout) {
          // l keeps the raw softmax sum; only the values drop (:285)
          const bool keep = keep_bit(bh, qpos, k0 + tx * 4 + j, p.seed,
                                     p.threshold);
          pa = (keep ? pa : 0.f) * p.drop_scale;
        }
        ps[(ty * 4 + i) * kLP + tx * 4 + j] = round_t<T>(pa);
      }
    }
    __syncthreads();
    fma_tile_rowA<NJ>(acc, ps, kLP, vs, LD, kTile, ty, tx);
  }

  T* o = static_cast<T*>(p.out0) + static_cast<long long>(bh) * p.sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= p.sq) continue;
    // rows that saw no live key: exact 0 and lse 0, so the backward's
    // p = exp(kMask - lse) underflows to 0 (:309-319)
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        o[static_cast<long long>(qpos) * D + tx * 4 + 64 * jj + x] =
            from_f<T>(acc[i][4 * jj + x] / l_safe);
    if (tx == 0)
      p.lse_out[static_cast<long long>(bh) * p.sq + qpos] =
          l[i] == 0.f ? 0.f : m[i] + logf(l_safe);
  }
}

// ================ K1: forward, bf16 or f16 on tensor cores ===============
// One block of 256 threads per (flat q head, q tile of 128 rows): two
// warpgroups of 64 q rows each. Thread 0 brings the Q tile in by TMA once,
// then blocks of 128 keys of K and V through a ring of kStages stages,
// each guarded by a "full" mbarrier (TMA bytes landed) and an "empty" one
// (each of the 8 warps is done with it); it refills a stage one block
// after the stage was freed, so it seldom waits. There is no loader warp:
// with a ninth warp, three warps share one SM quarter's 16384 registers,
// so ptxas allocates at most 168 a thread (setmaxnreg does not change
// that) and the o, S and P fragments spill; eight warps leave it 255. The
// tensor maps are 3-D, [B*H, S, D], so a box past S reads
// zeros and never the next head's rows. S = Q Kᵀ is one wgmma chain per
// warpgroup with both operands in shared memory (K-major); masking and the
// online softmax run on the accumulator fragment, with row max and sum
// over the 4 threads of a quad; P, rounded to bf16 exactly as the FMA
// kernel rounds it, is fed back as wgmma's A operand from registers (the
// f32 accumulator layout is the bf16 A-fragment layout, two values a
// register) against V in shared memory, MN-major. A block's O += P V is
// issued behind the next block's S = Q Kᵀ, so it runs on the tensor cores
// while the warpgroup does that block's softmax; the new P is packed into
// the A registers only after that product is done. Either a branch around
// part of a wgmma chain or a write to registers a wgmma in flight reads
// makes ptxas serialise every wgmma of the kernel (its C7520 and C7513).
//
// The visited keys are the FMA kernel's, at 64-key granularity: each
// warpgroup visits the live 64-key tiles of its own 64 rows
// (live_k_tiles), and keys of a block past them are masked like keys past
// Sk. So a row whose every visible score is masked averages v over the
// same keys as before, the set K2/K3 assume. Segment liveness is taken per
// (row, 64-key half). A tile that the FMA kernel skips (no equal segment
// id, or past the live tiles) is computed here and adds nothing: its p are
// 0, and its masked scores can only lift a running max from -inf to kMask,
// which scales an o and an l that are still 0. A block inside every bound,
// below the causal diagonal, with no bias or segments takes a short path:
// scale and exponent in one FMA, no masks. Operands must be 16-byte
// aligned (the wrapper checks). Bound: operations, as for the FMA kernel;
// this one runs its products on the bf16 tensor cores.
namespace fwd90 {
constexpr int kRows = 128;                 // q rows per block
constexpr int kKeys = 128;                 // keys per stage: two 64-key tiles
constexpr int kStages = 3;                 // K/V ring depth
constexpr int kThreads = 256;              // two warpgroups
constexpr int kWarps = kThreads / 32;      // one "empty" arrival each
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(kRows * D * 2) +
         2 * kStages * static_cast<size_t>(kKeys * D * 2) +
         8 * (1 + 2 * kStages);
}
}  // namespace fwd90

template <typename E, int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           FlashParams p) {
  using namespace hopper;
  using fwd90::kKeys;
  using fwd90::kLog2e;
  using fwd90::kRows;
  using fwd90::kStages;
  constexpr int kPanels = D / 64;
  constexpr int kQBytes = kRows * D * 2;
  constexpr int kKVBytes = kKeys * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);        // kPanels x [128][64]
  uint8_t* k_s = q_s + kQBytes;              // kStages x kPanels x [128][64]
  uint8_t* v_s = k_s + kStages * kKVBytes;   // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int b = bh / p.hq;
  const int kvh = b * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  // live 64-key tiles of each 64-row half
  const int n_lo = live_k_tiles(p, q0);
  const int n_hi = q0 + kTile < p.sq ? live_k_tiles(p, q0 + kTile) : 0;
  const int n_blocks = (max(n_lo, n_hi) * kTile + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], fwd90::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // keys of block j into its stage, by thread 0
  const auto load_block = [&](int j) {
    const int s = j % kStages;
    mbar_arrive_expect_tx(&kv_full[s], 2 * kKVBytes);
    for (int pn = 0; pn < kPanels; ++pn) {
      const int off = s * kKVBytes + pn * kKeys * 128;
      tma_load_3d(k_s + off, &tk, &kv_full[s], pn * 64, j * kKeys, kvh);
      tma_load_3d(v_s + off, &tv, &kv_full[s], pn * 64, j * kKeys, kvh);
    }
  };
  if (threadIdx.x == 0 && n_blocks > 0) {
    mbar_arrive_expect_tx(q_full, kQBytes);
    for (int pn = 0; pn < kPanels; ++pn)
      tma_load_3d(q_s + pn * kRows * 128, &tq, q_full, pn * 64, q0, bh);
    for (int j = 0; j < min(kStages, n_blocks); ++j) load_block(j);
  }

  const int cw = threadIdx.x / 128;        // warpgroup 0 or 1
  const int t = threadIdx.x % 128;         // thread in the warpgroup
  const int lane = t % 32;
  const int row0 = q0 + cw * kTile;        // first q row of the warpgroup
  const int ra = row0 + (t / 32) * 16 + lane / 4;  // the thread's rows
  const int rb = ra + 8;
  const int cq = 2 * (lane % 4);           // its first column in a chunk
  // keys this warpgroup visits: its live 64-key tiles, inside Sk
  const int k_lim = min(p.sk, (cw == 0 ? n_lo : n_hi) * kTile);
  const int* qseg = p.has_seg ? p.q_seg + static_cast<long long>(b) * p.sq
                              : nullptr;
  const int* kvseg = p.has_seg ? p.kv_seg + static_cast<long long>(b) * p.sk
                               : nullptr;
  const Masker mask(p, bias_of(p, bh), kvseg);
  const int seg_a = (qseg != nullptr && ra < p.sq) ? qseg[ra] : 0;
  const int seg_b = (qseg != nullptr && rb < p.sq) ? qseg[rb] : 0;
  const bool short_ok = mask.bias_head == nullptr && qseg == nullptr &&
                        mask.sm_scale > 0.f && row0 + kTile <= p.sq;
  const uint32_t q_addr = smem_u32(q_s) + cw * kTile * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = __int_as_float(0xff800000), m_b = m_a;  // -inf
  float l_a = 0.f, l_b = 0.f;
  uint32_t pf[kKeys / 16][4];  // P of the block whose O += P V is pending

  // S = Q Kᵀ of the keys in stage s (scale_d = 0 on the first k16 step, so
  // sc need not be cleared)
  const auto issue_s = [&](float (&sc)[64], int s) {
    const uint32_t k_addr = smem_u32(k_s + s * kKVBytes);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_m64n128k16_ss<0, 0, E>(
          sc, desc_k_major(q_addr + (kk / 4) * kRows * 128 + off),
          desc_k_major(k_addr + (kk / 4) * kKeys * 128 + off), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V with pf and the values in stage s
  const auto issue_pv = [&](int s) {
    const uint32_t v_addr = smem_u32(v_s + s * kKVBytes);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t dv = desc_mn_major(v_addr + kk * 16 * 128, kKeys * 128);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1, E>(o, pf[kk], dv);
      else
        wgmma_m64n64k16_rs<1, E>(o, pf[kk], dv);
    }
    wgmma_commit();
  };
  // once O += P V is done: o is final for it, pf and the stage are free
  const auto finish_pv = [&](int s) {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  };
  // The online softmax of block j's scores sc, in place: sc becomes P in
  // f32, m and l move on, and alpha_a/alpha_b are what o must be scaled by.
  const auto softmax = [&](float (&sc)[64], int j, float& alpha_a,
                           float& alpha_b) {
    const int k0 = j * kKeys;
    // rows with an equal-id key in each 64-key half ([row a/b][half]):
    // the FMA kernel's per-tile liveness
    bool live[2][2] = {{true, true}, {true, true}};
    if (qseg != nullptr) {
      live[0][0] = live[0][1] = live[1][0] = live[1][1] = false;
#pragma unroll
      for (int c = 0; c < kKeys / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * c + cq + e;
          if (kpos < k_lim) {
            const int ks = kvseg[kpos];
            live[0][c / 8] |= ra < p.sq && ks == seg_a;
            live[1][c / 8] |= rb < p.sq && ks == seg_b;
          }
        }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          live[h / 2][h % 2] |=
              __shfl_xor_sync(0xffffffffu, live[h / 2][h % 2], o2);
    }
    // element i of sc: key k0 + 8 * (i / 4) + cq + (i & 1), row a for
    // (i & 2) == 0, else row b
    const bool short_path =
        short_ok && k0 + kKeys <= k_lim &&
        (!p.causal || k0 + kKeys - 1 <= row0 + mask.offset);
    float mx_a, mx_b;
    if (short_path) {  // the scale is positive: scale the raw max
      float r_a = -FLT_MAX, r_b = -FLT_MAX;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if ((i & 2) == 0)
          r_a = fmaxf(r_a, sc[i]);
        else
          r_b = fmaxf(r_b, sc[i]);
      }
      mx_a = fmaxf(r_a * mask.sm_scale, kMask);
      mx_b = fmaxf(r_b * mask.sm_scale, kMask);
    } else {
      mx_a = mx_b = kMask;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool upper = (i & 2) == 0;
        float v = kMask;
        if (kpos < k_lim) {
          bool seg_live;
          v = mask.score(sc[i], upper ? ra : rb, kpos, upper ? seg_a : seg_b,
                         &seg_live);
        }
        sc[i] = v;
        if (upper)
          mx_a = fmaxf(mx_a, v);
        else
          mx_b = fmaxf(mx_b, v);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);

    if (short_path) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        sc[i] = exp2_approx(
            fmaf(sc[i], mask.sm_scale, (i & 2) == 0 ? -mn_a : -mn_b) *
            kLog2e);
    } else {
      // rows with no segment-live key in a 64-key tile add no p (:278)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool upper = (i & 2) == 0;
        const bool in = live[upper ? 0 : 1][i / 32] &&
                        (upper ? ra : rb) < p.sq && kpos < k_lim;
        sc[i] = in ? exp2_approx((sc[i] - (upper ? mn_a : mn_b)) * kLog2e)
                   : 0.f;
      }
    }
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if ((i & 2) == 0)
        sum_a += sc[i];
      else
        sum_b += sc[i];
    }
    if (p.has_dropout) {
      // l keeps the raw softmax sum; only the values drop (:285)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool keep = keep_bit(bh, (i & 2) == 0 ? ra : rb, kpos, p.seed,
                                   p.threshold);
        sc[i] = (keep ? sc[i] : 0.f) * p.drop_scale;
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o2);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o2);
    }
    alpha_a = exp2_approx((m_a - mn_a) * kLog2e);
    alpha_b = exp2_approx((m_b - mn_b) * kLog2e);
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
  };
  // P into pf in bf16: p[i], p[i + 1] are register (i % 8) / 2 of k16
  // step i / 8. Only once no O += P V is in flight, which reads pf.
  const auto pack_p = [&](const float (&sc)[64]) {
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      pf[i / 8][(i % 8) / 2] = pack2<E>(sc[i], sc[i + 1]);
  };

  if (n_blocks > 0) {
    float alpha_a, alpha_b;
    mbar_wait(q_full, 0);
    {  // block 0: its S alone (o is still 0, nothing to scale)
      float sc[64];
      mbar_wait(&kv_full[0], 0);
      wgmma_fence();
      issue_s(sc, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, 0, alpha_a, alpha_b);
      pack_p(sc);
    }
    for (int j = 1; j < n_blocks; ++j) {
      const int s = j % kStages, prev = (j - 1) % kStages;
      // the stage that block j - 2 freed last time round takes block
      // j + kStages - 2
      const int next = j + kStages - 2;
      if (threadIdx.x == 0 && next >= kStages && next < n_blocks) {
        mbar_wait(&kv_empty[next % kStages], (next / kStages - 1) & 1);
        load_block(next);
      }
      float sc[64];
      mbar_wait(&kv_full[s], (j / kStages) & 1);
      wgmma_fence();
      issue_s(sc, s);
      issue_pv(prev);  // the previous block's P V, behind this S
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(sc, j, alpha_a, alpha_b);
      finish_pv(prev);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) == 0 ? alpha_a : alpha_b;
      pack_p(sc);
    }
    wgmma_fence();
    issue_pv((n_blocks - 1) % kStages);
    finish_pv((n_blocks - 1) % kStages);
  }

  // rows that saw no live key: exact 0 and lse 0, so the backward's
  // p = exp(kMask - lse) underflows to 0 (:309-319)
  E* out = static_cast<E*>(p.out0) + static_cast<long long>(bh) * p.sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h == 0 ? ra : rb;
    if (row >= p.sq) continue;
    const float l = h == 0 ? l_a : l_b;
    const float l_safe = l == 0.f ? 1.f : l;
    E* orow = out + static_cast<long long>(row) * D + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store2<E>(orow + 8 * c, o[4 * c + 2 * h] / l_safe,
                o[4 * c + 2 * h + 1] / l_safe);
    if (lane % 4 == 0)
      p.lse_out[static_cast<long long>(bh) * p.sq + row] =
          l == 0.f ? 0.f : (h == 0 ? m_a : m_b) + logf(l_safe);
  }
}

using hopper::set_smem_once;

// whether every operand a tensor-core kernel loads by TMA or stores in
// pairs starts on a 16-byte boundary
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return true;
}

// a 3-D map [B*H, S, D] of a bf16 or f16 (E) q-side or kv-side tensor,
// boxes of 64 columns x box_rows rows
template <typename E, int D>
cudaError_t head_map(CUtensorMap* map, const void* base, int s, int bh,
                     int box_rows) {
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return hopper::make_map(map, base, 3, dims, strides, box,
                           hopper::map_dtype<E>());
}

template <typename E, int D>
cudaError_t run_fwd_wgmma(const FlashParams& p, cudaStream_t stream) {
  if (!aligned16({p.q, p.k, p.v, p.out0})) return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  cudaError_t e = head_map<E, D>(&tq, p.q, p.sq, p.bhq, fwd90::kRows);
  if (e == cudaSuccess) e = head_map<E, D>(&tk, p.k, p.sk, p.bhkv, fwd90::kKeys);
  if (e == cudaSuccess) e = head_map<E, D>(&tv, p.v, p.sk, p.bhkv, fwd90::kKeys);
  if (e != cudaSuccess) return e;
  const size_t smem = fwd90::smem_bytes<D>();
  e = set_smem_once(reinterpret_cast<const void*>(
                        &flash_fwd_wgmma_kernel<E, D>),
                    smem);
  if (e != cudaSuccess) return e;
  const unsigned nq = (p.sq + fwd90::kRows - 1) / fwd90::kRows;
  flash_fwd_wgmma_kernel<E, D>
      <<<dim3(p.bhq, nq), fwd90::kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ================================ K2: dq ==================================
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(FlashParams p) {
  constexpr int LD = D + kPad, NJ = D / 64;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][LD]
  float* dos = qs + kTile * LD;                 // [kTile][LD]
  float* kt = dos + kTile * LD;                 // [D][kTile]
  float* vt = kt + D * kTile;                   // [D][kTile]
  float* ks = vt + D * kTile;                   // [kTile][LD]
  float* dss = ks + kTile * LD;                 // [kTile][kLP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = bh / p.hq;
  const int kvh = b * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const long long qoff = static_cast<long long>(bh) * p.sq * D;
  const long long koff = static_cast<long long>(kvh) * p.sk * D;
  const T* q = static_cast<const T*>(p.q) + qoff;
  const T* dout = static_cast<const T*>(p.dout) + qoff;
  const T* k = static_cast<const T*>(p.k) + koff;
  const T* v = static_cast<const T*>(p.v) + koff;
  const int* qseg = p.has_seg ? p.q_seg + static_cast<long long>(b) * p.sq
                              : nullptr;
  const int* kvseg = p.has_seg ? p.kv_seg + static_cast<long long>(b) * p.sk
                               : nullptr;
  const Masker mask(p, bias_of(p, bh), kvseg);

  load_rows<T, D>(qs, q, q0, p.sq);
  load_rows<T, D>(dos, dout, q0, p.sq);
  int qseg_r[4];
  float lse[4], delta[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    const bool in = qpos < p.sq;
    const long long r = static_cast<long long>(bh) * p.sq + qpos;
    qseg_r[i] = (qseg != nullptr && in) ? qseg[qpos] : 0;
    lse[i] = in ? p.lse_in[r] : 0.f;
    delta[i] = in ? p.delta[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = live_k_tiles(p, q0);
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kTile;
    if (qseg != nullptr && !tile_has_segment(p, qseg, kvseg, q0, k0))
      continue;
    __syncthreads();
    load_rows_t<T, D>(kt, k, k0, p.sk);
    load_rows_t<T, D>(vt, v, k0, p.sk);
    load_rows<T, D>(ks, k, k0, p.sk);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    fma_tile_rowA<1>(s, qs, LD, kt, kTile, D, ty, tx);
    fma_tile_rowA<1>(dp, dos, LD, vt, kTile, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool live;
        const float sc = mask.score(s[i][j], qpos, kpos, qseg_r[i], &live);
        const bool in = qpos < p.sq && kpos < p.sk;
        const float pr = in ? expf(sc - lse[i]) : 0.f;
        float d = dp[i][j];
        if (p.has_dropout) {
          const bool keep =
              keep_bit(bh, qpos, kpos, p.seed, p.threshold);
          d = (keep ? d : 0.f) * p.drop_scale;
        }
        dss[(ty * 4 + i) * kLP + tx * 4 + j] =
            round_t<T>(pr * (d - delta[i]) * p.sm_scale);
      }
    }
    __syncthreads();
    fma_tile_rowA<NJ>(acc, dss, kLP, ks, LD, kTile, ty, tx);
  }

  T* dq = static_cast<T*>(p.out0) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= p.sq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dq[static_cast<long long>(qpos) * D + tx * 4 + 64 * jj + x] =
            from_f<T>(acc[i][4 * jj + x]);
  }
}

// =============================== K3: dk, dv ===============================
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(FlashParams p) {
  constexpr int LD = D + kPad, NJ = D / 64;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][kTile]
  float* vt = kt + D * kTile;                   // [D][kTile]
  float* qs = vt + D * kTile;                   // [kTile][LD]
  float* dos = qs + kTile * LD;                 // [kTile][LD]
  float* ps = dos + kTile * LD;                 // [kTile][kLP]
  float* dss = ps + kTile * kLP;                // [kTile][kLP]

  const int bkv = blockIdx.x;  // flat kv head
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = bkv / p.hkv;
  const int group = p.hq / p.hkv;
  const long long koff = static_cast<long long>(bkv) * p.sk * D;
  const int* qseg = p.has_seg ? p.q_seg + static_cast<long long>(b) * p.sq
                              : nullptr;
  const int* kvseg = p.has_seg ? p.kv_seg + static_cast<long long>(b) * p.sk
                               : nullptr;

  load_rows_t<T, D>(kt, static_cast<const T*>(p.k) + koff, k0, p.sk);
  load_rows_t<T, D>(vt, static_cast<const T*>(p.v) + koff, k0, p.sk);
  float dk[4][4 * NJ], dv[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // first q tile that is causally live for these keys
  const int offset = p.sk - p.sq;
  const int nq = (p.sq + kTile - 1) / kTile;
  const int qt0 = p.causal ? max(0, (k0 - offset) / kTile) : 0;
  for (int g = 0; g < group; ++g) {
    // flat q head of (batch, kv head, g): the forward's bh (_qflat, :220)
    const int bh = b * p.hq + (bkv % p.hkv) * group + g;
    const long long qoff = static_cast<long long>(bh) * p.sq * D;
    const Masker mask(p, bias_of(p, bh), kvseg);
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (p.causal && live_k_tiles(p, q0) <= blockIdx.y) continue;
      if (qseg != nullptr && !tile_has_segment(p, qseg, kvseg, q0, k0))
        continue;
      __syncthreads();
      load_rows<T, D>(qs, static_cast<const T*>(p.q) + qoff, q0, p.sq);
      load_rows<T, D>(dos, static_cast<const T*>(p.dout) + qoff, q0, p.sq);
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      fma_tile_rowA<1>(s, qs, LD, kt, kTile, D, ty, tx);
      fma_tile_rowA<1>(dp, dos, LD, vt, kTile, D, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i;
        const bool qin = qpos < p.sq;
        const long long r = static_cast<long long>(bh) * p.sq + qpos;
        const float lse = qin ? p.lse_in[r] : 0.f;
        const float delta = qin ? p.delta[r] : 0.f;
        const int qsg = (qseg != nullptr && qin) ? qseg[qpos] : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx * 4 + j;
          bool live;
          const float sc = mask.score(s[i][j], qpos, kpos, qsg, &live);
          const bool in = qin && kpos < p.sk;
          const float pr = in ? expf(sc - lse) : 0.f;
          float pd = pr, d = dp[i][j];
          if (p.has_dropout) {
            const bool keep = keep_bit(bh, qpos, kpos, p.seed, p.threshold);
            pd = (keep ? pd : 0.f) * p.drop_scale;
            d = (keep ? d : 0.f) * p.drop_scale;
          }
          ps[(ty * 4 + i) * kLP + tx * 4 + j] = round_t<T>(pd);
          dss[(ty * 4 + i) * kLP + tx * 4 + j] =
              round_t<T>(pr * (d - delta) * p.sm_scale);
        }
      }
      __syncthreads();
      // dv[c][:] += sum_r p_drop[r][c] do[r][:]
      // dk[c][:] += sum_r ds[r][c] q[r][:]
      fma_tile_colA<NJ>(dv, ps, kLP, dos, LD, kTile, ty, tx);
      fma_tile_colA<NJ>(dk, dss, kLP, qs, LD, kTile, ty, tx);
    }
  }

  T* dk_out = static_cast<T*>(p.out0) + koff;
  T* dv_out = static_cast<T*>(p.out1) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= p.sk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const long long e =
            static_cast<long long>(kpos) * D + tx * 4 + 64 * jj + x;
        dk_out[e] = from_f<T>(dk[i][4 * jj + x]);
        dv_out[e] = from_f<T>(dv[i][4 * jj + x]);
      }
  }
}

// =============== K2 and K3: bf16 or f16 on tensor cores ===================
// Both keep K1's block: 256 threads, two warpgroups, no loader warp;
// thread 0 issues every TMA copy through 3-D maps [B*H, S, D] (a box past S
// reads zeros, never the next head's rows) into 128-byte-swizzled tiles,
// and refills a ring stage one step after the stage was freed, as K1 does.
//
// K2 (dq): one block per (flat q head, 128 q rows), heavy causal tiles
// first; each warpgroup owns 64 q rows. Q and dO come in once, K and V
// through a ring of kStages stages of 64 keys. Per block of keys: S = Q Kᵀ
// and dP = dO Vᵀ are two ss wgmma chains (all operands K-major); p = exp(s
// - lse) and dS = p (dP - delta) scale run on the accumulator fragments;
// dS, rounded to bf16 where the FMA kernel rounds it, is packed into
// A-fragments and dQ += dS K runs as an rs wgmma with K as an MN-major B.
// A block's dQ product is issued behind the next block's S and dP, so it
// runs while the warpgroup computes that block's dS; dS is packed only
// after the product's wait, as K1 packs P. 64-key blocks keep S, dP and the
// packed dS at 32 + 32 + 16 registers beside dQ's 64 (hd 128).
//
// K3 (dk, dv): one block per (flat kv head, 128 keys), key block 0 (which
// meets the most causal q tiles) first; each warpgroup owns 64 keys and
// keeps its dK and dV accumulators in registers to the end. K and V come
// in once; the block walks every (q head of the GQA group, live 64-row q
// tile) pair in the FMA kernel's order, Q and dO through a ring of stages,
// so the group is reduced inside the block with no atomics and dk/dv are
// written once. The products are transposed so the accumulators are
// key-major: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (ss chains), then dV += p_dropᵀ dO
// and dK += dSᵀ Q as rs products with dO and Q as MN-major B operands. dSᵀ
// is formed in place before P is packed, so at the peak a thread holds
// dK, dV, Sᵀ and dPᵀ (64 + 64 + 32 + 32 at hd 128), and the dV product
// runs while dSᵀ is packed. lse and delta of a pair's 64 rows are read by
// the warpgroup's own threads one pair ahead into a register, and staged
// in two shared-memory slots behind a warpgroup barrier.
//
// The visited keys are the FMA kernels', pair by pair: a (64-row q tile,
// 64-key tile) pair counts iff the key tile is below the q tile's
// live_k_tiles and, with segment ids, the pair holds an equal id
// (warpgroup_any over the fragment). Inside a pair that counts every
// in-range (row, key) gets p = exp(s - lse), so a row whose every visible
// score is masked (lse = kMask) sees p = 1 there, as in the FMA kernels;
// everywhere else p is exactly 0. Every pair of a block is computed (no
// branch around a wgmma chain): a pair that does not count adds zeros. A
// pair inside every bound, below the causal diagonal, with no bias or
// segments takes a short path: scale, exponent and lse in one FMA, no
// masks. Operands must be 16-byte aligned (the wrapper checks).
namespace bwd90 {
constexpr int kStages = 4;     // ring depth: loads run two steps ahead
constexpr int kDqRows = 128;   // K2: q rows per block
constexpr int kDkvKeys = 128;  // K3: keys per block

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, then kStages x (K, V)
  return 1024 + 2 * static_cast<size_t>(kDqRows * D * 2) +
         2 * kStages * static_cast<size_t>(kTile * D * 2) +
         8 * (1 + 2 * kStages);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, kStages x (Q, dO), row slots
  return 1024 + 2 * static_cast<size_t>(kDkvKeys * D * 2) +
         2 * kStages * static_cast<size_t>(kTile * D * 2) +
         sizeof(float) * 2 * 2 * 2 * kTile + 8 * (1 + 2 * kStages);
}

// p of an in-range (row, key) of a pair that counts: exp(s - lse), with s
// masked and clamped as every kernel scores it
__device__ __forceinline__ float prob(const Masker& mask, float dot, int qpos,
                                      int kpos, int qseg, float lse) {
  bool live;
  const float s = mask.score(dot, qpos, kpos, qseg, &live);
  return hopper::exp2_approx((s - lse) * fwd90::kLog2e);
}
}  // namespace bwd90

template <typename E, int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          FlashParams p) {
  using namespace hopper;
  using bwd90::kStages;
  using fwd90::kLog2e;
  constexpr int kRows = bwd90::kDqRows;
  constexpr int kPanels = D / 64;
  constexpr int kQBytes = kRows * D * 2;   // one of Q, dO
  constexpr int kKVBytes = kTile * D * 2;  // one of K, V in a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);       // kPanels x [128][64]
  uint8_t* do_s = q_s + kQBytes;            // the same
  uint8_t* k_s = do_s + kQBytes;            // kStages x kPanels x [64][64]
  uint8_t* v_s = k_s + kStages * kKVBytes;  // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int b = bh / p.hq;
  const int kvh = b * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  // live 64-key tiles of each 64-row half
  const int n_lo = live_k_tiles(p, q0);
  const int n_hi = q0 + kTile < p.sq ? live_k_tiles(p, q0 + kTile) : 0;
  const int n_blocks = max(n_lo, n_hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], fwd90::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // keys of block j into its stage, by thread 0
  const auto load_block = [&](int j) {
    const int s = j % kStages;
    mbar_arrive_expect_tx(&kv_full[s], 2 * kKVBytes);
    for (int pn = 0; pn < kPanels; ++pn) {
      const int off = s * kKVBytes + pn * kTile * 128;
      tma_load_3d(k_s + off, &tk, &kv_full[s], pn * 64, j * kTile, kvh);
      tma_load_3d(v_s + off, &tv, &kv_full[s], pn * 64, j * kTile, kvh);
    }
  };
  if (threadIdx.x == 0 && n_blocks > 0) {
    mbar_arrive_expect_tx(q_full, 2 * kQBytes);
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load_3d(q_s + pn * kRows * 128, &tq, q_full, pn * 64, q0, bh);
      tma_load_3d(do_s + pn * kRows * 128, &tdo, q_full, pn * 64, q0, bh);
    }
    for (int j = 0; j < min(kStages, n_blocks); ++j) load_block(j);
  }

  const int cw = threadIdx.x / 128;  // warpgroup 0 or 1
  const int t = threadIdx.x % 128;   // thread in the warpgroup
  const int lane = t % 32;
  const int row0 = q0 + cw * kTile;  // first q row of the warpgroup
  const int ra = row0 + (t / 32) * 16 + lane / 4;  // the thread's rows
  const int rb = ra + 8;
  const int cq = 2 * (lane % 4);  // its first column in a chunk
  const int n_live = cw == 0 ? n_lo : n_hi;  // key tiles its rows visit
  const int* qseg = p.has_seg ? p.q_seg + static_cast<long long>(b) * p.sq
                              : nullptr;
  const int* kvseg = p.has_seg ? p.kv_seg + static_cast<long long>(b) * p.sk
                               : nullptr;
  const Masker mask(p, bias_of(p, bh), kvseg);
  const int seg_a = (qseg != nullptr && ra < p.sq) ? qseg[ra] : 0;
  const int seg_b = (qseg != nullptr && rb < p.sq) ? qseg[rb] : 0;
  const long long r0 = static_cast<long long>(bh) * p.sq;
  const float lse_a = ra < p.sq ? p.lse_in[r0 + ra] : 0.f;
  const float lse_b = rb < p.sq ? p.lse_in[r0 + rb] : 0.f;
  const float dl_a = ra < p.sq ? p.delta[r0 + ra] : 0.f;
  const float dl_b = rb < p.sq ? p.delta[r0 + rb] : 0.f;
  const bool short_ok = mask.bias_head == nullptr && qseg == nullptr &&
                        row0 + kTile <= p.sq;
  const float scale2 = mask.sm_scale * kLog2e;
  const uint32_t q_addr = smem_u32(q_s) + cw * kTile * 128;
  const uint32_t do_addr = smem_u32(do_s) + cw * kTile * 128;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t dsf[kTile / 16][4];  // dS of the block whose dQ += dS K is pending

  // S = Q Kᵀ and dP = dO Vᵀ of the keys in stage s
  const auto issue_s_dp = [&](float (&sc)[32], float (&dp)[32], int s) {
    const uint32_t k_addr = smem_u32(k_s + s * kKVBytes);
    const uint32_t v_addr = smem_u32(v_s + s * kKVBytes);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * kTile * 128 + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, E>(sc, desc_k_major(q_addr + a),
                            desc_k_major(k_addr + bo), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * kTile * 128 + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, E>(dp, desc_k_major(do_addr + a),
                            desc_k_major(v_addr + bo), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K with dsf and the keys in stage s
  const auto issue_dq = [&](int s) {
    const uint32_t k_addr = smem_u32(k_s + s * kKVBytes);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t db = desc_mn_major(k_addr + kk * 16 * 128, kTile * 128);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1, E>(dq, dsf[kk], db);
      else
        wgmma_m64n64k16_rs<1, E>(dq, dsf[kk], db);
    }
    wgmma_commit();
  };
  // once dQ += dS K is done: dq is final for it, dsf and the stage are free
  const auto finish_dq = [&](int s) {
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsf);
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  };
  // dS of block j, in place in sc: element i is key k0 + 8 * (i / 4) + cq +
  // (i & 1) of row a for (i & 2) == 0, else of row b
  const auto grad_scores = [&](float (&sc)[32], float (&dp)[32], int j) {
    const int k0 = j * kTile;
    bool counts = j < n_live;
    if (qseg != nullptr) {  // the FMA kernel skips a tile of unequal ids
      bool any = false;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool upper = (i & 2) == 0;
        any |= (upper ? ra : rb) < p.sq && kpos < p.sk &&
               kvseg[kpos] == (upper ? seg_a : seg_b);
      }
      counts = warpgroup_any(any, cw) && counts;
    }
    const bool short_path =
        short_ok && counts && k0 + kTile <= p.sk &&
        (!p.causal || k0 + kTile - 1 <= row0 + mask.offset);
    if (short_path) {
      const float la = lse_a * kLog2e, lb = lse_b * kLog2e;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = exp2_approx(fmaf(sc[i], scale2, (i & 2) == 0 ? -la : -lb));
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool upper = (i & 2) == 0;
        const int row = upper ? ra : rb;
        sc[i] = counts && row < p.sq && kpos < p.sk
                    ? bwd90::prob(mask, sc[i], row, kpos,
                                  upper ? seg_a : seg_b,
                                  upper ? lse_a : lse_b)
                    : 0.f;
      }
    }
    if (p.has_dropout) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool keep = keep_bit(bh, (i & 2) == 0 ? ra : rb, kpos, p.seed,
                                   p.threshold);
        dp[i] = (keep ? dp[i] : 0.f) * p.drop_scale;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = sc[i] * (dp[i] - ((i & 2) == 0 ? dl_a : dl_b)) * mask.sm_scale;
  };
  // dS into dsf in bf16: ds[i], ds[i + 1] are register (i % 8) / 2 of k16
  // step i / 8. Only once no dQ += dS K is in flight, which reads dsf.
  const auto pack_ds = [&](const float (&sc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      dsf[i / 8][(i % 8) / 2] = pack2<E>(sc[i], sc[i + 1]);
  };

  if (n_blocks > 0) {
    mbar_wait(q_full, 0);
    {  // block 0: its S and dP alone
      float sc[32], dp[32];
      mbar_wait(&kv_full[0], 0);
      wgmma_fence();
      issue_s_dp(sc, dp, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      grad_scores(sc, dp, 0);
      pack_ds(sc);
    }
    for (int j = 1; j < n_blocks; ++j) {
      const int s = j % kStages, prev = (j - 1) % kStages;
      // the stage that block j - 2 freed takes block j + kStages - 2
      const int next = j + kStages - 2;
      if (threadIdx.x == 0 && next >= kStages && next < n_blocks) {
        mbar_wait(&kv_empty[next % kStages], (next / kStages - 1) & 1);
        load_block(next);
      }
      float sc[32], dp[32];
      mbar_wait(&kv_full[s], (j / kStages) & 1);
      wgmma_fence();
      issue_s_dp(sc, dp, s);
      issue_dq(prev);  // the previous block's dQ product, behind them
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      grad_scores(sc, dp, j);
      finish_dq(prev);
      pack_ds(sc);
    }
    wgmma_fence();
    issue_dq((n_blocks - 1) % kStages);
    finish_dq((n_blocks - 1) % kStages);
  }

  E* out = static_cast<E*>(p.out0) + r0 * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h == 0 ? ra : rb;
    if (row >= p.sq) continue;
    E* orow = out + static_cast<long long>(row) * D + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store2<E>(orow + 8 * c, dq[4 * c + 2 * h], dq[4 * c + 2 * h + 1]);
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           FlashParams p) {
  using namespace hopper;
  using bwd90::kStages;
  using fwd90::kLog2e;
  constexpr int kKeys = bwd90::kDkvKeys;
  constexpr int kPanels = D / 64;
  constexpr int kKVBytes = kKeys * D * 2;  // one of K, V
  constexpr int kQBytes = kTile * D * 2;   // one of Q, dO in a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);       // kPanels x [128][64]
  uint8_t* v_s = k_s + kKVBytes;            // the same
  uint8_t* q_s = v_s + kKVBytes;            // kStages x kPanels x [64][64]
  uint8_t* do_s = q_s + kStages * kQBytes;  // the same
  // per warpgroup two slots of [lse of 64 rows, delta of 64 rows]
  float* rows_s = reinterpret_cast<float*>(do_s + kStages * kQBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + 2 * 2 * 2 * kTile);
  uint64_t* qd_full = kv_full + 1;
  uint64_t* qd_empty = qd_full + kStages;

  const int bkv = blockIdx.x;         // flat kv head
  const int k0 = blockIdx.y * kKeys;  // key block 0 first: the most q tiles
  const int b = bkv / p.hkv;
  const int group = p.hq / p.hkv;
  // the q tiles that are causally live for these keys, qt0 .. nq - 1, for
  // each q head of the group (the FMA kernel's loop)
  const int offset = p.sk - p.sq;
  const int nq = (p.sq + kTile - 1) / kTile;
  const int qt0 = p.causal ? max(0, (k0 - offset) / kTile) : 0;
  const int n_qt = nq - qt0;
  const int n_pairs = group * n_qt;
  // pair pr: flat q head of (batch, kv head, pr / n_qt), the forward's bh
  // (_qflat, :220), and first q row
  const auto pair_bh = [&](int pr) {
    return b * p.hq + (bkv % p.hkv) * group + pr / n_qt;
  };
  const auto pair_q0 = [&](int pr) { return (qt0 + pr % n_qt) * kTile; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&qd_full[s], 1);
      mbar_init(&qd_empty[s], fwd90::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Q and dO of pair pr into its stage, by thread 0
  const auto load_pair = [&](int pr) {
    const int s = pr % kStages, bh = pair_bh(pr), q0 = pair_q0(pr);
    mbar_arrive_expect_tx(&qd_full[s], 2 * kQBytes);
    for (int pn = 0; pn < kPanels; ++pn) {
      const int off = s * kQBytes + pn * kTile * 128;
      tma_load_3d(q_s + off, &tq, &qd_full[s], pn * 64, q0, bh);
      tma_load_3d(do_s + off, &tdo, &qd_full[s], pn * 64, q0, bh);
    }
  };
  if (threadIdx.x == 0 && n_pairs > 0) {
    mbar_arrive_expect_tx(kv_full, 2 * kKVBytes);
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load_3d(k_s + pn * kKeys * 128, &tk, kv_full, pn * 64, k0, bkv);
      tma_load_3d(v_s + pn * kKeys * 128, &tv, kv_full, pn * 64, k0, bkv);
    }
    for (int pr = 0; pr < min(kStages, n_pairs); ++pr) load_pair(pr);
  }

  const int cw = threadIdx.x / 128;  // warpgroup 0 or 1
  const int t = threadIdx.x % 128;   // thread in the warpgroup
  const int lane = t % 32;
  const int kw0 = k0 + cw * kTile;  // first key of the warpgroup
  const int ka = kw0 + (t / 32) * 16 + lane / 4;  // the thread's keys
  const int kb = ka + 8;
  const int cq = 2 * (lane % 4);  // its first q column in a chunk
  const int* qseg = p.has_seg ? p.q_seg + static_cast<long long>(b) * p.sq
                              : nullptr;
  const int* kvseg = p.has_seg ? p.kv_seg + static_cast<long long>(b) * p.sk
                               : nullptr;
  const int kseg_a = (kvseg != nullptr && ka < p.sk) ? kvseg[ka] : 0;
  const int kseg_b = (kvseg != nullptr && kb < p.sk) ? kvseg[kb] : 0;
  const float scale2 = p.sm_scale * kLog2e;
  const uint32_t k_addr = smem_u32(k_s) + cw * kTile * 128;
  const uint32_t v_addr = smem_u32(v_s) + cw * kTile * 128;
  float* slots = rows_s + cw * 2 * 2 * kTile;  // [slot][lse | delta][64]
  // the thread's share of pair pr's rows: lse (t < 64) or delta of row
  // t % 64
  const auto row_value = [&](int pr) {
    const int q = pair_q0(pr) + t % kTile;
    if (q >= p.sq) return 0.f;
    const long long r = static_cast<long long>(pair_bh(pr)) * p.sq + q;
    return t < kTile ? p.lse_in[r] : p.delta[r];
  };
  if (n_pairs > 0) slots[t] = row_value(0);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_pairs > 0) mbar_wait(kv_full, 0);
  for (int pr = 0; pr < n_pairs; ++pr) {
    const int s = pr % kStages;
    // the stage that pair pr - 2 freed takes pair pr + kStages - 2
    const int next = pr + kStages - 2;
    if (threadIdx.x == 0 && next >= kStages && next < n_pairs) {
      mbar_wait(&qd_empty[next % kStages], (next / kStages - 1) & 1);
      load_pair(next);
    }
    const float ahead = pr + 1 < n_pairs ? row_value(pr + 1) : 0.f;
    warpgroup_sync(cw);  // every thread's row value of pair pr is staged
    const float* lse = slots + (pr % 2) * 2 * kTile;
    const float* delta = lse + kTile;
    const int bh = pair_bh(pr), q0 = pair_q0(pr);
    const uint32_t q_addr = smem_u32(q_s + s * kQBytes);
    const uint32_t do_addr = smem_u32(do_s + s * kQBytes);

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: element i is q row q0 + 8 * (i / 4) + cq +
    // (i & 1) against key a for (i & 2) == 0, else key b
    float st[32], dpt[32];
    mbar_wait(&qd_full[s], (pr / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * kTile * 128 + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, E>(st, desc_k_major(k_addr + a),
                            desc_k_major(q_addr + bo), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * kTile * 128 + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, E>(dpt, desc_k_major(v_addr + a),
                            desc_k_major(do_addr + bo), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // does the pair (this q tile, the warpgroup's key tile) count?
    bool counts = !p.causal || live_k_tiles(p, q0) > kw0 / kTile;
    if (qseg != nullptr) {
      bool any = false;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qpos = q0 + 8 * (i / 2) + cq + (i & 1);
        if (qpos < p.sq) {
          const int qs = qseg[qpos];
          any |= (ka < p.sk && qs == kseg_a) || (kb < p.sk && qs == kseg_b);
        }
      }
      counts = warpgroup_any(any, cw) && counts;
    }
    const Masker mask(p, bias_of(p, bh), kvseg);
    const bool short_path =
        mask.bias_head == nullptr && qseg == nullptr && counts &&
        q0 + kTile <= p.sq && kw0 + kTile <= p.sk &&
        (!p.causal || kw0 + kTile - 1 <= q0 + offset);
    // pᵀ in place in st
    if (short_path) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + cq + (i & 1);
        st[i] = exp2_approx(fmaf(st[i], scale2, -lse[c] * kLog2e));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + cq + (i & 1);
        const int qpos = q0 + c;
        const int kpos = (i & 2) == 0 ? ka : kb;
        float pv = 0.f;
        if (counts && qpos < p.sq && kpos < p.sk)
          pv = bwd90::prob(mask, st[i], qpos, kpos,
                           qseg != nullptr ? qseg[qpos] : 0, lse[c]);
        st[i] = pv;
      }
    }
    uint32_t keep = 0xffffffffu;  // bit i: the dropout keep bit of element i
    if (p.has_dropout) {
      keep = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        keep |= static_cast<uint32_t>(keep_bit(
                    bh, q0 + 8 * (i / 4) + cq + (i & 1),
                    (i & 2) == 0 ? ka : kb, p.seed, p.threshold))
                << i;
    }
    const float dsc = p.has_dropout ? p.drop_scale : 1.f;
    // dSᵀ in place in dpt, from p and the dropped dP
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + cq + (i & 1);
      const float d = ((keep >> i) & 1u) ? dpt[i] * dsc : 0.f;
      dpt[i] = st[i] * (d - delta[c]) * p.sm_scale;
    }
    // dV += p_dropᵀ dO, then dK += dSᵀ Q (dO and Q as MN-major B)
    uint32_t pf[kTile / 16][4], dsf[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float p0 = ((keep >> i) & 1u) ? st[i] * dsc : 0.f;
      const float p1 = ((keep >> (i + 1)) & 1u) ? st[i + 1] * dsc : 0.f;
      pf[i / 8][(i % 8) / 2] = pack2<E>(p0, p1);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t db = desc_mn_major(do_addr + kk * 16 * 128, kTile * 128);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1, E>(dv, pf[kk], db);
      else
        wgmma_m64n64k16_rs<1, E>(dv, pf[kk], db);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      dsf[i / 8][(i % 8) / 2] = pack2<E>(dpt[i], dpt[i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t db = desc_mn_major(q_addr + kk * 16 * 128, kTile * 128);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1, E>(dk, dsf[kk], db);
      else
        wgmma_m64n64k16_rs<1, E>(dk, dsf[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(dsf);
    __syncwarp();
    if (lane == 0) mbar_arrive(&qd_empty[s]);
    slots[((pr + 1) % 2) * 2 * kTile + t] = ahead;
  }

  const long long koff = static_cast<long long>(bkv) * p.sk * D;
  E* dk_out = static_cast<E*>(p.out0) + koff;
  E* dv_out = static_cast<E*>(p.out1) + koff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h == 0 ? ka : kb;
    if (key >= p.sk) continue;
    const long long e0 = static_cast<long long>(key) * D + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      store2<E>(dk_out + e0 + 8 * c, dk[4 * c + 2 * h],
                dk[4 * c + 2 * h + 1]);
      store2<E>(dv_out + e0 + 8 * c, dv[4 * c + 2 * h],
                dv[4 * c + 2 * h + 1]);
    }
  }
}

// K2 (which 1) or K3 (which 2) in bf16 or f16 (E) on the tensor cores
template <typename E, int D>
cudaError_t run_bwd_wgmma(int which, const FlashParams& p,
                          cudaStream_t stream) {
  const bool dq = which == 1;
  if (!aligned16({p.q, p.k, p.v, p.dout, p.out0, dq ? p.out0 : p.out1}))
    return cudaErrorMisalignedAddress;
  const int q_box = dq ? bwd90::kDqRows : kTile;
  const int k_box = dq ? kTile : bwd90::kDkvKeys;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t e = head_map<E, D>(&tq, p.q, p.sq, p.bhq, q_box);
  if (e == cudaSuccess) e = head_map<E, D>(&tdo, p.dout, p.sq, p.bhq, q_box);
  if (e == cudaSuccess) e = head_map<E, D>(&tk, p.k, p.sk, p.bhkv, k_box);
  if (e == cudaSuccess) e = head_map<E, D>(&tv, p.v, p.sk, p.bhkv, k_box);
  if (e != cudaSuccess) return e;
  if (dq) {
    const size_t smem = bwd90::dq_smem_bytes<D>();
    e = set_smem_once(
        reinterpret_cast<const void*>(&flash_dq_wgmma_kernel<E, D>), smem);
    if (e != cudaSuccess) return e;
    const unsigned nq = (p.sq + bwd90::kDqRows - 1) / bwd90::kDqRows;
    flash_dq_wgmma_kernel<E, D><<<dim3(p.bhq, nq), fwd90::kThreads, smem,
                               stream>>>(tq, tdo, tk, tv, p);
  } else {
    const size_t smem = bwd90::dkv_smem_bytes<D>();
    e = set_smem_once(
        reinterpret_cast<const void*>(&flash_dkv_wgmma_kernel<E, D>), smem);
    if (e != cudaSuccess) return e;
    const unsigned nk = (p.sk + bwd90::kDkvKeys - 1) / bwd90::kDkvKeys;
    flash_dkv_wgmma_kernel<E, D><<<dim3(p.bhkv, nk), fwd90::kThreads, smem,
                                stream>>>(tq, tdo, tk, tv, p);
  }
  return cudaGetLastError();
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (D + kPad) + D * kTile + kTile * kLP);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (3 * kTile * (D + kPad) + 2 * D * kTile +
                          kTile * kLP);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kTile * (D + kPad) + 2 * D * kTile +
                          2 * kTile * kLP);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const FlashParams& p,
                   cudaStream_t stream) {
  const cudaError_t e =
      set_smem_once(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(int which, const FlashParams& p, cudaStream_t stream) {
  // bf16 and f16 on the tensor cores; f32 stays on the FMA kernels, since
  // TF32 would miss the f32 tolerances
  if constexpr (std::is_same<T, __nv_bfloat16>::value ||
                std::is_same<T, __half>::value) {
    return which == 0 ? run_fwd_wgmma<T, D>(p, stream)
                      : run_bwd_wgmma<T, D>(which, p, stream);
  } else {
    const unsigned nq = (p.sq + kTile - 1) / kTile;
    const unsigned nk = (p.sk + kTile - 1) / kTile;
    if (which == 0)
      return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), dim3(p.bhq, nq), p,
                    stream);
    if (which == 1)
      return launch(flash_dq_kernel<T, D>, dq_smem<D>(), dim3(p.bhq, nq), p,
                    stream);
    return launch(flash_dkv_kernel<T, D>, dkv_smem<D>(), dim3(p.bhkv, nk), p,
                  stream);
  }
}

int dispatch(int which, const FlashParams* p, void* stream) {
  if (p == nullptr || p->bhq < 1 || p->bhkv < 1 || p->sq < 1 || p->sk < 1 ||
      p->hq < 1 || p->hkv < 1 || p->hq % p->hkv != 0 ||
      p->bhq != p->bhkv * (p->hq / p->hkv) ||
      (p->sq + kTile - 1) / kTile > 65535 ||
      (p->sk + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (p->dtype == 0 && p->head_dim == 64) e = run<float, 64>(which, *p, st);
  if (p->dtype == 0 && p->head_dim == 128) e = run<float, 128>(which, *p, st);
  if (p->dtype == 1 && p->head_dim == 64)
    e = run<__nv_bfloat16, 64>(which, *p, st);
  if (p->dtype == 1 && p->head_dim == 128)
    e = run<__nv_bfloat16, 128>(which, *p, st);
  if (p->dtype == 2 && p->head_dim == 64) e = run<__half, 64>(which, *p, st);
  if (p->dtype == 2 && p->head_dim == 128) e = run<__half, 128>(which, *p, st);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Each returns a cudaError_t
// value (0 on a launch that was accepted); the Python wrapper raises on
// anything else.
int flash_fwd_launch(const FlashParams* p, void* stream) {
  return dispatch(0, p, stream);
}
int flash_dq_launch(const FlashParams* p, void* stream) {
  return dispatch(1, p, stream);
}
int flash_dkv_launch(const FlashParams* p, void* stream) {
  return dispatch(2, p, stream);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
