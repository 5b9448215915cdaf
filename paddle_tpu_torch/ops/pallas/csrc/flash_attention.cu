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
// Work assignment: 256 threads, tiles of 64 q rows x 64 keys. K1 and K2
// run one block per (flat q head, q tile) and loop over the live k tiles;
// K3 runs one block per (flat kv head, k tile) and loops over every
// (q head of the group, q tile) pair, so the GQA group is reduced inside
// the block and dk/dv are written once, with no atomics. Tiles are held
// in shared memory as f32. Every product is a register-tiled FMA loop:
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4..ty*4+3 and
// columns tx*4 + 64*j + 0..3 of its output tile. A score row lives in the
// 16 lanes of one half-warp, so row max and row sums are shuffles.
//
// Numerics follow the TPU kernels: scores are masked to kMask and clamped
// at it; a row with no segment-live key in a tile adds no p; in bf16 the
// p of the PV product (K1), p_drop of dv and ds of dq/dk (K2, K3) are
// rounded to bf16 before their product, as the TPU kernels cast them
// before their MXU dots. Products of bf16 values are exact in f32, so the
// FMA loops give the f32-accumulated dots of the TPU kernels. Rows past
// Sq and keys past Sk (the ragged edge of a tile) are masked out: they
// add nothing and are not written. A tile that is dead by causality or
// that holds no equal segment id is skipped, as on the TPU.
//
// Bound on this card: operations. At the training shape (B=4, S=2048,
// Hq=16, Hkv=4, D=128, causal, bf16) K1 does 2 products of 2*Sq*Sk*D/2
// flops per head (68.7 GFLOP), K2 3 and K3 4, against 84-118 MB of
// traffic: far above the H100's ridge of ~295 flops per byte. These first
// kernels use no tensor cores: the FMA loops run at the f32 rate at best
// (67 TFLOP/s), and bf16 inputs are widened to f32 in shared memory.
// wgmma on bf16 tiles, TMA loads and warp specialisation are the next
// steps (PERF.md holds the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

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


__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(int which, const FlashParams& p, cudaStream_t stream) {
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
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t value (0 on
// a launch that was accepted); the Python wrapper raises on anything else.
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
