// Ragged paged attention (RPA) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_rpa_kernel`
// (paddle_tpu/ops/pallas/ragged_paged_attention.py:159, launched by
// `_rpa_call` at :262). It computes the same function: token-packed
// ragged GQA attention over the block-paged KV pool, walking a host-built
// (sequence, page) work list per q tile with an online softmax in f32.
//
// Layouts (all row-major):
//   q, out        [T, Hq, hd]  (token and head strides passed in; the last
//                 dim is contiguous) -- no [n_kv, T*group, hd] transpose
//   k_pool/v_pool [num_blocks + 1, block_size, n_kv, hd], block 0 = null
//   block_tables  [max_seqs + 1, bt_width] int32
//   cu_seqlens    [max_seqs + 2] int32, context_lens [max_seqs + 1] int32
//   step_seq/blk  [num_tiles, max_steps] int32; live steps are a prefix,
//                 dead steps carry the sentinel max_seqs
//
// Work assignment: one thread block per (q tile j, kv head h). Row r of
// the tile is (token j*tile_q + r/group, q head h*group + r%group); each
// warp owns rows warp, warp + nwarps, ... (at most kMaxRowsPerWarp). The
// block loads its own step_seq/step_blk entries and block-table page ids
// (the TPU kernel's scalar-prefetch index maps), copies the step's K and
// V page for head h into shared memory as f32, and every warp folds the
// visible keys of that page into its rows' online-softmax state. A row
// with no visible key in a step leaves m, l and acc untouched; a row that
// never saw a key (padding tokens) writes exactly 0.
//
// Bound on this card: bytes. Attention over a paged cache does 4*hd
// flops per (query head, key) pair against 4*hd bytes of bf16 K/V per
// (kv head, key), far below the H100's ~295 flops/byte ridge. The least
// traffic is each live page read once per kv head, plus q and out. This
// first kernel re-reads a sequence's pages once per q tile it spans (a
// 512-token prefill chunk at tile_q 8 reads each page 64 times) and uses
// no tensor cores; wgmma, TMA page loads and a better work split are the
// next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

// finite stand-in for -inf (as the TPU kernel's _MASK_VALUE): keeps the
// max/exp arithmetic NaN-free for lanes that hold no key
constexpr float kMask = -0.7f * FLT_MAX;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxWarps = 32;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32) rpa_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ cu, const int* __restrict__ ctx,
    const int* __restrict__ step_seq, const int* __restrict__ step_blk,
    T* __restrict__ out, int tile_q, int group, int block_size, int n_kv,
    int max_steps, int max_seqs, int bt_width, long long q_st,
    long long q_sh, long long o_st, long long o_sh, float sm_scale) {
  constexpr int PER = HD / 32;  // head dims per lane
  extern __shared__ float smem[];
  float* ks = smem;                     // [block_size, HD]
  float* vs = smem + block_size * HD;  // [block_size, HD]

  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int rows = tile_q * group;

  float qr[kMaxRowsPerWarp][PER];
  float acc[kMaxRowsPerWarp][PER];
  float m[kMaxRowsPerWarp];
  float l[kMaxRowsPerWarp];
  int tok[kMaxRowsPerWarp];
  int head[kMaxRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kMaxRowsPerWarp; ++k) {
    const int r = warp + k * nwarps;
    tok[k] = j * tile_q + r / group;
    head[k] = h * group + r % group;
    m[k] = __int_as_float(0xff800000);  // -inf
    l[k] = 0.f;
#pragma unroll
    for (int x = 0; x < PER; ++x) {
      acc[k][x] = 0.f;
      qr[k][x] = r < rows
          ? to_f(q[tok[k] * q_st + head[k] * q_sh + lane + 32 * x])
          : 0.f;
    }
  }

  const int* ss = step_seq + static_cast<long long>(j) * max_steps;
  const int* sb = step_blk + static_cast<long long>(j) * max_steps;
  const long long page_stride =
      static_cast<long long>(block_size) * n_kv * HD;
  const long long row_stride = static_cast<long long>(n_kv) * HD;

  for (int i = 0; i < max_steps; ++i) {
    const int s = ss[i];
    if (s >= max_seqs) break;  // live steps are a prefix of the list
    const int blk = sb[i];
    const int phys = block_tables[static_cast<long long>(s) * bt_width + blk];
    const T* kpg = k_pool + phys * page_stride + h * HD;
    const T* vpg = v_pool + phys * page_stride + h * HD;
    __syncthreads();  // every warp is done with the previous page
    for (int e = threadIdx.x; e < block_size * HD; e += blockDim.x) {
      const int t = e / HD;
      const int d = e % HD;
      ks[e] = to_f(kpg[t * row_stride + d]);
      vs[e] = to_f(vpg[t * row_stride + d]);
    }
    __syncthreads();
    const int start = cu[s];
    const int end = cu[s + 1];
    const int kbase = blk * block_size;
#pragma unroll
    for (int k = 0; k < kMaxRowsPerWarp; ++k) {
      const int r = warp + k * nwarps;
      if (r >= rows) break;
      if (tok[k] < start || tok[k] >= end) continue;  // another sequence
      // key kpos is visible iff kpos <= ctx[s] + tok - cu[s]: prior
      // context, in-chunk causality and the page's ragged end in one bound
      const int nvis =
          min(block_size, ctx[s] + tok[k] - start - kbase + 1);
      for (int c0 = 0; c0 < nvis; c0 += 32) {
        const int nk = min(32, nvis - c0);
        float my_s = kMask;  // lane t holds the score of key c0 + t
        for (int t = 0; t < nk; ++t) {
          const float* kr = ks + (c0 + t) * HD;
          float part = 0.f;
#pragma unroll
          for (int x = 0; x < PER; ++x) part += qr[k][x] * kr[lane + 32 * x];
          part = warp_sum(part);
          if (lane == t) my_s = part * sm_scale;
        }
        const float m_new = fmaxf(m[k], warp_max(my_s));
        const float alpha = expf(m[k] - m_new);
        const float p = lane < nk ? expf(my_s - m_new) : 0.f;
        l[k] = l[k] * alpha + warp_sum(p);
#pragma unroll
        for (int x = 0; x < PER; ++x) acc[k][x] *= alpha;
        for (int t = 0; t < nk; ++t) {
          const float pt = __shfl_sync(0xffffffffu, p, t);
          const float* vr = vs + (c0 + t) * HD;
#pragma unroll
          for (int x = 0; x < PER; ++x) acc[k][x] += pt * vr[lane + 32 * x];
        }
        m[k] = m_new;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxRowsPerWarp; ++k) {
    const int r = warp + k * nwarps;
    if (r >= rows) break;
    // rows that saw no visible key (padding tokens): exact 0 output
    const float l_safe = l[k] == 0.f ? 1.f : l[k];
    T* orow = out + tok[k] * o_st + head[k] * o_sh;
#pragma unroll
    for (int x = 0; x < PER; ++x)
      orow[lane + 32 * x] = from_f<T>(acc[k][x] / l_safe);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* cu, const int* ctx,
                   const int* step_seq, const int* step_blk, void* out,
                   int num_tiles, int tile_q, int group, int block_size,
                   int n_kv, int max_steps, int max_seqs, int bt_width,
                   long long q_st, long long q_sh, long long o_st,
                   long long o_sh, float sm_scale, cudaStream_t stream) {
  const int rows = tile_q * group;
  const int warps = rows < kMaxWarps ? rows : kMaxWarps;
  const size_t smem = 2ull * block_size * HD * sizeof(float);
  auto kernel = rpa_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(num_tiles, n_kv);
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, cu, ctx, step_seq,
      step_blk, static_cast<T*>(out), tile_q, group, block_size, n_kv,
      max_steps, max_seqs, bt_width, q_st, q_sh, o_st, o_sh, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 on a
// launch that was accepted); the Python wrapper raises on anything else.
int rpa_launch(int dtype, int head_dim, const void* q, const void* k_pool,
               const void* v_pool, const void* block_tables, const void* cu,
               const void* ctx, const void* step_seq, const void* step_blk,
               void* out, int num_tiles, int tile_q, int group,
               int block_size, int n_kv, int max_steps, int max_seqs,
               int bt_width, long long q_st, long long q_sh, long long o_st,
               long long o_sh, float sm_scale, void* stream) {
  const int rows = tile_q * group;
  if (rows < 1 || rows > kMaxWarps * kMaxRowsPerWarp || block_size < 1 ||
      num_tiles < 1 || n_kv < 1 || n_kv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* c = static_cast<const int*>(cu);
  const auto* cx = static_cast<const int*>(ctx);
  const auto* ssq = static_cast<const int*>(step_seq);
  const auto* sbk = static_cast<const int*>(step_blk);
  const auto st = static_cast<cudaStream_t>(stream);
#define RPA_ARGS                                                          \
  q, k_pool, v_pool, bt, c, cx, ssq, sbk, out, num_tiles, tile_q, group, \
      block_size, n_kv, max_steps, max_seqs, bt_width, q_st, q_sh, o_st, \
      o_sh, sm_scale, st
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) e = launch<float, 64>(RPA_ARGS);
  if (dtype == 0 && head_dim == 128) e = launch<float, 128>(RPA_ARGS);
  if (dtype == 1 && head_dim == 64) e = launch<__nv_bfloat16, 64>(RPA_ARGS);
  if (dtype == 1 && head_dim == 128) e = launch<__nv_bfloat16, 128>(RPA_ARGS);
#undef RPA_ARGS
  return static_cast<int>(e);
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
