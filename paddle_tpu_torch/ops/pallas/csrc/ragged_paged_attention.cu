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
// Row r of q tile j for kv head h is (token j*tile_q + r/group, q head
// h*group + r%group). Key kpos of step (s, blk) is visible to the row iff
// cu[s] <= token < cu[s+1] and kpos <= ctx[s] + token - cu[s]: prior
// context, in-chunk causality and the page's ragged end in one bound. A
// row with no visible key in a step leaves its state untouched; a row
// that never saw a key (padding tokens) writes exactly 0.
//
// Bound on this card: bytes. Attention over a paged cache does 4*hd
// flops per (query head, key) pair against 4*hd bytes of bf16 K/V per
// (kv head, key), far below the H100's ~295 flops/byte ridge. The least
// traffic is each live page read once per kv head, plus q and out (0.018
// ms on chip_smoke.py's phase-3 mix). So what matters is that the pages
// stream at HBM rate across all 132 SMs.
//
// Two designs, chosen by an explicit dispatch on dtype (rpa_launch for
// f32, rpa_wgmma_launch for bf16 and f16):
//
// bf16 and f16: split, persistent, pages by TMA, tensor cores. The kernels
// are templates on the element type E (`__nv_bfloat16` or `__half`: the
// same two bytes an element, so every shared-memory layout holds for
// both); f16 takes wgmma's .f16 kind, f16 TMA maps, P packed to f16 and
// f16 stores. Three launches per call, on the caller's stream, no host
// synchronisation:
//  1. `rpa_items_kernel` builds the work list on the device from step_seq,
//     as gmm_tiles_kernel builds K5's: each tile's live prefix (a binary
//     search for the first sentinel) is cut into chunks of L_j = max(C,
//     ceil(live_j / kMaxChunks)) steps, C = max(1, 128 / block_size)
//     pages (128 keys; kMaxChunks = MAX_CHUNKS = 16 and C are the Python
//     wrapper's); a block scan gives each chunk its place. The work
//     items are (chunk, kv head); a dead tile has none, so padding tiles
//     and dead steps cost nothing. At most kMaxChunks chunks a tile bounds
//     the scratch the wrapper allocates (num_tiles * kMaxChunks * n_kv *
//     rows * (hd + 2) floats) with no host count.
//  2. `rpa_wgmma_kernel<E, D, NWG>`: a persistent grid (one block per SM, two
//     where one warpgroup computes) walks the items, the count read from
//     device memory. One producer warp (its lanes read 32 steps' metadata
//     at once, lane 0 issues the copies) loads the item's Q tile once,
//     into one of two buffers (a 3-D TMA map [T, Hq,
//     hd], box [tile_q][group][64], so the rows land in tile order) and
//     the chunk's pages into a ring of kStages stages of 64 keys (64 /
//     block_size pages a stage, each page one box [block_size][1][64] of
//     the pool viewed as [(num_blocks+1)*block_size, n_kv, hd], split
//     along hd in 64-column panels for the 128-byte swizzle), computing
//     each physical page from block_tables. A page that no row of the
//     tile can see (its first key past the tile's last token's visible
//     position) is skipped without a load; unused slots of a stage load
//     the null page and are masked. Each stage carries its slots' (cu[s],
//     cu[s+1], ctx[s] - cu[s] - first key) and a last-stage flag in
//     shared memory, published by the mbarrier's arrival. NWG warpgroups
//     own 64 rows each (tile_q * group rows, rounded up to 64, at most
//     128; a decode-heavy tile wastes tensor-core rows, which costs
//     nothing that bounds the kernel). Per stage: S = Q K^T by an ss
//     wgmma chain (m64n64k16, both K-major), the visibility bound applied
//     on the accumulator fragment per slot's sequence, the online softmax
//     in f32 (exp2), P rounded to E (as the TPU kernel casts p to v's
//     dtype) and fed from registers against MN-major V (rs wgmma), as K1
//     does, a stage's P V issued behind the next stage's S. A tile of one
//     chunk writes its normalised output; a tile of several writes per
//     row (m, l, acc) in f32 to scratch.
//  3. `rpa_combine_kernel` (a warp a row) merges the partials of
//     multi-chunk tiles with the log-sum-exp rescale (rows whose l is 0
//     in every chunk: exactly 0) and writes exact zeros for tiles with no
//     live step.
// What it does about the FMA kernel's limits: the split walk spreads a
// long decode tile over kMaxChunks x n_kv blocks instead of n_kv; larger
// q tiles (up to 128 rows) serve more rows per page load; pages stay in E
// and arrive by TMA, several per stage, loads running a ring ahead of the
// products; scores and P V run on the tensor cores.
//
// f32: `rpa_kernel`, the first port's FMA kernel: one block per (q tile,
// kv head) walking the tile's whole step list, each warp owning score
// rows, K and V pages copied into shared memory element by element, the
// online softmax in f32 through warp shuffles. It stays for float32,
// whose tolerance 16-bit tensor-core products would miss. The dynamic
// shared-memory limit of each wgmma instance is raised once per kernel and
// device (hopper::set_smem_once), so a launch a CUDA graph captures makes
// no other call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

// Launch parameters of the bf16/f16 design, filled field for field by the
// Python wrapper's ctypes mirror (_Params). At global scope so the extern
// "C" entry point that takes it keeps external linkage.
struct RpaParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* block_tables;
  const int* cu;
  const int* ctx;
  const int* step_seq;
  const int* step_blk;
  void* out;
  int* info;         // [4 * num_tiles + 1]: per tile live, len, first, chunks
  int* items;        // [num_tiles * max_chunks]: the tile of each chunk
  float* part_acc;   // [num_tiles * max_chunks, n_kv, rows, hd]
  float* part_ml;    // [num_tiles * max_chunks, n_kv, rows, 2]
  long long q_st, q_sh, o_st, o_sh;
  int num_tiles, tile_q, group, block_size, n_kv, max_steps, max_seqs;
  int bt_width, head_dim, pool_blocks, min_pages, max_chunks;
  int dtype;  // 1 bfloat16, 2 float16: the element type E of the kernels
  float sm_scale;
};

namespace {

// finite stand-in for -inf (as the TPU kernel's _MASK_VALUE): keeps the
// max/exp arithmetic NaN-free for lanes that hold no key
constexpr float kMask = -0.7f * FLT_MAX;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxWarps = 32;

// the FMA kernel runs in f32 only (the bf16 design is rpa_wgmma_kernel)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ========= bf16/f16: split, persistent, pages by TMA, wgmma ============
namespace rpa90 {
constexpr int kKeys = 64;        // keys per stage: 64 / block_size pages
constexpr int kMaxSlots = kKeys / 8;  // pages a stage holds (block_size 8)
constexpr int kMeta = 1 + 3 * kMaxSlots;  // last flag, 3 ints a slot
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: two Q buffers of 64 NWG rows, a ring of K and V stages,
// the barriers and each stage's meta data. The ring is as deep as lets two
// blocks share an SM where one warpgroup computes (hd 128: 2 stages), so
// one block's loads and softmax overlap the other's products.
template <int D, int NWG>
struct Cfg {
  static constexpr int kPanels = D / 64;
  static constexpr int kQPanel = 64 * NWG * 128;  // 64 columns of Q rows
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kKeys * D * 2;  // K or V of one stage
  static constexpr int kStages = (D == 128 && NWG == 1) ? 2 : 4;
  static constexpr int kBlocksPerSm = NWG == 1 ? 2 : 1;  // registers too
  static constexpr int kThreads = 128 * NWG + 32;  // + one producer warp
  static constexpr int kWarps = 4 * NWG;           // computing warps
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  2 * kStages * kKVBytes +
                                  8 * (4 + 2 * kStages) +
                                  4 * kStages * kMeta;
};
}  // namespace rpa90

// The work list: one block scans the tiles' chunk counts 1024 at a time.
// A tile's live steps are the prefix of its step_seq row before the first
// sentinel (binary search); its chunk length is max(min_pages, ceil(live /
// max_chunks)) steps; info[4j..4j+3] = live, length, first chunk, chunks;
// info[4 * num_tiles] = all chunks; items[u] = the tile of chunk u.
__global__ void __launch_bounds__(1024) rpa_items_kernel(RpaParams p) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  int carry = 0;
  for (int base = 0; base < p.num_tiles; base += blockDim.x) {
    const int j = base + threadIdx.x;
    int live = 0, len = p.min_pages, n = 0;
    if (j < p.num_tiles) {
      const int* ss = p.step_seq + static_cast<long long>(j) * p.max_steps;
      int lo = 0, hi = p.max_steps;  // the first dead step
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (ss[mid] >= p.max_seqs)
          hi = mid;
        else
          lo = mid + 1;
      }
      live = lo;
      len = max(p.min_pages, (live + p.max_chunks - 1) / p.max_chunks);
      n = (live + len - 1) / len;
    }
    int incl = n;
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
    if (j < p.num_tiles) {
      p.info[4 * j] = live;
      p.info[4 * j + 1] = len;
      p.info[4 * j + 2] = first;
      p.info[4 * j + 3] = n;
      for (int c = 0; c < n; ++c) p.items[first + c] = j;
    }
    carry += warp_sums[n_warps - 1];
    __syncthreads();  // warp_sums is rewritten by the next round
  }
  if (threadIdx.x == 0) p.info[4 * p.num_tiles] = carry;
}

// Item w of the walk: chunk u = w / n_kv of tile j, kv head h, steps
// [i0, i1) of the tile's list.
struct RpaItem {
  int j, h, u, i0, i1, chunks;
};

__device__ __forceinline__ RpaItem rpa_item(const RpaParams& p, int w) {
  RpaItem it;
  it.u = w / p.n_kv;
  it.h = w % p.n_kv;
  it.j = p.items[it.u];
  const int* inf = p.info + 4 * it.j;
  it.i0 = (it.u - inf[2]) * inf[1];
  it.i1 = min(inf[0], it.i0 + inf[1]);
  it.chunks = inf[3];
  return it;
}

template <typename E, int D, int NWG>
__global__ void __launch_bounds__(rpa90::Cfg<D, NWG>::kThreads,
                                  rpa90::Cfg<D, NWG>::kBlocksPerSm)
    rpa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, RpaParams p) {
  using namespace hopper;
  using namespace rpa90;
  using C = Cfg<D, NWG>;
  constexpr int kStages = C::kStages;
  constexpr int kQPanel = C::kQPanel;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + 2 * C::kQBytes;  // Q of items n and n + 1
  uint8_t* v_s = k_s + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kKVBytes);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;
  int* meta = reinterpret_cast<int*>(empty + kStages);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], C::kWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int bs = p.block_size;
  const int slots = kKeys / bs;
  const int rows = p.tile_q * p.group;
  const int n_items = p.info[4 * p.num_tiles] * p.n_kv;

  if (threadIdx.x >= 128 * NWG) {
    // The producer warp. Its 32 lanes read 32 steps' metadata at once (the
    // step, its sequence's cu, ctx and block table entry: dependent global
    // loads, which one thread walking the list would pay one after the
    // other); lane 0 alone writes the meta data and issues the loads. The
    // ring position and slot count are kept alike in every lane.
    const int lane = threadIdx.x % 32;
    const bool leader = lane == 0;
    uint32_t it = 0;
    int n_item = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n_item) {
      const RpaItem item = rpa_item(p, w);
      // Q of item n goes to buffer n % 2, once item n - 2 is done with it
      const int qb = n_item & 1;
      if (leader) {
        if (n_item >= 2) mbar_wait(&q_empty[qb], ((n_item >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[qb], rows * 128 * C::kPanels);
        for (int pn = 0; pn < C::kPanels; ++pn)
          tma_load_3d(q_s + qb * C::kQBytes + pn * kQPanel, &tq, &q_full[qb],
                      pn * 64, item.h * p.group, item.j * p.tile_q);
      }
      const int t_end = (item.j + 1) * p.tile_q;  // past the tile's tokens
      const long long row = static_cast<long long>(item.j) * p.max_steps;
      int slot = 0, st = 0;
      int* m = meta;
      bool held = false;  // a full stage waits for its last flag
      // a stage's loads are issued slot by slot; its mbarrier arrival,
      // which publishes the meta data, comes once it is known to be the
      // item's last stage or not (the loads' bytes may land first: the
      // phase completes only after the arrival)
      const auto load_slot = [&](int q, int phys) {
        for (int pn = 0; pn < C::kPanels; ++pn) {
          const int off = st * C::kKVBytes + pn * kKeys * 128 + q * bs * 128;
          tma_load_3d(k_s + off, &tk, &full[st], pn * 64, item.h, phys * bs);
          tma_load_3d(v_s + off, &tv, &full[st], pn * 64, item.h, phys * bs);
        }
      };
      const auto open = [&]() {
        st = it % kStages;
        if (leader && it >= kStages)
          mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        m = meta + st * kMeta;
      };
      const auto close = [&](int last) {
        if (leader) {
          for (int q = slot; q < slots; ++q) {  // unused slots: null page
            m[1 + 3 * q] = 0;
            m[2 + 3 * q] = 0;
            m[3 + 3 * q] = 0;
            load_slot(q, 0);
          }
          m[0] = last;
          mbar_arrive_expect_tx(&full[st], 2 * C::kKVBytes);
        }
        ++it;
        slot = 0;
        held = false;
      };
      for (int i0 = item.i0; i0 < item.i1; i0 += 32) {
        const int i = i0 + lane;
        int start = 0, end = 0, lim = 0, phys = 0;
        bool vis = false;
        if (i < item.i1) {
          const int s = p.step_seq[row + i];
          const int blk = p.step_blk[row + i];
          start = p.cu[s];
          end = p.cu[s + 1];
          const int cx = p.ctx[s];
          // the tile's last token of sequence s sees keys up to
          // cx + min(end, t_end) - 1 - start; a page past that is skipped
          vis = blk * bs <= cx + min(end, t_end) - 1 - start;
          lim = cx - start - blk * bs;
          if (vis)
            phys = p.block_tables[static_cast<long long>(s) * p.bt_width +
                                  blk];
        }
        for (uint32_t todo = __ballot_sync(0xffffffffu, vis); todo != 0;
             todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          const int v_start = __shfl_sync(0xffffffffu, start, src);
          const int v_end = __shfl_sync(0xffffffffu, end, src);
          const int v_lim = __shfl_sync(0xffffffffu, lim, src);
          const int v_phys = __shfl_sync(0xffffffffu, phys, src);
          if (held) close(0);
          if (slot == 0) open();
          if (leader) {
            m[1 + 3 * slot] = v_start;
            m[2 + 3 * slot] = v_end;
            m[3 + 3 * slot] = v_lim;
            load_slot(slot, v_phys);
          }
          if (++slot == slots) held = true;
        }
      }
      if (slot == 0 && !held) open();  // no visible page: one empty stage
      close(1);
    }
    return;
  }

  // computing warpgroups: cw owns rows 64 cw .. 64 cw + 63
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int ra = cw * 64 + (t / 32) * 16 + lane / 4;
  const int rb = ra + 8;
  const int cq = 2 * (lane % 4);
  const float sl = p.sm_scale * kLog2e;
  int log2bs = 0;
  while ((1 << log2bs) < bs) ++log2bs;
  E* out = static_cast<E*>(p.out);

  uint32_t it = 0;
  int n_item = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n_item) {
    const RpaItem item = rpa_item(p, w);
    const int tok_a = ra < rows ? item.j * p.tile_q + ra / p.group : -1;
    const int tok_b = rb < rows ? item.j * p.tile_q + rb / p.group : -1;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = __int_as_float(0xff800000), m_b = m_a;  // -inf
    float l_a = 0.f, l_b = 0.f;
    const int qb = n_item & 1;
    const uint32_t q_addr = smem_u32(q_s + qb * C::kQBytes) + cw * 64 * 128;
    uint32_t pf[4][4];  // P of the stage whose P V is pending, in E

    // S = Q K^T of stage st (scale_d = 0 on the first k16 step)
    const auto issue_s = [&](float (&sc)[32], int st) {
      const uint32_t k_addr = smem_u32(k_s + st * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_m64n64k16_ss<0, E>(
            sc, desc_k_major(q_addr + (kk / 4) * kQPanel + off),
            desc_k_major(k_addr + (kk / 4) * kKeys * 128 + off), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V with pf and the values of stage st
    const auto issue_pv = [&](int st) {
      const uint32_t v_addr = smem_u32(v_s + st * C::kKVBytes);
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
    // once the pending P V is done: o is final for it, pf and its stage
    // are free
    const auto finish_pv = [&](int st) {
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    // The masked online softmax of stage st's scores, in place: sc
    // becomes P in f32, m and l move on, alpha_a/alpha_b are what o must
    // be scaled by. Element i of sc: key column 8 (i / 4) + cq + (i & 1),
    // row a for (i & 2) == 0, else row b. Column c is key c % bs of slot
    // c / bs; it is visible to a row of token tok iff the slot's sequence
    // owns tok and c % bs <= ctx - start - first key + tok.
    const auto softmax = [&](float (&sc)[32], int st, float& alpha_a,
                             float& alpha_b) {
      const int* m = meta + st * kMeta;
      float mx_a = kMask, mx_b = kMask;
#pragma unroll
      for (int ci = 0; ci < 8; ++ci) {
        const int q = (8 * ci) >> log2bs;
        const int in_slot = (8 * ci) & (bs - 1);
        const int start = m[1 + 3 * q], end = m[2 + 3 * q];
        const int lim = m[3 + 3 * q] - in_slot - cq;
        const int rel_a = tok_a >= start && tok_a < end ? lim + tok_a : -1;
        const int rel_b = tok_b >= start && tok_b < end ? lim + tok_b : -1;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ia = 4 * ci + e, ib = ia + 2;
          sc[ia] = e <= rel_a ? sc[ia] * sl : kMask;
          sc[ib] = e <= rel_b ? sc[ib] * sl : kMask;
          mx_a = fmaxf(mx_a, sc[ia]);
          mx_b = fmaxf(mx_b, sc[ib]);
        }
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool upper = (i & 2) == 0;
        // a masked key adds nothing, so a row with no visible key in the
        // stage keeps its state (alpha is 1, or 0 on an empty state)
        const float x = sc[i] == kMask
                            ? 0.f
                            : exp2_approx(sc[i] - (upper ? mn_a : mn_b));
        sc[i] = x;
        if (upper)
          sum_a += x;
        else
          sum_b += x;
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o2);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o2);
      }
      alpha_a = exp2_approx(m_a - mn_a);
      alpha_b = exp2_approx(m_b - mn_b);
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
    };
    // P in E (v's type, as the TPU kernel casts p) as the A fragments of
    // the four k16 steps; only once no P V is in flight, which reads pf
    const auto pack_p = [&](const float (&sc)[32]) {
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        pf[i / 8][(i % 8) / 2] = pack2<E>(sc[i], sc[i + 1]);
    };

    mbar_wait(&q_full[qb], (n_item >> 1) & 1);
    float alpha_a, alpha_b;
    int prev = it % kStages;
    int last;
    {  // the item's first stage: its S alone (o is 0, nothing to scale)
      float sc[32];
      mbar_wait(&full[prev], (it / kStages) & 1);
      last = meta[prev * kMeta];
      wgmma_fence();
      issue_s(sc, prev);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, prev, alpha_a, alpha_b);
      pack_p(sc);
      ++it;
    }
    while (!last) {  // the next S, with the previous stage's P V behind it
      const int st = it % kStages;
      float sc[32];
      mbar_wait(&full[st], (it / kStages) & 1);
      last = meta[st * kMeta];
      wgmma_fence();
      issue_s(sc, st);
      issue_pv(prev);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(sc, st, alpha_a, alpha_b);
      finish_pv(prev);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) == 0 ? alpha_a : alpha_b;
      pack_p(sc);
      prev = st;
      ++it;
    }
    wgmma_fence();
    issue_pv(prev);
    finish_pv(prev);
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qb]);  // every read of Q is done

    // the epilogue: normalised output, or the chunk's partial state
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh == 0 ? ra : rb;
      if (r >= rows) continue;
      const float l = hh == 0 ? l_a : l_b;
      if (item.chunks == 1) {
        const float inv = l == 0.f ? 0.f : 1.f / l;  // no key seen: 0
        const int tok = item.j * p.tile_q + r / p.group;
        E* orow = out + tok * p.o_st +
                  (item.h * p.group + r % p.group) * p.o_sh + cq;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          store2<E>(orow + 8 * c, o[4 * c + 2 * hh] * inv,
                    o[4 * c + 2 * hh + 1] * inv);
      } else {
        const long long b =
            (static_cast<long long>(item.u) * p.n_kv + item.h) * rows + r;
        float* acc = p.part_acc + b * D + cq;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<float2*>(acc + 8 * c) =
              make_float2(o[4 * c + 2 * hh], o[4 * c + 2 * hh + 1]);
        if (lane % 4 == 0)
          *reinterpret_cast<float2*>(p.part_ml + 2 * b) =
              make_float2(hh == 0 ? m_a : m_b, l);
      }
    }
  }
}

// Tiles of several chunks: out = sum_c 2^(m_c - M) acc_c / sum_c 2^(m_c -
// M) l_c over the chunks with l_c > 0 (M their largest m; m is in the
// kernel's log2 units), 0 where no chunk saw a key. Tiles with no live
// step: exactly 0. Tiles of one chunk were written by the main kernel.
// A block of 8 warps per (tile, kv head, 8 rows): a warp a row, each lane
// D / 32 neighbouring columns, the chunks' loads independent.
template <typename E, int D>
__global__ void __launch_bounds__(256) rpa_combine_kernel(RpaParams p) {
  constexpr int kPer = D / 32;
  const int j = blockIdx.x, h = blockIdx.y;
  const int rows = p.tile_q * p.group;
  const int r = 8 * blockIdx.z + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = p.info[4 * j + 3], first = p.info[4 * j + 2];
  if (chunks == 1 || r >= rows) return;
  float acc[kPer];
#pragma unroll
  for (int x = 0; x < kPer; ++x) acc[x] = 0.f;
  if (chunks > 1) {
    const long long b0 =
        (static_cast<long long>(first) * p.n_kv + h) * rows + r;
    const long long step = static_cast<long long>(p.n_kv) * rows;
    float big = __int_as_float(0xff800000);
    for (int c = 0; c < chunks; ++c) {
      const float2 ml =
          *reinterpret_cast<const float2*>(p.part_ml + 2 * (b0 + c * step));
      if (ml.y > 0.f) big = fmaxf(big, ml.x);
    }
    float l = 0.f;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c) {
      const long long b = b0 + c * step;
      const float2 ml = *reinterpret_cast<const float2*>(p.part_ml + 2 * b);
      const float wgt = ml.y > 0.f ? exp2f(ml.x - big) : 0.f;
      l += ml.y * wgt;
      const float* src = p.part_acc + b * D + kPer * lane;
#pragma unroll
      for (int x = 0; x < kPer; x += 2) {
        const float2 v = *reinterpret_cast<const float2*>(src + x);
        acc[x] += wgt * v.x;
        acc[x + 1] += wgt * v.y;
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int x = 0; x < kPer; ++x) acc[x] *= inv;
  }
  const int tok = j * p.tile_q + r / p.group;
  E* orow = static_cast<E*>(p.out) + tok * p.o_st +
            (h * p.group + r % p.group) * p.o_sh + kPer * lane;
#pragma unroll
  for (int x = 0; x < kPer; x += 2)
    hopper::store2<E>(orow + x, acc[x], acc[x + 1]);
}

// whether a pointer or a byte count is a multiple of 16
inline bool al16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename E, int D, int NWG>
cudaError_t run_rpa_wgmma(const RpaParams& p, cudaStream_t stream) {
  using C = rpa90::Cfg<D, NWG>;
  const int n_heads = p.n_kv * p.group;
  CUtensorMap tq, tk, tv;
  {  // q [T, Hq, hd]: box [tile_q tokens][group heads][64 columns]
    const cuuint64_t dims[3] = {
        D, static_cast<cuuint64_t>(n_heads),
        static_cast<cuuint64_t>(p.num_tiles) * p.tile_q};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.q_sh) * 2,
                                   static_cast<cuuint64_t>(p.q_st) * 2};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(p.group),
                               static_cast<cuuint32_t>(p.tile_q)};
    cudaError_t e = hopper::make_map(&tq, p.q, 3, dims, strides, box,
                                     hopper::map_dtype<E>());
    if (e != cudaSuccess) return e;
  }
  // pools viewed as [(num_blocks + 1) * block_size, n_kv, hd]: one box a
  // page of one kv head, [block_size][1][64 columns]
  const cuuint64_t dims[3] = {
      D, static_cast<cuuint64_t>(p.n_kv),
      static_cast<cuuint64_t>(p.pool_blocks) * p.block_size};
  const cuuint64_t strides[2] = {D * 2,
                                 static_cast<cuuint64_t>(p.n_kv) * D * 2};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(p.block_size)};
  cudaError_t e = hopper::make_map(&tk, p.k_pool, 3, dims, strides, box,
                                   hopper::map_dtype<E>());
  if (e == cudaSuccess)
    e = hopper::make_map(&tv, p.v_pool, 3, dims, strides, box,
                         hopper::map_dtype<E>());
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  rpa_items_kernel<<<1, 1024, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel = rpa_wgmma_kernel<E, D, NWG>;
  e = hopper::set_smem_once(reinterpret_cast<const void*>(kernel), C::kSmem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    C::kThreads, C::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<sms * (per_sm > 1 ? per_sm : 1), C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = p.tile_q * p.group;
  rpa_combine_kernel<E, D>
      <<<dim3(p.num_tiles, p.n_kv, (rows + 7) / 8), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename E>
cudaError_t run_rpa_typed(const RpaParams& p, bool two, cudaStream_t st) {
  if (p.head_dim == 64)
    return two ? run_rpa_wgmma<E, 64, 2>(p, st) : run_rpa_wgmma<E, 64, 1>(p, st);
  if (p.head_dim == 128)
    return two ? run_rpa_wgmma<E, 128, 2>(p, st)
               : run_rpa_wgmma<E, 128, 1>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The f32 FMA kernel; dtype must be 0 (float32: bf16 and f16 run
// rpa_wgmma_launch).
// Returns a cudaError_t value (0 on a launch that was accepted); the
// Python wrapper raises on anything else.
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
#undef RPA_ARGS
  return static_cast<int>(e);
}

// The bf16 and f16 design (p->dtype 1 or 2): the work list, the persistent
// wgmma kernel and the combine pass, in that order on `stream`. Returns a
// cudaError_t value.
int rpa_wgmma_launch(const RpaParams* p, void* stream) {
  if (p == nullptr || p->num_tiles < 1 || p->n_kv < 1 || p->n_kv > 65535 ||
      p->num_tiles > 2147483647 / 4 || p->group < 1 || p->group > 256 ||
      p->tile_q < 1 || p->tile_q > 256 || p->max_chunks < 1 ||
      p->min_pages < 1 || p->max_steps < 1 || p->dtype < 1 || p->dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = p->tile_q * p->group;
  const int bs = p->block_size;
  if (rows > 128 || bs < 8 || bs > rpa90::kKeys || (bs & (bs - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!al16(p->q) || !al16(p->k_pool) || !al16(p->v_pool) ||
      (p->q_st * 2) % 16 != 0 || (p->q_sh * 2) % 16 != 0 ||
      (p->o_st % 2) != 0 || (p->o_sh % 2) != 0 || !al16(p->out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool two = rows > 64;
  cudaError_t e = cudaErrorInvalidValue;
  if (p->dtype == 1)
    e = run_rpa_typed<__nv_bfloat16>(*p, two, st);
  else
    e = run_rpa_typed<__half>(*p, two, st);
  return static_cast<int>(e);
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
