// Fused optimizer kernels of the port: the global-norm clip's reduction
// (fused_sqnorm) and the Adam/AdamW bucket update (fused_adam_update),
// CUDA C++ for sm_90a.
//
// They have no Pallas counterpart. They stand in for XLA's fusion of the
// reference's fused_clip_and_update (paddle_tpu/jit/fused_update.py:
// 250-345), which the TPU runs as one pass per flat bucket; eager PyTorch
// fuses nothing, and a per-parameter loop moves ~158 bytes a parameter in
// ~20 kernels. Both kernels are bound by bytes: fused_sqnorm reads each
// gradient element once (2 B in bf16); fused_adam_update reads the
// gradient and m, v and the f32 master once and writes m, v, the master
// and the bf16 parameter once (28 B a parameter with masters; the bf16
// parameter is written, never read), so 0.70 B parameters take at least
// 5.8 ms at 3.35 TB/s.
//
// Design: the bucket's parameters and gradients stay separate tensors
// (multi-tensor apply): a device table holds each tensor's pointer, its
// offset in the bucket's flat state and its size; the Python wrapper
// uploads the pointers only when they change. Each tensor is cut into
// chunks of kChunk elements; a block finds its chunk's tensor by a binary
// search over the chunk prefix and walks it with 16-byte loads where the
// tensor, its gradient and its flat state segments allow (else one
// element at a time), and a scalar tail.
//
// fused_sqnorm is a two-level reduction with no float atomics: a fixed
// grid of blocks writes one partial sum each (in f64), and one block adds
// the partials in a fixed order, so the same inputs give the same bits.
//
// fused_adam_update repeats the plain bucket update's operations
// (jit/fused_update.py:bucket_update_plain) in their order, each rounded
// as PyTorch rounds it: __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn keep nvcc
// from contracting anything into an FMA, and with bf16/f16 state every
// operation rounds to that dtype, as PyTorch's per-operation arithmetic
// does. So it is bit-equal to the plain version on the card. The bucket's
// beta1^t and beta2^t (one f32 element a parameter, all equal) are
// advanced by a one-thread-block launch before the pass, which then reads
// the advanced values and computes lr_t = lr * sqrt(1 - b2p) / (1 - b1p)
// in the plain version's order.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8192;  // = jit/fused_update.py:_CHUNK
constexpr int kThreads = 256;

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Num<__half> {
  static __device__ __forceinline__ float f(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from(float x) {
    return __float2half_rn(x);
  }
};

// x rounded to T and back (the identity for float)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Num<T>::f(Num<T>::from(x));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int N>
__device__ __forceinline__ void load_vec(T (&dst)[N], const T* src) {
  static_assert((N * sizeof(T)) % 16 == 0, "whole 16-byte words");
#pragma unroll
  for (int k = 0; k < int(N * sizeof(T) / 16); ++k)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const T (&src)[N]) {
#pragma unroll
  for (int k = 0; k < int(N * sizeof(T) / 16); ++k)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
}

// The tensor that holds chunk c: the last t with chunk_start[t] <= c (an
// empty tensor has no chunk and is never the last such t).
__device__ __forceinline__ int find_tensor(const long long* chunk_start,
                                           int n, long long c) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// fused_sqnorm. meta: offsets[n], sizes[n], chunk_start[n + 1]; ptrs: the
// n gradient pointers.
template <typename G>
__global__ void __launch_bounds__(kThreads)
fused_sqnorm_partials_kernel(const long long* ptrs, const long long* meta,
                             int n, long long n_chunks, double* partials) {
  const long long* sizes = meta + n;
  const long long* chunk_start = meta + 2 * n;
  constexpr int V = 16 / sizeof(G);
  double acc = 0.0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t = find_tensor(chunk_start, n, c);
    const long long begin = (c - chunk_start[t]) * kChunk;
    const long long left = sizes[t] - begin;
    const int len = int(left < kChunk ? left : kChunk);
    const G* g = reinterpret_cast<const G*>(ptrs[t]) + begin;
    const int nvec = aligned16(g) ? len / V : 0;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      __align__(16) G e[V];
      load_vec(e, g + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float x = Num<G>::f(e[j]);
        acc += double(__fmul_rn(x, x));
      }
    }
    for (int i = nvec * V + threadIdx.x; i < len; i += kThreads) {
      const float x = Num<G>::f(g[i]);
      acc += double(__fmul_rn(x, x));
    }
  }
  __shared__ double warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    partials[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(1024)
fused_sqnorm_final_kernel(const double* partials, int n, float* out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += 1024) acc += partials[i];
  __shared__ double warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < 32; ++w) s += warp_sums[w];
    out[0] = float(s);
  }
}

// ---------------------------------------------------------------------------
// fused_adam_update. ptrs: the n parameter pointers, then the n gradient
// pointers; the flat state m, v (and the master) is indexed by offsets[t].
struct AdamArgs {
  const long long* ptrs;
  const long long* meta;
  int n;
  void* m;
  void* v;
  float* master;
  const float* b1p;
  const float* b2p;
  const float* scale;  // the global-norm clip's factor, or null
  float lr, beta1, beta2, omb1, omb2, eps;
  int decay_kind;      // 0 none, 1 L2 (coeff * p), 2 L1 (coeff * sign(p))
  float decay_coeff;
  int has_wd;          // decoupled decay: multiply by wd_factor
  float wd_factor;     // 1 - lr * coeff, in f32
};

__global__ void fused_adam_pows_kernel(float* b1p, float* b2p, int n,
                                       float beta1, float beta2) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    b1p[i] = __fmul_rn(b1p[i], beta1);
    b2p[i] = __fmul_rn(b2p[i], beta2);
  }
}

// One element, in bucket_update_plain's order of operations. P is the
// parameter's (and gradient's) type, S the state's: float with a master,
// else P.
template <typename P, typename S, bool kMaster>
__device__ __forceinline__ void adam_elem(const AdamArgs& a, float lr_t_s,
                                          float scale_p, P& p, P graw, S& m,
                                          S& v, float& w) {
  float g = Num<P>::f(graw);
  if (a.scale != nullptr) g = rnd<P>(__fmul_rn(g, scale_p));
  // from here the gradient is in S: exact for a master (f32), S == P else
  const float ps = kMaster ? w : Num<P>::f(p);
  if (a.decay_kind == 1) {
    g = rnd<S>(__fadd_rn(g, rnd<S>(__fmul_rn(a.decay_coeff, ps))));
  } else if (a.decay_kind == 2) {
    const float sg = ps > 0.f ? 1.f : (ps < 0.f ? -1.f : 0.f);
    g = rnd<S>(__fadd_rn(g, rnd<S>(__fmul_rn(a.decay_coeff, sg))));
  }
  const float mf = rnd<S>(__fadd_rn(rnd<S>(__fmul_rn(Num<S>::f(m), a.beta1)),
                                    rnd<S>(__fmul_rn(a.omb1, g))));
  const float vf = rnd<S>(__fadd_rn(
      rnd<S>(__fmul_rn(Num<S>::f(v), a.beta2)),
      rnd<S>(__fmul_rn(rnd<S>(__fmul_rn(a.omb2, g)), g))));
  m = Num<S>::from(mf);
  v = Num<S>::from(vf);
  const float num = rnd<S>(__fmul_rn(lr_t_s, mf));
  const float den = rnd<S>(__fadd_rn(rnd<S>(__fsqrt_rn(vf)), a.eps));
  const float delta = rnd<S>(__fdiv_rn(num, den));
  if (kMaster) {
    float wf = w;
    if (a.has_wd) wf = __fmul_rn(wf, a.wd_factor);
    wf = __fsub_rn(wf, delta);
    w = wf;
    p = Num<P>::from(wf);
  } else {
    float pf = Num<P>::f(p);
    if (a.has_wd) pf = rnd<P>(__fmul_rn(pf, a.wd_factor));
    p = Num<P>::from(__fsub_rn(pf, delta));
  }
}

template <typename P, typename S, bool kMaster>
__global__ void __launch_bounds__(kThreads) fused_adam_kernel(AdamArgs a) {
  const long long* offsets = a.meta;
  const long long* sizes = a.meta + a.n;
  const long long* chunk_start = a.meta + 2 * a.n;
  const long long c = blockIdx.x;
  const int t = find_tensor(chunk_start, a.n, c);
  const long long begin = (c - chunk_start[t]) * kChunk;
  const long long left = sizes[t] - begin;
  const int len = int(left < kChunk ? left : kChunk);
  P* p = reinterpret_cast<P*>(a.ptrs[t]) + begin;
  const P* g = reinterpret_cast<const P*>(a.ptrs[a.n + t]) + begin;
  const long long fo = offsets[t] + begin;
  S* m = static_cast<S*>(a.m) + fo;
  S* v = static_cast<S*>(a.v) + fo;
  float* w = kMaster ? a.master + fo : nullptr;

  // lr_t = lr * sqrt(1 - b2p) / (1 - b1p), in f32, then in S where the
  // plain version casts it to the moments' dtype
  const float lr_t = __fdiv_rn(
      __fmul_rn(a.lr, __fsqrt_rn(__fsub_rn(1.f, a.b2p[0]))),
      __fsub_rn(1.f, a.b1p[0]));
  const float lr_t_s = rnd<S>(lr_t);
  const float scale_p = a.scale != nullptr ? rnd<P>(a.scale[0]) : 1.f;

  constexpr int V = 16 / sizeof(P);
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v) && (!kMaster || aligned16(w));
  const int nvec = vec ? len / V : 0;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    __align__(16) P pe[V];
    __align__(16) P ge[V];
    __align__(16) S me[V];
    __align__(16) S ve[V];
    __align__(16) float we[V];
    if (!kMaster) load_vec(pe, p + i * V);  // a master replaces it
    load_vec(ge, g + i * V);
    load_vec(me, m + i * V);
    load_vec(ve, v + i * V);
    if (kMaster) load_vec(we, w + i * V);
#pragma unroll
    for (int j = 0; j < V; ++j)
      adam_elem<P, S, kMaster>(a, lr_t_s, scale_p, pe[j], ge[j], me[j],
                               ve[j], we[j]);
    store_vec(p + i * V, pe);
    store_vec(m + i * V, me);
    store_vec(v + i * V, ve);
    if (kMaster) store_vec(w + i * V, we);
  }
  for (int i = nvec * V + threadIdx.x; i < len; i += kThreads) {
    P pe = kMaster ? P() : p[i];
    S me = m[i], ve = v[i];
    float we = kMaster ? w[i] : 0.f;
    adam_elem<P, S, kMaster>(a, lr_t_s, scale_p, pe, g[i], me, ve, we);
    p[i] = pe;
    m[i] = me;
    v[i] = ve;
    if (kMaster) w[i] = we;
  }
}

template <typename P, typename S, bool kMaster>
int launch_adam(const AdamArgs& a, long long n_chunks, cudaStream_t s) {
  fused_adam_kernel<P, S, kMaster>
      <<<dim3((unsigned)n_chunks), kThreads, 0, s>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Each returns a
// cudaError_t value (0 on launches that were accepted); the Python wrapper
// raises on anything else.
int fused_sqnorm_launch(const long long* ptrs, const long long* meta, int n,
                        long long n_chunks, int gtype, double* partials,
                        int max_partials, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks <= 0) {  // nothing to sum: 0
    cudaMemsetAsync(out, 0, sizeof(float), s);
    return int(cudaGetLastError());
  }
  const int blocks =
      int(n_chunks < max_partials ? n_chunks : (long long)max_partials);
  switch (gtype) {
    case 0:
      fused_sqnorm_partials_kernel<float>
          <<<blocks, kThreads, 0, s>>>(ptrs, meta, n, n_chunks, partials);
      break;
    case 1:
      fused_sqnorm_partials_kernel<__nv_bfloat16>
          <<<blocks, kThreads, 0, s>>>(ptrs, meta, n, n_chunks, partials);
      break;
    case 2:
      fused_sqnorm_partials_kernel<__half>
          <<<blocks, kThreads, 0, s>>>(ptrs, meta, n, n_chunks, partials);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  fused_sqnorm_final_kernel<<<1, 1024, 0, s>>>(partials, blocks, out);
  return int(cudaGetLastError());
}

int fused_adam_launch(const long long* ptrs, const long long* meta, int n,
                      long long n_chunks, int ptype, int master, void* m,
                      void* v, float* w, float* b1p, float* b2p, int n_pows,
                      const float* scale, float lr, float beta1, float beta2,
                      float omb1, float omb2, float eps, int decay_kind,
                      float decay_coeff, int has_wd, float wd_factor,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_adam_pows_kernel<<<1, 256, 0, s>>>(b1p, b2p, n_pows, beta1, beta2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  if (n_chunks <= 0) return 0;
  AdamArgs a{ptrs, meta, n, m, v, w, b1p, b2p, scale, lr, beta1, beta2,
             omb1, omb2, eps, decay_kind, decay_coeff, has_wd, wd_factor};
  switch (ptype * 2 + (master ? 1 : 0)) {
    case 0: return launch_adam<float, float, false>(a, n_chunks, s);
    case 2:
      return launch_adam<__nv_bfloat16, __nv_bfloat16, false>(a, n_chunks, s);
    case 3: return launch_adam<__nv_bfloat16, float, true>(a, n_chunks, s);
    case 4: return launch_adam<__half, __half, false>(a, n_chunks, s);
    case 5: return launch_adam<__half, float, true>(a, n_chunks, s);
    default: return int(cudaErrorInvalidValue);  // an f32 master of f32
  }
}

const char* fused_update_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
