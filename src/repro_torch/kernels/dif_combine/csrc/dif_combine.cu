// Hopper (sm_90a) kernels for the Dif-MAML outer update, bound through a
// plain C interface (ctypes; see ../ops.py).
//
// dif_combine — replaces the Pallas TPU kernel
//   src/repro/kernels/dif_combine/dif_combine.py::dif_combine
//   (_combine_kernel): paper eq. 6b, out[k, m] = sum_l A[l, k] * phi[l, m],
//   float32 accumulation, output in phi's dtype.
//   Bound on an H100: memory bytes.  It does 2K flops per element it moves
//   (K <= 64), far below the ~20 flop/byte where the CUDA cores' 67 TFLOP/s
//   would bind, so the least time is 2*K*M*itemsize bytes at 3.35 TB/s.
//   Design: the Pallas grid (K, M/bm) re-reads the (K, bm) phi tile once per
//   output row.  Here a block stages a (K, C) column tile in shared memory
//   from ONE coalesced pass over device memory (16 bytes a thread where the
//   buffer is aligned), then emits all K output rows of those columns from
//   the staged tile; A sits in shared memory too.  Every byte of phi is read
//   once and every output byte written once.  The tile is laid out
//   (row, vector lane, thread): the VEC values a thread loads land T words
//   apart, so a warp's shared-memory stores and loads touch 32 consecutive
//   words.  Laid out (row, column), they sat VEC words apart, and the 4- or
//   8-way bank conflicts, not device memory, bounded the kernel.
//
// fused_combine_update — replaces the Pallas TPU kernel
//   src/repro/kernels/dif_combine/dif_combine.py::fused_combine_update
//   (_fused_kernel): per column, clip scale -> fp32 optimizer moments (adam
//   with bias corrections from ctl and decoupled weight decay; momentum;
//   sgd) -> mix (atc A_eff(w+u), consensus A_eff w + u, local w + u) with
//   A_eff = gate * A[sel] + (1 - gate) * I.
//   Bound on an H100: memory bytes, the 4P + 4F traffic contract of the
//   reference module docstring (read w, g, mu, nu once; write w', mu', nu'
//   once).  Design: phase 1 streams each (row, column group) once, advances
//   the moments in registers and writes them straight back, and leaves the
//   row's mix input in a shared-memory tile (laid out as dif_combine's, free
//   of bank conflicts); phase 2 mixes the K rows of each column from it.  sel and ctl stay device tensors read
//   here (no host round trip); every block gathers A[sel] from the (S, K, K)
//   table into shared memory and forms A_eff there.  Elementwise math uses
//   the round-to-nearest intrinsics so nothing is contracted into an FMA:
//   each expression is the one repro_torch/optim/optimizers.py evaluates,
//   in the same order.  Zero-padded columns stay exactly zero (eps > 0).
//
// Neither kernel allocates or synchronises; both launch on the stream they
// are given, and each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kTileBytes = 32 * 1024;   // staged tile budget (A adds <= 16 KB)
constexpr int kTargetBlocks = 264;      // two blocks per SM of an H100

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { KIND_SGD = 0, KIND_MOMENTUM = 1, KIND_ADAM = 2 };
enum { MODE_ATC = 0, MODE_CONSENSUS = 1, MODE_LOCAL = 2 };

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(x.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[N]) {
  Vec<T, N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, N>*>(p) = x;
}

// Column groups per block (T): the (rows, vec, T) fp32 tile(s) fit the
// budget, and a small M is spread over up to kTargetBlocks blocks, down to
// T = 32, so that a block's rows x T items take few passes of its threads.
int tile_groups(int rows, int vec, int tiles, long long M) {
  int t = kTileBytes / (tiles * rows * vec * 4);
  if (t > kThreads) t = kThreads;
  const long long groups = (M + vec - 1) / vec;
  const long long per_block = (groups + kTargetBlocks - 1) / kTargetBlocks;
  const long long want = per_block <= 32 ? 32 : (per_block + 31) / 32 * 32;
  if (want < t) t = (int)want;
  if (t >= 32) t -= t % 32;
  return t < 1 ? 1 : t;
}

// ---------------------------------------------------------------------------
// dif_combine
// ---------------------------------------------------------------------------

template <typename P, int VEC>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ A, const P* __restrict__ phi,
               P* __restrict__ out, int K, long long M, int T) {
  extern __shared__ float smem[];
  float* As = smem;                   // (K, K)
  float* tile = smem + K * K;         // (K, VEC, T): see kernel note
  const long long col0 = (long long)blockIdx.x * T * VEC;
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) As[i] = A[i];
  const int items = K * T;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int l = i / T, gi = i - l * T;
    const long long c = col0 + (long long)gi * VEC;
    if (c >= M) continue;
    float x[VEC];
    load_vec<P, VEC>(phi + (long long)l * M + c, x);
    float* dst = tile + l * VEC * T + gi;
#pragma unroll
    for (int v = 0; v < VEC; ++v) dst[v * T] = x[v];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int k = i / T, gi = i - k * T;
    const long long c = col0 + (long long)gi * VEC;
    if (c >= M) continue;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int l = 0; l < K; ++l) {
      const float a = As[l * K + k];
      const float* src = tile + l * VEC * T + gi;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(a, src[v * T]));
    }
    store_vec<P, VEC>(out + (long long)k * M + c, acc);
  }
}

template <typename P, int VEC>
void launch_combine(const float* A, const P* phi, P* out, int K, long long M,
                    cudaStream_t stream) {
  const int T = tile_groups(K, VEC, 1, M);
  const long long width = (long long)T * VEC;
  const unsigned blocks = (unsigned)((M + width - 1) / width);
  const size_t shmem = (size_t)(K * K + K * width) * sizeof(float);
  combine_kernel<P, VEC><<<blocks, kThreads, shmem, stream>>>(A, phi, out, K,
                                                              M, T);
}

// ---------------------------------------------------------------------------
// fused_combine_update
// ---------------------------------------------------------------------------

struct Hyper {
  float neg_lr;    // -lr
  float b1, omb1;  // adam: b1, 1 - b1
  float b2, omb2;  // adam: b2, 1 - b2
  float eps;
  float lr_wd;     // lr * weight_decay (0: no decay)
  float beta;      // momentum
};

// Moment type: adam keeps fp32 moments, momentum a velocity in the param
// dtype, sgd none (the pointer is unused).
template <typename P, int KIND>
using MomT = typename std::conditional<KIND == KIND_ADAM, float, P>::type;

template <typename P, int KIND, int MODE, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ table, const int* __restrict__ sel,
             const float* __restrict__ ctl, const float* __restrict__ scale,
             const P* __restrict__ w, const P* __restrict__ g,
             const MomT<P, KIND>* __restrict__ mu,
             const float* __restrict__ nu, P* __restrict__ w_out,
             MomT<P, KIND>* __restrict__ mu_out, float* __restrict__ nu_out,
             int S, int K, long long M, int T, Hyper h) {
  extern __shared__ float smem[];
  float* Ae = smem;                   // (K, K) A_eff
  float* phi_t = smem + K * K;        // (K, VEC, T) mix input
  float* u_t = phi_t + K * T * VEC;   // (K, VEC, T) consensus: u
  const long long col0 = (long long)blockIdx.x * T * VEC;

  if (MODE != MODE_LOCAL) {
    const int s = sel[0];
    const float gate = ctl[0];
    const float keep = __fsub_rn(1.f, gate);
    for (int i = threadIdx.x; i < K * K; i += blockDim.x) {
      // an out-of-range row selects nothing, as the one-hot gather does
      const float a = (s >= 0 && s < S) ? table[(long long)s * K * K + i] : 0.f;
      const float eye = (i / K == i % K) ? 1.f : 0.f;
      Ae[i] = __fadd_rn(__fmul_rn(gate, a), __fmul_rn(keep, eye));
    }
  }
  const float bc1 = ctl[1], bc2 = ctl[2];

  const int items = K * T;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int l = i / T, gi = i - l * T;
    const long long c = col0 + (long long)gi * VEC;
    if (c >= M) continue;
    const long long off = (long long)l * M + c;
    const float sc = scale[l];
    float w32[VEC], g32[VEC], u[VEC];
    load_vec<P, VEC>(w + off, w32);
    load_vec<P, VEC>(g + off, g32);
#pragma unroll
    for (int v = 0; v < VEC; ++v) g32[v] = __fmul_rn(g32[v], sc);
    if (KIND == KIND_ADAM) {
      float m[VEC], n[VEC];
      load_vec<float, VEC>(reinterpret_cast<const float*>(mu) + off, m);
      load_vec<float, VEC>(nu + off, n);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        m[v] = __fadd_rn(__fmul_rn(h.b1, m[v]), __fmul_rn(h.omb1, g32[v]));
        n[v] = __fadd_rn(__fmul_rn(h.b2, n[v]),
                         __fmul_rn(h.omb2, __fmul_rn(g32[v], g32[v])));
        u[v] = __fdiv_rn(__fmul_rn(h.neg_lr, __fdiv_rn(m[v], bc1)),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(n[v], bc2)), h.eps));
        if (h.lr_wd != 0.f) u[v] = __fsub_rn(u[v], __fmul_rn(h.lr_wd, w32[v]));
      }
      store_vec<float, VEC>(reinterpret_cast<float*>(mu_out) + off, m);
      store_vec<float, VEC>(nu_out + off, n);
    } else if (KIND == KIND_MOMENTUM) {
      float vel[VEC];
      load_vec<P, VEC>(reinterpret_cast<const P*>(mu) + off, vel);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        vel[v] = __fadd_rn(__fmul_rn(h.beta, vel[v]), g32[v]);
        u[v] = __fmul_rn(h.neg_lr, vel[v]);
      }
      store_vec<P, VEC>(reinterpret_cast<P*>(mu_out) + off, vel);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) u[v] = __fmul_rn(h.neg_lr, g32[v]);
    }
    if (MODE == MODE_LOCAL) {
      float nw[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) nw[v] = __fadd_rn(w32[v], u[v]);
      store_vec<P, VEC>(w_out + off, nw);
    } else {
      float* pdst = phi_t + l * VEC * T + gi;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        pdst[v * T] = (MODE == MODE_ATC) ? __fadd_rn(w32[v], u[v]) : w32[v];
      if (MODE == MODE_CONSENSUS) {
        float* udst = u_t + l * VEC * T + gi;
#pragma unroll
        for (int v = 0; v < VEC; ++v) udst[v * T] = u[v];
      }
    }
  }
  if (MODE == MODE_LOCAL) return;
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int k = i / T, gi = i - k * T;
    const long long c = col0 + (long long)gi * VEC;
    if (c >= M) continue;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int l = 0; l < K; ++l) {
      const float a = Ae[l * K + k];
      const float* src = phi_t + l * VEC * T + gi;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(a, src[v * T]));
    }
    if (MODE == MODE_CONSENSUS) {
      const float* usrc = u_t + k * VEC * T + gi;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], usrc[v * T]);
    }
    store_vec<P, VEC>(w_out + (long long)k * M + c, acc);
  }
}

template <typename P, int KIND, int MODE, int VEC>
void launch_fused_vec(const float* table, const int* sel, const float* ctl,
                      const float* scale, const void* w, const void* g,
                      const void* mu, const void* nu, void* w_out,
                      void* mu_out, void* nu_out, int S, int K, long long M,
                      Hyper h, cudaStream_t stream) {
  const int tiles = MODE == MODE_CONSENSUS ? 2 : 1;
  const int T = tile_groups(K, VEC, tiles, M);
  const long long width = (long long)T * VEC;
  const unsigned blocks = (unsigned)((M + width - 1) / width);
  const size_t shmem =
      MODE == MODE_LOCAL ? 0 : (size_t)(K * K + tiles * K * width) * sizeof(float);
  using MT = MomT<P, KIND>;
  fused_kernel<P, KIND, MODE, VEC><<<blocks, kThreads, shmem, stream>>>(
      table, sel, ctl, scale, static_cast<const P*>(w),
      static_cast<const P*>(g), static_cast<const MT*>(mu),
      static_cast<const float*>(nu), static_cast<P*>(w_out),
      static_cast<MT*>(mu_out), static_cast<float*>(nu_out), S, K, M, T, h);
}

template <typename P, int KIND, int MODE>
void launch_fused_mode(bool vec, const float* table, const int* sel,
                       const float* ctl, const float* scale, const void* w,
                       const void* g, const void* mu, const void* nu,
                       void* w_out, void* mu_out, void* nu_out, int S, int K,
                       long long M, Hyper h, cudaStream_t stream) {
  if (vec)
    launch_fused_vec<P, KIND, MODE, 4>(table, sel, ctl, scale, w, g, mu, nu,
                                       w_out, mu_out, nu_out, S, K, M, h,
                                       stream);
  else
    launch_fused_vec<P, KIND, MODE, 1>(table, sel, ctl, scale, w, g, mu, nu,
                                       w_out, mu_out, nu_out, S, K, M, h,
                                       stream);
}

template <typename P, int KIND>
void launch_fused_kind(int mode, bool vec, const float* table, const int* sel,
                       const float* ctl, const float* scale, const void* w,
                       const void* g, const void* mu, const void* nu,
                       void* w_out, void* mu_out, void* nu_out, int S, int K,
                       long long M, Hyper h, cudaStream_t stream) {
#define REPRO_FUSED_ARGS vec, table, sel, ctl, scale, w, g, mu, nu, w_out, \
    mu_out, nu_out, S, K, M, h, stream
  if (mode == MODE_ATC)
    launch_fused_mode<P, KIND, MODE_ATC>(REPRO_FUSED_ARGS);
  else if (mode == MODE_CONSENSUS)
    launch_fused_mode<P, KIND, MODE_CONSENSUS>(REPRO_FUSED_ARGS);
  else
    launch_fused_mode<P, KIND, MODE_LOCAL>(REPRO_FUSED_ARGS);
#undef REPRO_FUSED_ARGS
}

template <typename P>
void launch_fused_dtype(int kind, int mode, bool vec, const float* table,
                        const int* sel, const float* ctl, const float* scale,
                        const void* w, const void* g, const void* mu,
                        const void* nu, void* w_out, void* mu_out,
                        void* nu_out, int S, int K, long long M, Hyper h,
                        cudaStream_t stream) {
#define REPRO_FUSED_ARGS mode, vec, table, sel, ctl, scale, w, g, mu, nu, \
    w_out, mu_out, nu_out, S, K, M, h, stream
  if (kind == KIND_ADAM)
    launch_fused_kind<P, KIND_ADAM>(REPRO_FUSED_ARGS);
  else if (kind == KIND_MOMENTUM)
    launch_fused_kind<P, KIND_MOMENTUM>(REPRO_FUSED_ARGS);
  else
    launch_fused_kind<P, KIND_SGD>(REPRO_FUSED_ARGS);
#undef REPRO_FUSED_ARGS
}

}  // namespace

extern "C" {

int repro_max_agents() { return kMaxK; }

// out (K, M) = A^T phi; A (K, K) float32; phi/out float32 or bfloat16.
// vec: every pointer is 16-byte aligned and M a multiple of 16/itemsize.
int repro_dif_combine(const void* A, const void* phi, void* out, int K,
                      long long M, int dtype, int vec, void* stream) {
  if (K < 1 || K > kMaxK || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  if (dtype == DT_F32) {
    const float* p = static_cast<const float*>(phi);
    float* o = static_cast<float*>(out);
    if (vec) launch_combine<float, 4>(a, p, o, K, M, s);
    else launch_combine<float, 1>(a, p, o, K, M, s);
  } else if (dtype == DT_BF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(phi);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec) launch_combine<__nv_bfloat16, 8>(a, p, o, K, M, s);
    else launch_combine<__nv_bfloat16, 1>(a, p, o, K, M, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One-pass combine-then-update over a (K, M) group; see the header comment.
// vec: every pointer is 4-element aligned and M a multiple of 4.
int repro_fused_update(const void* table, const void* sel, const void* ctl,
                       const void* scale, const void* w, const void* g,
                       const void* mu, const void* nu, void* w_out,
                       void* mu_out, void* nu_out, int S, int K, long long M,
                       int dtype, int kind, int mode, int vec, float neg_lr,
                       float b1, float omb1, float b2, float omb2, float eps,
                       float lr_wd, float beta, void* stream) {
  if (K < 1 || K > kMaxK || M < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (kind < KIND_SGD || kind > KIND_ADAM) return (int)cudaErrorInvalidValue;
  if (mode < MODE_ATC || mode > MODE_LOCAL) return (int)cudaErrorInvalidValue;
  Hyper h{neg_lr, b1, omb1, b2, omb2, eps, lr_wd, beta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(table);
  const int* sl = static_cast<const int*>(sel);
  const float* ct = static_cast<const float*>(ctl);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == DT_F32)
    launch_fused_dtype<float>(kind, mode, vec != 0, tab, sl, ct, sc, w, g, mu,
                              nu, w_out, mu_out, nu_out, S, K, M, h, s);
  else if (dtype == DT_BF16)
    launch_fused_dtype<__nv_bfloat16>(kind, mode, vec != 0, tab, sl, ct, sc,
                                      w, g, mu, nu, w_out, mu_out, nu_out, S,
                                      K, M, h, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
