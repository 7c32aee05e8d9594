// Hopper (sm_90a) kernel of the Mamba2 SSD chunked scan, bound through a
// plain C interface (ctypes; see ../ops.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (_ssd_kernel):
//   for each (b, h) and each chunk of c steps, with seg the inclusive
//   cumsum of dt * A over the chunk,
//     intra-chunk   y_q  = sum_{k <= q} (C_q . B_k) exp(seg_q - seg_k) dt_k x_k
//     entering      y_q += exp(seg_q) (C_q . state)
//     state update  state' = exp(seg_end) state
//                            + sum_k exp(seg_end - seg_k) dt_k x_k B_k^T
//   with the (P, N) state carried across chunks in float32.  y is written in
//   x's dtype, the final state in float32.
//
// What differs from the Pallas kernel:
//   - The TPU walks the chunks as the minor-most grid axis with the state in
//     VMEM scratch.  Here one block owns one (b, h) and loops over its
//     chunks, with the state in shared memory; blocks share nothing.
//   - One chunk (c up to 256 rows of x, B and C) does not fit in shared
//     memory as float32.  The chunk is cut into 64-row tiles: a query tile
//     of C meets the key tiles at or below the diagonal (tiles above it are
//     skipped, as the causal mask would zero them), and a second sweep over
//     the key tiles updates the state.  seg, dt and the state-update weights
//     exp(seg_end - seg_k) dt_k are computed once per chunk.
//   - exp(seg_q - seg_k) is formed from the difference and only for k <= q:
//     seg falls by up to hundreds over a chunk, so exp(seg_q) exp(-seg_k)
//     and exp of the masked differences would overflow.
//   - B and C are read through their group (head h reads group
//     h / (H / G)), as the reference's jnp.repeat to heads would give, so
//     the head-expanded copies are never written.
//   - A is given per sequence and head, (B, H), so a caller that folds
//     several parameter sets into the batch (torch.func.vmap over users) can
//     give each its own A.
//
// Bound on an H100 at the serving shape (B = 16, L = 1024, H = 24, P = 64,
// N = 128, G = 1, chunk 256, bfloat16): the scan needs c(c+1)N + c(c+1)P
// operations per (b, h, chunk) for the causal half of the intra-chunk
// products and 4cPN for the entering state and the state update, about
// 32.3 GFLOP in all: 0.033 ms at the 989 TFLOP/s bf16 tensor rate; x, dt,
// B, C, y and the state move about 123 MB, 0.037 ms at 3.35 TB/s.  Bytes
// bind.  This kernel is far from that bound: plain float32 FMA on the CUDA
// cores (the causal half of the intra-chunk products only), no tensor
// cores, no TMA, no pipelining, one block per (b, h) — later work.
// Thread layout: 256 threads as 16 x 16; a thread owns a 4 x 4 block of
// each 64 x 64 product (rows ty + 16 i, columns tx + 16 j) and 4 x 8 of the
// 64 x 128 state.
// Rows read by 16 lanes at once are padded by 4 words, so a lane's 16-byte
// loads of consecutive rows fall in distinct banks.
//
// The kernel does not allocate or synchronise; it launches on the stream it
// is given, and the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of a query or key tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kMaxP = 64;          // head dim (zero-padded to it)
constexpr int kMaxN = 128;         // state size (zero-padded to it)
constexpr int kMaxChunk = 256;
constexpr int kLdN = kMaxN + 4;    // row stride of C, B and state tiles
constexpr int kLdM = kTile + 4;    // row stride of the M tile

enum { DT_F32 = 0, DT_BF16 = 1 };

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Stage rows [t0, t0 + kTile) of the chunk (rows past `rows` are zero) of a
// (.., width) slice whose row r starts at src + r * stride, into a float32
// tile with row stride ld and `cols` columns; columns past width are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, int cols,
                                          const T* __restrict__ src,
                                          size_t stride, int rows,
                                          int width) {
  for (int idx = threadIdx.x; idx < kTile * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    float v = 0.f;
    if (r < rows && c < width) v = to_f32(src[(size_t)r * stride + c]);
    dst[r * ld + c] = v;
  }
}

struct Smem {
  float* c;      // query tile of C   (kTile, kLdN)
  float* b;      // key tile of B     (kTile, kLdN)
  float* x;      // key tile of x     (kTile, kMaxP)
  float* m;      // masked decay tile (kTile, kLdM)
  float* s;      // state             (kMaxP, kLdN)
  float* dt;     // the chunk's dt    (kMaxChunk)
  float* seg;    // inclusive cumsum of dt * A
  float* w;      // exp(seg_end - seg_k) * dt_k
};

constexpr size_t smem_floats() {
  return 2 * kTile * kLdN + kTile * kMaxP + kTile * kLdM + kMaxP * kLdN +
         3 * kMaxChunk;
}

// x (Bsz, L, H, P), dt (Bsz, L, H) f32, A (Bsz, H) f32, Bg/Cg (Bsz, L, G,
// N); y (Bsz, L, H, P), state (Bsz, H, P, N) f32.  One block per (b, h).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bg,
                const T* __restrict__ Cg, T* __restrict__ y,
                float* __restrict__ state, int L, int H, int P, int G, int N,
                int chunk) {
  extern __shared__ __align__(16) float smem[];
  Smem sm;
  sm.c = smem;
  sm.b = sm.c + kTile * kLdN;
  sm.x = sm.b + kTile * kLdN;
  sm.m = sm.x + kTile * kMaxP;
  sm.s = sm.m + kTile * kLdM;
  sm.dt = sm.s + kMaxP * kLdN;
  sm.seg = sm.dt + kMaxChunk;
  sm.w = sm.seg + kMaxChunk;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int g = h / (H / G);
  const float a = A[bh];
  const int nc = L / chunk;
  const int nt = (chunk + kTile - 1) / kTile;
  // row strides (elements) of x/y, B/C and dt along the sequence
  const size_t xs = (size_t)H * P, bs = (size_t)G * N;

  for (int i = tid; i < kMaxP * kLdN; i += kThreads) sm.s[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const size_t t_chunk = (size_t)b * L + (size_t)ci * chunk;
    for (int i = tid; i < chunk; i += kThreads)
      sm.dt[i] = dt[(t_chunk + i) * H + h];
    __syncthreads();
    // inclusive scan of dt * A over the chunk: warp 0, a run per lane
    if (warp == 0) {
      const int per = (chunk + 31) / 32, beg = lane * per;
      float run = 0.f;
      for (int i = 0; i < per; ++i)
        if (beg + i < chunk) run += sm.dt[beg + i] * a;
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float pre = incl - run;
      for (int i = 0; i < per; ++i)
        if (beg + i < chunk) {
          pre += sm.dt[beg + i] * a;
          sm.seg[beg + i] = pre;
        }
    }
    __syncthreads();
    const float seg_end = sm.seg[chunk - 1];
    for (int i = tid; i < chunk; i += kThreads)
      sm.w[i] = expf(seg_end - sm.seg[i]) * sm.dt[i];
    // (the first __syncthreads below orders these writes before any read)

    // --- outputs: one query tile at a time ------------------------------
    for (int qt = 0; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      const int qrows = min(kTile, chunk - q0);
      load_rows(sm.c, kLdN, kMaxN, Cg + (t_chunk + q0) * bs + (size_t)g * N,
                bs, qrows, N);
      __syncthreads();
      float acc[4][4];
      // the entering state: exp(seg_q) (C_q . state_p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < kMaxN; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(
              &sm.c[(ty + 16 * i) * kLdN + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sv[j] = *reinterpret_cast<const float4*>(
              &sm.s[(tx + 16 * j) * kLdN + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty + 16 * i;
        const float e = q < qrows ? expf(sm.seg[q0 + q]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // intra-chunk: key tiles at or below the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        const int krows = min(kTile, chunk - k0);
        load_rows(sm.b, kLdN, kMaxN,
                  Bg + (t_chunk + k0) * bs + (size_t)g * N, bs, krows, N);
        load_rows(sm.x, kMaxP, kMaxP, x + (t_chunk + k0) * xs + (size_t)h * P,
                  xs, krows, P);
        __syncthreads();
        float cb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
        for (int n = 0; n < kMaxN; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(
                &sm.c[(ty + 16 * i) * kLdN + n]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(
                &sm.b[(tx + 16 * j) * kLdN + n]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] = dot4(cv[i], bv[j], cb[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty + 16 * i;           // position in the chunk
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            float mv = 0.f;
            if (k <= q && q < chunk)
              mv = cb[i][j] * expf(sm.seg[q] - sm.seg[k]) * sm.dt[k];
            sm.m[(ty + 16 * i) * kLdM + tx + 16 * j] = mv;
          }
        }
        __syncthreads();
        for (int k = 0; k < kTile; k += 4) {
          float4 mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mv[i] = *reinterpret_cast<const float4*>(
                &sm.m[(ty + 16 * i) * kLdM + k]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              xv[j] = sm.x[(k + kk) * kMaxP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float mk = kk == 0   ? mv[i].x
                               : kk == 1 ? mv[i].y
                               : kk == 2 ? mv[i].z
                                         : mv[i].w;
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mk, xv[j], acc[i][j]);
            }
          }
        }
        __syncthreads();   // before the next tiles overwrite b, x and m
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty + 16 * i;
        if (q >= qrows) continue;
        T* yrow = y + (t_chunk + q0 + q) * xs + (size_t)h * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = from_f32<T>(acc[i][j]);
        }
      }
    }

    // --- state update: a second sweep over the key tiles ----------------
    float ds[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ds[i][j] = 0.f;
    for (int kt = 0; kt < nt; ++kt) {
      const int k0 = kt * kTile;
      const int krows = min(kTile, chunk - k0);
      load_rows(sm.b, kLdN, kMaxN, Bg + (t_chunk + k0) * bs + (size_t)g * N,
                bs, krows, N);
      load_rows(sm.x, kMaxP, kMaxP, x + (t_chunk + k0) * xs + (size_t)h * P,
                xs, krows, P);
      __syncthreads();
      for (int k = 0; k < krows; ++k) {
        const float wk = sm.w[k0 + k];
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = wk * sm.x[k * kMaxP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sm.b[k * kLdN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) ds[i][j] = fmaf(xv[i], bv[j], ds[i][j]);
      }
      __syncthreads();
    }
    const float decay = expf(seg_end);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* s = &sm.s[(ty + 16 * i) * kLdN + tx + 16 * j];
        *s = fmaf(decay, *s, ds[i][j]);
      }
    __syncthreads();
  }

  float* out = state + (size_t)bh * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx - (idx / N) * N;
    out[idx] = sm.s[p * kLdN + n];
  }
}

bool valid(int Bsz, int L, int H, int P, int G, int N, int chunk,
           int dtype) {
  return Bsz >= 1 && L >= 1 && H >= 1 && G >= 1 && H % G == 0 && P >= 1 &&
         P <= kMaxP && N >= 1 && N <= kMaxN && chunk >= 1 &&
         chunk <= kMaxChunk && L % chunk == 0 &&
         (long long)Bsz * H <= 0x7fffffffLL &&
         (dtype == DT_F32 || dtype == DT_BF16);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bg, const void* Cg, void* y, void* state,
                   int Bsz, int L, int H, int P, int G, int N, int chunk,
                   cudaStream_t s) {
  auto kernel = ssd_scan_kernel<T>;
  const size_t bytes = smem_floats() * sizeof(float);
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<(unsigned)((long long)Bsz * H), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bg),
      static_cast<const T*>(Cg), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, G, N, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest head dim, state size and chunk the kernel takes.
int repro_ssd_max_head_dim() { return kMaxP; }
int repro_ssd_max_state() { return kMaxN; }
int repro_ssd_max_chunk() { return kMaxChunk; }

// x (Bsz, L, H, P) and Bg/Cg (Bsz, L, G, N) contiguous in one dtype (f32 or
// bf16); dt (Bsz, L, H) and A (Bsz, H) float32; y (Bsz, L, H, P) in x's
// dtype; state (Bsz, H, P, N) float32.  L a multiple of chunk.
int repro_ssd_scan(const void* x, const void* dt, const void* A,
                   const void* Bg, const void* Cg, void* y, void* state,
                   int Bsz, int L, int H, int P, int G, int N, int chunk,
                   int dtype, void* stream) {
  if (!valid(Bsz, L, H, P, G, N, chunk, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == DT_F32
          ? launch<float>(x, dt, A, Bg, Cg, y, state, Bsz, L, H, P, G, N,
                          chunk, s)
          : launch<__nv_bfloat16>(x, dt, A, Bg, Cg, y, state, Bsz, L, H, P,
                                  G, N, chunk, s);
  return (int)err;
}

}  // extern "C"
