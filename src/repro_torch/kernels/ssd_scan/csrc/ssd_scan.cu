// Hopper (sm_90a) kernels of the Mamba2 SSD chunked scan, bound through a
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
// T3, the scan's forward-mode tangent (the jvp rule of the autograd
// Function in ../ops.py; no TPU counterpart), has the same two routes:
// three Hopper passes in bfloat16 (namespace t3) and a CUDA-core kernel in
// float32 (namespace jvpk), both near the end.
//
// Two routes, chosen by dtype in ../ops.py:
//
// bfloat16 (namespace hop, below): written for Hopper, three launches on
// the tensor cores (chunk states, states passed across chunks, chunk
// outputs with C B^T shared by a group's heads).
//
// float32: one block per (b, h), walking its chunks with the state in
// shared memory, plain FMA on the CUDA cores.  What it does differently
// from the Pallas kernel:
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
// At the serving shape in float32 the scan needs about 32.3 GFLOP (the
// causal half of the c x c products), 0.48 ms at the 67 TFLOP/s float32
// rate: operations bind.  Thread layout: 256 threads as 16 x 16; a thread
// owns a 4 x 4 block of each 64 x 64 product (rows ty + 16 i, columns
// tx + 16 j) and 4 x 8 of the 64 x 128 state.  Rows read by 16 lanes at
// once are padded by 4 words, so a lane's 16-byte loads of consecutive rows
// fall in distinct banks.
//
// No kernel allocates or synchronises; each launches on the stream it is
// given, and each C entry returns cudaGetLastError().

#include <cuda.h>
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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ===========================================================================
// bfloat16 on Hopper: three passes, two of them on the tensor cores
// ===========================================================================
//
// The SSD algorithm of arXiv:2405.21060 §6, in three launches:
//
//   1. chunk_state_kernel, one block per (heads of a group, chunk, b): for
//      each head seg (the inclusive cumsum of dt * A over the chunk,
//      written to a (B, H, L) float32 workspace), w_k = exp(seg_end -
//      seg_k) dt_k, and the chunk's own state S_c = (x * w)^T B, a (P x c)
//      (c x N) product, into a (B, nc, H, P, N) float32 workspace; the B
//      tiles are loaded once for all the block's heads.
//   2. state_pass_kernel, elementwise over (b, h, P, N): s_in[c + 1] =
//      exp(seg_end_c) s_in[c] + S_c from s_in[0] = 0, sequential over the nc
//      chunks only.  The entering states of chunks 1 .. nc - 1 are written as
//      two bf16 planes, hi = bf16(s) and lo = bf16(s - hi), (B, nc - 1, H, P,
//      N) each; the final state in float32.
//   3. chunk_scan_kernel, one block per (64-row query tile, group of heads,
//      b * nc + chunk): C B^T of its query tile against the key tiles at or
//      below the diagonal is computed once, kept in registers and reused by
//      every head the block owns (all heads of a block share a B/C group);
//      then for each head y = exp(seg_q) (C s_in^T) + M x with M = C B^T *
//      exp(seg_q - seg_k)[k <= q] * dt_k, M staged in shared memory as
//      hi/lo bf16 tiles (stmatrix) for the tensor cores.
//
// Everything intra-chunk is independent across chunks, so passes 1 and 3
// fill the card (256 and 1,536 blocks at the serving shape, two an SM);
// only the elementwise pass 2 walks the chunks in order.  Passes 1 and 2
// fused (a block per (h, b) walking its chunks, S kept in registers) ran
// no faster on an H100: the chunk loop's latency outweighed the saved
// round trip of S (PERF.md).
//
// Tiles are 64 rows x 64 bf16 columns to an 8 KB region (N <= 128: two),
// each row a 128-byte line with the 128-byte swizzle that TMA writes and
// wgmma's descriptors name, as in ../../flash_attention/csrc.  x, B, C and y
// are read and written by TMA through 4-d tensor maps (columns, heads, rows
// of a chunk, b * nc + chunk) of the model's contiguous (B, L, H, P) and
// (B, L, G, N) layouts: rows past the chunk's end and columns past P or N
// are zero-filled on loads and clipped on stores, so ragged chunks (32, 48)
// and narrow heads need no padding by the caller, and B/C are read by
// group, never expanded to heads.
//
// Numerics: every product accumulates in float32.  x, B and C are bf16 and
// exact; the float32 operands (x * w in pass 1, M and the entering state in
// pass 3) enter the bf16 products as hi/lo pairs (about 16 significant
// bits).  seg stays float32; exp(seg_q - seg_k) is taken of the difference
// and only for k <= q (it is selected to 0 above the diagonal), since seg
// falls by hundreds over a chunk.  No accumulator is written by anything
// but wgmma between a fence and its wait (a first product overwrites
// instead of a zeroing): ptxas would otherwise serialize every wgmma of
// the kernel (its warning C7515).
//
// Bound at the serving shape (B = 16, L = 1024, H = 24, P = 64, N = 128,
// G = 1, chunk 256): the inputs and outputs move about 123 MB (0.037 ms at
// 3.35 TB/s).  Counting each pass's own reads and writes, this design moves
// 359 MB, 0.107 ms: chunk states 108 MB (S written, 50 MB), state passing
// 101 MB (S read; s_in written as hi/lo, 38 MB), chunk outputs 150 MB (x,
// B, C, dt and seg read again, s_in read).  Bytes bind: the least work is
// about 20 GFLOP with C B^T once per group, 0.02 ms at the 989 TFLOP/s bf16
// rate; pass 3 forms C B^T once per block of kScanHeads heads (6 times per
// group here) and the hi/lo halves double the products, still under the
// byte time.

namespace hop {

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;                  // threads of a warpgroup
constexpr int kM = 64;                    // rows of a tile (wgmma M)
constexpr int kTiles = kMaxChunk / kM;    // 64-row tiles of the longest chunk
constexpr uint32_t kRegion = 64 * 128;    // 64 rows x 64 bf16 columns, bytes
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r of a tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(c >> 3) * kRegion + (uint32_t)r * 128u +
         ((uint32_t)((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Rows [row0, row0 + 64) of head (or group) `head` of chunk bc = b * nc + c
// through a 4-d map (columns, heads, rows of a chunk, b * nc + c) into the
// tile at dst, NR column regions; completes on bar.  One thread.
template <int NR>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& m,
                                         uint32_t bar, int head, int row0,
                                         int bc) {
  const uint64_t map = reinterpret_cast<uint64_t>(&m);
#pragma unroll
  for (int r = 0; r < NR; ++r)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            dst + r * kRegion),
        "l"(map), "r"(bar), "r"(64 * r), "r"(head), "r"(row0), "r"(bc)
        : "memory");
}

// (P, N) matrix `mat` of a 3-d map (N, P, matrices) into the tile at dst.
template <int NR>
__device__ __forceinline__ void tma_load_plane(uint32_t dst,
                                               const CUtensorMap& m,
                                               uint32_t bar, int mat) {
  const uint64_t map = reinterpret_cast<uint64_t>(&m);
#pragma unroll
  for (int r = 0; r < NR; ++r)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst +
                                                          r * kRegion),
        "l"(map), "r"(bar), "r"(64 * r), "r"(0), "r"(mat)
        : "memory");
}

// The tile at src (one region) to rows [row0, row0 + 64) of head `head` of
// chunk bc, clipped at the map's ends; committed as a bulk group.
__device__ __forceinline__ void tma_store(uint32_t src, const CUtensorMap& m,
                                          int head, int row0, int bc) {
  const uint64_t map = reinterpret_cast<uint64_t>(&m);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map),
      "r"(src), "r"(0), "r"(head), "r"(row0), "r"(bc)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(&m))
               : "memory");
}

// Generic-proxy stores to shared memory made visible to TMA and wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_wg() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWG) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at addr:
// 8-row groups 1024 bytes apart (SBO), 64-column regions kRegion apart
// (LBO, read only MN-major).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kRegion >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are pending.
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from reading (or moving) accumulator registers across
// the asynchronous product's issue and wait.
template <int N> __device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
// The same for A fragments that an issued product still reads.
template <int K> __device__ __forceinline__ void keep(uint32_t (&x)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4 * K; ++i)
    asm volatile("" : "+r"(x[i / 4][i % 4])::"memory");
}

#define REPRO_ACC32(x)                                                       \
  "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]), "+f"(x[4]), "+f"(x[5]),   \
      "+f"(x[6]), "+f"(x[7]), "+f"(x[8]), "+f"(x[9]), "+f"(x[10]),          \
      "+f"(x[11]), "+f"(x[12]), "+f"(x[13]), "+f"(x[14]), "+f"(x[15]),      \
      "+f"(x[16]), "+f"(x[17]), "+f"(x[18]), "+f"(x[19]), "+f"(x[20]),      \
      "+f"(x[21]), "+f"(x[22]), "+f"(x[23]), "+f"(x[24]), "+f"(x[25]),      \
      "+f"(x[26]), "+f"(x[27]), "+f"(x[28]), "+f"(x[29]), "+f"(x[30]),      \
      "+f"(x[31])
#define REPRO_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REPRO_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64): A and B in shared memory,
// both K-major (B stored as 64 rows of 16); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64): A in shared memory
// K-major, B in shared memory MN-major (16 rows of 64 columns).
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : REPRO_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared memory,
// MN-major: 16 rows of 64 columns).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared memory,
// MN-major: 16 rows across two 64-column regions, kRegion apart by the
// descriptor's LBO).
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d), REPRO_ACC32((d + 32))
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// acc (+)= A B^T over the columns of NH regions: A and B 64-row tiles at
// shared a and b (both K-major).
template <int NH>
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a,
                                        uint32_t b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4 * NH; ++kk) {
    const uint32_t off = (kk >> 2) * kRegion + (kk & 3) * 32;
    wgmma_ss(acc, desc(a + off), desc(b + off), accumulate || kk > 0);
  }
}

// acc[c] (+)= (hi + lo) B[:, 64c .. 64c + 63]: hi/lo the two bf16 halves of
// a 64 x 64 float32 operand as A fragments, B a 64-row tile at shared b
// (rows the contraction, MN-major); with two regions one m64n128k16 a step;
// accumulate = false overwrites acc.
template <int NH>
__device__ __forceinline__ void mma_rs(float (&acc)[NH][32],
                                       const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4],
                                       uint32_t b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc(b + kk * 16 * 128);
    const int first = accumulate || kk > 0;
    if constexpr (NH == 2) {
      float (&flat)[64] = reinterpret_cast<float (&)[64]>(acc);
      wgmma_rs128(flat, hi[kk], db, first);
      wgmma_rs128(flat, lo[kk], db, 1);
    } else {
      wgmma_rs(acc[0], hi[kk], db, first);
      wgmma_rs(acc[0], lo[kk], db, 1);
    }
  }
}

// Accumulator element e of thread t (of its warpgroup) sits at row
// frag_row(e, t) and column frag_col(e, t) of the 64 x 64 result; register
// j of a k-step's A fragment holds elements 2j and 2j + 1 of that layout.
__device__ __forceinline__ int frag_row(int e, int t) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int e, int t) {
  return 8 * (e >> 2) + 2 * (t & 3) + (e & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// hi = bf16(a, b) and lo = bf16(a - hi_a, b - hi_b), packed.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Inclusive cumsum of dt[i] * a over i < chunk into seg: one warp, a run of
// consecutive steps a lane, then a shuffle scan of the runs.
__device__ __forceinline__ void chunk_cumsum(const float* dt, float* seg,
                                             float a, int chunk, int lane) {
  const int per = (chunk + 31) / 32, beg = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i)
    if (beg + i < chunk) run += dt[beg + i] * a;
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float pre = incl - run;
  for (int i = 0; i < per; ++i)
    if (beg + i < chunk) {
      pre += dt[beg + i] * a;
      seg[beg + i] = pre;
    }
}

// ---------------------------------------------------------------------------
// pass 1: the chunk states, one block per (heads of a group, chunk, b)
// ---------------------------------------------------------------------------

// Heads of one group a pass-1 block takes (fewer where the group has
// fewer): it loads the group's B tiles once for them.  Of mamba2-130m's 24
// heads, 6 give 256 blocks at the serving shape, two an SM (the fastest of
// 1, 2, 3, 4 and 6 on an H100).
constexpr int kStateHeads = 6;

struct StateArgs {
  CUtensorMap tx, tb;       // x (P, H, chunk, B*nc), B (N, G, chunk, B*nc)
  const float* dt;          // (B, L, H)
  const float* A;           // A[b * a_stride + h]
  float* S;                 // (B, nc, H, P, N)
  float* seg;               // (B, H, L)
  long long a_stride;
  int L, H, P, G, N, chunk, nc;
  int hpb;                  // heads a block takes (of one group)
};

template <int NH> constexpr size_t state_smem() {
  // B tiles of the whole chunk; x tiles of one head; each head's dt (then
  // w); a cumsum scratch a warp; barriers
  return 1024 + kTiles * (NH + 1) * kRegion +
         (kStateHeads + 4) * kMaxChunk * 4 + 8 * 2 * kTiles;
}

// hi/lo fragments of A = (w * x)^T for one key tile: A[p][k] = w[k] x[k][p]
// with x the swizzled tile (rows = steps k, columns = p) at xt.
__device__ __forceinline__ void wx_frags(const unsigned short* xt,
                                         const float* w, int t,
                                         uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
  const int r0 = frag_row(0, t);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = r0 + 8 * (j & 1);
      const int k = 16 * kk + 8 * (j >> 1) + 2 * (t & 3);
      const float2 wk = *reinterpret_cast<const float2*>(&w[k]);
      // elements (k, p) and (k + 1, p) of the swizzled tile
      const int at0 = k * 64 + ((((p >> 3) ^ (k & 7))) << 3) + (p & 7);
      const int at1 = (k + 1) * 64 + ((((p >> 3) ^ ((k + 1) & 7))) << 3) +
                      (p & 7);
      split2(wk.x * __uint_as_float((uint32_t)xt[at0] << 16),
             wk.y * __uint_as_float((uint32_t)xt[at1] << 16), hi[kk][j],
             lo[kk][j]);
    }
}

template <int NH>
__global__ void __launch_bounds__(kWG, 2)
chunk_state_kernel(const __grid_constant__ StateArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t BT = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const uint32_t sB = base, sX = base + kTiles * BT;
  float* w = reinterpret_cast<float*>(gbase + kTiles * (BT + kRegion));
  float* scratch = w + kStateHeads * kMaxChunk;
  const uint32_t bars = base + kTiles * (BT + kRegion) +
                        (kStateHeads + 4) * kMaxChunk * 4;
  auto bar_b = [&](int kt) { return bars + 8 * kt; };
  auto bar_x = [&](int kt) { return bars + 8 * (kTiles + kt); };
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int sets = gridDim.x / a.G;
  const int g = blockIdx.x / sets, set = blockIdx.x - g * sets;
  const int hg = a.H / a.G, h0 = g * hg + set * a.hpb;
  const int nh = min(a.hpb, hg - set * a.hpb);
  const int c = blockIdx.y, b = blockIdx.z, bc = b * a.nc + c;
  const int nt = (a.chunk + kM - 1) / kM;
  const long long step0 = (long long)b * a.L + (long long)c * a.chunk;
  auto load_x = [&](int h, int kt) {
    mbar_expect(bar_x(kt), kRegion);
    tma_load<1>(sX + kt * kRegion, a.tx, bar_x(kt), h, kt * kM, bc);
  };

  if (t == 0) {
    prefetch_map(a.tx);
    prefetch_map(a.tb);
    for (int i = 0; i < 2 * kTiles; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0)
    for (int kt = 0; kt < nt; ++kt) {  // B once for every head; head 0's x
      mbar_expect(bar_b(kt), BT);
      tma_load<NH>(sB + kt * BT, a.tb, bar_b(kt), g, kt * kM, bc);
      load_x(h0, kt);
    }
  // dt of the block's heads (zero past the chunk's end), heads fastest so
  // that neighbouring threads read neighbouring words
  for (int idx = t; idx < nh * nt * kM; idx += kWG) {
    const int i = idx / nh, j = idx - (idx / nh) * nh;
    w[j * kMaxChunk + i] = i < a.chunk ? a.dt[(step0 + i) * a.H + h0 + j]
                                       : 0.f;
  }
  __syncthreads();
  // seg of head j (warp j % 4), written out; w = exp(seg_end - seg) dt in
  // dt's place
  for (int j = warp; j < nh; j += 4) {
    float* wj = w + j * kMaxChunk;
    float* seg = scratch + warp * kMaxChunk;
    chunk_cumsum(wj, seg, a.A[b * a.a_stride + h0 + j], a.chunk, lane);
    __syncwarp();
    const float seg_end = seg[a.chunk - 1];
    float* seg_out = a.seg + ((long long)b * a.H + h0 + j) * a.L +
                     (long long)c * a.chunk;
    for (int i = lane; i < a.chunk; i += 32) {
      seg_out[i] = seg[i];
      wj[i] = expf(seg_end - seg[i]) * wj[i];
    }
    __syncwarp();
  }
  __syncthreads();

  // per head, S = sum over the key tiles of (w * x)^T B; tile kt + 1's
  // fragments are built while tile kt's product runs
  const int r0 = frag_row(0, t);
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    const bool more = j + 1 < nh;
    const float* wj = w + j * kMaxChunk;
    float acc[NH][32];                  // the first product overwrites it
    uint32_t hi[2][4][4], lo[2][4][4];
    mbar_wait(bar_x(0), j & 1);
    wx_frags(reinterpret_cast<const unsigned short*>(gbase + (sX - base)),
             wj, t, hi[0], lo[0]);
#pragma unroll
    for (int kt = 0; kt < kTiles; ++kt) {
      if (kt >= nt) break;
      if (j == 0) mbar_wait(bar_b(kt), 0);
#pragma unroll
      for (int cc = 0; cc < NH; ++cc) keep(acc[cc]);
      keep(hi[kt & 1]);
      keep(lo[kt & 1]);
      wg_fence();
      mma_rs<NH>(acc, hi[kt & 1], lo[kt & 1], sB + kt * BT, kt > 0);
      wg_commit();
      if (kt + 1 < nt) {
        mbar_wait(bar_x(kt + 1), j & 1);
        wx_frags(reinterpret_cast<const unsigned short*>(
                     gbase + (sX - base) + (kt + 1) * kRegion),
                 wj + (kt + 1) * kM, t, hi[(kt + 1) & 1], lo[(kt + 1) & 1]);
      }
      wg_wait<0>();
#pragma unroll
      for (int cc = 0; cc < NH; ++cc) keep(acc[cc]);
      keep(hi[kt & 1]);
      keep(lo[kt & 1]);
      if (more) {
        bar_wg();                      // every warp is done with x tile kt
        if (t == 0) load_x(h + 1, kt);
      }
    }

    float* out = a.S + ((long long)bc * a.H + h) * a.P * a.N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = r0 + 8 * r;
      if (p >= a.P) continue;
#pragma unroll
      for (int cc = 0; cc < NH; ++cc)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = 64 * cc + 8 * i + 2 * (t & 3);
          if (n < a.N)
            *reinterpret_cast<float2*>(out + p * a.N + n) = make_float2(
                acc[cc][4 * i + 2 * r], acc[cc][4 * i + 2 * r + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the states passed across chunks, four elements a thread
// ---------------------------------------------------------------------------

struct PassArgs {
  const float* S;           // (B, nc, H, P, N)
  const float* seg;         // (B, H, L)
  bf16 *hi, *lo;            // (B, nc - 1, H, P, N): s_in of chunks 1 ..
  float* state;             // (B, H, P, N)
  long long quads;          // B * H * P * N / 4
  int L, H, PN, chunk, nc;
};

__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, float4 s) {
  uint2 h, l;
  split2(s.x, s.y, h.x, l.x);
  split2(s.z, s.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

__global__ void __launch_bounds__(256)
state_pass_kernel(const PassArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.quads) return;
  const long long e = 4 * i, bh = e / a.PN;
  const int pn = (int)(e - bh * a.PN);
  const long long b = bh / a.H;
  const int h = (int)(bh - b * a.H);
  const float* seg_end = a.seg + bh * a.L + a.chunk - 1;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < a.nc; ++c) {
    if (c > 0) {
      const long long at = ((b * (a.nc - 1) + c - 1) * a.H + h) * a.PN + pn;
      store_split(a.hi + at, a.lo + at, s);
    }
    const float4 sc = *reinterpret_cast<const float4*>(
        a.S + ((b * a.nc + c) * a.H + h) * a.PN + pn);
    const float d = expf(seg_end[(long long)c * a.chunk]);
    s = make_float4(fmaf(d, s.x, sc.x), fmaf(d, s.y, sc.y),
                    fmaf(d, s.z, sc.z), fmaf(d, s.w, sc.w));
  }
  *reinterpret_cast<float4*>(a.state + e) = s;
}

// ---------------------------------------------------------------------------
// pass 3: the chunk outputs, one block per (query tile, group of heads,
// b * nc + chunk)
// ---------------------------------------------------------------------------

// Heads of one group a pass-3 block takes (fewer where the group has
// fewer): it forms C B^T once for them.  4 give 1,536 blocks at the serving
// shape (the fastest of 2, 3, 4, 6, 8, 12 and 24 on an H100).
constexpr int kScanHeads = 4;

struct ScanArgs {
  CUtensorMap tx, tb, tc, ty;   // 4-d maps of x, B, C and y
  CUtensorMap thi, tlo;         // 3-d maps of the entering states' planes
  const float* dt;              // (B, L, H)
  const float* seg;             // (B, H, L)
  int L, H, P, G, N, chunk, nc;
  int hpb;                      // heads a block takes (of one group)
};

template <int NH> constexpr size_t scan_smem() {
  // C; the entering state's hi and lo planes (the first B tiles at
  // first); the x tiles (the other B tiles at first); M's hi and lo
  // halves; the y tile; two buffers of seg (log2 units) and dt; barriers
  return 1024 + 3 * NH * kRegion + kTiles * kRegion + 3 * kRegion +
         2 * 2 * kMaxChunk * 4 + 8 * 16;
}

// hi/lo halves of M = CB * 2^(sk[q] - skd[k]) for the 64 x 64 tile of
// queries q0 + .. and keys k0 + .., in the accumulator's layout (register
// j of k-step kk holds elements 8 kk + 2 j and + 1); skd[k] = sk[k] -
// log2(dt_k) folds dt_k into the exponent.  On a masked tile 0 where k > q
// or q >= chunk (where the exponent may overflow: selected, never
// multiplied).
__device__ __forceinline__ void decay_tile(const float (&cb)[32],
                                           const float* sk, const float* skd,
                                           int q0, int k0, bool masked,
                                           int chunk, int t,
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
  const int r0 = frag_row(0, t), c0 = frag_col(0, t);
  const float sq[2] = {sk[q0 + r0], sk[q0 + r0 + 8]};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 8 * kk + 2 * j, r = j & 1;
      const int k = k0 + c0 + 16 * kk + 8 * (j >> 1);
      const float2 s2 = *reinterpret_cast<const float2*>(&skd[k]);
      float m0 = cb[e] * exp2_approx(sq[r] - s2.x);
      float m1 = cb[e + 1] * exp2_approx(sq[r] - s2.y);
      if (masked) {
        const int q = q0 + r0 + 8 * r;
        m0 = k <= q && q < chunk ? m0 : 0.f;
        m1 = k + 1 <= q && q < chunk ? m1 : 0.f;
      }
      split2(m0, m1, hi[kk][j], lo[kk][j]);
    }
}

// The fragments of decay_tile into the 64 x 64 bf16 tile at shared dst
// (rows q, columns k: K-major for wgmma's A), four 8 x 8 matrices a k-step
// with stmatrix (lane l addresses row l % 8 of matrix l / 8).  A warp
// writes only its own 16 rows, which only its part of a product reads.
__device__ __forceinline__ void stage_tile(uint32_t dst,
                                           const uint32_t (&f)[4][4], int t) {
  const int lane = t & 31, m = lane >> 3;
  const int row = 16 * (t >> 5) + (lane & 7) + 8 * (m & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
        ::"r"(dst + swz(row, 2 * kk + (m >> 1))),
        "r"(f[kk][0]), "r"(f[kk][1]), "r"(f[kk][2]), "r"(f[kk][3])
        : "memory");
}

template <int NH>
__global__ void __launch_bounds__(kWG, 2)
chunk_scan_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t BT = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const uint32_t sC = base, sIn = base + BT, sX = base + 3 * BT;
  const uint32_t sM = sX + kTiles * kRegion, sY = sM + 2 * kRegion;
  float* vec = reinterpret_cast<float*>(gbase + (sY + kRegion - base));
  const uint32_t bars = sY + kRegion + 2 * 2 * kMaxChunk * 4;
  const uint32_t bar_c = bars, bar_in = bars + 8 * (1 + kTiles);
  auto bar_b = [&](int kt) { return bars + 8 * (1 + kt); };
  auto bar_x = [&](int kt) { return bars + 8 * (2 + kTiles + kt); };
  const int t = threadIdx.x;
  // neighbouring blocks take the query tiles of one (chunk, heads), so
  // they share x and the entering states in L2; the heaviest first
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kM, nk = qt + 1;
  const int sets = gridDim.y / a.G;
  const int g = blockIdx.y / sets, set = blockIdx.y - g * sets;
  const int hg = a.H / a.G, h0 = g * hg + set * a.hpb;
  const int nh = min(a.hpb, hg - set * a.hpb);
  const int bc = blockIdx.z, b = bc / a.nc, c = bc - b * a.nc;
  const bool entering = c > 0;
  const bool ragged = q0 + kM > a.chunk;   // query rows past the chunk
  const int rows = min(nk * kM, a.chunk);  // chunk rows the block reads
  const long long step0 = (long long)b * a.L + (long long)c * a.chunk;

  auto load_in = [&](int h) {
    mbar_expect(bar_in, 2 * BT);
    const int mat = (b * (a.nc - 1) + c - 1) * a.H + h;
    tma_load_plane<NH>(sIn, a.thi, bar_in, mat);
    tma_load_plane<NH>(sIn + BT, a.tlo, bar_in, mat);
  };
  auto load_x = [&](int h, int kt) {
    mbar_expect(bar_x(kt), kRegion);
    tma_load<1>(sX + kt * kRegion, a.tx, bar_x(kt), h, kt * kM, bc);
  };
  // seg (log2 units) and dt of head h's rows [0, rows), zero past them
  auto load_vec = [&](int h, float (&s)[2], float (&d)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = t + kWG * j;
      const bool in = i < rows;
      s[j] = in ? a.seg[((long long)b * a.H + h) * a.L +
                        (long long)c * a.chunk + i] * kLog2e
                : 0.f;
      d[j] = in ? a.dt[(step0 + i) * a.H + h] : 0.f;
    }
  };
  // into buffer buf: sk = seg and skd = seg - log2(dt) (+inf where dt = 0)
  auto store_vec = [&](int buf, const float (&s)[2], const float (&d)[2]) {
    float* sk = vec + buf * 2 * kMaxChunk;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sk[t + kWG * j] = s[j];
      sk[kMaxChunk + t + kWG * j] = s[j] - log2f(d[j]);
    }
  };

  if (t == 0) {
    prefetch_map(a.tc);
    prefetch_map(a.tb);
    prefetch_map(a.tx);
    prefetch_map(a.ty);
    if (entering) {
      prefetch_map(a.thi);
      prefetch_map(a.tlo);
    }
    for (int i = 0; i < 2 + 2 * kTiles; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect(bar_c, BT);
    tma_load<NH>(sC, a.tc, bar_c, g, q0, bc);
    for (int kt = 0; kt < nk; ++kt) {   // B tile kt in place of the planes
      mbar_expect(bar_b(kt), BT);       // (0, 1) and the x tiles (2, 3)
      tma_load<NH>(sIn + kt * BT, a.tb, bar_b(kt), g, kt * kM, bc);
    }
  }
  float sv[2], dv[2];
  load_vec(h0, sv, dv);
  store_vec(0, sv, dv);

  // C B^T of the query tile against each key tile at or below the
  // diagonal, once for all the block's heads: tiles 0 and 1, whose place
  // the entering state of the first head takes next, then 2 and 3
  float cb[kTiles][32];
  mbar_wait(bar_c, 0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int kt = 0; kt < kTiles; ++kt) keep(cb[kt]);
    wg_fence();
#pragma unroll
    for (int kt = 2 * half; kt < 2 * half + 2; ++kt)
      if (kt < nk) {
        mbar_wait(bar_b(kt), 0);
        mma_abt<NH>(cb[kt], sC, sIn + kt * BT, false);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int kt = 0; kt < kTiles; ++kt) keep(cb[kt]);
    bar_wg();                           // every warp is done with the tiles
    if (t == 0) {
      if (half == 0 && entering) load_in(h0);
      if (half == 1)
        for (int kt = 0; kt < nk; ++kt) load_x(h0, kt);
    }
  }

  const int r0 = frag_row(0, t);
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    const bool more = i + 1 < nh;
    if (more) load_vec(h + 1, sv, dv);  // stored at the end of this head
    bar_wg();                           // this head's seg and dt are in
    const float* sk = vec + (i & 1) * 2 * kMaxChunk;
    const float* skd = sk + kMaxChunk;

    // y = exp(seg_q) C s_in^T (s_in as its hi and lo planes), issued
    // first; then y += M x over the key tiles at or below the diagonal, M's
    // halves staged in shared memory, the next tile's M built while the
    // tensor cores work
    uint32_t hi[4][4], lo[4][4];
    float y[32];
    if (entering) {
      mbar_wait(bar_in, i & 1);
      keep(y);
      wg_fence();
      mma_abt<NH>(y, sC, sIn, false);
      mma_abt<NH>(y, sC, sIn + BT, true);
      wg_commit();
    }
    decay_tile(cb[0], sk, skd, q0, 0, qt == 0 || ragged, a.chunk, t, hi, lo);
    if (entering) {
      wg_wait<0>();
      keep(y);
      if (more) {
        bar_wg();                       // every warp is done with s_in
        if (t == 0) load_in(h + 1);
      }
      const float e0 = exp2_approx(sk[q0 + r0]),
                  e1 = exp2_approx(sk[q0 + r0 + 8]);
#pragma unroll
      for (int e = 0; e < 32; ++e) y[e] *= (e >> 1) & 1 ? e1 : e0;
    }
    // (the first chunk has no entering state: its first product below
    // overwrites y; zeroing y by other instructions would make ptxas
    // serialize every wgmma of the kernel)
#pragma unroll
    for (int kt = 0; kt < kTiles; ++kt) {
      if (kt >= nk) break;
      if (kt > 0) {
        wg_wait<0>();                   // tile kt - 1's product is done
        keep(y);
        bar_wg();                       // with M's halves and x tile kt - 1
        if (more && t == 0) load_x(h + 1, kt - 1);
      }
      stage_tile(sM, hi, t);
      stage_tile(sM + kRegion, lo, t);
      fence_async_smem();
      bar_wg();
      mbar_wait(bar_x(kt), i & 1);
      keep(y);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc(sX + kt * kRegion + kk * 16 * 128);
        wgmma_ss_mn(y, desc(sM + kk * 32), db, entering || kt + kk > 0);
        wgmma_ss_mn(y, desc(sM + kRegion + kk * 32), db, 1);
      }
      wg_commit();
      if (kt + 1 < nk)
        decay_tile(cb[kt + 1], sk, skd, q0, (kt + 1) * kM,
                   kt + 1 == qt || ragged, a.chunk, t, hi, lo);
    }
    wg_wait<0>();
    keep(y);
    if (more) {
      bar_wg();                         // every warp is done with the last
      if (t == 0) load_x(h + 1, nk - 1);   // x tile
    }

    // y to its tile, then by TMA to rows q0 .. of head h (clipped at the
    // chunk's end and at P)
    if (t == 0) store_wait_read();      // the last head's tile has been read
    bar_wg();
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         sY + swz(r0 + 8 * r, j) + 4 * (t & 3)),
                     "r"(pack_bf16(y[4 * j + 2 * r], y[4 * j + 2 * r + 1]))
                     : "memory");
    fence_async_smem();
    bar_wg();
    if (t == 0) tma_store(sY, a.ty, h, q0, bc);
    if (more) store_vec((i + 1) & 1, sv, dv);
  }
  if (t == 0) store_wait();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime's entry-point
// query, so the library links nothing beyond cudart.
EncodeTiled encode_tiled() {
  // The driver's encode needs a current context.  A thread that has made
  // no runtime call yet has none (autograd's device thread, a caller's
  // own thread, where every tensor came from the allocator's cache or
  // from memory it maps through the driver): cudaSetDevice binds the
  // device's primary context.
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return nullptr;
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool encode(CUtensorMap* m, const void* ptr, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous bf16 (Bsz, L, heads, cols) as (cols, heads, rows of a chunk,
// Bsz * nc): boxes of 64 columns x 1 head x 64 rows of one chunk.
bool map_rows(CUtensorMap* m, const void* ptr, int cols, int heads,
              int chunk, long long bnc) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads,
                              (cuuint64_t)chunk, (cuuint64_t)bnc};
  const cuuint64_t strides[3] = {2ull * cols, 2ull * cols * heads,
                                 2ull * cols * heads * chunk};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode(m, ptr, 4, dims, strides, box);
}

// mats contiguous bf16 (P, N) matrices as (N, P, mats): boxes of 64 x 64.
bool map_planes(CUtensorMap* m, const void* ptr, int P, int N,
                long long mats) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)P,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {2ull * N, 2ull * N * P};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode(m, ptr, 3, dims, strides, box);
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const Args& a, bool* ready) {
  if (!*ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *ready = true;
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int NH>
cudaError_t run_state(const StateArgs& a, int Bsz, cudaStream_t s) {
  static bool ready = false;
  const int sets = (a.H / a.G + a.hpb - 1) / a.hpb;
  return launch(chunk_state_kernel<NH>, dim3(a.G * sets, a.nc, Bsz), kWG,
                state_smem<NH>(), s, a, &ready);
}

template <int NH>
cudaError_t run_scan(const ScanArgs& a, int Bsz, cudaStream_t s) {
  static bool ready = false;
  const int nq = (a.chunk + kM - 1) / kM;
  const int sets = (a.H / a.G + a.hpb - 1) / a.hpb;
  return launch(chunk_scan_kernel<NH>, dim3(nq, a.G * sets, Bsz * a.nc),
                kWG, scan_smem<NH>(), s, a, &ready);
}

// The shapes the Hopper passes take: rows of x, B and C 16-byte multiples
// (P and N multiples of 8), grid dimensions in range.
bool shapes_ok(int Bsz, int L, int H, int P, int G, int N, int chunk) {
  return valid(Bsz, L, H, P, G, N, chunk, DT_BF16) && P % 8 == 0 &&
         N % 8 == 0 && Bsz <= 65535 && L / chunk <= 65535 &&
         (long long)Bsz * (L / chunk) <= 65535;
}

}  // namespace hop

// ===========================================================================
// T3 in bfloat16 on Hopper: the tangent's three chunk-parallel passes
// ===========================================================================
//
// The forward-mode tangent of the scan (see namespace jvpk below for the
// formulas), in the forward's three passes (namespace hop), each carrying
// the tangent plane beside its primal one:
//
//   1. tangent_state_kernel, one block per (heads of a group, chunk, b):
//      per head seg and seg' (written to (B, H, L) float32 workspaces),
//      u_k = w_k dt_k and u'_k = w_k ((seg'_end - seg'_k) dt_k + dt'_k)
//      with w_k = exp(seg_end - seg_k), then the chunk's own state and its
//      tangent,
//        S_c  = (u x)^T B,
//        S'_c = (u' x + u x')^T B + (u x)^T B',
//      (P x c)(c x N) products on wgmma with the float32-scaled operands as
//      bf16 hi/lo pairs, into (B, nc, H, P, N) float32 workspaces; the B
//      and B' tiles are loaded once for all the block's heads.
//   2. tangent_pass_kernel, elementwise over (b, h, P, N), sequential over
//      the chunks only:
//        s_in[c + 1]  = e^{seg_end} s_in[c] + S_c,
//        s'_in[c + 1] = e^{seg_end} (seg'_end s_in[c] + s'_in[c]) + S'_c,
//      from zero; the entering states of chunks 1 .. nc - 1 as bf16 hi/lo
//      planes, (B, nc - 1, H, P, N) each, and the final S' in float32.
//   3. tangent_scan_kernel, one block per (64-row query tile, heads of a
//      group, b * nc + chunk): for each key tile at or below the diagonal,
//      G = C B^T and G' = C' B^T + C B'^T once for all the block's heads
//      (registers), then per head
//        y' += M1 x + M2 x',
//        M1 = E [(G' + G (seg'_q - seg'_k)) dt_k + G dt'_k],  M2 = E G dt_k,
//      with E = exp(seg_q - seg_k) for k <= q (else 0), M1 and M2 staged in
//      shared memory as hi/lo bf16 tiles (stmatrix); before the key tiles
//      y' = exp(seg_q) (seg'_q C s_in^T + C' s_in^T + C s'_in^T) from the
//      entering planes.  The heads' y' stay in registers across the key
//      tiles, so a block takes kT3ScanHeads heads.
//
// Every exponential is of a difference that is at most 0 (E is selected to
// 0 above the diagonal, never multiplied), so T3 stays finite where seg
// falls by more than 88 within a chunk.  A is given per sequence, B/C are
// read through their group, y' is written in bf16 and S' in float32.
//
// Bound at the mamba2 training shape (B = 8, L = 512, H = 24, P = 64, N =
// 128, one group, chunk 256): the inputs and outputs move 48.9 MB (0.0146
// ms at 3.35 TB/s); the products of this design, the causal half of G and
// G' once per block's heads and the hi/lo halves counted, are printed by
// chip_smoke.py beside the time.
namespace t3 {

using hop::bf16;
using hop::kM;
using hop::kRegion;
using hop::kTiles;
using hop::kWG;

// Heads of one group a pass-1 block takes: the B and B' tiles of the whole
// chunk are loaded once for them (128 KB at N = 128, so one block an SM).
// Three give 128 blocks at the mamba2 training shape, one wave on 132 SMs.
constexpr int kT3StateHeads = 3;
// Heads of one group a pass-3 block takes: their y' stay in registers
// beside G and G'.
constexpr int kT3ScanHeads = 2;

struct StateArgs {
  CUtensorMap tx, ttx;      // x, x' (P, H, chunk, B*nc)
  CUtensorMap tb, ttb;      // B, B' (N, G, chunk, B*nc)
  const float *dt, *tdt;    // (B, L, H)
  const float *A, *tA;      // A[b * a_stride + h], A'[b * ta_stride + h]
  float *S, *tS;            // (B, nc, H, P, N)
  float *seg, *tseg;        // (B, H, L)
  long long a_stride, ta_stride;
  int L, H, P, G, N, chunk, nc;
  int hpb;                  // heads a block takes (of one group)
};

template <int NH> constexpr size_t state_smem() {
  // B and B' tiles of the chunk; x and x' tiles of one head; each head's
  // u and u' (dt and dt' at first); seg and seg' scratch a warp; barriers
  return 1024 + 2 * kTiles * (NH + 1) * kRegion +
         (2 * kT3StateHeads + 8) * kMaxChunk * 4 + 16;
}

// hi/lo fragments of A[p][k] = ua[k] xa[k][p] (+ ub[k] xb[k][p]) for one key
// tile (the layout of hop::wx_frags), xa and xb swizzled bf16 tiles.
template <bool kTwo>
__device__ __forceinline__ void ux_frags(const unsigned short* xa,
                                         const float* ua,
                                         const unsigned short* xb,
                                         const float* ub, int t,
                                         uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
  const int r0 = hop::frag_row(0, t);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = r0 + 8 * (j & 1);
      const int k = 16 * kk + 8 * (j >> 1) + 2 * (t & 3);
      const int at0 = k * 64 + (((p >> 3) ^ (k & 7)) << 3) + (p & 7);
      const int at1 = (k + 1) * 64 + (((p >> 3) ^ ((k + 1) & 7)) << 3) +
                      (p & 7);
      const float2 u = *reinterpret_cast<const float2*>(&ua[k]);
      float v0 = u.x * __uint_as_float((uint32_t)xa[at0] << 16);
      float v1 = u.y * __uint_as_float((uint32_t)xa[at1] << 16);
      if (kTwo) {
        const float2 w = *reinterpret_cast<const float2*>(&ub[k]);
        v0 = fmaf(w.x, __uint_as_float((uint32_t)xb[at0] << 16), v0);
        v1 = fmaf(w.y, __uint_as_float((uint32_t)xb[at1] << 16), v1);
      }
      hop::split2(v0, v1, hi[kk][j], lo[kk][j]);
    }
}

// Inclusive cumsum of term(i) over i < chunk into out: one warp, a run of
// consecutive steps a lane, then a shuffle scan of the runs.
template <typename Term>
__device__ __forceinline__ void cumsum(Term term, float* out, int chunk,
                                       int lane) {
  const int per = (chunk + 31) / 32, beg = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i)
    if (beg + i < chunk) run += term(beg + i);
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float pre = incl - run;
  for (int i = 0; i < per; ++i)
    if (beg + i < chunk) {
      pre += term(beg + i);
      out[beg + i] = pre;
    }
}

// A (P x N) float32 accumulator to rows p < P, columns n < N of out.
template <int NH>
__device__ __forceinline__ void store_state(const float (&acc)[NH][32],
                                            float* out, int P, int N,
                                            int t) {
  const int r0 = hop::frag_row(0, t);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = r0 + 8 * r;
    if (p >= P) continue;
#pragma unroll
    for (int cc = 0; cc < NH; ++cc)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = 64 * cc + 8 * i + 2 * (t & 3);
        if (n < N)
          *reinterpret_cast<float2*>(out + p * N + n) = make_float2(
              acc[cc][4 * i + 2 * r], acc[cc][4 * i + 2 * r + 1]);
      }
  }
}

template <int NH>
__global__ void __launch_bounds__(kWG, 1)
tangent_state_kernel(const __grid_constant__ StateArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t BT = NH * kRegion;
  const uint32_t base = (hop::smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - hop::smem_u32(smem));
  const uint32_t sB = base, sTB = base + kTiles * BT;
  const uint32_t sX = base + 2 * kTiles * BT, sTX = sX + kTiles * kRegion;
  float* u = reinterpret_cast<float*>(gbase + 2 * kTiles * (BT + kRegion));
  float* tu = u + kT3StateHeads * kMaxChunk;
  float* scratch = tu + kT3StateHeads * kMaxChunk;   // 2 a warp
  const uint32_t bars = base + 2 * kTiles * (BT + kRegion) +
                        (2 * kT3StateHeads + 8) * kMaxChunk * 4;
  const uint32_t bar_b = bars, bar_x = bars + 8;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int sets = gridDim.x / a.G;
  const int g = blockIdx.x / sets, set = blockIdx.x - g * sets;
  const int hg = a.H / a.G, h0 = g * hg + set * a.hpb;
  const int nh = min(a.hpb, hg - set * a.hpb);
  const int c = blockIdx.y, b = blockIdx.z, bc = b * a.nc + c;
  const int nt = (a.chunk + kM - 1) / kM;
  const long long step0 = (long long)b * a.L + (long long)c * a.chunk;
  auto load_x = [&](int h) {              // x and x' tiles of head h
    hop::mbar_expect(bar_x, 2 * nt * kRegion);
    for (int kt = 0; kt < nt; ++kt) {
      hop::tma_load<1>(sX + kt * kRegion, a.tx, bar_x, h, kt * kM, bc);
      hop::tma_load<1>(sTX + kt * kRegion, a.ttx, bar_x, h, kt * kM, bc);
    }
  };

  if (t == 0) {
    hop::prefetch_map(a.tx);
    hop::prefetch_map(a.ttx);
    hop::prefetch_map(a.tb);
    hop::prefetch_map(a.ttb);
    hop::mbar_init(bar_b);
    hop::mbar_init(bar_x);
    hop::mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {                           // B and B' once for every head
    hop::mbar_expect(bar_b, 2 * nt * BT);
    for (int kt = 0; kt < nt; ++kt) {
      hop::tma_load<NH>(sB + kt * BT, a.tb, bar_b, g, kt * kM, bc);
      hop::tma_load<NH>(sTB + kt * BT, a.ttb, bar_b, g, kt * kM, bc);
    }
    load_x(h0);
  }
  // dt and dt' of the block's heads (zero past the chunk's end)
  for (int idx = t; idx < nh * nt * kM; idx += kWG) {
    const int i = idx / nh, j = idx - (idx / nh) * nh;
    const bool in = i < a.chunk;
    const long long at = (step0 + i) * a.H + h0 + j;
    u[j * kMaxChunk + i] = in ? a.dt[at] : 0.f;
    tu[j * kMaxChunk + i] = in ? a.tdt[at] : 0.f;
  }
  __syncthreads();
  // seg and seg' of head j (warp j % 4), written out; u and u' in the
  // places of dt and dt'
  for (int j = warp; j < nh; j += 4) {
    float* dtj = u + j * kMaxChunk;
    float* tdtj = tu + j * kMaxChunk;
    float* seg = scratch + 2 * warp * kMaxChunk;
    float* tseg = seg + kMaxChunk;
    const int h = h0 + j;
    const float A = a.A[b * a.a_stride + h], tA = a.tA[b * a.ta_stride + h];
    cumsum([&](int i) { return dtj[i] * A; }, seg, a.chunk, lane);
    cumsum([&](int i) { return fmaf(dtj[i], tA, tdtj[i] * A); }, tseg,
           a.chunk, lane);
    __syncwarp();
    const float seg_end = seg[a.chunk - 1], tseg_end = tseg[a.chunk - 1];
    const long long row = ((long long)b * a.H + h) * a.L +
                          (long long)c * a.chunk;
    for (int i = lane; i < a.chunk; i += 32) {
      a.seg[row + i] = seg[i];
      a.tseg[row + i] = tseg[i];
      const float w = expf(seg_end - seg[i]), d = dtj[i];
      tdtj[i] = w * fmaf(tseg_end - tseg[i], d, tdtj[i]);
      dtj[i] = w * d;
    }
    __syncwarp();
  }
  __syncthreads();

  const unsigned short* xs =
      reinterpret_cast<const unsigned short*>(gbase + (sX - base));
  const unsigned short* txs =
      reinterpret_cast<const unsigned short*>(gbase + (sTX - base));
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    const float* uj = u + j * kMaxChunk;
    const float* tuj = tu + j * kMaxChunk;
    if (j == 0) hop::mbar_wait(bar_b, 0);
    hop::mbar_wait(bar_x, j & 1);
    // S = (u x)^T B and S' = (u' x + u x')^T B + (u x)^T B' in one sweep
    // over the key tiles; the first products overwrite the accumulators
    float acc[NH][32], tacc[NH][32];
    uint32_t hi1[4][4], lo1[4][4], hi2[4][4], lo2[4][4];
    for (int kt = 0; kt < nt; ++kt) {
      ux_frags<false>(xs + kt * 4096, uj + kt * kM, nullptr, nullptr, t,
                      hi1, lo1);
      ux_frags<true>(xs + kt * 4096, tuj + kt * kM, txs + kt * 4096,
                     uj + kt * kM, t, hi2, lo2);
#pragma unroll
      for (int cc = 0; cc < NH; ++cc) {
        hop::keep(acc[cc]);
        hop::keep(tacc[cc]);
      }
      hop::wg_fence();
      hop::mma_rs<NH>(acc, hi1, lo1, sB + kt * BT, kt > 0);
      hop::mma_rs<NH>(tacc, hi2, lo2, sB + kt * BT, kt > 0);
      hop::mma_rs<NH>(tacc, hi1, lo1, sTB + kt * BT, true);
      hop::wg_commit();
      hop::wg_wait<0>();
#pragma unroll
      for (int cc = 0; cc < NH; ++cc) {
        hop::keep(acc[cc]);
        hop::keep(tacc[cc]);
      }
      hop::keep(hi1);
      hop::keep(lo1);
      hop::keep(hi2);
      hop::keep(lo2);
    }
    store_state<NH>(acc, a.S + ((long long)bc * a.H + h) * a.P * a.N, a.P,
                    a.N, t);
    store_state<NH>(tacc, a.tS + ((long long)bc * a.H + h) * a.P * a.N,
                    a.P, a.N, t);
    if (j + 1 < nh) {
      hop::bar_wg();                      // every warp is done with x, x'
      if (t == 0) load_x(h + 1);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the states and their tangents passed across chunks
// ---------------------------------------------------------------------------

struct PassArgs {
  const float *S, *tS;      // (B, nc, H, P, N)
  const float *seg, *tseg;  // (B, H, L)
  bf16 *hi, *lo, *thi, *tlo;  // (B, nc - 1, H, P, N): s_in, s'_in of 1 ..
  float* tstate;            // (B, H, P, N)
  long long quads;          // B * H * P * N / 4
  int L, H, PN, chunk, nc;
};

__global__ void __launch_bounds__(256)
tangent_pass_kernel(const PassArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.quads) return;
  const long long e = 4 * i, bh = e / a.PN;
  const int pn = (int)(e - bh * a.PN);
  const long long b = bh / a.H;
  const int h = (int)(bh - b * a.H);
  const float* seg_end = a.seg + bh * a.L + a.chunk - 1;
  const float* tseg_end = a.tseg + bh * a.L + a.chunk - 1;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f), ts = s;
  for (int c = 0; c < a.nc; ++c) {
    if (c > 0) {
      const long long at = ((b * (a.nc - 1) + c - 1) * a.H + h) * a.PN + pn;
      hop::store_split(a.hi + at, a.lo + at, s);
      hop::store_split(a.thi + at, a.tlo + at, ts);
    }
    const long long at = ((b * a.nc + c) * a.H + h) * a.PN + pn;
    const float4 sc = *reinterpret_cast<const float4*>(a.S + at);
    const float4 tsc = *reinterpret_cast<const float4*>(a.tS + at);
    const float d = expf(seg_end[(long long)c * a.chunk]);
    const float td = tseg_end[(long long)c * a.chunk];
    ts = make_float4(fmaf(d, fmaf(td, s.x, ts.x), tsc.x),
                     fmaf(d, fmaf(td, s.y, ts.y), tsc.y),
                     fmaf(d, fmaf(td, s.z, ts.z), tsc.z),
                     fmaf(d, fmaf(td, s.w, ts.w), tsc.w));
    s = make_float4(fmaf(d, s.x, sc.x), fmaf(d, s.y, sc.y),
                    fmaf(d, s.z, sc.z), fmaf(d, s.w, sc.w));
  }
  *reinterpret_cast<float4*>(a.tstate + e) = ts;
}

// ---------------------------------------------------------------------------
// pass 3: y', one block per (query tile, heads of a group, b * nc + chunk)
// ---------------------------------------------------------------------------

struct ScanArgs {
  CUtensorMap tx, ttx, ty;      // x, x', y' (P, H, chunk, B*nc)
  CUtensorMap tb, ttb, tc, ttc; // B, B', C, C' (N, G, chunk, B*nc)
  CUtensorMap thi, tlo, tthi, ttlo;   // the entering planes (N, P, mats)
  const float *dt, *tdt;        // (B, L, H)
  const float *seg, *tseg;      // (B, H, L)
  int L, H, P, G, N, chunk, nc;
  int hpb;                      // heads a block takes (of one group)
};

// Bytes of one key tile's operands (B, B' and the block's x, x' tiles), and
// of region 0, which holds the four entering planes of one head at first.
template <int NH> __host__ __device__ constexpr uint32_t tile_bytes() {
  return 2 * NH * kRegion + 2 * kT3ScanHeads * kRegion;
}
template <int NH> __host__ __device__ constexpr uint32_t scan_region() {
  return 4 * NH * kRegion > tile_bytes<NH>() ? 4 * NH * kRegion
                                             : tile_bytes<NH>();
}

template <int NH> constexpr size_t scan_smem() {
  // C, C'; regions 0 and 1 (key tiles by turns); M1 and M2 as hi/lo tiles
  // (y' staged there at the end); per head seg (log2 units), seg', dt,
  // dt'; barriers
  return 1024 + 2 * NH * kRegion + scan_region<NH>() + tile_bytes<NH>() +
         4 * kRegion + 4 * kT3ScanHeads * kMaxChunk * 4 + 32;
}

// M1 (kOne) or M2 of the 64 x 64 tile (queries q0 .., keys k0 ..) as hi/lo
// A fragments in the accumulator's layout (as hop::decay_tile); on a masked
// tile 0 where k > q or q >= chunk.  The mask comes before the exponential:
// a masked pair's difference may be positive (past 88 it overflows), so
// its exponent is exp2(-inf) = 0 and its difference is never taken.
template <bool kOne>
__device__ __forceinline__ void m_frags(const float (&G)[32],
                                        const float (&Gp)[32],
                                        const float* sk, const float* sp,
                                        const float* dt, const float* tdt,
                                        int q0, int k0, bool masked,
                                        int chunk, int t,
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
  const int r0 = hop::frag_row(0, t), c0 = hop::frag_col(0, t);
  const float sq[2] = {sk[q0 + r0], sk[q0 + r0 + 8]};
  const float pq[2] = {sp[q0 + r0], sp[q0 + r0 + 8]};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 8 * kk + 2 * j, r = j & 1;
      const int k = k0 + c0 + 16 * kk + 8 * (j >> 1);
      const int q = q0 + r0 + 8 * r;
      float m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool keep = !masked || (k + i <= q && q < chunk);
        const float E =
            hop::exp2_approx(keep ? sq[r] - sk[k + i] : -INFINITY);
        const float gv = G[e + i];
        m[i] = kOne ? E * fmaf(fmaf(gv, pq[r] - sp[k + i], Gp[e + i]),
                               dt[k + i], gv * tdt[k + i])
                    : E * gv * dt[k + i];
      }
      hop::split2(m[0], m[1], hi[kk][j], lo[kk][j]);
    }
}

template <int NH>
__global__ void __launch_bounds__(kWG, 1)
tangent_scan_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t BT = NH * kRegion;
  const uint32_t base = (hop::smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - hop::smem_u32(smem));
  const uint32_t sC = base, sTC = base + BT, sR = base + 2 * BT;
  // key tile kt's operands in region (kt + 1) & 1: B, B', then head i's x
  // and x' at 2 BT + 2i regions and one region on; region 0 holds the
  // entering planes first
  auto region = [&](int kt) {
    return sR + ((kt + 1) & 1) * scan_region<NH>();
  };
  const uint32_t sM = sR + scan_region<NH>() + tile_bytes<NH>();
  float* vec = reinterpret_cast<float*>(gbase + (sM + 4 * kRegion - base));
  const uint32_t bars = sM + 4 * kRegion + 4 * kT3ScanHeads * kMaxChunk * 4;
  const uint32_t bar_c = bars, bar_in = bars + 8;
  auto bar_r = [&](int kt) { return bars + 16 + 8 * ((kt + 1) & 1); };
  const int t = threadIdx.x;
  // neighbouring blocks take the query tiles of one (chunk, heads); the
  // heaviest first
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kM, nk = qt + 1;
  const int sets = gridDim.y / a.G;
  const int g = blockIdx.y / sets, set = blockIdx.y - g * sets;
  const int hg = a.H / a.G, h0 = g * hg + set * a.hpb;
  const int nh = min(a.hpb, hg - set * a.hpb);
  const int bc = blockIdx.z, b = bc / a.nc, c = bc - b * a.nc;
  const bool entering = c > 0;
  const bool ragged = q0 + kM > a.chunk;   // query rows past the chunk
  const int rows = min(nk * kM, a.chunk);  // chunk rows the block reads
  const long long step0 = (long long)b * a.L + (long long)c * a.chunk;

  // key tile kt's B, B', x and x' tiles into region (kt + 1) & 1; one
  // thread
  auto load_tile = [&](int kt) {
    const uint32_t r = region(kt), bar = bar_r(kt);
    const int k0 = kt * kM;
    hop::mbar_expect(bar, 2 * BT + 2 * nh * kRegion);
    hop::tma_load<NH>(r, a.tb, bar, g, k0, bc);
    hop::tma_load<NH>(r + BT, a.ttb, bar, g, k0, bc);
    for (int i = 0; i < nh; ++i) {
      hop::tma_load<1>(r + 2 * BT + 2 * i * kRegion, a.tx, bar, h0 + i, k0,
                       bc);
      hop::tma_load<1>(r + 2 * BT + (2 * i + 1) * kRegion, a.ttx, bar,
                       h0 + i, k0, bc);
    }
  };

  if (t == 0) {
    hop::prefetch_map(a.tc);
    hop::prefetch_map(a.ttc);
    hop::prefetch_map(a.tb);
    hop::prefetch_map(a.ttb);
    hop::prefetch_map(a.tx);
    hop::prefetch_map(a.ttx);
    hop::prefetch_map(a.ty);
    for (int i = 0; i < 4; ++i) hop::mbar_init(bars + 8 * i);
    hop::mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    hop::mbar_expect(bar_c, 2 * BT);
    hop::tma_load<NH>(sC, a.tc, bar_c, g, q0, bc);
    hop::tma_load<NH>(sTC, a.ttc, bar_c, g, q0, bc);
    load_tile(0);                         // region 1, during the entering
  }
  // per head: seg in log2 units, seg', dt, dt' of rows [0, rows), 0 past
  for (int idx = t; idx < kT3ScanHeads * kMaxChunk; idx += kWG) {
    const int i = idx / kMaxChunk, j = idx - i * kMaxChunk;
    const bool in = i < nh && j < rows;
    const int h = h0 + i;
    float* v = vec + 4 * i * kMaxChunk;
    const long long sr = ((long long)b * a.H + h) * a.L +
                         (long long)c * a.chunk + j;
    const long long dr = (step0 + j) * a.H + h;
    v[j] = in ? a.seg[sr] * hop::kLog2e : 0.f;
    v[kMaxChunk + j] = in ? a.tseg[sr] : 0.f;
    v[2 * kMaxChunk + j] = in ? a.dt[dr] : 0.f;
    v[3 * kMaxChunk + j] = in ? a.tdt[dr] : 0.f;
  }
  __syncthreads();
  hop::mbar_wait(bar_c, 0);

  const int r0 = hop::frag_row(0, t);
  float y[kT3ScanHeads][32];
  // y' = exp(seg_q) (seg'_q C s_in^T + C' s_in^T + C s'_in^T), per head
  if (entering) {
#pragma unroll
    for (int i = 0; i < kT3ScanHeads; ++i) {
      if (i >= nh) break;
      const int mat = (b * (a.nc - 1) + c - 1) * a.H + h0 + i;
      if (i > 0) hop::bar_wg();           // every warp is done with the planes
      if (t == 0) {
        hop::mbar_expect(bar_in, 4 * BT);
        hop::tma_load_plane<NH>(sR, a.thi, bar_in, mat);
        hop::tma_load_plane<NH>(sR + BT, a.tlo, bar_in, mat);
        hop::tma_load_plane<NH>(sR + 2 * BT, a.tthi, bar_in, mat);
        hop::tma_load_plane<NH>(sR + 3 * BT, a.ttlo, bar_in, mat);
      }
      hop::mbar_wait(bar_in, i & 1);
      float y0[32];
      hop::keep(y0);
      hop::keep(y[i]);
      hop::wg_fence();
      hop::mma_abt<NH>(y0, sC, sR, false);
      hop::mma_abt<NH>(y0, sC, sR + BT, true);
      hop::mma_abt<NH>(y[i], sTC, sR, false);
      hop::mma_abt<NH>(y[i], sTC, sR + BT, true);
      hop::mma_abt<NH>(y[i], sC, sR + 2 * BT, true);
      hop::mma_abt<NH>(y[i], sC, sR + 3 * BT, true);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::keep(y0);
      hop::keep(y[i]);
      const float* sk = vec + 4 * i * kMaxChunk;
      const float* sp = sk + kMaxChunk;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int q = q0 + r0 + 8 * ((e >> 1) & 1);
        y[i][e] = hop::exp2_approx(sk[q]) * fmaf(sp[q], y0[e], y[i][e]);
      }
    }
  }

  // y' += M1 x + M2 x' over the key tiles at or below the diagonal, tile
  // kt + 1 landing in the other region while tile kt is multiplied
  hop::bar_wg();                          // every warp is done with the planes
  if (t == 0 && nk > 1) load_tile(1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kM;
    const uint32_t sB = region(kt), sTB = sB + BT;
    const uint32_t sX = sB + 2 * BT;      // head i's x, x': sX + 2i regions
    hop::mbar_wait(bar_r(kt), (kt >> 1) & 1);
    float G[32], Gp[32];
    hop::keep(G);
    hop::keep(Gp);
    hop::wg_fence();
    hop::mma_abt<NH>(G, sC, sB, false);
    hop::mma_abt<NH>(Gp, sTC, sB, false);
    hop::mma_abt<NH>(Gp, sC, sTB, true);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::keep(G);
    hop::keep(Gp);
    const bool masked = kt == qt || ragged;
#pragma unroll
    for (int i = 0; i < kT3ScanHeads; ++i) {
      if (i >= nh) break;
      const float* sk = vec + 4 * i * kMaxChunk;
      const float* sp = sk + kMaxChunk;
      const float* dt = sp + kMaxChunk;
      const float* tdt = dt + kMaxChunk;
      uint32_t hi[4][4], lo[4][4];
      hop::bar_wg();                      // the last product is done with M
      m_frags<true>(G, Gp, sk, sp, dt, tdt, q0, k0, masked, a.chunk, t, hi,
                    lo);
      hop::stage_tile(sM, hi, t);
      hop::stage_tile(sM + kRegion, lo, t);
      m_frags<false>(G, Gp, sk, sp, dt, tdt, q0, k0, masked, a.chunk, t, hi,
                     lo);
      hop::stage_tile(sM + 2 * kRegion, hi, t);
      hop::stage_tile(sM + 3 * kRegion, lo, t);
      hop::fence_async_smem();
      hop::bar_wg();
      const uint32_t x = sX + 2 * i * kRegion, tx = x + kRegion;
      hop::keep(y[i]);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = hop::desc(x + kk * 16 * 128);
        const uint64_t dtx = hop::desc(tx + kk * 16 * 128);
        hop::wgmma_ss_mn(y[i], hop::desc(sM + kk * 32), dx,
                         entering || kt > 0 || kk > 0);
        hop::wgmma_ss_mn(y[i], hop::desc(sM + kRegion + kk * 32), dx, 1);
        hop::wgmma_ss_mn(y[i], hop::desc(sM + 2 * kRegion + kk * 32), dtx, 1);
        hop::wgmma_ss_mn(y[i], hop::desc(sM + 3 * kRegion + kk * 32), dtx, 1);
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::keep(y[i]);
    }
    if (kt + 2 < nk) {
      hop::bar_wg();                      // every warp is done with tile kt
      if (t == 0) load_tile(kt + 2);
    }
  }

  // each head's y' to a region of M, then by TMA to rows q0 .. of its head
  // (clipped at the chunk's end and at P)
  hop::bar_wg();                          // every warp is done with M
#pragma unroll
  for (int i = 0; i < kT3ScanHeads; ++i) {
    if (i >= nh) break;
    const uint32_t st = sM + i * kRegion;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         st + hop::swz(r0 + 8 * r, j) + 4 * (t & 3)),
                     "r"(hop::pack_bf16(y[i][4 * j + 2 * r],
                                        y[i][4 * j + 2 * r + 1]))
                     : "memory");
  }
  hop::fence_async_smem();
  hop::bar_wg();
  if (t == 0) {
    for (int i = 0; i < nh; ++i)
      hop::tma_store(sM + i * kRegion, a.ty, h0 + i, q0, bc);
    hop::store_wait();
  }
}

template <int NH>
cudaError_t run_state(const StateArgs& a, int Bsz, cudaStream_t s) {
  static bool ready = false;
  const int sets = (a.H / a.G + a.hpb - 1) / a.hpb;
  return hop::launch(tangent_state_kernel<NH>, dim3(a.G * sets, a.nc, Bsz), kWG,
                     state_smem<NH>(), s, a, &ready);
}

template <int NH>
cudaError_t run_scan(const ScanArgs& a, int Bsz, cudaStream_t s) {
  static bool ready = false;
  const int nq = (a.chunk + kM - 1) / kM;
  const int sets = (a.H / a.G + a.hpb - 1) / a.hpb;
  return hop::launch(tangent_scan_kernel<NH>, dim3(nq, a.G * sets, Bsz * a.nc),
                     kWG, scan_smem<NH>(), s, a, &ready);
}

}  // namespace t3

// ===========================================================================
// T3: the forward-mode tangent of the scan (no TPU counterpart)
// ===========================================================================
//
// The exact meta-gradient's Hessian-vector products are forward-over-
// reverse, so the scan's autograd Function (../ops.py) has a jvp rule, and
// this kernel is it: the tangent (y', final state') along (x', dt', A', B',
// C').  With a_t = dt_t A, seg the inclusive cumsum of a over a chunk and
// seg' that of a'_t = dt'_t A + dt_t A', the carried state's tangent is
//   S'_t = e^{a_t} (S'_{t-1} + a'_t S_{t-1}) + B'_t (dt_t x_t)
//          + B_t (dt'_t x_t + dt_t x'_t),      y'_t = C'_t S_t + C_t S'_t,
// computed by chunks as the forward is, from the state S0 and its tangent
// S0' entering the chunk:
//   M_qk  = (C_q . B_k) E_qk,  E_qk = exp(seg_q - seg_k) for k <= q, else 0
//   M'_qk = (C'_q . B_k + C_q . B'_k) E_qk + M_qk (seg'_q - seg'_k)
//   y'_q  = sum_k (M'_qk dt_k + M_qk dt'_k) x_k + M_qk dt_k x'_k
//           + exp(seg_q) (seg'_q C_q . S0 + C'_q . S0 + C_q . S0')
//   S_end  = exp(seg_end) S0 + sum_k w_k dt_k x_k B_k^T
//   S'_end = exp(seg_end) (seg'_end S0 + S0')
//            + sum_k w_k [((seg'_end - seg'_k) dt_k + dt'_k) x_k
//                          + dt_k x'_k] B_k^T + w_k dt_k x_k B'_k^T
// with w_k = exp(seg_end - seg_k).  Every exponential is of a difference
// taken only where it is at most 0 (E is selected to 0 above the
// diagonal), so the tangent stays finite where seg falls by more than 88
// within a chunk, as the forward does.
//
// bfloat16 runs the three passes of namespace t3 above.  float32 runs this
// CUDA-core kernel: one block per (b, h) walking its chunks with S and S'
// in shared memory (float32), like the float32 forward above; query tiles
// of 32 rows against key tiles of 64, float32 FMA, 256 threads as 16 x 16.
// About 219 KB of shared memory, so one block an SM.  x, B, C and their
// tangents are float32 here (the kernel also takes bf16), dt, A and theirs
// float32; y' is written in x's dtype, S' in float32.
namespace jvpk {

constexpr int kQ = 32;                    // query rows of an output tile
constexpr int kLdQ = kTile + 4;           // row stride of the M tiles

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T cast(float x);
template <> __device__ __forceinline__ float cast<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Stage `rows` (at most `tile`) rows of a (.., width) slice whose row r
// starts at src + r * stride into a float32 tile (row stride ld, `cols`
// columns, zero past width and past `rows`).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int tile, int ld, int cols,
                                      const T* __restrict__ src,
                                      size_t stride, int rows, int width) {
  for (int idx = threadIdx.x; idx < tile * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    float v = 0.f;
    if (r < rows && c < width) v = f32(src[(size_t)r * stride + c]);
    dst[r * ld + c] = v;
  }
}

// Inclusive scan of in[i] * a + (in2 ? in2[i] * a2 : 0) over n <= 256
// entries into out, by warp 0 (a run per lane).
__device__ __forceinline__ void scan(const float* in, float a,
                                     const float* in2, float a2, float* out,
                                     int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32, beg = lane * per;
  auto term = [&](int i) {
    const float t = in[i] * a;
    return in2 ? fmaf(in2[i], a2, t) : t;
  };
  float run = 0.f;
  for (int i = 0; i < per; ++i)
    if (beg + i < n) run += term(beg + i);
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float pre = incl - run;
  for (int i = 0; i < per; ++i)
    if (beg + i < n) {
      pre += term(beg + i);
      out[beg + i] = pre;
    }
}

constexpr size_t smem_floats() {
  return 2 * kQ * kLdN            // C, C'
         + 2 * kTile * kLdN       // B, B'
         + 2 * kTile * kMaxP      // x, x'
         + 2 * kQ * kLdQ          // the two M tiles
         + 2 * kMaxP * kLdN       // S, S'
         + 5 * kMaxChunk;         // dt, dt', seg, seg', w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_tangent_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bg,
                   const T* __restrict__ Cg, const T* __restrict__ tx,
                   const float* __restrict__ tdt,
                   const float* __restrict__ tA, const T* __restrict__ tB,
                   const T* __restrict__ tC, T* __restrict__ ty,
                   float* __restrict__ tstate, int L, int H, int P, int G,
                   int N, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* sC = smem;
  float* sTC = sC + kQ * kLdN;
  float* sB = sTC + kQ * kLdN;
  float* sTB = sB + kTile * kLdN;
  float* sX = sTB + kTile * kLdN;
  float* sTX = sX + kTile * kMaxP;
  float* sM1 = sTX + kTile * kMaxP;       // M' dt_k + M dt'_k  (times x)
  float* sM2 = sM1 + kQ * kLdQ;           // M dt_k             (times x')
  float* sS = sM2 + kQ * kLdQ;
  float* sTS = sS + kMaxP * kLdN;
  float* sDt = sTS + kMaxP * kLdN;
  float* sTDt = sDt + kMaxChunk;
  float* sSeg = sTDt + kMaxChunk;
  float* sTSeg = sSeg + kMaxChunk;
  float* sW = sTSeg + kMaxChunk;

  const int tid = threadIdx.x;
  const int tx_ = tid & 15, ty_ = tid >> 4;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int g = h / (H / G);
  const float a = A[bh], ta = tA[bh];
  const int nc = L / chunk;
  const size_t xs = (size_t)H * P, bs = (size_t)G * N;

  for (int i = tid; i < kMaxP * kLdN; i += kThreads) sS[i] = sTS[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const size_t t_chunk = (size_t)b * L + (size_t)ci * chunk;
    for (int i = tid; i < chunk; i += kThreads) {
      sDt[i] = dt[(t_chunk + i) * H + h];
      sTDt[i] = tdt[(t_chunk + i) * H + h];
    }
    __syncthreads();
    if (warp == 0) {
      scan(sDt, a, nullptr, 0.f, sSeg, chunk);
      scan(sTDt, a, sDt, ta, sTSeg, chunk);
    }
    __syncthreads();
    const float seg_end = sSeg[chunk - 1], tseg_end = sTSeg[chunk - 1];
    for (int i = tid; i < chunk; i += kThreads)
      sW[i] = expf(seg_end - sSeg[i]);

    // --- y': one 32-row query tile at a time ----------------------------
    for (int q0 = 0; q0 < chunk; q0 += kQ) {
      const int qrows = min(kQ, chunk - q0);
      stage(sC, kQ, kLdN, kMaxN, Cg + (t_chunk + q0) * bs + (size_t)g * N,
            bs, qrows, N);
      stage(sTC, kQ, kLdN, kMaxN, tC + (t_chunk + q0) * bs + (size_t)g * N,
            bs, qrows, N);
      __syncthreads();
      // entering: exp(seg_q) (seg'_q C_q.S0 + C'_q.S0 + C_q.S0')
      float acc[2][4], cs[2][4], tcs[2][4], cts[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = cs[i][j] = tcs[i][j] = cts[i][j] = 0.f;
      for (int n = 0; n < kMaxN; n += 4) {
        float4 cv[2], tcv[2], sv[4], tsv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          cv[i] = *reinterpret_cast<const float4*>(
              &sC[(ty_ + 16 * i) * kLdN + n]);
          tcv[i] = *reinterpret_cast<const float4*>(
              &sTC[(ty_ + 16 * i) * kLdN + n]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sv[j] = *reinterpret_cast<const float4*>(
              &sS[(tx_ + 16 * j) * kLdN + n]);
          tsv[j] = *reinterpret_cast<const float4*>(
              &sTS[(tx_ + 16 * j) * kLdN + n]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cs[i][j] = dot4(cv[i], sv[j], cs[i][j]);
            tcs[i][j] = dot4(tcv[i], sv[j], tcs[i][j]);
            cts[i][j] = dot4(cv[i], tsv[j], cts[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = ty_ + 16 * i;
        const bool in = q < qrows;
        const float e = in ? expf(sSeg[q0 + q]) : 0.f;
        const float ts = in ? sTSeg[q0 + q] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = e * fmaf(ts, cs[i][j], tcs[i][j] + cts[i][j]);
      }
      // intra-chunk: key tiles that start at or before the tile's last row
      for (int k0 = 0; k0 < q0 + qrows; k0 += kTile) {
        const int krows = min(kTile, chunk - k0);
        stage(sB, kTile, kLdN, kMaxN,
              Bg + (t_chunk + k0) * bs + (size_t)g * N, bs, krows, N);
        stage(sTB, kTile, kLdN, kMaxN,
              tB + (t_chunk + k0) * bs + (size_t)g * N, bs, krows, N);
        stage(sX, kTile, kMaxP, kMaxP,
              x + (t_chunk + k0) * xs + (size_t)h * P, xs, krows, P);
        stage(sTX, kTile, kMaxP, kMaxP,
              tx + (t_chunk + k0) * xs + (size_t)h * P, xs, krows, P);
        __syncthreads();
        float cb[2][4], cbd[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = cbd[i][j] = 0.f;
        for (int n = 0; n < kMaxN; n += 4) {
          float4 cv[2], tcv[2], bv[4], tbv[4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            cv[i] = *reinterpret_cast<const float4*>(
                &sC[(ty_ + 16 * i) * kLdN + n]);
            tcv[i] = *reinterpret_cast<const float4*>(
                &sTC[(ty_ + 16 * i) * kLdN + n]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bv[j] = *reinterpret_cast<const float4*>(
                &sB[(tx_ + 16 * j) * kLdN + n]);
            tbv[j] = *reinterpret_cast<const float4*>(
                &sTB[(tx_ + 16 * j) * kLdN + n]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              cb[i][j] = dot4(cv[i], bv[j], cb[i][j]);
              cbd[i][j] = dot4(tcv[i], bv[j], dot4(cv[i], tbv[j], cbd[i][j]));
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = q0 + ty_ + 16 * i;        // position in the chunk
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx_ + 16 * j;
            float m1 = 0.f, m2 = 0.f;
            if (k <= q && q < chunk) {
              const float E = expf(sSeg[q] - sSeg[k]);
              const float M = cb[i][j] * E;
              const float Md = cbd[i][j] * E + M * (sTSeg[q] - sTSeg[k]);
              m1 = fmaf(Md, sDt[k], M * sTDt[k]);
              m2 = M * sDt[k];
            }
            sM1[(ty_ + 16 * i) * kLdQ + tx_ + 16 * j] = m1;
            sM2[(ty_ + 16 * i) * kLdQ + tx_ + 16 * j] = m2;
          }
        }
        __syncthreads();
        for (int k = 0; k < kTile; ++k) {
          float xv[4], txv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xv[j] = sX[k * kMaxP + tx_ + 16 * j];
            txv[j] = sTX[k * kMaxP + tx_ + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m1 = sM1[(ty_ + 16 * i) * kLdQ + k];
            const float m2 = sM2[(ty_ + 16 * i) * kLdQ + k];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(m1, xv[j], fmaf(m2, txv[j], acc[i][j]));
          }
        }
        __syncthreads();   // before the next tiles overwrite B, x and M
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = ty_ + 16 * i;
        if (q >= qrows) continue;
        T* yrow = ty + (t_chunk + q0 + q) * xs + (size_t)h * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx_ + 16 * j;
          if (p < P) yrow[p] = cast<T>(acc[i][j]);
        }
      }
    }

    // --- S and S' at the chunk's end: a sweep over the key tiles --------
    float ds[4][8], dts[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ds[i][j] = dts[i][j] = 0.f;
    for (int k0 = 0; k0 < chunk; k0 += kTile) {
      const int krows = min(kTile, chunk - k0);
      stage(sB, kTile, kLdN, kMaxN, Bg + (t_chunk + k0) * bs + (size_t)g * N,
            bs, krows, N);
      stage(sTB, kTile, kLdN, kMaxN, tB + (t_chunk + k0) * bs + (size_t)g * N,
            bs, krows, N);
      stage(sX, kTile, kMaxP, kMaxP, x + (t_chunk + k0) * xs + (size_t)h * P,
            xs, krows, P);
      stage(sTX, kTile, kMaxP, kMaxP,
            tx + (t_chunk + k0) * xs + (size_t)h * P, xs, krows, P);
      __syncthreads();
      for (int k = 0; k < krows; ++k) {
        const int kc = k0 + k;
        const float w = sW[kc], d = sDt[kc];
        const float cx = w * fmaf(tseg_end - sTSeg[kc], d, sTDt[kc]);
        float u[4], tu[4], bv[8], tbv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = sX[k * kMaxP + ty_ + 16 * i];
          u[i] = w * d * xv;
          tu[i] = fmaf(cx, xv, w * d * sTX[k * kMaxP + ty_ + 16 * i]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bv[j] = sB[k * kLdN + tx_ + 16 * j];
          tbv[j] = sTB[k * kLdN + tx_ + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ds[i][j] = fmaf(u[i], bv[j], ds[i][j]);
            dts[i][j] = fmaf(tu[i], bv[j], fmaf(u[i], tbv[j], dts[i][j]));
          }
      }
      __syncthreads();
    }
    const float decay = expf(seg_end);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (ty_ + 16 * i) * kLdN + tx_ + 16 * j;
        const float s0 = sS[at];
        sTS[at] = fmaf(decay, fmaf(tseg_end, s0, sTS[at]), dts[i][j]);
        sS[at] = fmaf(decay, s0, ds[i][j]);
      }
    __syncthreads();
  }

  float* out = tstate + (size_t)bh * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx - (idx / N) * N;
    out[idx] = sTS[p * kLdN + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bg, const void* Cg, const void* tx,
                   const void* tdt, const void* tA, const void* tB,
                   const void* tC, void* ty, void* tstate, int Bsz, int L,
                   int H, int P, int G, int N, int chunk, cudaStream_t s) {
  auto kernel = ssd_tangent_kernel<T>;
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
      static_cast<const T*>(Cg), static_cast<const T*>(tx),
      static_cast<const float*>(tdt), static_cast<const float*>(tA),
      static_cast<const T*>(tB), static_cast<const T*>(tC),
      static_cast<T*>(ty), static_cast<float*>(tstate), L, H, P, G, N,
      chunk);
  return cudaGetLastError();
}

}  // namespace jvpk

}  // namespace

extern "C" {

// The largest head dim, state size and chunk the kernel takes.
int repro_ssd_max_head_dim() { return kMaxP; }
int repro_ssd_max_state() { return kMaxN; }
int repro_ssd_max_chunk() { return kMaxChunk; }

// float32 on the CUDA cores: x (Bsz, L, H, P) and Bg/Cg (Bsz, L, G, N)
// contiguous float32 (dtype DT_F32; bfloat16 goes to the passes below);
// dt (Bsz, L, H) and A (Bsz, H) float32; y (Bsz, L, H, P) float32; state
// (Bsz, H, P, N) float32.  L a multiple of chunk.
int repro_ssd_scan(const void* x, const void* dt, const void* A,
                   const void* Bg, const void* Cg, void* y, void* state,
                   int Bsz, int L, int H, int P, int G, int N, int chunk,
                   int dtype, void* stream) {
  if (dtype != DT_F32 || !valid(Bsz, L, H, P, G, N, chunk, dtype))
    return (int)cudaErrorInvalidValue;
  return (int)launch<float>(x, dt, A, Bg, Cg, y, state, Bsz, L, H, P, G, N,
                            chunk, static_cast<cudaStream_t>(stream));
}

// bfloat16 on Hopper, three launches (see namespace hop).  x (Bsz, L, H, P)
// and Bg/Cg (Bsz, L, G, N) contiguous bf16 with P and N multiples of 8 and
// 16-byte aligned pointers; dt (Bsz, L, H) float32; L a multiple of chunk;
// nc = L / chunk.

// Pass 1.  A[b * a_stride + h] float32 (a_stride 0: one A for every
// sequence); writes S (Bsz, nc, H, P, N) and seg (Bsz, H, L), float32.
int repro_ssd_chunk_state(const void* x, const void* dt, const void* A,
                          long long a_stride, const void* Bg, void* S,
                          void* seg, int Bsz, int L, int H, int P, int G,
                          int N, int chunk, void* stream) {
  if (!hop::shapes_ok(Bsz, L, H, P, G, N, chunk))
    return (int)cudaErrorInvalidValue;
  hop::StateArgs a{};
  const long long bnc = (long long)Bsz * (L / chunk);
  if (!hop::map_rows(&a.tx, x, P, H, chunk, bnc) ||
      !hop::map_rows(&a.tb, Bg, N, G, chunk, bnc))
    return (int)cudaErrorInvalidValue;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.S = static_cast<float*>(S);
  a.seg = static_cast<float*>(seg);
  a.a_stride = a_stride;
  a.L = L; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk;
  a.nc = L / chunk;
  a.hpb = hop::kStateHeads < H / G ? hop::kStateHeads : H / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(N <= 64 ? hop::run_state<1>(a, Bsz, s)
                       : hop::run_state<2>(a, Bsz, s));
}

// Pass 2.  S and seg from pass 1; writes the entering states of chunks
// 1 .. nc - 1 as bf16 planes hi and lo (Bsz, nc - 1, H, P, N) and the
// final state (Bsz, H, P, N) float32.
int repro_ssd_state_pass(const void* S, const void* seg, void* hi, void* lo,
                         void* state, int Bsz, int L, int H, int P, int N,
                         int chunk, void* stream) {
  if (!hop::shapes_ok(Bsz, L, H, P, 1, N, chunk))
    return (int)cudaErrorInvalidValue;
  hop::PassArgs a{};
  a.S = static_cast<const float*>(S);
  a.seg = static_cast<const float*>(seg);
  a.hi = static_cast<__nv_bfloat16*>(hi);
  a.lo = static_cast<__nv_bfloat16*>(lo);
  a.state = static_cast<float*>(state);
  a.quads = (long long)Bsz * H * P * N / 4;
  a.L = L; a.H = H; a.PN = P * N; a.chunk = chunk; a.nc = L / chunk;
  const long long blocks = (a.quads + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hop::state_pass_kernel<<<(unsigned)blocks, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Pass 3.  seg from pass 1, hi and lo from pass 2; writes y (Bsz, L, H, P)
// bf16.
int repro_ssd_chunk_scan(const void* x, const void* dt, const void* seg,
                         const void* Bg, const void* Cg, const void* hi,
                         const void* lo, void* y, int Bsz, int L, int H,
                         int P, int G, int N, int chunk, void* stream) {
  if (!hop::shapes_ok(Bsz, L, H, P, G, N, chunk))
    return (int)cudaErrorInvalidValue;
  hop::ScanArgs a{};
  const int nc = L / chunk;
  const long long bnc = (long long)Bsz * nc;
  if (!hop::map_rows(&a.tx, x, P, H, chunk, bnc) ||
      !hop::map_rows(&a.ty, y, P, H, chunk, bnc) ||
      !hop::map_rows(&a.tb, Bg, N, G, chunk, bnc) ||
      !hop::map_rows(&a.tc, Cg, N, G, chunk, bnc))
    return (int)cudaErrorInvalidValue;
  if (nc > 1) {                  // chunk 0 enters from the zero state
    const long long mats = (long long)Bsz * (nc - 1) * H;
    if (!hop::map_planes(&a.thi, hi, P, N, mats) ||
        !hop::map_planes(&a.tlo, lo, P, N, mats))
      return (int)cudaErrorInvalidValue;
  }
  a.dt = static_cast<const float*>(dt);
  a.seg = static_cast<const float*>(seg);
  a.L = L; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk; a.nc = nc;
  a.hpb = hop::kScanHeads < H / G ? hop::kScanHeads : H / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(N <= 64 ? hop::run_scan<1>(a, Bsz, s)
                       : hop::run_scan<2>(a, Bsz, s));
}

// T3 in bfloat16 on Hopper, three launches (see namespace t3).  x, x'
// (Bsz, L, H, P) and Bg, Cg, B', C' (Bsz, L, G, N) contiguous bf16 with P
// and N multiples of 8 and 16-byte aligned pointers; dt, dt' (Bsz, L, H)
// float32; L a multiple of chunk; nc = L / chunk.

// Pass 1.  A[b * a_stride + h] and A'[b * ta_stride + h] float32; writes
// S, S' (Bsz, nc, H, P, N) and seg, seg' (Bsz, H, L), float32.
int repro_ssd_tangent_state(const void* x, const void* dt, const void* A,
                            long long a_stride, const void* Bg,
                            const void* tx, const void* tdt, const void* tA,
                            long long ta_stride, const void* tB, void* S,
                            void* tS, void* seg, void* tseg, int Bsz, int L,
                            int H, int P, int G, int N, int chunk,
                            void* stream) {
  if (!hop::shapes_ok(Bsz, L, H, P, G, N, chunk))
    return (int)cudaErrorInvalidValue;
  t3::StateArgs a{};
  const long long bnc = (long long)Bsz * (L / chunk);
  if (!hop::map_rows(&a.tx, x, P, H, chunk, bnc) ||
      !hop::map_rows(&a.ttx, tx, P, H, chunk, bnc) ||
      !hop::map_rows(&a.tb, Bg, N, G, chunk, bnc) ||
      !hop::map_rows(&a.ttb, tB, N, G, chunk, bnc))
    return (int)cudaErrorInvalidValue;
  a.dt = static_cast<const float*>(dt);
  a.tdt = static_cast<const float*>(tdt);
  a.A = static_cast<const float*>(A);
  a.tA = static_cast<const float*>(tA);
  a.S = static_cast<float*>(S);
  a.tS = static_cast<float*>(tS);
  a.seg = static_cast<float*>(seg);
  a.tseg = static_cast<float*>(tseg);
  a.a_stride = a_stride;
  a.ta_stride = ta_stride;
  a.L = L; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk;
  a.nc = L / chunk;
  a.hpb = t3::kT3StateHeads < H / G ? t3::kT3StateHeads : H / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(N <= 64 ? t3::run_state<1>(a, Bsz, s)
                       : t3::run_state<2>(a, Bsz, s));
}

// Pass 2.  S, S', seg and seg' from pass 1; writes the entering states and
// their tangents of chunks 1 .. nc - 1 as bf16 planes hi, lo, thi, tlo
// (Bsz, nc - 1, H, P, N) and the final state's tangent (Bsz, H, P, N)
// float32.
int repro_ssd_tangent_pass(const void* S, const void* tS, const void* seg,
                           const void* tseg, void* hi, void* lo, void* thi,
                           void* tlo, void* tstate, int Bsz, int L, int H,
                           int P, int N, int chunk, void* stream) {
  if (!hop::shapes_ok(Bsz, L, H, P, 1, N, chunk))
    return (int)cudaErrorInvalidValue;
  t3::PassArgs a{};
  a.S = static_cast<const float*>(S);
  a.tS = static_cast<const float*>(tS);
  a.seg = static_cast<const float*>(seg);
  a.tseg = static_cast<const float*>(tseg);
  a.hi = static_cast<__nv_bfloat16*>(hi);
  a.lo = static_cast<__nv_bfloat16*>(lo);
  a.thi = static_cast<__nv_bfloat16*>(thi);
  a.tlo = static_cast<__nv_bfloat16*>(tlo);
  a.tstate = static_cast<float*>(tstate);
  a.quads = (long long)Bsz * H * P * N / 4;
  a.L = L; a.H = H; a.PN = P * N; a.chunk = chunk; a.nc = L / chunk;
  const long long blocks = (a.quads + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  t3::tangent_pass_kernel<<<(unsigned)blocks, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Pass 3.  seg, seg' from pass 1, the planes from pass 2; writes y' (Bsz,
// L, H, P) bf16.
int repro_ssd_tangent_scan(const void* x, const void* dt, const void* seg,
                           const void* Bg, const void* Cg, const void* tx,
                           const void* tdt, const void* tseg, const void* tB,
                           const void* tC, const void* hi, const void* lo,
                           const void* thi, const void* tlo, void* ty,
                           int Bsz, int L, int H, int P, int G, int N,
                           int chunk, void* stream) {
  if (!hop::shapes_ok(Bsz, L, H, P, G, N, chunk))
    return (int)cudaErrorInvalidValue;
  t3::ScanArgs a{};
  const int nc = L / chunk;
  const long long bnc = (long long)Bsz * nc;
  if (!hop::map_rows(&a.tx, x, P, H, chunk, bnc) ||
      !hop::map_rows(&a.ttx, tx, P, H, chunk, bnc) ||
      !hop::map_rows(&a.ty, ty, P, H, chunk, bnc) ||
      !hop::map_rows(&a.tb, Bg, N, G, chunk, bnc) ||
      !hop::map_rows(&a.ttb, tB, N, G, chunk, bnc) ||
      !hop::map_rows(&a.tc, Cg, N, G, chunk, bnc) ||
      !hop::map_rows(&a.ttc, tC, N, G, chunk, bnc))
    return (int)cudaErrorInvalidValue;
  if (nc > 1) {                  // chunk 0 enters from the zero state
    const long long mats = (long long)Bsz * (nc - 1) * H;
    if (!hop::map_planes(&a.thi, hi, P, N, mats) ||
        !hop::map_planes(&a.tlo, lo, P, N, mats) ||
        !hop::map_planes(&a.tthi, thi, P, N, mats) ||
        !hop::map_planes(&a.ttlo, tlo, P, N, mats))
      return (int)cudaErrorInvalidValue;
  }
  a.dt = static_cast<const float*>(dt);
  a.tdt = static_cast<const float*>(tdt);
  a.seg = static_cast<const float*>(seg);
  a.tseg = static_cast<const float*>(tseg);
  a.L = L; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk; a.nc = nc;
  a.hpb = t3::kT3ScanHeads < H / G ? t3::kT3ScanHeads : H / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(N <= 64 ? t3::run_scan<1>(a, Bsz, s)
                       : t3::run_scan<2>(a, Bsz, s));
}

// The forward-mode tangent T3 on the CUDA cores (namespace jvpk), the
// float32 route: x, B, C and their tangents x', B', C' contiguous, float32
// (dtype DT_F32) or bfloat16 (DT_BF16);
// dt, dt' (Bsz, L, H) and A, A' (Bsz, H) float32; writes y' (Bsz, L, H, P)
// in x's dtype and the final state's tangent (Bsz, H, P, N) float32.
int repro_ssd_scan_tangent(const void* x, const void* dt, const void* A,
                           const void* Bg, const void* Cg, const void* tx,
                           const void* tdt, const void* tA, const void* tB,
                           const void* tC, void* ty, void* tstate, int Bsz,
                           int L, int H, int P, int G, int N, int chunk,
                           int dtype, void* stream) {
  if (!valid(Bsz, L, H, P, G, N, chunk, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == DT_BF16
                   ? jvpk::launch<__nv_bfloat16>(x, dt, A, Bg, Cg, tx, tdt,
                                                 tA, tB, tC, ty, tstate, Bsz,
                                                 L, H, P, G, N, chunk, s)
                   : jvpk::launch<float>(x, dt, A, Bg, Cg, tx, tdt, tA, tB,
                                         tC, ty, tstate, Bsz, L, H, P, G, N,
                                         chunk, s));
}

}  // extern "C"
