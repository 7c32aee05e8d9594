// Hopper (sm_90a) flash-attention kernels, forward and backward, bound
// through a plain C interface (ctypes; see ../ops.py).
//
// forward — replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_fwd_lse
//   (_flash_kernel): online-softmax attention over (B, H, S, d) with causal
//   and sliding-window masks taken from positions; emits out (q's dtype)
//   and the per-row logsumexp lse (float32).  m, l and acc stay float32.
// backward — replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention/flash_bwd.py::flash_attention_bwd
//   (_dkv_kernel, _dq_kernel): the FlashAttention-2 backward.  P = exp(S -
//   lse) is recomputed from q, k and lse; dS = P * (dP - D) * scale with
//   dP = dO V^T and D = rowsum(dO * O), computed by the dQ kernel; dK and dV
//   accumulate over query tiles, dQ over key tiles.  Two launches, dQ then
//   dK/dV, as in the reference, so nothing is summed with atomics and every
//   result is the same from run to run.
//
// forward and backward tangents (T1, T2; namespace jvpk) — no TPU
//   counterpart: the forward-mode rules of both autograd Functions, so that
//   the exact meta-gradient's forward-over-reverse Hessian-vector products
//   run through the kernels (see the section's own comment).
//
// Masks, as the reference: a key the band excludes gets the logit -1e30
// (so a row that has seen no allowed key yet carries exp(0) terms that the
// first allowed key's rescale by exp(-1e30 - m) = 0 wipes out, exactly as
// in the Pallas kernel).  Keys and queries past the sequence ends are
// outside the problem and contribute exactly nothing, so any S and S_k
// work.  Key tiles that lie wholly outside the causal or window band of a
// query tile (and query tiles outside a key tile's band) are skipped.
//
// Two routes, chosen by dtype in ../ops.py.
//
// bfloat16 (namespace hop, below): written for Hopper.  At the qwen2
// serving path's shape (B = 16, S = 256, 12 query heads on 2 KV heads,
// d = 128, causal) the forward reads q, k, v and writes o once: 29 MB with
// K/V unexpanded, 8.8 us at 3.35 TB/s, against 3.3 us of flops at the 989
// TFLOP/s bf16 tensor rate (about 5 us with the hi/lo products), so bytes
// bound it; the backward moves about twice the bytes.  Design: wgmma on the tensor cores, TMA for every tile
// in and out, the views' own strides (no expansion or copy), and blocks
// that each own one 64-row tile of one head.
//
// float32: the backward on the tensor cores as three TF32 products
// (namespace tf32, after hop), on the same strided views as bf16.  The
// forward is a plain FMA kernel on the CUDA cores (the flops at 67
// TFLOP/s bound it), which takes contiguous (B*H, S, d) with heads expanded
// by the wrapper.  A block owns a 64-row tile and 8 warps of 8 rows each;
// tiles are staged in shared memory (head dims up to 128 zero-padded to 32,
// 64 or 128), padded by 4 words where lanes read them by row, so a lane's
// 16-byte loads of consecutive rows fall in distinct banks.
//
// No kernel allocates or synchronises; each launches on the stream it is
// given, and each C entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // query rows and key rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;     // rows a warp owns
constexpr int kMaxHeadDim = 128;
constexpr float kMasked = -1e30f;         // the reference's NEG_INF


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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Query position qp may see key position kp.  window <= 0: no window.
__device__ __forceinline__ bool allowed(int qp, int kp, int causal,
                                        int window) {
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// Stage rows [row0, row0 + kTile) of a (rows, d) matrix into a float32
// tile with row stride ld and D columns; rows past the end and columns
// past d are zero.  Neighbouring threads read neighbouring elements.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int row0, int rows, int d) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows && c < d) x = to_f32(src[(size_t)gr * d + c]);
    dst[r * ld + c] = x;
  }
}

// Key tiles [begin, end) a query tile starting at q0 must visit.
__device__ __forceinline__ void key_range(int q0, int S, int Sk, int causal,
                                          int window, int* begin, int* end) {
  const int nk = (Sk + kTile - 1) / kTile;
  int b = 0, e = nk;
  if (causal) {
    const int q_last = min(q0 + kTile, S) - 1;
    e = min(nk, q_last / kTile + 1);
  }
  if (window > 0) b = max(0, q0 - window + 1) / kTile;
  *begin = b;
  *end = max(b, e);
}

// Query tiles [begin, end) a key tile starting at k0 must visit.
__device__ __forceinline__ void query_range(int k0, int S, int Sk,
                                            int causal, int window,
                                            int* begin, int* end) {
  const int nq = (S + kTile - 1) / kTile;
  int b = 0, e = nq;
  if (causal) b = k0 / kTile;
  if (window > 0) {
    const int k_last = min(k0 + kTile, Sk) - 1;
    e = min(nq, (k_last + window - 1) / kTile + 1);
  }
  *begin = b;
  *end = max(b, e);
}

// ---------------------------------------------------------------------------
// forward: one block per (b*h, query tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Sk, int d, float scale,
                 int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 32;                 // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                          // kTile x LD
  float* sK = sQ + kTile * LD;               // kTile x LD
  float* sV = sK + kTile * LD;               // kTile x D
  float* sP = sV + kTile * D;                // kTile x kTile

  const int nq = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * kTile;
  const T* qb = q + (size_t)bh * S * d;
  const T* kb = k + (size_t)bh * Sk * d;
  const T* vb = v + (size_t)bh * Sk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;

  load_tile<T, D>(sQ, LD, qb, q0, S, d);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int kt_begin, kt_end;
  key_range(q0, S, Sk, causal, window, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                         // last tile's readers are done
    load_tile<T, D>(sK, LD, kb, k0, Sk, d);
    load_tile<T, D>(sV, D, vb, k0, Sk, d);
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sK[lane * LD + c]);
      const float4 kc =
          *reinterpret_cast<const float4*>(&sK[(lane + 32) * LD + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sQ[(r0 + r) * LD + c]);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kc, s[r][1]);
      }
    }

    // online softmax update of m, l and acc
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        s[r][j] = kp >= Sk ? -INFINITY
                : allowed(qp, kp, causal, window) ? s[r][j] * scale
                : kMasked;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      sP[(r0 + r) * kTile + lane] = p0;
      sP[(r0 + r) * kTile + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over this tile's keys
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sP[(r0 + r) * kTile + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * S + qp) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) orow[col] = from_f32<T>(acc[r][c] / lc);
    }
    if (lane == 0) lse[(size_t)bh * S + qp] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (D + 4) + kTile * D + kTile * kTile);
}

// Lets `kernel` use `bytes` of dynamic shared memory (above the 48 KB
// default).  Set once per kernel and process, before the first launch, so
// that a launch recorded into a CUDA graph makes no such call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int S, int Sk, int d, float scale,
                       int causal, int window, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<T, D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>(), &ready);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)BH * ((S + kTile - 1) / kTile);
  kernel<<<(unsigned)blocks, kThreads, fwd_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, Sk, d, scale, causal, window);
  return cudaGetLastError();
}

bool valid(int BH, int S, int Sk, int d) {
  const int longest = S > Sk ? S : Sk;
  const long long blocks = (long long)BH * ((longest + kTile - 1) / kTile);
  return BH >= 1 && S >= 1 && Sk >= 1 && d >= 1 && d <= kMaxHeadDim &&
         blocks <= 0x7fffffffLL;
}


// ===========================================================================
// bfloat16 on Hopper: wgmma on the tensor cores, TMA double buffering,
// strided reads of any (B, S, H, d) or (B, H, S, d) view, GQA by index
// ===========================================================================
//
// A block is one warpgroup (128 threads) per 64 rows it owns: wgmma's M.
// Tiles stay bf16 in shared memory, 64 rows x 64 columns to an 8 KB region
// (d <= 64: one region, d <= 128: two, zero-padded), each row a 128-byte
// line with the 128-byte swizzle that both TMA and wgmma's descriptors
// name.  One layout serves both uses of a tile: read K-major (A B^T over d)
// and MN-major (P B over the rows, the transposed-B descriptor).  One thread
// asks TMA for the next tile (a box of 64 rows x 64 columns per region,
// rows past the end zero-filled) into the other of two stages, with an
// mbarrier per stage, so tile j + 1 is in flight while tile j is
// multiplied, and no thread spends instructions on addresses.  A view whose
// rows are not 16-byte aligned (no tensor map) is read element by element
// into the same layout.
//
// Numerics as the float32 route: logits, P and dS stay float32 in
// registers (exp as 2^x of log2-scaled logits); the products that take P or
// dS as A (P V, dS K, P^T dO, dS^T Q) take each as two bf16 halves, hi =
// bf16(x) and lo = bf16(x - hi), into one float32 accumulator (about 16
// significant bits; Q, K, V and dO are bf16 and exact).  D = rowsum(dO * O)
// is the diagonal of dO O^T on the tensor cores, as dP is, so dP - D is
// exactly 0 where a row sees a single key.

namespace hop {

using bf16 = __nv_bfloat16;

constexpr int kM = 64;                  // rows a warpgroup owns (wgmma M)
constexpr int kN = 64;                  // rows of the other side a step visits
constexpr int kWG = 128;                // threads of a warpgroup
constexpr uint32_t kRegion = 64 * 128;  // 64 rows x 64 bf16 columns, bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {                        // element strides; d has stride 1
  long long b, s, h;
};

// The tensor map of a view: dims (d, H, S, B) or, where the sequence
// stride is the smaller, (d, S, H, B); boxes of 64 rows x 64 columns.
struct TileMap {
  CUtensorMap map;
  int heads_inner;                      // 1: (d, H, S, B)
};

struct Args {
  TileMap tq, tk, tv, to, tdo, tdq, tdk, tdv;   // used when tma = 1
  const bf16 *q, *k, *v, *dout;
  bf16 *o, *dq, *dk, *dv;               // o: written by the forward, read
  float *lse, *dsum;                    // by the backward; lse, dsum (B,H,S)
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, KV, S, Sk, d;
  float scale;
  int causal, window;
  int tma;                              // 1: 16-byte aligned rows, d % 8 == 0
};

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

// Rows [row0, row0 + 64) of head h of batch b of a view into the tile at
// dst, by TMA, completing on bar (which must expect the tile's bytes).
template <int NH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const TileMap& m,
                                         uint32_t bar, int b, int h,
                                         int row0) {
  const uint64_t map = reinterpret_cast<uint64_t>(&m.map);
  const int c1 = m.heads_inner ? h : row0, c2 = m.heads_inner ? row0 : h;
#pragma unroll
  for (int c = 0; c < NH; ++c)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            dst + c * kRegion),
        "l"(map), "r"(bar), "r"(64 * c), "r"(c1), "r"(c2), "r"(b)
        : "memory");
}

// The tile at src (written by this warpgroup, made visible by the caller's
// fence and barrier) to rows [row0, row0 + 64) of head h of batch b of a
// view, by TMA (rows and columns past the ends are not written); waits
// until the tile has been read.  One thread.
template <int NH>
__device__ __forceinline__ void tma_store_tile(uint32_t src, const TileMap& m,
                                               int b, int h, int row0) {
  const uint64_t map = reinterpret_cast<uint64_t>(&m.map);
  const int c1 = m.heads_inner ? h : row0, c2 = m.heads_inner ? row0 : h;
#pragma unroll
  for (int c = 0; c < NH; ++c)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
        "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map),
        "r"(src + c * kRegion), "r"(64 * c), "r"(c1), "r"(c2), "r"(b)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const TileMap& m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(&m.map))
               : "memory");
}

// The same tile, element by element (views without a tensor map): NT
// threads share the work, tid in [0, NT); rows past `rows` and columns past
// d are zero.  src is row 0 of (b, h), ld the row stride.
template <int NH, int NT>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src,
                                          long long ld, int row0, int rows,
                                          int d, int tid) {
  constexpr int kChunks = 8 * NH;
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(src);
  for (int idx = tid; idx < kM * kChunks; idx += NT) {
    const int r = idx / kChunks, c = idx - (idx / kChunks) * kChunks;
    const int gr = row0 + r, col = 8 * c;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t lo = 0, hi = 0;
      const long long at = (long long)gr * ld + col + 2 * e;
      if (gr < rows && col + 2 * e < d) lo = raw[at];
      if (gr < rows && col + 2 * e + 1 < d) hi = raw[at + 1];
      w[e] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + swz(r, c)),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// Element-by-element stores go through the generic proxy, wgmma reads
// through the async one: each thread orders its own stores before the
// barrier that follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_group(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWG) : "memory");
}

// 64 floats src[row0 .. row0 + 63] into shared dst, zero past `rows`: one
// 4-byte cp.async a thread, tid < 64.
__device__ __forceinline__ void load_row_vec(uint32_t dst, const float* src,
                                             int row0, int rows, int tid) {
  const bool in = row0 + tid < rows;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4u * tid),
               "l"(in ? src + row0 + tid : src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from reading (or moving) accumulator registers across
// the asynchronous product's issue and wait.
template <int N> __device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
// The same for A fragments that an issued product still reads.
__device__ __forceinline__ void keep(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(x[i / 4][i % 4])::"memory");
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

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared memory,
// MN-major: 16 rows of 64 columns).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc = A B^T over the head dim: A and B 64-row tiles at shared a and b.
template <int NH>
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NH; ++kk) {
    const uint32_t off = (kk >> 2) * kRegion + (kk & 3) * 32;
    wgmma_ss(acc, desc(a + off), desc(b + off), kk > 0);
  }
}

#define REPRO_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared memory,
// MN-major: 16 rows across two 64-column regions, kRegion apart by the
// descriptor's LBO).
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d), REPRO_ACC32((d + 32))
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc[c] += (hi + lo) B[:, 64c .. 64c + 63]: hi/lo the two bf16 halves of a
// 64 x 64 float32 operand as A fragments, B a 64-row tile at shared b; with
// two regions, one m64n128k16 a step over both (acc's two halves are the
// n128 accumulator's columns 0-63 and 64-127).
template <int NH>
__device__ __forceinline__ void mma_pb(float (&acc)[NH][32],
                                       const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4],
                                       uint32_t b) {
  if constexpr (NH == 2) {
    float (&flat)[64] = reinterpret_cast<float (&)[64]>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc(b + kk * 16 * 128);
      wgmma_rs128(flat, hi[kk], db);
      wgmma_rs128(flat, lo[kk], db);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc(b + kk * 16 * 128);
      wgmma_rs(acc[0], hi[kk], db);
      wgmma_rs(acc[0], lo[kk], db);
    }
  }
}

// Accumulator element e of thread t (of its warpgroup) sits at row
// frag_row(e, t) and column frag_col(e, t) of the 64 x 64 result.
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

// The accumulator layout read as wgmma's A fragments (16 columns a step),
// split into hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split(const float (&x)[32],
                                      uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * kk + 2 * j], b = x[8 * kk + 2 * j + 1];
      const uint32_t h = pack_bf16(a, b);
      hi[kk][j] = h;
      lo[kk][j] = pack_bf16(a - __uint_as_float(h << 16),
                            b - __uint_as_float(h & 0xffff0000u));
    }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Writes a 64-row accumulator (rows row0 + frag_row) to rows < rows of a
// (rows, d) bf16 matrix at dst with row stride ld, element by element.
template <int NH>
__device__ __forceinline__ void store_acc(const float (&acc)[NH][32],
                                          bf16* dst, long long ld, int row0,
                                          int rows, int d, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + frag_row(2 * r, t);
    if (row >= rows) continue;
    bf16* out = dst + (long long)row * ld;
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * c + frag_col(4 * i, t);
        if (col < d) out[col] = __float2bfloat16_rn(acc[c][4 * i + 2 * r]);
        if (col + 1 < d)
          out[col + 1] = __float2bfloat16_rn(acc[c][4 * i + 2 * r + 1]);
      }
  }
}

// A warpgroup's 64-row accumulator as bf16 into rows [row0, row0 + 64) of
// head h of batch b of a view: through the free tile at shared `stage` and
// one TMA store, or, without a tensor map, straight from the registers.
// Every thread of the warpgroup (named barrier `group`) calls it.
template <int NH>
__device__ __forceinline__ void write_tile(const float (&acc)[NH][32],
                                           uint32_t stage, const TileMap& m,
                                           bf16* dst, long long ld, int b,
                                           int h, int row0, int rows,
                                           const Args& a, int t, int group) {
  if (!a.tma) {
    store_acc<NH>(acc, dst, ld, row0, rows, a.d, t);
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         stage + swz(frag_row(2 * r, t), 8 * c + i) +
                         4 * (t & 3)),
                     "r"(pack_bf16(acc[c][4 * i + 2 * r],
                                   acc[c][4 * i + 2 * r + 1]))
                     : "memory");
  fence_async_smem();
  bar_group(group);
  if (t == 0) tma_store_tile<NH>(stage, m, b, h, row0);
}

// A tile pair (query tile at q0, key tile at k0) needs the mask only on
// the band's edge or past a sequence end.
__device__ __forceinline__ bool edge_tile(int q0, int k0, int S, int Sk,
                                          int causal, int window) {
  return q0 + kM > S || k0 + kN > Sk || (causal && k0 + kN - 1 > q0) ||
         (window > 0 && k0 <= q0 + kM - 1 - window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The band as bounds on delta = query position - key position: a pair is
// allowed iff lo <= delta <= hi (causal: delta >= 0; a window w: delta <
// w).  Element e of a thread's 64 x 64 tile sits rofs(e) rows and cofs(e)
// columns from its element 0, both known at compile time once unrolled.
struct Band {
  int lo, hi;
};
__device__ __forceinline__ Band band(const Args& a) {
  return Band{a.causal ? 0 : INT_MIN, a.window > 0 ? a.window - 1 : INT_MAX};
}
__device__ __forceinline__ int rofs(int e) { return 8 * ((e >> 1) & 1); }
__device__ __forceinline__ int cofs(int e) { return 8 * (e >> 2) + (e & 1); }

// P = exp(S * scale - L) in place, as 2^(S * c - L * log2 e) with c =
// scale * log2 e, for a 64 x 64 tile of logits whose rows are queries
// (kQueryRows: L the thread's two rows' values, already times log2 e) or
// keys (L the tile's 64 query values in shared memory, natural units).  On
// an edge tile, pairs outside the sequences give 0 and pairs outside the
// band the logit -1e30.
template <bool kQueryRows>
__device__ __forceinline__ void probs(float (&s)[32], const float* L,
                                      float c, bool edge, int q0, int k0,
                                      const Args& a, int t) {
  const int r0 = frag_row(0, t), c0 = frag_col(0, t);
  // positions of element 0's query and key
  const int qp0 = q0 + (kQueryRows ? r0 : c0);
  const int kp0 = k0 + (kQueryRows ? c0 : r0);
  const Band bd = band(a);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float l2 =
        kQueryRows ? L[(e >> 1) & 1] : L[c0 + cofs(e)] * kLog2e;
    float x = fmaf(s[e], c, -l2);
    if (edge) {
      const int qp = qp0 + (kQueryRows ? rofs(e) : cofs(e));
      const int kp = kp0 + (kQueryRows ? cofs(e) : rofs(e));
      const int delta = qp - kp;
      x = delta < bd.lo || delta > bd.hi ? kMasked * kLog2e - l2 : x;
      x = qp < a.S && kp < a.Sk ? x : -INFINITY;
    }
    s[e] = exp2_approx(x);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, head, batch)
// ---------------------------------------------------------------------------

template <int NH> constexpr size_t fwd_smem() {
  return 1024 + 5 * NH * kRegion + 64;  // Q, two stages of K and V; barriers
}

template <int NH>
__global__ void __launch_bounds__(kWG, 2)
fwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t T = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, bars = base + 5 * T;  // Q, stage 0, stage 1
  const int t = threadIdx.x;
  // the last query tiles (the most key tiles, causal) are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kM, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  const bf16* kb = a.k + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + hk * a.sv.h;
  auto stage = [&](int i) { return base + T + 2 * T * (i & 1); };
  auto fetch = [&](int i, int kt) {      // K and V tile kt into stage i & 1
    const uint32_t sK = stage(i), bar = bars + 8 * (1 + (i & 1));
    if (a.tma) {
      if (t == 0) {
        mbar_expect(bar, 2 * T);
        tma_tile<NH>(sK, a.tk, bar, b, hk, kt * kN);
        tma_tile<NH>(sK + T, a.tv, bar, b, hk, kt * kN);
      }
    } else {
      copy_tile<NH, kWG>(sK, kb, a.sk.s, kt * kN, a.Sk, a.d, t);
      copy_tile<NH, kWG>(sK + T, vb, a.sv.s, kt * kN, a.Sk, a.d, t);
    }
  };

  int kt0, kt1;
  key_range(q0, a.S, a.Sk, a.causal, a.window, &kt0, &kt1);
  if (t == 0) {
    if (a.tma) {
      prefetch_map(a.tq);
      prefetch_map(a.tk);
      prefetch_map(a.tv);
    }
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (a.tma) {
    if (t == 0) {
      mbar_expect(bars, T);
      tma_tile<NH>(sQ, a.tq, bars, b, hq, q0);
    }
  } else {
    copy_tile<NH, kWG>(sQ, a.q + b * a.sq.b + hq * a.sq.h, a.sq.s, q0, a.S,
                       a.d, t);
  }
  if (kt0 < kt1) fetch(0, kt0);

  float acc[NH][32], s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = 0.f;
#pragma unroll
    for (int c = 0; c < NH; ++c) acc[c][e] = 0.f;
  }
  const float c = a.scale * kLog2e;
  const Band bd = band(a);
  float m[2] = {kMasked * kLog2e, kMasked * kLog2e}, l[2] = {0.f, 0.f};

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    const uint32_t sK = stage(i), sV = sK + T;
    if (a.tma) {
      if (i == 0) mbar_wait(bars, 0);
      mbar_wait(bars + 8 * (1 + (i & 1)), (i >> 1) & 1);
    } else {
      fence_async_smem();
      __syncthreads();
    }

    wg_fence();
    mma_abt<NH>(s, sQ, sK);
    wg_commit();
    // the next tile goes into the stage freed at the end of the last step,
    // issued while the tensor cores work
    if (kt + 1 < kt1) fetch(i + 1, kt + 1);
    wg_wait();
    keep(s);

    // online softmax in log2 units: row max, rescale, P = 2^(x - m)
    const int k0 = kt * kN;
    const bool edge = edge_tile(q0, k0, a.S, a.Sk, a.causal, a.window);
    const int delta0 = q0 + frag_row(0, t) - k0 - frag_col(0, t);
    const int kleft = a.Sk - k0 - frag_col(0, t);  // keys left from col 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * c;
      if (edge) {
        const int delta = delta0 + rofs(e) - cofs(e);
        x = delta < bd.lo || delta > bd.hi ? kMasked * kLog2e : x;
        x = cofs(e) < kleft ? x : -INFINITY;
      }
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      const float p = exp2_approx(s[e] - m[r]);
      l[r] += p;
      s[e] = p;
#pragma unroll
      for (int cc = 0; cc < NH; ++cc) acc[cc][e] *= alpha[r];
    }
    uint32_t hi[4][4], lo[4][4];
    split(s, hi, lo);
    wg_fence();
    mma_pb<NH>(acc, hi, lo, sV);
    wg_commit();
    wg_wait();
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) keep(acc[cc]);
    __syncthreads();                   // stage read by all before refilled
  }

  if (a.tma && kt0 == kt1) mbar_wait(bars, 0);   // Q landed; no key tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f), inv = 1.f / lc;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (((e >> 1) & 1) == r)
#pragma unroll
        for (int cc = 0; cc < NH; ++cc) acc[cc][e] *= inv;
    const int row = q0 + frag_row(2 * r, t);
    if ((t & 3) == 0 && row < a.S)
      a.lse[((long long)b * a.H + hq) * a.S + row] =
          (m[r] + log2f(lc)) * kLn2;
  }
  write_tile<NH>(acc, sQ, a.to, a.o + b * a.so.b + hq * a.so.h, a.so.s, b,
                 hq, q0, a.S, a, t, 1);                  // Q is free now
}

// ---------------------------------------------------------------------------
// backward, dQ (first launch): one block per (query tile, head, batch).
// Computes D = rowsum(dO * O) of its rows, keeps it, and writes it to
// a.dsum for the dK/dV launch.
// ---------------------------------------------------------------------------

template <int NH> constexpr size_t dq_smem() {
  // Q, dO, two stages of K and V (O in the second K slot at first); D;
  // barriers
  return 1024 + 6 * NH * kRegion + 64 * 4 + 64;
}

template <int NH>
__global__ void __launch_bounds__(kWG, 2)
dq_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t T = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  float* sD = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) +
                                       6 * T);
  const uint32_t sQ = base, sO = base + T, bars = base + 6 * T + 256;
  const int t = threadIdx.x;
  // the last query tiles (the most key tiles, causal) are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kM, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  const bf16* kb = a.k + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + hk * a.sv.h;
  const long long row_vec = ((long long)b * a.H + hq) * a.S;
  auto stage = [&](int i) { return base + 2 * T + 2 * T * (i & 1); };
  auto fetch = [&](int i, int kt) {
    const uint32_t sK = stage(i), bar = bars + 8 * (1 + (i & 1));
    if (a.tma) {
      if (t == 0) {
        mbar_expect(bar, 2 * T);
        tma_tile<NH>(sK, a.tk, bar, b, hk, kt * kN);
        tma_tile<NH>(sK + T, a.tv, bar, b, hk, kt * kN);
      }
    } else {
      copy_tile<NH, kWG>(sK, kb, a.sk.s, kt * kN, a.Sk, a.d, t);
      copy_tile<NH, kWG>(sK + T, vb, a.sv.s, kt * kN, a.Sk, a.d, t);
    }
  };

  int kt0, kt1;
  key_range(q0, a.S, a.Sk, a.causal, a.window, &kt0, &kt1);
  if (t == 0) {
    if (a.tma) {
      prefetch_map(a.tq);
      prefetch_map(a.tdo);
      prefetch_map(a.to);
      prefetch_map(a.tk);
      prefetch_map(a.tv);
    }
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  // Q, dO and O (into the second stage's K slot, free until the loop's
  // first prefetch), then the first K and V tile
  if (a.tma) {
    if (t == 0) {
      mbar_expect(bars, 3 * T);
      tma_tile<NH>(sQ, a.tq, bars, b, hq, q0);
      tma_tile<NH>(sO, a.tdo, bars, b, hq, q0);
      tma_tile<NH>(base + 4 * T, a.to, bars, b, hq, q0);
    }
  } else {
    copy_tile<NH, kWG>(sQ, a.q + b * a.sq.b + hq * a.sq.h, a.sq.s, q0, a.S,
                       a.d, t);
    copy_tile<NH, kWG>(sO, a.dout + b * a.sdo.b + hq * a.sdo.h, a.sdo.s, q0,
                       a.S, a.d, t);
    copy_tile<NH, kWG>(base + 4 * T, a.o + b * a.so.b + hq * a.so.h, a.so.s,
                       q0, a.S, a.d, t);
  }
  if (kt0 < kt1) fetch(0, kt0);
  float L2[2];                          // lse of the thread's rows, log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + frag_row(2 * r, t);
    L2[r] = row < a.S ? a.lse[row_vec + row] * kLog2e : 0.f;
  }
  if (a.tma) {
    mbar_wait(bars, 0);
  } else {
    fence_async_smem();
    __syncthreads();
  }
  // D = rowsum(dO * O) as the diagonal of dO O^T, on the tensor cores as
  // dP is: where a row sees one key (P = 1, O = V), dP - D is then exactly
  // 0, as it is in exact arithmetic.
  {
    float dd[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dd[e] = 0.f;
    wg_fence();
    mma_abt<NH>(dd, sO, base + 4 * T);
    wg_commit();
    wg_wait();
    keep(dd);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = frag_row(e, t);
      if (r == frag_col(e, t)) {
        sD[r] = dd[e];
        if (q0 + r < a.S) a.dsum[row_vec + q0 + r] = dd[e];
      }
    }
  }
  __syncthreads();
  const float c = a.scale * kLog2e;
  float D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) D[r] = sD[frag_row(2 * r, t)];

  float acc[NH][32], s[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = dp[e] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) acc[cc][e] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    const uint32_t sK = stage(i), sV = sK + T;
    if (a.tma) {
      mbar_wait(bars + 8 * (1 + (i & 1)), (i >> 1) & 1);
    } else {
      fence_async_smem();
      __syncthreads();
    }

    wg_fence();
    mma_abt<NH>(s, sQ, sK);
    mma_abt<NH>(dp, sO, sV);
    wg_commit();
    if (kt + 1 < kt1) fetch(i + 1, kt + 1);   // while the tensor cores work
    wg_wait();
    keep(s);
    keep(dp);

    const int k0 = kt * kN;
    probs<true>(s, L2, c,
                edge_tile(q0, k0, a.S, a.Sk, a.causal, a.window), q0, k0, a,
                t);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = s[e] * (dp[e] - D[(e >> 1) & 1]) * a.scale;
    uint32_t hi[4][4], lo[4][4];
    split(dp, hi, lo);
    wg_fence();
    mma_pb<NH>(acc, hi, lo, sK);
    wg_commit();
    wg_wait();
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) keep(acc[cc]);
    __syncthreads();
  }
  write_tile<NH>(acc, sQ, a.tdq, a.dq + b * a.sdq.b + hq * a.sdq.h, a.sdq.s,
                 b, hq, q0, a.S, a, t, 1);               // Q is free now
}

// ---------------------------------------------------------------------------
// backward, dK and dV (second launch): one block per (key tile, KV head,
// batch).  WG warpgroups split the H / KV query heads of the group (group w
// takes heads w, w + WG, ...), each with its own two stages of Q, dO, lse
// and D; each sums dK and dV of the key tile in registers over its heads
// and their query tiles, and the groups' sums are added through shared
// memory at the end, always in the same order.
// ---------------------------------------------------------------------------

template <int NH, int WG> constexpr size_t dkv_smem() {
  // K, V; per group two stages of Q and dO, then of lse and D; barriers
  return 1024 + (2 + 4 * WG) * NH * kRegion + WG * 2 * 512 + 64;
}

template <int NH, int WG>
__global__ void __launch_bounds__(kWG * WG, WG == 1 ? 2 : 1)
dkv_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t T = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const uint32_t sK = base, sV = base + T;
  const uint32_t bars = base + (2 + 4 * WG) * T + WG * 2 * 512;
  const int w = threadIdx.x / kWG, t = threadIdx.x - w * kWG;
  // the first key tiles (the most query tiles, causal) are launched first
  const int k0 = blockIdx.z * kN, hk = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KV;
  // group w's stage i & 1: Q and dO (2T bytes), lse and D (64 floats each)
  auto stage = [&](int i) { return base + 2 * T + (2 * w + (i & 1)) * 2 * T; };
  auto vecs = [&](int i) {   // offset from base
    return (2 + 4 * WG) * T + (2 * w + (i & 1)) * 512;
  };
  auto bar = [&](int i) { return bars + 8 * (1 + 2 * w + (i & 1)); };

  int qt0, qt1;
  query_range(k0, a.S, a.Sk, a.causal, a.window, &qt0, &qt1);
  const int nqt = qt1 - qt0;
  const int heads = w < G ? (G - w + WG - 1) / WG : 0;
  const int iters = heads * nqt;
  auto fetch = [&](int i) {
    const int hq = hk * G + w + WG * (i / nqt);
    const int q0 = (qt0 + i % nqt) * kM;
    const uint32_t sQ = stage(i);
    if (a.tma) {
      if (t == 0) {
        mbar_expect(bar(i), 2 * T);
        tma_tile<NH>(sQ, a.tq, bar(i), b, hq, q0);
        tma_tile<NH>(sQ + T, a.tdo, bar(i), b, hq, q0);
      }
    } else {
      copy_tile<NH, kWG>(sQ, a.q + b * a.sq.b + hq * a.sq.h, a.sq.s, q0, a.S,
                         a.d, t);
      copy_tile<NH, kWG>(sQ + T, a.dout + b * a.sdo.b + hq * a.sdo.h,
                         a.sdo.s, q0, a.S, a.d, t);
    }
    const long long row_vec = ((long long)b * a.H + hq) * a.S;
    if (t < 64)
      load_row_vec(base + vecs(i), a.lse + row_vec, q0, a.S, t);
    else
      load_row_vec(base + vecs(i) + 256, a.dsum + row_vec, q0, a.S, t - 64);
    cp_commit();
  };

  if (threadIdx.x == 0) {
    if (a.tma) {
      prefetch_map(a.tk);
      prefetch_map(a.tv);
      prefetch_map(a.tq);
      prefetch_map(a.tdo);
    }
    for (int i = 0; i < 1 + 2 * WG; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (a.tma) {
    if (threadIdx.x == 0) {
      mbar_expect(bars, 2 * T);
      tma_tile<NH>(sK, a.tk, bars, b, hk, k0);
      tma_tile<NH>(sV, a.tv, bars, b, hk, k0);
    }
  } else {
    copy_tile<NH, kWG * WG>(sK, a.k + b * a.sk.b + hk * a.sk.h, a.sk.s, k0,
                            a.Sk, a.d, threadIdx.x);
    copy_tile<NH, kWG * WG>(sV, a.v + b * a.sv.b + hk * a.sv.h, a.sv.s, k0,
                            a.Sk, a.d, threadIdx.x);
  }
  if (iters > 0) fetch(0);

  float dk[NH][32], dv[NH][32], s[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = dp[e] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) dk[cc][e] = dv[cc][e] = 0.f;
  }
  const float c = a.scale * kLog2e;

  for (int i = 0; i < iters; ++i) {
    cp_wait<0>();                      // this thread's lse and D of step i
    if (!a.tma) fence_async_smem();
    if (i == 0)
      __syncthreads();                 // K and V came from every group
    else
      bar_group(1 + w);
    if (a.tma) {
      if (i == 0) mbar_wait(bars, 0);
      mbar_wait(bar(i), (i >> 1) & 1);
    }
    const uint32_t sQ = stage(i), sO = sQ + T;
    const float* Lv = reinterpret_cast<const float*>(gbase + vecs(i));
    const float* Dv = Lv + 64;
    const int q0 = (qt0 + i % nqt) * kM;

    wg_fence();
    mma_abt<NH>(s, sK, sQ);            // S^T: keys x queries
    mma_abt<NH>(dp, sV, sO);           // dP^T
    wg_commit();
    if (i + 1 < iters) fetch(i + 1);   // while the tensor cores work
    wg_wait();
    keep(s);
    keep(dp);

    probs<false>(s, Lv, c,
                 edge_tile(q0, k0, a.S, a.Sk, a.causal, a.window), q0, k0,
                 a, t);
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    split(s, phi, plo);
    wg_fence();
    mma_pb<NH>(dv, phi, plo, sO);      // dV += P^T dO, while dS is formed
    wg_commit();
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = s[e] * (dp[e] - Dv[frag_col(e, t)]) * a.scale;
    split(dp, dhi, dlo);
    wg_fence();
    mma_pb<NH>(dk, dhi, dlo, sQ);      // dK += dS^T Q
    wg_commit();
    wg_wait();
    keep(phi);
    keep(plo);
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) {
      keep(dk[cc]);
      keep(dv[cc]);
    }
    bar_group(1 + w);                  // stage read by the group before refilled
  }

  if (WG > 1) {
    // groups 1.. hand their sums to group 0 through group 0's stages (idle
    // now), one after another, in a fixed order
    float* red = reinterpret_cast<float*>(gbase + 2 * T);
    for (int g = 1; g < WG; ++g) {
      __syncthreads();
      if (w == g) {
#pragma unroll
        for (int cc = 0; cc < NH; ++cc)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            red[((2 * cc) * 32 + e) * kWG + t] = dk[cc][e];
            red[((2 * cc + 1) * 32 + e) * kWG + t] = dv[cc][e];
          }
      }
      __syncthreads();
      if (w == 0) {
#pragma unroll
        for (int cc = 0; cc < NH; ++cc)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            dk[cc][e] += red[((2 * cc) * 32 + e) * kWG + t];
            dv[cc][e] += red[((2 * cc + 1) * 32 + e) * kWG + t];
          }
      }
    }
  }
  if (a.tma && iters == 0) mbar_wait(bars, 0);  // K, V landed; no query
  if (w == 0) {                         // K and V are free now
    if (WG == 1) bar_group(1);
    write_tile<NH>(dk, sK, a.tdk, a.dk + b * a.sdk.b + hk * a.sdk.h, a.sdk.s,
                   b, hk, k0, a.Sk, a, t, 1);
    write_tile<NH>(dv, sV, a.tdv, a.dv + b * a.sdv.b + hk * a.sdv.h, a.sdv.s,
                   b, hk, k0, a.Sk, a, t, 1);
  }
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

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links nothing beyond cudart.
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

// The tensor map of a (B, S, heads, d) view with element strides st: boxes
// of 64 rows x 64 columns, 128-byte swizzle, zeros past the ends.
bool make_map(TileMap* m, const void* ptr, int B, int S, int heads, int d,
              const Strides& st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  m->heads_inner = st.h <= st.s;
  const cuuint64_t dims[4] = {
      (cuuint64_t)d, (cuuint64_t)(m->heads_inner ? heads : S),
      (cuuint64_t)(m->heads_inner ? S : heads), (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(2 * (m->heads_inner ? st.h : st.s)),
      (cuuint64_t)(2 * (m->heads_inner ? st.s : st.h)),
      (cuuint64_t)(2 * st.b)};
  const cuuint32_t box[4] = {64, m->heads_inner ? 1u : 64u,
                             m->heads_inner ? 64u : 1u, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(&m->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const Args& a, bool* ready) {
  cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int NH>
cudaError_t run_fwd(const Args& a, int B, cudaStream_t s) {
  static bool ready = false;
  const dim3 grid(a.H, B, (a.S + kM - 1) / kM);
  return launch(fwd_kernel<NH>, grid, kWG, fwd_smem<NH>(), s, a, &ready);
}

template <int NH>
cudaError_t run_dq(const Args& a, int B, cudaStream_t s) {
  static bool ready = false;
  const dim3 grid(a.H, B, (a.S + kM - 1) / kM);
  return launch(dq_kernel<NH>, grid, kWG, dq_smem<NH>(), s, a, &ready);
}

template <int NH, int WG>
cudaError_t run_dkv(const Args& a, int B, cudaStream_t s) {
  static bool ready = false;
  const dim3 grid(a.KV, B, (a.Sk + kN - 1) / kN);
  return launch(dkv_kernel<NH, WG>, grid, kWG * WG, dkv_smem<NH, WG>(), s, a,
                &ready);
}

bool valid(int B, int H, int KV, int S, int Sk, int d) {
  return B >= 1 && B <= 65535 && H >= 1 && KV >= 1 && H % KV == 0 &&
         S >= 1 && Sk >= 1 && (S + kM - 1) / kM <= 65535 &&
         (Sk + kN - 1) / kN <= 65535 && d >= 1 && d <= kMaxHeadDim;
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace hop

// ===========================================================================
// float32 backward on Hopper: 3xTF32 products on the tensor cores
// ===========================================================================
//
// The float32 route's backward (the forward stays the CUDA-core kernel
// above).  The same two launches as the bf16 route, on the same strided
// views (any (B, S, H, d) or (B, H, S, d) view whose d has stride 1, query
// head h reading KV head h / (H / KV)): dQ first, which also writes D =
// rowsum(dO * O) for the second, dK/dV, which sums each KV head's query
// heads itself (two warpgroups split them where there are two or more and
// add their sums through shared memory in a fixed order).  No atomics;
// every result is the same from run to run.
//
// Products: every one of S = Q K^T, dP = dO V^T, dQ = dS K, dV = P^T dO and
// dK = dS^T Q runs on the tensor cores as three TF32 products.  Each float32
// operand x is split into hi = tf32(x) (rounded to nearest, ties away, as
// cvt.rna) and lo = x - hi (which the tensor core reads as TF32 rounded
// toward zero), and a product of x and y sums lo_x hi_y + hi_x lo_y + hi_x
// hi_y into a float32 accumulator: about 21 significant bits of each
// operand, where one TF32 product keeps 11 and would miss the float32
// tolerance (1e-4).  Logits, P, dS, lse and D stay float32.  Each warp
// splits the fragments it reads, in three instructions an element: on an
// H100 the split costs more than the extra products, and cvt.rna for hi
// and lo was slower (PERF.md).
//
// Why mma.sync (m16n8k8, a warp a 16-row slice) and not wgmma: wgmma takes
// TF32 from shared memory only K-major, and dQ = dS K, dK = dS^T Q and dV =
// P^T dO reduce over the rows of K, Q and dO, which TMA lands d-contiguous;
// each would need a transposed copy in shared memory.  mma.sync's
// fragments are loaded by each lane from plain row-major tiles, in either
// orientation, with no bank conflicts (rows padded by 4 words).  P and dS
// enter as A from the accumulators' registers: a thread holds columns 2t
// and 2t + 1 of each 8-column slice where A wants t and t + 4, so the
// contraction runs over the 8 keys (queries) of a slice in the order 0, 2,
// 4, 6, 1, 3, 5, 7, and the B fragment reads its rows in the same order.
//
// Tiles: a block is 4 warps owning 64 rows (16 a warp); it visits the
// other side 32 rows at a time.  Shared memory: two own tiles and two
// visited ones a stage, float32, row stride d + 4.  At d <= 64 two stages,
// so the next visited tiles land while these are multiplied: (64 + 64 +
// 2 x (32 + 32)) x 68 x 4 = 69,632 bytes at d = 64 (three blocks an SM;
// dK/dV with two warpgroups, each its own stages, 104,448: two); at d =
// 128 one, (64 + 64 + 32 + 32) x 132 x 4 = 101,376 bytes (two; dK/dV with
// two warpgroups 135,168: one).
// Tiles land by 16-byte cp.async where every row is 16-byte aligned, else
// element by element; rows past the sequences and columns past d are 0.
//
// Bound at lm-100m's shape (B = 16, S = 256, H = 8, KV = 4, d = 64,
// causal): 2.7 GFLOP of products, 0.040 ms at the 67 TFLOP/s float32 rate;
// as three TF32 products 8.1 GFLOP, 0.016 ms at 495 TFLOP/s, just above
// the 0.015 ms of bytes (50.5 MB at 3.35 TB/s, K/V unexpanded).
namespace tf32 {

constexpr int kOwn = 64;                  // rows a block owns
constexpr int kVis = 32;                  // rows of the other side a step visits
constexpr int kThreadsF = 128;            // 4 warps of 16 own rows

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dsum, *dq, *dk, *dv;
  hop::Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, KV, S, Sk, d;
  float scale;
  int causal, window;
  int vec;                              // 1: rows 16-byte aligned, d % 4 == 0
};

struct FragA {                          // a 16 x 8 A operand, hi and lo
  uint32_t hi[4], lo[4];
};
struct FragB {                          // an 8 x 8 B operand, hi and lo
  uint32_t hi[2], lo[2];
};

// hi = tf32(x), rounded to nearest with ties away from zero (the rounding
// of cvt.rna.tf32.f32, in two integer instructions where the conversion
// issued at a quarter of their rate), and lo = x - hi, exact in float32.
// lo goes to the tensor core as it is: it reads the top 19 bits of each
// operand (TF32 rounded toward zero), and the 13 it drops weigh 2^-21 of
// x at most.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_hi(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = A B (no accumulator in).
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
// d += A B in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}
// The same into t, which the first step (first) overwrites.  The long
// sums (dQ over keys, dK and dV over queries and heads) take a visited
// tile's 32 rows into such a t and add it to their total with a float32
// add: the tensor core's accumulation rounds toward zero, and over
// thousands of steps into one accumulator (768 at 12 heads on 2 KV heads
// and S = 1024) that bias reached 1e-4 relative in dV, past the float32
// tolerance, where adds that round to nearest stay unbiased.
__device__ __forceinline__ void mma3_into(float (&t)[4], const FragA& a,
                                          const FragB& b, bool first) {
  if (first)
    mma0(t, a.lo, b.hi);
  else
    mma(t, a.lo, b.hi);
  mma(t, a.hi, b.lo);
  mma(t, a.hi, b.hi);
}

// A = rows [r0, r0 + 16) x columns [c0, c0 + 8) of a tile (row stride LD):
// lane (g, t) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
template <int LD>
__device__ __forceinline__ FragA load_a(const float* s, int r0, int c0,
                                        int g, int t) {
  const float* p = s + (r0 + g) * LD + c0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * LD], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * LD + 4], f.hi[3], f.lo[3]);
  return f;
}
// B[k][n] = tile[n0 + n][c0 + k] (the tile's rows are B's columns, as K in
// Q K^T): lane (g, t) holds (t, g) and (t + 4, g).
template <int LD>
__device__ __forceinline__ FragB load_bt(const float* s, int n0, int c0,
                                         int g, int t) {
  const float* p = s + (n0 + g) * LD + c0 + t;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}
// B[k][n] = tile[r0 + k'][c0 + n] with k' the slice order 0, 2, 4, 6, 1, 3,
// 5, 7 (the tile's rows are the contraction, as K in dS K): lane (g, t)
// holds rows 2t and 2t + 1 of column g.
template <int LD>
__device__ __forceinline__ FragB load_bk(const float* s, int r0, int c0,
                                         int g, int t) {
  const float* p = s + (r0 + 2 * t) * LD + c0 + g;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[LD], f.hi[1], f.lo[1]);
  return f;
}
// An accumulator slice (16 x 8: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)) as the A operand of a product over its 8 columns, in the slice
// order load_bk reads.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hop::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Rows [row0, row0 + R) of a head's (rows, d) slice (row stride ld) into a
// float32 tile of row stride D + 4, by NT threads (tid < NT); rows past
// `rows` and columns past d 0.
template <int R, int D, int NT = kThreadsF>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int row0, int rows,
                                          int d, int vec, int tid) {
  constexpr int LD = D + 4, C4 = D / 4;
  for (int idx = tid; idx < R * C4; idx += NT) {
    const int r = idx / C4, c = 4 * (idx - (idx / C4) * C4);
    const long long gr = row0 + r;
    float* to = dst + r * LD + c;
    if (vec) {
      const bool in = gr < rows && c < d;
      cp_async16(to, in ? src + gr * ld + c : src, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        to[e] = gr < rows && c + e < d ? src[gr * ld + c + e] : 0.f;
    }
  }
}

// Tiles of `vis` rows on the key side that query rows [q0, q0 + own) visit.
__device__ __forceinline__ void keys_of(int q0, int own, int vis, int S,
                                        int Sk, int causal, int window,
                                        int* begin, int* end) {
  const int nk = (Sk + vis - 1) / vis;
  int b = 0, e = nk;
  if (causal) e = min(nk, (min(q0 + own, S) - 1) / vis + 1);
  if (window > 0) b = max(0, q0 - window + 1) / vis;
  *begin = b;
  *end = max(b, e);
}
// Tiles of `vis` rows on the query side that key rows [k0, k0 + own) visit.
__device__ __forceinline__ void queries_of(int k0, int own, int vis, int S,
                                           int Sk, int causal, int window,
                                           int* begin, int* end) {
  const int nq = (S + vis - 1) / vis;
  int b = 0, e = nq;
  if (causal) b = k0 / vis;
  if (window > 0) e = min(nq, (min(k0 + own, Sk) - 1 + window - 1) / vis + 1);
  *begin = b;
  *end = max(b, e);
}

// A pair of tiles (qr query rows at q0, kr key rows at k0) needs the mask
// only on the band's edge or past a sequence end.
__device__ __forceinline__ bool edge(int q0, int qr, int k0, int kr,
                                     const Args& a) {
  return q0 + qr > a.S || k0 + kr > a.Sk || (a.causal && k0 + kr - 1 > q0) ||
         (a.window > 0 && k0 <= q0 + qr - 1 - a.window);
}

// P = 2^(s c - L2) of one logit, L2 = lse log2 e; on an edge tile a pair
// outside the band gets the logit -1e30 and one past a sequence end 0.
__device__ __forceinline__ float prob(float s, float c, float L2, bool edge,
                                      int qp, int kp, const Args& a) {
  float x = fmaf(s, c, -L2);
  if (edge) {
    const int delta = qp - kp;
    const bool out = (a.causal && delta < 0) ||
                     (a.window > 0 && delta > a.window - 1);
    x = out ? kMasked * hop::kLog2e - L2 : x;
    x = qp < a.S && kp < a.Sk ? x : -INFINITY;
  }
  return hop::exp2_approx(x);
}

// ---------------------------------------------------------------------------
// dQ (first launch): one block per (64 query rows, head, batch); writes D
// ---------------------------------------------------------------------------

// Stages of the visited tiles: two at d <= 64, so tile i + 1 lands while
// tile i is multiplied; one at d = 128, where two would leave one block an
// SM.
template <int D> __host__ __device__ constexpr int stages() {
  return D <= 64 ? 2 : 1;
}

template <int D> constexpr size_t dq_smem() {
  return sizeof(float) *
         ((2 * kOwn + 2 * stages<D>() * kVis) * (D + 4) + kOwn);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
dq_kernel(const __grid_constant__ Args a) {
  constexpr int LD = D + 4, KS = D / 8, NS = stages<D>();
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // kOwn x LD
  float* sO = sQ + kOwn * LD;             // dO
  float* sKV = sO + kOwn * LD;            // per stage K, V: kVis x LD each
  float* sD = sKV + 2 * NS * kVis * LD;   // D of the block's rows
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2,
            tg = tid & 3;
  // the last query tiles (the most key tiles, causal) are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  const long long row_vec = ((long long)b * a.H + hq) * a.S;
  const float* kb = a.k + b * a.sk.b + hk * a.sk.h;
  const float* vb = a.v + b * a.sv.b + hk * a.sv.h;
  auto fetch = [&](int kt, int st) {      // key tile kt into stage st
    float* k = sKV + 2 * st * kVis * LD;
    load_tile<kVis, D>(k, kb, a.sk.s, kt * kVis, a.Sk, a.d, a.vec, tid);
    load_tile<kVis, D>(k + kVis * LD, vb, a.sv.s, kt * kVis, a.Sk, a.d,
                       a.vec, tid);
    hop::cp_commit();
  };

  // Q, dO, and O in stage 0's K and V (64 rows), for D
  load_tile<kOwn, D>(sQ, a.q + b * a.sq.b + hq * a.sq.h, a.sq.s, q0, a.S,
                     a.d, a.vec, tid);
  load_tile<kOwn, D>(sO, a.dout + b * a.sdo.b + hq * a.sdo.h, a.sdo.s, q0,
                     a.S, a.d, a.vec, tid);
  load_tile<kOwn, D>(sKV, a.o + b * a.so.b + hq * a.so.h, a.so.s, q0, a.S,
                     a.d, a.vec, tid);
  hop::cp_commit();
  hop::cp_wait<0>();
  __syncthreads();
  {                                       // D = rowsum(dO * O), a row per
    const int r = tid >> 1, half = tid & 1;   // two threads
    const float* x = sO + r * LD + half * (D / 2);
    const float* y = sKV + r * LD + half * (D / 2);
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) acc = fmaf(x[c], y[c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sD[r] = acc;
      if (q0 + r < a.S) a.dsum[row_vec + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int r0 = 16 * w + g;              // the thread's rows r0, r0 + 8
  float L2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    L2[r] = row < a.S ? a.lse[row_vec + row] * hop::kLog2e : 0.f;
    Dr[r] = sD[r0 + 8 * r];
  }
  const float c = a.scale * hop::kLog2e;

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int kt0, kt1;
  keys_of(q0, kOwn, kVis, a.S, a.Sk, a.causal, a.window, &kt0, &kt1);
  if (kt0 < kt1) fetch(kt0, 0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kVis, st = NS == 2 ? (kt - kt0) & 1 : 0;
    hop::cp_wait<0>();
    __syncthreads();                      // tile kt landed; the last one read
    if (NS == 2 && kt + 1 < kt1) fetch(kt + 1, st ^ 1);
    const float* sK = sKV + 2 * st * kVis * LD;
    const float* sV = sK + kVis * LD;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA qa = load_a<LD>(sQ, 16 * w, 8 * kk, g, tg);
      const FragA oa = load_a<LD>(sO, 16 * w, 8 * kk, g, tg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma3(s[j], qa, load_bt<LD>(sK, 8 * j, 8 * kk, g, tg));
        mma3(dp[j], oa, load_bt<LD>(sV, 8 * j, 8 * kk, g, tg));
      }
    }
    // dS = P (dP - D) scale, into s
    const bool e_ = edge(q0, kOwn, k0, kVis, a);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = prob(s[j][e], c, L2[r], e_, q0 + r0 + 8 * r,
                             k0 + 8 * j + 2 * tg + (e & 1), a);
        s[j][e] = p * (dp[j][e] - Dr[r]) * a.scale;
      }
    // dQ += dS K, the tile's sum added to the total
    FragA da[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) da[j] = acc_as_a(s[j]);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3_into(t, da[j], load_bk<LD>(sK, 8 * j, 8 * n, g, tg), j == 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
    }
    if (NS == 1 && kt + 1 < kt1) {
      __syncthreads();                    // every warp is done with tile kt
      fetch(kt + 1, 0);
    }
  }

  float* dq = a.dq + b * a.sdq.b + hq * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = q0 + r0 + 8 * r;
    if (row >= a.S) continue;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int col = 8 * n + 2 * tg;
      if (col < a.d) dq[row * a.sdq.s + col] = acc[n][2 * r];
      if (col + 1 < a.d) dq[row * a.sdq.s + col + 1] = acc[n][2 * r + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV (second launch): one block per (64 key rows, KV head, batch),
// visiting 32 query rows at a time of each of the KV head's query heads
// ---------------------------------------------------------------------------

// WG warpgroups split a KV head's query heads (group w takes heads w, w +
// WG, ...), each with its own stages of visited tiles: at 2 on 1 KV head
// the heaviest key tile's visits halve.  Their sums meet at the end
// through shared memory, in a fixed order.
template <int D, int WG> constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * kOwn + WG * 2 * stages<D>() * kVis) * (D + 4) +
                          WG * 2 * stages<D>() * kVis);
}

template <int D, int WG>
__global__ void __launch_bounds__(kThreadsF * WG)
dkv_kernel(const __grid_constant__ Args a) {
  constexpr int LD = D + 4, KS = D / 8, NS = stages<D>();
  constexpr int kStage = 2 * kVis * LD;   // a stage: Q, dO
  // the groups' totals at the end, in the visited tiles' place
  static_assert(2 * KS * 4 * kThreadsF <= WG * NS * kStage || WG == 1,
                "the visited tiles hold a group's dK and dV");
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // kOwn x LD
  float* sV = sK + kOwn * LD;
  const int wg = threadIdx.x / kThreadsF, tid = threadIdx.x % kThreadsF;
  float* sQO = sV + kOwn * LD + wg * NS * kStage;   // this group's stages
  float* sLD = smem + 2 * kOwn * LD + WG * NS * kStage +
               wg * NS * 2 * kVis;        // per stage lse, D of the rows
  const int w = tid >> 5, g = (tid & 31) >> 2, tg = tid & 3;
  // the first key tiles (the most query tiles, causal) are launched first
  const int k0 = blockIdx.z * kOwn, hk = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KV;

  int qt0, qt1;
  queries_of(k0, kOwn, kVis, a.S, a.Sk, a.causal, a.window, &qt0, &qt1);
  const int nqt = qt1 - qt0;
  const int heads = wg < G ? (G - wg + WG - 1) / WG : 0;
  const int iters = heads * nqt;
  auto fetch = [&](int i, int st) {       // visit i (head, query tile)
    const int hq = hk * G + wg + WG * (i / nqt), q0 = (qt0 + i % nqt) * kVis;
    const long long row_vec = ((long long)b * a.H + hq) * a.S;
    float* q = sQO + st * kStage;
    load_tile<kVis, D>(q, a.q + b * a.sq.b + hq * a.sq.h, a.sq.s, q0, a.S,
                       a.d, a.vec, tid);
    load_tile<kVis, D>(q + kVis * LD, a.dout + b * a.sdo.b + hq * a.sdo.h,
                       a.sdo.s, q0, a.S, a.d, a.vec, tid);
    float* v = sLD + 2 * st * kVis;
    if (tid < kVis)
      v[tid] = q0 + tid < a.S ? a.lse[row_vec + q0 + tid] * hop::kLog2e
                              : 0.f;
    else if (tid < 2 * kVis)
      v[tid] = q0 + tid - kVis < a.S ? a.dsum[row_vec + q0 + tid - kVis]
                                     : 0.f;
    hop::cp_commit();
  };
  // the warpgroup's own barrier (all of the block's threads at once: 0)
  auto sync_group = [&]() {
    if (WG == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kThreadsF)
                   : "memory");
  };

  load_tile<kOwn, D, kThreadsF * WG>(sK, a.k + b * a.sk.b + hk * a.sk.h,
                                     a.sk.s, k0, a.Sk, a.d, a.vec,
                                     threadIdx.x);
  load_tile<kOwn, D, kThreadsF * WG>(sV, a.v + b * a.sv.b + hk * a.sv.h,
                                     a.sv.s, k0, a.Sk, a.d, a.vec,
                                     threadIdx.x);
  if (iters > 0) fetch(0, 0);
  else hop::cp_commit();

  float gk[KS][4], gv[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;
  const float c = a.scale * hop::kLog2e;
  const int r0 = 16 * w + g;              // the thread's key rows r0, r0 + 8

  for (int i = 0; i < iters; ++i) {
    const int q0 = (qt0 + i % nqt) * kVis, st = NS == 2 ? i & 1 : 0;
    hop::cp_wait<0>();
    if (i == 0)
      __syncthreads();                    // K and V came from every group
    else
      sync_group();                       // visit i landed; the last one read
    if (NS == 2 && i + 1 < iters) fetch(i + 1, st ^ 1);
    const float* sQ = sQO + st * kStage;
    const float* sO = sQ + kVis * LD;
    const float* sL = sLD + 2 * st * kVis;
    const float* sD = sL + kVis;

    // S^T and dP^T: the warp's 16 keys against the 32 queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA ka = load_a<LD>(sK, 16 * w, 8 * kk, g, tg);
      const FragA va = load_a<LD>(sV, 16 * w, 8 * kk, g, tg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma3(s[j], ka, load_bt<LD>(sQ, 8 * j, 8 * kk, g, tg));
        mma3(dp[j], va, load_bt<LD>(sO, 8 * j, 8 * kk, g, tg));
      }
    }
    // P^T into s, dS^T into dp
    const bool e_ = edge(q0, kVis, k0, kOwn, a);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tg + (e & 1);
        const float p = prob(s[j][e], c, sL[col], e_, q0 + col,
                             k0 + r0 + 8 * (e >> 1), a);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sD[col]) * a.scale;
      }
    // dV += P^T dO,  dK += dS^T Q, the tile's sums added to the totals
    FragA pa[4], da[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j] = acc_as_a(s[j]);
      da[j] = acc_as_a(dp[j]);
    }
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      float tv[4], tk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma3_into(tv, pa[j], load_bk<LD>(sO, 8 * j, 8 * n, g, tg), j == 0);
        mma3_into(tk, da[j], load_bk<LD>(sQ, 8 * j, 8 * n, g, tg), j == 0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[n][e] += tv[e];
        gk[n][e] += tk[e];
      }
    }
    if (NS == 1 && i + 1 < iters) {
      sync_group();                       // every warp is done with visit i
      fetch(i + 1, 0);
    }
  }
  hop::cp_wait<0>();
  if (iters == 0) __syncthreads();        // K and V landed; no query

  if (WG > 1) {
    // groups 1.. hand their sums to group 0, one after another, through
    // the visited tiles (free now)
    float* red = smem + 2 * kOwn * LD;
    for (int from = 1; from < WG; ++from) {
      __syncthreads();
      if (wg == from) {
#pragma unroll
        for (int n = 0; n < KS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            red[((2 * n) * 4 + e) * kThreadsF + tid] = gk[n][e];
            red[((2 * n + 1) * 4 + e) * kThreadsF + tid] = gv[n][e];
          }
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int n = 0; n < KS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gk[n][e] += red[((2 * n) * 4 + e) * kThreadsF + tid];
            gv[n][e] += red[((2 * n + 1) * 4 + e) * kThreadsF + tid];
          }
      }
    }
  }
  if (wg != 0) return;

  float* dk = a.dk + b * a.sdk.b + hk * a.sdk.h;
  float* dv = a.dv + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = k0 + r0 + 8 * r;
    if (row >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * tg + e;
        if (col < a.d) {
          dk[row * a.sdk.s + col] = gk[n][2 * r + e];
          dv[row * a.sdv.s + col] = gv[n][2 * r + e];
        }
      }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const Args& a, bool* ready) {
  cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D, int WG>
cudaError_t run_dkv(const Args& a, int B, cudaStream_t s) {
  static bool ready = false;
  return launch(dkv_kernel<D, WG>, dim3(a.KV, B, (a.Sk + kOwn - 1) / kOwn),
                kThreadsF * WG, dkv_smem<D, WG>(), s, a, &ready);
}

template <int D>
cudaError_t run(const Args& a, int B, int part, cudaStream_t s) {
  if (part == 0) {
    static bool ready = false;
    return launch(dq_kernel<D>, dim3(a.H, B, (a.S + kOwn - 1) / kOwn),
                  kThreadsF, dq_smem<D>(), s, a, &ready);
  }
  // two warpgroups split a KV head's query heads where it has two or more
  return a.H / a.KV >= 2 ? run_dkv<D, 2>(a, B, s) : run_dkv<D, 1>(a, B, s);
}

}  // namespace tf32

}  // namespace

// ===========================================================================
// Forward-mode tangents of the forward and the backward (no TPU
// counterpart: the JAX package has no forward-mode rule for its kernels)
// ===========================================================================
//
// The exact meta-gradient's Hessian-vector products are forward-over-
// reverse (torch.func.jvp of torch.func.grad), so both flash Functions of
// ../ops.py need a forward-mode rule, and these two kernels are it.
//
// T1, the tangent of the forward: given q, k, v, the forward's lse and the
// tangents q', k', v', with s'_ij = scale (q'_i . k_j + q_i . k'_j) on the
// allowed pairs,
//   lse'_i = sum_j P_ij s'_ij,   o'_i = sum_j P_ij (s'_ij v_j + v'_j) - lse'_i o_i
// with P = exp(S - lse) recomputed from the saved lse and o = P V
// accumulated beside o' in float32.  One pass over the key tiles.
// T2, the tangent of the FlashAttention-2 backward (dQ, dK, dV of q, k, v,
// o, lse, dO), from the tangents of all six:
//   P' = P (S' - lse'),  D = rowsum(dO o),  D' = rowsum(dO' o + dO o'),
//   dP = dO V^T,  dP' = dO' V^T + dO V'^T,
//   dS = P (dP - D),  dS' = P' (dP - D) + P (dP' - D'),
//   dQ' = scale (dS' K + dS K'),  dK' = scale (dS'^T Q + dS^T Q'),
//   dV' = P'^T dO + P^T dO'.
// Two launches, as the backward: part 0 writes dQ' and D, D' (a (B, H, S)
// float32 workspace each), part 1 (after it) dK' and dV', summed over each
// KV head's query heads, so nothing is summed with atomics.
//
// Simple CUDA-core kernels that are right first (making them fast with
// wgmma and TMA is later work): float32 FMA, 256 threads, 32-row tiles
// on both sides (a warp owns 4 rows of its block's tile, a lane one row of
// the visited tile), every operand staged as float32 in shared memory and
// read through its view's (b, s, h) strides, so the model layout (B, S, H,
// d) with K/V heads unexpanded and the expanded (B, H, S, d) are both read
// in place; bf16 or float32 in, float32 sums, results in the inputs'
// dtype.  Masks as the forward: a pair the band excludes gets the logit
// -1e30 and the tangent logit 0.
namespace jvpk {

constexpr int kT = 32;                    // rows of a tile, both sides
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kT / kWarps;        // own rows a warp holds
constexpr int kMaxViews = 13;

// (b, s, h) element strides of every view a launch reads or writes.
struct Views {
  long long s[kMaxViews][3];
};

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

// The (rows, d) slice of head h of batch b in view `i`.
template <typename T>
__device__ __forceinline__ T* head(T* base, const Views& st, int i, int b,
                                   int h) {
  return base + b * st.s[i][0] + h * st.s[i][2];
}

// Stage rows [row0, row0 + kT) of a head's slice (row stride rs) into a
// float32 tile with row stride ld and D columns; rows past `rows` and
// columns past d are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src,
                                      long long rs, int row0, int rows,
                                      int d) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows && c < d) x = f32(src[gr * rs + c]);
    dst[r * ld + c] = x;
  }
}

// Tiles of kT rows on the other side that a tile starting at t0 must
// visit: key tiles of a query tile (keys = 1) or query tiles of a key tile.
__device__ __forceinline__ void visit(int t0, int S, int Sk, int causal,
                                      int window, bool keys, int* begin,
                                      int* end) {
  if (keys) {
    const int nk = (Sk + kT - 1) / kT;
    int b = 0, e = nk;
    if (causal) e = min(nk, (min(t0 + kT, S) - 1) / kT + 1);
    if (window > 0) b = max(0, t0 - window + 1) / kT;
    *begin = b;
    *end = max(b, e);
  } else {
    const int nq = (S + kT - 1) / kT;
    int b = 0, e = nq;
    if (causal) b = t0 / kT;
    if (window > 0) e = min(nq, (min(t0 + kT, Sk) - 1 + window - 1) / kT + 1);
    *begin = b;
    *end = max(b, e);
  }
}

// logit and tangent logit of an in-range pair, masked as the forward.
__device__ __forceinline__ void logits(float s, float sd, int qp, int kp,
                                       int causal, int window, float scale,
                                       float* x, float* xd) {
  const bool ok = allowed(qp, kp, causal, window);
  *x = ok ? s * scale : kMasked;
  *xd = ok ? sd * scale : 0.f;
}

enum { Q = 0, K, V, O, DO, TQ, TK, TV, TO, TDO, TDQ, TDK, TDV };

// T1.  Views: Q, K, V, TQ, TK, TV and TO (o' out).  One block per (b, h,
// 32-row query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_tangent_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lse,
                   const T* __restrict__ tq, const T* __restrict__ tk,
                   const T* __restrict__ tv, T* __restrict__ to,
                   float* __restrict__ tlse, Views st, int H, int KV, int S,
                   int Sk, int d, float scale, int causal, int window) {
  constexpr int LD = D + 4, NC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                        // kT x LD
  float* sTQ = sQ + kT * LD;
  float* sK = sTQ + kT * LD;
  float* sTK = sK + kT * LD;
  float* sV = sTK + kT * LD;               // kT x D
  float* sTV = sV + kT * D;
  float* sP = sTV + kT * D;                // own rows x visited keys
  float* sPS = sP + kT * kT;               // P * s'

  const int nq = (S + kT - 1) / kT;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * kT;
  const int b = bh / H, h = bh - (bh / H) * H, hk = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;

  stage<T, D>(sQ, LD, head(q, st, Q, b, h), st.s[Q][1], q0, S, d);
  stage<T, D>(sTQ, LD, head(tq, st, TQ, b, h), st.s[TQ][1], q0, S, d);
  const T* kb = head(k, st, K, b, hk);
  const T* tkb = head(tk, st, TK, b, hk);
  const T* vb = head(v, st, V, b, hk);
  const T* tvb = head(tv, st, TV, b, hk);

  float lrow[kRows], dl[kRows], ao[kRows][NC], at[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    lrow[r] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
    dl[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) ao[r][c] = at[r][c] = 0.f;
  }

  int kt_begin, kt_end;
  visit(q0, S, Sk, causal, window, true, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    stage<T, D>(sK, LD, kb, st.s[K][1], k0, Sk, d);
    stage<T, D>(sTK, LD, tkb, st.s[TK][1], k0, Sk, d);
    stage<T, D>(sV, D, vb, st.s[V][1], k0, Sk, d);
    stage<T, D>(sTV, D, tvb, st.s[TV][1], k0, Sk, d);
    __syncthreads();

    float s[kRows], sd[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = sd[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sK[lane * LD + c]);
      const float4 tka =
          *reinterpret_cast<const float4*>(&sTK[lane * LD + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sQ[(r0 + r) * LD + c]);
        const float4 tqv =
            *reinterpret_cast<const float4*>(&sTQ[(r0 + r) * LD + c]);
        s[r] = dot4(qv, ka, s[r]);
        sd[r] = dot4(tqv, ka, dot4(qv, tka, sd[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r, kp = k0 + lane;
      float p = 0.f, ps = 0.f;
      if (qp < S && kp < Sk) {
        float x, xd;
        logits(s[r], sd[r], qp, kp, causal, window, scale, &x, &xd);
        p = expf(x - lrow[r]);
        ps = p * xd;
      }
      sP[(r0 + r) * kT + lane] = p;
      sPS[(r0 + r) * kT + lane] = ps;
      dl[r] += warp_sum(ps);
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float vv[NC], tvv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        vv[c] = sV[j * D + lane + 32 * c];
        tvv[c] = sTV[j * D + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sP[(r0 + r) * kT + j];
        const float ps = sPS[(r0 + r) * kT + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ao[r][c] = fmaf(p, vv[c], ao[r][c]);
          at[r][c] = fmaf(ps, vv[c], fmaf(p, tvv[c], at[r][c]));
        }
      }
    }
  }

  T* tob = head(to, st, TO, b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d)
        tob[qp * st.s[TO][1] + col] = cast<T>(at[r][c] - dl[r] * ao[r][c]);
    }
    if (lane == 0) tlse[(size_t)bh * S + qp] = dl[r];
  }
}

// Per (own row, visited row) pair of T2: s, s', dP and dP' from the staged
// tiles of one side (a: the row a warp owns) and the other (lane's row).
struct Pair {
  float s, sd, dp, dpd;
};

// T2 part 0: dQ', and D, D' into the workspaces.  Views: all but TDK and
// TDV.  One block per (b, h, 32-row query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_tangent_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const T* __restrict__ tq, const T* __restrict__ tk,
                      const T* __restrict__ tv, const T* __restrict__ to,
                      const T* __restrict__ tdout,
                      const float* __restrict__ tlse,
                      float* __restrict__ dsum, float* __restrict__ tdsum,
                      T* __restrict__ tdq, Views st, int H, int KV, int S,
                      int Sk, int d, float scale, int causal, int window) {
  constexpr int LD = D + 4, NC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                        // own: q, q', dO, dO'
  float* sTQ = sQ + kT * LD;
  float* sO = sTQ + kT * LD;
  float* sTO = sO + kT * LD;
  float* sK = sTO + kT * LD;               // visited: k, k', v, v'
  float* sTK = sK + kT * LD;
  float* sV = sTK + kT * LD;
  float* sTV = sV + kT * LD;
  float* sS = sTV + kT * LD;               // dS, own x visited
  float* sSD = sS + kT * kT;               // dS'

  const int nq = (S + kT - 1) / kT;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * kT;
  const int b = bh / H, h = bh - (bh / H) * H, hk = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;

  stage<T, D>(sQ, LD, head(q, st, Q, b, h), st.s[Q][1], q0, S, d);
  stage<T, D>(sTQ, LD, head(tq, st, TQ, b, h), st.s[TQ][1], q0, S, d);
  stage<T, D>(sO, LD, head(dout, st, DO, b, h), st.s[DO][1], q0, S, d);
  stage<T, D>(sTO, LD, head(tdout, st, TDO, b, h), st.s[TDO][1], q0, S, d);
  const T* ob = head(o, st, O, b, h);
  const T* tob = head(to, st, TO, b, h);
  __syncthreads();

  // D = rowsum(dO o), D' = rowsum(dO' o + dO o') of this warp's rows
  float lrow[kRows], tl[kRows], dr[kRows], tdr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    float a = 0.f, ad = 0.f;
    if (qp < S) {
      for (int c = lane; c < d; c += 32) {
        const float ov = f32(ob[qp * st.s[O][1] + c]);
        const float tov = f32(tob[qp * st.s[TO][1] + c]);
        const float g = sO[(r0 + r) * LD + c];
        const float tg = sTO[(r0 + r) * LD + c];
        a = fmaf(g, ov, a);
        ad = fmaf(tg, ov, fmaf(g, tov, ad));
      }
    }
    dr[r] = warp_sum(a);
    tdr[r] = warp_sum(ad);
    lrow[r] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
    tl[r] = qp < S ? tlse[(size_t)bh * S + qp] : 0.f;
    if (lane == 0 && qp < S) {
      dsum[(size_t)bh * S + qp] = dr[r];
      tdsum[(size_t)bh * S + qp] = tdr[r];
    }
  }

  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const T* kb = head(k, st, K, b, hk);
  const T* tkb = head(tk, st, TK, b, hk);
  const T* vb = head(v, st, V, b, hk);
  const T* tvb = head(tv, st, TV, b, hk);
  int kt_begin, kt_end;
  visit(q0, S, Sk, causal, window, true, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    stage<T, D>(sK, LD, kb, st.s[K][1], k0, Sk, d);
    stage<T, D>(sTK, LD, tkb, st.s[TK][1], k0, Sk, d);
    stage<T, D>(sV, LD, vb, st.s[V][1], k0, Sk, d);
    stage<T, D>(sTV, LD, tvb, st.s[TV][1], k0, Sk, d);
    __syncthreads();

    Pair pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) pr[r] = Pair{0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sK[lane * LD + c]);
      const float4 tka =
          *reinterpret_cast<const float4*>(&sTK[lane * LD + c]);
      const float4 va = *reinterpret_cast<const float4*>(&sV[lane * LD + c]);
      const float4 tva =
          *reinterpret_cast<const float4*>(&sTV[lane * LD + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = (r0 + r) * LD + c;
        const float4 qv = *reinterpret_cast<const float4*>(&sQ[row]);
        const float4 tqv = *reinterpret_cast<const float4*>(&sTQ[row]);
        const float4 gv = *reinterpret_cast<const float4*>(&sO[row]);
        const float4 tgv = *reinterpret_cast<const float4*>(&sTO[row]);
        pr[r].s = dot4(qv, ka, pr[r].s);
        pr[r].sd = dot4(tqv, ka, dot4(qv, tka, pr[r].sd));
        pr[r].dp = dot4(gv, va, pr[r].dp);
        pr[r].dpd = dot4(tgv, va, dot4(gv, tva, pr[r].dpd));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r, kp = k0 + lane;
      float ds = 0.f, dsd = 0.f;
      if (qp < S && kp < Sk) {
        float x, xd;
        logits(pr[r].s, pr[r].sd, qp, kp, causal, window, scale, &x, &xd);
        const float p = expf(x - lrow[r]);
        const float pd = p * (xd - tl[r]);
        ds = p * (pr[r].dp - dr[r]);
        dsd = pd * (pr[r].dp - dr[r]) + p * (pr[r].dpd - tdr[r]);
      }
      sS[(r0 + r) * kT + lane] = ds;
      sSD[(r0 + r) * kT + lane] = dsd;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kT; ++j) {
      float kv[NC], tkv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        kv[c] = sK[j * LD + lane + 32 * c];
        tkv[c] = sTK[j * LD + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float g = sS[(r0 + r) * kT + j];
        const float gd = sSD[(r0 + r) * kT + j];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = fmaf(gd, kv[c], fmaf(g, tkv[c], acc[r][c]));
      }
    }
  }

  T* out = head(tdq, st, TDQ, b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) out[qp * st.s[TDQ][1] + col] = cast<T>(scale * acc[r][c]);
    }
  }
}

// T2 part 1: dK' and dV' over each KV head's query heads.  Reads D and D'
// from part 0.  One block per (b, KV head, 32-row key tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_tangent_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const T* __restrict__ tq, const T* __restrict__ tk,
                       const T* __restrict__ tv,
                       const T* __restrict__ tdout,
                       const float* __restrict__ tlse,
                       const float* __restrict__ dsum,
                       const float* __restrict__ tdsum,
                       T* __restrict__ tdk, T* __restrict__ tdv, Views st,
                       int H, int KV, int S, int Sk, int d, float scale,
                       int causal, int window) {
  constexpr int LD = D + 4, NC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                        // own: k, k', v, v'
  float* sTK = sK + kT * LD;
  float* sV = sTK + kT * LD;
  float* sTV = sV + kT * LD;
  float* sQ = sTV + kT * LD;               // visited: q, q', dO, dO'
  float* sTQ = sQ + kT * LD;
  float* sO = sTQ + kT * LD;
  float* sTO = sO + kT * LD;
  float* sP = sTO + kT * LD;               // own keys x visited queries
  float* sPD = sP + kT * kT;
  float* sS = sPD + kT * kT;
  float* sSD = sS + kT * kT;
  float* sRow = sSD + kT * kT;             // lse, lse', D, D' of the tile

  const int nk = (Sk + kT - 1) / kT;
  const int bk = blockIdx.x / nk;
  const int k0 = (blockIdx.x - bk * nk) * kT;
  const int b = bk / KV, hk = bk - (bk / KV) * KV, grp = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;

  stage<T, D>(sK, LD, head(k, st, K, b, hk), st.s[K][1], k0, Sk, d);
  stage<T, D>(sTK, LD, head(tk, st, TK, b, hk), st.s[TK][1], k0, Sk, d);
  stage<T, D>(sV, LD, head(v, st, V, b, hk), st.s[V][1], k0, Sk, d);
  stage<T, D>(sTV, LD, head(tv, st, TV, b, hk), st.s[TV][1], k0, Sk, d);

  float gk[kRows][NC], gv[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[r][c] = gv[r][c] = 0.f;

  int qt_begin, qt_end;
  visit(k0, S, Sk, causal, window, false, &qt_begin, &qt_end);
  for (int h = hk * grp; h < (hk + 1) * grp; ++h) {
    const size_t rows = ((size_t)b * H + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();
      stage<T, D>(sQ, LD, head(q, st, Q, b, h), st.s[Q][1], q0, S, d);
      stage<T, D>(sTQ, LD, head(tq, st, TQ, b, h), st.s[TQ][1], q0, S, d);
      stage<T, D>(sO, LD, head(dout, st, DO, b, h), st.s[DO][1], q0, S, d);
      stage<T, D>(sTO, LD, head(tdout, st, TDO, b, h), st.s[TDO][1], q0, S,
                  d);
      if (threadIdx.x < kT) {
        const int qp = q0 + threadIdx.x;
        const bool in = qp < S;
        sRow[threadIdx.x] = in ? lse[rows + qp] : 0.f;
        sRow[kT + threadIdx.x] = in ? tlse[rows + qp] : 0.f;
        sRow[2 * kT + threadIdx.x] = in ? dsum[rows + qp] : 0.f;
        sRow[3 * kT + threadIdx.x] = in ? tdsum[rows + qp] : 0.f;
      }
      __syncthreads();

      Pair pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pr[r] = Pair{0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(&sQ[lane * LD + c]);
        const float4 tqa =
            *reinterpret_cast<const float4*>(&sTQ[lane * LD + c]);
        const float4 ga = *reinterpret_cast<const float4*>(&sO[lane * LD + c]);
        const float4 tga =
            *reinterpret_cast<const float4*>(&sTO[lane * LD + c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = (r0 + r) * LD + c;
          const float4 kv = *reinterpret_cast<const float4*>(&sK[row]);
          const float4 tkv = *reinterpret_cast<const float4*>(&sTK[row]);
          const float4 vv = *reinterpret_cast<const float4*>(&sV[row]);
          const float4 tvv = *reinterpret_cast<const float4*>(&sTV[row]);
          pr[r].s = dot4(qa, kv, pr[r].s);
          pr[r].sd = dot4(tqa, kv, dot4(qa, tkv, pr[r].sd));
          pr[r].dp = dot4(ga, vv, pr[r].dp);
          pr[r].dpd = dot4(tga, vv, dot4(ga, tvv, pr[r].dpd));
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kp = k0 + r0 + r, qp = q0 + lane;
        float p = 0.f, pd = 0.f, ds = 0.f, dsd = 0.f;
        if (qp < S && kp < Sk) {
          float x, xd;
          logits(pr[r].s, pr[r].sd, qp, kp, causal, window, scale, &x, &xd);
          const float dr = sRow[2 * kT + lane], tdr = sRow[3 * kT + lane];
          p = expf(x - sRow[lane]);
          pd = p * (xd - sRow[kT + lane]);
          ds = p * (pr[r].dp - dr);
          dsd = pd * (pr[r].dp - dr) + p * (pr[r].dpd - tdr);
        }
        const int at = (r0 + r) * kT + lane;
        sP[at] = p;
        sPD[at] = pd;
        sS[at] = ds;
        sSD[at] = dsd;
      }
      __syncwarp();

#pragma unroll 2
      for (int i = 0; i < kT; ++i) {
        float qv[NC], tqv[NC], gvv[NC], tgv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int at = i * LD + lane + 32 * c;
          qv[c] = sQ[at];
          tqv[c] = sTQ[at];
          gvv[c] = sO[at];
          tgv[c] = sTO[at];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int at = (r0 + r) * kT + i;
          const float p = sP[at], pd = sPD[at], g = sS[at], gd = sSD[at];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            gk[r][c] = fmaf(gd, qv[c], fmaf(g, tqv[c], gk[r][c]));
            gv[r][c] = fmaf(pd, gvv[c], fmaf(p, tgv[c], gv[r][c]));
          }
        }
      }
    }
  }

  T* okb = head(tdk, st, TDK, b, hk);
  T* ovb = head(tdv, st, TDV, b, hk);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kp = k0 + r0 + r;
    if (kp >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        okb[kp * st.s[TDK][1] + col] = cast<T>(scale * gk[r][c]);
        ovb[kp * st.s[TDV][1] + col] = cast<T>(gv[r][c]);
      }
    }
  }
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (4 * kT * (D + 4) + 2 * kT * D + 2 * kT * kT);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (8 * kT * (D + 4) + 2 * kT * kT);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (8 * kT * (D + 4) + 4 * kT * kT + 4 * kT);
}

struct Ptrs {
  const void *q, *k, *v, *o, *dout, *lse, *tq, *tk, *tv, *to, *tdout, *tlse;
  void *out_q, *out_k, *out_v, *out_lse, *dsum, *tdsum;
};

template <typename T, int D>
cudaError_t run_fwd(const Ptrs& p, const Views& st, int B, int H, int KV,
                    int S, int Sk, int d, float scale, int causal,
                    int window, cudaStream_t s) {
  auto kernel = fwd_tangent_kernel<T, D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>(), &ready);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((S + kT - 1) / kT);
  kernel<<<(unsigned)blocks, kThreads, fwd_smem<D>(), s>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k),
      static_cast<const T*>(p.v), static_cast<const float*>(p.lse),
      static_cast<const T*>(p.tq), static_cast<const T*>(p.tk),
      static_cast<const T*>(p.tv), static_cast<T*>(p.out_q),
      static_cast<float*>(p.out_lse), st, H, KV, S, Sk, d, scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_bwd(const Ptrs& p, const Views& st, int B, int H, int KV,
                    int S, int Sk, int d, float scale, int causal,
                    int window, int part, cudaStream_t s) {
  const T *q = static_cast<const T*>(p.q), *k = static_cast<const T*>(p.k),
          *v = static_cast<const T*>(p.v), *dout = static_cast<const T*>(p.dout),
          *tq = static_cast<const T*>(p.tq), *tk = static_cast<const T*>(p.tk),
          *tv = static_cast<const T*>(p.tv),
          *tdout = static_cast<const T*>(p.tdout);
  const float *lse = static_cast<const float*>(p.lse),
              *tlse = static_cast<const float*>(p.tlse);
  float *dsum = static_cast<float*>(p.dsum),
        *tdsum = static_cast<float*>(p.tdsum);
  if (part == 0) {
    auto kernel = bwd_tangent_dq_kernel<T, D>;
    static bool ready = false;
    cudaError_t err = allow_smem(kernel, dq_smem<D>(), &ready);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * H * ((S + kT - 1) / kT);
    kernel<<<(unsigned)blocks, kThreads, dq_smem<D>(), s>>>(
        q, k, v, static_cast<const T*>(p.o), dout, lse, tq, tk, tv,
        static_cast<const T*>(p.to), tdout, tlse, dsum, tdsum,
        static_cast<T*>(p.out_q), st, H, KV, S, Sk, d, scale, causal,
        window);
  } else {
    auto kernel = bwd_tangent_dkv_kernel<T, D>;
    static bool ready = false;
    cudaError_t err = allow_smem(kernel, dkv_smem<D>(), &ready);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * KV * ((Sk + kT - 1) / kT);
    kernel<<<(unsigned)blocks, kThreads, dkv_smem<D>(), s>>>(
        q, k, v, dout, lse, tq, tk, tv, tdout, tlse, dsum, tdsum,
        static_cast<T*>(p.out_k), static_cast<T*>(p.out_v), st, H, KV, S,
        Sk, d, scale, causal, window);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Ptrs& p, const Views& st, int B, int H, int KV,
                     int S, int Sk, int d, float scale, int causal,
                     int window, int part, cudaStream_t s) {
  if (part < 0)
    return d <= 32 ? run_fwd<T, 32>(p, st, B, H, KV, S, Sk, d, scale, causal, window, s)
         : d <= 64 ? run_fwd<T, 64>(p, st, B, H, KV, S, Sk, d, scale, causal, window, s)
                   : run_fwd<T, 128>(p, st, B, H, KV, S, Sk, d, scale, causal, window, s);
  return d <= 32 ? run_bwd<T, 32>(p, st, B, H, KV, S, Sk, d, scale, causal, window, part, s)
       : d <= 64 ? run_bwd<T, 64>(p, st, B, H, KV, S, Sk, d, scale, causal, window, part, s)
                 : run_bwd<T, 128>(p, st, B, H, KV, S, Sk, d, scale, causal, window, part, s);
}

bool valid(int B, int H, int KV, int S, int Sk, int d, int dtype) {
  const int longest = S > Sk ? S : Sk;
  return B >= 1 && KV >= 1 && H >= KV && H % KV == 0 && S >= 1 && Sk >= 1 &&
         d >= 1 && d <= kMaxHeadDim && (dtype == 0 || dtype == 1) &&
         (long long)B * H * ((longest + kT - 1) / kT) <= 0x7fffffffLL;
}

Views views(const long long* strides, int n) {
  Views st{};
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  return st;
}

}  // namespace jvpk

extern "C" {

int repro_flash_max_head_dim() { return kMaxHeadDim; }

// float32 on the CUDA cores.  q (BH, S, d), k/v (BH, Sk, d) contiguous;
// o (BH, S, d), lse (BH, S).  window <= 0: none.
int repro_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int BH, int S, int Sk, int d, float scale,
                    int causal, int window, void* stream) {
  if (!valid(BH, S, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d <= 32 ? launch_fwd<float, 32>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s)
      : d <= 64 ? launch_fwd<float, 64>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s)
                : launch_fwd<float, 128>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s);
  return (int)err;
}

// float32 on Hopper (namespace tf32): the interface of the bf16 backward
// below on float32 views; vec = 1: every pointer and stride 16-byte
// aligned and d % 4 == 0 (tiles by cp.async), 0: element by element.
int repro_flash_bwd_f32(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dsum, void* dq, void* dk, void* dv,
                        const long long* strides, int B, int H, int KV,
                        int S, int Sk, int d, float scale, int causal,
                        int window, int part, int vec, void* stream) {
  if (!hop::valid(B, H, KV, S, Sk, d) || (part != 0 && part != 1))
    return (int)cudaErrorInvalidValue;
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<float*>(dsum);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.sq = hop::strides_at(strides, 0);
  a.sk = hop::strides_at(strides, 1);
  a.sv = hop::strides_at(strides, 2);
  a.so = hop::strides_at(strides, 3);
  a.sdo = hop::strides_at(strides, 4);
  a.sdq = hop::strides_at(strides, 5);
  a.sdk = hop::strides_at(strides, 6);
  a.sdv = hop::strides_at(strides, 7);
  a.H = H; a.KV = KV; a.S = S; a.Sk = Sk; a.d = d; a.scale = scale;
  a.causal = causal; a.window = window; a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(d <= 32 ? tf32::run<32>(a, B, part, s)
               : d <= 64 ? tf32::run<64>(a, B, part, s)
                         : tf32::run<128>(a, B, part, s));
}

// bfloat16 on Hopper.  q and o (B, S, H, d), k and v (B, Sk, KV, d), any
// views whose d has stride 1: `strides` holds the (b, s, h) element strides
// of q, k, v and o (forward), or of q, k, v, o, dout, dq, dk and dv
// (backward).  lse and dsum are (B, H, S) float32.  H % KV == 0: query
// head h reads KV head h / (H / KV).  vec = 1: every pointer and stride
// 16-byte aligned and d % 8 == 0 (tiles by TMA; an error if no tensor map
// can be made); 0: element by element.
int repro_flash_fwd_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, const long long* strides, int B,
                         int H, int KV, int S, int Sk, int d, float scale,
                         int causal, int window, int vec, void* stream) {
  if (!hop::valid(B, H, KV, S, Sk, d)) return (int)cudaErrorInvalidValue;
  hop::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.sq = hop::strides_at(strides, 0);
  a.sk = hop::strides_at(strides, 1);
  a.sv = hop::strides_at(strides, 2);
  a.so = hop::strides_at(strides, 3);
  a.H = H; a.KV = KV; a.S = S; a.Sk = Sk; a.d = d; a.scale = scale;
  a.causal = causal; a.window = window;
  a.tma = vec && hop::make_map(&a.tq, q, B, S, H, d, a.sq) &&
          hop::make_map(&a.tk, k, B, Sk, KV, d, a.sk) &&
          hop::make_map(&a.tv, v, B, Sk, KV, d, a.sv) &&
          hop::make_map(&a.to, o, B, S, H, d, a.so);
  if (vec && !a.tma) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(d <= 64 ? hop::run_fwd<1>(a, B, s) : hop::run_fwd<2>(a, B, s));
}

// part 0: dq, and dsum = rowsum(dout * o); part 1 (after part 0, which
// wrote dsum): dk and dv, summed over each KV head's query heads.
int repro_flash_bwd_bf16(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* dsum, void* dq, void* dk, void* dv,
                         const long long* strides, int B, int H, int KV,
                         int S, int Sk, int d, float scale, int causal,
                         int window, int part, int vec, void* stream) {
  if (!hop::valid(B, H, KV, S, Sk, d) || (part != 0 && part != 1))
    return (int)cudaErrorInvalidValue;
  hop::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(const_cast<void*>(o));
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.dsum = static_cast<float*>(dsum);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.sq = hop::strides_at(strides, 0);
  a.sk = hop::strides_at(strides, 1);
  a.sv = hop::strides_at(strides, 2);
  a.so = hop::strides_at(strides, 3);
  a.sdo = hop::strides_at(strides, 4);
  a.sdq = hop::strides_at(strides, 5);
  a.sdk = hop::strides_at(strides, 6);
  a.sdv = hop::strides_at(strides, 7);
  a.H = H; a.KV = KV; a.S = S; a.Sk = Sk; a.d = d; a.scale = scale;
  a.causal = causal; a.window = window;
  a.tma = vec && hop::make_map(&a.tq, q, B, S, H, d, a.sq) &&
          hop::make_map(&a.tdo, dout, B, S, H, d, a.sdo) &&
          hop::make_map(&a.tk, k, B, Sk, KV, d, a.sk) &&
          hop::make_map(&a.tv, v, B, Sk, KV, d, a.sv) &&
          (part == 1 ? hop::make_map(&a.tdk, dk, B, Sk, KV, d, a.sdk) &&
                           hop::make_map(&a.tdv, dv, B, Sk, KV, d, a.sdv)
                     : hop::make_map(&a.to, o, B, S, H, d, a.so) &&
                           hop::make_map(&a.tdq, dq, B, S, H, d, a.sdq));
  if (vec && !a.tma) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (part == 0) {
    err = d <= 64 ? hop::run_dq<1>(a, B, s) : hop::run_dq<2>(a, B, s);
  } else if (H / KV >= 2) {   // two warpgroups split the group's heads
    err = d <= 64 ? hop::run_dkv<1, 2>(a, B, s) : hop::run_dkv<2, 2>(a, B, s);
  } else {
    err = d <= 64 ? hop::run_dkv<1, 1>(a, B, s) : hop::run_dkv<2, 1>(a, B, s);
  }
  return (int)err;
}

// Forward-mode tangents on the CUDA cores (namespace jvpk), dtype 0
// float32 or 1 bfloat16.  `strides` holds the (b, s, h) element strides of
// 13 views, in the order q, k, v, o, dout, tq, tk, tv, to, tdout, tdq,
// tdk, tdv (a view a launch does not touch may be given as 0s); each view's
// d has stride 1.  q-like views have H heads, k/v-like views KV, H % KV ==
// 0.  lse, tlse, dsum and tdsum are (B, H, S) float32.
// T1: o' into `to`, lse' into `tlse`.
int repro_flash_fwd_tangent(const void* q, const void* k, const void* v,
                            const void* lse, const void* tq, const void* tk,
                            const void* tv, void* to, void* tlse,
                            const long long* strides, int B, int H, int KV,
                            int S, int Sk, int d, float scale, int causal,
                            int window, int dtype, void* stream) {
  if (!jvpk::valid(B, H, KV, S, Sk, d, dtype))
    return (int)cudaErrorInvalidValue;
  jvpk::Ptrs p{};
  p.q = q; p.k = k; p.v = v; p.lse = lse; p.tq = tq; p.tk = tk; p.tv = tv;
  p.out_q = to; p.out_lse = tlse;
  const jvpk::Views st = jvpk::views(strides, jvpk::kMaxViews);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype ? jvpk::dispatch<__nv_bfloat16>(p, st, B, H, KV, S, Sk, d, scale, causal, window, -1, s)
                     : jvpk::dispatch<float>(p, st, B, H, KV, S, Sk, d, scale, causal, window, -1, s));
}

// T2.  part 0: dq' into `tdq`, and D, D' into `dsum`, `tdsum`; part 1
// (after part 0): dk' and dv', summed over each KV head's query heads.
int repro_flash_bwd_tangent(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            const void* tq, const void* tk, const void* tv,
                            const void* to, const void* tdout,
                            const void* tlse, void* dsum, void* tdsum,
                            void* tdq, void* tdk, void* tdv,
                            const long long* strides, int B, int H, int KV,
                            int S, int Sk, int d, float scale, int causal,
                            int window, int part, int dtype, void* stream) {
  if (!jvpk::valid(B, H, KV, S, Sk, d, dtype) || (part != 0 && part != 1))
    return (int)cudaErrorInvalidValue;
  jvpk::Ptrs p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse;
  p.tq = tq; p.tk = tk; p.tv = tv; p.to = to; p.tdout = tdout; p.tlse = tlse;
  p.dsum = dsum; p.tdsum = tdsum; p.out_q = tdq; p.out_k = tdk; p.out_v = tdv;
  const jvpk::Views st = jvpk::views(strides, jvpk::kMaxViews);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype ? jvpk::dispatch<__nv_bfloat16>(p, st, B, H, KV, S, Sk, d, scale, causal, window, part, s)
                     : jvpk::dispatch<float>(p, st, B, H, KV, S, Sk, d, scale, causal, window, part, s));
}

}  // extern "C"
