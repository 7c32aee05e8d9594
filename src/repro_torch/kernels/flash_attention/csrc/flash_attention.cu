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
//   dP = dO V^T and D = rowsum(dO * O) precomputed by the wrapper; dK and
//   dV accumulate over query tiles, dQ over key tiles.  Two launches, as in
//   the reference, so nothing is summed with atomics and every result is
//   the same from run to run.
//
// Masks, as the reference: a key the band excludes gets the logit -1e30
// (so a row that has seen no allowed key yet carries exp(0) terms that the
// first allowed key's rescale by exp(-1e30 - m) = 0 wipes out, exactly as
// in the Pallas kernel).  Keys and queries past the sequence ends are
// outside the problem and contribute exactly nothing, so any S and S_k
// work.  Key tiles that lie wholly outside the causal or window band of a
// query tile (and query tiles outside a key tile's band) are skipped.
//
// Bound on an H100: at the serving path's shape (B*H = 192, S = 256,
// d = 128, causal) the forward does 2 * S * S * d flops per (b, h) and
// moves q, k, v and o once.  In bf16 the bytes bound it (about 50 MB at
// 3.35 TB/s, against the flops at the 989 TFLOP/s bf16 tensor rate); in
// float32 the flops at 67 TFLOP/s do.  The backward does 2.5 times the
// forward's flops and moves about twice its bytes.  These kernels are far
// from either bound.  Design: plain float32 FMA on the CUDA cores, no
// wgmma, no TMA, no pipelining (later work).  A block owns a 64-row tile
// and 8 warps of 8 rows each; tiles are staged in shared memory as float32
// (bf16 widened on load, head dims up to 128 zero-padded to 32, 64 or
// 128).  Tiles read across lanes by row are padded by 4 words, so a lane's
// 16-byte loads of consecutive rows fall in distinct banks; tiles read
// across lanes by column are contiguous.
//
// No kernel allocates or synchronises; each launches on the stream it is
// given, and each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // query rows and key rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;     // rows a warp owns
constexpr int kMaxHeadDim = 128;
constexpr float kMasked = -1e30f;         // the reference's NEG_INF

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { BWD_DKV = 0, BWD_DQ = 1 };   // the backward's two launches

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
// backward, dK and dV: one block per (b*h, key tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sk, int d, float scale,
                     int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                          // kTile x LD (this block's keys)
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;               // the visited query tile
  float* sO = sQ + kTile * LD;               // its dO
  float* sP = sO + kTile * LD;               // kTile keys x kTile queries
  float* sS = sP + kTile * kTile;            // dS, same layout
  float* sL = sS + kTile * kTile;            // lse of the query tile
  float* sD = sL + kTile;                    // rowsum(dO * O) of the tile

  const int nk = (Sk + kTile - 1) / kTile;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x - bh * nk) * kTile;
  const T* qb = q + (size_t)bh * S * d;
  const T* ob = dout + (size_t)bh * S * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;               // this warp's key rows

  load_tile<T, D>(sK, LD, k + (size_t)bh * Sk * d, k0, Sk, d);
  load_tile<T, D>(sV, LD, v + (size_t)bh * Sk * d, k0, Sk, d);

  float gk[kRows][NC], gv[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[r][c] = gv[r][c] = 0.f;

  int qt_begin, qt_end;
  query_range(k0, S, Sk, causal, window, &qt_begin, &qt_end);
  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, LD, qb, q0, S, d);
    load_tile<T, D>(sO, LD, ob, q0, S, d);
    if (threadIdx.x < kTile) {
      const int qp = q0 + threadIdx.x;
      sL[threadIdx.x] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
      sD[threadIdx.x] = qp < S ? dsum[(size_t)bh * S + qp] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: this warp's keys against queries lane and lane + 32
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQ[lane * LD + c]);
      const float4 qc =
          *reinterpret_cast<const float4*>(&sQ[(lane + 32) * LD + c]);
      const float4 oa = *reinterpret_cast<const float4*>(&sO[lane * LD + c]);
      const float4 oc =
          *reinterpret_cast<const float4*>(&sO[(lane + 32) * LD + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&sK[(r0 + r) * LD + c]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&sV[(r0 + r) * LD + c]);
        s[r][0] = dot4(kv, qa, s[r][0]);
        s[r][1] = dot4(kv, qc, s[r][1]);
        dp[r][0] = dot4(vv, oa, dp[r][0]);
        dp[r][1] = dot4(vv, oc, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kp = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = lane + 32 * j;
        const int qp = q0 + i;
        float p = 0.f;
        if (qp < S && kp < Sk) {
          const float x = allowed(qp, kp, causal, window) ? s[r][j] * scale
                                                          : kMasked;
          p = expf(x - sL[i]);
        }
        sP[(r0 + r) * kTile + i] = p;
        sS[(r0 + r) * kTile + i] = p * (dp[r][j] - sD[i]) * scale;
      }
    }
    __syncwarp();

    // dV += P^T dO,  dK += dS^T Q  over this query tile
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float ov[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ov[c] = sO[i * LD + lane + 32 * c];
        qv[c] = sQ[i * LD + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sP[(r0 + r) * kTile + i];
        const float g = sS[(r0 + r) * kTile + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          gv[r][c] = fmaf(p, ov[c], gv[r][c]);
          gk[r][c] = fmaf(g, qv[c], gk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kp = k0 + r0 + r;
    if (kp >= Sk) continue;
    const size_t row = ((size_t)bh * Sk + kp) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        dk[row + col] = from_f32<T>(gk[r][c]);
        dv[row + col] = from_f32<T>(gv[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (b*h, query tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int S, int Sk, int d, float scale, int causal,
                    int window) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                          // this block's queries
  float* sO = sQ + kTile * LD;               // their dO
  float* sK = sO + kTile * LD;               // the visited key tile
  float* sV = sK + kTile * LD;
  float* sS = sV + kTile * LD;               // dS, kTile x kTile
  float* sL = sS + kTile * kTile;
  float* sD = sL + kTile;

  const int nq = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * kTile;
  const T* kb = k + (size_t)bh * Sk * d;
  const T* vb = v + (size_t)bh * Sk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;

  load_tile<T, D>(sQ, LD, q + (size_t)bh * S * d, q0, S, d);
  load_tile<T, D>(sO, LD, dout + (size_t)bh * S * d, q0, S, d);
  if (threadIdx.x < kTile) {
    const int qp = q0 + threadIdx.x;
    sL[threadIdx.x] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
    sD[threadIdx.x] = qp < S ? dsum[(size_t)bh * S + qp] : 0.f;
  }

  float gq[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) gq[r][c] = 0.f;

  int kt_begin, kt_end;
  key_range(q0, S, Sk, causal, window, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(sK, LD, kb, k0, Sk, d);
    load_tile<T, D>(sV, LD, vb, k0, Sk, d);
    __syncthreads();

    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sK[lane * LD + c]);
      const float4 kc =
          *reinterpret_cast<const float4*>(&sK[(lane + 32) * LD + c]);
      const float4 va = *reinterpret_cast<const float4*>(&sV[lane * LD + c]);
      const float4 vc =
          *reinterpret_cast<const float4*>(&sV[(lane + 32) * LD + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sQ[(r0 + r) * LD + c]);
        const float4 ov =
            *reinterpret_cast<const float4*>(&sO[(r0 + r) * LD + c]);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kc, s[r][1]);
        dp[r][0] = dot4(ov, va, dp[r][0]);
        dp[r][1] = dot4(ov, vc, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        float p = 0.f;
        if (qp < S && kp < Sk) {
          const float x = allowed(qp, kp, causal, window) ? s[r][j] * scale
                                                          : kMasked;
          p = expf(x - sL[r0 + r]);
        }
        sS[(r0 + r) * kTile + lane + 32 * j] =
            p * (dp[r][j] - sD[r0 + r]) * scale;
      }
    }
    __syncwarp();

    // dQ += dS K over this key tile
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[j * LD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float g = sS[(r0 + r) * kTile + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) gq[r][c] = fmaf(g, kv[c], gq[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
    T* row = dq + ((size_t)bh * S + qp) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) row[col] = from_f32<T>(gq[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (D + 4) + kTile * D + kTile * kTile);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 4) + 2 * kTile * kTile + 2 * kTile);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 4) + kTile * kTile + 2 * kTile);
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

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dq, void* dk, void* dv, int BH, int S, int Sk,
                       int d, float scale, int causal, int window, int part,
                       cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(dsum);
  if (part == BWD_DKV) {
    auto dkv = flash_bwd_dkv_kernel<T, D>;
    static bool ready = false;
    cudaError_t err = allow_smem(dkv, dkv_smem<D>(), &ready);
    if (err != cudaSuccess) return err;
    const long long kv_blocks = (long long)BH * ((Sk + kTile - 1) / kTile);
    dkv<<<(unsigned)kv_blocks, kThreads, dkv_smem<D>(), s>>>(
        qp, kp, vp, op, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), S,
        Sk, d, scale, causal, window);
  } else {
    auto dqk = flash_bwd_dq_kernel<T, D>;
    static bool ready = false;
    cudaError_t err = allow_smem(dqk, dq_smem<D>(), &ready);
    if (err != cudaSuccess) return err;
    const long long q_blocks = (long long)BH * ((S + kTile - 1) / kTile);
    dqk<<<(unsigned)q_blocks, kThreads, dq_smem<D>(), s>>>(
        qp, kp, vp, op, lp, dp, static_cast<T*>(dq), S, Sk, d, scale, causal,
        window);
  }
  return cudaGetLastError();
}

bool valid(int BH, int S, int Sk, int d, int dtype) {
  const int longest = S > Sk ? S : Sk;
  const long long blocks = (long long)BH * ((longest + kTile - 1) / kTile);
  return BH >= 1 && S >= 1 && Sk >= 1 && d >= 1 && d <= kMaxHeadDim &&
         blocks <= 0x7fffffffLL && (dtype == DT_F32 || dtype == DT_BF16);
}

}  // namespace

extern "C" {

int repro_flash_max_head_dim() { return kMaxHeadDim; }

// q (BH, S, d), k/v (BH, Sk, d) contiguous, f32 or bf16 (one dtype);
// o (BH, S, d) in that dtype, lse (BH, S) float32.  window <= 0: none.
int repro_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int BH, int S, int Sk, int d, float scale,
                    int causal, int window, int dtype, void* stream) {
  if (!valid(BH, S, Sk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == DT_F32) {
    err = d <= 32  ? launch_fwd<float, 32>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s)
        : d <= 64  ? launch_fwd<float, 64>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s)
                   : launch_fwd<float, 128>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s);
  } else {
    err = d <= 32  ? launch_fwd<__nv_bfloat16, 32>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s)
        : d <= 64  ? launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s)
                   : launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, BH, S, Sk, d, scale, causal, window, s);
  }
  return (int)err;
}

// q/dout/dq (BH, S, d), k/v/dk/dv (BH, Sk, d) contiguous, one dtype;
// lse and dsum = rowsum(dout * out) (BH, S) float32.  One launch a call:
// part 0 writes dk and dv, part 1 writes dq.
int repro_flash_bwd(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dsum,
                    void* dq, void* dk, void* dv, int BH, int S, int Sk,
                    int d, float scale, int causal, int window, int dtype,
                    int part, void* stream) {
  if (!valid(BH, S, Sk, d, dtype) || (part != BWD_DKV && part != BWD_DQ))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == DT_F32) {
    err = d <= 32  ? launch_bwd<float, 32>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s)
        : d <= 64  ? launch_bwd<float, 64>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s)
                   : launch_bwd<float, 128>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s);
  } else {
    err = d <= 32  ? launch_bwd<__nv_bfloat16, 32>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s)
        : d <= 64  ? launch_bwd<__nv_bfloat16, 64>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s)
                   : launch_bwd<__nv_bfloat16, 128>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s);
  }
  return (int)err;
}

}  // extern "C"
