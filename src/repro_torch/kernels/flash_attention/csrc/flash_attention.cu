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
//   dP = dO V^T and D = rowsum(dO * O) (from the wrapper in float32, from
//   the dQ kernel in bfloat16); dK and dV accumulate over query tiles, dQ
//   over key tiles.  Two launches, as in the reference, so nothing is
//   summed with atomics and every result is the same from run to run.
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
// float32: plain FMA kernels on the CUDA cores (the flops at 67 TFLOP/s
// bound them), which take contiguous (B*H, S, d) with heads expanded by
// the wrapper.  A block owns a 64-row tile and 8 warps of 8
// rows each; tiles are staged in shared memory (head dims up to 128
// zero-padded to 32, 64 or 128), padded by 4 words where lanes read them
// by row, so a lane's 16-byte loads of consecutive rows fall in distinct
// banks.
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

enum { BWD_DKV = 0, BWD_DQ = 1 };   // the backward's two launches

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

}  // namespace

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

// float32: q/dout/dq (BH, S, d), k/v/dk/dv (BH, Sk, d) contiguous; lse and
// dsum = rowsum(dout * out) (BH, S).  One launch a call: part 0 writes dk
// and dv, part 1 writes dq.
int repro_flash_bwd(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dsum,
                    void* dq, void* dk, void* dv, int BH, int S, int Sk,
                    int d, float scale, int causal, int window, int part,
                    void* stream) {
  if (!valid(BH, S, Sk, d) || (part != BWD_DKV && part != BWD_DQ))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d <= 32 ? launch_bwd<float, 32>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s)
      : d <= 64 ? launch_bwd<float, 64>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s)
                : launch_bwd<float, 128>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, S, Sk, d, scale, causal, window, part, s);
  return (int)err;
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

}  // extern "C"
