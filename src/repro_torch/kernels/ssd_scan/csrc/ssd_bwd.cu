// The Mamba2 SSD chunked scan's backward and the backward's forward-mode
// tangent, as CUDA kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../ops.py).  No TPU counterpart: the JAX package
// differentiates its jnp scan.
//
// The backward is the VJP of the chunked scan from a zero state, in
// float32.  For each (b, h) and chunk, with seg the in-chunk cumsum of
// dt * A, E_qk = exp(seg_q - seg_k) for k <= q, G = C B^T (C and B read
// through the head's group), M = G E dt_k, w_k = exp(seg_end - seg_k) and
// u_k = w_k dt_k:
//
//   y_q   = sum_k M_qk x_k + exp(seg_q) s_in C_q
//   s_out = exp(seg_end) s_in + sum_k u_k x_k B_k^T
//
// Five launches (../ref.py has each pass's plain version):
//   state   one block a (b, chunk, h) and 32 columns of N: seg, the
//           chunk's own state S = sum_k u_k x_k B_k^T and its state
//           cotangent Lc = sum_q exp(seg_q) gy_q C_q^T (P x N products
//           over the rows).
//   pass    one block a (b, h): the entering states s_in carried forward,
//           the cotangents gO of the states leaving each chunk carried back
//           from gs (gO[c-1] = exp(seg_end_c) gO[c] + Lc[c]), and
//           sg = <s_in, gO> per chunk.
//   chunk   blocks of 64 rows of a (b, chunk, h), in two roles.  Key rows k
//           walk the query rows q >= k in tiles of 32: D = gy x^T and G
//           give dx = M^T gy + u_k gO B_k, dB (per head) = Z^T C +
//           u_k gO^T x with Z = D E dt_k, the direct part of ddt and the
//           column sums of R = D M.  Query rows walk the key rows k <= q:
//           dC (per head) = Z B + exp(seg_q) gy s_in and the row sums of R
//           with the entering state's term.
//   finish  one warp a (b, h, chunk): dseg (row sums less column sums,
//           the state terms at the chunk's end), its reverse cumsum rcs,
//           ddt = direct + A rcs, and the chunk's part of dA = sum dt rcs.
//   reduce  dB and dC summed over each group's heads, dA over chunks (and
//           over sequences where A is one (H,) for all), in fixed order.
//
// Every sum runs in a fixed order: there are no atomics, so two calls on
// the same inputs give the same bits.  exp is taken of seg_q - seg_k only
// for k <= q (masked before the exponential), so everything stays finite
// where seg falls by more than about 88 within a chunk.
//
// The tangent runs the same five kernels on dual numbers (value, tangent):
// each pass carries its tangent plane beside the value, and a product of
// two dual tiles is three products (A B, A' B, A B').  It writes only the
// tangents of the five gradients.
//
// Products.  Each warp forms 16-row tiles with the m16n8k16 fragment
// layout.  In bfloat16 (x, gy, B, C and their tangents bf16) a product runs
// on the tensor cores (mma.sync, bf16 in, float32 accumulate); an operand
// that is a float32 intermediate (u x, exp(seg) gy, M, Z, gO, s_in) goes in
// as a bf16 hi/lo pair, hi = bf16(v) and lo = bf16(v - hi), as two products
// (three where both are), so products keep about 16 bits of each float32
// operand.  In float32 the same tiles are summed on the CUDA cores, one
// FMA per term, with the same per-thread layout.  The chunk kernel stages
// its operands in shared memory by cp.async (all of a tile's copies in
// flight at once: staged element by element, one dependent load after
// another, the kernel took four times as long) and, in bfloat16, loads
// the fragments by ldmatrix; the state kernel stages its operands the
// same way.
//
// No kernel allocates or synchronises the device; each launches on the
// stream it is given, and the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace sbw {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 256;
constexpr int kWarps = 4;              // a chunk or state block: 4 x 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;
constexpr int kSlab = 32;              // columns of one product pass
constexpr int kLdS = kSlab + 4;        // row strides of the warps' tiles
constexpr int kLdP = kMaxP + 4;
constexpr int kLdN = kMaxN + 4;
constexpr int kPassThreads = 256;

enum { DT_F32 = 0, DT_BF16 = 1 };

// The C entry's pointer slots: each tensor's value plane, then its tangent
// plane (unused in the backward).  ../ops.py lists the same names in the
// same order.
enum Slot {
  X, GY, BM, CM, DT, AA, GS,                       // inputs
  SEG, SS, LC, SIN, GO, SG,                        // passes 1-2
  DBH, DCH, DDD, DSK, DSQ, TK, DAP,                // pass 3 scratch
  DX, DB, DC, DDT, DA,                             // outputs
  kTensors
};
constexpr int kSlots = 2 * kTensors;

struct Args {
  void* p[kSlots];
  int B, L, H, P, G, N, cs, nc;
  long long a_stride, ta_stride;   // A[b * a_stride + h]: 0 for one (H,)
  int a_per_seq;                   // dA (B, H) rather than (H,)
};

// --------------------------------------------------------------------------
// dual numbers
// --------------------------------------------------------------------------

struct Dual { float v, t; };
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.t + b.t};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.t - b.t};
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.v * b.t + a.t * b.v};
}
__device__ __forceinline__ Dual& operator+=(Dual& a, Dual b) {
  a = a + b;
  return a;
}
__device__ __forceinline__ float dexp(float a) { return expf(a); }
__device__ __forceinline__ Dual dexp(Dual a) {
  const float e = expf(a.v);
  return {e, e * a.t};
}
__device__ __forceinline__ float shfl_xor(float x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}
__device__ __forceinline__ Dual shfl_xor(Dual x, int m) {
  return {shfl_xor(x.v, m), shfl_xor(x.t, m)};
}

template <bool kDual> using Num = std::conditional_t<kDual, Dual, float>;

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E> __device__ __forceinline__ E cast(float x);
template <> __device__ __forceinline__ float cast<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// One tensor read as Num: its value plane, and its tangent plane in dual.
template <typename E, bool kDual> struct Rd {
  const E* v;
  const E* t;
  __device__ __forceinline__ Num<kDual> operator[](long long i) const {
    if constexpr (kDual) return Dual{f32(v[i]), f32(t[i])};
    else return f32(v[i]);
  }
};
// One tensor written from Num; in dual a null value plane is skipped (the
// tangent's outputs are tangents only).
template <typename E, bool kDual> struct Wr {
  E* v;
  E* t;
  __device__ __forceinline__ void put(long long i, Num<kDual> x) const {
    if constexpr (kDual) {
      if (v) v[i] = cast<E>(x.v);
      t[i] = cast<E>(x.t);
    } else {
      v[i] = cast<E>(x);
    }
  }
};
template <typename E, bool kDual>
__device__ __forceinline__ Rd<E, kDual> rd(const Args& a, int s) {
  return {static_cast<const E*>(a.p[2 * s]),
          static_cast<const E*>(a.p[2 * s + 1])};
}
template <typename E, bool kDual>
__device__ __forceinline__ Wr<E, kDual> wr(const Args& a, int s) {
  return {static_cast<E*>(a.p[2 * s]), static_cast<E*>(a.p[2 * s + 1])};
}
template <bool kDual>
__device__ __forceinline__ Num<kDual> load_A(const Args& a, int b, int h) {
  const float av = static_cast<const float*>(a.p[2 * AA])[b * a.a_stride + h];
  if constexpr (kDual)
    return Dual{av,
                static_cast<const float*>(a.p[2 * AA + 1])[b * a.ta_stride +
                                                            h]};
  else return av;
}

// --------------------------------------------------------------------------
// warp products in the m16n8k16 layout: lane (g, t) = (lane / 4, lane % 4)
// holds rows g and g + 8, columns 8 nt + 2 t and + 1, of a 16 x 32 tile
// --------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two float32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), the
// first value in the low half (the lower contraction index).
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// acc (16 x 32) += A (16 x K) B (K x 32) for one warp on the CUDA cores
// (the float32 route), one FMA a term; fa(i, k) and fb(k, j) give the
// operands, zero outside the tensors.
template <typename T, typename FA, typename FB>
__device__ __forceinline__ void warp_mm(T (&acc)[4][4], int K, const FA& fa,
                                        const FB& fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const T a0 = fa(g, k), a1 = fa(g + 8, k);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 8 * nt + 2 * t;
      const T b0 = fb(k, n), b1 = fb(k, n + 1);
      acc[nt][0] += a0 * b0;
      acc[nt][1] += a0 * b1;
      acc[nt][2] += a1 * b0;
      acc[nt][3] += a1 * b1;
    }
  }
}

// The bfloat16 route's products from shared memory, fragment by fragment:
// bf16 operands by ldmatrix (transposed where the contraction runs down
// the rows), float32 operands (M, Z, gO, s_in) as pairs split into hi/lo.
// A loader fills a lane's A fragment (16 rows x 16 of the contraction) or
// B fragments (16 of the contraction x 32 columns) of one plane (0 the
// value, 1 the tangent) at contraction offset k0; lo halves only for
// float32 operands.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
using bf16 = __nv_bfloat16;

// A: rows r0 .. r0 + 15 of a bf16 operand, the contraction along the row
struct LdA16 {
  const bf16* p[2];
  int ld, r0;
  __device__ __forceinline__ void operator()(int pl, int k0, uint32_t (&h)[4],
                                             uint32_t (&)[4]) const {
    const int l = threadIdx.x & 31;
    ldsm4(h, p[pl] + (r0 + (l & 7) + 8 * ((l >> 3) & 1)) * ld + k0 +
                 8 * (l >> 4));
  }
};
// B: the 32 columns n0 .. are rows of a bf16 operand, the contraction along
// the row
struct LdBRow16 {
  const bf16* p[2];
  int ld, n0;
  __device__ __forceinline__ void operator()(int pl, int k0,
                                             uint32_t (&h)[4][2],
                                             uint32_t (&)[4][2]) const {
    const int l = threadIdx.x & 31, m = l >> 3;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      uint32_t r[4];
      ldsm4(r, p[pl] + (n0 + 16 * pr + 8 * (m >> 1) + (l & 7)) * ld + k0 +
                   8 * (m & 1));
      h[2 * pr][0] = r[0];
      h[2 * pr][1] = r[1];
      h[2 * pr + 1][0] = r[2];
      h[2 * pr + 1][1] = r[3];
    }
  }
};
// B: the contraction runs down the rows k0 .. of a bf16 operand, the 32
// columns n0 .. along the row
struct LdBCol16 {
  const bf16* p[2];
  int ld, n0;
  __device__ __forceinline__ void operator()(int pl, int k0,
                                             uint32_t (&h)[4][2],
                                             uint32_t (&)[4][2]) const {
    const int l = threadIdx.x & 31, m = l >> 3;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      uint32_t r[4];
      ldsm4t(r, p[pl] + (k0 + 8 * (m & 1) + (l & 7)) * ld + n0 + 16 * pr +
                    8 * (m >> 1));
      h[2 * pr][0] = r[0];
      h[2 * pr][1] = r[1];
      h[2 * pr + 1][0] = r[2];
      h[2 * pr + 1][1] = r[3];
    }
  }
};
// A: rows r0 .. r0 + 15 of a float32 operand, the contraction along the row
struct LdA32 {
  const float* p[2];
  int ld, r0;
  __device__ __forceinline__ void operator()(int pl, int k0, uint32_t (&h)[4],
                                             uint32_t (&lo)[4]) const {
    const int l = threadIdx.x & 31;
    const float* b = p[pl] + (r0 + (l >> 2)) * ld + k0 + 2 * (l & 3);
    const float2 x0 = *reinterpret_cast<const float2*>(b);
    const float2 x1 = *reinterpret_cast<const float2*>(b + 8 * ld);
    const float2 x2 = *reinterpret_cast<const float2*>(b + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(b + 8 * ld + 8);
    split(x0.x, x0.y, h[0], lo[0]);
    split(x1.x, x1.y, h[1], lo[1]);
    split(x2.x, x2.y, h[2], lo[2]);
    split(x3.x, x3.y, h[3], lo[3]);
  }
};
// B: the 32 columns n0 .. are rows of a float32 operand, the contraction
// along the row
struct LdBRow32 {
  const float* p[2];
  int ld, n0;
  __device__ __forceinline__ void operator()(int pl, int k0,
                                             uint32_t (&h)[4][2],
                                             uint32_t (&lo)[4][2]) const {
    const int l = threadIdx.x & 31;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* b = p[pl] + (n0 + 8 * nt + (l >> 2)) * ld + k0 +
                       2 * (l & 3);
      const float2 x0 = *reinterpret_cast<const float2*>(b);
      const float2 x1 = *reinterpret_cast<const float2*>(b + 8);
      split(x0.x, x0.y, h[nt][0], lo[nt][0]);
      split(x1.x, x1.y, h[nt][1], lo[nt][1]);
    }
  }
};
// B: the contraction runs down the rows k0 .. of a float32 operand, the 32
// columns n0 .. along the row
struct LdBCol32 {
  const float* p[2];
  int ld, n0;
  __device__ __forceinline__ void operator()(int pl, int k0,
                                             uint32_t (&h)[4][2],
                                             uint32_t (&lo)[4][2]) const {
    const int l = threadIdx.x & 31;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* b = p[pl] + (k0 + 2 * (l & 3)) * ld + n0 + 8 * nt +
                       (l >> 2);
      split(b[0], b[ld], h[nt][0], lo[nt][0]);
      split(b[8 * ld], b[9 * ld], h[nt][1], lo[nt][1]);
    }
  }
};

// acc (16 x 32) += A B over K (a multiple of 16 or zero-padded to one),
// one plane each; an operand that is not exactly bf16 goes in as hi + lo.
template <bool kEA, bool kEB, typename LA, typename LB>
__device__ __forceinline__ void tc_mm1(float (&acc)[4][4], int K,
                                       const LA& la, int pa, const LB& lb,
                                       int pb) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    la(pa, k0, ah, al);
    lb(pb, k0, bh, bl);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma16816(acc[nt], ah, bh[nt]);
      if constexpr (!kEA) mma16816(acc[nt], al, bh[nt]);
      if constexpr (!kEB) mma16816(acc[nt], ah, bl[nt]);
    }
  }
}
// The same on Num: in dual, A B + (A' B + A B') e.
template <bool kEA, bool kEB, typename T, typename LA, typename LB>
__device__ __forceinline__ void tc_mm(T (&acc)[4][4], int K, const LA& la,
                                      const LB& lb) {
  if constexpr (std::is_same<T, float>::value) {
    tc_mm1<kEA, kEB>(acc, K, la, 0, lb, 0);
  } else {
    float v[4][4], t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[i][e] = acc[i][e].v;
        t[i][e] = acc[i][e].t;
      }
    tc_mm1<kEA, kEB>(v, K, la, 0, lb, 0);
    tc_mm1<kEA, kEB>(t, K, la, 1, lb, 0);
    tc_mm1<kEA, kEB>(t, K, la, 0, lb, 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = Dual{v[i][e], t[i][e]};
  }
}

// f(row, column, element) over a lane's fragment elements.
template <typename T, typename F>
__device__ __forceinline__ void each(T (&acc)[4][4], const F& f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(g + 8 * (e >> 1), 8 * nt + 2 * t + (e & 1), acc[nt][e]);
}

// The sum of a row's values over the four lanes that hold it.
template <typename T> __device__ __forceinline__ T quad_sum(T x) {
  x += shfl_xor(x, 1);
  x += shfl_xor(x, 2);
  return x;
}

// --------------------------------------------------------------------------
// operands staged in shared memory
// --------------------------------------------------------------------------

constexpr int kTileRows = 32;              // rows a staged slab or tile

// Rows [r0, r0 + n) of the chunk of a (B, L, X, W) tensor at index xi
// (row0: the chunk's first (b, l) row) into dst, row stride ld: zero past
// the chunk's cs rows and from column W to the next multiple of 32.
// Rows whose width is a multiple of 16 bytes (from a 16-byte aligned
// tensor) go by cp.async, 16 bytes a copy, all in flight at once (the
// caller waits with cp_async_wait before its barrier); others element by
// element.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
template <typename E>
__device__ __forceinline__ void stage(E* dst, int ld, const E* src,
                                      long long row0, int X, int xi, int W,
                                      int r0, int n, int cs) {
  const int Wr = (W + 31) & ~31;
  constexpr int kV = 16 / sizeof(E);
  if (W % kV == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = Wr / kV;
    for (int idx = threadIdx.x; idx < n * per_row; idx += blockDim.x) {
      const int r = idx / per_row, col = (idx - r * per_row) * kV;
      const int k = r0 + r;
      const bool in = k < cs && col < W;
      cp_async16(dst + r * ld + col,
                 in ? src + ((row0 + k) * X + xi) * W + col : src,
                 in ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < n * Wr; idx += blockDim.x) {
    const int r = idx / Wr, col = idx - r * Wr, k = r0 + r;
    E v = cast<E>(0.f);
    if (k < cs && col < W) v = src[((row0 + k) * X + xi) * W + col];
    dst[r * ld + col] = v;
  }
}

// A staged operand: element (row, column) as Num.
template <typename E, bool kDual> struct Sm {
  const E* v;
  const E* t;
  int ld;
  __device__ __forceinline__ Num<kDual> operator()(int r, int c) const {
    const int i = r * ld + c;
    if constexpr (kDual) return Dual{f32(v[i]), f32(t[i])};
    else return f32(v[i]);
  }
};
// The same read from global memory: rows r0 + r of a (B, L, X, W) tensor,
// zero outside the chunk and the width (the float32 tangent's operands).
template <typename E, bool kDual> struct Gl {
  Rd<E, kDual> m;
  long long row0;
  int X, xi, W, r0, cs;
  __device__ __forceinline__ Num<kDual> operator()(int r, int c) const {
    const int k = r0 + r;
    return k < cs && c < W ? m[((row0 + k) * X + xi) * W + c]
                           : Num<kDual>{};
  }
};

// --------------------------------------------------------------------------
// pass 1: seg, S and Lc of one (b, chunk, h), 32 columns of N a block
// --------------------------------------------------------------------------

// A block a (b, chunk, h) and 32 columns n0 of N: its four warps take 16
// rows of P each and walk the chunk's rows in slabs of kTileRows, staging
// x, B, gy and C rows (as the chunk kernel stages its tiles; read in place
// in the float32 tangent).  S = (u x)^T B and Lc = (e gy)^T C, the scaled
// operand formed as it is loaded.
template <typename In, bool kDual> struct StateLayout {
  static constexpr bool kTC = std::is_same<In, __nv_bfloat16>::value;
  static constexpr bool kStage = kTC || !kDual;
  static constexpr int kPlanes = kDual ? 2 : 1;
  static constexpr int kLdNi = kMaxN + (kTC ? 8 : 4);
  static constexpr int kLdPi = kMaxP + (kTC ? 8 : 4);
  static constexpr size_t kSlabN = (size_t)kTileRows * kLdNi * sizeof(In) *
                                   kPlanes;
  static constexpr size_t kSlabP = (size_t)kTileRows * kLdPi * sizeof(In) *
                                   kPlanes;
  static constexpr size_t kBytes = kStage ? 2 * (kSlabN + kSlabP) : 0;
};

// A fragment of (u x)^T: A(p, k) = u_k x[k][p], x staged as rows k of P;
// in dual the tangent plane is u'_k x + u_k x'.
template <bool kDual> struct LdAScaled {
  const bf16* p[2];
  int ld, r0;
  const Num<kDual>* u;
  __device__ __forceinline__ float at(int pl, int r, int k) const {
    const int i = k * ld + r0 + r;
    if constexpr (kDual) {
      return pl ? u[k].t * f32(p[0][i]) + u[k].v * f32(p[1][i])
                : u[k].v * f32(p[0][i]);
    } else {
      return u[k] * f32(p[0][i]);
    }
  }
  __device__ __forceinline__ void operator()(int pl, int k0, uint32_t (&h)[4],
                                             uint32_t (&lo)[4]) const {
    const int l = threadIdx.x & 31, g = l >> 2, k = k0 + 2 * (l & 3);
    split(at(pl, g, k), at(pl, g, k + 1), h[0], lo[0]);
    split(at(pl, g + 8, k), at(pl, g + 8, k + 1), h[1], lo[1]);
    split(at(pl, g, k + 8), at(pl, g, k + 9), h[2], lo[2]);
    split(at(pl, g + 8, k + 8), at(pl, g + 8, k + 9), h[3], lo[3]);
  }
};

template <typename In, bool kDual>
__device__ __forceinline__ void state_body(const Args& a) {
  using T = Num<kDual>;
  using Lay = StateLayout<In, kDual>;
  using Op = std::conditional_t<Lay::kStage, Sm<In, kDual>, Gl<In, kDual>>;
  constexpr bool kTC = Lay::kTC;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T segs[kMaxChunk], u[kMaxChunk], e[kMaxChunk];
  const int cs = a.cs, H = a.H, P = a.P, N = a.N, G = a.G, L = a.L;
  const int nS = (N + kSlab - 1) / kSlab;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z / nS;
  const int n0 = (blockIdx.z % nS) * kSlab;
  const int grp = h / (H / G);
  const long long row0 = (long long)b * L + (long long)c * cs;
  const long long sbase = ((long long)b * H + h) * L + (long long)c * cs;
  const auto dt = rd<float, kDual>(a, DT);
  const auto x = rd<In, kDual>(a, X), gy = rd<In, kDual>(a, GY);
  const auto Bm = rd<In, kDual>(a, BM), Cm = rd<In, kDual>(a, CM);
  const T A = load_A<kDual>(a, b, h);
  for (int i = threadIdx.x; i < cs; i += blockDim.x)
    segs[i] = dt[(row0 + i) * H + h] * A;
  __syncthreads();
  if (threadIdx.x == 0) {                  // the cumsum, in row order
    T s{};
    for (int i = 0; i < cs; ++i) {
      s += segs[i];
      segs[i] = s;
    }
  }
  __syncthreads();
  const auto seg = wr<float, kDual>(a, SEG);
  for (int i = threadIdx.x; i < kMaxChunk; i += blockDim.x) {
    u[i] = e[i] = T{};                     // zero past the chunk
    if (i >= cs) continue;
    if (n0 == 0) seg.put(sbase + i, segs[i]);
    u[i] = dexp(segs[cs - 1] - segs[i]) * dt[(row0 + i) * H + h];
    e[i] = dexp(segs[i]);
  }
  // rows [k0, k0 + kTileRows) of m as an operand, staged at `at`
  auto rows = [&](const Rd<In, kDual>& m, size_t at, bool group, int k0) {
    const int W = group ? N : P, X = group ? G : H, xi = group ? grp : h;
    if constexpr (Lay::kStage) {
      const int ld = group ? Lay::kLdNi : Lay::kLdPi;
      In* v = reinterpret_cast<In*>(smem + at);
      stage(v, ld, m.v, row0, X, xi, W, k0, kTileRows, cs);
      In* t = v;
      if constexpr (kDual) {
        t = v + (size_t)kTileRows * ld;
        stage(t, ld, m.t, row0, X, xi, W, k0, kTileRows, cs);
      }
      return Op{v, t, ld};
    } else {
      return Op{m, row0, X, xi, W, k0, cs};
    }
  };
  const int p0 = 16 * (threadIdx.x >> 5);
  T accS[4][4] = {}, accL[4][4] = {};
  for (int k0 = 0; k0 < cs; k0 += kTileRows) {
    __syncthreads();                       // the last slab is read
    const Op xs = rows(x, 0, false, k0);
    const Op bs = rows(Bm, Lay::kSlabP, true, k0);
    const Op gs = rows(gy, Lay::kSlabP + Lay::kSlabN, false, k0);
    const Op cs_ = rows(Cm, 2 * Lay::kSlabP + Lay::kSlabN, true, k0);
    cp_async_wait();
    __syncthreads();
    if (p0 >= P) continue;
    if constexpr (kTC) {
      tc_mm<false, true>(accS, kTileRows,
                         LdAScaled<kDual>{{xs.v, xs.t}, xs.ld, p0, u + k0},
                         LdBCol16{{bs.v, bs.t}, bs.ld, n0});
      tc_mm<false, true>(accL, kTileRows,
                         LdAScaled<kDual>{{gs.v, gs.t}, gs.ld, p0, e + k0},
                         LdBCol16{{cs_.v, cs_.t}, cs_.ld, n0});
    } else {
      warp_mm(
          accS, kTileRows,
          [&](int i, int k) { return u[k0 + k] * xs(k, p0 + i); },
          [&](int k, int j) { return bs(k, n0 + j); });
      warp_mm(
          accL, kTileRows,
          [&](int i, int k) { return e[k0 + k] * gs(k, p0 + i); },
          [&](int k, int j) { return cs_(k, n0 + j); });
    }
  }
  if (p0 >= P) return;
  const long long obase = (((long long)b * a.nc + c) * H + h) * P * N;
  const auto S = wr<float, kDual>(a, SS), Lc = wr<float, kDual>(a, LC);
  each(accS, [&](int i, int j, T v) {
    const int p = p0 + i, n = n0 + j;
    if (p < P && n < N) S.put(obase + (long long)p * N + n, v);
  });
  each(accL, [&](int i, int j, T v) {
    const int p = p0 + i, n = n0 + j;
    if (p < P && n < N) Lc.put(obase + (long long)p * N + n, v);
  });
}

// --------------------------------------------------------------------------
// pass 2: the states carried forward and their cotangents back, one block
// a (b, h)
// --------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T block_sum(T x, T* red) {
  x += shfl_xor(x, 16);
  x += shfl_xor(x, 8);
  x += shfl_xor(x, 4);
  x += shfl_xor(x, 2);
  x += shfl_xor(x, 1);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s{};
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

template <bool kDual>
__device__ __forceinline__ void pass_body(const Args& a) {
  using T = Num<kDual>;
  __shared__ T red[kPassThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, nc = a.nc, cs = a.cs;
  const long long PN = (long long)a.P * a.N;
  const auto seg = rd<float, kDual>(a, SEG);
  const auto S = rd<float, kDual>(a, SS), Lc = rd<float, kDual>(a, LC);
  const auto gs = rd<float, kDual>(a, GS);
  const auto s_in = wr<float, kDual>(a, SIN), gO = wr<float, kDual>(a, GO);
  const long long send = ((long long)b * H + h) * a.L + cs - 1;
  auto at = [&](int c, long long e) {
    return (((long long)b * nc + c) * H + h) * PN + e;
  };
  for (long long e = threadIdx.x; e < PN; e += blockDim.x) {
    T s{};
    for (int c = 0; c < nc; ++c) {
      s_in.put(at(c, e), s);
      s = dexp(seg[send + (long long)c * cs]) * s + S[at(c, e)];
    }
    T g = gs[((long long)b * H + h) * PN + e];
    for (int c = nc - 1; c >= 0; --c) {
      gO.put(at(c, e), g);
      g = dexp(seg[send + (long long)c * cs]) * g + Lc[at(c, e)];
    }
  }
  // each thread reads back only what it wrote
  const auto s_r = rd<float, kDual>(a, SIN), g_r = rd<float, kDual>(a, GO);
  const auto sg = wr<float, kDual>(a, SG);
  for (int c = 0; c < nc; ++c) {
    T part{};
    for (long long e = threadIdx.x; e < PN; e += blockDim.x)
      part += s_r[at(c, e)] * g_r[at(c, e)];
    const T total = block_sum(part, red);
    if (threadIdx.x == 0) sg.put(((long long)b * H + h) * nc + c, total);
  }
}

// --------------------------------------------------------------------------
// pass 3: a block's 64 key rows or 64 query rows of a (b, chunk, h)
// --------------------------------------------------------------------------

// A block stages its own 64 rows of its two operands (key rows: B and x;
// query rows: C and gy) once, then walks the other side's rows in tiles of
// 32 (key rows the query rows q >= k; query rows the key rows k <= q),
// staging each tile's two operands (C and gy; B and x), and last the
// chunk's state operand (key rows gO, query rows s_in, P x N float32).
// Staged rows are zero past the chunk and their columns zero up to the
// next multiple of 32, so the warps read them without bounds.  Each warp
// owns 16 of the block's rows: its M and Z slabs are its own, and so are
// its accumulators (registers in the backward, shared memory in the
// tangent, whose dual accumulators would not fit in registers).  The
// float32 tangent's operands would not fit in shared memory beside its
// accumulators: it reads them from global memory through L1.
template <typename In, bool kDual> struct ChunkLayout {
  static constexpr bool kTC = std::is_same<In, __nv_bfloat16>::value;
  static constexpr bool kStage = kTC || !kDual;
  static constexpr int kPlanes = kDual ? 2 : 1;
  static constexpr int kLdNi = kMaxN + (kTC ? 8 : 4);   // staged row strides
  static constexpr int kLdPi = kMaxP + (kTC ? 8 : 4);
  static constexpr size_t kOwn =
      kStage ? (size_t)kRows * (kLdNi + kLdPi) * sizeof(In) * kPlanes : 0;
  static constexpr size_t kTile =
      kStage ? (size_t)kTileRows * (kLdNi + kLdPi) * sizeof(In) * kPlanes
             : 0;
  static constexpr size_t kMZ =
      (size_t)kWarps * 2 * 16 * kLdS * sizeof(Num<kDual>);
  static constexpr size_t kState =
      kStage ? (size_t)kMaxP * kLdN * sizeof(float) * kPlanes : 0;
  static constexpr size_t kLoop = kTile + kMZ > kState ? kTile + kMZ : kState;
  static constexpr size_t kAcc =
      kDual ? (size_t)kWarps * 16 * (kLdP + kLdN) * sizeof(Num<kDual>) : 0;
  static constexpr size_t kBytes = kOwn + kLoop + kAcc;
};

template <typename In, bool kDual> struct Chunk {
  using T = Num<kDual>;
  using Lay = ChunkLayout<In, kDual>;
  static constexpr bool kTC = Lay::kTC;
  static constexpr bool kStage = Lay::kStage;
  static constexpr int kSP = kMaxP / kSlab, kSN = kMaxN / kSlab;
  using Op = std::conditional_t<kStage, Sm<In, kDual>, Gl<In, kDual>>;
  using StOp = std::conditional_t<kStage, Sm<float, kDual>, Gl<float, kDual>>;

  const Args& a;
  unsigned char* smem;
  int b, c, h, grp, cs, H, P, N, G, warp, lane, g;
  long long row0, sbase, obase;
  Rd<In, kDual> x, gy, Bm, Cm;
  Rd<float, kDual> dt, seg;

  __device__ __forceinline__ Chunk(const Args& a_, unsigned char* smem_,
                                   int b_, int c_, int h_)
      : a(a_), smem(smem_), b(b_), c(c_), h(h_), cs(a_.cs), H(a_.H),
        P(a_.P), N(a_.N), G(a_.G) {
    grp = h / (H / G);
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    row0 = (long long)b * a.L + (long long)c * cs;
    sbase = ((long long)b * H + h) * a.L + (long long)c * cs;
    obase = (((long long)b * a.nc + c) * H + h) * (long long)P * N;
    x = rd<In, kDual>(a, X);
    gy = rd<In, kDual>(a, GY);
    Bm = rd<In, kDual>(a, BM);
    Cm = rd<In, kDual>(a, CM);
    dt = rd<float, kDual>(a, DT);
    seg = rd<float, kDual>(a, SEG);
  }

  // Staged region `at` (bytes into shared memory) holding rows of a
  // width-W (N or P) operand, ld its row stride.
  __device__ __forceinline__ In* plane(size_t at, int rows, int ld, int p) {
    return reinterpret_cast<In*>(smem + at) + (size_t)p * rows * ld;
  }
  // rows [r0, r0 + n) of m (a B/C tensor with group index, or an x/gy
  // tensor with head index) as an operand: staged at `at`, or read in place
  template <bool kGroup>
  __device__ __forceinline__ Op rows(const Rd<In, kDual>& m, size_t at,
                                     int r0, int n) {
    const int W = kGroup ? N : P, X = kGroup ? G : H, xi = kGroup ? grp : h;
    if constexpr (kStage) {
      const int ld = kGroup ? Lay::kLdNi : Lay::kLdPi;
      In* v = plane(at, n, ld, 0);
      stage(v, ld, m.v, row0, X, xi, W, r0, n, cs);
      In* t = v;
      if constexpr (kDual) {
        t = plane(at, n, ld, 1);
        stage(t, ld, m.t, row0, X, xi, W, r0, n, cs);
      }
      return Op{v, t, ld};
    } else {
      return Op{m, row0, X, xi, W, r0, cs};
    }
  }
  // the chunk's P x N state operand (gO or s_in), staged at `at`
  __device__ __forceinline__ StOp state_op(int slot, size_t at) {
    const auto m = rd<float, kDual>(a, slot);
    if constexpr (kStage) {
      float* v = reinterpret_cast<float*>(smem + at);
      float* t = v + kMaxP * kLdN;
      // as a (1, P, 1, N) tensor, zero to kMaxP rows and kLdN columns
      stage(v, kLdN, m.v + obase, 0, 1, 0, N, 0, kMaxP, P);
      if constexpr (kDual) stage(t, kLdN, m.t + obase, 0, 1, 0, N, 0, kMaxP, P);
      return StOp{v, t, kLdN};
    } else {
      // one (P, N) plane: rows p of width N, as a (1, P, 1, N) tensor
      return StOp{m, obase / N, 1, 0, N, 0, P};
    }
  }

  // accumulators of a warp's 16 rows x (32 kS) columns: registers in the
  // backward, shared memory (row stride ld) in the tangent
  template <int kS> struct Acc {
    T r[kDual ? 1 : kS][4][4];
    T* s;
    int ld;
  };
  template <int kS>
  __device__ __forceinline__ void acc_init(Acc<kS>& acc, T* s, int ld) {
    acc.s = s;
    acc.ld = ld;
    if constexpr (kDual) {
      for (int i = lane; i < 16 * ld; i += 32) s[i] = T{};
    } else {
#pragma unroll
      for (int q = 0; q < kS; ++q)
        each(acc.r[q], [](int, int, T& v) { v = T{}; });
    }
  }
  // f(slab, 16 x 32 tile): the tile is the slab's accumulator, updated in
  // place, for the slabs below width W
  template <int kS, typename F>
  __device__ __forceinline__ void acc_slabs(Acc<kS>& acc, int W,
                                            const F& f) {
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (q * kSlab >= W) break;
      if constexpr (kDual) {
        T t[4][4];
        T* row = acc.s + q * kSlab;
        each(t, [&](int i, int j, T& v) { v = row[i * acc.ld + j]; });
        f(q, t);
        each(t, [&](int i, int j, T& v) { row[i * acc.ld + j] = v; });
      } else {
        f(q, acc.r[q]);
      }
    }
  }
  template <int kS, typename F>
  __device__ __forceinline__ void acc_each(Acc<kS>& acc, int W,
                                           const F& f) {
    acc_slabs(acc, W, [&](int q, T (&t)[4][4]) {
      each(t, [&](int i, int j, T& v) {
        if (q * kSlab + j < W) f(i, q * kSlab + j, v);
      });
    });
  }

  // the warp's M (0) and Z (1) slabs, 16 x kSlab, as float planes (value,
  // then the tangent in dual)
  __device__ __forceinline__ float* mz_plane(int which, int pl) const {
    return reinterpret_cast<float*>(smem + Lay::kOwn + Lay::kTile) +
           ((warp * 2 + which) * Lay::kPlanes + pl) * 16 * kLdS;
  }
  __device__ __forceinline__ void put_mz(int which, int i, int j, T v) const {
    if constexpr (kDual) {
      mz_plane(which, 0)[i * kLdS + j] = v.v;
      mz_plane(which, 1)[i * kLdS + j] = v.t;
    } else {
      mz_plane(which, 0)[i * kLdS + j] = v;
    }
  }
  __device__ __forceinline__ T get_mz(int which, int i, int j) const {
    if constexpr (kDual)
      return Dual{mz_plane(which, 0)[i * kLdS + j],
                  mz_plane(which, 1)[i * kLdS + j]};
    else return mz_plane(which, 0)[i * kLdS + j];
  }
  __device__ __forceinline__ LdA32 mz_loader(int which) const {
    return LdA32{{mz_plane(which, 0), mz_plane(which, kDual ? 1 : 0)}, kLdS,
                 0};
  }

  __device__ __forceinline__ T seg_at(int k) const {
    return k < cs ? seg[sbase + k] : T{};
  }
  __device__ __forceinline__ T dt_at(int k) const {
    return k < cs ? dt[(row0 + k) * H + h] : T{};
  }

  __device__ void key_rows(int kb) {
    const int kc = kb * kRows, k0 = kc + 16 * warp;
    T* accs = reinterpret_cast<T*>(smem + Lay::kOwn + Lay::kLoop) +
              warp * 16 * (kLdP + kLdN);
    const size_t rowsN = (size_t)kRows * Lay::kLdNi * sizeof(In) *
                         Lay::kPlanes;
    const size_t tileN = (size_t)kTileRows * Lay::kLdNi * sizeof(In) *
                         Lay::kPlanes;
    const Op Bk = rows<true>(Bm, 0, kc, kRows);
    const Op xk = rows<false>(x, rowsN, kc, kRows);
    Acc<kSP> dx;
    Acc<kSN> dB;
    acc_init(dx, accs, kLdP);
    acc_init(dB, accs + 16 * kLdP, kLdN);
    T segk[2], dtk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      segk[r] = seg_at(k0 + g + 8 * r);
      dtk[r] = dt_at(k0 + g + 8 * r);
    }
    T colR[2] = {}, direct[2] = {};
    const int wr = 16 * warp;                     // the warp's own rows
    for (int qs = kc; qs < cs; qs += kTileRows) {
      __syncthreads();                            // the last tile is read
      const Op Cq = rows<true>(Cm, Lay::kOwn, qs, kTileRows);
      const Op gq = rows<false>(gy, Lay::kOwn + tileN, qs, kTileRows);
      cp_async_wait();
      __syncthreads();
      if (k0 >= cs || qs + kTileRows <= k0) continue;
      T Gt[4][4] = {}, Dt[4][4] = {};
      if constexpr (kTC) {
        tc_mm<true, true>(Gt, N, LdA16{{Bk.v, Bk.t}, Bk.ld, wr},
                          LdBRow16{{Cq.v, Cq.t}, Cq.ld, 0});
        tc_mm<true, true>(Dt, P, LdA16{{xk.v, xk.t}, xk.ld, wr},
                          LdBRow16{{gq.v, gq.t}, gq.ld, 0});
      } else {
        warp_mm(
            Gt, N, [&](int i, int n) { return Bk(wr + i, n); },
            [&](int n, int j) { return Cq(j, n); });
        warp_mm(
            Dt, P, [&](int i, int p) { return xk(wr + i, p); },
            [&](int p, int j) { return gq(j, p); });
      }
      each(Gt, [&](int i, int j, T gq_) {
        const int k = k0 + i, q = qs + j, r = i >> 3;
        const T d = Dt[j >> 3][(j & 1) + 2 * r];
        T M{}, Z{};
        if (k < cs && q < cs && k <= q) {
          const T E = dexp(seg[sbase + q] - segk[r]);
          const T GE = gq_ * E;
          M = GE * dtk[r];
          Z = d * E * dtk[r];
          if (k < q) colR[r] += d * M;     // the diagonal: see finish_body
          direct[r] += d * GE;
        }
        put_mz(0, i, j, M);
        put_mz(1, i, j, Z);
      });
      __syncwarp();
      acc_slabs(dx, P, [&](int s, T (&t)[4][4]) {
        if constexpr (kTC)
          tc_mm<false, true>(t, kSlab, mz_loader(0),
                             LdBCol16{{gq.v, gq.t}, gq.ld, s * kSlab});
        else
          warp_mm(
              t, kSlab, [&](int i, int q) { return get_mz(0, i, q); },
              [&](int q, int j) { return gq(q, s * kSlab + j); });
      });
      acc_slabs(dB, N, [&](int s, T (&t)[4][4]) {
        if constexpr (kTC)
          tc_mm<false, true>(t, kSlab, mz_loader(1),
                             LdBCol16{{Cq.v, Cq.t}, Cq.ld, s * kSlab});
        else
          warp_mm(
              t, kSlab, [&](int i, int q) { return get_mz(1, i, q); },
              [&](int q, int j) { return Cq(q, s * kSlab + j); });
      });
      __syncwarp();
    }
    // the state leaving the chunk: s_out += u_k x_k B_k^T
    __syncthreads();
    const StOp gO = state_op(GO, Lay::kOwn);
    cp_async_wait();
    __syncthreads();
    if (k0 >= cs) return;                         // no barrier below
    const T end = seg[sbase + cs - 1];
    T wk[2], uk[2], xv[2] = {};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wk[r] = k0 + g + 8 * r < cs ? dexp(end - segk[r]) : T{};
      uk[r] = wk[r] * dtk[r];
    }
    for (int p0 = 0; p0 < P; p0 += kSlab) {
      T v[4][4] = {};                             // gO B_k
      if constexpr (kTC)
        tc_mm<true, false>(v, N, LdA16{{Bk.v, Bk.t}, Bk.ld, wr},
                           LdBRow32{{gO.v, gO.t}, gO.ld, p0});
      else
        warp_mm(
            v, N, [&](int i, int n) { return Bk(wr + i, n); },
            [&](int n, int j) { return gO(p0 + j, n); });
      each(v, [&](int i, int j, T vv) {
        if (p0 + j < P) xv[i >> 3] += xk(wr + i, p0 + j) * vv;
      });
      acc_slabs(dx, P, [&](int s, T (&t)[4][4]) {
        if (s * kSlab != p0) return;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[nt][e] += uk[e >> 1] * v[nt][e];
      });
    }
    acc_slabs(dB, N, [&](int s, T (&t)[4][4]) {
      T w[4][4] = {};                             // gO^T x_k
      if constexpr (kTC)
        tc_mm<true, false>(w, P, LdA16{{xk.v, xk.t}, xk.ld, wr},
                           LdBCol32{{gO.v, gO.t}, gO.ld, s * kSlab});
      else
        warp_mm(
            w, P, [&](int i, int p) { return xk(wr + i, p); },
            [&](int p, int j) { return gO(p, s * kSlab + j); });
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[nt][e] += uk[e >> 1] * w[nt][e];
    });
    const auto ddd = wr_<float>(DDD), dsk = wr_<float>(DSK);
    const auto tk = wr_<float>(TK);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      colR[r] = quad_sum(colR[r]);
      direct[r] = quad_sum(direct[r]);
      xv[r] = quad_sum(xv[r]);
      const int k = k0 + g + 8 * r;
      if ((lane & 3) == 0 && k < cs) {
        const T Tk = k < cs - 1 ? uk[r] * xv[r] : T{};
        ddd.put(sbase + k, direct[r] + wk[r] * xv[r]);
        dsk.put(sbase + k, T{} - colR[r] - Tk);
        tk.put(sbase + k, Tk);
      }
    }
    const auto dxo = wr_<In>(DX);
    const auto dBh = wr_<float>(DBH);
    acc_each(dx, P, [&](int i, int p, T& v) {
      if (k0 + i < cs) dxo.put(((row0 + k0 + i) * H + h) * P + p, v);
    });
    acc_each(dB, N, [&](int i, int n, T& v) {
      if (k0 + i < cs) dBh.put(((row0 + k0 + i) * H + h) * N + n, v);
    });
  }

  __device__ void query_rows(int qb) {
    const int qc = qb * kRows, q0 = qc + 16 * warp;

    T* accs = reinterpret_cast<T*>(smem + Lay::kOwn + Lay::kLoop) +
              warp * 16 * (kLdP + kLdN);
    const size_t rowsN = (size_t)kRows * Lay::kLdNi * sizeof(In) *
                         Lay::kPlanes;
    const size_t tileN = (size_t)kTileRows * Lay::kLdNi * sizeof(In) *
                         Lay::kPlanes;
    const Op Cq = rows<true>(Cm, 0, qc, kRows);
    const Op gq = rows<false>(gy, rowsN, qc, kRows);
    Acc<kSN> dC;
    acc_init(dC, accs, kLdN);
    T segq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) segq[r] = seg_at(q0 + g + 8 * r);
    T rowR[2] = {};
    const int wr = 16 * warp;
    const int kend = min(cs, qc + kRows);
    for (int ks = 0; ks < kend; ks += kTileRows) {
      __syncthreads();
      const Op Bk = rows<true>(Bm, Lay::kOwn, ks, kTileRows);
      const Op xk = rows<false>(x, Lay::kOwn + tileN, ks, kTileRows);
      cp_async_wait();
      __syncthreads();
      if (q0 >= cs || ks > q0 + 15) continue;
      T Gq[4][4] = {}, Dq[4][4] = {};
      if constexpr (kTC) {
        tc_mm<true, true>(Gq, N, LdA16{{Cq.v, Cq.t}, Cq.ld, wr},
                          LdBRow16{{Bk.v, Bk.t}, Bk.ld, 0});
        tc_mm<true, true>(Dq, P, LdA16{{gq.v, gq.t}, gq.ld, wr},
                          LdBRow16{{xk.v, xk.t}, xk.ld, 0});
      } else {
        warp_mm(
            Gq, N, [&](int i, int n) { return Cq(wr + i, n); },
            [&](int n, int j) { return Bk(j, n); });
        warp_mm(
            Dq, P, [&](int i, int p) { return gq(wr + i, p); },
            [&](int p, int j) { return xk(j, p); });
      }
      each(Gq, [&](int i, int j, T gq_) {
        const int q = q0 + i, k = ks + j, r = i >> 3;
        const T d = Dq[j >> 3][(j & 1) + 2 * r];
        T Z{};
        if (q < cs && k <= q) {
          const T E = dexp(segq[r] - seg[sbase + k]);
          Z = d * E * dt[(row0 + k) * H + h];
          if (k < q) rowR[r] += Z * gq_;
        }
        put_mz(1, i, j, Z);
      });
      __syncwarp();
      acc_slabs(dC, N, [&](int s, T (&t)[4][4]) {
        if constexpr (kTC)
          tc_mm<false, true>(t, kSlab, mz_loader(1),
                             LdBCol16{{Bk.v, Bk.t}, Bk.ld, s * kSlab});
        else
          warp_mm(
              t, kSlab, [&](int i, int k) { return get_mz(1, i, k); },
              [&](int k, int j) { return Bk(k, s * kSlab + j); });
      });
      __syncwarp();
    }
    // the entering state: y_q += exp(seg_q) s_in C_q (zero for the first
    // chunk of a sequence, but the wrapper takes any s_in)
    __syncthreads();
    const StOp s_in = state_op(SIN, Lay::kOwn);
    cp_async_wait();
    __syncthreads();
    if (q0 >= cs) return;                         // no barrier below
    T rs[2] = {};
    T eq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) eq[r] = dexp(segq[r]);
    acc_slabs(dC, N, [&](int s, T (&t)[4][4]) {
      T w[4][4] = {};                             // gy_q s_in
      if constexpr (kTC)
        tc_mm<true, false>(w, P, LdA16{{gq.v, gq.t}, gq.ld, wr},
                           LdBCol32{{s_in.v, s_in.t}, s_in.ld, s * kSlab});
      else
        warp_mm(
            w, P, [&](int i, int p) { return gq(wr + i, p); },
            [&](int p, int j) { return s_in(p, s * kSlab + j); });
      each(w, [&](int i, int j, T ww) {
        const int n = s * kSlab + j, r = i >> 3;
        if (n < N) rs[r] += Cq(wr + i, n) * ww;
      });
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[nt][e] += eq[e >> 1] * w[nt][e];
    });
    const auto dsq = wr_<float>(DSQ);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rowR[r] = quad_sum(rowR[r]);
      rs[r] = quad_sum(rs[r]);
      const int q = q0 + g + 8 * r;
      if ((lane & 3) == 0 && q < cs)
        dsq.put(sbase + q, rowR[r] + eq[r] * rs[r]);
    }
    const auto dCh = wr_<float>(DCH);
    acc_each(dC, N, [&](int i, int n, T& v) {
      if (q0 + i < cs) dCh.put(((row0 + q0 + i) * H + h) * N + n, v);
    });
  }

  template <typename E>
  __device__ __forceinline__ Wr<E, kDual> wr_(int s) const {
    return wr<E, kDual>(a, s);
  }
};

template <typename In, bool kDual>
__device__ __forceinline__ void chunk_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nblk = (a.cs + kRows - 1) / kRows;
  const int role = blockIdx.x >= nblk;               // 0 key rows, 1 query
  const int blk = blockIdx.x - role * nblk;
  const int bc = blockIdx.z, h = blockIdx.y;
  Chunk<In, kDual> ch(a, smem, bc / a.nc, bc % a.nc, h);
  if (role == 0) ch.key_rows(blk);
  else ch.query_rows(blk);
}

// --------------------------------------------------------------------------
// pass 4: ddt and each chunk's dA, one warp a (b, h, chunk)
// --------------------------------------------------------------------------

// R_qq would enter dseg_q once in its row sum and once, negated, in its
// column sum, and T of the chunk's last row once at seg_end and once,
// negated, at its own row: each pair cancels, so neither term is summed
// (in float32 they would not cancel where seg falls steeply).
// One warp a (b, h, chunk): lane l takes rows [l per, (l + 1) per); the
// sums across lanes run in a fixed order (to lane 0 and back, a suffix scan
// by shuffles), so the result does not vary from run to run.
template <typename T> __device__ __forceinline__ T shfl_down(T x, int d);
template <> __device__ __forceinline__ float shfl_down<float>(float x,
                                                              int d) {
  return __shfl_down_sync(0xffffffffu, x, d);
}
template <> __device__ __forceinline__ Dual shfl_down<Dual>(Dual x, int d) {
  return {shfl_down<float>(x.v, d), shfl_down<float>(x.t, d)};
}
template <typename T> __device__ __forceinline__ T lane0(T x);
template <> __device__ __forceinline__ float lane0<float>(float x) {
  return __shfl_sync(0xffffffffu, x, 0);
}
template <> __device__ __forceinline__ Dual lane0<Dual>(Dual x) {
  return {lane0<float>(x.v), lane0<float>(x.t)};
}
// the warp's sum, the same bits in every lane
template <typename T> __device__ __forceinline__ T warp_sum(T x) {
  for (int d = 16; d; d >>= 1) x += shfl_down(x, d);
  return lane0(x);
}

template <bool kDual>
__device__ __forceinline__ void finish_body(const Args& a) {
  using T = Num<kDual>;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int nc = a.nc, H = a.H, cs = a.cs;
  if (w >= (long long)a.B * H * nc) return;          // the whole warp
  const int c = w % nc, h = (w / nc) % H, b = w / ((long long)nc * H);
  const long long sbase = ((long long)b * H + h) * a.L + (long long)c * cs;
  const long long row0 = (long long)b * a.L + (long long)c * cs;
  const auto seg = rd<float, kDual>(a, SEG), sg = rd<float, kDual>(a, SG);
  const auto dsq = rd<float, kDual>(a, DSQ), dsk = rd<float, kDual>(a, DSK);
  const auto ddd = rd<float, kDual>(a, DDD), tk = rd<float, kDual>(a, TK);
  const auto dt = rd<float, kDual>(a, DT);
  const auto ddt = wr<float, kDual>(a, DDT);
  const int per = (cs + 31) / 32;
  const int i0 = min(cs, lane * per), i1 = min(cs, i0 + per);
  T part{};
  for (int i = i0; i < i1; ++i) part += tk[sbase + i];
  const T tsum = warp_sum(part);
  // dseg of the lane's rows, the state terms at the chunk's end
  T own{};
  for (int i = i0; i < i1; ++i) own += dsq[sbase + i] + dsk[sbase + i];
  if (i0 <= cs - 1 && cs - 1 < i1)
    own += tsum + dexp(seg[sbase + cs - 1]) *
                      sg[((long long)b * H + h) * nc + c];
  // the sum over the lanes above: an inclusive suffix scan, shifted
  T incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const T up = shfl_down(incl, d);
    if (lane + d < 32) incl += up;
  }
  T rcs = shfl_down(incl, 1);
  if (lane == 31) rcs = T{};
  const T A = load_A<kDual>(a, b, h);
  T dA{};
  for (int i = i1 - 1; i >= i0; --i) {
    T ds = dsq[sbase + i] + dsk[sbase + i];
    if (i == cs - 1)
      ds += tsum + dexp(seg[sbase + i]) * sg[((long long)b * H + h) * nc + c];
    rcs += ds;
    const long long at = (row0 + i) * H + h;
    ddt.put(at, ddd[sbase + i] + A * rcs);
    dA += dt[at] * rcs;
  }
  dA = warp_sum(dA);
  if (lane == 0)
    wr<float, kDual>(a, DAP).put(((long long)b * nc + c) * H + h, dA);
}

// --------------------------------------------------------------------------
// pass 5: dB and dC summed over each group's heads, dA over chunks (and
// sequences), one plane (the backward's values or the tangent's tangents)
// --------------------------------------------------------------------------

template <typename In>
__device__ __forceinline__ void reduce_body(const Args& a, int plane) {
  const int H = a.H, G = a.G, N = a.N, nc = a.nc, r = H / G;
  const long long rows = (long long)a.B * a.L * G * N;
  const long long nA = a.a_per_seq ? (long long)a.B * H : H;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * rows + nA) return;
  if (idx < 2 * rows) {
    const int which = idx >= rows;                   // 0 dB, 1 dC
    const long long e = idx - which * rows;
    const int n = e % N, grp = (e / N) % G;
    const long long bl = e / ((long long)N * G);
    const float* src =
        static_cast<const float*>(a.p[2 * (which ? DCH : DBH) + plane]);
    float s = 0.f;
    for (int j = 0; j < r; ++j) s += src[(bl * H + grp * r + j) * N + n];
    static_cast<In*>(a.p[2 * (which ? DC : DB) + plane])[e] = cast<In>(s);
    return;
  }
  const long long m = idx - 2 * rows;
  const float* src = static_cast<const float*>(a.p[2 * DAP + plane]);
  float s = 0.f;
  const int h = m % H;
  const int b0 = a.a_per_seq ? (int)(m / H) : 0;
  const int b1 = a.a_per_seq ? b0 + 1 : a.B;
  for (int b = b0; b < b1; ++b)
    for (int c = 0; c < nc; ++c) s += src[((long long)b * nc + c) * H + h];
  static_cast<float*>(a.p[2 * DA + plane])[m] = s;
}

// --------------------------------------------------------------------------
// kernels: the backward's, and the tangent's under their own names
// --------------------------------------------------------------------------

template <typename In>
__global__ void __launch_bounds__(kThreads) state_kernel(const Args a) {
  state_body<In, false>(a);
}
template <typename In>
__global__ void __launch_bounds__(kThreads) tangent_state_kernel(
    const Args a) {
  state_body<In, true>(a);
}
__global__ void __launch_bounds__(kPassThreads) pass_kernel(const Args a) {
  pass_body<false>(a);
}
__global__ void __launch_bounds__(kPassThreads) tangent_pass_kernel(
    const Args a) {
  pass_body<true>(a);
}
template <typename In>
__global__ void __launch_bounds__(kThreads) chunk_kernel(const Args a) {
  chunk_body<In, false>(a);
}
template <typename In>
__global__ void __launch_bounds__(kThreads) tangent_chunk_kernel(
    const Args a) {
  chunk_body<In, true>(a);
}
__global__ void __launch_bounds__(128) finish_kernel(const Args a) {
  finish_body<false>(a);
}
__global__ void __launch_bounds__(128) tangent_finish_kernel(const Args a) {
  finish_body<true>(a);
}
template <typename In>
__global__ void __launch_bounds__(256) reduce_kernel(const Args a) {
  reduce_body<In>(a, 0);
}
template <typename In>
__global__ void __launch_bounds__(256) tangent_reduce_kernel(const Args a) {
  reduce_body<In>(a, 1);
}

template <typename In>
cudaError_t launch(int pass, bool tangent, const Args& a, cudaStream_t s) {
  switch (pass) {
    case 0: {
      const dim3 grid(a.H, a.nc, a.B * ((a.N + kSlab - 1) / kSlab));
      const size_t smem = tangent ? StateLayout<In, true>::kBytes
                                  : StateLayout<In, false>::kBytes;
      const void* fn = tangent ? (const void*)tangent_state_kernel<In>
                               : (const void*)state_kernel<In>;
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      if (tangent) tangent_state_kernel<In><<<grid, kThreads, smem, s>>>(a);
      else state_kernel<In><<<grid, kThreads, smem, s>>>(a);
      break;
    }
    case 1: {
      const dim3 grid(a.H, a.B);
      if (tangent) tangent_pass_kernel<<<grid, kPassThreads, 0, s>>>(a);
      else pass_kernel<<<grid, kPassThreads, 0, s>>>(a);
      break;
    }
    case 2: {
      const dim3 grid(2 * ((a.cs + kRows - 1) / kRows), a.H, a.B * a.nc);
      const size_t smem = tangent ? ChunkLayout<In, true>::kBytes
                                  : ChunkLayout<In, false>::kBytes;
      const void* fn = tangent ? (const void*)tangent_chunk_kernel<In>
                               : (const void*)chunk_kernel<In>;
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      if (tangent) tangent_chunk_kernel<In><<<grid, kThreads, smem, s>>>(a);
      else chunk_kernel<In><<<grid, kThreads, smem, s>>>(a);
      break;
    }
    case 3: {
      const long long n = 32LL * a.B * a.H * a.nc;       // a warp each
      const unsigned blocks = (unsigned)((n + 127) / 128);
      if (tangent) tangent_finish_kernel<<<blocks, 128, 0, s>>>(a);
      else finish_kernel<<<blocks, 128, 0, s>>>(a);
      break;
    }
    case 4: {
      const long long n = 2LL * a.B * a.L * a.G * a.N +
                          (a.a_per_seq ? (long long)a.B * a.H : a.H);
      const long long blocks = (n + 255) / 256;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
      if (tangent)
        tangent_reduce_kernel<In><<<(unsigned)blocks, 256, 0, s>>>(a);
      else
        reduce_kernel<In><<<(unsigned)blocks, 256, 0, s>>>(a);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace sbw

extern "C" {

int repro_ssd_bwd_slots() { return sbw::kSlots; }
int repro_ssd_bwd_max_head_dim() { return sbw::kMaxP; }
int repro_ssd_bwd_max_state() { return sbw::kMaxN; }
int repro_ssd_bwd_max_chunk() { return sbw::kMaxChunk; }

// One pass (0 state, 1 pass, 2 chunk, 3 finish, 4 reduce) of the backward
// (tangent 0) or of its tangent (tangent 1).  ptrs: repro_ssd_bwd_slots()
// device pointers, each tensor's value plane then its tangent plane, in
// the order of sbw::Slot; dtype 0 float32 or 1 bfloat16 (x, gy, B, C, dx,
// dB, dC and their tangents; every other tensor float32).  dims: B, L, H,
// P, G, N, chunk, A's stride per sequence, A''s, and 1 where dA is (B, H).
// Tensors are contiguous; x, gy, dx (B, L, H, P), dt, ddt (B, L, H), B, C,
// dB, dC (B, L, G, N), gs (B, H, P, N); the rest as ../ops.py allocates.
int repro_ssd_bwd_launch(int pass, int tangent, int dtype,
                         void* const* ptrs, const long long* dims,
                         void* stream) {
  sbw::Args a{};
  for (int i = 0; i < sbw::kSlots; ++i) a.p[i] = ptrs[i];
  a.B = (int)dims[0]; a.L = (int)dims[1]; a.H = (int)dims[2];
  a.P = (int)dims[3]; a.G = (int)dims[4]; a.N = (int)dims[5];
  a.cs = (int)dims[6];
  a.a_stride = dims[7]; a.ta_stride = dims[8]; a.a_per_seq = (int)dims[9];
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.P <= 0 || a.G <= 0 ||
      a.N <= 0 || a.cs <= 0 || a.L % a.cs || a.H % a.G ||
      a.P > sbw::kMaxP || a.N > sbw::kMaxN || a.cs > sbw::kMaxChunk ||
      (long long)a.B * (a.L / a.cs) > 65535 || a.H > 65535 ||
      (long long)a.B * ((a.N + sbw::kSlab - 1) / sbw::kSlab) > 65535)
    return (int)cudaErrorInvalidValue;
  a.nc = a.L / a.cs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sbw::DT_F32) return (int)sbw::launch<float>(pass, tangent, a, s);
  if (dtype == sbw::DT_BF16)
    return (int)sbw::launch<__nv_bfloat16>(pass, tangent, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
