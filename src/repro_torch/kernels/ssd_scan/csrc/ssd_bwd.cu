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
// Its passes (../ref.py has each pass's plain version):
//   state   each chunk's own state S = sum_k u_k x_k B_k^T, its state
//           cotangent Lc = sum_q exp(seg_q) gy_q C_q^T, and seg.
//   pass    one block a (b, h): the entering states s_in carried forward,
//           the cotangents gO of the states leaving each chunk carried back
//           from gs (gO[c-1] = exp(seg_end_c) gO[c] + Lc[c]), and
//           sg = <s_in, gO> per chunk.
//   chunk   each chunk's gradients: D = gy x^T, Z = D E dt_k, R = D M;
//           dx = M^T gy + u_k gO B_k, dB (per head) = Z^T C + u_k gO^T x,
//           dC (per head) = Z B + exp(seg_q) gy s_in, the direct part of
//           ddt, and R's row and column sums.
//   finish  one warp a (b, h, chunk): dseg (row sums less column sums,
//           the state terms at the chunk's end), its reverse cumsum rcs,
//           ddt = direct + A rcs, and the chunk's part of dA = sum dt rcs.
//   reduce  dB and dC summed over each group's heads, dA over chunks (and
//           over sequences where A is one (H,) for all), in fixed order.
// The tangent runs the same passes on dual numbers (value, tangent) and
// writes only the tangents of the five gradients.
//
// Two routes, chosen by dtype in the C entry, each with the backward and
// its tangent; the state passing, finish and reduce bodies (namespace ssd)
// serve both:
//   bfloat16  namespace hbw, on wgmma and TMA (its design below, at the
//             namespace): state, pass, gram (C B^T once per group), chunk,
//             finish, reduce; six launches.
//   float32   namespace tbw, the same six launches on the tensor cores as
//             three TF32 mma.sync products (its design at the namespace;
//             the fragments in tf32x3.cuh, shared with ssd_scan.cu's
//             float32 forward).
//
// The designs these replaced (mma.sync on 16 x 32 warp tiles in bfloat16,
// 40x and 51x its bounds at the mamba2 training shape; in float32 five
// CUDA-core kernels, the backward 6.1x its float32-rate bound and the
// tangent 22x) lost their time in five places, and hbw and tbw answer
// each:
//   1. every float32 operand was split into bf16 hi/lo in registers at
//      each fragment load, again by every warp and 32-column slab: now M,
//      Z (and M', Z') are split once a pair of tiles and gO, s_in once a
//      block, into swizzled shared-memory planes that wgmma reads (in
//      tbw, formed once into float32 planes whose fragments split as they
//      load);
//   2. the chunk kernel formed G and D twice (one block for key rows, one
//      for query rows) and G once per head: now one block walks all pairs
//      (q, k) of its (b, chunk, h) once, and G comes from the gram launch,
//      once per group;
//   3. the tangent's dual accumulators lived in shared memory (223 KB, one
//      block an SM) and every product ran three times, its value products
//      thrown away: now only the tangents dx', dB', dC' accumulate, in
//      registers, from the value planes M, Z formed once;
//   4. the state kernel's cumsum ran on one thread and four blocks repeated
//      it for 32 columns each: now a warp scan, and one block forms all
//      P x N of S and Lc on the tensor cores;
//   5. the state passing took one element at a time: now each of its 1024
//      threads carries eight through the chunks together.

// Every sum runs in a fixed order: there are no atomics, so two calls on
// the same inputs give the same bits.  exp is taken of seg_q - seg_k only
// for k <= q (masked before the exponential), so everything stays finite
// where seg falls by more than about 88 within a chunk.  In hbw every
// float32 intermediate enters a bf16 product as a hi/lo pair, hi = bf16(v)
// and lo = bf16(v - hi), two products a pair, keeping about 16 bits of it;
// dx, dB and dC are rounded to bf16 at the end.  In tbw every product is
// three TF32 products (about 21 bits of each operand).
//
// No kernel allocates or synchronises the device; each launches on the
// stream it is given, and the C entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "tf32x3.cuh"

// What every route shares: the C entry's slots and arguments, dual numbers,
// and the bodies of the state passing, finish and reduce passes.
namespace ssd {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 256;
constexpr int kPassThreads = 1024;
// elements of a (P, N) state a pass thread carries (kMaxP kMaxN / threads)
constexpr int kPassPer = kMaxP * kMaxN / kPassThreads;

enum { DT_F32 = 0, DT_BF16 = 1 };

// The C entry's pointer slots: each tensor's value plane, then its tangent
// plane (unused in the backward).  ../ops.py lists the same names in the
// same order.
enum Slot {
  X, GY, BM, CM, DT, AA, GS,                       // inputs
  SEG, SS, LC, SIN, GO, SG,                        // passes 1-2
  DBH, DCH, DDD, DSK, DSQ, TK, DAP,                // pass 3 scratch
  DX, DB, DC, DDT, DA,                             // outputs
  GRAM,                                            // C B^T (hbw, tbw)
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

// The sum of a row's values over the four lanes that hold it.
template <typename T> __device__ __forceinline__ T quad_sum(T x) {
  x += shfl_xor(x, 1);
  x += shfl_xor(x, 2);
  return x;
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

// A thread carries kPassPer elements e = t + kPassThreads j of the state
// through the chunks at once, so that the loads of one chunk's elements are
// in flight together (one element at a time, each chunk's load waited for
// in turn, the pass took 6x its bytes' time on an H100).
template <bool kDual>
__device__ __forceinline__ void pass_body(const Args& a) {
  using T = Num<kDual>;
  __shared__ T red[kPassThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int H = a.H, nc = a.nc, cs = a.cs;
  const int PN = a.P * a.N;
  const auto seg = rd<float, kDual>(a, SEG);
  const auto S = rd<float, kDual>(a, SS), Lc = rd<float, kDual>(a, LC);
  const auto gs = rd<float, kDual>(a, GS);
  const auto s_in = wr<float, kDual>(a, SIN), gO = wr<float, kDual>(a, GO);
  const auto s_r = rd<float, kDual>(a, SIN);
  const auto sg = wr<float, kDual>(a, SG);
  const long long send = ((long long)b * H + h) * a.L + cs - 1;
  auto at = [&](int c, int j) {
    return (((long long)b * nc + c) * H + h) * PN + t + kPassThreads * j;
  };
  auto in = [&](int j) { return t + kPassThreads * j < PN; };
  T s[kPassPer] = {};
  for (int c = 0; c < nc; ++c) {
    const T d = dexp(seg[send + (long long)c * cs]);
#pragma unroll
    for (int j = 0; j < kPassPer; ++j)
      if (in(j)) {
        s_in.put(at(c, j), s[j]);
        s[j] = d * s[j] + S[at(c, j)];
      }
  }
  // the cotangents back, with each chunk's <s_in, gO> (each thread reads
  // back only the s_in it wrote)
#pragma unroll
  for (int j = 0; j < kPassPer; ++j)
    s[j] = in(j) ? gs[((long long)b * H + h) * PN + t + kPassThreads * j]
                 : T{};
  for (int c = nc - 1; c >= 0; --c) {
    const T d = dexp(seg[send + (long long)c * cs]);
    T part{};
#pragma unroll
    for (int j = 0; j < kPassPer; ++j)
      if (in(j)) {
        gO.put(at(c, j), s[j]);
        part += s_r[at(c, j)] * s[j];
        s[j] = d * s[j] + Lc[at(c, j)];
      }
    const T total = block_sum(part, red);
    if (t == 0) sg.put(((long long)b * H + h) * nc + c, total);
  }
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

// The state passing of every route: the backward's, and the tangent's
// under its own name.
__global__ void __launch_bounds__(kPassThreads) pass_kernel(const Args a) {
  pass_body<false>(a);
}
__global__ void __launch_bounds__(kPassThreads) tangent_pass_kernel(
    const Args a) {
  pass_body<true>(a);
}

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace ssd

// ==========================================================================
// bfloat16 on Hopper (namespace hbw)
// ==========================================================================
//
// Six launches, in order (pass ids of the C entry in brackets):
//   state  [0] one block a (b, chunk, h), two warpgroups: the first forms
//              S = (u x)^T B, the second Lc = (e gy)^T C, each a 64 x 128
//              product on wgmma.m64n128k16 with the scaled operand as hi/lo
//              register fragments, the chunk's key tiles streamed by TMA
//              through a ring of two stages; seg by a warp scan.
//   pass   [1] ssd::pass_kernel (the tangent's ssd::tangent_pass_kernel;
//              float32, shared by every route).
//   gram   [5] one block a (b, chunk, group, pair of 64-row tiles q >= k):
//              G^T = B_k C_q^T once for all the group's heads, written in
//              the accumulator's order so that the chunk kernel copies a
//              tile into shared memory with one bulk copy.
//   chunk  [2] one block (one warpgroup) a (b, chunk, h), both roles: the
//              block walks the key tiles k and, for each, the query tiles
//              q >= k, so each (q, k) pair's D^T = x_k gy_q^T (and G^T,
//              read once) are formed once and feed dx, dB and dC alike.
//   finish [3] and reduce [4]: ssd's bodies (ddt and dA; dB and dC summed
//              over a group's heads) under this namespace's names.
//
// The chunk kernel.  dx and dB of the block's key tile stay in wgmma
// register accumulators for the whole walk over q; dC of a query tile is
// touched once a key tile, so its float32 accumulator is read from and
// written back to the per-head scratch dCh (the block's own rows, L2
// resident, in the same order every call).  Before the walk the block
// writes each query tile's entering-state term e_q gy_q s_in to dCh; each
// key tile starts its accumulators with u_k gO B_k and u_k gO^T x_k.  The
// float32 intermediates M^T, Z^T (and their tangents) are written to
// shared memory once a pair as bf16 hi/lo planes (swizzled for wgmma), the
// states gO and s_in once a key tile: no operand is split twice.  dx +=
// M^T gy and dB += Z^T C read the planes K-major; dC += Z B reads the same
// Z^T plane transposed (wgmma's MN-major A).  R's row sums (dseg of the
// query rows) are column sums here: each warp's are added, in pair order,
// to its own vector in shared memory, summed over the four at the end.
// The per-element work is branch-free (the exponent masked to -inf before
// the exponential), so a thread's elements interleave.  The next pair's G
// is loaded as soon as this pair's is read, its q tile as soon as dx and
// dB have read this one's.
//
// The backward runs one warpgroup a block, two blocks an SM (105 KB of
// shared memory, 255 registers).  The tangent forms only the tangents of
// dx, dB and dC (A' B + A B', the value planes of M and Z formed once and
// read by both halves); its 209 KB hold one block an SM, so it runs two
// warpgroups a block: each forms D, D' and the per-element work for half
// of a pair's columns q; the first then accumulates dx' and dC', the
// second dB' (and each its half of dC's entering-state term).  On an H100
// two warpgroups made the tangent's chunk kernel faster; the backward's
// stays at one (two blocks an SM were faster at the serving shape,
// PERF.md).  The float32 scratch (seg, the R sums, ddd, tk) carries value
// and tangent, as the finish kernel needs.
//
// What bounds it.  At the mamba2 training shape (B = 8, L = 512, H = 24,
// P = 64, N = 128, G = 1, chunk 256) the products are ~18 GFLOP (0.018 ms
// at 989 TFLOP/s) and the bytes ~40 MB.  This design does each hi/lo
// product twice and the causal pairs by whole 64 x 64 tiles (10 of 16),
// ~2.5x the least products, and moves dC's partial sums through L2 (~0.2
// GB at that shape).  The walk is one warpgroup in order: an H100 runs the
// backward's chunk kernel far from its products' time (removing them
// changes nothing); dC's read-modify-write and the per-element work are
// its largest parts (PERF.md).

namespace hbw {

using bf16 = __nv_bfloat16;
using ssd::Args;
using ssd::Dual;
template <bool kDual> using Num = ssd::Num<kDual>;

constexpr int kWG = 128;                           // threads of a warpgroup
constexpr int kM = 64;                             // rows of a tile
constexpr uint32_t kRegion = 64 * 128;             // 64 rows x 64 bf16
constexpr uint32_t kGramBytes = kM * kM * 4;       // one G tile, float32

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Byte offset of element (r, col) of a 128-byte-swizzled tile whose
// 64-column regions lie kRegion apart.
__device__ __forceinline__ uint32_t elem(int r, int col) {
  return (uint32_t)(col >> 6) * kRegion + (uint32_t)r * 128u +
         ((uint32_t)(((col >> 3) & 7) ^ (r & 7)) << 4) + (col & 7) * 2;
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
// Waits for the phase of parity `parity` to complete; a barrier that never
// completes (a load that was never issued) traps after ~2^33 cycles
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}
// Rows [row0, row0 + 64) of head (or group) `head` of chunk bc through a
// 4-d map (columns, heads, rows of a chunk, b * nc + c) into the tile at
// dst, nr column regions; completes on bar.  One thread.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& m,
                                         uint32_t bar, int nr, int head,
                                         int row0, int bc) {
  const uint64_t map = reinterpret_cast<uint64_t>(&m);
  for (int r = 0; r < nr; ++r)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            dst + r * kRegion),
        "l"(map), "r"(bar), "r"(64 * r), "r"(head), "r"(row0), "r"(bc)
        : "memory");
}
// bytes (a multiple of 16) from src (16-byte aligned) to dst, on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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
// The warpgroup's 128 threads (named barrier 1 + its index).
__device__ __forceinline__ void bar_wg(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWG) : "memory");
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
template <int N = 0> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
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

// d (64 x 64) (+)= A (64 x 16) B (16 x 64), both in shared memory; kTA /
// kTB 1 reads A / B MN-major (transposed); acc = 0 overwrites d.
template <int kTA, int kTB>
__device__ __forceinline__ void mma64(float (&d)[32], uint64_t a, uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : REPRO_ACC32(d)
      : "l"(a), "l"(b), "r"(acc), "n"(kTA), "n"(kTB));
}
// d (64 x 128) (+)= A (64 x 16) B (16 x 128), as mma64.
template <int kTA, int kTB>
__device__ __forceinline__ void mma128(float (&d)[64], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : REPRO_ACC32(d), REPRO_ACC32((d + 32))
      : "l"(a), "l"(b), "r"(acc), "n"(kTA), "n"(kTB));
}
// d (64 x 128) (+)= A (64 x 16, registers) B (16 x 128, MN-major).
__device__ __forceinline__ void mma128_rs(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d), REPRO_ACC32((d + 32))
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// The products over whole tiles (shared-memory byte addresses; `add`
// false overwrites the accumulator):
// acc (+)= A B^T over K = 64 nr, A and B 64-row tiles, both K-major
template <int NR>
__device__ __forceinline__ void abt(float (&acc)[32], uint32_t a, uint32_t b,
                                   bool add) {
#pragma unroll
  for (int kk = 0; kk < 4 * NR; ++kk) {
    const uint32_t off = (kk >> 2) * kRegion + (kk & 3) * 32;
    mma64<0, 0>(acc, desc(a + off), desc(b + off), add || kk > 0);
  }
}
// acc (+)= A B over K = 64: A K-major (64 rows), B MN-major (64 rows of the
// contraction, N = 64 or 128 columns)
__device__ __forceinline__ void amn(float (&acc)[32], uint32_t a, uint32_t b,
                                   bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma64<0, 1>(acc, desc(a + kk * 32), desc(b + kk * 2048), add || kk > 0);
}
__device__ __forceinline__ void amn(float (&acc)[64], uint32_t a, uint32_t b,
                                   bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma128<0, 1>(acc, desc(a + kk * 32), desc(b + kk * 2048), add || kk > 0);
}
// acc (+)= A B over K = 64, A stored transposed (rows the contraction, the
// 64 output rows along them: MN-major), B MN-major, N = 128
__device__ __forceinline__ void tmn(float (&acc)[64], uint32_t a, uint32_t b,
                                   bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma128<1, 1>(acc, desc(a + kk * 2048), desc(b + kk * 2048),
                 add || kk > 0);
}

// Accumulator element e of thread t (of its warpgroup) sits at row
// frag_row(e, t) and column frag_col(e, t); register j of k-step kk of an
// A fragment holds elements 8 kk + 2 j and + 1 of that layout.
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
__device__ __forceinline__ float bf(const uint8_t* tile, int r, int col) {
  return __uint_as_float(
      (uint32_t)*reinterpret_cast<const unsigned short*>(tile + elem(r, col))
      << 16);
}
__device__ __forceinline__ void st32(uint8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

__device__ __forceinline__ float vpart(float x) { return x; }
__device__ __forceinline__ float vpart(Dual x) { return x.v; }
__device__ __forceinline__ float tpart(float) { return 0.f; }
__device__ __forceinline__ float tpart(Dual x) { return x.t; }
template <bool kDual>
__device__ __forceinline__ Num<kDual> num(float v, float t) {
  if constexpr (kDual) return Dual{v, t};
  else return v;
}

// The (P, N) float32 matrix at src (and its tangent at srct) as bf16 hi/lo
// planes of a 64 x 128 swizzled tile each, zero past P and N: planes hi, lo
// (then hi', lo') 2 kRegion apart from dst.  kThreads threads (t the
// thread's index); each thread's loads of a plane are issued together (one
// at a time they cost a load latency each).
template <bool kDual, int kThreads>
__device__ __forceinline__ void stage_state(uint8_t* dst, const float* src,
                                            const float* srct, int P, int N,
                                            int t) {
  constexpr int kPer = 64 * 64 / kThreads;
#pragma unroll
  for (int pl = 0; pl < (kDual ? 2 : 1); ++pl) {
    const float* m = pl ? srct : src;
    float2 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = t + kThreads * j, p = i >> 6, n = 2 * (i & 63);
      v[j] = p < P && n < N
                 ? *reinterpret_cast<const float2*>(m + p * N + n)
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = t + kThreads * j, p = i >> 6, n = 2 * (i & 63);
      uint32_t h, l;
      split2(v[j].x, v[j].y, h, l);
      st32(dst + (2 * pl) * 2 * kRegion + elem(p, n), h);
      st32(dst + (2 * pl + 1) * 2 * kRegion + elem(p, n), l);
    }
  }
}

// Region 1 (columns 64 .. 127) of a B/C tile zeroed where N <= 64: TMA
// loads only region 0 then.
__device__ __forceinline__ void zero_region(uint8_t* tile, int t,
                                            int nthreads) {
  for (int i = t; i < (int)kRegion / 16; i += nthreads)
    reinterpret_cast<uint4*>(tile + kRegion)[i] = make_uint4(0, 0, 0, 0);
}

// The pointers of a slot's value (pl = 0) or tangent (1) plane.
template <typename E>
__device__ __forceinline__ E* ptr(const Args& a, int slot, int pl) {
  return static_cast<E*>(a.p[2 * slot + pl]);
}

struct HArgs {
  CUtensorMap tx[2], tgy[2], tb[2], tc[2];   // value, tangent
  Args a;
};

// --------------------------------------------------------------------------
// state: S = (u x)^T B and Lc = (e gy)^T C, one block a (b, chunk, h)
// --------------------------------------------------------------------------

template <bool kDual> struct StateLay {
  static constexpr int kNP = kDual ? 2 : 1;
  static constexpr uint32_t kStage = kNP * 3 * kRegion;   // A tile, B tile
  static constexpr uint32_t kWGBytes = 2 * kStage;
  static constexpr uint32_t kVecs = kNP * 3 * ssd::kMaxChunk * 4;
  static constexpr size_t kBytes = 1024 + 2 * kWGBytes + 2 * kVecs + 64;
};

// Inclusive cumsum of dt a (and its tangent dt' a + dt a') over the chunk:
// one warp, a run of consecutive steps a lane, then a shuffle scan of the
// runs, in a fixed order.
template <bool kDual>
__device__ __forceinline__ void cumsum(const float* dt, const float* dtt,
                                       float a, float at, float* seg,
                                       float* segt, int cs, int lane) {
  const int per = (cs + 31) / 32, beg = lane * per;
  float rv = 0.f, rt = 0.f;
  for (int i = 0; i < per; ++i)
    if (beg + i < cs) {
      rv += dt[beg + i] * a;
      if constexpr (kDual) rt += dtt[beg + i] * a + dt[beg + i] * at;
    }
  float iv = rv, it = rt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, iv, o);
    const float w = __shfl_up_sync(0xffffffffu, it, o);
    if (lane >= o) {
      iv += v;
      it += w;
    }
  }
  float pv = __shfl_up_sync(0xffffffffu, iv, 1);
  float pt = __shfl_up_sync(0xffffffffu, it, 1);
  if (lane == 0) pv = pt = 0.f;
  for (int i = 0; i < per; ++i)
    if (beg + i < cs) {
      pv += dt[beg + i] * a;
      seg[beg + i] = pv;
      if constexpr (kDual) {
        pt += dtt[beg + i] * a + dt[beg + i] * at;
        segt[beg + i] = pt;
      }
    }
}

// hi/lo fragments of A = (w x)^T for one key tile (pl: x's plane):
// A[p][k] = w[k] x[k][p], x the swizzled tile (rows k, columns p) at xt;
// with `xt2`, A[p][k] = w[k] x[k][p] + w2[k] x2[k][p].
__device__ __forceinline__ void scaled_frags(const uint8_t* xt,
                                             const float* w,
                                             const uint8_t* xt2,
                                             const float* w2, int t,
                                             uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4]) {
  const int r0 = frag_row(0, t);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = r0 + 8 * (j & 1);
      const int k = 16 * kk + 8 * (j >> 1) + 2 * (t & 3);
      float a0 = w[k] * bf(xt, k, p), a1 = w[k + 1] * bf(xt, k + 1, p);
      if (xt2 != nullptr) {
        a0 += w2[k] * bf(xt2, k, p);
        a1 += w2[k + 1] * bf(xt2, k + 1, p);
      }
      split2(a0, a1, hi[kk][j], lo[kk][j]);
    }
}

template <bool kDual>
__device__ __forceinline__ void state_body(const HArgs& ha) {
  using Lay = StateLay<kDual>;
  constexpr int NP = Lay::kNP;
  extern __shared__ __align__(16) uint8_t smem[];
  const Args& a = ha.a;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int cs = a.cs, H = a.H, P = a.P, N = a.N, nc = a.nc;
  const int grp = h / (H / a.G), bc = b * nc + c;
  const int nt = (cs + kM - 1) / kM, nrn = N > 64 ? 2 : 1;
  const long long row0 = (long long)b * a.L + (long long)c * cs;
  // this warpgroup's ring: stage s holds its A tile's planes (x or gy) at
  // s * kStage, then the B tile's (B or C) at + NP kRegion
  const uint32_t ring = base + wg * Lay::kWGBytes;
  uint8_t* gring = gbase + wg * Lay::kWGBytes;
  float* vec = reinterpret_cast<float*>(gbase + 2 * Lay::kWGBytes +
                                        wg * Lay::kVecs);
  float* dtv = vec;                          // [NP][256]: dt, dt'
  float* segv = vec + NP * ssd::kMaxChunk;   // seg, seg'
  float* sc = vec + 2 * NP * ssd::kMaxChunk; // u or e, and its tangent
  const uint32_t bars = base + 2 * Lay::kWGBytes + 2 * Lay::kVecs + 16 * wg;
  const CUtensorMap* ta = wg ? ha.tgy : ha.tx;
  const CUtensorMap* tb = wg ? ha.tc : ha.tb;
  auto load = [&](int kt) {
    const uint32_t st = ring + (kt & 1) * Lay::kStage, bar = bars + 8 * (kt & 1);
    mbar_expect(bar, NP * (1 + nrn) * kRegion);
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      tma_load(st + pl * kRegion, ta[pl], bar, 1, h, kt * kM, bc);
      tma_load(st + NP * kRegion + pl * 2 * kRegion, tb[pl], bar, nrn, grp,
               kt * kM, bc);
    }
  };
  if (t == 0) {
    for (int pl = 0; pl < NP; ++pl) {
      prefetch_map(ta[pl]);
      prefetch_map(tb[pl]);
    }
    mbar_init(bars);
    mbar_init(bars + 8);
    mbar_init_fence();
  }
  if (nrn == 1)                              // B/C columns 64 .. 127: zero
    for (int s = 0; s < 2; ++s)
      for (int pl = 0; pl < NP; ++pl)
        zero_region(gring + s * Lay::kStage + NP * kRegion + pl * 2 * kRegion,
                    t, kWG);
  fence_async_smem();
  bar_wg(wg);
  if (t == 0) {
    load(0);
    if (nt > 1) load(1);
  }
  // dt (and dt') of the chunk, zero past it; seg by warp 0
  const float* dt = ptr<const float>(a, ssd::DT, 0);
  const float* dtt = ptr<const float>(a, ssd::DT, 1);
  for (int i = t; i < ssd::kMaxChunk; i += kWG) {
    const bool in = i < cs;
    dtv[i] = in ? dt[(row0 + i) * H + h] : 0.f;
    if constexpr (kDual)
      dtv[ssd::kMaxChunk + i] = in ? dtt[(row0 + i) * H + h] : 0.f;
  }
  bar_wg(wg);
  if (warp == 0) {
    const float av = ptr<const float>(a, ssd::AA, 0)[b * a.a_stride + h];
    const float at =
        kDual ? ptr<const float>(a, ssd::AA, 1)[b * a.ta_stride + h] : 0.f;
    cumsum<kDual>(dtv, dtv + ssd::kMaxChunk, av, at, segv,
                  segv + ssd::kMaxChunk, cs, lane);
  }
  bar_wg(wg);
  // the scale of the A operand: u_k = exp(seg_end - seg_k) dt_k (S) or
  // e_k = exp(seg_k) (Lc), zero past the chunk
  const long long sbase = ((long long)b * H + h) * a.L + (long long)c * cs;
  const Num<kDual> end = num<kDual>(segv[cs - 1],
                                    kDual ? segv[ssd::kMaxChunk + cs - 1] : 0.f);
  for (int i = t; i < ssd::kMaxChunk; i += kWG) {
    Num<kDual> s{};
    if (i < cs) {
      const Num<kDual> sg = num<kDual>(segv[i],
                                       kDual ? segv[ssd::kMaxChunk + i] : 0.f);
      if (wg == 0) {
        s = ssd::dexp(end - sg) *
            num<kDual>(dtv[i], kDual ? dtv[ssd::kMaxChunk + i] : 0.f);
        ptr<float>(a, ssd::SEG, 0)[sbase + i] = vpart(sg);
        if constexpr (kDual) ptr<float>(a, ssd::SEG, 1)[sbase + i] = tpart(sg);
      } else {
        s = ssd::dexp(sg);
      }
    }
    sc[i] = vpart(s);
    if constexpr (kDual) sc[ssd::kMaxChunk + i] = tpart(s);
  }
  bar_wg(wg);

  float acc[64];                       // S or Lc (the first product overwrites)
  float acct[kDual ? 64 : 1];          // their tangents
  for (int kt = 0; kt < nt; ++kt) {
    const uint32_t st = ring + (kt & 1) * Lay::kStage;
    const uint8_t* gst = gring + (kt & 1) * Lay::kStage;
    mbar_wait(bars + 8 * (kt & 1), (kt >> 1) & 1);
    const uint32_t bt = st + NP * kRegion;
    uint32_t hi[4][4], lo[4][4];
    const float* w = sc + kt * kM;
    scaled_frags(gst, w, nullptr, nullptr, t, hi, lo);
    keep(acc);
    keep(hi);
    keep(lo);
    if constexpr (kDual) keep(acct);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc(bt + kk * 2048);
      mma128_rs(acc, hi[kk], db, kt > 0 || kk > 0);
      mma128_rs(acc, lo[kk], db, 1);
      if constexpr (kDual) {        // A B'
        const uint64_t db1 = desc(bt + 2 * kRegion + kk * 2048);
        mma128_rs(acct, hi[kk], db1, kt > 0 || kk > 0);
        mma128_rs(acct, lo[kk], db1, 1);
      }
    }
    wg_commit();
    wg_wait();
    keep(acc);
    keep(hi);
    keep(lo);
    if constexpr (kDual) {             // + A' B, A' = w' x + w x'
      keep(acct);
      scaled_frags(gst, w + ssd::kMaxChunk, gst + kRegion, w, t, hi, lo);
      keep(hi);
      keep(lo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc(bt + kk * 2048);
        mma128_rs(acct, hi[kk], db, 1);
        mma128_rs(acct, lo[kk], db, 1);
      }
      wg_commit();
      wg_wait();
      keep(acct);
      keep(hi);
      keep(lo);
    }
    bar_wg(wg);                        // every warp is done with stage kt
    if (t == 0 && kt + 2 < nt) load(kt + 2);
  }
  const long long obase = ((long long)bc * H + h) * P * N;
  float* out = ptr<float>(a, wg ? ssd::LC : ssd::SS, 0) + obase;
  float* outt = ptr<float>(a, wg ? ssd::LC : ssd::SS, 1) + obase;
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int p = frag_row(e, t), n = frag_col(e, t);
    if (p < P && n < N) {
      *reinterpret_cast<float2*>(out + p * N + n) =
          make_float2(acc[e], acc[e + 1]);
      if constexpr (kDual)
        *reinterpret_cast<float2*>(outt + p * N + n) =
            make_float2(acct[e], acct[e + 1]);
    }
  }
}

// --------------------------------------------------------------------------
// gram: G^T = B_k C_q^T of each pair of tiles q >= k, once per group
// --------------------------------------------------------------------------

__host__ __device__ constexpr int pairs(int nt) { return nt * (nt + 1) / 2; }

template <bool kDual>
__device__ __forceinline__ void gram_body(const HArgs& ha) {
  constexpr int NP = kDual ? 2 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const Args& a = ha.a;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const int t = threadIdx.x;
  const int pidx = blockIdx.x, grp = blockIdx.y, bc = blockIdx.z;
  int qt = 0;
  while (pairs(qt + 1) <= pidx) ++qt;
  const int kt = pidx - pairs(qt);
  const int nt = (a.cs + kM - 1) / kM, nrn = a.N > 64 ? 2 : 1;
  // B planes at pl * 2 kRegion, C planes after them; the barrier last
  const uint32_t sB = base, sC = base + NP * 2 * kRegion;
  const uint32_t bar = base + 2 * NP * 2 * kRegion;
  if (t == 0) {
    mbar_init(bar);
    mbar_init_fence();
  }
  if (nrn == 1)
    for (int i = 0; i < 2 * NP; ++i)
      zero_region(gbase + i * 2 * kRegion, t, kWG);
  fence_async_smem();
  __syncthreads();
  if (t == 0) {
    mbar_expect(bar, 2 * NP * nrn * kRegion);
    for (int pl = 0; pl < NP; ++pl) {
      tma_load(sB + pl * 2 * kRegion, ha.tb[pl], bar, nrn, grp, kt * kM, bc);
      tma_load(sC + pl * 2 * kRegion, ha.tc[pl], bar, nrn, grp, qt * kM, bc);
    }
  }
  mbar_wait(bar, 0);
  float g[32], gt[kDual ? 32 : 1];
  keep(g);
  if constexpr (kDual) keep(gt);
  wg_fence();
  abt<2>(g, sB, sC, false);
  if constexpr (kDual) {
    abt<2>(gt, sB + 2 * kRegion, sC, false);
    abt<2>(gt, sB, sC + 2 * kRegion, true);
  }
  wg_commit();
  wg_wait();
  keep(g);
  if constexpr (kDual) keep(gt);
  const long long at =
      (((long long)bc * a.G + grp) * pairs(nt) + pidx) * (kM * kM / 4);
  float4* out = ptr<float4>(a, ssd::GRAM, 0) + at;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out[j * kWG + t] = make_float4(g[4 * j], g[4 * j + 1], g[4 * j + 2],
                                   g[4 * j + 3]);
  if constexpr (kDual) {
    float4* outt = ptr<float4>(a, ssd::GRAM, 1) + at;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      outt[j * kWG + t] = make_float4(gt[4 * j], gt[4 * j + 1],
                                      gt[4 * j + 2], gt[4 * j + 3]);
  }
}

// --------------------------------------------------------------------------
// chunk: dx, dB, dC and the R sums of one (b, chunk, h), one warpgroup
// --------------------------------------------------------------------------

template <bool kDual> struct ChunkLay {
  static constexpr int NP = kDual ? 2 : 1;
  // warpgroups: one in the backward (two blocks an SM); two in the tangent
  // (one block an SM), each forming half of a pair's columns q
  static constexpr int kWGs = kDual ? 2 : 1;
  static constexpr uint32_t kK = NP * 3 * kRegion;    // x planes, B planes
  static constexpr uint32_t oX = 0, oB = NP * kRegion;
  static constexpr uint32_t oGY = kK, oC = kK + NP * kRegion;
  static constexpr uint32_t oG = 2 * kK;              // G (G') tiles
  static constexpr uint32_t oPL = oG + NP * kGramBytes;
  // planes of the pair: M hi, M lo, Z hi, Z lo (then the tangents')
  static constexpr uint32_t kTiles_ = oPL + NP * 4 * kRegion;
  // gO or s_in as hi/lo planes (then the tangent's), over the pair's planes
  static constexpr uint32_t oST = oPL;
  static constexpr int kV = ssd::kMaxChunk;
  // seg, dt, R's per-warp column sums (4), the entering-state terms of
  // dseg, and the second warpgroup's row sums for the first
  static constexpr uint32_t kVecs = NP * (2 + 4 + 1 + 1) * kV * 4;
  static constexpr size_t kBytes = 1024 + kTiles_ + kVecs + 64;
};

// acc (64 x 32) = A B^T over K = 64: A and B (32 rows) K-major tiles.
__device__ __forceinline__ void mma32(float (&d)[16], uint64_t a, uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void abt(float (&acc)[16], uint32_t a, uint32_t b,
                                   bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma32(acc, desc(a + kk * 32), desc(b + kk * 32), add || kk > 0);
}
__device__ __forceinline__ void abt(float (&acc)[32], uint32_t a, uint32_t b,
                                   bool add) {
  abt<1>(acc, a, b, add);
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <bool kDual>
__device__ __forceinline__ void chunk_body(const HArgs& ha) {
  using T = Num<kDual>;
  using Lay = ChunkLay<kDual>;
  constexpr int NP = Lay::NP, kV = Lay::kV, kWGs = Lay::kWGs;
  constexpr int kThreads = kWGs * kWG;
  constexpr int kCols = kM / kWGs;         // a warpgroup's columns q of a pair
  constexpr int kE = kCols / 2;            // its D elements a thread
  constexpr int kN = 128 / kWGs;           // its columns n of dC's state term
  extern __shared__ __align__(16) uint8_t smem[];
  const Args& a = ha.a;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  // (compile-time constants at one warpgroup, so that the backward's code
  // carries none of the second warpgroup's branches)
  const int tid = threadIdx.x, wg = kWGs == 1 ? 0 : tid >> 7;
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  // the first warpgroup accumulates dx and dC, the last dB
  const bool own_x = kWGs == 1 || wg == 0, own_B = kWGs == 1 || wg == 1;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int cs = a.cs, H = a.H, P = a.P, N = a.N, nc = a.nc;
  const int grp = h / (H / a.G), bc = b * nc + c;
  const int nt = (cs + kM - 1) / kM, nrn = N > 64 ? 2 : 1;
  const long long row0 = (long long)b * a.L + (long long)c * cs;
  const long long sbase = ((long long)b * H + h) * a.L + (long long)c * cs;
  const long long obase = ((long long)bc * H + h) * P * N;
  float* vec = reinterpret_cast<float*>(gbase + Lay::kTiles_);
  float* segv = vec;                       // [NP][kV]
  float* dtv = vec + NP * kV;              // [NP][kV]
  float* rowr = vec + 2 * NP * kV;         // [NP][4][kV]
  float* dsqs = vec + 6 * NP * kV;         // [NP][kV]
  float* xbuf = vec + 7 * NP * kV;         // [NP][kV]: row sums of the
                                           // second warpgroup's columns
  const uint32_t bar_k = base + Lay::kTiles_ + Lay::kVecs;
  const uint32_t bar_q = bar_k + 8, bar_g = bar_k + 16;
  int uk = 0, uq = 0, ug = 0;              // completed waits of each barrier
  auto seg_at = [&](int i) {
    return num<kDual>(segv[i], kDual ? segv[kV + i] : 0.f);
  };
  auto dt_at = [&](int i) {
    return num<kDual>(dtv[i], kDual ? dtv[kV + i] : 0.f);
  };
  auto load_k = [&](int kt) {
    mbar_expect(bar_k, NP * (1 + nrn) * kRegion);
    for (int pl = 0; pl < NP; ++pl) {
      tma_load(base + Lay::oX + pl * kRegion, ha.tx[pl], bar_k, 1, h,
               kt * kM, bc);
      tma_load(base + Lay::oB + pl * 2 * kRegion, ha.tb[pl], bar_k, nrn, grp,
               kt * kM, bc);
    }
  };
  auto load_q = [&](int qt) {
    mbar_expect(bar_q, NP * (1 + nrn) * kRegion);
    for (int pl = 0; pl < NP; ++pl) {
      tma_load(base + Lay::oGY + pl * kRegion, ha.tgy[pl], bar_q, 1, h,
               qt * kM, bc);
      tma_load(base + Lay::oC + pl * 2 * kRegion, ha.tc[pl], bar_q, nrn, grp,
               qt * kM, bc);
    }
  };
  auto load_g = [&](int qt, int kt) {
    const long long at = (((long long)bc * a.G + grp) * pairs(nt) +
                          pairs(qt) + kt) * (kM * kM);
    mbar_expect(bar_g, NP * kGramBytes);
    for (int pl = 0; pl < NP; ++pl)
      bulk_load(base + Lay::oG + pl * kGramBytes,
                ptr<const float>(a, ssd::GRAM, pl) + at, kGramBytes, bar_g);
  };
  // the second warpgroup's row sums (this thread's rows r0, r0 + 8) added
  // to the first's, in that order; every thread of the block calls it
  auto row_sums = [&](T (&v)[2], int at) {
    if constexpr (kWGs == 2) {
      const int r0_ = frag_row(0, t);
      if (wg == 1 && (lane & 3) == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xbuf[at + r0_ + 8 * r] = vpart(v[r]);
          if constexpr (kDual) xbuf[kV + at + r0_ + 8 * r] = tpart(v[r]);
        }
      __syncthreads();
      if (wg == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          v[r] += num<kDual>(xbuf[at + r0_ + 8 * r],
                             kDual ? xbuf[kV + at + r0_ + 8 * r] : 0.f);
    }
  };

  if (tid == 0) {
    for (int pl = 0; pl < NP; ++pl) {
      prefetch_map(ha.tx[pl]);
      prefetch_map(ha.tgy[pl]);
      prefetch_map(ha.tb[pl]);
      prefetch_map(ha.tc[pl]);
    }
    mbar_init(bar_k);
    mbar_init(bar_q);
    mbar_init(bar_g);
    mbar_init_fence();
    load_g(0, 0);                        // the first pair's, ahead of all
  }
  if (nrn == 1)
    for (int pl = 0; pl < NP; ++pl) {
      zero_region(gbase + Lay::oB + pl * 2 * kRegion, tid, kThreads);
      zero_region(gbase + Lay::oC + pl * 2 * kRegion, tid, kThreads);
    }
  for (int i = tid; i < kV; i += kThreads) {
    const bool in = i < cs;
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      segv[pl * kV + i] = in ? ptr<const float>(a, ssd::SEG, pl)[sbase + i]
                             : 0.f;
      dtv[pl * kV + i] =
          in ? ptr<const float>(a, ssd::DT, pl)[(row0 + i) * H + h] : 0.f;
      for (int w = 0; w < 4; ++w) rowr[(pl * 4 + w) * kV + i] = 0.f;
    }
  }
  // the entering state s_in as hi/lo planes
  stage_state<kDual, kThreads>(gbase + Lay::oST,
                               ptr<const float>(a, ssd::SIN, 0) + obase,
                               kDual ? ptr<const float>(a, ssd::SIN, 1) + obase
                                     : nullptr,
                               P, N, tid);
  fence_async_smem();
  __syncthreads();
  const int r0 = frag_row(0, t);
  // this thread's two rows (r = 0, 1) of a tile: r0 and r0 + 8
  const int dplane = kDual ? 1 : 0;       // the plane dx, dB, dC carry
  float* dCh = ptr<float>(a, ssd::DCH, dplane);
  auto dc_at = [&](int q, int n) {
    return ((row0 + q) * H + h) * (long long)N + n;
  };

  // the entering state's term of each query tile: dC_q = e_q gy_q s_in
  // into dCh, e_q C_q . (gy_q s_in) into dsqs; each warpgroup its kN
  // columns n; the tiles in reverse, so that query tile 0 is in place for
  // the first pair
  for (int qt = nt - 1; qt >= 0; --qt) {
    if (qt != nt - 1) __syncthreads();   // every warp is done with the tile
    if (tid == 0) load_q(qt);
    mbar_wait(bar_q, uq++ & 1);
    float w[kN / 2], wt[kDual ? kN / 2 : 1];
    const uint32_t sin = base + Lay::oST + wg * kRegion;
    keep(w);
    if constexpr (kDual) keep(wt);
    wg_fence();
    amn(w, base + Lay::oGY, sin, false);
    amn(w, base + Lay::oGY, sin + 2 * kRegion, true);
    if constexpr (kDual) {
      amn(wt, base + Lay::oGY + kRegion, sin, false);
      amn(wt, base + Lay::oGY + kRegion, sin + 2 * kRegion, true);
      amn(wt, base + Lay::oGY, sin + 4 * kRegion, true);
      amn(wt, base + Lay::oGY, sin + 6 * kRegion, true);
    }
    wg_commit();
    wg_wait();
    keep(w);
    if constexpr (kDual) keep(wt);
    T rs[2] = {}, eq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qt * kM + r0 + 8 * r;
      eq[r] = q < cs ? ssd::dexp(seg_at(q)) : T{};
    }
    const uint8_t* Ct = gbase + Lay::oC;
#pragma unroll
    for (int e = 0; e < kN / 2; e += 2) {
      const int r = (e >> 1) & 1, row = r0 + 8 * r;
      const int n = kN * wg + frag_col(e, t), q = qt * kM + row;
      const T w0 = num<kDual>(w[e], kDual ? wt[e] : 0.f);
      const T w1 = num<kDual>(w[e + 1], kDual ? wt[e + 1] : 0.f);
      const T c0 = num<kDual>(bf(Ct, row, n),
                              kDual ? bf(Ct + 2 * kRegion, row, n) : 0.f);
      const T c1 = num<kDual>(bf(Ct, row, n + 1),
                              kDual ? bf(Ct + 2 * kRegion, row, n + 1) : 0.f);
      rs[r] += c0 * w0 + c1 * w1;
      if (q < cs && n < N) {
        const T d0 = eq[r] * w0, d1 = eq[r] * w1;
        *reinterpret_cast<float2*>(dCh + dc_at(q, n)) =
            kDual ? make_float2(tpart(d0), tpart(d1))
                  : make_float2(vpart(d0), vpart(d1));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) rs[r] = ssd::quad_sum(rs[r]);
    row_sums(rs, 2 * kM);
    if (own_x)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qt * kM + r0 + 8 * r;
        if ((lane & 3) == 0 && q < cs) {
          const T v = eq[r] * rs[r];
          dsqs[q] = vpart(v);
          if constexpr (kDual) dsqs[kV + q] = tpart(v);
        }
      }
  }

  const T seg_end = seg_at(cs - 1);
  const uint8_t* Xt = gbase + Lay::oX;
  for (int kt = 0; kt < nt; ++kt) {
    __syncthreads();                     // every warp is done with ST, K
    if (tid == 0) load_k(kt);
    stage_state<kDual, kThreads>(gbase + Lay::oST,
                                 ptr<const float>(a, ssd::GO, 0) + obase,
                                 kDual ? ptr<const float>(a, ssd::GO, 1) + obase
                                       : nullptr,
                                 P, N, tid);
    fence_async_smem();
    __syncthreads();
    mbar_wait(bar_k, uk++ & 1);
    // this thread's two key rows: w_k, u_k, dt_k
    T segk[2], dtk[2], wk[2], ukk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = kt * kM + r0 + 8 * r;
      const bool in = k < cs;
      segk[r] = seg_at(in ? k : 0);
      dtk[r] = in ? dt_at(k) : T{};
      wk[r] = in ? ssd::dexp(seg_end - segk[r]) : T{};
      ukk[r] = wk[r] * dtk[r];
    }
    // the state leaving the chunk: dx = u_k gO B_k, dB = u_k gO^T x_k
    float dx[32], dB[64];
    T xv[2] = {};
    if (own_x) {
      float v[kDual ? 32 : 1];           // the value gO B_k in the tangent
      keep(dx);
      if constexpr (kDual) keep(v);
      wg_fence();
      if constexpr (kDual) {
        abt<2>(v, base + Lay::oB, base + Lay::oST, false);
        abt<2>(v, base + Lay::oB, base + Lay::oST + 2 * kRegion, true);
        abt<2>(dx, base + Lay::oB + 2 * kRegion, base + Lay::oST, false);
        abt<2>(dx, base + Lay::oB + 2 * kRegion,
               base + Lay::oST + 2 * kRegion, true);
        abt<2>(dx, base + Lay::oB, base + Lay::oST + 4 * kRegion, true);
        abt<2>(dx, base + Lay::oB, base + Lay::oST + 6 * kRegion, true);
      } else {
        abt<2>(dx, base + Lay::oB, base + Lay::oST, false);
        abt<2>(dx, base + Lay::oB, base + Lay::oST + 2 * kRegion, true);
      }
      wg_commit();
      wg_wait();
      keep(dx);
      if constexpr (kDual) keep(v);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1, p = frag_col(e, t);
        const T vv = num<kDual>(kDual ? v[e] : dx[e], kDual ? dx[e] : 0.f);
        const T xx = num<kDual>(bf(Xt, r0 + 8 * r, p),
                                kDual ? bf(Xt + kRegion, r0 + 8 * r, p) : 0.f);
        xv[r] += xx * vv;
        dx[e] = kDual ? tpart(ukk[r] * vv) : vpart(ukk[r] * vv);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) xv[r] = ssd::quad_sum(xv[r]);
    }
    if (own_B) {
      float w[kDual ? 64 : 1];
      keep(dB);
      if constexpr (kDual) keep(w);
      wg_fence();
      if constexpr (kDual) {
        amn(w, base + Lay::oX, base + Lay::oST, false);
        amn(w, base + Lay::oX, base + Lay::oST + 2 * kRegion, true);
        amn(dB, base + Lay::oX + kRegion, base + Lay::oST, false);
        amn(dB, base + Lay::oX + kRegion, base + Lay::oST + 2 * kRegion, true);
        amn(dB, base + Lay::oX, base + Lay::oST + 4 * kRegion, true);
        amn(dB, base + Lay::oX, base + Lay::oST + 6 * kRegion, true);
      } else {
        amn(dB, base + Lay::oX, base + Lay::oST, false);
        amn(dB, base + Lay::oX, base + Lay::oST + 2 * kRegion, true);
      }
      wg_commit();
      wg_wait();
      keep(dB);
      if constexpr (kDual) keep(w);
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e >> 1) & 1;
        const T ww = num<kDual>(kDual ? w[e] : dB[e], kDual ? dB[e] : 0.f);
        dB[e] = kDual ? tpart(ukk[r] * ww) : vpart(ukk[r] * ww);
      }
    }
    T colR[2] = {}, direct[2] = {};

    for (int qt = kt; qt < nt; ++qt) {
      // the next pair (q, k) of the walk, whose q tile and G are loaded
      // while this one's products run; none after the last
      const int nq = qt + 1 < nt ? qt + 1 : kt + 1;
      const int nk = qt + 1 < nt ? kt : kt + 1;
      const bool more = nk < nt;
      __syncthreads();                   // every warp is done with the planes
      // this pair's q tile: left by the prologue (the first pair) or loaded
      // during the last pair; its G loaded during the last pair's products
      if (kt > 0 || qt > 0) mbar_wait(bar_q, uq++ & 1);
      mbar_wait(bar_g, ug++ & 1);
      // D^T = x_k gy_q^T (and D'^T = x'_k gy_q^T + x_k gy'_q^T): this
      // warpgroup's kCols columns q
      float D[kE], Dt[kDual ? kE : 1];
      const uint32_t gyc = base + Lay::oGY + wg * kCols * 128;
      keep(D);
      if constexpr (kDual) keep(Dt);
      wg_fence();
      abt(D, base + Lay::oX, gyc, false);
      if constexpr (kDual) {
        abt(Dt, base + Lay::oX + kRegion, gyc, false);
        abt(Dt, base + Lay::oX, gyc + kRegion, true);
      }
      wg_commit();
      wg_wait();
      keep(D);
      if constexpr (kDual) keep(Dt);
      // M^T, Z^T (rows k, columns q) into the planes, the R sums
      const float4* g4 = reinterpret_cast<const float4*>(gbase + Lay::oG);
      const float4* g4t =
          reinterpret_cast<const float4*>(gbase + Lay::oG + kGramBytes);
      uint8_t* pl0 = gbase + Lay::oPL;
#pragma unroll
      for (int i = 0; i < kE / 4; ++i) { // elements 4 i .. 4 i + 3
        // G in the 64-column tile's order: this warpgroup's group i
        const int gi = (i + (kE / 4) * wg) * kWG + t;
        const float4 gv = g4[gi];
        const float4 gt = kDual ? g4t[gi] : make_float4(0, 0, 0, 0);
        const float gvs[4] = {gv.x, gv.y, gv.z, gv.w};
        const float gts[4] = {gt.x, gt.y, gt.z, gt.w};
        T cols[2] = {};                  // R summed over the two rows
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) { // row r0 (hh 0) or r0 + 8
          const int e = 4 * i + 2 * hh;
          const int row = r0 + 8 * hh, col = kCols * wg + frag_col(e, t);
          const int k = kt * kM + row;
          T Mv[2], Zv[2];
          // branch-free, so that the elements' chains interleave: the
          // exponent is masked to -inf before the exponential where the
          // pair is out (k > q, or past the chunk), E = 0 there
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int q = qt * kM + col + u;
            const bool in = k < cs && q < cs && k <= q;
            const T E = ssd::dexp(in ? seg_at(q) - segk[hh]
                                     : num<kDual>(-INFINITY, 0.f));
            const T G = num<kDual>(gvs[2 * hh + u], gts[2 * hh + u]);
            const T Dv = num<kDual>(D[e + u], kDual ? Dt[e + u] : 0.f);
            const T GE = G * E;
            Mv[u] = GE * dtk[hh];
            Zv[u] = Dv * E * dtk[hh];
            direct[hh] += Dv * GE;
            // the diagonal is left out of R's sums: see finish_body
            const T R = k < q ? Dv * Mv[u] : T{};
            colR[hh] += R;
            cols[u] += R;
          }
          uint32_t hi, lo;
          const uint32_t off = elem(row, col);
          split2(vpart(Mv[0]), vpart(Mv[1]), hi, lo);
          st32(pl0 + off, hi);
          st32(pl0 + kRegion + off, lo);
          split2(vpart(Zv[0]), vpart(Zv[1]), hi, lo);
          st32(pl0 + 2 * kRegion + off, hi);
          st32(pl0 + 3 * kRegion + off, lo);
          if constexpr (kDual) {
            split2(tpart(Mv[0]), tpart(Mv[1]), hi, lo);
            st32(pl0 + 4 * kRegion + off, hi);
            st32(pl0 + 5 * kRegion + off, lo);
            split2(tpart(Zv[0]), tpart(Zv[1]), hi, lo);
            st32(pl0 + 6 * kRegion + off, hi);
            st32(pl0 + 7 * kRegion + off, lo);
          }
        }
        // the columns' sums over the warp's 16 rows, added to its vector
        // (each column is one warpgroup's)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          T s = cols[u];
          s += ssd::shfl_xor(s, 4);
          s += ssd::shfl_xor(s, 8);
          s += ssd::shfl_xor(s, 16);
          const int q = qt * kM + kCols * wg + frag_col(4 * i, t) + u;
          if (lane < 4 && q < cs) {
            rowr[warp * kV + q] += vpart(s);
            if constexpr (kDual) rowr[(4 + warp) * kV + q] += tpart(s);
          }
        }
      }
      fence_async_smem();
      __syncthreads();
      if (tid == 0 && more) load_g(nq, nk);  // G is read: the next pair's
      // dx += M^T gy, dB += Z^T C (their tangents: M'^T gy + M^T gy', ...)
      const uint32_t sPL = base + Lay::oPL;
      if (own_x) keep(dx);
      if (own_B) keep(dB);
      wg_fence();
      if (own_x) {
        if constexpr (kDual) {
          amn(dx, sPL + 4 * kRegion, base + Lay::oGY, true);
          amn(dx, sPL + 5 * kRegion, base + Lay::oGY, true);
          amn(dx, sPL, base + Lay::oGY + kRegion, true);
          amn(dx, sPL + kRegion, base + Lay::oGY + kRegion, true);
        } else {
          amn(dx, sPL, base + Lay::oGY, true);
          amn(dx, sPL + kRegion, base + Lay::oGY, true);
        }
      }
      if (own_B) {
        if constexpr (kDual) {
          amn(dB, sPL + 6 * kRegion, base + Lay::oC, true);
          amn(dB, sPL + 7 * kRegion, base + Lay::oC, true);
          amn(dB, sPL + 2 * kRegion, base + Lay::oC + 2 * kRegion, true);
          amn(dB, sPL + 3 * kRegion, base + Lay::oC + 2 * kRegion, true);
        } else {
          amn(dB, sPL + 2 * kRegion, base + Lay::oC, true);
          amn(dB, sPL + 3 * kRegion, base + Lay::oC, true);
        }
      }
      wg_commit();
      if (own_x) {
        // dC_q += Z B_k (Z' B_k + Z B'_k), its partial sum read from dCh
        float dC[64];
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int q = qt * kM + frag_row(e, t), n = frag_col(e, t);
          float2 v = make_float2(0.f, 0.f);
          if (q < cs && n < N)
            v = *reinterpret_cast<const float2*>(dCh + dc_at(q, n));
          dC[e] = v.x;
          dC[e + 1] = v.y;
        }
        keep(dC);
        wg_fence();
        if constexpr (kDual) {
          tmn(dC, sPL + 6 * kRegion, base + Lay::oB, true);
          tmn(dC, sPL + 7 * kRegion, base + Lay::oB, true);
          tmn(dC, sPL + 2 * kRegion, base + Lay::oB + 2 * kRegion, true);
          tmn(dC, sPL + 3 * kRegion, base + Lay::oB + 2 * kRegion, true);
        } else {
          tmn(dC, sPL + 2 * kRegion, base + Lay::oB, true);
          tmn(dC, sPL + 3 * kRegion, base + Lay::oB, true);
        }
        wg_commit();
        wg_wait<1>();                    // dx (and dB) done
        if constexpr (kWGs == 2) bar_sync(3, kThreads);   // dB done too
        if (tid == 0 && more) load_q(nq);  // the q tile is read
        wg_wait();
        keep(dx);
        keep(dB);
        keep(dC);
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int q = qt * kM + frag_row(e, t), n = frag_col(e, t);
          if (q < cs && n < N)
            *reinterpret_cast<float2*>(dCh + dc_at(q, n)) =
                make_float2(dC[e], dC[e + 1]);
        }
      } else {
        wg_wait();
        keep(dB);
        bar_arrive(3, kThreads);
      }
    }

    // the key tile's outputs: dx, dB per head, ddd, dsk, tk
    if (own_x) {
      bf16* dxo = ptr<bf16>(a, ssd::DX, dplane);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int k = kt * kM + frag_row(e, t), p = frag_col(e, t);
        if (k < cs && p < P)
          *reinterpret_cast<uint32_t*>(dxo + ((row0 + k) * H + h) * P + p) =
              pack_bf16(dx[e], dx[e + 1]);
      }
    }
    if (own_B) {
      float* dBh = ptr<float>(a, ssd::DBH, dplane);
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        const int k = kt * kM + frag_row(e, t), n = frag_col(e, t);
        if (k < cs && n < N)
          *reinterpret_cast<float2*>(dBh + ((row0 + k) * H + h) * N + n) =
              make_float2(dB[e], dB[e + 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      colR[r] = ssd::quad_sum(colR[r]);
      direct[r] = ssd::quad_sum(direct[r]);
    }
    row_sums(colR, 0);
    row_sums(direct, kM);
    if (own_x)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = kt * kM + r0 + 8 * r;
        if ((lane & 3) == 0 && k < cs) {
          const T Tk = k < cs - 1 ? ukk[r] * xv[r] : T{};
          const T ddd = direct[r] + wk[r] * xv[r];
          const T dsk = T{} - colR[r] - Tk;
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) {
            ptr<float>(a, ssd::DDD, pl)[sbase + k] =
                pl ? tpart(ddd) : vpart(ddd);
            ptr<float>(a, ssd::DSK, pl)[sbase + k] =
                pl ? tpart(dsk) : vpart(dsk);
            ptr<float>(a, ssd::TK, pl)[sbase + k] = pl ? tpart(Tk) : vpart(Tk);
          }
        }
      }
  }
  // dseg of the query rows: R's row sums (the four warps' column sums) and
  // the entering state's term
  __syncthreads();
  for (int q = tid; q < cs; q += kThreads)
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      const float* rr = rowr + pl * 4 * kV;
      ptr<float>(a, ssd::DSQ, pl)[sbase + q] =
          ((rr[q] + rr[kV + q]) + (rr[2 * kV + q] + rr[3 * kV + q])) +
          dsqs[pl * kV + q];
    }
}

// --------------------------------------------------------------------------
// kernels: the backward's, and the tangent's under their own names
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(2 * kWG, 1)
state_kernel(const __grid_constant__ HArgs ha) {
  state_body<false>(ha);
}
__global__ void __launch_bounds__(2 * kWG, 1)
tangent_state_kernel(const __grid_constant__ HArgs ha) {
  state_body<true>(ha);
}
__global__ void __launch_bounds__(kWG)
gram_kernel(const __grid_constant__ HArgs ha) {
  gram_body<false>(ha);
}
__global__ void __launch_bounds__(kWG)
tangent_gram_kernel(const __grid_constant__ HArgs ha) {
  gram_body<true>(ha);
}
__global__ void __launch_bounds__(kWG, 2)
chunk_kernel(const __grid_constant__ HArgs ha) {
  chunk_body<false>(ha);
}
__global__ void __launch_bounds__(2 * kWG, 1)
tangent_chunk_kernel(const __grid_constant__ HArgs ha) {
  chunk_body<true>(ha);
}
__global__ void __launch_bounds__(128) finish_kernel(const Args a) {
  ssd::finish_body<false>(a);
}
__global__ void __launch_bounds__(128) tangent_finish_kernel(const Args a) {
  ssd::finish_body<true>(a);
}
__global__ void __launch_bounds__(256) reduce_kernel(const Args a) {
  ssd::reduce_body<bf16>(a, 0);
}
__global__ void __launch_bounds__(256) tangent_reduce_kernel(const Args a) {
  ssd::reduce_body<bf16>(a, 1);
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library links nothing beyond cudart.  The driver's encode needs a current
// context; a thread that has made no runtime call has none (autograd's
// device thread): cudaSetDevice binds the device's primary context.
EncodeTiled encode_tiled() {
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

// A contiguous bf16 (B, L, heads, cols) as (cols, heads, rows of a chunk,
// B * nc): boxes of 64 columns x 1 head x 64 rows of one chunk, rows past
// the chunk and columns past cols zero-filled.
bool map_rows(CUtensorMap* m, const void* ptr, int cols, int heads,
              int chunk, long long bnc) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads,
                              (cuuint64_t)chunk, (cuuint64_t)bnc};
  const cuuint64_t strides[3] = {2ull * cols, 2ull * cols * heads,
                                 2ull * cols * heads * chunk};
  const cuuint32_t box[4] = {64, 1, 64, 1}, unit[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel, typename A>
cudaError_t run(Kernel kernel, dim3 grid, int threads, size_t smem,
                cudaStream_t s, const A& args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(args);
  return cudaGetLastError();
}

// The shapes the Hopper kernels take: rows of x, gy, B and C 16-byte
// multiples (P and N multiples of 8).
bool shapes_ok(const Args& a) { return a.P % 8 == 0 && a.N % 8 == 0; }

template <bool kDual>
cudaError_t launch(int pass, const Args& a, cudaStream_t s) {
  if (pass == 1) {
    const dim3 grid(a.H, a.B);
    if (kDual) ssd::tangent_pass_kernel<<<grid, ssd::kPassThreads, 0, s>>>(a);
    else ssd::pass_kernel<<<grid, ssd::kPassThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (pass == 3)
    return run(kDual ? tangent_finish_kernel : finish_kernel,
               dim3((unsigned)((32LL * a.B * a.H * a.nc + 127) / 128)), 128,
               0, s, a);
  if (pass == 4) {
    const long long n = 2LL * a.B * a.L * a.G * a.N +
                        (a.a_per_seq ? (long long)a.B * a.H : a.H);
    const long long blocks = (n + 255) / 256;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    return run(kDual ? tangent_reduce_kernel : reduce_kernel,
               dim3((unsigned)blocks), 256, 0, s, a);
  }
  if (pass != 0 && pass != 2 && pass != 5) return cudaErrorInvalidValue;
  if (!shapes_ok(a)) return cudaErrorInvalidValue;
  HArgs ha;
  ha.a = a;
  const long long bnc = (long long)a.B * a.nc;
  const int pls = kDual ? 2 : 1;
  for (int pl = 0; pl < pls; ++pl) {
    if (!map_rows(&ha.tx[pl], a.p[2 * ssd::X + pl], a.P, a.H, a.cs, bnc) ||
        !map_rows(&ha.tgy[pl], a.p[2 * ssd::GY + pl], a.P, a.H, a.cs, bnc) ||
        !map_rows(&ha.tb[pl], a.p[2 * ssd::BM + pl], a.N, a.G, a.cs, bnc) ||
        !map_rows(&ha.tc[pl], a.p[2 * ssd::CM + pl], a.N, a.G, a.cs, bnc))
      return cudaErrorInvalidValue;
  }
  if (!kDual) {                      // unused tangent maps: copies
    ha.tx[1] = ha.tx[0];
    ha.tgy[1] = ha.tgy[0];
    ha.tb[1] = ha.tb[0];
    ha.tc[1] = ha.tc[0];
  }
  const int nt = (a.cs + kM - 1) / kM;
  if (pass == 0)
    return run(kDual ? tangent_state_kernel : state_kernel,
               dim3(a.H, a.nc, a.B), 2 * kWG, StateLay<kDual>::kBytes, s, ha);
  if (pass == 5)
    return run(kDual ? tangent_gram_kernel : gram_kernel,
               dim3(pairs(nt), a.G, (unsigned)bnc), kWG,
               1024 + (kDual ? 2 : 1) * 4 * kRegion + 64, s, ha);
  return run(kDual ? tangent_chunk_kernel : chunk_kernel,
             dim3(a.H, a.nc, a.B), ChunkLay<kDual>::kWGs * kWG,
             ChunkLay<kDual>::kBytes, s, ha);
}

}  // namespace hbw

// ==========================================================================
// float32 on Hopper's tensor cores (namespace tbw)
// ==========================================================================
//
// hbw's design with every product as three TF32 mma.sync products
// (tf32x3.cuh: m16n8k8, float32 accumulators, each float32 operand split
// into hi = tf32(x) and lo = x - hi as it is loaded into a fragment; about
// 21 bits of each operand, where one TF32 product keeps 11 and misses the
// float32 tolerance).  Why mma.sync and not wgmma: wgmma reads TF32 from
// shared memory only K-major, and dx = M^T gy, dB = Z^T C, dC = Z B, the
// states' S = (u x)^T B and the entering term gy s_in all contract over the
// rows of a row-major tile; mma.sync's fragments are loaded by each lane in
// either orientation from plain float32 tiles (rows padded by 4 words), so
// nothing is staged twice.  The kernels are templates on kDual: the
// backward (kDual false, the kernels' plain names) carries values, the
// tangent (kDual true, the tangent_* names) dual numbers, of which it
// accumulates only the tangents of dx, dB and dC.  Six launches, in order
// (pass ids of the C entry in brackets):
//   state  [0] one block (8 warps) a (b, chunk, h): warp scan of seg (and
//              seg', hbw's), then S (S') with warps 0-3 and Lc (Lc') with
//              4-7, each warp 16 rows of P by all 128 columns of N, the
//              chunk's rows streamed in 32-row tiles by cp.async.
//   pass   [1] ssd::pass_kernel (ssd::tangent_pass_kernel).
//   gram   [5] one block a (b, chunk, group, pair of a 64-row key tile k
//              and a 32-row query tile q that meets k <= q): G^T = B_k C_q^T
//              (and G'^T), once for all the group's heads, written in the
//              chunk kernel's fragment order (each thread's 8 values).
//   chunk  [2] one block (8 warps) a (b, chunk, h): the entering-state term
//              of each query tile (dC = e_q gy_q s_in into the per-head
//              scratch, its row sums), then for each key tile its state
//              terms (dx = u_k gO B_k, dB = u_k gO^T x_k) and the walk over
//              the query tiles q >= k: D^T = x_k gy_q^T, the per-element
//              work once (M, Z into shared memory, the R sums), then dx +=
//              M^T gy and dB += Z^T C (registers, warp (rows, half) owning
//              16 key rows by half of the columns) and dC_q += Z B_k (its
//              partial sum read from and written back to the scratch, the
//              same thread each pair).  The tangent does the same on dual
//              numbers: D', M', Z' beside, dx' += M'^T gy + M^T gy' and so
//              on, the value planes M, Z formed once and read by both
//              products.
//   finish [3] and reduce [4]: ssd's bodies under this namespace's names.
// Every pair's products go into fresh accumulators added to the totals in
// float32 (the tensor core's accumulation rounds toward zero).  The
// per-element work is branch-free: the exponent is masked to -inf before
// the exponential.  Sums run in fixed orders, without atomics.
//
// Shared memory of the chunk kernel: the key tile's x (64 x 68 floats) and
// B (64 x 132); the query tile's gy (32 x 68) and C (32 x 132) and the
// planes M, Z (64 x 36), where gO (64 x 132) also lands before each key
// tile's walk (and s_in in the key tile's place before the first); the
// tangent holds each twice (x, x', ...; M, Z, M', Z').  The backward's
// 104,448 bytes leave room for two blocks an SM, the tangent's 206,848 for
// one.
//
// What bounds it.  At the mamba2 training shape (B = 8, L = 512, H = 24, P
// = 64, N = 128, G = 1, chunk 256) the backward's least work is 17.9 GFLOP
// at the float32 rate, 0.267 ms at 67 TFLOP/s, as three TF32 products
// 0.108 ms at 495 TFLOP/s, its bytes ~55 MB (0.017 ms); the tangent's
// 53.7 GFLOP, 0.80 ms, as three TF32 products 0.33 ms, its bytes ~150 MB
// (chip_smoke.py::ssd_bwd_cost).  Operations bind.  This design forms the
// causal pairs by whole 64 x 32 tiles and reads dC's partial sums through
// L2.
namespace tbw {

using namespace ssd;
using namespace tf32x3;
using hbw::ptr;

constexpr int kThreads = 256;                   // 8 warps
constexpr int kKT = 64;                         // rows of a key tile
constexpr int kQT = 32;                         // rows of a query tile
constexpr int kLdP = kMaxP + 4;                 // row strides of the tiles
constexpr int kLdN = kMaxN + 4;
constexpr int kLdQ = kQT + 4;
constexpr int kGramTile = kKT * kQT;            // floats of a G tile
// blocks an SM the backward's state and chunk kernels are compiled for
// (registers: 128 a thread at two)
constexpr int kBwdBlocks = 2;

// The pairs (key tile kt, query tile qt >= 2 kt) in order: the first of key
// tile kt, and all of a chunk.
__host__ __device__ constexpr int pair_start(int kt, int nq) {
  return kt * nq - kt * (kt - 1);
}
__host__ __device__ constexpr int npairs(int cs) {
  return pair_start(ceil_div(cs, kKT), ceil_div(cs, kQT));
}

// A value (kDual false) or a dual number from its two planes: v[i], and
// t[i] in dual only (t is not read otherwise); what an output keeps of
// one (the value in the backward, the tangent in the tangent); its value.
template <bool kDual>
__device__ __forceinline__ Num<kDual> num(float v, float t) {
  if constexpr (kDual) return Dual{v, t};
  else return v;
}
template <bool kDual>
__device__ __forceinline__ Num<kDual> ld(const float* v, const float* t,
                                         int i) {
  if constexpr (kDual) return Dual{v[i], t[i]};
  else return v[i];
}
__device__ __forceinline__ float out_of(float x) { return x; }
__device__ __forceinline__ float out_of(Dual x) { return x.t; }
__device__ __forceinline__ float val_of(float x) { return x; }
__device__ __forceinline__ float val_of(Dual x) { return x.v; }

// --------------------------------------------------------------------------
// state: S = (u x)^T B and Lc = (e gy)^T C (and their tangents)
// --------------------------------------------------------------------------

template <bool kDual> struct StateLay {         // floats
  static constexpr int kP = kDual ? 2 : 1;      // planes
  static constexpr int oA = 0;                  // x (x'), gy (gy') (32 x kLdP)
  static constexpr int oY = 2 * kP * kQT * kLdP;    // B (B'), C (C')
  static constexpr int oDT = oY + 2 * kP * kQT * kLdN;  // dt (dt')
  static constexpr int oSEG = oDT + kP * kMaxChunk;     // seg (seg')
  static constexpr int oSC = oSEG + kP * kMaxChunk;     // u (u'), e (e')
  static constexpr size_t kBytes =
      sizeof(float) * (oSC + 2 * kP * kMaxChunk);
};

template <bool kDual>
__device__ __forceinline__ void state_body(const Args& a) {
  using L = StateLay<kDual>;
  using T = Num<kDual>;
  constexpr int kP = L::kP;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31,
            g = lane >> 2, t = lane & 3;
  const int which = w >> 2, rg = w & 3;          // 0: S, 1: Lc; 16 rows of P
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int cs = a.cs, H = a.H, P = a.P, N = a.N;
  const int grp = h / (H / a.G);
  const long long row0 = (long long)b * a.L + (long long)c * cs;
  const long long sbase = ((long long)b * H + h) * a.L + (long long)c * cs;
  float* dtv = sm + L::oDT;
  float* segv = sm + L::oSEG;
  float* sc = sm + L::oSC;
  for (int i = tid; i < kMaxChunk; i += kThreads) {
    const bool in = i < cs;
#pragma unroll
    for (int pl = 0; pl < kP; ++pl)
      dtv[pl * kMaxChunk + i] =
          in ? ptr<const float>(a, DT, pl)[(row0 + i) * H + h] : 0.f;
  }
  __syncthreads();
  if (w == 0)
    hbw::cumsum<kDual>(
        dtv, dtv + kMaxChunk, ptr<const float>(a, AA, 0)[b * a.a_stride + h],
        kDual ? ptr<const float>(a, AA, 1)[b * a.ta_stride + h] : 0.f, segv,
        segv + kMaxChunk, cs, lane);
  __syncthreads();
  // u_k = exp(seg_end - seg_k) dt_k and e_k = exp(seg_k), zero past the
  // chunk; seg (and seg') out
  const T end = ld<kDual>(segv, segv + kMaxChunk, cs - 1);
  for (int i = tid; i < kMaxChunk; i += kThreads) {
    T u{}, e{};
    if (i < cs) {
      const T sg = ld<kDual>(segv, segv + kMaxChunk, i);
      u = dexp(end - sg) * ld<kDual>(dtv, dtv + kMaxChunk, i);
      e = dexp(sg);
      ptr<float>(a, SEG, 0)[sbase + i] = val_of(sg);
      if constexpr (kDual) ptr<float>(a, SEG, 1)[sbase + i] = sg.t;
    }
    sc[i] = val_of(u);
    sc[kP * kMaxChunk + i] = val_of(e);
    if constexpr (kDual) {
      sc[kMaxChunk + i] = u.t;
      sc[3 * kMaxChunk + i] = e.t;
    }
  }

  float acc[kMaxN / 8][4] = {}, tacc[kMaxN / 8][4] = {};
  const float* sA = sm + L::oA + which * kP * kQT * kLdP;  // x or gy
  const float* sTA = sA + kQT * kLdP;                      // its tangent
  const float* sY = sm + L::oY + which * kP * kQT * kLdN;  // B or C
  const float* sTY = sY + kQT * kLdN;
  const int p0 = 16 * rg;
  for (int k0 = 0; k0 < cs; k0 += kQT) {
    __syncthreads();                     // the last tile is read
#pragma unroll
    for (int pl = 0; pl < kP; ++pl) {
      stage(sm + L::oA + pl * kQT * kLdP, kLdP, ptr<const float>(a, X, pl),
            row0, H, h, P, kMaxP, k0, kQT, cs);
      stage(sm + L::oA + (kP + pl) * kQT * kLdP, kLdP,
            ptr<const float>(a, GY, pl), row0, H, h, P, kMaxP, k0, kQT, cs);
      stage(sm + L::oY + pl * kQT * kLdN, kLdN, ptr<const float>(a, BM, pl),
            row0, a.G, grp, N, kMaxN, k0, kQT, cs);
      stage(sm + L::oY + (kP + pl) * kQT * kLdN, kLdN,
            ptr<const float>(a, CM, pl), row0, a.G, grp, N, kMaxN, k0, kQT,
            cs);
    }
    cp_async_wait();
    __syncthreads();
    const float* s = sc + which * kP * kMaxChunk + k0;     // u or e
    const float* st = s + kMaxChunk;                        // its tangent
#pragma unroll 1
    for (int kk = 0; kk < kQT / 8; ++kk) {
      // A[p][k] = s_k X[k][p] (and A' = s'_k X[k][p] + s_k X'[k][p]): the
      // tile read transposed
      const FragA A = frag_a(
          [&](int r, int cc) {
            const int k = 8 * kk + cc;
            return s[k] * sA[k * kLdP + p0 + r];
          },
          g, t);
      FragA TA;
      if constexpr (kDual)
        TA = frag_a(
            [&](int r, int cc) {
              const int k = 8 * kk + cc;
              return st[k] * sA[k * kLdP + p0 + r] +
                     s[k] * sTA[k * kLdP + p0 + r];
            },
            g, t);
#pragma unroll
      for (int j = 0; j < kMaxN / 8; ++j) {
        const FragB Bv = rows_b(sY, kLdN, 8 * kk, 8 * j, g, t);
        mma3(acc[j], A, Bv);
        if constexpr (kDual) {
          const FragB TB = rows_b(sTY, kLdN, 8 * kk, 8 * j, g, t);
          mma3(tacc[j], TA, Bv);
          mma3(tacc[j], A, TB);
        }
      }
    }
  }
  const long long obase = (((long long)b * a.nc + c) * H + h) * P * N;
  float* out = ptr<float>(a, which ? LC : SS, 0) + obase;
  float* outt = kDual ? ptr<float>(a, which ? LC : SS, 1) + obase : nullptr;
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      if (p < P && n < N) {
        out[p * N + n] = acc[j][e];
        if constexpr (kDual) outt[p * N + n] = tacc[j][e];
      }
    }
}

// --------------------------------------------------------------------------
// gram: G^T = B_k C_q^T (and its tangent) for each pair, once per group
// --------------------------------------------------------------------------

template <bool kDual>
constexpr size_t gram_smem() {
  return sizeof(float) * (kDual ? 2 : 1) * (kKT + kQT) * kLdN;
}

template <bool kDual>
__device__ __forceinline__ void gram_body(const Args& a) {
  constexpr int kP = kDual ? 2 : 1;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31,
            g = lane >> 2, t = lane & 3;
  const int rg = w & 3, hf = w >> 2;
  const int pi = blockIdx.x, grp = blockIdx.y, bc = blockIdx.z;
  const int cs = a.cs, nk = ceil_div(cs, kKT), nq = ceil_div(cs, kQT);
  int kt = 0;
  while (kt + 1 < nk && pair_start(kt + 1, nq) <= pi) ++kt;
  const int qt = 2 * kt + pi - pair_start(kt, nq);
  const long long row0 =
      (long long)(bc / a.nc) * a.L + (long long)(bc % a.nc) * cs;
  float* sB = sm;                                // B (B') (64 rows)
  float* sC = sm + kP * kKT * kLdN;              // C (C') (32 rows)
#pragma unroll
  for (int pl = 0; pl < kP; ++pl) {
    stage(sB + pl * kKT * kLdN, kLdN, ptr<const float>(a, BM, pl), row0, a.G,
          grp, a.N, kMaxN, kt * kKT, kKT, cs);
    stage(sC + pl * kQT * kLdN, kLdN, ptr<const float>(a, CM, pl), row0, a.G,
          grp, a.N, kMaxN, qt * kQT, kQT, cs);
  }
  cp_async_wait();
  __syncthreads();
  // warp (rg, hf): key rows 16 rg .., query columns 16 hf ..
  float d[2][4] = {}, dd[2][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < kMaxN / 8; ++kk) {
    const FragA A = rows_a(sB, kLdN, 16 * rg, 8 * kk, g, t);
    FragA TA;
    if constexpr (kDual)
      TA = rows_a(sB + kKT * kLdN, kLdN, 16 * rg, 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const FragB Bv = cols_b(sC, kLdN, 8 * kk, 16 * hf + 8 * j, g, t);
      mma3(d[j], A, Bv);
      if constexpr (kDual) {
        const FragB TB =
            cols_b(sC + kQT * kLdN, kLdN, 8 * kk, 16 * hf + 8 * j, g, t);
        mma3(dd[j], TA, Bv);
        mma3(dd[j], A, TB);
      }
    }
  }
  const long long at =
      (((long long)bc * a.G + grp) * npairs(cs) + pi) * kGramTile + tid * 8;
  float4* out = reinterpret_cast<float4*>(ptr<float>(a, GRAM, 0) + at);
  float4* outt = kDual ? reinterpret_cast<float4*>(ptr<float>(a, GRAM, 1)
                                                   + at)
                       : nullptr;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    out[j] = make_float4(d[j][0], d[j][1], d[j][2], d[j][3]);
    if constexpr (kDual)
      outt[j] = make_float4(dd[j][0], dd[j][1], dd[j][2], dd[j][3]);
  }
}

// --------------------------------------------------------------------------
// chunk: dx, dB, dC and the R sums of a (b, chunk, h); in the tangent dx',
// dB', dC' and the R sums' values and tangents
// --------------------------------------------------------------------------

template <bool kDual> struct ChunkLay {         // floats
  static constexpr int kP = kDual ? 2 : 1;      // planes
  static constexpr int oX = 0;                  // x (x') (kKT x kLdP)
  static constexpr int oB = kP * kKT * kLdP;    // B (B') (kKT x kLdN)
  static constexpr int kKey = oB + kP * kKT * kLdN;
  static constexpr int oSIN = 0;                // s_in (s_in') over the key
  static constexpr int oGY = kKey;              // gy (gy') (kQT x kLdP)
  static constexpr int oC = oGY + kP * kQT * kLdP;  // C (C') (kQT x kLdN)
  static constexpr int oPL = oC + kP * kQT * kLdN;  // M, Z (M', Z')
  static constexpr int kLoop = oPL + 2 * kP * kKT * kLdQ - kKey;
  static constexpr int oST = kKey;              // gO (gO') over the loop
  static constexpr int oSEG = kKey + kLoop;     // seg (seg')
  static constexpr int oDT = oSEG + kP * kMaxChunk;  // dt (dt')
  static constexpr int oROWR = oDT + kP * kMaxChunk;  // [planes][4 warps][cs]
  static constexpr int oDSQ = oROWR + 4 * kP * kMaxChunk;  // entering dseg_q
  static constexpr int oXCH = oDSQ + kP * kMaxChunk;  // sums between warps
  static constexpr size_t kBytes = sizeof(float) * (oXCH + 512);
  static_assert(kP * kMaxP * kLdN <= kKey, "s_in fits the key tile's place");
  static_assert(kP * kMaxP * kLdN <= kLoop, "gO fits the loop's place");
};

template <bool kDual>
__device__ __forceinline__ void chunk_body(const Args& a) {
  using L = ChunkLay<kDual>;
  using T = Num<kDual>;
  constexpr int kP = L::kP, out = kDual ? 1 : 0;   // the outputs' plane
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31,
            g = lane >> 2, t = lane & 3;
  // the walk's roles: key rows 16 rg .. of the key tile, half hf of the
  // columns (query columns of a pair, p of dx, n of dB)
  const int rg = w & 3, hf = w >> 2;
  // dC and the entering term: query rows qr .. of a tile, columns n nn ..
  const int qr = 16 * (w & 1), nn = 32 * (w >> 1);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int cs = a.cs, H = a.H, P = a.P, N = a.N, G = a.G;
  const int grp = h / (H / G), bc = b * a.nc + c;
  const int nk = ceil_div(cs, kKT), nq = ceil_div(cs, kQT);
  const long long row0 = (long long)b * a.L + (long long)c * cs;
  const long long sbase = ((long long)b * H + h) * a.L + (long long)c * cs;
  const long long obase = ((long long)bc * H + h) * P * N;
  const long long gbase = ((long long)bc * G + grp) * npairs(cs);
  float* segv = sm + L::oSEG;
  float* dtv = sm + L::oDT;
  float* rowr = sm + L::oROWR;
  float* dsqs = sm + L::oDSQ;
  float* xch = sm + L::oXCH;
  const float *sX = sm + L::oX, *sTX = sX + kKT * kLdP;
  const float *sB = sm + L::oB, *sTB = sB + kKT * kLdN;
  const float *sGY = sm + L::oGY, *sTGY = sGY + kQT * kLdP;
  const float *sC = sm + L::oC, *sTC = sC + kQT * kLdN;
  float* plM = sm + L::oPL;
  float* plZ = plM + kKT * kLdQ;
  float* plTM = plZ + kKT * kLdQ;
  float* plTZ = plTM + kKT * kLdQ;
  float* dCh = ptr<float>(a, DCH, out);
  auto seg_at = [&](int i) { return ld<kDual>(segv, segv + kMaxChunk, i); };
  auto dt_at = [&](int i) { return ld<kDual>(dtv, dtv + kMaxChunk, i); };
  auto dc_at = [&](int q, int n) {
    return ((row0 + q) * H + h) * (long long)N + n;
  };
  auto stage_q = [&](int qt) {
#pragma unroll
    for (int pl = 0; pl < kP; ++pl) {
      stage(sm + L::oGY + pl * kQT * kLdP, kLdP, ptr<const float>(a, GY, pl),
            row0, H, h, P, kMaxP, qt * kQT, kQT, cs);
      stage(sm + L::oC + pl * kQT * kLdN, kLdN, ptr<const float>(a, CM, pl),
            row0, G, grp, N, kMaxN, qt * kQT, kQT, cs);
    }
  };
  // the (P, N) state `slot` (and its tangent) at `at`, zero to 64 x 128
  auto stage_state = [&](int slot, int at) {
#pragma unroll
    for (int pl = 0; pl < kP; ++pl)
      stage(sm + at + pl * kMaxP * kLdN, kLdN,
            ptr<const float>(a, slot, pl) + obase, 0, 1, 0, N, kMaxN, 0,
            kMaxP, P);
  };

  for (int i = tid; i < kMaxChunk; i += kThreads) {
    const bool in = i < cs;
#pragma unroll
    for (int pl = 0; pl < kP; ++pl) {
      segv[pl * kMaxChunk + i] =
          in ? ptr<const float>(a, SEG, pl)[sbase + i] : 0.f;
      dtv[pl * kMaxChunk + i] =
          in ? ptr<const float>(a, DT, pl)[(row0 + i) * H + h] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) rowr[(4 * pl + r) * kMaxChunk + i] = 0.f;
    }
  }
  stage_state(SIN, L::oSIN);

  // the entering state's term of each query tile: dC_q = e_q gy_q s_in (in
  // the tangent its tangent) into dCh, e_q C_q . (gy_q s_in) (value, and
  // tangent in the tangent) into dsqs
  {
    const float *sIN = sm + L::oSIN, *sTIN = sIN + kMaxP * kLdN;
    for (int qt = 0; qt < nq; ++qt) {
      __syncthreads();                   // the last tile and xch are read
      stage_q(qt);
      cp_async_wait();
      __syncthreads();
      float wv[4][4] = {}, wt[4][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kMaxP / 8; ++kk) {
        const FragA A = rows_a(sGY, kLdP, qr, 8 * kk, g, t);
        FragA TA;
        if constexpr (kDual) TA = rows_a(sTGY, kLdP, qr, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const FragB Bv = rows_b(sIN, kLdN, 8 * kk, nn + 8 * j, g, t);
          mma3(wv[j], A, Bv);
          if constexpr (kDual) {
            const FragB TB = rows_b(sTIN, kLdN, 8 * kk, nn + 8 * j, g, t);
            mma3(wt[j], TA, Bv);
            mma3(wt[j], A, TB);
          }
        }
      }
      T rs[2] = {}, eq[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qt * kQT + qr + g + 8 * r;
        eq[r] = q < cs ? dexp(seg_at(q)) : T{};
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, row = qr + g + 8 * r;
          const int n = nn + 8 * j + 2 * t + (e & 1), q = qt * kQT + row;
          const T wd = num<kDual>(wv[j][e], wt[j][e]);
          rs[r] += ld<kDual>(sC, sTC, row * kLdN + n) * wd;
          if (q < cs && n < N) dCh[dc_at(q, n)] = out_of(eq[r] * wd);
        }
      // the four column groups' row sums, added in order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] = quad_sum(rs[r]);
        if (t == 0) {
          xch[(w >> 1) * kQT + qr + g + 8 * r] = val_of(rs[r]);
          if constexpr (kDual)
            xch[(4 + (w >> 1)) * kQT + qr + g + 8 * r] = rs[r].t;
        }
      }
      __syncthreads();
      if (tid < kQT) {
        const int q = qt * kQT + tid;
        T s{};
#pragma unroll
        for (int cg = 0; cg < 4; ++cg)
          s += ld<kDual>(xch + cg * kQT, xch + (4 + cg) * kQT, tid);
        if (q < cs) {
          const T v = dexp(seg_at(q)) * s;
          dsqs[q] = val_of(v);
          if constexpr (kDual) dsqs[kMaxChunk + q] = v.t;
        }
      }
    }
  }

  const T seg_end = seg_at(cs - 1);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();                     // the key and loop places are read
#pragma unroll
    for (int pl = 0; pl < kP; ++pl) {
      stage(sm + L::oX + pl * kKT * kLdP, kLdP, ptr<const float>(a, X, pl),
            row0, H, h, P, kMaxP, kt * kKT, kKT, cs);
      stage(sm + L::oB + pl * kKT * kLdN, kLdN, ptr<const float>(a, BM, pl),
            row0, G, grp, N, kMaxN, kt * kKT, kKT, cs);
    }
    stage_state(GO, L::oST);
    cp_async_wait();
    __syncthreads();
    // this thread's two key rows (r = 0, 1): 16 rg + g and + 8
    T segk[2], dtk[2], wk[2], ukk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = kt * kKT + 16 * rg + g + 8 * r;
      const bool in = k < cs;
      segk[r] = seg_at(in ? k : 0);
      dtk[r] = in ? dt_at(k) : T{};
      wk[r] = in ? dexp(seg_end - segk[r]) : T{};
      ukk[r] = wk[r] * dtk[r];
    }
    // the state leaving the chunk: dx = u_k gO B_k (columns p 32 hf ..) and
    // dB = u_k gO^T x_k (columns n 64 hf ..), in the tangent their tangents
    const float *sGO = sm + L::oST, *sTGO = sGO + kMaxP * kLdN;
    float accX[4][4], accB[8][4];
    T xv[2] = {};
    {
      float v[4][4] = {}, vt[4][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kMaxN / 8; ++kk) {
        const FragA A = rows_a(sB, kLdN, 16 * rg, 8 * kk, g, t);
        FragA TA;
        if constexpr (kDual) TA = rows_a(sTB, kLdN, 16 * rg, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const FragB Bv = cols_b(sGO, kLdN, 8 * kk, 32 * hf + 8 * j, g, t);
          mma3(v[j], A, Bv);
          if constexpr (kDual) {
            const FragB TB =
                cols_b(sTGO, kLdN, 8 * kk, 32 * hf + 8 * j, g, t);
            mma3(vt[j], TA, Bv);
            mma3(vt[j], A, TB);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, row = 16 * rg + g + 8 * r;
          const int p = 32 * hf + 8 * j + 2 * t + (e & 1);
          const T vv = num<kDual>(v[j][e], vt[j][e]);
          xv[r] += ld<kDual>(sX, sTX, row * kLdP + p) * vv;
          accX[j][e] = out_of(ukk[r] * vv);
        }
    }
    {
      float wv[8][4] = {}, wt[8][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kMaxP / 8; ++kk) {
        const FragA A = rows_a(sX, kLdP, 16 * rg, 8 * kk, g, t);
        FragA TA;
        if constexpr (kDual) TA = rows_a(sTX, kLdP, 16 * rg, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const FragB Bv = rows_b(sGO, kLdN, 8 * kk, 64 * hf + 8 * j, g, t);
          mma3(wv[j], A, Bv);
          if constexpr (kDual) {
            const FragB TB =
                rows_b(sTGO, kLdN, 8 * kk, 64 * hf + 8 * j, g, t);
            mma3(wt[j], TA, Bv);
            mma3(wt[j], A, TB);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          accB[j][e] = out_of(ukk[e >> 1] * num<kDual>(wv[j][e], wt[j][e]));
    }
    T colR[2] = {}, direct[2] = {};

    for (int qt = 2 * kt; qt < nq; ++qt) {
      __syncthreads();                   // gO, or the last pair, is read
      stage_q(qt);
      // G (and G') of the pair: this thread's 8 values, in the gram
      // kernel's order
      const long long gat =
          (gbase + pair_start(kt, nq) + qt - 2 * kt) * kGramTile + tid * 8;
      const float4* g4 = reinterpret_cast<const float4*>(
          ptr<const float>(a, GRAM, 0) + gat);
      const float4 ga = g4[0], gb = g4[1];
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      float gt[8] = {};
      if constexpr (kDual) {
        const float4* gt4 = reinterpret_cast<const float4*>(
            ptr<const float>(a, GRAM, 1) + gat);
        const float4 ta = gt4[0], tb = gt4[1];
        const float gtv[8] = {ta.x, ta.y, ta.z, ta.w,
                              tb.x, tb.y, tb.z, tb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) gt[i] = gtv[i];
      }
      cp_async_wait();
      __syncthreads();
      // D^T = x_k gy_q^T (and D'^T): the warp's 16 key rows by 16 columns q
      float d[2][4] = {}, dd[2][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kMaxP / 8; ++kk) {
        const FragA A = rows_a(sX, kLdP, 16 * rg, 8 * kk, g, t);
        FragA TA;
        if constexpr (kDual) TA = rows_a(sTX, kLdP, 16 * rg, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const FragB Bv = cols_b(sGY, kLdP, 8 * kk, 16 * hf + 8 * j, g, t);
          mma3(d[j], A, Bv);
          if constexpr (kDual) {
            const FragB TB =
                cols_b(sTGY, kLdP, 8 * kk, 16 * hf + 8 * j, g, t);
            mma3(dd[j], TA, Bv);
            mma3(dd[j], A, TB);
          }
        }
      }
      // M^T, Z^T (rows k, columns q) (and their tangents) into the planes;
      // the R sums.  Branch-free: the exponent is masked to -inf where the
      // pair is out (k > q, or past the chunk), so E = 0 there.
      T cols[2][2] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, u = e & 1;
          const int row = 16 * rg + g + 8 * r;
          const int col = 16 * hf + 8 * j + 2 * t + u;
          const int k = kt * kKT + row, q = qt * kQT + col;
          const bool in = k < cs && q < cs && k <= q;
          const T E = dexp(in ? seg_at(q) - segk[r]
                              : num<kDual>(-INFINITY, 0.f));
          const T GE = num<kDual>(gv[4 * j + e], gt[4 * j + e]) * E;
          const T Dv = num<kDual>(d[j][e], dd[j][e]);
          const T M = GE * dtk[r];
          const T Z = Dv * E * dtk[r];
          direct[r] += Dv * GE;
          // the diagonal is left out of R's sums: see finish_body
          const T R = k < q ? Dv * M : T{};
          colR[r] += R;
          cols[j][u] += R;
          plM[row * kLdQ + col] = val_of(M);
          plZ[row * kLdQ + col] = val_of(Z);
          if constexpr (kDual) {
            plTM[row * kLdQ + col] = M.t;
            plTZ[row * kLdQ + col] = Z.t;
          }
        }
      // the columns' sums over the warp's 16 rows, added to its vector
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          T s = cols[j][u];
          s += shfl_xor(s, 4);
          s += shfl_xor(s, 8);
          s += shfl_xor(s, 16);
          const int q = qt * kQT + 16 * hf + 8 * j + 2 * t + u;
          if (lane < 4 && q < cs) {
            rowr[rg * kMaxChunk + q] += val_of(s);
            if constexpr (kDual) rowr[(4 + rg) * kMaxChunk + q] += s.t;
          }
        }
      __syncthreads();                   // the planes are written
      {                        // dx += M^T gy (dx' += M'^T gy + M^T gy')
        float tx[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kQT / 8; ++kk) {
          const FragA A1 =
              rows_a(kDual ? plTM : plM, kLdQ, 16 * rg, 8 * kk, g, t);
          FragA A2;
          if constexpr (kDual) A2 = rows_a(plM, kLdQ, 16 * rg, 8 * kk, g, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma3(tx[j], A1, rows_b(sGY, kLdP, 8 * kk, 32 * hf + 8 * j, g, t));
            if constexpr (kDual)
              mma3(tx[j], A2,
                   rows_b(sTGY, kLdP, 8 * kk, 32 * hf + 8 * j, g, t));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) accX[j][e] += tx[j][e];
      }
      {                        // dB += Z^T C (dB' += Z'^T C + Z^T C')
        float tb[8][4] = {};
#pragma unroll
        for (int kk = 0; kk < kQT / 8; ++kk) {
          const FragA A1 =
              rows_a(kDual ? plTZ : plZ, kLdQ, 16 * rg, 8 * kk, g, t);
          FragA A2;
          if constexpr (kDual) A2 = rows_a(plZ, kLdQ, 16 * rg, 8 * kk, g, t);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            mma3(tb[j], A1, rows_b(sC, kLdN, 8 * kk, 64 * hf + 8 * j, g, t));
            if constexpr (kDual)
              mma3(tb[j], A2,
                   rows_b(sTC, kLdN, 8 * kk, 64 * hf + 8 * j, g, t));
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) accB[j][e] += tb[j][e];
      }
      {                        // dC_q += Z B_k (dC' += Z' B + Z B')
        float tc[4][4] = {};
#pragma unroll 2
        for (int kk = 0; kk < kKT / 8; ++kk) {
          const FragA A1 = cols_a(kDual ? plTZ : plZ, kLdQ, qr, 8 * kk, g, t);
          FragA A2;
          if constexpr (kDual) A2 = cols_a(plZ, kLdQ, qr, 8 * kk, g, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma3(tc[j], A1, rows_b(sB, kLdN, 8 * kk, nn + 8 * j, g, t));
            if constexpr (kDual)
              mma3(tc[j], A2, rows_b(sTB, kLdN, 8 * kk, nn + 8 * j, g, t));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = qt * kQT + qr + g + 8 * (e >> 1);
            const int n = nn + 8 * j + 2 * t + (e & 1);
            if (q < cs && n < N) dCh[dc_at(q, n)] += tc[j][e];
          }
      }
    }

    // the key tile's outputs: dx, dB per head, and ddd, dsk, tk (their
    // values, and tangents in the tangent) from both halves' sums, the
    // second added to the first
    __syncthreads();                     // xch is free
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      colR[r] = quad_sum(colR[r]);
      direct[r] = quad_sum(direct[r]);
      xv[r] = quad_sum(xv[r]);
      if (hf == 1 && t == 0) {
        float* x6 = xch + 6 * (16 * rg + g + 8 * r);
        x6[0] = val_of(colR[r]);
        x6[2] = val_of(direct[r]);
        x6[4] = val_of(xv[r]);
        if constexpr (kDual) {
          x6[1] = colR[r].t;
          x6[3] = direct[r].t;
          x6[5] = xv[r].t;
        }
      }
    }
    __syncthreads();
    if (hf == 0 && t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = kt * kKT + 16 * rg + g + 8 * r;
        const float* x6 = xch + 6 * (16 * rg + g + 8 * r);
        colR[r] += ld<kDual>(x6, x6 + 1, 0);
        direct[r] += ld<kDual>(x6 + 2, x6 + 3, 0);
        xv[r] += ld<kDual>(x6 + 4, x6 + 5, 0);
        if (k < cs) {
          const T Tk = k < cs - 1 ? ukk[r] * xv[r] : T{};
          const T ddd = direct[r] + wk[r] * xv[r];
          const T dsk = T{} - colR[r] - Tk;
          ptr<float>(a, DDD, 0)[sbase + k] = val_of(ddd);
          ptr<float>(a, DSK, 0)[sbase + k] = val_of(dsk);
          ptr<float>(a, TK, 0)[sbase + k] = val_of(Tk);
          if constexpr (kDual) {
            ptr<float>(a, DDD, 1)[sbase + k] = ddd.t;
            ptr<float>(a, DSK, 1)[sbase + k] = dsk.t;
            ptr<float>(a, TK, 1)[sbase + k] = Tk.t;
          }
        }
      }
    float* dxo = ptr<float>(a, DX, out);
    float* dBh = ptr<float>(a, DBH, out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = kt * kKT + 16 * rg + g + 8 * (e >> 1);
      if (k >= cs) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 32 * hf + 8 * j + 2 * t + (e & 1);
        if (p < P) dxo[((row0 + k) * H + h) * P + p] = accX[j][e];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 64 * hf + 8 * j + 2 * t + (e & 1);
        if (n < N) dBh[((row0 + k) * H + h) * N + n] = accB[j][e];
      }
    }
  }
  // dseg of the query rows: R's row sums (the four warps' column sums) and
  // the entering state's term
  __syncthreads();
  for (int q = tid; q < cs; q += kThreads)
#pragma unroll
    for (int pl = 0; pl < kP; ++pl) {
      const float* rr = rowr + pl * 4 * kMaxChunk;
      ptr<float>(a, DSQ, pl)[sbase + q] =
          ((rr[q] + rr[kMaxChunk + q]) +
           (rr[2 * kMaxChunk + q] + rr[3 * kMaxChunk + q])) +
          dsqs[pl * kMaxChunk + q];
    }
}

// --------------------------------------------------------------------------
// kernels: the backward's under their plain names, the tangent's as
// tangent_*
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kBwdBlocks)
state_kernel(const Args a) {
  state_body<false>(a);
}
__global__ void __launch_bounds__(kThreads, 1)
tangent_state_kernel(const Args a) {
  state_body<true>(a);
}
__global__ void __launch_bounds__(kThreads) gram_kernel(const Args a) {
  gram_body<false>(a);
}
__global__ void __launch_bounds__(kThreads)
tangent_gram_kernel(const Args a) {
  gram_body<true>(a);
}
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
chunk_kernel(const Args a) {
  chunk_body<false>(a);
}
__global__ void __launch_bounds__(kThreads, 1)
tangent_chunk_kernel(const Args a) {
  chunk_body<true>(a);
}
__global__ void __launch_bounds__(128) finish_kernel(const Args a) {
  finish_body<false>(a);
}
__global__ void __launch_bounds__(128) tangent_finish_kernel(const Args a) {
  finish_body<true>(a);
}
__global__ void __launch_bounds__(256) reduce_kernel(const Args a) {
  reduce_body<float>(a, 0);
}
__global__ void __launch_bounds__(256) tangent_reduce_kernel(const Args a) {
  reduce_body<float>(a, 1);
}

using hbw::run;

template <bool kDual>
cudaError_t launch(int pass, const Args& a, cudaStream_t s) {
  switch (pass) {
    case 0:
      return run(kDual ? tangent_state_kernel : state_kernel,
                 dim3(a.H, a.nc, a.B), kThreads, StateLay<kDual>::kBytes, s,
                 a);
    case 1:
      return run(kDual ? tangent_pass_kernel : pass_kernel, dim3(a.H, a.B),
                 kPassThreads, 0, s, a);
    case 2:
      return run(kDual ? tangent_chunk_kernel : chunk_kernel,
                 dim3(a.H, a.nc, a.B), kThreads, ChunkLay<kDual>::kBytes, s,
                 a);
    case 3:
      return run(kDual ? tangent_finish_kernel : finish_kernel,
                 dim3((unsigned)((32LL * a.B * a.H * a.nc + 127) / 128)), 128,
                 0, s, a);
    case 4: {
      const long long n = 2LL * a.B * a.L * a.G * a.N +
                          (a.a_per_seq ? (long long)a.B * a.H : a.H);
      const long long blocks = (n + 255) / 256;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
      return run(kDual ? tangent_reduce_kernel : reduce_kernel,
                 dim3((unsigned)blocks), 256, 0, s, a);
    }
    case 5:
      return run(kDual ? tangent_gram_kernel : gram_kernel,
                 dim3(npairs(a.cs), a.G, (unsigned)((long long)a.B * a.nc)),
                 kThreads, gram_smem<kDual>(), s, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tbw



extern "C" {

int repro_ssd_bwd_slots() { return ssd::kSlots; }
int repro_ssd_bwd_max_head_dim() { return ssd::kMaxP; }
int repro_ssd_bwd_max_state() { return ssd::kMaxN; }
int repro_ssd_bwd_max_chunk() { return ssd::kMaxChunk; }

// One pass (0 state, 1 pass, 2 chunk, 3 finish, 4 reduce, 5 gram) of the
// backward (tangent 0) or of its tangent
// (tangent 1).  ptrs: repro_ssd_bwd_slots() device pointers, each tensor's
// value plane then its tangent plane, in the order of ssd::Slot; dtype 0
// float32 or 1 bfloat16 (x, gy, B, C, dx, dB, dC and their tangents; every
// other tensor float32).  dims: B, L, H,
// P, G, N, chunk, A's stride per sequence, A''s, and 1 where dA is (B, H).
// Tensors are contiguous; x, gy, dx (B, L, H, P), dt, ddt (B, L, H), B, C,
// dB, dC (B, L, G, N), gs (B, H, P, N); the rest as ../ops.py allocates.
int repro_ssd_bwd_launch(int pass, int tangent, int dtype,
                         void* const* ptrs, const long long* dims,
                         void* stream) {
  ssd::Args a{};
  for (int i = 0; i < ssd::kSlots; ++i) a.p[i] = ptrs[i];
  a.B = (int)dims[0]; a.L = (int)dims[1]; a.H = (int)dims[2];
  a.P = (int)dims[3]; a.G = (int)dims[4]; a.N = (int)dims[5];
  a.cs = (int)dims[6];
  a.a_stride = dims[7]; a.ta_stride = dims[8]; a.a_per_seq = (int)dims[9];
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.P <= 0 || a.G <= 0 ||
      a.N <= 0 || a.cs <= 0 || a.L % a.cs || a.H % a.G ||
      a.P > ssd::kMaxP || a.N > ssd::kMaxN || a.cs > ssd::kMaxChunk ||
      // the launches' grid limits (65535 in y and z): B * nc and G <= H
      // of the gram launches, nc and B of the others
      (long long)a.B * (a.L / a.cs) > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  a.nc = a.L / a.cs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ssd::DT_F32)
    return (int)(tangent ? tbw::launch<true>(pass, a, s)
                         : tbw::launch<false>(pass, a, s));
  if (dtype == ssd::DT_BF16)
    return (int)(tangent ? hbw::launch<true>(pass, a, s)
                         : hbw::launch<false>(pass, a, s));
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
