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
// forward and backward tangents (T1, T2) — no TPU counterpart: the
//   forward-mode rules of both autograd Functions, so that the exact
//   meta-gradient's forward-over-reverse Hessian-vector products run
//   through the kernels (bfloat16: namespace hop; float32: namespace tf32,
//   whose T1/T2 section's comment holds the algebra).
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
// float32 (namespace tf32, after hop): the forward, the backward, T1 and
// T2's two parts on the tensor cores, every float32 product as three TF32
// mma.sync products, on the same strided views as bf16 (K/V unexpanded).
// In bf16, T1 and T2 are hop's forward and backward blocks on dual numbers
// (three kernels after the backward's).
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

constexpr int kTile = 64;                 // query and key rows of a bf16 tile
constexpr int kMaxHeadDim = 128;
constexpr float kMasked = -1e30f;         // the reference's NEG_INF

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
//
// The tangents T1 and T2 (tangent_fwd_kernel, tangent_dq_kernel,
// tangent_dkv_kernel, after the backward) keep these numerics on dual
// numbers: S' and dP' are products of bf16 tiles like S and dP; P ⊙ S',
// P' = P (S' scale - lse'), dS and dS' stay float32 in registers and enter
// the products that take them as A as hi/lo pairs, as P and dS do; lse' =
// rowsum(P ⊙ S') is a float32 sum of those registers; D' = rowsum(dO' * O
// + dO * O') is the diagonal of dO' O^T + dO O'^T, as D.  They are bound by
// operations (at whisper's encoder shape, B = 16, 1500 x 1500, 20 heads of
// 64: T1 5.5e11 of them, 0.56 ms at 989 TFLOP/s; T2 1.1e12, 1.12 ms); the
// hi/lo pairs, and the dK'/dV' launch forming S, S', dP and dP' again, make
// the design's own floor 1.5x (T1) and 2x (T2) that.  T1 and T2's dQ' part
// keep the forward's and dQ's loop with a second accumulator; the dK'/dV'
// part holds two accumulators of 64 (d = 128) registers a thread, so each
// visited tile's work runs in sequence (S and S', then dV', dP, dK' from
// dS, dP', dK' from dS') to keep at most three 32-register tiles beside
// them.

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

// acc = A B^T over the head dim (add: acc += A B^T): A and B 64-row tiles
// at shared a and b.
template <int NH>
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a,
                                        uint32_t b, bool add = false) {
#pragma unroll
  for (int kk = 0; kk < 4 * NH; ++kk) {
    const uint32_t off = (kk >> 2) * kRegion + (kk & 3) * 32;
    wgmma_ss(acc, desc(a + off), desc(b + off), add || kk > 0);
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
// Every thread of the warpgroup (named barrier `group`) calls it.  A: Args
// or TArgs.
template <int NH, typename A>
__device__ __forceinline__ void write_tile(const float (&acc)[NH][32],
                                           uint32_t stage, const TileMap& m,
                                           bf16* dst, long long ld, int b,
                                           int h, int row0, int rows,
                                           const A& a, int t, int group) {
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
template <typename A>
__device__ __forceinline__ Band band(const A& a) {
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
template <bool kQueryRows, typename A>
__device__ __forceinline__ void probs(float (&s)[32], const float* L,
                                      float c, bool edge, int q0, int k0,
                                      const A& a, int t) {
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
// forward-mode tangents T1 and T2 (the algebra is in namespace tf32's
// T1/T2 section, near the end of this file): the forward's and the
// backward's blocks with dual accumulators.  Every product runs on wgmma;
// P, P ⊙ S', P', dS and dS' are float32 in registers and enter the
// products that take them as A as bf16 hi/lo pairs, as P and dS do above;
// lse' = rowsum(P ⊙ S') is a float32 sum of those registers, and D' =
// rowsum(dO' ⊙ O + dO ⊙ O') the diagonal of dO' O^T + dO O'^T on the
// tensor cores, as D.
// ---------------------------------------------------------------------------

// The 13 views of the tangent entries, in the entries' order.
enum TView { tQ = 0, tK, tV, tO, tDO, tTQ, tTK, tTV, tTO, tTDO, tTDQ, tTDK,
             tTDV, kTViews };

struct TArgs {
  TileMap m[kTViews];                   // the views a launch uses, tma = 1
  const bf16* p[kTViews];               // outputs written through const_cast
  Strides st[kTViews];
  const float* lse;                     // (B, H, S) float32, as the rest:
  float *tlse, *dsum, *tdsum;           // lse' (T1 writes it, T2 reads it),
  int H, KV, S, Sk, d;                  // D and D' (T2 part 0 writes them,
  float scale;                          // part 1 reads them)
  int causal, window;
  int tma;                              // 1: 16-byte aligned rows, d % 8 == 0
};

// Row 0 of head h of batch b of view v.
__device__ __forceinline__ const bf16* view(const TArgs& a, int v, int b,
                                            int h) {
  return a.p[v] + b * a.st[v].b + h * a.st[v].h;
}

// Rows [row0, row0 + 64) of head h of batch b of view v into the tile at
// dst: by TMA (thread 0; bar must expect the bytes) or element by element
// (all NT threads; rows past `rows` zero).
template <int NH, int NT>
__device__ __forceinline__ void load_view(uint32_t dst, const TArgs& a, int v,
                                          uint32_t bar, int b, int h,
                                          int row0, int rows, int tid) {
  if (a.tma) {
    if (tid == 0) tma_tile<NH>(dst, a.m[v], bar, b, h, row0);
  } else {
    copy_tile<NH, NT>(dst, view(a, v, b, h), a.st[v].s, row0, rows, a.d,
                      tid);
  }
}

// The tangent logits of the pairs outside the band to 0 on an edge tile:
// the reference masks the logit, whose tangent is then 0 (pairs past the
// sequence ends have P = 0 and need nothing).
template <bool kQueryRows>
__device__ __forceinline__ void band_zero(float (&sd)[32], bool edge, int q0,
                                          int k0, const TArgs& a, int t) {
  if (!edge) return;
  const int r0 = frag_row(0, t), c0 = frag_col(0, t);
  const int delta0 = (q0 + (kQueryRows ? r0 : c0)) -
                     (k0 + (kQueryRows ? c0 : r0));
  const Band bd = band(a);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int delta = delta0 + (kQueryRows ? rofs(e) - cofs(e)
                                           : cofs(e) - rofs(e));
    if (delta < bd.lo || delta > bd.hi) sd[e] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// T1: one block per (query tile, head, batch), the forward kernel's loop
// with lse read rather than built (no online rescale): per key tile S =
// Q K^T and S' = Q' K^T + Q K'^T, P = 2^(S c - lse log2 e) and P ⊙ S' in
// registers, lse' += rowsum(P ⊙ S'), O += P V and O' += P V' + (P ⊙ S') V;
// then o' = O' - lse' O.
// ---------------------------------------------------------------------------

template <int NH> constexpr size_t tangent_fwd_smem() {
  // Q, Q'; two stages of K, K', V, V'; barriers
  return 1024 + 10 * NH * kRegion + 64;
}

template <int NH>
__global__ void __launch_bounds__(kWG, NH == 1 ? 2 : 1)
tangent_fwd_kernel(const __grid_constant__ TArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t T = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sTQ = base + T, bars = base + 10 * T;
  const int t = threadIdx.x;
  // the last query tiles (the most key tiles, causal) are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kM, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  auto stage = [&](int i) { return base + 2 * T + 4 * T * (i & 1); };
  auto fetch = [&](int i, int kt) {     // K, K', V, V' of tile kt
    const uint32_t dst = stage(i), bar = bars + 8 * (1 + (i & 1));
    if (a.tma && t == 0) mbar_expect(bar, 4 * T);
    load_view<NH, kWG>(dst, a, tK, bar, b, hk, kt * kN, a.Sk, t);
    load_view<NH, kWG>(dst + T, a, tTK, bar, b, hk, kt * kN, a.Sk, t);
    load_view<NH, kWG>(dst + 2 * T, a, tV, bar, b, hk, kt * kN, a.Sk, t);
    load_view<NH, kWG>(dst + 3 * T, a, tTV, bar, b, hk, kt * kN, a.Sk, t);
  };

  int kt0, kt1;
  key_range(q0, a.S, a.Sk, a.causal, a.window, &kt0, &kt1);
  if (t == 0) {
    const int used[] = {tQ, tTQ, tK, tTK, tV, tTV, tTO};
    if (a.tma)
      for (int v : used) prefetch_map(a.m[v]);
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (a.tma && t == 0) mbar_expect(bars, 2 * T);
  load_view<NH, kWG>(sQ, a, tQ, bars, b, hq, q0, a.S, t);
  load_view<NH, kWG>(sTQ, a, tTQ, bars, b, hq, q0, a.S, t);
  if (kt0 < kt1) fetch(0, kt0);

  const long long row_vec = ((long long)b * a.H + hq) * a.S;
  float L2[2], dl[2] = {0.f, 0.f};      // lse (log2 units) and lse' of rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + frag_row(2 * r, t);
    L2[r] = row < a.S ? a.lse[row_vec + row] * kLog2e : 0.f;
  }
  float o[NH][32], ot[NH][32], s[32], sd[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = sd[e] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) o[cc][e] = ot[cc][e] = 0.f;
  }
  const float c = a.scale * kLog2e;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    const uint32_t sK = stage(i), sTK = sK + T, sV = sK + 2 * T,
                   sTV = sK + 3 * T;
    if (a.tma) {
      if (i == 0) mbar_wait(bars, 0);
      mbar_wait(bars + 8 * (1 + (i & 1)), (i >> 1) & 1);
    } else {
      fence_async_smem();
      __syncthreads();
    }

    wg_fence();
    mma_abt<NH>(s, sQ, sK);            // S
    mma_abt<NH>(sd, sTQ, sK);          // S' = Q' K^T + Q K'^T
    mma_abt<NH>(sd, sQ, sTK, true);
    wg_commit();
    if (kt + 1 < kt1) fetch(i + 1, kt + 1);   // while the tensor cores work
    wg_wait();
    keep(s);
    keep(sd);

    const int k0 = kt * kN;
    const bool edge = edge_tile(q0, k0, a.S, a.Sk, a.causal, a.window);
    probs<true>(s, L2, c, edge, q0, k0, a, t);
    band_zero<true>(sd, edge, q0, k0, a, t);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sd[e] = s[e] * sd[e] * a.scale;  // P ⊙ S'
      dl[(e >> 1) & 1] += sd[e];
    }
    uint32_t hi[4][4], lo[4][4], shi[4][4], slo[4][4];
    split(s, hi, lo);
    split(sd, shi, slo);
    wg_fence();
    mma_pb<NH>(o, hi, lo, sV);         // O += P V
    mma_pb<NH>(ot, hi, lo, sTV);       // O' += P V'
    mma_pb<NH>(ot, shi, slo, sV);      //     + (P ⊙ S') V
    wg_commit();
    wg_wait();
    keep(hi);
    keep(lo);
    keep(shi);
    keep(slo);
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) {
      keep(o[cc]);
      keep(ot[cc]);
    }
    __syncthreads();                   // stage read by all before refilled
  }

  if (a.tma && kt0 == kt1) mbar_wait(bars, 0);   // Q landed; no key tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] = quad_sum(dl[r]);
    const int row = q0 + frag_row(2 * r, t);
    if ((t & 3) == 0 && row < a.S) a.tlse[row_vec + row] = dl[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e)
#pragma unroll
    for (int cc = 0; cc < NH; ++cc)   // o' = O' - lse' O
      ot[cc][e] = fmaf(-dl[(e >> 1) & 1], o[cc][e], ot[cc][e]);
  write_tile<NH>(ot, sQ, a.m[tTO], const_cast<bf16*>(view(a, tTO, b, hq)),
                 a.st[tTO].s, b, hq, q0, a.S, a, t, 1);  // Q is free now
}

// ---------------------------------------------------------------------------
// T2 part 0: dq', and D, D' into a.dsum, a.tdsum; one block per (query
// tile, head, batch), the dQ kernel's loop on dual numbers.  Per key tile S,
// S', dP = dO V^T and dP' = dO' V^T + dO V'^T on the tensor cores, then in
// registers P, P' = P (S' - lse'), dS = P (dP - D) and dS' = P' (dP - D) +
// P (dP' - D') (both times scale), and dq' += dS' K + dS K'.
// ---------------------------------------------------------------------------

template <int NH> constexpr size_t tangent_dq_smem() {
  // Q, Q', dO, dO'; two stages of K, K', V, V' (O and O' in the second's
  // first two slots at first); D, D'; barriers
  return 1024 + 12 * NH * kRegion + 2 * 64 * 4 + 64;
}

template <int NH>
__global__ void __launch_bounds__(kWG, NH == 1 ? 2 : 1)
tangent_dq_kernel(const __grid_constant__ TArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t T = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  float* sD = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) +
                                       12 * T);    // D, then D'
  const uint32_t sQ = base, sTQ = base + T, sDO = base + 2 * T,
                 sTDO = base + 3 * T, bars = base + 12 * T + 512;
  const int t = threadIdx.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kM, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  const long long row_vec = ((long long)b * a.H + hq) * a.S;
  auto stage = [&](int i) { return base + 4 * T + 4 * T * (i & 1); };
  auto fetch = [&](int i, int kt) {     // K, K', V, V' of tile kt
    const uint32_t dst = stage(i), bar = bars + 8 * (1 + (i & 1));
    if (a.tma && t == 0) mbar_expect(bar, 4 * T);
    load_view<NH, kWG>(dst, a, tK, bar, b, hk, kt * kN, a.Sk, t);
    load_view<NH, kWG>(dst + T, a, tTK, bar, b, hk, kt * kN, a.Sk, t);
    load_view<NH, kWG>(dst + 2 * T, a, tV, bar, b, hk, kt * kN, a.Sk, t);
    load_view<NH, kWG>(dst + 3 * T, a, tTV, bar, b, hk, kt * kN, a.Sk, t);
  };

  int kt0, kt1;
  key_range(q0, a.S, a.Sk, a.causal, a.window, &kt0, &kt1);
  if (t == 0) {
    const int used[] = {tQ, tTQ, tDO, tTDO, tO, tTO, tK, tTK, tV, tTV, tTDQ};
    if (a.tma)
      for (int v : used) prefetch_map(a.m[v]);
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  // Q, Q', dO, dO', and O, O' (into the second stage, free until the
  // loop's first prefetch), then the first key tile
  const uint32_t sO = stage(1), sTO = stage(1) + T;
  if (a.tma && t == 0) mbar_expect(bars, 6 * T);
  load_view<NH, kWG>(sQ, a, tQ, bars, b, hq, q0, a.S, t);
  load_view<NH, kWG>(sTQ, a, tTQ, bars, b, hq, q0, a.S, t);
  load_view<NH, kWG>(sDO, a, tDO, bars, b, hq, q0, a.S, t);
  load_view<NH, kWG>(sTDO, a, tTDO, bars, b, hq, q0, a.S, t);
  load_view<NH, kWG>(sO, a, tO, bars, b, hq, q0, a.S, t);
  load_view<NH, kWG>(sTO, a, tTO, bars, b, hq, q0, a.S, t);
  if (kt0 < kt1) fetch(0, kt0);
  float L2[2], tl[2];                   // lse (log2 units) and lse' of rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + frag_row(2 * r, t);
    L2[r] = row < a.S ? a.lse[row_vec + row] * kLog2e : 0.f;
    tl[r] = row < a.S ? a.tlse[row_vec + row] : 0.f;
  }
  if (a.tma) {
    mbar_wait(bars, 0);
  } else {
    fence_async_smem();
    __syncthreads();
  }
  // D = diag(dO O^T) and D' = diag(dO' O^T + dO O'^T), on the tensor cores
  // as dP and dP' are: where a row sees one key, dP - D and dP' - D' are
  // exactly 0
  {
    float dd[32], dt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dd[e] = dt[e] = 0.f;
    wg_fence();
    mma_abt<NH>(dd, sDO, sO);
    mma_abt<NH>(dt, sTDO, sO);
    mma_abt<NH>(dt, sDO, sTO, true);
    wg_commit();
    wg_wait();
    keep(dd);
    keep(dt);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = frag_row(e, t);
      if (r == frag_col(e, t)) {
        sD[r] = dd[e];
        sD[64 + r] = dt[e];
        if (q0 + r < a.S) {
          a.dsum[row_vec + q0 + r] = dd[e];
          a.tdsum[row_vec + q0 + r] = dt[e];
        }
      }
    }
  }
  __syncthreads();
  const float c = a.scale * kLog2e;
  float D[2], Dt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    D[r] = sD[frag_row(2 * r, t)];
    Dt[r] = sD[64 + frag_row(2 * r, t)];
  }

  float acc[NH][32], s[32], sd[32], dp[32], dpt[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = sd[e] = dp[e] = dpt[e] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) acc[cc][e] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    const uint32_t sK = stage(i), sTK = sK + T, sV = sK + 2 * T,
                   sTV = sK + 3 * T;
    if (a.tma) {
      mbar_wait(bars + 8 * (1 + (i & 1)), (i >> 1) & 1);
    } else {
      fence_async_smem();
      __syncthreads();
    }

    wg_fence();
    mma_abt<NH>(s, sQ, sK);            // S
    mma_abt<NH>(sd, sTQ, sK);          // S'
    mma_abt<NH>(sd, sQ, sTK, true);
    mma_abt<NH>(dp, sDO, sV);          // dP
    mma_abt<NH>(dpt, sTDO, sV);        // dP'
    mma_abt<NH>(dpt, sDO, sTV, true);
    wg_commit();
    if (kt + 1 < kt1) fetch(i + 1, kt + 1);   // while the tensor cores work
    wg_wait();
    keep(s);
    keep(sd);
    keep(dp);
    keep(dpt);

    const int k0 = kt * kN;
    const bool edge = edge_tile(q0, k0, a.S, a.Sk, a.causal, a.window);
    probs<true>(s, L2, c, edge, q0, k0, a, t);
    band_zero<true>(sd, edge, q0, k0, a, t);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      const float p = s[e], pt = p * fmaf(sd[e], a.scale, -tl[r]);
      const float u = dp[e] - D[r];
      s[e] = p * u * a.scale;                                // dS
      sd[e] = fmaf(pt, u, p * (dpt[e] - Dt[r])) * a.scale;   // dS'
    }
    uint32_t hi[4][4], lo[4][4], dhi[4][4], dlo[4][4];
    split(sd, hi, lo);
    split(s, dhi, dlo);
    wg_fence();
    mma_pb<NH>(acc, hi, lo, sK);       // dq' += dS' K
    mma_pb<NH>(acc, dhi, dlo, sTK);    //      + dS K'
    wg_commit();
    wg_wait();
    keep(hi);
    keep(lo);
    keep(dhi);
    keep(dlo);
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) keep(acc[cc]);
    __syncthreads();
  }
  write_tile<NH>(acc, sQ, a.m[tTDQ], const_cast<bf16*>(view(a, tTDQ, b, hq)),
                 a.st[tTDQ].s, b, hq, q0, a.S, a, t, 1);  // Q is free now
}

// ---------------------------------------------------------------------------
// T2 part 1: dk' and dv'; one block per (key tile, KV head, batch), which
// visits the query tiles of each of the KV head's query heads in order and
// sums in registers.  The transposed tiles (keys x queries) S^T, S'^T, P^T,
// P'^T, then dv' += P'^T dO + P^T dO', then dP^T and dS^T = P^T (dP^T - D),
// dk' += dS^T Q', then dP'^T and dS'^T, dk' += dS'^T Q: at d = 128 the two
// accumulators are 128 registers a thread, so the tile's work is sequenced
// to keep at most three 32-register tiles beside them.
// ---------------------------------------------------------------------------

template <int NH> constexpr size_t tangent_dkv_smem() {
  // K, K', V, V'; two stages of Q, Q', dO, dO', then of lse, lse', D, D';
  // barriers
  return 1024 + 12 * NH * kRegion + 2 * 1024 + 64;
}

template <int NH>
__global__ void __launch_bounds__(kWG, NH == 1 ? 2 : 1)
tangent_dkv_kernel(const __grid_constant__ TArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr uint32_t T = NH * kRegion;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint8_t* gbase = smem + (base - smem_u32(smem));
  const uint32_t sK = base, sTK = base + T, sV = base + 2 * T,
                 sTV = base + 3 * T, bars = base + 12 * T + 2048;
  const int t = threadIdx.x;
  // the first key tiles (the most query tiles, causal) are launched first
  const int k0 = blockIdx.z * kN, hk = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KV;
  auto stage = [&](int i) { return base + 4 * T + 4 * T * (i & 1); };
  auto vecs = [&](int i) { return 12 * T + 1024 * (i & 1); };  // from base

  int qt0, qt1;
  query_range(k0, a.S, a.Sk, a.causal, a.window, &qt0, &qt1);
  const int nqt = qt1 - qt0, iters = G * nqt;
  auto fetch = [&](int i) {   // Q, Q', dO, dO' and lse, lse', D, D' of step i
    const int hq = hk * G + i / nqt, q0 = (qt0 + i % nqt) * kM;
    const uint32_t dst = stage(i), bar = bars + 8 * (1 + (i & 1));
    if (a.tma && t == 0) mbar_expect(bar, 4 * T);
    load_view<NH, kWG>(dst, a, tQ, bar, b, hq, q0, a.S, t);
    load_view<NH, kWG>(dst + T, a, tTQ, bar, b, hq, q0, a.S, t);
    load_view<NH, kWG>(dst + 2 * T, a, tDO, bar, b, hq, q0, a.S, t);
    load_view<NH, kWG>(dst + 3 * T, a, tTDO, bar, b, hq, q0, a.S, t);
    const long long row_vec = ((long long)b * a.H + hq) * a.S;
    const uint32_t v = base + vecs(i);
    if (t < 64) {
      load_row_vec(v, a.lse + row_vec, q0, a.S, t);
      load_row_vec(v + 512, a.dsum + row_vec, q0, a.S, t);
    } else {
      load_row_vec(v + 256, a.tlse + row_vec, q0, a.S, t - 64);
      load_row_vec(v + 768, a.tdsum + row_vec, q0, a.S, t - 64);
    }
    cp_commit();
  };

  if (t == 0) {
    const int used[] = {tK, tTK, tV, tTV, tQ, tTQ, tDO, tTDO, tTDK, tTDV};
    if (a.tma)
      for (int v : used) prefetch_map(a.m[v]);
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (a.tma && t == 0) mbar_expect(bars, 4 * T);
  load_view<NH, kWG>(sK, a, tK, bars, b, hk, k0, a.Sk, t);
  load_view<NH, kWG>(sTK, a, tTK, bars, b, hk, k0, a.Sk, t);
  load_view<NH, kWG>(sV, a, tV, bars, b, hk, k0, a.Sk, t);
  load_view<NH, kWG>(sTV, a, tTV, bars, b, hk, k0, a.Sk, t);
  if (iters > 0) fetch(0);

  float dk[NH][32], dv[NH][32], s[32], sd[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = sd[e] = dp[e] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) dk[cc][e] = dv[cc][e] = 0.f;
  }
  const float c = a.scale * kLog2e;
  const int c0 = frag_col(0, t);

  for (int i = 0; i < iters; ++i) {
    cp_wait<0>();                      // this thread's row vectors of step i
    if (!a.tma) fence_async_smem();
    __syncthreads();
    if (a.tma) {
      if (i == 0) mbar_wait(bars, 0);
      mbar_wait(bars + 8 * (1 + (i & 1)), (i >> 1) & 1);
    }
    const uint32_t sQ = stage(i), sTQ = sQ + T, sDO = sQ + 2 * T,
                   sTDO = sQ + 3 * T;
    const float* Lv = reinterpret_cast<const float*>(gbase + vecs(i));
    const float *Ltv = Lv + 64, *Dv = Lv + 128, *Dtv = Lv + 192;
    const int q0 = (qt0 + i % nqt) * kM;

    wg_fence();
    mma_abt<NH>(s, sK, sQ);            // S^T: keys x queries
    mma_abt<NH>(sd, sK, sTQ);          // S'^T = K Q'^T + K' Q^T
    mma_abt<NH>(sd, sTK, sQ, true);
    wg_commit();
    if (i + 1 < iters) fetch(i + 1);   // while the tensor cores work
    wg_wait();
    keep(s);
    keep(sd);

    const bool edge = edge_tile(q0, k0, a.S, a.Sk, a.causal, a.window);
    probs<false>(s, Lv, c, edge, q0, k0, a, t);       // P^T
    band_zero<false>(sd, edge, q0, k0, a, t);
#pragma unroll
    for (int e = 0; e < 32; ++e)                      // P'^T
      sd[e] = s[e] * fmaf(sd[e], a.scale, -Ltv[c0 + cofs(e)]);
    uint32_t hi[4][4], lo[4][4];
    split(sd, hi, lo);
    wg_fence();
    mma_pb<NH>(dv, hi, lo, sDO);       // dv' += P'^T dO
    wg_commit();
    wg_wait();
    keep(hi);
    keep(lo);
    split(s, hi, lo);
    wg_fence();
    mma_pb<NH>(dv, hi, lo, sTDO);      //       + P^T dO'
    wg_commit();
    wg_wait();
    keep(hi);
    keep(lo);
    wg_fence();
    mma_abt<NH>(dp, sV, sDO);          // dP^T
    wg_commit();
    wg_wait();
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float u = dp[e] - Dv[c0 + cofs(e)];
      sd[e] *= u;                      // P'^T (dP^T - D), dS'^T's first part
      dp[e] = s[e] * u * a.scale;      // dS^T
    }
    split(dp, hi, lo);
    wg_fence();
    mma_pb<NH>(dk, hi, lo, sTQ);       // dk' += dS^T Q'
    wg_commit();
    wg_wait();
    keep(hi);
    keep(lo);
    wg_fence();
    mma_abt<NH>(dp, sV, sTDO);         // dP'^T = V dO'^T + V' dO^T
    mma_abt<NH>(dp, sTV, sDO, true);
    wg_commit();
    wg_wait();
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e)       // dS'^T
      sd[e] = fmaf(s[e], dp[e] - Dtv[c0 + cofs(e)], sd[e]) * a.scale;
    split(sd, hi, lo);
    wg_fence();
    mma_pb<NH>(dk, hi, lo, sQ);        //       + dS'^T Q
    wg_commit();
    wg_wait();
    keep(hi);
    keep(lo);
#pragma unroll
    for (int cc = 0; cc < NH; ++cc) {
      keep(dk[cc]);
      keep(dv[cc]);
    }
  }

  if (a.tma && iters == 0) mbar_wait(bars, 0);  // K, V landed; no query
  __syncthreads();                     // every product has read K, K', V, V'
  write_tile<NH>(dk, sK, a.m[tTDK], const_cast<bf16*>(view(a, tTDK, b, hk)),
                 a.st[tTDK].s, b, hk, k0, a.Sk, a, t, 1);
  write_tile<NH>(dv, sV, a.m[tTDV], const_cast<bf16*>(view(a, tTDV, b, hk)),
                 a.st[tTDV].s, b, hk, k0, a.Sk, a, t, 1);
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

template <typename Kernel, typename A>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const A& a, bool* ready) {
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

// The tangent launches: kind 0 T1, 1 T2's dq' (part 0), 2 T2's dk'/dv'
// (part 1).
template <int NH>
cudaError_t run_tangent(const TArgs& a, int B, int kind, cudaStream_t s) {
  if (kind == 0) {
    static bool ready = false;
    return launch(tangent_fwd_kernel<NH>, dim3(a.H, B, (a.S + kM - 1) / kM),
                  kWG, tangent_fwd_smem<NH>(), s, a, &ready);
  }
  if (kind == 1) {
    static bool ready = false;
    return launch(tangent_dq_kernel<NH>, dim3(a.H, B, (a.S + kM - 1) / kM),
                  kWG, tangent_dq_smem<NH>(), s, a, &ready);
  }
  static bool ready = false;
  return launch(tangent_dkv_kernel<NH>, dim3(a.KV, B, (a.Sk + kN - 1) / kN),
                kWG, tangent_dkv_smem<NH>(), s, a, &ready);
}

bool valid(int B, int H, int KV, int S, int Sk, int d) {
  return B >= 1 && B <= 65535 && H >= 1 && KV >= 1 && H % KV == 0 &&
         S >= 1 && Sk >= 1 && (S + kM - 1) / kM <= 65535 &&
         (Sk + kN - 1) / kN <= 65535 && d >= 1 && d <= kMaxHeadDim;
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// The views each tangent launch (run_tangent's kind) reads or writes, as
// bits of TView, and those with KV heads and S_k rows.
constexpr unsigned kTangentViews[3] = {
    1u << tQ | 1u << tK | 1u << tV | 1u << tTQ | 1u << tTK | 1u << tTV |
        1u << tTO,
    (1u << kTViews) - 1 - (1u << tTDK) - (1u << tTDV),
    (1u << kTViews) - 1 - (1u << tO) - (1u << tTO) - (1u << tTDQ)};
constexpr unsigned kKeyViews = 1u << tK | 1u << tV | 1u << tTK | 1u << tTV |
                               1u << tTDK | 1u << tTDV;

// a's pointers and strides of the 13 views and, where every view the
// launch uses has 16-byte aligned rows and d % 8 == 0, their tensor maps
// (tma = 1; else 0: element by element).  a's dims must be set.  False if
// such a view's map cannot be made.
bool tangent_views(TArgs* a, const void* const* ptrs, const long long* strides,
                   int kind, int B) {
  const unsigned used = kTangentViews[kind];
  bool vec = a->d % 8 == 0;
  for (int v = 0; v < kTViews; ++v) {
    a->p[v] = static_cast<const bf16*>(ptrs[v]);
    a->st[v] = strides_at(strides, v);
    if (used >> v & 1)
      vec = vec && reinterpret_cast<uintptr_t>(ptrs[v]) % 16 == 0 &&
            a->st[v].b % 8 == 0 && a->st[v].s % 8 == 0 &&
            a->st[v].h % 8 == 0;
  }
  a->tma = 0;
  if (!vec) return true;
  for (int v = 0; v < kTViews; ++v) {
    if (!(used >> v & 1)) continue;
    const bool keys = kKeyViews >> v & 1;
    if (!make_map(&a->m[v], ptrs[v], B, keys ? a->Sk : a->S,
                  keys ? a->KV : a->H, a->d, a->st[v]))
      return false;
  }
  a->tma = 1;
  return true;
}

// The tangent launch of run_tangent's `kind` on the 13 views (the C
// entries' arguments); a cudaError_t.
int tangent(const void* const* views, const long long* strides,
            const void* lse, const void* tlse, void* dsum, void* tdsum, int B,
            int H, int KV, int S, int Sk, int d, float scale, int causal,
            int window, int kind, cudaStream_t s) {
  if (!valid(B, H, KV, S, Sk, d)) return (int)cudaErrorInvalidValue;
  TArgs a{};
  a.H = H; a.KV = KV; a.S = S; a.Sk = Sk; a.d = d; a.scale = scale;
  a.causal = causal; a.window = window;
  if (!tangent_views(&a, views, strides, kind, B))
    return (int)cudaErrorInvalidValue;
  a.lse = static_cast<const float*>(lse);
  a.tlse = static_cast<float*>(const_cast<void*>(tlse));
  a.dsum = static_cast<float*>(dsum);
  a.tdsum = static_cast<float*>(tdsum);
  return (int)(d <= 64 ? run_tangent<1>(a, B, kind, s)
                       : run_tangent<2>(a, B, kind, s));
}

}  // namespace hop

// ===========================================================================
// float32 on Hopper: 3xTF32 products on the tensor cores
// ===========================================================================
//
// The float32 route: the backward first, then the forward and T2 (after
// the backward's launchers), which share its machinery.
//
// The backward: the same two launches as the bf16 route, on the same strided
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

struct Args {                           // the forward writes o and lse
  const float *q, *k, *v, *dout;
  float *o, *lse, *dsum, *dq, *dk, *dv;
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
template <typename A>
__device__ __forceinline__ bool edge(int q0, int qr, int k0, int kr,
                                     const A& a) {
  return q0 + qr > a.S || k0 + kr > a.Sk || (a.causal && k0 + kr - 1 > q0) ||
         (a.window > 0 && k0 <= q0 + qr - 1 - a.window);
}

// P = 2^(s c - L2) of one logit, L2 = lse log2 e; on an edge tile a pair
// outside the band gets the logit -1e30 and one past a sequence end 0.
template <typename A>
__device__ __forceinline__ float prob(float s, float c, float L2, bool edge,
                                      int qp, int kp, const A& a) {
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

template <typename Kernel, typename A>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const A& a, bool* ready) {
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

// A warp's 16 x D accumulator tile (a lane's rows g and g + 8, columns
// 8n + 2t and 8n + 2t + 1) to rows [row0, row0 + 16) of a head's (rows, d)
// slice at dst, row stride ld: through `tile`, 16 rows of shared memory
// (row stride D + 4) that no other thread reads by then, so that each row
// goes out in 16-byte stores where vec; rows past `rows` and columns past
// d are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&x)[D / 8][4],
                                           float* tile, float* dst,
                                           long long ld, int row0, int rows,
                                           int d, int vec, int lane) {
  constexpr int LD = D + 4, C4 = D / 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(tile + g * LD + 8 * n + 2 * t) =
        make_float2(x[n][0], x[n][1]);
    *reinterpret_cast<float2*>(tile + (g + 8) * LD + 8 * n + 2 * t) =
        make_float2(x[n][2], x[n][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * C4; i += 32) {
    const int r = i / C4, c = 4 * (i - (i / C4) * C4);
    const long long gr = row0 + r;
    if (gr >= rows || c >= d) continue;
    const float* from = tile + r * LD + c;
    float* to = dst + gr * ld + c;
    if (vec) {
      *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(from);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) to[e] = from[e];
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (64 query rows, head, batch)
// ---------------------------------------------------------------------------
//
// Replaces the Pallas TPU kernel flash_attention.py::flash_attention_fwd_lse
// in float32.  Four warps own 16 query rows each and visit the key tiles of
// their band 32 keys at a time (two cp.async stages at d <= 64, one at
// d = 128, as the backward).  S = Q K^T is three TF32 products; the online
// softmax runs in float32 on the accumulator fragments, in log2 units (the
// scale times log2 e folded into one multiply), row max and sum by quad
// shuffles; P enters P V as the A operand straight from the accumulators;
// P V of a tile goes into a fresh accumulator and O = alpha O + t is a
// float32 update, so the tensor core's round-toward-zero never sums across
// tiles.  O leaves through the warp's own Q rows in shared memory (16-byte
// row stores), lse = m + log l as (B, H, S) float32.  q, k, v and o are read
// and written through their views' strides: (B, S, H, d) with K/V heads
// unexpanded, or (B, H, S, d); query head h reads KV head h / (H / KV).
//
// Bound at lm-100m's shape (B = 16, S = 256, H = 8, KV = 4, d = 64,
// causal): 1.08 GFLOP, 0.016 ms at the 67 TFLOP/s float32 rate; as three
// TF32 products 3.2 GFLOP, 0.0065 ms at 495 TFLOP/s; 25.2 MB of bytes,
// 0.0075 ms at 3.35 TB/s.

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (kOwn + 2 * stages<D>() * kVis) * (D + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
fwd_kernel(const __grid_constant__ Args a) {
  constexpr int LD = D + 4, KS = D / 8, NS = stages<D>();
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // kOwn x LD; then each warp's O
  float* sKV = sQ + kOwn * LD;            // per stage K, V: kVis x LD each
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2,
            tg = tid & 3;
  // the last query tiles (the most key tiles, causal) are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  const float* kb = a.k + b * a.sk.b + hk * a.sk.h;
  const float* vb = a.v + b * a.sv.b + hk * a.sv.h;
  auto fetch = [&](int kt, int st) {      // key tile kt into stage st
    float* k = sKV + 2 * st * kVis * LD;
    load_tile<kVis, D>(k, kb, a.sk.s, kt * kVis, a.Sk, a.d, a.vec, tid);
    load_tile<kVis, D>(k + kVis * LD, vb, a.sv.s, kt * kVis, a.Sk, a.d,
                       a.vec, tid);
    hop::cp_commit();
  };

  load_tile<kOwn, D>(sQ, a.q + b * a.sq.b + hq * a.sq.h, a.sq.s, q0, a.S,
                     a.d, a.vec, tid);
  hop::cp_commit();
  int kt0, kt1;
  keys_of(q0, kOwn, kVis, a.S, a.Sk, a.causal, a.window, &kt0, &kt1);
  if (kt0 < kt1) fetch(kt0, 0);

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float c = a.scale * hop::kLog2e;
  float m[2] = {kMasked * hop::kLog2e, kMasked * hop::kLog2e};
  float l[2] = {0.f, 0.f};
  const int r0 = 16 * w + g;              // the thread's rows r0, r0 + 8

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kVis, st = NS == 2 ? (kt - kt0) & 1 : 0;
    hop::cp_wait<0>();
    __syncthreads();                      // tile kt landed; the last one read
    if (NS == 2 && kt + 1 < kt1) fetch(kt + 1, st ^ 1);
    const float* sK = sKV + 2 * st * kVis * LD;
    const float* sV = sK + kVis * LD;

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA qa = load_a<LD>(sQ, 16 * w, 8 * kk, g, tg);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3(s[j], qa, load_bt<LD>(sK, 8 * j, 8 * kk, g, tg));
    }

    // online softmax in log2 units: row max, rescale, P = 2^(x - m); on an
    // edge tile a pair outside the band gets the logit -1e30, one past the
    // keys' end -inf
    const bool e_ = edge(q0, kOwn, k0, kVis, a);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * c;
        if (e_) {
          const int kp = k0 + 8 * j + 2 * tg + (e & 1);
          const int delta = q0 + r0 + 8 * r - kp;
          const bool out = (a.causal && delta < 0) ||
                           (a.window > 0 && delta > a.window - 1);
          x = out ? kMasked * hop::kLog2e : x;
          x = kp < a.Sk ? x : -INFINITY;
        }
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = hop::quad_max(mx[r]);
      alpha[r] = hop::exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hop::exp2_approx(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    // O += P V, the tile's sum into a fresh accumulator
    FragA pa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[j] = acc_as_a(s[j]);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3_into(t, pa[j], load_bk<LD>(sV, 8 * j, 8 * n, g, tg), j == 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
    }
    if (NS == 1 && kt + 1 < kt1) {
      __syncthreads();                    // every warp is done with tile kt
      fetch(kt + 1, 0);
    }
  }
  hop::cp_wait<0>();
  __syncthreads();                        // Q landed, where no key tile was

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(hop::quad_sum(l[r]), 1e-30f), inv = 1.f / lc;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      acc[n][2 * r] *= inv;
      acc[n][2 * r + 1] *= inv;
    }
    const int row = q0 + r0 + 8 * r;
    if (tg == 0 && row < a.S)
      a.lse[((long long)b * a.H + hq) * a.S + row] =
          (m[r] + log2f(lc)) * hop::kLn2;
  }
  store_rows<D>(acc, sQ + 16 * w * LD, a.o + b * a.so.b + hq * a.so.h,
                a.so.s, q0 + 16 * w, a.S, a.d, a.vec, tid & 31);
}

template <int D>
cudaError_t run_fwd(const Args& a, int B, cudaStream_t s) {
  static bool ready = false;
  return launch(fwd_kernel<D>, dim3(a.H, B, (a.S + kOwn - 1) / kOwn),
                kThreadsF, fwd_smem<D>(), s, a, &ready);
}

// ---------------------------------------------------------------------------
// T1 and T2 in float32: the tangents of the forward and the backward on the
// tensor cores
// ---------------------------------------------------------------------------
//
// No TPU counterpart: the JAX package has no forward-mode rule for its
// kernels.  The exact meta-gradient's Hessian-vector products are forward-
// over-reverse (torch.func.jvp of torch.func.grad), so both flash Functions
// of ../ops.py need a forward-mode rule, and these kernels (and hop's in
// bfloat16) are it.  The algebra, which both dtypes share:
//
// T1, the tangent of the forward: given q, k, v, the forward's lse and the
// tangents q', k', v', with s'_ij = scale (q'_i . k_j + q_i . k'_j) on the
// allowed pairs (0 on the pairs the band excludes, whose logit is -1e30),
//   lse'_i = sum_j P_ij s'_ij,   o'_i = sum_j P_ij (s'_ij v_j + v'_j) - lse'_i o_i
// with P = exp(S - lse) recomputed from the saved lse.  One pass over the
// key tiles.
// T2, the tangent of the FlashAttention-2 backward (dQ, dK, dV of q, k, v,
// o, lse, dO), from the tangents of all six:
//   P' = P (S' - lse'),  D = rowsum(dO o),  D' = rowsum(dO' o + dO o'),
//   dP = dO V^T,  dP' = dO' V^T + dO V'^T,
//   dS = P (dP - D),  dS' = P' (dP - D) + P (dP' - D'),
//   dQ' = scale (dS' K + dS K'),  dK' = scale (dS'^T Q + dS^T Q'),
//   dV' = P'^T dO + P^T dO'.
//
// T2: two launches, as the backward: part 0 (tangent_dq_kernel) writes
// dQ' and D = rowsum(dO o), D' = rowsum(dO' o + dO o') into (B, H, S)
// float32 workspaces; part 1 (tangent_dkv_kernel) dK' and dV', summed over
// each KV head's query heads in a fixed order, without atomics.  Every
// product is three TF32 products: S = Q K^T, S' = Q' K^T + Q K'^T, dP = dO
// V^T, dP' = dO' V^T + dO V'^T, then dQ' = scale (dS' K + dS K'), dK' =
// scale (dS'^T Q + dS^T Q') and dV' = P'^T dO + P^T dO'; P, P', dS and dS'
// enter as A from the accumulators.  The long sums take each visited tile
// into a fresh accumulator and add it with a float32 add.
//
// Each side stages twice the backward's operands (q, q', dO, dO' against k,
// k', v, v'), so a block is 8 warps on one set of stages: warp w owns rows
// 16 (w % 4) .. of the block's 64 and takes visited rows 16 (w / 4) .. of
// each 32-row visited tile; the two halves add their sums through shared
// memory at the end, in a fixed order.  (Two warpgroups that split a KV
// head's query heads, as the backward's dK/dV does, would need two sets of
// visited stages: 270 KB at d = 128.)  Shared memory, float32 rows of
// d + 4: 4 x 64 own rows and 4 x 32 visited rows a stage.  dQ': two stages
// at d <= 32 (73.7 KB, two blocks an SM), one at d = 64 (104.4 KB, two
// blocks at 128 registers) and d = 128 (202.8 KB, one).  dK'/dV', whose
// blocks visit every query head of their KV head: two stages at d <= 64
// (140.3 KB at d = 64, one block an SM at up to 255 registers, no spills)
// and one at d = 128.  At lm-100m's shape each part ran faster laid out
// so than laid out as the other.  Both parts read every view through its
// strides, K/V unexpanded.
//
// Bound at lm-100m's shape: 6.5 GFLOP of products, 0.097 ms at the float32
// rate (12 d multiply-adds a pair, chip_smoke.py::flash_tangent_cost); as
// three TF32 products 0.039 ms; 84 MB of bytes, 0.025 ms.  The two parts
// each recompute S, S', dP and dP' (18 d multiply-adds a pair in all).

// The views of a T2 launch, in the entry's order.
enum { kQ = 0, kK, kV, kO, kDO, kTQ, kTK, kTV, kTO, kTDO, kTDQ, kTDK, kTDV,
       kViews };

struct TArgs {
  const float *q, *k, *v, *o, *dout, *lse, *tq, *tk, *tv, *to, *tdout,
      *tlse;
  float *dsum, *tdsum, *tdq, *tdk, *tdv;
  hop::Strides st[kViews];
  int H, KV, S, Sk, d;
  float scale;
  int causal, window;
  int vec;                              // 1: rows 16-byte aligned, d % 4 == 0
};

constexpr int kThreadsT = 256;            // 8 warps: 4 row groups x 2 halves

// Stages of the visited tiles in part 0 (dq = true) and part 1.
template <int D, bool dq> __host__ __device__ constexpr int tangent_stages() {
  return D <= (dq ? 32 : 64) ? 2 : 1;
}
template <int D> constexpr size_t tangent_dq_smem() {
  return sizeof(float) *
         ((4 * kOwn + 4 * tangent_stages<D, true>() * kVis) * (D + 4) +
          2 * kOwn);
}
template <int D> constexpr size_t tangent_dkv_smem() {
  return sizeof(float) * ((4 * kOwn + 4 * tangent_stages<D, false>() * kVis) *
                              (D + 4) +
                          4 * tangent_stages<D, false>() * kVis);
}

// The (rows, d) slice of head h of batch b in view i.
__device__ __forceinline__ const float* slice(const TArgs& a, const float* p,
                                              int i, int b, int h) {
  return p + b * a.st[i].b + h * a.st[i].h;
}

// The four products of both parts, own rows r0 .. r0 + 15 of the tiles x
// (row stride LD) against visited rows v0 .. v0 + 15 of the tiles y:
//   s = x0 y0^T,  sd = x1 y0^T + x0 y1^T,  dp = x2 y2^T,  dpd = x3 y2^T + x2 y3^T
// (part 0: x = q, q', dO, dO' and y = k, k', v, v': S, S', dP, dP'; part 1
// the other way round, their transposes).
template <int LD, int KS>
__device__ __forceinline__ void tangent_scores(
    const float* const (&x)[4], const float* const (&y)[4], int r0, int v0,
    int g, int tg, float (&s)[2][4], float (&sd)[2][4], float (&dp)[2][4],
    float (&dpd)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = sd[j][e] = dp[j][e] = dpd[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    {
      const FragA a = load_a<LD>(x[0], r0, 8 * kk, g, tg);
      const FragA ta = load_a<LD>(x[1], r0, 8 * kk, g, tg);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const FragB b = load_bt<LD>(y[0], v0 + 8 * j, 8 * kk, g, tg);
        mma3(s[j], a, b);
        mma3(sd[j], ta, b);
        mma3(sd[j], a, load_bt<LD>(y[1], v0 + 8 * j, 8 * kk, g, tg));
      }
    }
    const FragA a = load_a<LD>(x[2], r0, 8 * kk, g, tg);
    const FragA ta = load_a<LD>(x[3], r0, 8 * kk, g, tg);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const FragB b = load_bt<LD>(y[2], v0 + 8 * j, 8 * kk, g, tg);
      mma3(dp[j], a, b);
      mma3(dpd[j], ta, b);
      mma3(dpd[j], a, load_bt<LD>(y[3], v0 + 8 * j, 8 * kk, g, tg));
    }
  }
}

// acc += u y + w z over the warp's 16 visited rows v0 .. (the contraction):
// u and w accumulator slices (16 x 8 each, two) as A, y and z visited
// tiles; the tile's sum into a fresh accumulator, added in float32.
template <int LD, int KS>
__device__ __forceinline__ void add_products(float (&acc)[KS][4],
                                             const float (&u)[2][4],
                                             const float* y,
                                             const float (&w)[2][4],
                                             const float* z, int v0, int g,
                                             int tg) {
  FragA ua[2], wa[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    ua[j] = acc_as_a(u[j]);
    wa[j] = acc_as_a(w[j]);
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    float t[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mma3_into(t, ua[j], load_bk<LD>(y, v0 + 8 * j, 8 * n, g, tg), j == 0);
      mma3_into(t, wa[j], load_bk<LD>(z, v0 + 8 * j, 8 * n, g, tg), false);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
  }
}

// The second half's sums x to the first, through shared memory at red
// (free by then; KS x 512 floats): half 1 stores, half 0 adds, in that
// fixed order.  Every thread of the block calls it.
template <int KS>
__device__ __forceinline__ void add_halves(float (&x)[KS][4], float* red,
                                           bool second, int at) {
  if (second) {
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 128 + at] = x[n][e];
  }
  __syncthreads();
  if (!second) {
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] += red[(n * 4 + e) * 128 + at];
  }
}

// Part 0: dQ', D and D'.  One block per (64 query rows, head, batch),
// visiting the key tiles of its band 32 rows at a time.
template <int D>
__global__ void __launch_bounds__(kThreadsT, D <= 64 ? 2 : 1)
tangent_dq_kernel(const __grid_constant__ TArgs a) {
  constexpr int LD = D + 4, KS = D / 8, NS = tangent_stages<D, true>();
  constexpr int OWN = kOwn * LD, VIS = kVis * LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // own: q, q', dO, dO'
  float* sTQ = sQ + OWN;
  float* sO = sTQ + OWN;
  float* sTO = sO + OWN;
  float* sVis = sTO + OWN;                // per stage k, k', v, v'
  float* sD = sVis + 4 * NS * VIS;        // D, D' of the block's rows
  const float* const own_t[4] = {sQ, sTQ, sO, sTO};
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31,
            g = lane >> 2, tg = lane & 3;
  const int rg = w & 3, v0 = 16 * (w >> 2);   // own row group, visited half
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  const long long row_vec = ((long long)b * a.H + hq) * a.S;
  const float *kb = slice(a, a.k, kK, b, hk), *tkb = slice(a, a.tk, kTK, b, hk),
              *vb = slice(a, a.v, kV, b, hk), *tvb = slice(a, a.tv, kTV, b, hk);
  auto fetch = [&](int kt, int st) {      // key tile kt into stage st
    float* s = sVis + 4 * st * VIS;
    const int r = kt * kVis;
    load_tile<kVis, D, kThreadsT>(s, kb, a.st[kK].s, r, a.Sk, a.d, a.vec,
                                  tid);
    load_tile<kVis, D, kThreadsT>(s + VIS, tkb, a.st[kTK].s, r, a.Sk, a.d,
                                  a.vec, tid);
    load_tile<kVis, D, kThreadsT>(s + 2 * VIS, vb, a.st[kV].s, r, a.Sk, a.d,
                                  a.vec, tid);
    load_tile<kVis, D, kThreadsT>(s + 3 * VIS, tvb, a.st[kTV].s, r, a.Sk,
                                  a.d, a.vec, tid);
    hop::cp_commit();
  };
  auto own = [&](float* dst, const float* p, int i) {
    load_tile<kOwn, D, kThreadsT>(dst, slice(a, p, i, b, hq), a.st[i].s, q0,
                                  a.S, a.d, a.vec, tid);
  };

  // q, q', dO, dO', and o, o' in stage 0 (64 rows each), for D and D'
  own(sQ, a.q, kQ);
  own(sTQ, a.tq, kTQ);
  own(sO, a.dout, kDO);
  own(sTO, a.tdout, kTDO);
  own(sVis, a.o, kO);
  own(sVis + 2 * VIS, a.to, kTO);
  hop::cp_commit();
  hop::cp_wait<0>();
  __syncthreads();
  {                                       // four threads a row
    const int r = tid >> 2, part = (tid & 3) * (D / 4);
    const float *x = sO + r * LD + part, *tx = sTO + r * LD + part;
    const float *y = sVis + r * LD + part, *ty = sVis + 2 * VIS + r * LD + part;
    float dd = 0.f, td = 0.f;
#pragma unroll 8
    for (int c = 0; c < D / 4; ++c) {
      dd = fmaf(x[c], y[c], dd);
      td = fmaf(tx[c], y[c], fmaf(x[c], ty[c], td));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      dd += __shfl_xor_sync(0xffffffffu, dd, o);
      td += __shfl_xor_sync(0xffffffffu, td, o);
    }
    if ((tid & 3) == 0) {
      sD[r] = dd;
      sD[kOwn + r] = td;
      if (q0 + r < a.S) {
        a.dsum[row_vec + q0 + r] = dd;
        a.tdsum[row_vec + q0 + r] = td;
      }
    }
  }
  __syncthreads();                        // D, D' kept; stage 0 free

  const int r0 = 16 * rg + g;             // the thread's rows r0, r0 + 8
  float L2[2], tl[2], Dr[2], tDr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const bool in = row < a.S;
    L2[r] = in ? a.lse[row_vec + row] * hop::kLog2e : 0.f;
    tl[r] = in ? a.tlse[row_vec + row] : 0.f;
    Dr[r] = sD[r0 + 8 * r];
    tDr[r] = sD[kOwn + r0 + 8 * r];
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
    const float* sK = sVis + 4 * st * VIS;
    const float* const vis[4] = {sK, sK + VIS, sK + 2 * VIS, sK + 3 * VIS};

    // S, S', dP, dP': the warp's 16 rows against its 16 visited keys
    float s[2][4], sd[2][4], dp[2][4], dpd[2][4];
    tangent_scores<LD, KS>(own_t, vis, 16 * rg, v0, g, tg, s, sd, dp, dpd);
    // P = exp(S - lse), P' = P (S' - lse'); dS into dp, dS' into dpd
    const bool e_ = edge(q0, kOwn, k0, kVis, a);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = prob(s[j][e], c, L2[r], e_, q0 + r0 + 8 * r,
                             k0 + v0 + 8 * j + 2 * tg + (e & 1), a);
        const float pd = p * (sd[j][e] * a.scale - tl[r]);
        const float x = dp[j][e] - Dr[r];
        dp[j][e] = p * x;
        dpd[j][e] = pd * x + p * (dpd[j][e] - tDr[r]);
      }
    // dQ' += dS' K + dS K' (times scale at the end)
    add_products<LD, KS>(acc, dpd, vis[0], dp, vis[1], v0, g, tg);
    if (NS == 1 && kt + 1 < kt1) {
      __syncthreads();                    // every warp is done with tile kt
      fetch(kt + 1, 0);
    }
  }
  hop::cp_wait<0>();
  __syncthreads();                        // the stages are free

  // the second half's sums to the first, which writes dQ'
  add_halves<KS>(acc, sVis, v0 != 0, rg * 32 + lane);
  if (v0) return;
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= a.scale;
  store_rows<D>(acc, sQ + 16 * rg * LD,
                a.tdq + b * a.st[kTDQ].b + hq * a.st[kTDQ].h, a.st[kTDQ].s,
                q0 + 16 * rg, a.S, a.d, a.vec, lane);
}

// Part 1: dK' and dV'.  One block per (64 key rows, KV head, batch),
// visiting 32 query rows at a time of each of the KV head's query heads in
// order; reads D and D' from part 0.
template <int D>
__global__ void __launch_bounds__(kThreadsT, D <= 32 ? 2 : 1)
tangent_dkv_kernel(const __grid_constant__ TArgs a) {
  constexpr int LD = D + 4, KS = D / 8, NS = tangent_stages<D, false>();
  constexpr int OWN = kOwn * LD, VIS = kVis * LD;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // own: k, k', v, v'
  float* sTK = sK + OWN;
  float* sV = sTK + OWN;
  float* sTV = sV + OWN;
  float* sVis = sTV + OWN;                // per stage q, q', dO, dO'
  float* sRow = sVis + 4 * NS * VIS;      // per stage lse log2 e, lse', D, D'
  const float* const own_t[4] = {sK, sTK, sV, sTV};
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31,
            g = lane >> 2, tg = lane & 3;
  const int rg = w & 3, v0 = 16 * (w >> 2);   // own row group, visited half
  // the first key tiles (the most query tiles, causal) are launched first
  const int k0 = blockIdx.z * kOwn, hk = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KV;

  int qt0, qt1;
  queries_of(k0, kOwn, kVis, a.S, a.Sk, a.causal, a.window, &qt0, &qt1);
  const int nqt = qt1 - qt0, iters = G * nqt;
  auto fetch = [&](int i, int st) {       // visit i: (head, query tile)
    const int hq = hk * G + i / nqt, q0 = (qt0 + i % nqt) * kVis;
    float* s = sVis + 4 * st * VIS;
    const float* src[4] = {a.q, a.tq, a.dout, a.tdout};
    const int view[4] = {kQ, kTQ, kDO, kTDO};
#pragma unroll
    for (int x = 0; x < 4; ++x)
      load_tile<kVis, D, kThreadsT>(s + x * VIS,
                                    slice(a, src[x], view[x], b, hq),
                                    a.st[view[x]].s, q0, a.S, a.d, a.vec,
                                    tid);
    if (tid < 4 * kVis) {
      const int which = tid / kVis, qp = q0 + tid % kVis;
      const long long at = ((long long)b * a.H + hq) * a.S + qp;
      float x = 0.f;
      if (qp < a.S)
        x = which == 0 ? a.lse[at] * hop::kLog2e
          : which == 1 ? a.tlse[at]
          : which == 2 ? a.dsum[at] : a.tdsum[at];
      sRow[4 * st * kVis + tid] = x;
    }
    hop::cp_commit();
  };

  {
    float* dst[4] = {sK, sTK, sV, sTV};
    const float* src[4] = {a.k, a.tk, a.v, a.tv};
    const int view[4] = {kK, kTK, kV, kTV};
#pragma unroll
    for (int x = 0; x < 4; ++x)
      load_tile<kOwn, D, kThreadsT>(dst[x], slice(a, src[x], view[x], b, hk),
                                    a.st[view[x]].s, k0, a.Sk, a.d, a.vec,
                                    tid);
  }
  if (iters > 0) fetch(0, 0);
  else hop::cp_commit();

  float gk[KS][4], gv[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;
  const float c = a.scale * hop::kLog2e;
  const int r0 = 16 * rg + g;             // the thread's key rows r0, r0 + 8

  for (int i = 0; i < iters; ++i) {
    const int q0 = (qt0 + i % nqt) * kVis, st = NS == 2 ? i & 1 : 0;
    hop::cp_wait<0>();
    __syncthreads();                      // visit i landed; the last one read
    if (NS == 2 && i + 1 < iters) fetch(i + 1, st ^ 1);
    const float* sQ = sVis + 4 * st * VIS;
    const float* const vis[4] = {sQ, sQ + VIS, sQ + 2 * VIS, sQ + 3 * VIS};
    const float* sL = sRow + 4 * st * kVis;
    const float *sTL = sL + kVis, *sD = sL + 2 * kVis, *sTD = sL + 3 * kVis;

    // S^T, S'^T, dP^T, dP'^T: the warp's 16 keys against its 16 queries
    float s[2][4], sd[2][4], dp[2][4], dpd[2][4];
    tangent_scores<LD, KS>(own_t, vis, 16 * rg, v0, g, tg, s, sd, dp, dpd);
    // P^T, P'^T into s, sd; dS^T, dS'^T into dp, dpd
    const bool e_ = edge(q0, kVis, k0, kOwn, a);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + 8 * j + 2 * tg + (e & 1);
        const float p = prob(s[j][e], c, sL[col], e_, q0 + col,
                             k0 + r0 + 8 * (e >> 1), a);
        const float pd = p * (sd[j][e] * a.scale - sTL[col]);
        const float x = dp[j][e] - sD[col];
        s[j][e] = p;
        sd[j][e] = pd;
        dp[j][e] = p * x;
        dpd[j][e] = pd * x + p * (dpd[j][e] - sTD[col]);
      }
    // dV' += P'^T dO + P^T dO', dK' += dS'^T Q + dS^T Q' (times scale at
    // the end)
    add_products<LD, KS>(gv, sd, vis[2], s, vis[3], v0, g, tg);
    add_products<LD, KS>(gk, dpd, vis[0], dp, vis[1], v0, g, tg);
    if (NS == 1 && i + 1 < iters) {
      __syncthreads();                    // every warp is done with visit i
      fetch(i + 1, 0);
    }
  }
  hop::cp_wait<0>();
  __syncthreads();                        // K, V landed; the stages are free

  // the second half's sums to the first, which writes dK' and dV'
  add_halves<KS>(gk, sVis, v0 != 0, rg * 32 + lane);
  add_halves<KS>(gv, sVis + KS * 512, v0 != 0, rg * 32 + lane);
  if (v0) return;
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] *= a.scale;
  store_rows<D>(gk, sK + 16 * rg * LD,
                a.tdk + b * a.st[kTDK].b + hk * a.st[kTDK].h, a.st[kTDK].s,
                k0 + 16 * rg, a.Sk, a.d, a.vec, lane);
  store_rows<D>(gv, sV + 16 * rg * LD,
                a.tdv + b * a.st[kTDV].b + hk * a.st[kTDV].h, a.st[kTDV].s,
                k0 + 16 * rg, a.Sk, a.d, a.vec, lane);
}

template <int D>
cudaError_t run_tangent(const TArgs& a, int B, int part, cudaStream_t s) {
  if (part == 0) {
    static bool ready = false;
    return launch(tangent_dq_kernel<D>,
                  dim3(a.H, B, (a.S + kOwn - 1) / kOwn), kThreadsT,
                  tangent_dq_smem<D>(), s, a, &ready);
  }
  static bool ready = false;
  return launch(tangent_dkv_kernel<D>,
                dim3(a.KV, B, (a.Sk + kOwn - 1) / kOwn), kThreadsT,
                tangent_dkv_smem<D>(), s, a, &ready);
}

// T1 (tangent_fwd_kernel): one launch, one block per (64 query rows, head,
// batch) on T2's layout: 8 warps, warp w owning rows 16 (w % 4) .. of the
// block's 64 and taking keys 16 (w / 4) .. of each 32-key visited tile.
// S = Q K^T and S' = Q' K^T + Q K'^T are three TF32 products each; P =
// exp(S - lse) from the saved lse, P ⊙ S' and lse' = rowsum(P ⊙ S') in
// float32 on the accumulators; then O = P V and O' = (P ⊙ S') V + P V',
// each visited tile's sums into fresh accumulators added in float32.  The
// halves meet at the end in a fixed order: lse' first (through shared
// memory), then each half's part of o' = O' - lse' O, the second added to
// the first.  o is recomputed as P V rather than read from the forward:
// T1's interface (and the Function that saves its inputs) stays q, k, v,
// lse and the tangents, and at lm-100m's shape the saved sixth of the
// products (0.003 ms at the TF32 rate) costs about what reading o would
// (8.4 MB, 0.0025 ms), which would also add a view to every caller.
// Shared memory: q, q' (64 rows) and k, k', v, v' (32 rows a stage),
// float32 rows of d + 4; two stages at d <= 64 (104.4 KB at d = 64, two
// blocks an SM at 128 registers, a few spilled: one block an SM at 255
// was 11% slower on an H100, PERF.md), one at d = 128 (135.2 KB).  No
// atomics: two calls give the same bits.
//
// Bound at lm-100m's shape (B = 16, S = 256, H = 8, KV = 4, d = 64,
// causal): 3.23 GFLOP of products (S, S' twice, P V, (P ⊙ S') V and P V':
// 6d multiply-adds a pair, chip_smoke.py::flash_tangent_cost), 0.0483 ms at
// the float32 rate; as three TF32 products 9.7 GFLOP, 0.0196 ms at 495
// TFLOP/s; 42 MB of bytes, 0.0126 ms at 3.35 TB/s.

template <int D> constexpr size_t tangent_fwd_smem() {
  return sizeof(float) *
         ((2 * kOwn + 4 * stages<D>() * kVis) * (D + 4) + 2 * kOwn);
}

// S = x0 y0^T and S' = x1 y0^T + x0 y1^T: own rows r0 .. r0 + 15 of the
// tiles x (q, q') against visited rows v0 .. v0 + 15 of the tiles y (k, k').
template <int LD, int KS>
__device__ __forceinline__ void fwd_scores(const float* const (&x)[2],
                                           const float* const (&y)[2],
                                           int r0, int v0, int g, int tg,
                                           float (&s)[2][4],
                                           float (&sd)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = sd[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const FragA a = load_a<LD>(x[0], r0, 8 * kk, g, tg);
    const FragA ta = load_a<LD>(x[1], r0, 8 * kk, g, tg);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const FragB b = load_bt<LD>(y[0], v0 + 8 * j, 8 * kk, g, tg);
      mma3(s[j], a, b);
      mma3(sd[j], ta, b);
      mma3(sd[j], a, load_bt<LD>(y[1], v0 + 8 * j, 8 * kk, g, tg));
    }
  }
}

// O += P V and O' += (P ⊙ S') V + P V' over the warp's 16 visited rows
// v0 .. (the contraction): P and P ⊙ S' accumulator slices as A, each V
// and V' fragment loaded once for the products that read it; each tile's
// sums into fresh accumulators, added in float32.
template <int LD, int KS>
__device__ __forceinline__ void add_pv(float (&ao)[KS][4], float (&at)[KS][4],
                                       const float (&p)[2][4],
                                       const float (&ps)[2][4],
                                       const float* v, const float* tv,
                                       int v0, int g, int tg) {
  FragA pa[2], psa[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    pa[j] = acc_as_a(p[j]);
    psa[j] = acc_as_a(ps[j]);
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    float t[4], td[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const FragB b = load_bk<LD>(v, v0 + 8 * j, 8 * n, g, tg);
      mma3_into(t, pa[j], b, j == 0);
      mma3_into(td, psa[j], b, j == 0);
      mma3(td, pa[j], load_bk<LD>(tv, v0 + 8 * j, 8 * n, g, tg));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ao[n][e] += t[e];
      at[n][e] += td[e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsT, D <= 64 ? 2 : 1)
tangent_fwd_kernel(const __grid_constant__ TArgs a) {
  constexpr int LD = D + 4, KS = D / 8, NS = stages<D>();
  constexpr int OWN = kOwn * LD, VIS = kVis * LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // own: q, q'
  float* sTQ = sQ + OWN;
  float* sVis = sTQ + OWN;                // per stage k, k', v, v'
  float* sDL = sVis + 4 * NS * VIS;       // each half's lse' of the rows
  const float* const own_t[2] = {sQ, sTQ};
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31,
            g = lane >> 2, tg = lane & 3;
  const int rg = w & 3, v0 = 16 * (w >> 2);   // own row group, visited half
  // the last query tiles (the most key tiles, causal) are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn, hq = blockIdx.x,
            b = blockIdx.y;
  const int hk = hq / (a.H / a.KV);
  const long long row_vec = ((long long)b * a.H + hq) * a.S;
  const float *kb = slice(a, a.k, kK, b, hk), *tkb = slice(a, a.tk, kTK, b, hk),
              *vb = slice(a, a.v, kV, b, hk), *tvb = slice(a, a.tv, kTV, b, hk);
  auto fetch = [&](int kt, int st) {      // key tile kt into stage st
    float* s = sVis + 4 * st * VIS;
    const int r = kt * kVis;
    load_tile<kVis, D, kThreadsT>(s, kb, a.st[kK].s, r, a.Sk, a.d, a.vec,
                                  tid);
    load_tile<kVis, D, kThreadsT>(s + VIS, tkb, a.st[kTK].s, r, a.Sk, a.d,
                                  a.vec, tid);
    load_tile<kVis, D, kThreadsT>(s + 2 * VIS, vb, a.st[kV].s, r, a.Sk, a.d,
                                  a.vec, tid);
    load_tile<kVis, D, kThreadsT>(s + 3 * VIS, tvb, a.st[kTV].s, r, a.Sk,
                                  a.d, a.vec, tid);
    hop::cp_commit();
  };
  load_tile<kOwn, D, kThreadsT>(sQ, slice(a, a.q, kQ, b, hq), a.st[kQ].s, q0,
                                a.S, a.d, a.vec, tid);
  load_tile<kOwn, D, kThreadsT>(sTQ, slice(a, a.tq, kTQ, b, hq),
                                a.st[kTQ].s, q0, a.S, a.d, a.vec, tid);
  hop::cp_commit();
  int kt0, kt1;
  keys_of(q0, kOwn, kVis, a.S, a.Sk, a.causal, a.window, &kt0, &kt1);
  if (kt0 < kt1) fetch(kt0, 0);

  const int r0 = 16 * rg + g;             // the thread's rows r0, r0 + 8
  float L2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    L2[r] = row < a.S ? a.lse[row_vec + row] * hop::kLog2e : 0.f;
  }
  const float c = a.scale * hop::kLog2e;
  float ao[KS][4], at[KS][4], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ao[n][e] = at[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kVis, st = NS == 2 ? (kt - kt0) & 1 : 0;
    hop::cp_wait<0>();
    __syncthreads();                      // tile kt landed; the last one read
    if (NS == 2 && kt + 1 < kt1) fetch(kt + 1, st ^ 1);
    const float* sK = sVis + 4 * st * VIS;
    const float* const kk_t[2] = {sK, sK + VIS};

    // S, S': the warp's 16 rows against its 16 visited keys
    float s[2][4], sd[2][4];
    fwd_scores<LD, KS>(own_t, kk_t, 16 * rg, v0, g, tg, s, sd);
    // P = exp(S - lse) into s, P ⊙ S' into sd; a pair the band excludes has
    // the tangent logit 0
    const bool e_ = edge(q0, kOwn, k0, kVis, a);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qp = q0 + r0 + 8 * r;
        const int kp = k0 + v0 + 8 * j + 2 * tg + (e & 1);
        const float p = prob(s[j][e], c, L2[r], e_, qp, kp, a);
        float sp = sd[j][e] * a.scale;
        if (e_) {
          const int delta = qp - kp;
          const bool out = (a.causal && delta < 0) ||
                           (a.window > 0 && delta > a.window - 1);
          sp = out ? 0.f : sp;
        }
        s[j][e] = p;
        sd[j][e] = p * sp;
        dl[r] += sd[j][e];
      }
    // O += P V, O' += (P ⊙ S') V + P V'
    add_pv<LD, KS>(ao, at, s, sd, sK + 2 * VIS, sK + 3 * VIS, v0, g, tg);
    if (NS == 1 && kt + 1 < kt1) {
      __syncthreads();                    // every warp is done with tile kt
      fetch(kt + 1, 0);
    }
  }
  hop::cp_wait<0>();
  __syncthreads();                        // the stages are free

  // lse' of the thread's rows: the quad's sums, then both halves' in order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] = hop::quad_sum(dl[r]);
    if (tg == 0) sDL[(v0 ? kOwn : 0) + r0 + 8 * r] = dl[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) dl[r] = sDL[r0 + 8 * r] + sDL[kOwn + r0 + 8 * r];
  // each half's part of o' = O' - lse' O; the second half's to the first
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) at[n][e] -= dl[e >> 1] * ao[n][e];
  add_halves<KS>(at, sVis, v0 != 0, rg * 32 + lane);
  if (v0) return;
  // T1 writes the views that T2 then reads (const in TArgs)
  float* tlse = const_cast<float*>(a.tlse);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (tg == 0 && row < a.S) tlse[row_vec + row] = dl[r];
  }
  store_rows<D>(at, sQ + 16 * rg * LD,
                const_cast<float*>(a.to) + b * a.st[kTO].b + hq * a.st[kTO].h,
                a.st[kTO].s, q0 + 16 * rg, a.S, a.d, a.vec, lane);
}

template <int D>
cudaError_t run_tangent_fwd(const TArgs& a, int B, cudaStream_t s) {
  static bool ready = false;
  return launch(tangent_fwd_kernel<D>, dim3(a.H, B, (a.S + kOwn - 1) / kOwn),
                kThreadsT, tangent_fwd_smem<D>(), s, a, &ready);
}

}  // namespace tf32

}  // namespace

extern "C" {

int repro_flash_max_head_dim() { return kMaxHeadDim; }

// float32 on Hopper (namespace tf32): the interface of the bf16 forward
// below on float32 views; vec = 1: every pointer and stride 16-byte aligned
// and d % 4 == 0 (tiles by cp.async, 16-byte row stores), 0: element by
// element.
int repro_flash_fwd_f32(const void* q, const void* k, const void* v,
                        void* o, void* lse, const long long* strides, int B,
                        int H, int KV, int S, int Sk, int d, float scale,
                        int causal, int window, int vec, void* stream) {
  if (!hop::valid(B, H, KV, S, Sk, d)) return (int)cudaErrorInvalidValue;
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.sq = hop::strides_at(strides, 0);
  a.sk = hop::strides_at(strides, 1);
  a.sv = hop::strides_at(strides, 2);
  a.so = hop::strides_at(strides, 3);
  a.H = H; a.KV = KV; a.S = S; a.Sk = Sk; a.d = d; a.scale = scale;
  a.causal = causal; a.window = window; a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(d <= 32 ? tf32::run_fwd<32>(a, B, s)
               : d <= 64 ? tf32::run_fwd<64>(a, B, s)
                         : tf32::run_fwd<128>(a, B, s));
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
  a.o = static_cast<float*>(const_cast<void*>(o));
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
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

// Forward-mode tangents, dtype 0 float32 or 1 bfloat16.  `strides` holds
// the (b, s, h) element strides of 13 views, in the order q, k, v, o,
// dout, tq, tk, tv, to, tdout, tdq, tdk, tdv (a view a launch does not
// touch may be given as 0s); each view's d has stride 1.  q-like views
// have H heads, k/v-like views KV, H % KV == 0.  lse, tlse, dsum and tdsum
// are (B, H, S) float32.  bfloat16 runs namespace hop's tangent kernels:
// tiles by TMA where every view the launch uses has 16-byte aligned rows
// (pointer and strides) and d % 8 == 0 (an error if a tensor map cannot be
// made), element by element otherwise.

// T1: o' into `to`, lse' into `tlse`.  float32 on the tensor cores
// (namespace tf32; tiles by cp.async where the views the launch uses have
// 16-byte aligned pointers and strides and d % 4 == 0, element by element
// otherwise).
int repro_flash_fwd_tangent(const void* q, const void* k, const void* v,
                            const void* lse, const void* tq, const void* tk,
                            const void* tv, void* to, void* tlse,
                            const long long* strides, int B, int H, int KV,
                            int S, int Sk, int d, float scale, int causal,
                            int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* views[hop::kTViews] = {q,  k,  v,  nullptr, nullptr,
                                     tq, tk, tv, to,      nullptr,
                                     nullptr, nullptr, nullptr};
  if (dtype == 1)
    return hop::tangent(views, strides, lse, tlse, nullptr, nullptr, B, H,
                        KV, S, Sk, d, scale, causal, window, 0, s);
  if (dtype != 0 || !hop::valid(B, H, KV, S, Sk, d))
    return (int)cudaErrorInvalidValue;
  tf32::TArgs a{};
  int vec = d % 4 == 0;
  for (int i = 0; i < tf32::kViews; ++i) {
    a.st[i] = hop::strides_at(strides, i);
    if (views[i] != nullptr)
      vec = vec && reinterpret_cast<uintptr_t>(views[i]) % 16 == 0 &&
            a.st[i].b % 4 == 0 && a.st[i].s % 4 == 0 && a.st[i].h % 4 == 0;
  }
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lse = static_cast<const float*>(lse);
  a.tq = static_cast<const float*>(tq);
  a.tk = static_cast<const float*>(tk);
  a.tv = static_cast<const float*>(tv);
  a.to = static_cast<const float*>(to);
  a.tlse = static_cast<const float*>(tlse);
  a.H = H; a.KV = KV; a.S = S; a.Sk = Sk; a.d = d; a.scale = scale;
  a.causal = causal; a.window = window; a.vec = vec;
  return (int)(d <= 32 ? tf32::run_tangent_fwd<32>(a, B, s)
               : d <= 64 ? tf32::run_tangent_fwd<64>(a, B, s)
                         : tf32::run_tangent_fwd<128>(a, B, s));
}

// T2.  part 0: dq' into `tdq`, and D, D' into `dsum`, `tdsum`; part 1
// (after part 0): dk' and dv', summed over each KV head's query heads.
// float32 on the tensor cores (namespace tf32; tiles by cp.async where
// every view's pointer and strides are 16-byte aligned and d % 4 == 0,
// element by element otherwise).
int repro_flash_bwd_tangent(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            const void* tq, const void* tk, const void* tv,
                            const void* to, const void* tdout,
                            const void* tlse, void* dsum, void* tdsum,
                            void* tdq, void* tdk, void* tdv,
                            const long long* strides, int B, int H, int KV,
                            int S, int Sk, int d, float scale, int causal,
                            int window, int part, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (part != 0 && part != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* views[hop::kTViews] = {q, k, v, o, dout, tq, tk, tv, to,
                                     tdout, tdq, tdk, tdv};
  if (dtype == 1)
    return hop::tangent(views, strides, lse, tlse, dsum, tdsum, B, H, KV, S,
                        Sk, d, scale, causal, window, 1 + part, s);
  if (!hop::valid(B, H, KV, S, Sk, d)) return (int)cudaErrorInvalidValue;
  tf32::TArgs a{};
  int vec = d % 4 == 0;
  for (int i = 0; i < tf32::kViews; ++i) {
    a.st[i] = hop::strides_at(strides, i);
    vec = vec && reinterpret_cast<uintptr_t>(views[i]) % 16 == 0 &&
          a.st[i].b % 4 == 0 && a.st[i].s % 4 == 0 && a.st[i].h % 4 == 0;
  }
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.tq = static_cast<const float*>(tq);
  a.tk = static_cast<const float*>(tk);
  a.tv = static_cast<const float*>(tv);
  a.to = static_cast<const float*>(to);
  a.tdout = static_cast<const float*>(tdout);
  a.tlse = static_cast<const float*>(tlse);
  a.dsum = static_cast<float*>(dsum);
  a.tdsum = static_cast<float*>(tdsum);
  a.tdq = static_cast<float*>(tdq);
  a.tdk = static_cast<float*>(tdk);
  a.tdv = static_cast<float*>(tdv);
  a.H = H; a.KV = KV; a.S = S; a.Sk = Sk; a.d = d; a.scale = scale;
  a.causal = causal; a.window = window; a.vec = vec;
  return (int)(d <= 32 ? tf32::run_tangent<32>(a, B, part, s)
               : d <= 64 ? tf32::run_tangent<64>(a, B, part, s)
                         : tf32::run_tangent<128>(a, B, part, s));
}

}  // extern "C"
