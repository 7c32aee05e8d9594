// Hopper (sm_90a) kernels for the Dif-MAML outer update, bound through a
// plain C interface (ctypes; see ../ops.py).  One launch covers a list of
// parameter leaves, each a contiguous (K, m_i) view of a (K, ...) tensor
// read and written in its own shape, with no packing and no padding.
//
// dif_combine — replaces the Pallas TPU kernel
//   src/repro/kernels/dif_combine/dif_combine.py::dif_combine
//   (_combine_kernel): paper eq. 6b, out[k, m] = sum_l A[l, k] * phi[l, m],
//   float32 accumulation, output in phi's dtype.
//
// fused_combine_update — replaces the Pallas TPU kernel
//   src/repro/kernels/dif_combine/dif_combine.py::fused_combine_update
//   (_fused_kernel): per column, clip scale -> fp32 optimizer moments (adam
//   with bias corrections and decoupled weight decay; momentum; sgd) -> mix
//   (atc A_eff(w+u), consensus A_eff w + u, local w + u) with
//   A_eff = gate * A[sel] + (1 - gate) * I.
//
// Bound on an H100: memory bytes, for both.  The mix does 2K flops per
// element it moves (K <= 64), far below the ~20 flop/byte where the CUDA
// cores' 67 TFLOP/s would bind, so the least time is the bytes at 3.35 TB/s:
// phi read and out written once; for the fused update w, g, mu, nu read
// once and w', mu', nu' written once (the reference module's 4P + 4F
// contract).  Tensor cores do not apply: 2K flops a byte is far below their
// ridge, and wgmma wants 64-row tiles.
//
// Design.  A kernel per leaf is bound by launches (the sine MLP has six
// leaves, and each would need zero-padding copies), and a block that loads
// a whole tile before it mixes and stores overlaps nothing at large M.
// Here:
//   * One launch per leaf list.  The list travels in the kernel parameters
//     (a __grid_constant__ table of pointers, widths and first tiles, as
//     PyTorch's multi_tensor_apply does), so nothing is copied to the card
//     before the launch and a CUDA-graph capture records it whole.  A leaf
//     is cut into column tiles of TC columns; a ragged tail is a short tile
//     and nothing is written past a leaf's end.
//   * A persistent grid of two blocks per SM walks the tiles.  Each block
//     stages A (or A_eff) once and keeps a ring of 2 slots filled with 1-D
//     TMA bulk copies (cp.async.bulk, completion on an mbarrier), one copy
//     per row segment, issued by warp 0; the mix and the stores of one unit
//     overlap the loads of the next.  The combine's unit is a tile (K rows);
//     the fused update's is one row of a tile (w, g and the moments), whose
//     update is elementwise, so its copies are whole TC-column segments
//     (4 KB in f32 at TC = 1024) and the mix input of the K rows collects
//     in an f32 tile in shared memory.  1 KB segments read at a third of
//     the rate (the 256-column copy of kernels/dif_combine/ablate.py).
//   * A small launch (the sine MLP's six leaves), whose tiles give each
//     block at most one, has no ring: its tiles are narrowed to spread the
//     leaves over the blocks, and the threads read every row of a tile at
//     once from device memory.  So does any leaf whose rows are not 16-byte
//     aligned (m = 1, m = 1001, a misaligned view), element by element;
//     aligned rows take 16-byte vectors.
//   * bf16 stays bf16 in shared memory and is widened in registers.  A
//     thread mixes R output rows of its columns at a time from registers,
//     R the least of 2, 4, 6, 8 that covers K in the combine (no row is
//     computed for nothing at the paper's K = 6), so each staged row is
//     read from shared memory once per R output rows, in 16-byte loads free
//     of bank conflicts.
//   * Outputs are stored with the streaming hint: each is written once.
//   * The fused kernel's control is read on the card: either the row and
//     [gate, bc1, bc2] of the single-buffer interface, or a step counter (a
//     device int or a launch parameter) from which it derives sel = step % S
//     and the CommSchedule gate (step % every == every - 1), and Adam's count
//     from which it derives the bias corrections.  No host value that changes
//     from step to step is needed.
// What bounds them now (kernels/dif_combine/ablate.py on an H100): the
// stores.  Without them the f32 combine reads at 89% of 3.35 TB/s; with
// them both kernels move their bytes at 89-97% of a device copy's rate.
// Both kernels keep the plain versions' arithmetic: the round-to-nearest
// intrinsics, so nothing is contracted into an FMA, each expression the one
// repro_torch/optim/optimizers.py evaluates in the same order, and each mix
// summed over l ascending from 0.
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
constexpr int kMaxLeaves = 48;         // leaves a launch's table holds
// Ring depth, for launches whose blocks walk many tiles (bandwidth-bound).
// The tile width is sized for kRingSlots slots, so copies of the source that
// change kStages (up to kRingSlots) keep it.  A small launch, each block
// with at most one tile of at least kMinDirectColumns columns, has no ring:
// its threads read device memory themselves (latency-bound).
constexpr int kStages = 2;
constexpr int kRingSlots = 4;
constexpr int kMinDirectColumns = 128;
constexpr int kBlockBytes = 110 * 1024;  // shared memory a block may use
constexpr int kBlocksPerSM = 2;
constexpr int kBarBytes = 128;         // the ring's mbarriers
constexpr int kMixRows = 8;            // rows the fused mix takes at once

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { KIND_SGD = 0, KIND_MOMENTUM = 1, KIND_ADAM = 2 };
enum { MODE_ATC = 0, MODE_CONSENSUS = 1, MODE_LOCAL = 2 };

// One leaf of a launch: combine uses in[0] (phi) and out[0]; the fused
// update in[0..3] (w, g, mu, nu) and out[0..2] (w', mu', nu').
struct Leaf {
  const void* in[4];
  void* out[3];
  long long m;      // columns of the (K, m) view
  int tile0;        // the leaf's first tile in the launch's tile order
  int bulk;         // every row 16-byte aligned: TMA and 16-byte vectors
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n;            // leaves
  int tiles;        // tiles of all leaves
};

struct Hyper {
  float neg_lr;     // -lr
  float b1, omb1;   // adam: b1, 1 - b1
  float b2, omb2;   // adam: b2, 1 - b2
  float eps;
  float lr_wd;      // lr * weight_decay (0: no decay)
  float beta;       // momentum
};

// Where the fused update's row, gate and bias corrections come from.
struct Control {
  const float* table;     // (S, K, K)
  const int* sel;         // single-buffer interface: the row, or null
  const float* ctl;       // single-buffer interface: [gate, bc1, bc2]
  const void* step;       // device step counter (int32 or int64), or null
  long long step_host;    // the step when `step` is null
  const int* count;       // adam: its step count before this update
  const float* scale;     // (K,) clip scale, or null for 1
  int step64;             // `step` is int64
  int S, every;
};

struct CombineArgs {
  const float* A;         // (K, K)
  int K, KP, TC;          // agents, K rounded up to R, tile width
  int stages;             // ring depth of this launch (0: no ring)
  Table t;
};

struct FusedArgs {
  Control c;
  Hyper h;
  int K, KP, TC;
  int stages;
  Table t;
};

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

// The integer type a Vec of B bytes is stored as.
template <int B> struct Word;
template <> struct Word<16> { using type = int4; };
template <> struct Word<8> { using type = int2; };
template <> struct Word<4> { using type = int; };
template <> struct Word<2> { using type = short; };

// To device memory, with the streaming (evict-first) hint: each output is
// written once and not read again by the kernel.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[N]) {
  using W = typename Word<sizeof(Vec<T, N>)>::type;
  Vec<T, N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = from_f32<T>(in[i]);
  __stcs(reinterpret_cast<W*>(p), *reinterpret_cast<const W*>(&x));
}

// To shared memory.
template <int N>
__device__ __forceinline__ void put_vec(float* p, const float (&in)[N]) {
  Vec<float, N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = in[i];
  *reinterpret_cast<Vec<float, N>*>(p) = x;
}

// --- mbarriers and bulk copies ----------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --- tiles ------------------------------------------------------------------

// The leaf of `tile`; a block's tiles rise, so its cursor only moves on.
__device__ __forceinline__ int leaf_of(const Table& t, int& cursor,
                                       int tile) {
  while (cursor + 1 < t.n && tile >= t.leaf[cursor + 1].tile0) ++cursor;
  return cursor;
}

struct TileAt {
  int li;           // leaf
  long long col0;   // first column
  int cols;         // columns (TC, or fewer at the leaf's end)
};

__device__ __forceinline__ TileAt tile_at(const Table& t, int& cursor,
                                          int tile, int TC) {
  TileAt a;
  a.li = leaf_of(t, cursor, tile);
  const Leaf& L = t.leaf[a.li];
  a.col0 = (long long)(tile - L.tile0) * TC;
  const long long left = L.m - a.col0;
  a.cols = left < TC ? (int)left : TC;
  return a;
}

// Warp 0 fills ring slot q % stages with unit q of this block.  A unit is
// rows [row0, row0 + nrows) of buffers 0..NB-1 of one tile: the combine's
// unit is a whole tile (upt = 1 unit a tile, all K rows), the fused
// update's one row of a tile (upt = K).  For a bulk leaf lane 0 arms the
// slot's barrier with the unit's bytes and the lanes copy one row segment
// each; for any other leaf lane 0 only arrives (the threads read that unit
// from device memory themselves).  Buffer b starts at slot + off[b] and
// holds nrows rows of TC elements of size[b] bytes.
template <int NB>
__device__ __forceinline__ void fill_slot(const Table& t, int& cursor, int q,
                                          int upt, int K, int TC, int stages,
                                          unsigned char* ring, int slot_bytes,
                                          const int (&size)[NB],
                                          const int (&off)[NB],
                                          uint64_t* full) {
  const int tile = blockIdx.x + (q / upt) * gridDim.x;
  if (tile >= t.tiles) return;
  const int nrows = upt == 1 ? K : 1, row0 = upt == 1 ? 0 : q % upt;
  const TileAt at = tile_at(t, cursor, tile, TC);
  const Leaf& L = t.leaf[at.li];
  const int s = q % stages;
  const int lane = threadIdx.x & 31;
  if (!L.bulk) {
    if (lane == 0) mbar_arrive(full + s);
    return;
  }
  uint32_t bytes = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) bytes += (uint32_t)(nrows * at.cols * size[b]);
  if (lane == 0) mbar_expect(full + s, bytes);
  __syncwarp();
  unsigned char* slot = ring + (size_t)s * slot_bytes;
  for (int r = lane; r < NB * nrows; r += 32) {
    const int b = r / nrows, i = r - b * nrows;
    int sz = size[0], of = off[0];
#pragma unroll
    for (int c = 1; c < NB; ++c)
      if (b == c) sz = size[c], of = off[c];
    const char* src = static_cast<const char*>(L.in[b]) +
                      ((long long)(row0 + i) * L.m + at.col0) * sz;
    bulk_load(slot + of + (size_t)i * TC * sz, src, (uint32_t)(at.cols * sz),
              full + s);
  }
}

// V columns of output rows k < K: out_k = sum_l As[l, k] * x_l, l ascending
// from 0, with x_l = src[l * ld .. + V) in shared memory (T widened to
// f32); consensus then adds u_k = u[k * ld ..].  R rows at a time, each
// staged row read once per R output rows.  Row k goes to dst + k * m
// (global memory).  As is (K, KP), KP a multiple of R, zero past column K.
template <int R, int V, typename T, typename O, bool ADD_U>
__device__ __forceinline__ void mix_columns(const float* __restrict__ As,
                                            int K, int KP, const T* src,
                                            int ld, const float* u, O* dst,
                                            long long m) {
  static_assert(R % 2 == 0, "A is read two floats at a time");
  for (int kc = 0; kc < K; kc += R) {
    float acc[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
    for (int l = 0; l < K; ++l) {
      float x[V], a[R];
      load_vec<T, V>(src + (size_t)l * ld, x);
#pragma unroll
      for (int r = 0; r < R; r += 2) {
        const float2 a2 =
            *reinterpret_cast<const float2*>(As + l * KP + kc + r);
        a[r] = a2.x;
        a[r + 1] = a2.y;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r][v] = __fadd_rn(acc[r][v], __fmul_rn(a[r], x[v]));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = kc + r;
      if (k >= K) break;
      if (ADD_U) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r][v] = __fadd_rn(acc[r][v], u[(size_t)k * ld + v]);
      }
      store_vec<O, V>(dst + (long long)k * m, acc[r]);
    }
  }
}

// Shared memory: the barriers, then As (K, KP) f32, then the ring.
__host__ __device__ inline int a_bytes(int K, int KP) {
  return (K * KP * 4 + 127) / 128 * 128;
}

// The ring's barriers, one a slot.
__device__ __forceinline__ void init_ring(uint64_t* full, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s);
    mbar_init_fence();
  }
}

// ---------------------------------------------------------------------------
// dif_combine: a ring unit is a tile, all K rows
// ---------------------------------------------------------------------------

template <typename P, int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
combine_kernel(const __grid_constant__ CombineArgs a) {
  constexpr int V = 16 / sizeof(P);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* As = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned char* ring = smem + kBarBytes + a_bytes(a.K, a.KP);
  const int K = a.K, KP = a.KP, TC = a.TC;
  const int slot_bytes = K * TC * (int)sizeof(P);
  const int size[1] = {(int)sizeof(P)};
  const int off[1] = {0};

  // the ring's first copies go out before A is staged, so the two loads
  // overlap
  init_ring(full, a.stages);
  __syncthreads();
  int fill_cursor = 0, cursor = 0;
  const int stages = a.stages;
  if (threadIdx.x < 32)
    for (int j = 0; j < stages; ++j)
      fill_slot<1>(a.t, fill_cursor, j, 1, K, TC, stages, ring, slot_bytes,
                   size, off, full);
  for (int i = threadIdx.x; i < K * KP; i += kThreads) {
    const int l = i / KP, k = i - l * KP;
    As[i] = k < K ? a.A[l * K + k] : 0.f;
  }
  __syncthreads();

  for (int j = 0;; ++j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= a.t.tiles) break;
    const TileAt at = tile_at(a.t, cursor, tile, TC);
    const Leaf& L = a.t.leaf[at.li];
    P* dst = static_cast<P*>(L.out[0]) + at.col0;
    const P* src = static_cast<const P*>(L.in[0]) + at.col0;
    if (stages == 0 || !L.bulk) {
      // from device memory: a small launch, or rows not 16-byte aligned
      // (whose ring unit carries no data; it is refilled once every thread
      // has seen its phase, or a slow warp could wait on the next one)
      if (stages > 0) {
        mbar_wait(full + j % stages, (j / stages) & 1);
        __syncthreads();
        if (threadIdx.x < 32)
          fill_slot<1>(a.t, fill_cursor, j + stages, 1, K, TC, stages, ring,
                       slot_bytes, size, off, full);
      }
      if (L.bulk) {
        for (int c = threadIdx.x * V; c < at.cols; c += kThreads * V)
          mix_columns<R, V, P, P, false>(As, K, KP, src + c, L.m, nullptr,
                                         dst + c, L.m);
      } else {
        for (int c = threadIdx.x; c < at.cols; c += kThreads)
          mix_columns<R, 1, P, P, false>(As, K, KP, src + c, L.m, nullptr,
                                         dst + c, L.m);
      }
      continue;
    }
    const int s = j % stages;
    const P* st = reinterpret_cast<const P*>(ring + (size_t)s * slot_bytes);
    mbar_wait(full + s, (j / stages) & 1);
    for (int c = threadIdx.x * V; c < at.cols; c += kThreads * V)
      mix_columns<R, V, P, P, false>(As, K, KP, st + c, TC, nullptr, dst + c,
                                     L.m);
    __syncthreads();    // slot s is read: refill it
    if (threadIdx.x < 32)
      fill_slot<1>(a.t, fill_cursor, j + stages, 1, K, TC, stages, ring,
                   slot_bytes, size, off, full);
  }
}

// ---------------------------------------------------------------------------
// fused_combine_update: a ring unit is one row of a tile (w, g and the
// moments), so a copy is a whole TC-column row segment; the mix input of
// all K rows of the tile collects in f32 tiles (phi, and u for consensus)
// ---------------------------------------------------------------------------

// Moment type: adam keeps fp32 moments, momentum a velocity in the param
// dtype, sgd none.
template <typename P, int KIND>
using MomT = typename std::conditional<KIND == KIND_ADAM, float, P>::type;

// Buffers staged per row: w and g, then the moments.
template <int KIND>
__host__ __device__ constexpr int staged_buffers() {
  return KIND == KIND_ADAM ? 4 : KIND == KIND_MOMENTUM ? 3 : 2;
}

// f32 (K, TC) tiles a block keeps for the mix: phi, and u for consensus.
template <int MODE>
__host__ __device__ constexpr int mix_tiles() {
  return MODE == MODE_LOCAL ? 0 : MODE == MODE_CONSENSUS ? 2 : 1;
}

// The update of V columns of one row: reads w, g, mu, nu (shared or global
// memory), writes mu', nu' and, in local mode, w' (global); otherwise leaves
// the mix input (w + u for atc, w for consensus) in phi and u in ut.
template <typename P, int KIND, int MODE, int V>
__device__ __forceinline__ void update_columns(
    const Hyper& h, float sc, float bc1, float bc2, const P* w, const P* g,
    const MomT<P, KIND>* mu, const float* nu, P* w_out, MomT<P, KIND>* mu_out,
    float* nu_out, float* phi, float* ut) {
  float w32[V], g32[V], u[V];
  load_vec<P, V>(w, w32);
  load_vec<P, V>(g, g32);
#pragma unroll
  for (int v = 0; v < V; ++v) g32[v] = __fmul_rn(g32[v], sc);
  if (KIND == KIND_ADAM) {
    float m[V], n[V];
    load_vec<float, V>(reinterpret_cast<const float*>(mu), m);
    load_vec<float, V>(nu, n);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      m[v] = __fadd_rn(__fmul_rn(h.b1, m[v]), __fmul_rn(h.omb1, g32[v]));
      n[v] = __fadd_rn(__fmul_rn(h.b2, n[v]),
                       __fmul_rn(h.omb2, __fmul_rn(g32[v], g32[v])));
      u[v] = __fdiv_rn(__fmul_rn(h.neg_lr, __fdiv_rn(m[v], bc1)),
                       __fadd_rn(__fsqrt_rn(__fdiv_rn(n[v], bc2)), h.eps));
      if (h.lr_wd != 0.f) u[v] = __fsub_rn(u[v], __fmul_rn(h.lr_wd, w32[v]));
    }
    store_vec<float, V>(reinterpret_cast<float*>(mu_out), m);
    store_vec<float, V>(nu_out, n);
  } else if (KIND == KIND_MOMENTUM) {
    float vel[V];
    load_vec<P, V>(reinterpret_cast<const P*>(mu), vel);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      vel[v] = __fadd_rn(__fmul_rn(h.beta, vel[v]), g32[v]);
      u[v] = __fmul_rn(h.neg_lr, vel[v]);
    }
    store_vec<P, V>(reinterpret_cast<P*>(mu_out), vel);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) u[v] = __fmul_rn(h.neg_lr, g32[v]);
  }
  if (MODE == MODE_LOCAL) {
    float nw[V];
#pragma unroll
    for (int v = 0; v < V; ++v) nw[v] = __fadd_rn(w32[v], u[v]);
    store_vec<P, V>(w_out, nw);
  } else {
    if (MODE == MODE_ATC) {
#pragma unroll
      for (int v = 0; v < V; ++v) w32[v] = __fadd_rn(w32[v], u[v]);
    }
    put_vec<V>(phi, w32);
    if (MODE == MODE_CONSENSUS) put_vec<V>(ut, u);
  }
}

template <typename P, int KIND, int MODE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_kernel(const __grid_constant__ FusedArgs a) {
  using MT = MomT<P, KIND>;
  constexpr int NB = staged_buffers<KIND>();
  constexpr int V = 4;               // columns a thread updates at once
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* As = reinterpret_cast<float*>(smem + kBarBytes);
  const int K = a.K, KP = a.KP, TC = a.TC;
  float* scs = As + K * KP;          // (K,) clip scale
  unsigned char* ring =
      smem + kBarBytes + a_bytes(K, KP) + (K * 4 + 127) / 128 * 128;
  int size[NB], off[NB];
  {
    const int sizes[4] = {(int)sizeof(P), (int)sizeof(P), (int)sizeof(MT), 4};
    int o = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      size[b] = sizes[b];
      off[b] = o;
      o += TC * sizes[b];
    }
  }
  const int slot_bytes = off[NB - 1] + TC * size[NB - 1];
  float* phi = reinterpret_cast<float*>(ring + (size_t)a.stages * slot_bytes);
  float* ut = phi + K * TC;

  // the ring's first copies go out before the control is read, so their
  // loads overlap
  init_ring(full, a.stages);
  __syncthreads();
  int fill_cursor = 0, cursor = 0;
  const int stages = a.stages;
  if (threadIdx.x < 32)
    for (int q = 0; q < stages; ++q)
      fill_slot<NB>(a.t, fill_cursor, q, K, K, TC, stages, ring, slot_bytes,
                    size, off, full);

  // control: the schedule row, the gate and the bias corrections (Adam's
  // count is read first, so its load overlaps the table's)
  const Control& c = a.c;
  const int count =
      KIND == KIND_ADAM && c.ctl == nullptr ? *c.count : 0;
  int sel;
  float gate, bc1 = 1.f, bc2 = 1.f;
  if (c.ctl != nullptr) {
    sel = c.sel[0];
    gate = c.ctl[0];
    bc1 = c.ctl[1];
    bc2 = c.ctl[2];
  } else {
    const long long step =
        c.step == nullptr ? c.step_host
        : c.step64 ? *static_cast<const long long*>(c.step)
                   : (long long)*static_cast<const int*>(c.step);
    long long r = step % c.S, e = step % c.every;
    sel = (int)(r < 0 ? r + c.S : r);
    gate = (e < 0 ? e + c.every : e) == c.every - 1 ? 1.f : 0.f;
  }
  if (MODE != MODE_LOCAL) {
    const float keep = __fsub_rn(1.f, gate);
    for (int i = threadIdx.x; i < K * KP; i += kThreads) {
      const int l = i / KP, k = i - l * KP;
      float v = 0.f;
      if (k < K) {
        // an out-of-range row selects nothing, as the one-hot gather does
        const float x = (sel >= 0 && sel < c.S)
                            ? c.table[((long long)sel * K + l) * K + k]
                            : 0.f;
        v = __fadd_rn(__fmul_rn(gate, x), __fmul_rn(keep, l == k ? 1.f : 0.f));
      }
      As[i] = v;
    }
  }
  for (int l = threadIdx.x; l < K; l += kThreads)
    scs[l] = c.scale != nullptr ? c.scale[l] : 1.f;
  if (KIND == KIND_ADAM && c.ctl == nullptr) {
    const float t = __int2float_rn(count + 1);
    bc1 = __fsub_rn(1.f, powf(a.h.b1, t));
    bc2 = __fsub_rn(1.f, powf(a.h.b2, t));
  }
  __syncthreads();

  for (int j = 0;; ++j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= a.t.tiles) break;
    const TileAt at = tile_at(a.t, cursor, tile, TC);
    const Leaf& L = a.t.leaf[at.li];
    P* w_out = static_cast<P*>(L.out[0]) + at.col0;
    MT* mu_out = static_cast<MT*>(L.out[1]) + at.col0;
    float* nu_out = static_cast<float*>(L.out[2]) + at.col0;
    const int q0 = j * K;          // the tile's first ring unit
    if (stages == 0 || !L.bulk) {
      // every row in one pass from device memory: a small launch, or rows
      // not 16-byte aligned (whose ring units carry no data; each is
      // refilled once every thread has seen its phase, or a slow warp could
      // wait on the next one); 16-byte vectors where the rows are aligned
      for (int l = 0; l < K && stages > 0; ++l) {
        mbar_wait(full + (q0 + l) % stages, ((q0 + l) / stages) & 1);
        __syncthreads();
        if (threadIdx.x < 32)
          fill_slot<NB>(a.t, fill_cursor, q0 + l + stages, K, K, TC, stages,
                        ring, slot_bytes, size, off, full);
      }
      const P* w = static_cast<const P*>(L.in[0]) + at.col0;
      const P* g = static_cast<const P*>(L.in[1]) + at.col0;
      const MT* mu = static_cast<const MT*>(L.in[2]) + at.col0;
      const float* nu = static_cast<const float*>(L.in[3]) + at.col0;
      const int vec = L.bulk ? V : 1, G = at.cols / vec;
      for (int i = threadIdx.x; i < K * G; i += kThreads) {
        const int l = i / G, cc = (i - l * G) * vec;
        const long long go = (long long)l * L.m + cc;
        float* ph = phi + l * TC + cc;
        float* u = ut + l * TC + cc;
        if (L.bulk)
          update_columns<P, KIND, MODE, V>(
              a.h, scs[l], bc1, bc2, w + go, g + go, mu + go, nu + go,
              w_out + go, mu_out + go, nu_out + go, ph, u);
        else
          update_columns<P, KIND, MODE, 1>(
              a.h, scs[l], bc1, bc2, w + go, g + go, mu + go, nu + go,
              w_out + go, mu_out + go, nu_out + go, ph, u);
      }
      __syncthreads();  // phi is whole
    } else {
      // one row of the ring at a time
      for (int l = 0; l < K; ++l) {
        const int q = q0 + l, s = q % stages;
        mbar_wait(full + s, (q / stages) & 1);
        const long long go = (long long)l * L.m;
        const unsigned char* slot = ring + (size_t)s * slot_bytes;
        const P* w = reinterpret_cast<const P*>(slot);
        const P* g = reinterpret_cast<const P*>(slot + off[1]);
        const MT* mu = reinterpret_cast<const MT*>(slot + off[NB > 2 ? 2 : 0]);
        const float* nu = reinterpret_cast<const float*>(slot + off[NB - 1]);
        for (int cc = threadIdx.x * V; cc < at.cols; cc += kThreads * V)
          update_columns<P, KIND, MODE, V>(
              a.h, scs[l], bc1, bc2, w + cc, g + cc, mu + cc, nu + cc,
              w_out + go + cc, mu_out + go + cc, nu_out + go + cc,
              phi + l * TC + cc, ut + l * TC + cc);
        __syncthreads();  // slot s is read (after row K - 1, phi is whole)
        if (threadIdx.x < 32)
          fill_slot<NB>(a.t, fill_cursor, q + stages, K, K, TC, stages, ring,
                        slot_bytes, size, off, full);
      }
    }
    if (MODE != MODE_LOCAL) {
      if (L.bulk) {
        for (int cc = threadIdx.x * V; cc < at.cols; cc += kThreads * V)
          mix_columns<kMixRows, V, float, P, MODE == MODE_CONSENSUS>(
              As, K, KP, phi + cc, TC, ut + cc, w_out + cc, L.m);
      } else {
        for (int cc = threadIdx.x; cc < at.cols; cc += kThreads)
          mix_columns<kMixRows, 1, float, P, MODE == MODE_CONSENSUS>(
              As, K, KP, phi + cc, TC, ut + cc, w_out + cc, L.m);
      }
      __syncthreads();  // phi is read: the next tile may write it
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tables, tile widths, launches
// ---------------------------------------------------------------------------

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Tile width: `slots` ring slots of `slot_column` bytes a column and the f32
// mix tiles (`mix_column`) fit kBlockBytes beside `fixed`; a multiple of
// kThreads where it reaches that, else of 16 columns (16-byte row segments
// for bulk copies), at most `cap`.
struct Ring {
  int TC;
  size_t shmem;
};

Ring ring_for(int fixed, int slot_column, int mix_column, int cap) {
  const int per_column = kRingSlots * slot_column + mix_column;
  int tc = (kBlockBytes - fixed) / per_column;
  if (tc > cap) tc = cap;
  tc = tc >= kThreads ? tc / kThreads * kThreads : tc / 16 * 16;
  if (tc < 16) tc = 16;
  return Ring{tc, fixed + (size_t)per_column * tc};
}

// Fills t from leaves [first, first + n): pointers (in[0..nin), out[0..nout))
// in `ptrs` (7 a leaf), widths in `m`.  A leaf is bulk when every pointer is
// 16-byte aligned and every row a whole number of 16-byte segments
// (`elem[b]` bytes an element of buffer b: ins, then outs).
void fill_table(Table& t, const void* const* ptrs, const long long* m,
                int first, int n, int TC, const int* elem) {
  t.n = n;
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    Leaf& L = t.leaf[i];
    const void* const* p = ptrs + (size_t)(first + i) * 7;
    bool bulk = true;
    for (int b = 0; b < 7; ++b) {
      if (b < 4) L.in[b] = p[b];
      else L.out[b - 4] = const_cast<void*>(p[b]);
      if (p[b] != nullptr)
        bulk = bulk && aligned16(p[b]) && (m[first + i] * elem[b]) % 16 == 0;
    }
    L.m = m[first + i];
    L.tile0 = (int)tiles;
    L.bulk = bulk ? 1 : 0;
    tiles += (L.m + TC - 1) / TC;
  }
  t.tiles = (int)tiles;
}

template <typename Kernel>
cudaError_t set_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

unsigned grid_for(int tiles) {
  const int most = kBlocksPerSM * sm_count();
  return (unsigned)(tiles < most ? tiles : most);
}

// One launch of `kernel` per kMaxLeaves leaves; `args` carries everything
// but the table, the tile width and the ring depth.  A launch whose leaves
// fit one tile a block, at a width that spreads them over the blocks (at
// least kMinDirectColumns, at most ring.TC), reads device memory directly
// (stages = 0); any other takes the ring at ring.TC, kStages deep.
template <typename Args, typename Kernel>
int launch_tables(Kernel kernel, Args& args, const Ring& ring, int n,
                  const void* const* ptrs, const long long* m,
                  const int* elem, cudaStream_t stream) {
  cudaError_t err = set_shared(kernel, ring.shmem);
  if (err != cudaSuccess) return (int)err;
  const int most = kBlocksPerSM * sm_count();
  for (int first = 0; first < n; first += kMaxLeaves) {
    const int count = n - first < kMaxLeaves ? n - first : kMaxLeaves;
    long long cols = 0;
    for (int i = first; i < first + count; ++i) cols += m[i];
    int tc = (int)(((cols + most - 1) / most + 15) / 16 * 16);
    if (tc < kMinDirectColumns) tc = kMinDirectColumns;
    bool direct = tc <= ring.TC;
    if (direct) {
      fill_table(args.t, ptrs, m, first, count, tc, elem);
      direct = args.t.tiles <= most;       // the leaves' tails add tiles
    }
    if (!direct) {
      tc = ring.TC;
      fill_table(args.t, ptrs, m, first, count, tc, elem);
    }
    if (args.t.tiles == 0) continue;
    args.TC = tc;
    args.stages = direct ? 0 : kStages;
    kernel<<<grid_for(args.t.tiles), kThreads, ring.shmem, stream>>>(args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The combine mixes R output rows at a time: the least of 2, 4, 6, 8 that
// covers K, so no row is computed for nothing at K <= 8 (the paper's K = 6).
template <typename P, int R>
int launch_combine_rows(const float* A, int K, int n,
                        const void* const* ptrs, const long long* m,
                        cudaStream_t stream) {
  CombineArgs args;
  args.A = A;
  args.K = K;
  args.KP = (K + R - 1) / R * R;
  const Ring ring = ring_for(kBarBytes + a_bytes(K, args.KP),
                             K * (int)sizeof(P), 0,
                             kThreads * 16 / (int)sizeof(P));
  const int elem[7] = {(int)sizeof(P), 0, 0, 0, (int)sizeof(P), 0, 0};
  return launch_tables(combine_kernel<P, R>, args, ring, n, ptrs, m, elem,
                       stream);
}

template <typename P>
int launch_combine(const float* A, int K, int n, const void* const* ptrs,
                   const long long* m, cudaStream_t s) {
  if (K <= 2) return launch_combine_rows<P, 2>(A, K, n, ptrs, m, s);
  if (K <= 4) return launch_combine_rows<P, 4>(A, K, n, ptrs, m, s);
  if (K <= 6) return launch_combine_rows<P, 6>(A, K, n, ptrs, m, s);
  return launch_combine_rows<P, 8>(A, K, n, ptrs, m, s);
}

template <typename P, int KIND, int MODE>
int launch_fused(const Control& c, const Hyper& h, int K, int n,
                 const void* const* ptrs, const long long* m,
                 cudaStream_t stream) {
  using MT = MomT<P, KIND>;
  constexpr int NB = staged_buffers<KIND>();
  const int sizes[4] = {(int)sizeof(P), (int)sizeof(P), (int)sizeof(MT), 4};
  int column = 0;          // bytes of one column of one row, all buffers
  for (int b = 0; b < NB; ++b) column += sizes[b];
  FusedArgs args;
  args.c = c;
  args.h = h;
  args.K = K;
  args.KP = (K + kMixRows - 1) / kMixRows * kMixRows;
  const int fixed =
      kBarBytes + a_bytes(K, args.KP) + (K * 4 + 127) / 128 * 128;
  const Ring ring =
      ring_for(fixed, column, mix_tiles<MODE>() * K * 4, 1024);
  const int elem[7] = {(int)sizeof(P), (int)sizeof(P), (int)sizeof(MT), 4,
                       (int)sizeof(P), (int)sizeof(MT), 4};
  return launch_tables(fused_kernel<P, KIND, MODE>, args, ring, n, ptrs, m,
                       elem, stream);
}

template <typename P, int KIND>
int launch_fused_kind(int mode, const Control& c, const Hyper& h, int K,
                      int n, const void* const* ptrs, const long long* m,
                      cudaStream_t s) {
  if (mode == MODE_ATC)
    return launch_fused<P, KIND, MODE_ATC>(c, h, K, n, ptrs, m, s);
  if (mode == MODE_CONSENSUS)
    return launch_fused<P, KIND, MODE_CONSENSUS>(c, h, K, n, ptrs, m, s);
  return launch_fused<P, KIND, MODE_LOCAL>(c, h, K, n, ptrs, m, s);
}

template <typename P>
int launch_fused_dtype(int kind, int mode, const Control& c, const Hyper& h,
                       int K, int n, const void* const* ptrs,
                       const long long* m, cudaStream_t s) {
  if (kind == KIND_ADAM)
    return launch_fused_kind<P, KIND_ADAM>(mode, c, h, K, n, ptrs, m, s);
  if (kind == KIND_MOMENTUM)
    return launch_fused_kind<P, KIND_MOMENTUM>(mode, c, h, K, n, ptrs, m, s);
  return launch_fused_kind<P, KIND_SGD>(mode, c, h, K, n, ptrs, m, s);
}

}  // namespace

extern "C" {

int repro_max_agents() { return kMaxK; }
int repro_max_leaves() { return kMaxLeaves; }

// out_i (K, m_i) = A^T phi_i for n leaves of one dtype, kMaxLeaves a launch.
// ptrs: 7 a leaf (phi, 3 unused, out, 2 unused); A (K, K) float32.
int repro_dif_combine_leaves(const void* A, int K, int n,
                             const void* const* ptrs, const long long* m,
                             int dtype, void* stream) {
  if (K < 1 || K > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  if (dtype == DT_F32) return launch_combine<float>(a, K, n, ptrs, m, s);
  if (dtype == DT_BF16)
    return launch_combine<__nv_bfloat16>(a, K, n, ptrs, m, s);
  return (int)cudaErrorInvalidValue;
}

// One-pass combine-then-update over n leaves of one dtype; see the header.
// ptrs: 7 a leaf (w, g, mu, nu, w', mu', nu'; null where the kind has no
// such moment).  Control: either sel and ctl (the row, [gate, bc1, bc2]),
// or the step (device `step`, int64 when step64, else `step_host`) with S
// and `every`, and for adam `count`.  scale: (K,) or null.
int repro_fused_update_leaves(
    const void* table, const void* sel, const void* ctl, const void* step,
    long long step_host, int step64, const void* count, int S, int every,
    const void* scale, int K, int n, const void* const* ptrs,
    const long long* m, int dtype, int kind, int mode, float neg_lr, float b1,
    float omb1, float b2, float omb2, float eps, float lr_wd, float beta,
    void* stream) {
  if (K < 1 || K > kMaxK || n < 0 || S < 1 || every < 1)
    return (int)cudaErrorInvalidValue;
  if (kind < KIND_SGD || kind > KIND_ADAM) return (int)cudaErrorInvalidValue;
  if (mode < MODE_ATC || mode > MODE_LOCAL) return (int)cudaErrorInvalidValue;
  if ((sel == nullptr) != (ctl == nullptr)) return (int)cudaErrorInvalidValue;
  if (ctl == nullptr && kind == KIND_ADAM && count == nullptr)
    return (int)cudaErrorInvalidValue;
  Control c{static_cast<const float*>(table), static_cast<const int*>(sel),
            static_cast<const float*>(ctl),   step,
            step_host,                        static_cast<const int*>(count),
            static_cast<const float*>(scale), step64,
            S,                                every};
  Hyper h{neg_lr, b1, omb1, b2, omb2, eps, lr_wd, beta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_fused_dtype<float>(kind, mode, c, h, K, n, ptrs, m, s);
  if (dtype == DT_BF16)
    return launch_fused_dtype<__nv_bfloat16>(kind, mode, c, h, K, n, ptrs, m,
                                             s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
