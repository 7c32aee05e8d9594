// Float32 products on Hopper's tensor cores as three TF32 mma.sync
// products (m16n8k8, float32 accumulators), shared by the float32 routes of
// ssd_scan.cu (namespace tfs) and ssd_bwd.cu (namespace tbw).
//
// Each float32 operand x is split as it is loaded into a fragment into hi =
// tf32(x) (rounded to nearest, ties away from zero) and lo = x - hi (exact
// in float32; the tensor core reads its top 19 bits), and a product sums lo
// hi + hi lo + hi hi: about 21 bits of each operand, where one TF32 product
// keeps 11 and misses the float32 tolerances.  The fragments are loaded by
// each lane from plain row-major float32 tiles in shared memory, in either
// orientation, which is why these routes use mma.sync and not wgmma: wgmma
// reads TF32 from shared memory only K-major, and the scans' products also
// contract over the rows of a tile (S = (u x)^T B, M^T gy, Z^T C).
//
// Lane (g, t) = (lane / 4, lane % 4) of a warp holds rows g and g + 8 of
// the 16 x 8 accumulator, columns 2 t and 2 t + 1.

#pragma once

#include <stdint.h>

namespace tf32x3 {

struct FragA {                                  // a 16 x 8 A operand
  uint32_t hi[4], lo[4];
};
struct FragB {                                  // an 8 x 8 B operand
  uint32_t hi[2], lo[2];
};

// hi = tf32(x), rounded to nearest with ties away from zero, and lo = x -
// hi, exact in float32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += A B in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}
// A (16 x 8) with A[r][c] = f(r, c): lane (g, t) holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4).
template <typename F>
__device__ __forceinline__ FragA frag_a(const F& f, int g, int t) {
  FragA x;
  split(f(g, t), x.hi[0], x.lo[0]);
  split(f(g + 8, t), x.hi[1], x.lo[1]);
  split(f(g, t + 4), x.hi[2], x.lo[2]);
  split(f(g + 8, t + 4), x.hi[3], x.lo[3]);
  return x;
}
// B (8 x 8) with B[k][n] = f(k, n): lane (g, t) holds (t, g) and (t + 4, g).
template <typename F>
__device__ __forceinline__ FragB frag_b(const F& f, int g, int t) {
  FragB x;
  split(f(t, g), x.hi[0], x.lo[0]);
  split(f(t + 4, g), x.hi[1], x.lo[1]);
  return x;
}
// The fragment operands of row-major float32 tiles (row stride ld):
// A from rows r0 .. of tile s, columns c0 ..
__device__ __forceinline__ FragA rows_a(const float* s, int ld, int r0,
                                        int c0, int g, int t) {
  return frag_a([&](int r, int c) { return s[(r0 + r) * ld + c0 + c]; }, g,
                t);
}
// A from tile s read transposed: A[r][c] = s[c0 + c][r0 + r]
__device__ __forceinline__ FragA cols_a(const float* s, int ld, int r0,
                                        int c0, int g, int t) {
  return frag_a([&](int r, int c) { return s[(c0 + c) * ld + r0 + r]; }, g,
                t);
}
// B whose contraction runs along the tile's columns (the tile's rows are
// B's columns, as gy in x gy^T): B[k][n] = s[n0 + n][k0 + k]
__device__ __forceinline__ FragB cols_b(const float* s, int ld, int k0,
                                        int n0, int g, int t) {
  return frag_b([&](int k, int n) { return s[(n0 + n) * ld + k0 + k]; }, g,
                t);
}
// B whose contraction runs along the tile's rows: B[k][n] = s[k0 + k][n0 + n]
__device__ __forceinline__ FragB rows_b(const float* s, int ld, int k0,
                                        int n0, int g, int t) {
  return frag_b([&](int k, int n) { return s[(k0 + k) * ld + n0 + n]; }, g,
                t);
}

// 16 bytes from src to shared dst, src_bytes of them read (the rest zero);
// the caller waits with cp_async_wait before its barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [r0, r0 + n) of the chunk of a float32 (B, L, X, W) tensor at index
// xi (row0: the chunk's first (b, l) row) into the tile dst, row stride
// ld: zero past the chunk's cs rows and from column W to Wpad (a multiple
// of 4).  Rows whose width is a multiple of 4 floats (from a 16-byte
// aligned tensor) go by cp.async, 16 bytes a copy, all in flight at once
// (the caller waits with cp_async_wait before its barrier); others element
// by element.  All the block's threads take part.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long row0, int X, int xi, int W,
                                      int Wpad, int r0, int n, int cs) {
  if (W % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = Wpad / 4;
    for (int idx = threadIdx.x; idx < n * per_row; idx += blockDim.x) {
      const int r = idx / per_row, col = (idx - r * per_row) * 4;
      const int k = r0 + r;
      const bool in = k < cs && col < W;
      cp_async16(dst + r * ld + col,
                 in ? src + ((row0 + k) * X + xi) * W + col : src,
                 in ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < n * Wpad; idx += blockDim.x) {
    const int r = idx / Wpad, col = idx - r * Wpad, k = r0 + r;
    float v = 0.f;
    if (k < cs && col < W) v = src[((row0 + k) * X + xi) * W + col];
    dst[r * ld + col] = v;
  }
}

}  // namespace tf32x3
