// Building blocks of the wide routes (flash_attention_wide.cu, ssd_wide.cu):
// SIMT tiles of 64 x 64 in f32 shared memory, 256 threads as 16 (ty) x 16
// (tx), each thread owning rows ty + 16a and columns tx + 16k of a tile.
//
// The wide routes take every shape the Pallas kernels take: any head, state
// or chunk width, and bf16 at any base, stride or width (element-wise loads,
// converted to f32 in shared memory).  No width is a template parameter: a
// product over a width walks it 64 columns at a time (walk), and an output
// wider than a block's tile is split across blocks, each recomputing what it
// needs.  f32 accumulation throughout, sums in a fixed order, no atomics.
#pragma once

#include "common.cuh"

namespace wide {

constexpr int TR = 64;       // rows of a tile, and columns of a walk step
constexpr int NT = 256;      // threads: 16 (ty) x 16 (tx)
constexpr int LD = TR + 1;   // row length of a shared tile: conflict-free column reads

// A strided matrix: element (r, c) at p[r * rs + c * cs]; rows >= rows read 0.
template <typename T>
struct View {
  const T* p;
  long long rs, cs;
  int rows;
};

template <typename T>
__device__ __forceinline__ View<T> view(const T* p, long long rs, long long cs, int rows) {
  View<T> v;
  v.p = p;
  v.rs = rs;
  v.cs = cs;
  v.rows = rows;
  return v;
}

// rows [0, 64) x columns [c0, c0 + w) of m into dst (64 x ld floats), 0
// outside the view's rows or past w columns (w <= width)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int width, View<T> m, int c0, int w) {
  for (int idx = threadIdx.x; idx < TR * width; idx += NT) {
    const int r = idx / width, c = idx - r * width;
    dst[r * ld + c] = (r < m.rows && c < w) ? rt::to_f32(m.p[r * m.rs + (c0 + c) * m.cs]) : 0.f;
  }
}

// s[a][k] = sum over d < D of A(ty + 16a, d) * B(tx + 16k, d): a 64 x 64
// product over any depth, 64 columns of A and B at a time through As / Bs
// (64 x LD floats each).  Begins with a barrier, so the block's earlier
// reads of As / Bs (and of anything read before the call) are done before
// they are overwritten; ends without one.
template <typename TA, typename TB>
__device__ void walk(float (&s)[4][4], View<TA> A, View<TB> B, int D, float* As, float* Bs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[a][k] = 0.f;
  for (int d0 = 0; d0 < D; d0 += TR) {
    const int w = min(TR, D - d0);
    __syncthreads();
    load_tile(As, LD, TR, A, d0, w);
    load_tile(Bs, LD, TR, B, d0, w);
    __syncthreads();
    for (int d = 0; d < w; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = Bs[(tx + 16 * k) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[a][k] += av[a] * bv[k];
    }
  }
}

}  // namespace wide
