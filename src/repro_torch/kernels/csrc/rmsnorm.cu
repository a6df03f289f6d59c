// Fused RMSNorm for Hopper, and its backward.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas
//           (body _rmsnorm_kernel).
// Computes: out = x * rsqrt(mean(x^2) + eps) * (1 + scale), statistics in
//           f32, result cast back to x's dtype.  x is (T, D) row-major.
//           The backward (rmsnorm_bwd, at the end of this file) has no
//           Pallas counterpart: JAX differentiates the jnp rmsnorm of
//           src/repro/models/layers.py.
//
// Bound: device-memory bytes (one read of x, one write of out, ~4 flops per
// element), so each byte is read once, 16 bytes a thread at a time.  Design:
// a row belongs to `tpr` neighbouring threads (a power of two); the block
// holds 128 / tpr rows when a row is shorter than a warp's worth of
// vectors, or one row of up to 256 threads.  Each thread loads VPT vectors
// of VEC elements (uint4: 8 bf16 or 4 f32), neighbouring threads on
// neighbouring 16 bytes, and keeps them in registers across the reduction,
// so there is no second pass over x; (1 + scale) is loaded the same way
// once per thread.  The sum of squares reduces with warp shuffles, and
// through shared memory only when a row spans several warps.  The grid
// holds at most 1024 threads an SM; a block walks its rows with a stride
// and loads its share of the next row before it reduces and writes the
// current one, so loads stay in flight across rows.  Registers hold the
// loaded words packed (bf16 pairs), not as f32.  VPT = 0 is
// the looped variant for rows too long for registers (it reads x twice);
// VEC = 1 is the scalar path for a D that is not a multiple of the vector
// or a base that is not 16-byte aligned.  The launch plan (VEC, VPT, tpr,
// rows per block, blocks) is chosen in Python (rmsnorm/ops.py::launch_plan).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_VPT = 4;

// the N elements of T packed in 32-bit words w, as f32
template <typename T, int N>
__device__ __forceinline__ void words_to_f32(const uint32_t* w, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 4)
      f[i] = __uint_as_float(w[i]);
    else  // bf16 is the high half of an f32
      f[i] = __uint_as_float((i & 1) ? (w[i / 2] & 0xffff0000u) : (w[i / 2] << 16));
  }
}

// N elements of T as a thread holds them between loading and using them:
// packed 32-bit words, filled by 16-byte (or, for 8 bytes, 8-byte) vector
// loads from an address aligned to them ...
template <typename T, int N, bool PACKED = (N * sizeof(T) >= 8)>
struct Raw {
  static constexpr int W = N * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[W];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[c];
        w[4 * c] = u.x, w[4 * c + 1] = u.y, w[4 * c + 2] = u.z, w[4 * c + 3] = u.w;
      }
    } else {
      static_assert(W == 2, "8 or 16·k bytes");
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    }
  }
  __device__ __forceinline__ void get(float (&f)[N]) const { words_to_f32<T, N>(w, f); }
};

// ... or, on the scalar path, element by element as f32
template <typename T, int N>
struct Raw<T, N, false> {
  float v[N];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = rt::to_f32(p[i]);
  }
  __device__ __forceinline__ void get(float (&f)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = v[i];
  }
};

template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* p, const float (&f)[N]) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  if constexpr (bytes % 16 == 0) {
    uint32_t w[bytes / 4];
#pragma unroll
    for (int i = 0; i < bytes / 4; ++i) {
      if constexpr (sizeof(T) == 4)
        w[i] = __float_as_uint(f[i]);
      else
        w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))) << 16);
    }
#pragma unroll
    for (int c = 0; c < bytes / 16; ++c)
      reinterpret_cast<uint4*>(p)[c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = rt::from_f32<T>(f[i]);
  }
}

// Sum over the tpr threads of a row (rows are aligned groups of tpr threads).
// Every thread of the block calls it, rows past the end included; `partial`
// alternates between two buffers from one row to the next.
__device__ __forceinline__ float row_sum(float v, int tpr, float* partial) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5, first = warp & ~(wpr - 1);
  if ((threadIdx.x & 31) == 0) partial[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < wpr; ++i) s += partial[first + i];
  return s;
}

template <typename T, int VEC>
__device__ __forceinline__ float sum_sq(const Raw<T, VEC>& r) {
  float f[VEC];
  r.get(f);
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  return ss;
}

template <typename T, typename S, int VEC>
__device__ __forceinline__ void scale_store(T* p, const Raw<T, VEC>& xr, const Raw<S, VEC>& sr,
                                            float inv) {
  float f[VEC], g[VEC];
  xr.get(f);
  sr.get(g);
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = f[e] * inv * (1.f + g[e]);
  store_from_f32<T, VEC>(p, f);
}

// The block's row groups are blockIdx.x, blockIdx.x + gridDim.x, ...; on the
// register path each thread loads its share of the next row before it
// reduces and writes the current one.
template <typename T, typename S, int VEC, int VPT>
__global__ void __launch_bounds__(256) rmsnorm_kernel(const T* __restrict__ x,
                                                      const S* __restrict__ scale,
                                                      T* __restrict__ out, long long rows, int D,
                                                      int tpr, int rows_per_block, float eps) {
  __shared__ float partial[2][8];
  const int lane = threadIdx.x & (tpr - 1), sub = threadIdx.x / tpr;
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  const int nvec = D / VEC;
  long long base = static_cast<long long>(blockIdx.x) * rows_per_block;

  if constexpr (VPT > 0) {
    Raw<S, VEC> sr[VPT];
    Raw<T, VEC> xr[VPT], xn[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vi = j * tpr + lane;
      if (vi < nvec) sr[j].load(scale + vi * VEC);
      if (vi < nvec && base + sub < rows) xr[j].load(x + (base + sub) * D + vi * VEC);
    }
    for (int it = 0; base < rows; base += stride, ++it) {
      const long long row = base + sub, next = row + stride;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vi = j * tpr + lane;
        if (vi < nvec && next < rows) xn[j].load(x + next * D + vi * VEC);
      }
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        if (j * tpr + lane < nvec && row < rows) ss += sum_sq(xr[j]);
      const float inv = rsqrtf(row_sum(ss, tpr, partial[it & 1]) / static_cast<float>(D) + eps);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vi = j * tpr + lane;
        if (vi < nvec && row < rows) scale_store(out + row * D + vi * VEC, xr[j], sr[j], inv);
        xr[j] = xn[j];
      }
    }
  } else {  // looped: rows too long to hold in registers; x is read twice
    for (int it = 0; base < rows; base += stride, ++it) {
      const long long row = base + sub;
      const bool live = row < rows;
      float ss = 0.f;
      for (int vi = lane; live && vi < nvec; vi += tpr) {
        Raw<T, VEC> xr;
        xr.load(x + row * D + vi * VEC);
        ss += sum_sq(xr);
      }
      const float inv = rsqrtf(row_sum(ss, tpr, partial[it & 1]) / static_cast<float>(D) + eps);
      for (int vi = lane; live && vi < nvec; vi += tpr) {
        Raw<T, VEC> xr;
        Raw<S, VEC> sr;
        xr.load(x + row * D + vi * VEC);
        sr.load(scale + vi * VEC);
        scale_store(out + row * D + vi * VEC, xr, sr, inv);
      }
    }
  }
}

template <typename T, typename S, int VEC>
int launch_vec(const void* x, const void* scale, void* out, long long rows, int D, int vpt,
               int tpr, int rpb, int blocks, float eps, cudaStream_t stream) {
  const int threads = tpr * rpb;
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  switch (vpt) {
#define RMSNORM_CASE(V)                                                              \
  case V:                                                                            \
    rmsnorm_kernel<T, S, VEC, V><<<blocks, threads, 0, stream>>>(xp, sp, op, rows, D, \
                                                                 tpr, rpb, eps);     \
    break;
    RMSNORM_CASE(0)
    RMSNORM_CASE(1)
    RMSNORM_CASE(2)
    RMSNORM_CASE(3)
    RMSNORM_CASE(4)
#undef RMSNORM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows, int D, int vec, int vpt,
           int tpr, int rpb, int blocks, float eps, cudaStream_t stream) {
  constexpr int full = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 && D % full == 0;
  // tpr a power of two up to 256, whole warps per block
  if (tpr < 1 || tpr > 256 || (tpr & (tpr - 1)) || rpb < 1 || (tpr * rpb) % 32 ||
      tpr * rpb > 256 || vpt < 0 || vpt > MAX_VPT || (tpr > 32 && rpb != 1) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == full && aligned)
    return launch_vec<T, S, full>(x, scale, out, rows, D, vpt, tpr, rpb, blocks, eps, stream);
  if (vec == 1)
    return launch_vec<T, S, 1>(x, scale, out, rows, D, vpt, tpr, rpb, blocks, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// vec, vpt, tpr, rows_per_block, blocks: the launch plan of rmsnorm/ops.py
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, long long rows, int D,
                           float eps, int x_dtype, int s_dtype, int vec, int vpt, int tpr,
                           int rows_per_block, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(D) * (vpt > 0 ? 1 : 0) > static_cast<long long>(vpt) * tpr * vec)
    return static_cast<int>(cudaErrorInvalidValue);  // the register path must cover the row
#define RMSNORM_LAUNCH(T, S) \
  return launch<T, S>(x, scale, out, rows, D, vec, vpt, tpr, rows_per_block, blocks, eps, st)
  if (x_dtype == rt::BF16 && s_dtype == rt::BF16) RMSNORM_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (x_dtype == rt::BF16 && s_dtype == rt::F32) RMSNORM_LAUNCH(__nv_bfloat16, float);
  if (x_dtype == rt::F32 && s_dtype == rt::BF16) RMSNORM_LAUNCH(float, __nv_bfloat16);
  if (x_dtype == rt::F32 && s_dtype == rt::F32) RMSNORM_LAUNCH(float, float);
#undef RMSNORM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

// ---------------------------------------------------------------------------
// Backward: dx = rstd·(dy·w − x̂·mean(dy·w·x̂)), dscale = Σ_rows dy·x̂
// ---------------------------------------------------------------------------
//
// Bound: device-memory bytes, like the forward (x and dy read once, dx
// written once; rstd is recomputed from x, nothing is saved between the
// passes).  Design: the forward's coverage of a row (a row to `tpr`
// threads, 16-byte loads, VPT vectors a thread in registers, the looped
// variant for rows too long for registers, the scalar path for unaligned
// rows); each row needs two sums (Σx², Σdy·w·x), reduced together.  On the
// register path a block of up to 512 threads holds 512 / tpr row groups,
// one block an SM, and walks its rows with a stride; each thread holds x
// and dy packed as loaded (bf16 pairs) and loads its share of the next row
// before it reduces and writes the current one, so a row's loads are in
// flight while the previous one is reduced (with only two rows an SM in
// flight otherwise, too few bytes are outstanding to cover the memory
// latency).  One block an SM keeps the partial rows below few: more blocks
// measured slower.  dscale is reduced over the rows in f32 and
// deterministically, with no atomics: each row group keeps its partial sums
// of dy·x̂ in registers, the block's row groups add theirs pairwise in
// shared memory in a fixed order, and the block writes one row of
// partial[block][D]; a second kernel sums the blocks' rows of each column
// in a fixed order and casts once to the scale's dtype.  The looped path
// keeps one row group a block and its partial row in the scratch.  The
// launch plan is rmsnorm/ops.py::bwd_launch_plan.

constexpr int BWD_THREADS = 512;
constexpr int BWD_WARPS = BWD_THREADS / 32;

// the sums of a and b over the tpr threads of a row (see row_sum);
// partial holds 2·BWD_WARPS floats
__device__ __forceinline__ void row_sum2(float& a, float& b, int tpr, float* partial) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (tpr <= 32) return;
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5, first = warp & ~(wpr - 1);
  if ((threadIdx.x & 31) == 0) partial[warp] = a, partial[BWD_WARPS + warp] = b;
  __syncthreads();
  float sa = 0.f, sb = 0.f;
  for (int i = 0; i < wpr; ++i) sa += partial[first + i], sb += partial[BWD_WARPS + first + i];
  a = sa, b = sb;
}

template <typename T, typename S, int VEC, int VPT>
__global__ void __launch_bounds__(BWD_THREADS) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const S* __restrict__ scale, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ partial, long long rows, int D, int tpr,
    int rows_per_block, float eps) {
  __shared__ float red[2][2 * BWD_WARPS];
  extern __shared__ float tree[];  // (rows_per_block / 2) x D: the row groups' dscale sums
  const int lane = threadIdx.x & (tpr - 1), sub = threadIdx.x / tpr;
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  const int nvec = D / VEC;
  const float inv_d = 1.f / static_cast<float>(D);
  float* part = partial + static_cast<long long>(blockIdx.x) * D;
  long long base = static_cast<long long>(blockIdx.x) * rows_per_block;

  if constexpr (VPT > 0) {
    float w[VPT][VEC], acc[VPT][VEC];
    Raw<T, VEC> xr[VPT], gr[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vi = j * tpr + lane;
      float f[VEC] = {};
      if (vi < nvec) {
        Raw<S, VEC> sr;
        sr.load(scale + vi * VEC);
        sr.get(f);
        if (base + sub < rows) {
          xr[j].load(x + (base + sub) * D + vi * VEC);
          gr[j].load(dy + (base + sub) * D + vi * VEC);
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[j][e] = 1.f + f[e], acc[j][e] = 0.f;
    }
    for (int it = 0; base < rows; base += stride, ++it) {
      const long long row = base + sub, next = row + stride;
      const bool live = row < rows;
      Raw<T, VEC> xn[VPT], gn[VPT];  // the next row's share, in flight during this one
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vi = j * tpr + lane;
        if (vi < nvec && next < rows) {
          xn[j].load(x + next * D + vi * VEC);
          gn[j].load(dy + next * D + vi * VEC);
        }
      }
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (!(j * tpr + lane < nvec && live)) continue;
        float xv[VEC], gv[VEC];
        xr[j].get(xv);
        gr[j].get(gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss += xv[e] * xv[e];
          dot += gv[e] * w[j][e] * xv[e];
        }
      }
      row_sum2(ss, dot, tpr, red[it & 1]);
      const float rstd = rsqrtf(ss * inv_d + eps);
      // dx = rstd·dy·w − x·c, with c = rstd · rstd·mean(dy·w·x̂) = rstd³·Σ(dy·w·x) / D
      const float c = rstd * rstd * rstd * dot * inv_d;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vi = j * tpr + lane;
        if (vi < nvec && live) {
          float xv[VEC], gv[VEC], o[VEC];
          xr[j].get(xv);
          gr[j].get(gv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            o[e] = rstd * gv[e] * w[j][e] - xv[e] * c;
            acc[j][e] += gv[e] * (xv[e] * rstd);
          }
          store_from_f32<T, VEC>(dx + row * D + vi * VEC, o);
        }
        xr[j] = xn[j];
        gr[j] = gn[j];
      }
    }
    // row groups [h, 2h) hand their sums to [0, h), halving h: a fixed order
    for (int h = rows_per_block >> 1; h > 0; h >>= 1) {
      if (sub >= h && sub < 2 * h) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int vi = j * tpr + lane;
          if (vi < nvec)
#pragma unroll
            for (int e = 0; e < VEC; ++e) tree[(sub - h) * D + vi * VEC + e] = acc[j][e];
        }
      }
      __syncthreads();
      if (sub < h) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int vi = j * tpr + lane;
          if (vi < nvec)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j][e] += tree[sub * D + vi * VEC + e];
        }
      }
      __syncthreads();
    }
    if (sub == 0) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vi = j * tpr + lane;
        if (vi < nvec)
#pragma unroll
          for (int e = 0; e < VEC; ++e) part[vi * VEC + e] = acc[j][e];
      }
    }
  } else {  // looped, one row group a block: x and dy are read twice
    for (int vi = lane; vi < nvec; vi += tpr)
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[vi * VEC + e] = 0.f;
    for (int it = 0; base < rows; base += stride, ++it) {
      const long long row = base + sub;
      const bool live = row < rows;
      float ss = 0.f, dot = 0.f;
      for (int vi = lane; live && vi < nvec; vi += tpr) {
        Raw<T, VEC> xr, gr;
        Raw<S, VEC> sr;
        xr.load(x + row * D + vi * VEC);
        gr.load(dy + row * D + vi * VEC);
        sr.load(scale + vi * VEC);
        float xv[VEC], gv[VEC], sv[VEC];
        xr.get(xv), gr.get(gv), sr.get(sv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += xv[e] * xv[e], dot += gv[e] * (1.f + sv[e]) * xv[e];
      }
      row_sum2(ss, dot, tpr, red[it & 1]);
      const float rstd = rsqrtf(ss * inv_d + eps);
      const float c = rstd * rstd * rstd * dot * inv_d;
      for (int vi = lane; live && vi < nvec; vi += tpr) {
        Raw<T, VEC> xr, gr;
        Raw<S, VEC> sr;
        xr.load(x + row * D + vi * VEC);
        gr.load(dy + row * D + vi * VEC);
        sr.load(scale + vi * VEC);
        float xv[VEC], gv[VEC], sv[VEC], o[VEC];
        xr.get(xv), gr.get(gv), sr.get(sv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          o[e] = rstd * gv[e] * (1.f + sv[e]) - xv[e] * c;
          part[vi * VEC + e] += gv[e] * (xv[e] * rstd);
        }
        store_from_f32<T, VEC>(dx + row * D + vi * VEC, o);
      }
    }
  }
}

// dscale[c] = Σ_p partial[p][c], 32 columns a block, 8 warps each summing
// every 8th part, combined in warp order: the same order on every run
template <typename S>
__global__ void __launch_bounds__(256) dscale_reduce_kernel(const float* __restrict__ partial,
                                                            S* __restrict__ dscale, int parts,
                                                            int D) {
  __shared__ float red[8][33];
  const int col = threadIdx.x & 31, j = threadIdx.x >> 5, c = blockIdx.x * 32 + col;
  float s = 0.f;
  if (c < D)
    for (int p = j; p < parts; p += 8) s += partial[static_cast<long long>(p) * D + c];
  red[j][col] = s;
  __syncthreads();
  if (j == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][col];
    dscale[c] = rt::from_f32<S>(t);
  }
}

template <typename T, typename S, int VEC>
int launch_bwd_vec(const void* x, const void* scale, const void* dy, void* dx, void* partial,
                   void* dscale, long long rows, int D, int vpt, int tpr, int rpb, int blocks,
                   float eps, cudaStream_t stream) {
  const int threads = tpr * rpb;
  const size_t tree = sizeof(float) * static_cast<size_t>(rpb / 2) * D;
  if (tree > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  switch (vpt) {
#define RMSNORM_BWD_CASE(V)                                                                 \
  case V:                                                                                   \
    rmsnorm_bwd_kernel<T, S, VEC, V><<<blocks, threads, tree, stream>>>(xp, sp, gp, op, pp, \
                                                                        rows, D, tpr, rpb,  \
                                                                        eps);               \
    break;
    RMSNORM_BWD_CASE(0)
    RMSNORM_BWD_CASE(1)
    RMSNORM_BWD_CASE(2)
    RMSNORM_BWD_CASE(3)
    RMSNORM_BWD_CASE(4)
#undef RMSNORM_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dscale_reduce_kernel<S><<<(D + 31) / 32, 256, 0, stream>>>(pp, static_cast<S*>(dscale), blocks, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* partial,
               void* dscale, long long rows, int D, int vec, int vpt, int tpr, int rpb,
               int blocks, float eps, cudaStream_t stream) {
  constexpr int full = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 && D % full == 0;
  // tpr and rows_per_block powers of two (the pairwise dscale sum), whole
  // warps, at most BWD_THREADS; the looped path takes one row group a block
  if (tpr < 1 || tpr > 256 || (tpr & (tpr - 1)) || rpb < 1 || (rpb & (rpb - 1)) ||
      (tpr * rpb) % 32 || tpr * rpb > BWD_THREADS || vpt < 0 || vpt > MAX_VPT || blocks < 1 ||
      (vpt == 0 && rpb != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == full && aligned)
    return launch_bwd_vec<T, S, full>(x, scale, dy, dx, partial, dscale, rows, D, vpt, tpr, rpb,
                                      blocks, eps, stream);
  if (vec == 1)
    return launch_bwd_vec<T, S, 1>(x, scale, dy, dx, partial, dscale, rows, D, vpt, tpr, rpb,
                                   blocks, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dy and dx have x's dtype; partial is float32 scratch of blocks x D (one
// row a block); dscale has scale's dtype.  The launch plan is
// rmsnorm/ops.py::bwd_launch_plan.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* partial, void* dscale, long long rows, int D, float eps,
                           int x_dtype, int s_dtype, int vec, int vpt, int tpr,
                           int rows_per_block, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(D) * (vpt > 0 ? 1 : 0) > static_cast<long long>(vpt) * tpr * vec)
    return static_cast<int>(cudaErrorInvalidValue);  // the register path must cover the row
#define RMSNORM_BWD_LAUNCH(T, S)                                                                  \
  return launch_bwd<T, S>(x, scale, dy, dx, partial, dscale, rows, D, vec, vpt, tpr,             \
                          rows_per_block, blocks, eps, st)
  if (x_dtype == rt::BF16 && s_dtype == rt::BF16) RMSNORM_BWD_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (x_dtype == rt::BF16 && s_dtype == rt::F32) RMSNORM_BWD_LAUNCH(__nv_bfloat16, float);
  if (x_dtype == rt::F32 && s_dtype == rt::BF16) RMSNORM_BWD_LAUNCH(float, __nv_bfloat16);
  if (x_dtype == rt::F32 && s_dtype == rt::F32) RMSNORM_BWD_LAUNCH(float, float);
#undef RMSNORM_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
