// Flash attention, the wide route: forward and backward for every f32
// shape, and for every bf16 shape the tensor-core route refuses.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//           (body _flash_kernel) for the shapes flash_attention.cu does not
//           take, and for the backward the jnp custom VJP of
//           src/repro/models/attention.py::_make_flash, as
//           flash_attention_bwd.cu does.  The Pallas kernel checks only
//           Lq % block_q and Lk % block_kv: any head dim and any layout.
//           This route takes head dims Dh and Dv of any width in f32 or
//           bf16, bf16 at any base, head dim or stride (the tensor-core
//           route takes bf16 only, in whole 16-byte chunks:
//           flash_attention.cu / flash_attention_bwd.cu up to 256,
//           flash_attention_split.cu up to Dh 576 and Dv 512).
// Computes: the same functions as flash_attention.cu / flash_attention_bwd.cu:
//   out = softmax(q k^T · scale) v with the online softmax of the TPU
//   kernel (f32 running max and sum, masked scores NEG_INF, l clamped at
//   1e-30), causal / window / q_offset / GQA / ragged lengths, lse for
//   training; the backward's D = rowsum(dO∘O), P = exp(S·scale − lse),
//   dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − D)·scale, dQ = dS·K, dK = dSᵀ·Q,
//   dK / dV summed over the G query heads of each KV head.
// Layout:   the model's (B, L, H, D) through strides (last dim contiguous).
//
// Bound: operations, as the other routes.  This route is the simple one:
// SIMT f32 (wide.cuh), no tensor cores, so it runs far from the bound.
//   - Products that reduce over a head dim walk it 64 columns at a time
//     (S over Dh, dP over Dv), so no width bounds the shared memory.
//   - Products that produce a head dim are split across blocks, OC = 256
//     columns a block (one grid slice per chunk): the forward's O by Dv
//     chunk (each slice recomputes S and the softmax statistics, slice 0
//     writes lse), the backward's dK by Dh chunk and dV by Dv chunk (one
//     dK/dV kernel, the slice picking which), dQ by Dh chunk.
//   - Every sum runs in a fixed order and no float atomics are used, so
//     each run gives the same bits; the D pass is one warp a row.
//   - Tiles wholly masked by the causal diagonal or the window are skipped,
//     as in the other routes.
#include <cstdint>

#include "common.cuh"
#include "wide.cuh"

namespace {

using wide::LD;
using wide::NT;
using wide::TR;
using wide::View;
using wide::view;

constexpr int OC = 256;       // output columns a block
constexpr int NJ = OC / 16;   // output columns a thread: tx + 16j

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Lq) f32, or null
  int H, KH, Lq, Lk, Dh, Dv, causal, window, q_offset;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, sequence, head) strides
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Lq)
  float* dvec;       // (B, H, Lq): D
  void* dq;
  void* dk;
  void* dv;
  int B, H, KH, Lq, Lk, Dh, Dv, causal, window, q_offset;
  float scale;
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  bool ok = true;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// ---------------------------------------------------------------------------
// forward: block (64 query rows, head, Dv slice)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) flash_wide_fwd_kernel(const FwdParams p) {
  extern __shared__ float smem[];
  float* As = smem;           // walk tiles
  float* Bs = As + TR * LD;
  float* Ps = Bs + TR * LD;   // TR x LD: probabilities
  float* Vs = Ps + TR * LD;   // TR x OC: V rows of this slice's columns

  const int n_sl = (p.Dv + OC - 1) / OC;
  const int q0 = blockIdx.x * TR, h = blockIdx.y / n_sl, sl = blockIdx.y - h * n_sl, b = blockIdx.z;
  const int c0 = sl * OC, w = min(OC, p.Dv - c0);
  const int kh = h / (p.H / p.KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2] + q0 * p.qs[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kh * p.ks[2];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kh * p.vs[2];
  const View<T> Q = view(qb, p.qs[1], 1, p.Lq - q0);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // live key range of this query tile: [k_lo, k_hi)
  const int qpos_lo = p.q_offset + q0;
  const int qpos_hi = p.q_offset + min(q0 + TR, p.Lq) - 1;
  const int k_hi = p.causal ? min(p.Lk, qpos_hi + 1) : p.Lk;
  const int k_lo = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;

  for (int k0 = (k_lo / TR) * TR; k0 < k_hi; k0 += TR) {
    float s[4][4];
    wide::walk(s, Q, view(kb + k0 * p.ks[1], p.ks[1], 1, p.Lk - k0), p.Dh, As, Bs);

    // mask + online softmax; a row's 16 owners are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qpos_lo + ty + 16 * i;
      float mx = rt::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < p.Lk && visible(qpos, kpos, p.causal, p.window);
        s[i][j] = ok ? s[i][j] * p.scale : rt::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * LD + tx + 16 * j] = s[i][j];
    }
    wide::load_tile(Vs, OC, OC, view(vb + k0 * p.vs[1], p.vs[1], 1, p.Lk - k0), c0, w);
    __syncthreads();

    for (int kk = 0; kk < TR; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * OC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Lq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && sl == 0 && tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    T* orow = static_cast<T*>(p.o) + b * p.os[0] + row * p.os[1] + h * p.os[2] + c0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < w) orow[c] = rt::from_f32<T>(acc[i][j] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D = rowsum(dO∘O): one warp a (b, h, query) row
template <typename T>
__global__ void __launch_bounds__(NT) flash_wide_dot_kernel(const BwdParams p) {
  const long long r = static_cast<long long>(blockIdx.x) * (NT / 32) + (threadIdx.x >> 5);
  if (r >= static_cast<long long>(p.B) * p.H * p.Lq) return;
  const int i = static_cast<int>(r % p.Lq), h = static_cast<int>((r / p.Lq) % p.H),
            b = static_cast<int>(r / (static_cast<long long>(p.Lq) * p.H));
  const T* orow = static_cast<const T*>(p.o) + b * p.os[0] + i * p.os[1] + h * p.os[2];
  const T* drow = static_cast<const T*>(p.dout) + b * p.dos[0] + i * p.dos[1] + h * p.dos[2];
  float s = 0.f;
  for (int c = threadIdx.x & 31; c < p.Dv; c += 32) s += rt::to_f32(orow[c]) * rt::to_f32(drow[c]);
  s = rt::warp_sum(s);
  if ((threadIdx.x & 31) == 0) p.dvec[(static_cast<long long>(b) * p.H + h) * p.Lq + i] = s;
}

// P (or dS when ds) for query rows q0 + ty + 16a, keys k0 + tx + 16k of
// query head h; 0 outside [0, Lq) x [0, Lk).  Ls / Ds: the rows' lse and D.
// Two walks (S, then dP for dS): each begins with a barrier.
template <typename T>
__device__ void probs(float (&pr)[4][4], const BwdParams& p, int b, int h, int kh, int q0, int k0,
                      bool ds, const float* Ls, const float* Ds, float* As, float* Bs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2] + q0 * p.qs[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kh * p.ks[2] + k0 * p.ks[1];
  wide::walk(pr, view(qb, p.qs[1], 1, p.Lq - q0), view(kb, p.ks[1], 1, p.Lk - k0), p.Dh, As, Bs);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = q0 + ty + 16 * a;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int key = k0 + tx + 16 * k;
      const bool live = q < p.Lq && key < p.Lk;
      const float sv = visible(p.q_offset + q, key, p.causal, p.window) ? pr[a][k] * p.scale : rt::NEG_INF;
      pr[a][k] = live ? expf(sv - Ls[ty + 16 * a]) : 0.f;
    }
  }
  if (!ds) return;
  float dp[4][4];
  const T* dob = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2] + q0 * p.dos[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kh * p.vs[2] + k0 * p.vs[1];
  wide::walk(dp, view(dob, p.dos[1], 1, p.Lq - q0), view(vb, p.vs[1], 1, p.Lk - k0), p.Dv, As, Bs);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) pr[a][k] = pr[a][k] * (dp[a][k] - Ds[ty + 16 * a]) * p.scale;
}

__device__ __forceinline__ void load_rows_stats(const BwdParams& p, int b, int h, int q0, float* Ls, float* Ds) {
  const int t = threadIdx.x;
  if (t < TR) {
    const int row = q0 + t;
    const long long i = (static_cast<long long>(b) * p.H + h) * p.Lq + row;
    Ls[t] = row < p.Lq ? p.lse[i] : 0.f;
    Ds[t] = row < p.Lq ? p.dvec[i] : 0.f;
  }
}

// dK or dV columns [c0, c0 + OC) of 64 keys: block (key tile, KV head x
// slice, batch); slices [0, n_dh) are dK's Dh chunks, the rest dV's Dv chunks.
// Loops over the G query heads, then the live query tiles, in order.
template <typename T>
__global__ void __launch_bounds__(NT) flash_wide_dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TR * LD;
  float* Ps = Bs + TR * LD;  // TR x LD: P or dS, [query][key]
  float* Os = Ps + TR * LD;  // TR x OC: dO (dV) or Q (dK) rows of the slice's columns
  float* Ls = Os + TR * OC;  // TR
  float* Ds = Ls + TR;       // TR

  const int n_dh = (p.Dh + OC - 1) / OC, per = n_dh + (p.Dv + OC - 1) / OC;
  const int k0 = blockIdx.x * TR, kh = blockIdx.y / per, sl = blockIdx.y - kh * per, b = blockIdx.z;
  const bool is_dk = sl < n_dh;
  const int c0 = (is_dk ? sl : sl - n_dh) * OC, w = min(OC, (is_dk ? p.Dh : p.Dv) - c0);
  const int G = p.H / p.KH;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // query rows that see a key of this tile: [q_lo, q_hi)
  const int q_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_hi = p.window > 0 ? min(p.Lq, k0 + TR - 1 + p.window - p.q_offset) : p.Lq;

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = (q_lo / TR) * TR; q0 < q_hi; q0 += TR) {
      __syncthreads();  // the previous tile's Ps, Os, Ls, Ds consumed
      load_rows_stats(p, b, h, q0, Ls, Ds);
      float pr[4][4];
      probs<T>(pr, p, b, h, kh, q0, k0, is_dk, Ls, Ds, As, Bs);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) Ps[(ty + 16 * a) * LD + tx + 16 * k] = pr[a][k];
      const View<T> src = is_dk
          ? view(static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2] + q0 * p.qs[1], p.qs[1], 1, p.Lq - q0)
          : view(static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2] + q0 * p.dos[1], p.dos[1], 1,
                 p.Lq - q0);
      wide::load_tile(Os, OC, OC, src, c0, w);
      __syncthreads();
      // acc[key][c] += sum over queries of Ps[query][key] * Os[query][c]
      for (int qq = 0; qq < TR; ++qq) {
        float pv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a] = Ps[qq * LD + ty + 16 * a];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float ov = Os[qq * OC + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][j] += pv[a] * ov;
        }
      }
    }
  }

  T* dst = static_cast<T*>(is_dk ? p.dk : p.dv);
  const long long* ds = is_dk ? p.dks : p.dvs;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= p.Lk) continue;
    T* row = dst + b * ds[0] + key * ds[1] + kh * ds[2] + c0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < w) row[c] = rt::from_f32<T>(acc[a][j]);
    }
  }
}

// dQ columns [c0, c0 + OC) of 64 query rows: block (query tile, head x
// slice, batch), looping over the forward's live key tiles in order.
template <typename T>
__global__ void __launch_bounds__(NT) flash_wide_dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TR * LD;
  float* Ps = Bs + TR * LD;  // TR x LD: dS, [query][key]
  float* Os = Ps + TR * LD;  // TR x OC: K rows of the slice's columns
  float* Ls = Os + TR * OC;
  float* Ds = Ls + TR;

  const int n_dh = (p.Dh + OC - 1) / OC;
  const int q0 = blockIdx.x * TR, h = blockIdx.y / n_dh, sl = blockIdx.y - h * n_dh, b = blockIdx.z;
  const int c0 = sl * OC, w = min(OC, p.Dh - c0);
  const int kh = h / (p.H / p.KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_rows_stats(p, b, h, q0, Ls, Ds);  // visible after the first walk's barrier

  const int qpos_lo = p.q_offset + q0;
  const int qpos_hi = p.q_offset + min(q0 + TR, p.Lq) - 1;
  const int k_hi = p.causal ? min(p.Lk, qpos_hi + 1) : p.Lk;
  const int k_lo = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kh * p.ks[2];
  for (int k0 = (k_lo / TR) * TR; k0 < k_hi; k0 += TR) {
    float pr[4][4];
    probs<T>(pr, p, b, h, kh, q0, k0, true, Ls, Ds, As, Bs);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) Ps[(ty + 16 * a) * LD + tx + 16 * k] = pr[a][k];
    wide::load_tile(Os, OC, OC, view(kb + k0 * p.ks[1], p.ks[1], 1, p.Lk - k0), c0, w);
    __syncthreads();
    for (int kk = 0; kk < TR; ++kk) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = Ps[(ty + 16 * a) * LD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float ov = Os[kk * OC + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] += pv[a] * ov;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.Lq) continue;
    T* dst = static_cast<T*>(p.dq) + b * p.dqs[0] + row * p.dqs[1] + h * p.dqs[2] + c0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < w) dst[c] = rt::from_f32<T>(acc[a][j]);
    }
  }
}

constexpr size_t FWD_SMEM = sizeof(float) * (3 * TR * LD + TR * OC);
constexpr size_t BWD_SMEM = sizeof(float) * (3 * TR * LD + TR * OC + 2 * TR);

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <typename T>
int launch_fwd(const FwdParams& p, int B, cudaStream_t st) {
  const int n_sl = (p.Dv + OC - 1) / OC;
  if (static_cast<long long>(p.H) * n_sl > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_wide_fwd_kernel<T>, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + TR - 1) / TR, p.H * n_sl, B);
  flash_wide_fwd_kernel<T><<<grid, NT, FWD_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const BwdParams& p, cudaStream_t st) {
  const int n_dh = (p.Dh + OC - 1) / OC, n_dv = (p.Dv + OC - 1) / OC;
  if (static_cast<long long>(p.KH) * (n_dh + n_dv) > 65535 || static_cast<long long>(p.H) * n_dh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(p.B) * p.H * p.Lq;
  flash_wide_dot_kernel<T><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(flash_wide_dkdv_kernel<T>, BWD_SMEM)) != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(flash_wide_dq_kernel<T>, BWD_SMEM)) != cudaSuccess) return static_cast<int>(err);
  flash_wide_dkdv_kernel<T><<<dim3((p.Lk + TR - 1) / TR, p.KH * (n_dh + n_dv), p.B), NT, BWD_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_wide_dq_kernel<T><<<dim3((p.Lq + TR - 1) / TR, p.H * n_dh, p.B), NT, BWD_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

void copy3(long long* dst, const long long* src) {
  for (int i = 0; i < 3; ++i) dst[i] = src[i];
}

}  // namespace

// The arguments of flash_attention_fwd (flash_attention.cu), any head dims
// and any layout with a contiguous last dim; f32 or bf16.
extern "C" int flash_attention_wide_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                        int B, int H, int KH, int Lq, int Lk, int Dh, int Dv,
                                        const long long* q_strides, const long long* k_strides,
                                        const long long* v_strides, const long long* o_strides, int causal,
                                        int window, int q_offset, float scale, int dtype, void* stream) {
  if (Dh < 1 || Dv < 1 || KH <= 0 || H % KH != 0 || B < 1 || B > 65535 || Lq < 1 || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.KH = KH;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Dh = Dh;
  p.Dv = Dv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  copy3(p.qs, q_strides);
  copy3(p.ks, k_strides);
  copy3(p.vs, v_strides);
  copy3(p.os, o_strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16) return launch_fwd<__nv_bfloat16>(p, B, st);
  if (dtype == rt::F32) return launch_fwd<float>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The arguments of flash_attention_bwd (flash_attention_bwd.cu), any head
// dims and any layout with a contiguous last dim; f32 or bf16.  Four
// launches: D, dK/dV, dQ (dvec is (B, H, Lq) f32 scratch).
extern "C" int flash_attention_wide_bwd(const void* q, const void* k, const void* v, const void* o,
                                        const void* dout, const void* lse, void* dvec, void* dq, void* dk,
                                        void* dv, int B, int H, int KH, int Lq, int Lk, int Dh, int Dv,
                                        const long long* q_strides, const long long* k_strides,
                                        const long long* v_strides, const long long* o_strides,
                                        const long long* do_strides, const long long* dq_strides,
                                        const long long* dk_strides, const long long* dv_strides, int causal,
                                        int window, int q_offset, float scale, int dtype, void* stream) {
  if (Dh < 1 || Dv < 1 || KH <= 0 || H % KH != 0 || B < 1 || B > 65535 || Lq < 1 || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<float*>(dvec);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.KH = KH;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Dh = Dh;
  p.Dv = Dv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  copy3(p.qs, q_strides);
  copy3(p.ks, k_strides);
  copy3(p.vs, v_strides);
  copy3(p.os, o_strides);
  copy3(p.dos, do_strides);
  copy3(p.dqs, dq_strides);
  copy3(p.dks, dk_strides);
  copy3(p.dvs, dv_strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16) return launch_bwd<__nv_bfloat16>(p, st);
  if (dtype == rt::F32) return launch_bwd<float>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
