// Flash attention forward for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//           (body _flash_kernel).
// Computes: causal / windowed GQA attention, out = softmax(q k^T / sqrt(Dh)) v,
//           with the online softmax of the TPU kernel: f32 running max m, sum l
//           and accumulator, masked scores NEG_INF (-1e30), l clamped at 1e-30,
//           query positions offset by q_offset, mask qpos >= kpos (causal) and
//           qpos - kpos < window.  Query head h reads KV head h / (H / KH).
// Layout:   the model's (B, L, H, D), read through strides (last dim
//           contiguous), so the caller transposes nothing.
//
// Bound: at prefill lengths the work is ~4·L²·H·Dh/2 flops against ~4·L·H·Dh
// elements moved, far above the card's ops-per-byte line, so it is bound by
// operations.  Design (simple first): one block of 256 threads per (64-query
// tile, head, batch); the TPU's sequential KV grid axis becomes a loop inside
// the block over 64-key tiles, staged through shared memory as f32.  Tiles
// entirely above the causal diagonal or below the window are never loaded
// (the TPU kernel's structural skip), and the ragged edges of Lq and Lk are
// masked here, so any length works.  Products are f32 FMA on the SIMT cores
// (a 4x4 / 4x8 register micro-tile per thread); wgmma / TMA are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per inner tile
constexpr int NT = 256;  // threads: 16 (ty) x 16 (tx)
constexpr int DMAX = 128;
constexpr int NJ = DMAX / 16;  // output columns per thread

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int H, int KH, int Lq, int Lk, int Dh, int Dv,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int DP = Dh + 1;          // padded rows: conflict-free column reads
  float* Qs = smem;               // BQ x DP
  float* Ks = Qs + BQ * DP;       // BK x DP
  float* Vs = Ks + BK * DP;       // BK x Dv
  float* Ps = Vs + BK * Dv;       // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int idx = tid; idx < BQ * Dh; idx += NT) {
    const int r = idx / Dh, d = idx - r * Dh, row = q0 + r;
    Qs[r * DP + d] = row < Lq ? rt::to_f32(qb[row * q_sl + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // live key range of this query tile: [k_lo, k_hi)
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Lq) - 1;
  const int k_hi = causal ? min(Lk, qpos_hi + 1) : Lk;
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Qs written / previous tile's Ks, Vs, Ps consumed
    for (int idx = tid; idx < BK * Dh; idx += NT) {
      const int r = idx / Dh, d = idx - r * Dh, kr = k0 + r;
      Ks[r * DP + d] = kr < Lk ? rt::to_f32(kb[kr * k_sl + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * Dv; idx += NT) {
      const int r = idx / Dv, d = idx - r * Dv, kr = k0 + r;
      Vs[r * Dv + d] = kr < Lk ? rt::to_f32(vb[kr * v_sl + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

    // mask + online softmax; a row's 16 owners are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = rt::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Lk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? s[i][j] * scale : rt::NEG_INF;
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
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V for rows ty + 16i, columns tx + 16j
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < Dv ? Vs[kk * Dv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + b * o_sb + row * o_sl + h * o_sh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Dv) orow[c] = rt::from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int Lq,
           int Lk, int Dh, int Dv, const long long* qs, const long long* ks, const long long* vs,
           const long long* os, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ) * (Dh + 1) + static_cast<size_t>(BK) * (Dh + 1) +
       static_cast<size_t>(BK) * Dv + static_cast<size_t>(BQ) * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KH, Lq, Lk, Dh, Dv, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
      vs[0], vs[1], vs[2], os[0], os[1], os[2], causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides are (batch, sequence, head) in elements; the head_dim stride is 1.
// window <= 0 means no window.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int KH, int Lq, int Lk, int Dh, int Dv,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* o_strides,
                                   int causal, int window, int q_offset, float scale, int dtype,
                                   void* stream) {
  if (Dh > DMAX || Dv > DMAX || KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KH, Lq, Lk, Dh, Dv, q_strides, k_strides,
                                 v_strides, o_strides, causal, window, q_offset, scale, st);
  if (dtype == rt::F32)
    return launch<float>(q, k, v, o, B, H, KH, Lq, Lk, Dh, Dv, q_strides, k_strides, v_strides,
                         o_strides, causal, window, q_offset, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
