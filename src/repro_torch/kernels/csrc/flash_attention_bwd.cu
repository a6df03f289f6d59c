// Flash attention backward for Hopper.
//
// Replaces: no Pallas kernel.  src/repro/kernels/flash_attention/kernel.py:111
//   (flash_attention_pallas) is forward only; JAX trains through the jnp
//   custom VJP of src/repro/models/attention.py::_make_flash (the
//   FlashAttention-2 backward), whose recurrence this computes from the
//   forward's residuals q, k, v, out and lse (flash_attention.cu):
//     D  = rowsum(dO∘O)
//     P  = exp(S·scale − lse), masked scores −1e30 as in the forward
//     dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP − D)·scale,  dQ = dS·K,  dK = dSᵀ·Q
//   with dK and dV summed over the G = H / KH query heads of each KV head.
// Layout:   the model's (B, L, H, D) for q, k, v, out, dout, dq, dk, dv,
//   read and written through strides (last dim contiguous); lse and D are
//   (B, H, Lq) float32.
//
// Bound: operations (5 products over the unmasked (query, key) pairs, ~2.5×
// the forward's).  This first version runs on the SIMT cores in f32 for
// both dtypes (bf16 values are widened as they are loaded; P and dS stay
// f32), as the forward's f32 route does; a tensor-core version is later
// work (ROADMAP.md).  Deterministic, with no float atomics:
//   1. flash_bwd_dot_kernel: D, one warp a (b, h, query) row;
//   2. flash_bwd_dkdv_kernel: one block owns (b, KV head, 64-key tile), loops
//      over the G query heads and the 64-row query tiles that the causal
//      diagonal and the window let see the key tile, keeps dK and dV in
//      registers (4 x 8 a thread) and writes each once;
//   3. flash_bwd_dq_kernel: one block owns (b, head, 64-row query tile) and
//      loops over the key tiles that the forward loads, keeping dQ in
//      registers.
// Tiles are f32 in shared memory with odd row strides (conflict-free column
// reads), 16 x 16 threads with 4 x 4 score micro-tiles, as the forward's
// SIMT route.  No tile that the mask removes is loaded.  The heaviest
// causal tiles launch first.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: 16 (ty) x 16 (tx)
constexpr int DMAX = 128;
constexpr int NJ = DMAX / 16;  // head-dim columns per thread

struct Strides {
  long long b, l, h;
};

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, Strides s, int r0,
                                          int n_rows, int d, int tid) {
  for (int idx = tid; idx < 64 * d; idx += NT) {
    const int r = idx / d, c = idx - r * d, row = r0 + r;
    dst[r * ld + c] = row < n_rows ? rt::to_f32(src[row * s.l + c]) : 0.f;
  }
}

// D[b, h, i] = Σ_c dout[b, i, h, c] · out[b, i, h, c]
template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dot_kernel(const T* __restrict__ o,
                                                           const T* __restrict__ dout,
                                                           float* __restrict__ dvec, int B, int H,
                                                           int Lq, int Dv, Strides os, Strides ds) {
  const long long r = static_cast<long long>(blockIdx.x) * (NT / 32) + (threadIdx.x >> 5);
  if (r >= static_cast<long long>(B) * H * Lq) return;
  const int i = static_cast<int>(r % Lq), h = static_cast<int>((r / Lq) % H),
            b = static_cast<int>(r / (static_cast<long long>(Lq) * H));
  const T* orow = o + b * os.b + i * os.l + h * os.h;
  const T* drow = dout + b * ds.b + i * ds.l + h * ds.h;
  float s = 0.f;
  for (int c = threadIdx.x & 31; c < Dv; c += 32) s += rt::to_f32(orow[c]) * rt::to_f32(drow[c]);
  s = rt::warp_sum(s);
  if ((threadIdx.x & 31) == 0) dvec[r] = s;
}

// s[i][j] = Σ_d A[(ty + 16i), d] · Bm[(tx + 16j), d] over d < n
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, int lda, const float* Bm,
                                         int ldb, int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < n; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * ldb + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bv[j];
  }
}

// From the scores s and dP of rows q0 + ty + 16i, keys k0 + tx + 16j: P and
// dS (P = 0 for rows past Lq and keys past Lk, which do not exist)
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
                                      const float* d_s, int q0, int k0, int Lq, int Lk, int causal,
                                      int window, int q_offset, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q_offset + q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      bool ok = true;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      const float sv = ok ? s[i][j] * scale : rt::NEG_INF;
      const float p = (q0 + r < Lq && kpos < Lk) ? expf(sv - lse_s[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - d_s[r]) * scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, int H, int KH, int Lq, int Lk, int Dh, int Dv,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int causal,
    int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int DP = Dh + 1, VP = Dv + 1;
  float* Ks = smem;             // BK x DP
  float* Vs = Ks + BK * DP;     // BK x VP
  float* Qs = Vs + BK * VP;     // BQ x DP
  float* dOs = Qs + BQ * DP;    // BQ x VP
  float* Ps = dOs + BQ * VP;    // BQ x (BK + 1)
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* d_s = lse_s + BQ;

  const int kh = blockIdx.x, k0 = blockIdx.y * BK, b = blockIdx.z;  // key tile 0 first: heaviest
  const int G = H / KH, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_rows(Ks, DP, k + b * ks.b + kh * ks.h, ks, k0, Lk, Dh, tid);
  load_rows(Vs, VP, v + b * vs.b + kh * vs.h, vs, k0, Lk, Dv, tid);

  // query rows that see some key of [k0, k0 + BK): [i_lo, i_hi)
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Lq, k0 + BK - 1 + window - q_offset) : Lq;

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NJ; ++c) dk_acc[a][c] = 0.f, dv_acc[a][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Lq;
    const float* d_h = dvec + (static_cast<long long>(b) * H + h) * Lq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's Qs, dOs, Ps, dSs are consumed
      load_rows(Qs, DP, q + b * qs.b + h * qs.h, qs, q0, Lq, Dh, tid);
      load_rows(dOs, VP, dout + b * dos.b + h * dos.h, dos, q0, Lq, Dv, tid);
      if (tid < BQ) {
        lse_s[tid] = q0 + tid < Lq ? lse_h[q0 + tid] : 0.f;
        d_s[tid] = q0 + tid < Lq ? d_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot(s, Qs, DP, Ks, DP, Dh, ty, tx);
      tile_dot(dp, dOs, VP, Vs, VP, Dv, ty, tx);
      probs(s, dp, lse_s, d_s, q0, k0, Lq, Lk, causal, window, q_offset, scale, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j];
          dSs[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dV[key][c] += Σ_i P[i][key]·dO[i][c], dK[key][d] += Σ_i dS[i][key]·Q[i][d]
      // for keys ty + 16a and columns tx + 16c
      for (int i = 0; i < BQ; ++i) {
        float p4[4], ds4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          p4[a] = Ps[i * (BK + 1) + ty + 16 * a];
          ds4[a] = dSs[i * (BK + 1) + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          const int col = tx + 16 * c;
          const float dov = col < Dv ? dOs[i * VP + col] : 0.f;
          const float qv = col < Dh ? Qs[i * DP + col] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv_acc[a][c] += p4[a] * dov;
            dk_acc[a][c] += ds4[a] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= Lk) continue;
    T* dkrow = dk + b * dks.b + key * dks.l + kh * dks.h;
    T* dvrow = dv + b * dvs.b + key * dvs.l + kh * dvs.h;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) dkrow[col] = rt::from_f32<T>(dk_acc[a][c]);
      if (col < Dv) dvrow[col] = rt::from_f32<T>(dv_acc[a][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dq, int H, int KH, int Lq, int Lk, int Dh, int Dv, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dqs, int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int DP = Dh + 1, VP = Dv + 1;
  float* Qs = smem;             // BQ x DP
  float* dOs = Qs + BQ * DP;    // BQ x VP
  float* Ks = dOs + BQ * VP;    // BK x DP
  float* Vs = Ks + BK * DP;     // BK x VP
  float* dSs = Vs + BK * VP;    // BQ x (BK + 1)
  float* lse_s = dSs + BQ * (BK + 1);
  float* d_s = lse_s + BQ;

  // heaviest causal query tiles first: blockIdx.y counts down the sequence
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ, b = blockIdx.z;
  const int kh = h / (H / KH), tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_rows(Qs, DP, q + b * qs.b + h * qs.h, qs, q0, Lq, Dh, tid);
  load_rows(dOs, VP, dout + b * dos.b + h * dos.h, dos, q0, Lq, Dv, tid);
  if (tid < BQ) {
    const long long r = (static_cast<long long>(b) * H + h) * Lq + q0 + tid;
    lse_s[tid] = q0 + tid < Lq ? lse[r] : 0.f;
    d_s[tid] = q0 + tid < Lq ? dvec[r] : 0.f;
  }

  // the forward's live key range of this query tile: [k_lo, k_hi)
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Lq) - 1;
  const int k_hi = causal ? min(Lk, qpos_hi + 1) : Lk;
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[a][c] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Qs written / the previous tile's Ks, Vs, dSs consumed
    load_rows(Ks, DP, k + b * ks.b + kh * ks.h, ks, k0, Lk, Dh, tid);
    load_rows(Vs, VP, v + b * vs.b + kh * vs.h, vs, k0, Lk, Dv, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, DP, Ks, DP, Dh, ty, tx);
    tile_dot(dp, dOs, VP, Vs, VP, Dv, ty, tx);
    probs(s, dp, lse_s, d_s, q0, k0, Lq, Lk, causal, window, q_offset, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ[r][d] += Σ_j dS[r][j]·K[j][d] for rows ty + 16a, columns tx + 16c
    for (int j = 0; j < BK; ++j) {
      float ds4[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds4[a] = dSs[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < Dh ? Ks[j * DP + col] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] += ds4[a] * kv;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Lq) continue;
    T* dqrow = dq + b * dqs.b + row * dqs.l + h * dqs.h;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) dqrow[col] = rt::from_f32<T>(acc[a][c]);
    }
  }
}

Strides st(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* dvec, void* dq, void* dk, void* dv, int B, int H, int KH,
           int Lq, int Lk, int Dh, int Dv, const long long* qs, const long long* ks,
           const long long* vs, const long long* os, const long long* dos, const long long* dqs,
           const long long* dks, const long long* dvs, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * H * Lq;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      static_cast<const T*>(o), dop, dvec, B, H, Lq, Dv, st(os), st(dos));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t tiles = static_cast<size_t>(BK) * (Dh + 1) + static_cast<size_t>(BK) * (Dv + 1) +
                       static_cast<size_t>(BQ) * (Dh + 1) + static_cast<size_t>(BQ) * (Dv + 1);
  const size_t smem_kv = sizeof(float) * (tiles + 2 * BQ * (BK + 1) + 2 * BQ);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T><<<dim3(KH, (Lk + BK - 1) / BK, B), NT, smem_kv, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), H, KH, Lq, Lk, Dh, Dv,
      st(qs), st(ks), st(vs), st(dos), st(dks), st(dvs), causal, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_q = sizeof(float) * (tiles + BQ * (BK + 1) + 2 * BQ);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T><<<dim3(H, (Lq + BQ - 1) / BQ, B), NT, smem_q, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<T*>(dq), H, KH, Lq, Lk, Dh, Dv, st(qs), st(ks),
      st(vs), st(dos), st(dqs), causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout in the model's (B, L, H, D) layout with (batch,
// sequence, head) strides in elements (head dim contiguous); lse (B, H, Lq)
// float32 from the forward; dvec a (B, H, Lq) float32 scratch; dq, dk, dv
// written in the inputs' dtype.  window <= 0 means no window.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dvec, void* dq,
                                   void* dk, void* dv, int B, int H, int KH, int Lq, int Lk,
                                   int Dh, int Dv, const long long* q_strides,
                                   const long long* k_strides, const long long* v_strides,
                                   const long long* o_strides, const long long* do_strides,
                                   const long long* dq_strides, const long long* dk_strides,
                                   const long long* dv_strides, int causal, int window,
                                   int q_offset, float scale, int dtype, void* stream) {
  if (Dh > DMAX || Dv > DMAX || Dh < 1 || Dv < 1 || KH <= 0 || H % KH != 0 || B < 1 || Lq < 1 ||
      Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dvp = static_cast<float*>(dvec);
#define FLASH_BWD_LAUNCH(T)                                                                    \
  return launch<T>(q, k, v, o, dout, l, dvp, dq, dk, dv, B, H, KH, Lq, Lk, Dh, Dv, q_strides,  \
                   k_strides, v_strides, o_strides, do_strides, dq_strides, dk_strides,          \
                   dv_strides, causal, window, q_offset, scale, s)
  if (dtype == rt::BF16) FLASH_BWD_LAUNCH(__nv_bfloat16);
  if (dtype == rt::F32) FLASH_BWD_LAUNCH(float);
#undef FLASH_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
