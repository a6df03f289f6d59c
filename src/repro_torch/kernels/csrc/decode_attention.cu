// Decode attention (flash-decoding) for Hopper.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
//           (body _decode_kernel).
// Computes: one query token per sequence against its KV cache; the G = H / KH
//           query heads of a group share each K/V row; online softmax in f32,
//           masked scores NEG_INF (-1e30), l clamped at 1e-30.  Unlike the TPU
//           kernel's scalar pos, pos is a (B,) int32 device tensor: slot s of
//           sequence b is valid where s < min(pos[b] + 1, S).  That one rule is
//           both the full-cache rule (s <= pos[b]) and the ring-window rule, so
//           the ring window needs no flag here (only the writer folds pos % S).
// Layout:   the cache stays in the model's (B, S, KH, D) layout and is read
//           through strides: no transpose per decode step.
//
// Bound: device-memory bytes (each valid K/V row is read once for ~4·G·D
// flops).  Design: split-S.  Pass 1 runs one block per (64-slot chunk, KV
// head, sequence), so a short batch still fills the card; chunks past pos[b]
// exit at once (the TPU kernel's skip of blocks past pos).  Each block writes
// its chunk's unnormalised (m, l, acc) to a workspace the wrapper allocated.
// Pass 2 combines the chunks of each (sequence, KV head) in chunk order with
// no atomics, so decode is deterministic run to run.
#include "common.cuh"

namespace {

constexpr int CS = 64;   // cache slots per chunk
constexpr int NT = 128;  // threads per block: 4 warps
constexpr int NW = NT / 32;
constexpr int DMAX = 128;
constexpr int DL = DMAX / 32;  // head-dim elements per lane in the score pass

template <typename T>
__global__ void __launch_bounds__(NT) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, float* __restrict__ ws_m, float* __restrict__ ws_l,
    float* __restrict__ ws_acc, int H, int KH, int S, int Dh, int Dv, int n_chunks,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale) {
  extern __shared__ float sm[];
  const int G = H / KH;
  float* qs = sm;           // G x Dh
  float* ps = qs + G * Dh;  // G x CS

  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_valid = min(pos[b] + 1, S);
  const int s0 = c * CS;
  if (s0 >= n_valid) return;  // past pos[b]: pass 2 never reads this chunk
  const int ns = min(CS, n_valid - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < G * Dh; idx += NT) {
    const int g = idx / Dh, d = idx - g * Dh;
    qs[idx] = rt::to_f32(q[b * q_sb + (kh * G + g) * q_sh + d]);
  }
  __syncthreads();

  // scores: warp w takes slots w, w + 4, ...; lanes split the head dim
  const T* kb = k + b * k_sb + kh * k_sh + s0 * k_ss;
  for (int j = warp; j < ns; j += NW) {
    const T* kr = kb + j * k_ss;
    float kd[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      kd[i] = d < Dh ? rt::to_f32(kr[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) part += qs[g * Dh + d] * kd[i];
      }
      part = rt::warp_sum(part);
      if (lane == 0) ps[g * CS + j] = part * scale;
    }
  }
  __syncthreads();

  // chunk-local softmax statistics, one warp per head of the group
  const long long ws_row = (static_cast<long long>(b) * KH + kh) * n_chunks + c;
  for (int g = warp; g < G; g += NW) {
    float mx = rt::NEG_INF;
    for (int j = lane; j < ns; j += 32) mx = fmaxf(mx, ps[g * CS + j]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < ns; j += 32) {
      const float p = expf(ps[g * CS + j] - mx);
      ps[g * CS + j] = p;
      sum += p;
    }
    sum = rt::warp_sum(sum);
    if (lane == 0) {
      ws_m[ws_row * G + g] = mx;
      ws_l[ws_row * G + g] = sum;
    }
  }
  __syncthreads();

  // unnormalised chunk output: thread d sums p_j * V[j][d]
  const T* vb = v + b * v_sb + kh * v_sh + s0 * v_ss;
  for (int d = tid; d < Dv; d += NT) {
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < ns; ++j) a += ps[g * CS + j] * rt::to_f32(vb[j * v_ss + d]);
      ws_acc[(ws_row * G + g) * Dv + d] = a;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_combine_kernel(
    const int* __restrict__ pos, const float* __restrict__ ws_m, const float* __restrict__ ws_l,
    const float* __restrict__ ws_acc, T* __restrict__ o, int H, int KH, int S, int Dv,
    int n_chunks, long long o_sb, long long o_sh) {
  const int G = H / KH;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int n_valid = min(pos[b] + 1, S);
  const int nc = (n_valid + CS - 1) / CS;
  const long long base = (static_cast<long long>(b) * KH + kh) * n_chunks;
  for (int g = 0; g < G; ++g) {
    float M = rt::NEG_INF;
    for (int c = 0; c < nc; ++c) M = fmaxf(M, ws_m[(base + c) * G + g]);
    float L = 0.f;
    for (int c = 0; c < nc; ++c) L += ws_l[(base + c) * G + g] * expf(ws_m[(base + c) * G + g] - M);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    T* orow = o + b * o_sb + (kh * G + g) * o_sh;
    for (int d = threadIdx.x; d < Dv; d += NT) {
      float a = 0.f;
      for (int c = 0; c < nc; ++c)
        a += ws_acc[((base + c) * G + g) * Dv + d] * expf(ws_m[(base + c) * G + g] - M);
      orow[d] = rt::from_f32<T>(a * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos, void* o, float* ws_m,
           float* ws_l, float* ws_acc, int B, int H, int KH, int S, int Dh, int Dv, int n_chunks,
           const long long* qs, const long long* ks, const long long* vs, const long long* os,
           float scale, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = sizeof(float) * static_cast<size_t>(G) * (Dh + CS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_partial_kernel<T><<<dim3(n_chunks, KH, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos, ws_m,
      ws_l, ws_acc, H, KH, S, Dh, Dv, n_chunks, qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(KH, B), NT, 0, stream>>>(
      pos, ws_m, ws_l, ws_acc, static_cast<T*>(o), H, KH, S, Dv, n_chunks, os[0], os[1]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_chunk() { return CS; }

// q strides are (batch, head), cache strides (batch, slot, head), out strides
// (batch, head), all in elements with a contiguous last dim.  The workspaces
// hold B*KH*n_chunks*G floats (m, l) and that times Dv (acc);
// n_chunks = ceil(S / decode_attention_chunk()).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, const int* pos,
                                    void* o, float* ws_m, float* ws_l, float* ws_acc, int B,
                                    int H, int KH, int S, int Dh, int Dv, int n_chunks,
                                    const long long* q_strides, const long long* k_strides,
                                    const long long* v_strides, const long long* o_strides,
                                    float scale, int dtype, void* stream) {
  if (Dh > DMAX || KH <= 0 || H % KH != 0 || n_chunks * CS < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(q, k, v, pos, o, ws_m, ws_l, ws_acc, B, H, KH, S, Dh, Dv,
                                 n_chunks, q_strides, k_strides, v_strides, o_strides, scale, st);
  if (dtype == rt::F32)
    return launch<float>(q, k, v, pos, o, ws_m, ws_l, ws_acc, B, H, KH, S, Dh, Dv, n_chunks,
                         q_strides, k_strides, v_strides, o_strides, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
