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
// lse:      for training, each row's natural-log log-sum-exp of the scaled,
//           masked scores can be written to a (B, H, Lq) f32 buffer, the
//           residual flash_attention_bwd.cu recomputes P from; serving
//           passes none and its time is unchanged.
//
// Bound: at prefill lengths the work is ~4·L²·H·Dh/2 flops against ~4·L·H·Dh
// elements moved, far above the card's ops-per-byte line, so it is bound by
// operations, and only the tensor cores (989 TFLOP/s bf16) come near that
// bound.  This file is the bf16 route (the serving and train path):
//
// flash_fwd_wgmma_kernel.  One block of two
//   warpgroups owns 128 query rows (64 per warpgroup) of one head and loops
//   over 64-key tiles.  S = Q·Kᵀ is a wgmma with Q and K read from shared
//   memory (both K-major); P is rounded to bf16 in registers (as the TPU
//   kernel's p.astype(v.dtype)) and fed back as the register A operand of
//   O += P·V, with V read from shared memory as an MN-major B operand (the
//   descriptor's transpose bit).  S and O stay in registers; the online
//   softmax runs on the wgmma accumulator layout with quad shuffles.  Q, K
//   and V tiles arrive by 16-byte cp.async into a 2-stage ring in the
//   128-byte swizzle that the wgmma descriptors name, so the loads of tile
//   j+1 overlap the products of tile j.  The copies zero-fill what lies
//   past Lq / Lk or past the real head dim, so one kernel, templated on the
//   padded head dims (64 or 128, or 256 for both when either passes 128),
//   takes any Dh, Dv <= 256 that is a multiple of 8 and any length.  Tiles
//   wholly above the causal diagonal
//   or before the window are never loaded; the mask (a select) runs only on
//   tiles that cross an edge.  The heaviest causal query tiles launch first.
//   96 KB of shared memory and 128 registers a thread, so two blocks share
//   an SM, and one block's softmax runs while the other's wgmma does.  The
//   softmax is what the tensor cores wait on: the scale is applied in the
//   exponent and 2^x runs as one ex2.approx (MUFU), which took about a fifth
//   off the kernel's time on an H100.  (A variant with one block an SM, a
//   4-stage ring and each warpgroup's P·V running under its next softmax
//   measured slower there.)  At the padded head dim 256 the same tiles
//   need 193 KB (Q 64 KB, the K / V ring 128 KB) and 128 f32 of O a thread
//   (two m64n128 products over V's column halves): one block an SM, up to
//   255 registers, the block's two warpgroups still overlapping each
//   other's softmax and products.
// f32, and bf16 outside this kernel's envelope (a head dim above 256, or a
// base, head dim or stride off the 16-byte grid), run the SIMT kernel of
// flash_attention_wide.cu: f32 exact for the checks that need it (TF32
// would not be).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int DMAX = 256;  // the widest head dim of this route

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

using namespace hop;

constexpr int BQ = 128;      // query rows per block: two warpgroups of 64
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads
constexpr int STAGES = 2;    // K/V ring

// DP / DVP: the q·k and v head dims padded to 64 or 128, or both to 256
// (193 KB of shared memory: one block an SM)
template <int DP, int DVP>
__global__ void __launch_bounds__(NT, DP > 128 || DVP > 128 ? 1 : 2) flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int KH, int Lq, int Lk, int Dh, int Dv,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    int causal, int window, int q_offset, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;  // BQ x DP
  const uint32_t sK = sQ + BQ * DP * 2;                         // STAGES x BK x DP
  const uint32_t sV = sK + STAGES * BK * DP * 2;                // STAGES x BK x DVP

  // heaviest causal query tiles first: blockIdx.y counts down the sequence
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kh * k_sh;
  const bf16* vb = v + b * v_sb + kh * v_sh;

  // key tiles the block loads: [t_lo, t_hi)
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Lq) - 1;
  const int k_hi = causal ? min(Lk, qpos_hi + 1) : Lk;
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  // this warpgroup's 64 rows and the keys they see: [wk_lo, wk_hi)
  const int wq0 = q0 + wg * 64;
  const bool has_rows = wq0 < Lq;
  const int wpos_lo = q_offset + wq0, wpos_hi = q_offset + min(wq0 + 64, Lq) - 1;
  const int wk_hi = causal ? min(Lk, wpos_hi + 1) : Lk;
  const int wk_lo = window > 0 ? max(0, wpos_lo - window + 1) : 0;

  // this thread's two rows of the accumulator layout: r and r + 8
  const int row0 = warp * 16 + (lane >> 2);
  const int qpos0 = wpos_lo + row0, qpos1 = qpos0 + 8;
  const int col0 = 2 * (lane & 3);

  if (t_lo < t_hi) {
    load_tile<BQ, DP, NT>(sQ, qb, q_sl, q0, Lq, Dh, tid);
    load_tile<BK, DP, NT>(sK, kb, k_sl, t_lo * BK, Lk, Dh, tid);
    load_tile<BK, DVP, NT>(sV, vb, v_sl, t_lo * BK, Lk, Dv, tid);
  }
  cp_async_commit();

  float acc[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

  for (int j = t_lo; j < t_hi; ++j) {
    const int st = (j - t_lo) & 1;
    if (j + 1 < t_hi) {  // the next tile goes into the other stage, released last iteration
      load_tile<BK, DP, NT>(sK + (st ^ 1) * (BK * DP * 2), kb, k_sl, (j + 1) * BK, Lk, Dh, tid);
      load_tile<BK, DVP, NT>(sV + (st ^ 1) * (BK * DVP * 2), vb, v_sl, (j + 1) * BK, Lk, Dv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    fence_async_shared();
    __syncthreads();

    const int k0 = j * BK;
    if (has_rows && k0 < wk_hi && k0 + BK > wk_lo) {  // uniform per warpgroup
      const uint32_t kst = sK + st * (BK * DP * 2), vst = sV + st * (BK * DVP * 2);
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      // S = Q·Kᵀ: K-major A and B, k steps of 16 (32 bytes) inside each 64-column region
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        const uint64_t da = desc128(sQ + (kk >> 2) * (BQ * ROW_BYTES) + wg * (64 * ROW_BYTES) + off, 16, 1024);
        const uint64_t db = desc128(kst + (kk >> 2) * (BK * ROW_BYTES) + off, 16, 1024);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // s[4n + 2r + e]: row row0 + 8r, key k0 + 8n + col0 + e.  m is the
      // running max of the unscaled scores: p = 2^((s - m)·scale_log2), so a
      // row that has seen only masked keys gets exactly 2^0, as on the TPU.
      const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > wpos_lo) ||
                        (window > 0 && k0 <= wpos_hi - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          bool ok = kpos < Lk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          s[i] = ok ? s[i] : rt::NEG_INF;
        }
      }
      float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = fast_exp2((m[r] - m_new) * scale_log2);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = fast_exp2((s[i] - m[r]) * scale_log2);
        l[r] += s[i];
      }
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P·V: P (rounded to bf16) is the register A operand, 16 keys per
      // step; V is MN-major: k step kk starts 16 rows in, regions BK rows apart
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn<DVP>(acc, a[kk], vst + kk * (16 * ROW_BYTES), BK * ROW_BYTES);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    __syncthreads();  // both warpgroups are done with stage st
  }
  cp_async_wait<0>();

  if (!has_rows) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + row0 + 8 * r;
    if (row >= Lq) continue;
    // m is the running max of the unscaled scores: the natural-log lse of
    // the scaled ones is m·scale + log(l), with scale = scale_log2·ln 2
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<long long>(b) * H + h) * Lq + row] =
          m[r] * scale_log2 * 0.6931471805599453f + logf(fmaxf(l[r], 1e-30f));
    bf16* orow = o + b * o_sb + row * o_sl + h * o_sh;
#pragma unroll
    for (int n = 0; n < DVP / 8; ++n) {
      const int c = 8 * n + col0;
      if (c < Dv)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16(acc[4 * n + 2 * r] * inv[r], acc[4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

template <int DP, int DVP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int KH, int Lq,
           int Lk, int Dh, int Dv, const long long* qs, const long long* ks, const long long* vs,
           const long long* os, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int smem = 1024 + BQ * DP * 2 + STAGES * BK * (DP + DVP) * 2;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP, DVP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (Lq + BQ - 1) / BQ, B);
  flash_fwd_wgmma_kernel<DP, DVP><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, KH, Lq, Lk, Dh, Dv, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
      vs[0], vs[1], vs[2], os[0], os[1], os[2], causal, window, q_offset,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// The loads take 16-byte chunks: head dims, strides and bases in whole chunks.
bool aligned16(const void* p, const long long* strides, int d) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || d % 8 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int KH, int Lq,
                int Lk, int Dh, int Dv, const long long* qs, const long long* ks,
                const long long* vs, const long long* os, int causal, int window, int q_offset,
                float scale, cudaStream_t stream) {
  if (!aligned16(q, qs, Dh) || !aligned16(k, ks, Dh) || !aligned16(v, vs, Dv) ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || os[0] % 2 || os[1] % 2 || os[2] % 2)
    return static_cast<int>(cudaErrorMisalignedAddress);
#define FLASH_TC_LAUNCH(DP, DVP)                                                                  \
  return launch<DP, DVP>(q, k, v, o, lse, B, H, KH, Lq, Lk, Dh, Dv, qs, ks, vs, os, causal, window, \
                         q_offset, scale, stream)
  if (Dh > 128 || Dv > 128) FLASH_TC_LAUNCH(256, 256);
  if (Dh <= 64) {
    if (Dv <= 64) FLASH_TC_LAUNCH(64, 64);
    FLASH_TC_LAUNCH(64, 128);
  }
  if (Dv <= 64) FLASH_TC_LAUNCH(128, 64);
  FLASH_TC_LAUNCH(128, 128);
#undef FLASH_TC_LAUNCH
}

}  // namespace tc

}  // namespace

// strides are (batch, sequence, head) in elements; the head_dim stride is 1.
// window <= 0 means no window.  bf16 only (flash_attention_wide.cu takes
// f32): head dims up to 256 in 16-byte chunks.  lse, when not null, is a
// (B, H, Lq) float32 buffer that receives each row's natural-log
// log-sum-exp of the scaled, masked scores (the residual the backward,
// flash_attention_bwd.cu, recomputes P from); serving passes null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int KH, int Lq, int Lk, int Dh, int Dv,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* o_strides,
                                   int causal, int window, int q_offset, float scale, int dtype,
                                   void* stream) {
  if (dtype != rt::BF16 || Dh > DMAX || Dv > DMAX || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_bf16(q, k, v, o, static_cast<float*>(lse), B, H, KH, Lq, Lk, Dh, Dv, q_strides, k_strides,
                         v_strides, o_strides, causal, window, q_offset, scale, static_cast<cudaStream_t>(stream));
}
