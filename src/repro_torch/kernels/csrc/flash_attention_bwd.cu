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
// the forward's).  Deterministic, with no float atomics, in three launches:
//   1. flash_bwd_dot_kernel: D, one warp a (b, h, query) row (a small pass,
//      bound by bytes);
//   2. a dK/dV kernel: one block owns (b, KV head, key tile), loops over the
//      G query heads and the query tiles that the causal diagonal and the
//      window let see its keys, keeps dK and dV in registers and writes each
//      once;
//   3. a dQ kernel: one block owns (b, head, query tile) and loops over the
//      key tiles that the forward loads, keeping dQ in registers.
// The price of no atomics: S and dP are formed in both kernels, 7 products
// where 5 are needed, so the best the pair can do is 1.4× the bound.  No
// tile that the mask removes is loaded, the mask (a select) runs only on
// tiles that cross an edge, and the heaviest causal tiles launch first.
// This file is the bf16 route (the train path), as the forward's:
//
// flash_bwd_dkdv_wgmma_kernel and
//   flash_bwd_dq_wgmma_kernel, every product on the tensor cores (wgmma)
//   with the forward's helpers (hopper.cuh: 16-byte cp.async into the
//   128-byte swizzle, desc128, wgmma_ss / wgmma_rs, pack_bf16).
//   dK/dV: a block of two warpgroups owns 128 keys (64 each); K and V are
//   loaded once, Q, dO and the tile's lse and D arrive through a 2-stage
//   cp.async ring.  Working transposed, so that P and dS come out with key
//   rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS products (all four operands
//   K-major along the head dim), Pᵀ = 2^(Sᵀ·scale·log2e − lse·log2e) and
//   dSᵀ = Pᵀ∘(dPᵀ − D)·scale are formed on the accumulator layout (lse and
//   D vary along its columns: each thread reads its 16 column values from
//   shared memory), then dV += Pᵀ·dO and dK += dSᵀ·Q are RS products: Pᵀ
//   and dSᵀ rounded to bf16 in registers (as the forward rounds P), dO and
//   Q the MN-major B operand (the descriptor's transpose bit), as V is in
//   the forward's P·V.  dK and dV stay in f32 registers across the loop.
//   dQ: the forward kernel's shape (128 query rows, two warpgroups, K and V
//   through the 2-stage ring over the forward's live key range) with
//   S = Q·Kᵀ and dP = dO·Vᵀ as SS products, dS formed in registers and
//   dQ += dS·K as an RS product with K MN-major.  Both take any Dh, Dv <=
//   128 that is a multiple of 8 (templated on the padded 64 / 128; the
//   copies zero-fill), one block an SM (~130 KB of shared memory each).
// bf16 at a padded head dim of 256 (Dh or Dv in (128, 256], both padded to
//   256): dK and dV of 64 keys are 2 × 128 f32 a thread of one warpgroup,
//   over the 255-register limit, and the 128-key / 128-query tiles above
//   need 256 KB of shared memory.  So each block's two warpgroups split
//   the products by role instead of by rows:
//   flash_bwd_dkdv_wgmma256_kernel: a block owns 64 keys.  Warpgroup 0
//     forms Sᵀ = K·Qᵀ and Pᵀ, hands Pᵀ (f32) to warpgroup 1 through
//     shared memory and runs dV += Pᵀ·dO; warpgroup 1 forms dPᵀ = V·dOᵀ,
//     then dSᵀ from the handed Pᵀ, and runs dK += dSᵀ·Q.  Each holds one
//     128-f32 accumulator; S and dP are formed once.  K and V 64 KB, the
//     Q / dO ring 128 KB, Pᵀ 16 KB: 210 KB.
//   flash_bwd_dq_wgmma256_kernel: a block owns 64 query rows.  Warpgroup 0
//     forms S and P, warpgroup 1 dP; both hand theirs (f32) over through
//     shared memory, both form the same dS, and warpgroup w runs dQ's
//     columns [128w, 128w + 128) += dS·K.  Q and dO 64 KB, the K / V ring
//     128 KB, P and dP 32 KB: 225 KB.
//   The arithmetic is the 128 kernels' (P and dS in f32, rounded to bf16
//   only as a product's A operand), and still no atomics.
// f32, and bf16 outside these kernels' envelope, run the SIMT kernels of
// flash_attention_wide.cu (the same recurrence, no atomics): f32 stays exact
// for the checks that need it.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 256;  // threads
constexpr int DMAX = 256;

struct Strides {
  long long b, l, h;
};

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

Strides st(const long long* s) { return Strides{s[0], s[1], s[2]}; }

// D[b, h, i] = rowsum(dout∘out), the first launch
template <typename T>
int launch_dot(const void* o, const void* dout, float* dvec, int B, int H, int Lq, int Dv,
               const long long* os, const long long* dos, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * Lq;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dvec, B, H, Lq, Dv, st(os), st(dos));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

using namespace hop;

constexpr int BKB = 128;  // keys of a dK/dV block: two warpgroups of 64
constexpr int BQT = 64;   // query rows of a tile of the dK/dV loop
constexpr int BQB = 128;  // query rows of a dQ block: two warpgroups of 64
constexpr int BKT = 64;   // keys of a tile of the dQ loop
constexpr float LOG2E = 1.4426950408889634f;

// 4 bytes global -> shared; valid == false writes 4 zero bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// A 64 x 64 f32 accumulator tile as the register A operand of four k
// steps of 16 columns, rounded to bf16 (as the forward feeds P to O += P·V)
__device__ __forceinline__ void to_frags(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// the 64 rows x DPAD columns of a warpgroup's f32 accumulator, written as
// bf16 pairs to rows r0 + row0 (+ 8) of a (row stride `ld`) matrix: rows
// past n_rows and columns past d are dropped
template <int DPAD>
__device__ __forceinline__ void store_rows(bf16* base, long long ld, const float (&acc)[DPAD / 2],
                                           int r0, int n_rows, int d, int row0, int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row0 + 8 * r;
    if (row >= n_rows) continue;
    bf16* p = base + row * ld;
#pragma unroll
    for (int n = 0; n < DPAD / 8; ++n) {
      const int c = 8 * n + col0;
      if (c < d)
        *reinterpret_cast<uint32_t*>(p + c) = pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

// DP / DVP: the q·k and v head dims padded to 64 or 128
template <int DP, int DVP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KH, int Lq, int Lk, int Dh, int Dv,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int causal,
    int window, int q_offset, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_addr(smem_raw);
  const uint32_t sK = (s0 + 1023u) & ~1023u;        // BKB x DP
  const uint32_t sV = sK + BKB * DP * 2;             // BKB x DVP
  const uint32_t sQ = sV + BKB * DVP * 2;            // 2 stages x BQT x DP
  const uint32_t sO = sQ + 2 * BQT * DP * 2;         // 2 stages x BQT x DVP (dO)
  const uint32_t sL = sO + 2 * BQT * DVP * 2;        // 2 stages x (lse, D) x BQT f32
  const float* lsd = reinterpret_cast<const float*>(smem_raw + (sL - s0));

  // key tile 0 first: under the causal mask it sees the most queries
  const int kh = blockIdx.x, k0 = blockIdx.y * BKB, b = blockIdx.z;
  const int G = H / KH, tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  // query rows that see some key of [k0, k0 + BKB): [i_lo, i_hi), in
  // query tiles [t_lo, t_lo + n_qt) of each of the G heads
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Lq, k0 + BKB - 1 + window - q_offset) : Lq;
  const int t_lo = i_lo / BQT;
  const int n_qt = i_hi > i_lo ? (i_hi + BQT - 1) / BQT - t_lo : 0;
  const int n_it = G * n_qt;

  // this warpgroup's 64 keys and the query rows that see them: [wi_lo, wi_hi)
  const int wk0 = k0 + wg * 64;
  const bool has_keys = wk0 < Lk;
  const int wi_lo = causal ? max(0, wk0 - q_offset) : 0;
  const int wi_hi = window > 0 ? min(Lq, wk0 + 63 + window - q_offset) : Lq;

  // this thread's two rows of the accumulator layout (keys) and its columns (queries)
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int kpos0 = wk0 + row0;

  auto load_q = [&](int it, int st) {  // query tile `it` of the loop into stage st
    const int h = kh * G + it / n_qt, q0 = (t_lo + it % n_qt) * BQT;
    load_tile<BQT, DP, NT>(sQ + st * (BQT * DP * 2), q + b * qs.b + h * qs.h, qs.l, q0, Lq, Dh, tid);
    load_tile<BQT, DVP, NT>(sO + st * (BQT * DVP * 2), dout + b * dos.b + h * dos.h, dos.l, q0, Lq,
                            Dv, tid);
    if (tid < 2 * BQT) {  // threads 0-63 lse, 64-127 D; rows past Lq read as 0
      const int r = tid & (BQT - 1);
      const float* src = (tid < BQT ? lse : dvec) + (static_cast<long long>(b) * H + h) * Lq + q0 + r;
      cp_async4(sL + st * (2 * BQT * 4) + tid * 4, q0 + r < Lq ? src : lse, q0 + r < Lq);
    }
  };

  if (n_it > 0) {
    load_tile<BKB, DP, NT>(sK, k + b * ks.b + kh * ks.h, ks.l, k0, Lk, Dh, tid);
    load_tile<BKB, DVP, NT>(sV, v + b * vs.b + kh * vs.h, vs.l, k0, Lk, Dv, tid);
    load_q(0, 0);
  }
  cp_async_commit();

  float dka[DP / 2], dva[DVP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) dva[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);  // the other stage, released last iteration
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group of copies has landed
    fence_async_shared();
    __syncthreads();

    const int q0 = (t_lo + it % n_qt) * BQT;
    if (has_keys && q0 < wi_hi && q0 + BQT > wi_lo) {  // uniform per warpgroup
      const uint32_t qst = sQ + st * (BQT * DP * 2), ost = sO + st * (BQT * DVP * 2);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f, dp[i] = 0.f;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, one wgmma group each: K-major A and B,
      // k steps of 16 inside each 64-column region.  Pᵀ is formed while
      // dPᵀ runs, and dSᵀ while dV += Pᵀ·dO runs.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss(s, desc128(sK + (kk >> 2) * (BKB * ROW_BYTES) + wg * (64 * ROW_BYTES) + off, 16, 1024),
                 desc128(qst + (kk >> 2) * (BQT * ROW_BYTES) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DVP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss(dp, desc128(sV + (kk >> 2) * (BKB * ROW_BYTES) + wg * (64 * ROW_BYTES) + off, 16, 1024),
                 desc128(ost + (kk >> 2) * (BQT * ROW_BYTES) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // Sᵀ has landed; dPᵀ may still run
      fence_regs(s);

      // s[4n + 2r + e]: key kpos0 + 8r, query q0 + 8n + col0 + e.  Masked
      // pairs and rows past Lq / Lk get the score −1e30 (P = 0).
      const int qpos_lo = q_offset + q0;
      const bool edge = q0 + BQT > Lq || wk0 + 64 > Lk || (causal && qpos_lo < wk0 + 63) ||
                        (window > 0 && qpos_lo + BQT - 1 - wk0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qi = q0 + 8 * (i >> 2) + col0 + (i & 1), kpos = kpos0 + 8 * ((i >> 1) & 1);
          bool ok = qi < Lq && kpos < Lk;
          if (causal) ok = ok && q_offset + qi >= kpos;
          if (window > 0) ok = ok && q_offset + qi - kpos < window;
          s[i] = ok ? s[i] : rt::NEG_INF;
        }
      }
      // Pᵀ = exp(Sᵀ·scale − lse), lse by column
      const float* ls = lsd + st * (2 * BQT);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + col0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[4 * n + j] = fast_exp2(fmaf(s[4 * n + j], scale_log2, -((j & 1) ? l2.y : l2.x) * LOG2E));
      }
      // dV += Pᵀ·dO: Pᵀ (bf16) the register A operand, 16 queries a k step;
      // dO MN-major, regions BQT rows apart
      uint32_t pa[4][4];
      to_frags(s, pa);
      fence_regs(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dva, pa[kk], desc128(ost + kk * (16 * ROW_BYTES), BQT * ROW_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // dPᵀ has landed; dV += Pᵀ·dO may still run
      fence_regs(dp);
      // dSᵀ = Pᵀ∘(dPᵀ − D)·scale, D by column; then dK += dSᵀ·Q, Q MN-major
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(ls + BQT + 8 * n + col0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dp[4 * n + j] = s[4 * n + j] * (dp[4 * n + j] - ((j & 1) ? d2.y : d2.x)) * scale;
      }
      uint32_t da[4][4];
      to_frags(dp, da);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dka, da[kk], desc128(qst + kk * (16 * ROW_BYTES), BQT * ROW_BYTES, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dva);
      fence_regs(dka);
    }
    __syncthreads();  // both warpgroups are done with stage st
  }
  cp_async_wait<0>();

  if (!has_keys) return;
  store_rows<DP>(dk + b * dks.b + kh * dks.h, dks.l, dka, wk0, Lk, Dh, row0, col0);
  store_rows<DVP>(dv + b * dvs.b + kh * dvs.h, dvs.l, dva, wk0, Lk, Dv, row0, col0);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dq, int H, int KH, int Lq, int Lk, int Dh, int Dv, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dqs, int causal, int window, int q_offset, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;  // BQB x DP
  const uint32_t sO = sQ + BQB * DP * 2;                        // BQB x DVP (dO)
  const uint32_t sK = sO + BQB * DVP * 2;                       // 2 stages x BKT x DP
  const uint32_t sV = sK + 2 * BKT * DP * 2;                    // 2 stages x BKT x DVP

  // heaviest causal query tiles first: blockIdx.y counts down the sequence
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQB, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  // key tiles the block loads, the forward's: [t_lo, t_hi)
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQB, Lq) - 1;
  const int k_hi = causal ? min(Lk, qpos_hi + 1) : Lk;
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int t_lo = k_lo / BKT, t_hi = (k_hi + BKT - 1) / BKT;

  // this warpgroup's 64 rows and the keys they see: [wk_lo, wk_hi)
  const int wq0 = q0 + wg * 64;
  const bool has_rows = wq0 < Lq;
  const int wpos_lo = q_offset + wq0, wpos_hi = q_offset + min(wq0 + 64, Lq) - 1;
  const int wk_hi = causal ? min(Lk, wpos_hi + 1) : Lk;
  const int wk_lo = window > 0 ? max(0, wpos_lo - window + 1) : 0;

  // this thread's two rows of the accumulator layout, r and r + 8: their
  // lse (in log2 units) and D
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int qpos0 = wpos_lo + row0, qpos1 = qpos0 + 8;
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + row0 + 8 * r;
    const long long i = (static_cast<long long>(b) * H + h) * Lq + row;
    lse2[r] = row < Lq ? lse[i] * LOG2E : 0.f;
    dr[r] = row < Lq ? dvec[i] : 0.f;
  }

  if (t_lo < t_hi) {
    load_tile<BQB, DP, NT>(sQ, q + b * qs.b + h * qs.h, qs.l, q0, Lq, Dh, tid);
    load_tile<BQB, DVP, NT>(sO, dout + b * dos.b + h * dos.h, dos.l, q0, Lq, Dv, tid);
    load_tile<BKT, DP, NT>(sK, kb, ks.l, t_lo * BKT, Lk, Dh, tid);
    load_tile<BKT, DVP, NT>(sV, vb, vs.l, t_lo * BKT, Lk, Dv, tid);
  }
  cp_async_commit();

  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int j = t_lo; j < t_hi; ++j) {
    const int st = (j - t_lo) & 1;
    if (j + 1 < t_hi) {  // the next tile goes into the other stage, released last iteration
      load_tile<BKT, DP, NT>(sK + (st ^ 1) * (BKT * DP * 2), kb, ks.l, (j + 1) * BKT, Lk, Dh, tid);
      load_tile<BKT, DVP, NT>(sV + (st ^ 1) * (BKT * DVP * 2), vb, vs.l, (j + 1) * BKT, Lk, Dv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();

    const int k0 = j * BKT;
    if (has_rows && k0 < wk_hi && k0 + BKT > wk_lo) {  // uniform per warpgroup
      const uint32_t kst = sK + st * (BKT * DP * 2), vst = sV + st * (BKT * DVP * 2);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f, dp[i] = 0.f;
      // S = Q·Kᵀ and dP = dO·Vᵀ, one wgmma group each: K-major A and B.
      // P is formed while dP runs.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss(s, desc128(sQ + (kk >> 2) * (BQB * ROW_BYTES) + wg * (64 * ROW_BYTES) + off, 16, 1024),
                 desc128(kst + (kk >> 2) * (BKT * ROW_BYTES) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DVP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss(dp, desc128(sO + (kk >> 2) * (BQB * ROW_BYTES) + wg * (64 * ROW_BYTES) + off, 16, 1024),
                 desc128(vst + (kk >> 2) * (BKT * ROW_BYTES) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S has landed; dP may still run
      fence_regs(s);

      // s[4n + 2r + e]: row row0 + 8r, key k0 + 8n + col0 + e
      const bool edge = k0 + BKT > Lk || (causal && k0 + BKT - 1 > wpos_lo) ||
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
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = fast_exp2(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1]));
      wgmma_wait0();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dr[(i >> 1) & 1]) * scale;
      // dQ += dS·K: dS (bf16) the register A operand, 16 keys a k step; K MN-major
      uint32_t a[4][4];
      to_frags(dp, a);
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dqa, a[kk], desc128(kst + kk * (16 * ROW_BYTES), BKT * ROW_BYTES, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dqa);
    }
    __syncthreads();  // both warpgroups are done with stage st
  }
  cp_async_wait<0>();

  if (!has_rows) return;
  store_rows<DP>(dq + b * dqs.b + h * dqs.h, dqs.l, dqa, wq0, Lq, Dh, row0, col0);
}

template <int DP, int DVP>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* dvec, void* dq, void* dk, void* dv, int B, int H, int KH,
           int Lq, int Lk, int Dh, int Dv, const long long* qs, const long long* ks,
           const long long* vs, const long long* os, const long long* dos, const long long* dqs,
           const long long* dks, const long long* dvs, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  cudaError_t err = static_cast<cudaError_t>(launch_dot<bf16>(o, dout, dvec, B, H, Lq, Dv, os, dos, stream));
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem_kv = 1024 + BKB * (DP + DVP) * 2 + 2 * BQT * (DP + DVP) * 2 + 2 * 2 * BQT * 4;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wgmma_kernel<DP, DVP><<<dim3(KH, (Lk + BKB - 1) / BKB, B), NT, smem_kv, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KH, Lq, Lk,
      Dh, Dv, st(qs), st(ks), st(vs), st(dos), st(dks), st(dvs), causal, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem_q = 1024 + BQB * (DP + DVP) * 2 + 2 * BKT * (DP + DVP) * 2;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma_kernel<DP, DVP><<<dim3(H, (Lq + BQB - 1) / BQB, B), NT, smem_q, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<bf16*>(dq), H, KH, Lq, Lk, Dh, Dv, st(qs), st(ks),
      st(vs), st(dos), st(dqs), causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 at the padded head dim 256: the two warpgroups split by role
// ---------------------------------------------------------------------------

constexpr int D256 = 256;
constexpr int BR = 64;  // keys (dK/dV) or query rows (dQ) of a block: one warpgroup's rows

// dK and dV of 64 keys: warpgroup 0 forms Pᵀ and runs dV += Pᵀ·dO,
// warpgroup 1 forms dPᵀ, takes Pᵀ from shared memory and runs dK += dSᵀ·Q
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_wgmma256_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KH, int Lq, int Lk, int Dh, int Dv,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int causal,
    int window, int q_offset, float scale) {
  constexpr int TILE = BR * D256 * 2;                // one 64 x 256 bf16 tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_addr(smem_raw);
  const uint32_t sK = (s0 + 1023u) & ~1023u;        // BR x 256
  const uint32_t sV = sK + TILE;                     // BR x 256
  const uint32_t sQ = sV + TILE;                     // 2 stages x BQT x 256
  const uint32_t sO = sQ + 2 * TILE;                 // 2 stages x BQT x 256 (dO)
  const uint32_t sL = sO + 2 * TILE;                 // 2 stages x (lse, D) x BQT f32
  const uint32_t sP = sL + 2 * 2 * BQT * 4;          // Pᵀ: 32 f32 a thread of warpgroup 0
  const float* lsd = reinterpret_cast<const float*>(smem_raw + (sL - s0));
  float* pt = reinterpret_cast<float*>(smem_raw + (sP - s0));

  // key tile 0 first: under the causal mask it sees the most queries
  const int kh = blockIdx.x, k0 = blockIdx.y * BR, b = blockIdx.z;
  const int G = H / KH, tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31;

  // query rows that see some key of [k0, k0 + BR): [i_lo, i_hi), in query
  // tiles [t_lo, t_lo + n_qt) of each of the G heads
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Lq, k0 + BR - 1 + window - q_offset) : Lq;
  const int t_lo = i_lo / BQT;
  const int n_qt = i_hi > i_lo ? (i_hi + BQT - 1) / BQT - t_lo : 0;
  const int n_it = G * n_qt;

  // this thread's two rows of the accumulator layout (keys) and its columns (queries)
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int kpos0 = k0 + row0;

  auto load_q = [&](int it, int st) {  // query tile `it` of the loop into stage st
    const int h = kh * G + it / n_qt, q0 = (t_lo + it % n_qt) * BQT;
    load_tile<BQT, D256, NT>(sQ + st * TILE, q + b * qs.b + h * qs.h, qs.l, q0, Lq, Dh, tid);
    load_tile<BQT, D256, NT>(sO + st * TILE, dout + b * dos.b + h * dos.h, dos.l, q0, Lq, Dv, tid);
    if (tid < 2 * BQT) {  // threads 0-63 lse, 64-127 D; rows past Lq read as 0
      const int r = tid & (BQT - 1);
      const float* src = (tid < BQT ? lse : dvec) + (static_cast<long long>(b) * H + h) * Lq + q0 + r;
      cp_async4(sL + st * (2 * BQT * 4) + tid * 4, q0 + r < Lq ? src : lse, q0 + r < Lq);
    }
  };

  if (n_it > 0) {
    load_tile<BR, D256, NT>(sK, k + b * ks.b + kh * ks.h, ks.l, k0, Lk, Dh, tid);
    load_tile<BR, D256, NT>(sV, v + b * vs.b + kh * vs.h, vs.l, k0, Lk, Dv, tid);
    load_q(0, 0);
  }
  cp_async_commit();

  float acc[D256 / 2];  // warpgroup 0: dV, warpgroup 1: dK
#pragma unroll
  for (int i = 0; i < D256 / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);  // the other stage, released last iteration
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group of copies has landed
    fence_async_shared();
    __syncthreads();

    const uint32_t qst = sQ + st * TILE, ost = sO + st * TILE;
    const float* ls = lsd + st * (2 * BQT);
    const int q0 = (t_lo + it % n_qt) * BQT;
    float s[32];  // warpgroup 0: Sᵀ, then Pᵀ; warpgroup 1: dPᵀ, then dSᵀ
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    // K-major A and B, k steps of 16 inside each 64-column region
    const uint32_t a_base = wg == 0 ? sK : sV, b_base = wg == 0 ? qst : ost;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D256 / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss(s, desc128(a_base + (kk >> 2) * (BR * ROW_BYTES) + off, 16, 1024),
               desc128(b_base + (kk >> 2) * (BQT * ROW_BYTES) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    if (wg == 0) {
      // s[4n + 2r + e]: key kpos0 + 8r, query q0 + 8n + col0 + e.  Masked
      // pairs and rows past Lq / Lk get the score −1e30 (P = 0).
      const int qpos_lo = q_offset + q0;
      const bool edge = q0 + BQT > Lq || k0 + BR > Lk || (causal && qpos_lo < k0 + BR - 1) ||
                        (window > 0 && qpos_lo + BQT - 1 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qi = q0 + 8 * (i >> 2) + col0 + (i & 1), kpos = kpos0 + 8 * ((i >> 1) & 1);
          bool ok = qi < Lq && kpos < Lk;
          if (causal) ok = ok && q_offset + qi >= kpos;
          if (window > 0) ok = ok && q_offset + qi - kpos < window;
          s[i] = ok ? s[i] : rt::NEG_INF;
        }
      }
      // Pᵀ = exp(Sᵀ·scale − lse), lse by column
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + col0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[4 * n + j] = fast_exp2(fmaf(s[4 * n + j], scale_log2, -((j & 1) ? l2.y : l2.x) * LOG2E));
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) pt[i * 128 + t] = s[i];
    }
    __syncthreads();  // Pᵀ handed over
    if (wg == 1) {
      // dSᵀ = Pᵀ∘(dPᵀ − D)·scale, D by column, Pᵀ from warpgroup 0's thread t
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(ls + BQT + 8 * n + col0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[4 * n + j] = pt[(4 * n + j) * 128 + t] * (s[4 * n + j] - ((j & 1) ? d2.y : d2.x)) * scale;
      }
    }
    // warpgroup 0: dV += Pᵀ·dO; warpgroup 1: dK += dSᵀ·Q.  The A operand
    // (bf16) from registers, 16 queries a k step; dO / Q MN-major, regions
    // BQT rows apart
    uint32_t fa[4][4];
    to_frags(s, fa);
    const uint32_t bm = wg == 0 ? ost : qst;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<D256>(acc, fa[kk], bm + kk * (16 * ROW_BYTES), BQT * ROW_BYTES);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();  // stage st and Pᵀ are released
  }
  cp_async_wait<0>();

  if (k0 >= Lk) return;
  if (wg == 0)
    store_rows<D256>(dv + b * dvs.b + kh * dvs.h, dvs.l, acc, k0, Lk, Dv, row0, col0);
  else
    store_rows<D256>(dk + b * dks.b + kh * dks.h, dks.l, acc, k0, Lk, Dh, row0, col0);
}

// dQ of 64 query rows: warpgroup 0 forms P, warpgroup 1 dP; both hand
// theirs over, form the same dS and run dQ's column half w += dS·K
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_wgmma256_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dq, int H, int KH, int Lq, int Lk, int Dh, int Dv, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dqs, int causal, int window, int q_offset, float scale) {
  constexpr int TILE = BR * D256 * 2;                         // one 64 x 256 bf16 tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_addr(smem_raw);
  const uint32_t sQ = (s0 + 1023u) & ~1023u;                 // BR x 256
  const uint32_t sO = sQ + TILE;                              // BR x 256 (dO)
  const uint32_t sK = sO + TILE;                              // 2 stages x BKT x 256
  const uint32_t sV = sK + 2 * TILE;                          // 2 stages x BKT x 256
  const uint32_t sX = sV + 2 * TILE;                          // P, then dP: 32 f32 a thread each
  float* xs = reinterpret_cast<float*>(smem_raw + (sX - s0));

  // heaviest causal query tiles first: blockIdx.y counts down the sequence
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BR, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31;
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  // key tiles the block loads, the forward's: [t_lo, t_hi)
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BR, Lq) - 1;
  const int k_hi = causal ? min(Lk, qpos_hi + 1) : Lk;
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int t_lo = k_lo / BKT, t_hi = (k_hi + BKT - 1) / BKT;

  // this thread's two rows of the accumulator layout, r and r + 8: their
  // lse (in log2 units) and D
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int qpos0 = qpos_lo + row0, qpos1 = qpos0 + 8;
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    const long long i = (static_cast<long long>(b) * H + h) * Lq + row;
    lse2[r] = row < Lq ? lse[i] * LOG2E : 0.f;
    dr[r] = row < Lq ? dvec[i] : 0.f;
  }

  if (t_lo < t_hi) {
    load_tile<BR, D256, NT>(sQ, q + b * qs.b + h * qs.h, qs.l, q0, Lq, Dh, tid);
    load_tile<BR, D256, NT>(sO, dout + b * dos.b + h * dos.h, dos.l, q0, Lq, Dv, tid);
    load_tile<BKT, D256, NT>(sK, kb, ks.l, t_lo * BKT, Lk, Dh, tid);
    load_tile<BKT, D256, NT>(sV, vb, vs.l, t_lo * BKT, Lk, Dv, tid);
  }
  cp_async_commit();

  float dqa[64];  // dQ's columns [128·wg, 128·wg + 128)
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int j = t_lo; j < t_hi; ++j) {
    const int st = (j - t_lo) & 1;
    if (j + 1 < t_hi) {  // the next tile goes into the other stage, released last iteration
      load_tile<BKT, D256, NT>(sK + (st ^ 1) * TILE, kb, ks.l, (j + 1) * BKT, Lk, Dh, tid);
      load_tile<BKT, D256, NT>(sV + (st ^ 1) * TILE, vb, vs.l, (j + 1) * BKT, Lk, Dv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();

    const int k0 = j * BKT;
    const uint32_t kst = sK + st * TILE, vst = sV + st * TILE;
    float x[32];  // warpgroup 0: S, then P; warpgroup 1: dP
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    // S = Q·Kᵀ (warpgroup 0), dP = dO·Vᵀ (warpgroup 1): K-major A and B
    const uint32_t a_base = wg == 0 ? sQ : sO, b_base = wg == 0 ? kst : vst;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D256 / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss(x, desc128(a_base + (kk >> 2) * (BR * ROW_BYTES) + off, 16, 1024),
               desc128(b_base + (kk >> 2) * (BKT * ROW_BYTES) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(x);
    if (wg == 0) {
      // x[4n + 2r + e]: row row0 + 8r, key k0 + 8n + col0 + e
      const bool edge = k0 + BKT > Lk || (causal && k0 + BKT - 1 > qpos_lo) ||
                        (window > 0 && k0 <= qpos_hi - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          bool ok = kpos < Lk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          x[i] = ok ? x[i] : rt::NEG_INF;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = fast_exp2(fmaf(x[i], scale_log2, -lse2[(i >> 1) & 1]));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) xs[(wg * 32 + i) * 128 + t] = x[i];
    __syncthreads();  // P and dP handed over
    // dS = P∘(dP − D)·scale, the same bits in both warpgroups
    float ds[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float y = xs[((wg ^ 1) * 32 + i) * 128 + t];
      const float p = wg == 0 ? x[i] : y, dp = wg == 0 ? y : x[i];
      ds[i] = p * (dp - dr[(i >> 1) & 1]) * scale;
    }
    // dQ[:, 128·wg ...] += dS·K: dS (bf16) the register A operand, 16 keys
    // a k step; K MN-major, its columns from 128·wg on
    uint32_t a[4][4];
    to_frags(ds, a);
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dqa, a[kk], desc128(kst + kk * (16 * ROW_BYTES) + wg * (2 * BKT * ROW_BYTES), BKT * ROW_BYTES, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dqa);
    __syncthreads();  // stage st and the hand-over buffer are released
  }
  cp_async_wait<0>();

  store_rows<128>(dq + b * dqs.b + h * dqs.h + 128 * wg, dqs.l, dqa, q0, Lq, Dh - 128 * wg, row0, col0);
}

int launch256(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* dvec, void* dq, void* dk, void* dv, int B, int H, int KH,
              int Lq, int Lk, int Dh, int Dv, const long long* qs, const long long* ks,
              const long long* vs, const long long* os, const long long* dos, const long long* dqs,
              const long long* dks, const long long* dvs, int causal, int window, int q_offset,
              float scale, cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  constexpr int TILE = BR * D256 * 2;
  cudaError_t err = static_cast<cudaError_t>(launch_dot<bf16>(o, dout, dvec, B, H, Lq, Dv, os, dos, stream));
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem_kv = 1024 + 6 * TILE + 2 * 2 * BQT * 4 + 32 * 128 * 4;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wgmma256_kernel<<<dim3(KH, (Lk + BR - 1) / BR, B), NT, smem_kv, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KH, Lq, Lk,
      Dh, Dv, st(qs), st(ks), st(vs), st(dos), st(dks), st(dvs), causal, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem_q = 1024 + 6 * TILE + 2 * 32 * 128 * 4;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma256_kernel<<<dim3(H, (Lq + BR - 1) / BR, B), NT, smem_q, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<bf16*>(dq), H, KH, Lq, Lk, Dh, Dv, st(qs), st(ks),
      st(vs), st(dos), st(dqs), causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// The copies take 16-byte chunks: head dims, strides and bases in whole chunks.
bool aligned16(const void* p, const long long* strides, int d) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || d % 8 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* dvec, void* dq, void* dk, void* dv, int B, int H, int KH,
                int Lq, int Lk, int Dh, int Dv, const long long* qs, const long long* ks,
                const long long* vs, const long long* os, const long long* dos,
                const long long* dqs, const long long* dks, const long long* dvs, int causal,
                int window, int q_offset, float scale, cudaStream_t stream) {
  if (!aligned16(q, qs, Dh) || !aligned16(k, ks, Dh) || !aligned16(v, vs, Dv) ||
      !aligned16(dout, dos, Dv) || !aligned16(dq, dqs, Dh) || !aligned16(dk, dks, Dh) ||
      !aligned16(dv, dvs, Dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (Dh > 128 || Dv > 128)
    return launch256(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, H, KH, Lq, Lk, Dh, Dv, qs, ks, vs, os,
                     dos, dqs, dks, dvs, causal, window, q_offset, scale, stream);
#define FLASH_BWD_TC_LAUNCH(DP, DVP)                                                            \
  return launch<DP, DVP>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, H, KH, Lq, Lk, Dh, Dv, qs, \
                         ks, vs, os, dos, dqs, dks, dvs, causal, window, q_offset, scale, stream)
  if (Dh <= 64) {
    if (Dv <= 64) FLASH_BWD_TC_LAUNCH(64, 64);
    FLASH_BWD_TC_LAUNCH(64, 128);
  }
  if (Dv <= 64) FLASH_BWD_TC_LAUNCH(128, 64);
  FLASH_BWD_TC_LAUNCH(128, 128);
#undef FLASH_BWD_TC_LAUNCH
}

}  // namespace tc

}  // namespace

// q, k, v, out, dout in the model's (B, L, H, D) layout with (batch,
// sequence, head) strides in elements (head dim contiguous); lse (B, H, Lq)
// float32 from the forward; dvec a (B, H, Lq) float32 scratch; dq, dk, dv
// written in the inputs' dtype.  window <= 0 means no window.  bf16 only
// (flash_attention_wide.cu takes f32): q, k, v, dout, dq, dk, dv with
// 16-byte bases and head dims and strides in multiples of 8 elements (else
// cudaErrorMisalignedAddress).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dvec, void* dq,
                                   void* dk, void* dv, int B, int H, int KH, int Lq, int Lk,
                                   int Dh, int Dv, const long long* q_strides,
                                   const long long* k_strides, const long long* v_strides,
                                   const long long* o_strides, const long long* do_strides,
                                   const long long* dq_strides, const long long* dk_strides,
                                   const long long* dv_strides, int causal, int window,
                                   int q_offset, float scale, int dtype, void* stream) {
  if (dtype != rt::BF16 || Dh > DMAX || Dv > DMAX || Dh < 1 || Dv < 1 || KH <= 0 || H % KH != 0 || B < 1 ||
      Lq < 1 || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_bf16(q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(dvec), dq, dk, dv,
                         B, H, KH, Lq, Lk, Dh, Dv, q_strides, k_strides, v_strides, o_strides, do_strides,
                         dq_strides, dk_strides, dv_strides, causal, window, q_offset, scale,
                         static_cast<cudaStream_t>(stream));
}
