// Flash attention for Hopper at head dims above 256, bf16: forward and
// backward on the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:111
//   (flash_attention_pallas, body _flash_kernel) for bf16 calls whose Dh or
//   Dv lies in (256, 576] / (256, 512] (the Pallas kernel takes any head
//   dim), and for the backward the jnp custom VJP of
//   src/repro/models/attention.py::_make_flash, as flash_attention_bwd.cu
//   does at the narrower widths.
// Computes: what flash_attention.cu and flash_attention_bwd.cu compute: the
//   online softmax with f32 running max and sum, masked scores NEG_INF
//   (-1e30), l clamped at 1e-30, P rounded to bf16 before P·V, causal /
//   window / q_offset / GQA / ragged lengths, lse for training; the
//   backward's D = rowsum(dO∘O), P = exp(S·scale − lse), dV = Pᵀ·dO,
//   dP = dO·Vᵀ, dS = P∘(dP − D)·scale, dQ = dS·K, dK = dSᵀ·Q, dK / dV
//   summed over the G query heads of each KV head.
// Layout:   the model's (B, L, H, D) through strides (last dim contiguous);
//   bases, head dims and strides in whole 16-byte chunks (the wrapper sends
//   every other layout to flash_attention_wide.cu).
//
// Bound: operations (at prefill lengths ~4·L²·H·D/2 flops against ~4·L·H·D
// elements moved, far above the card's ops-per-byte line), so the products
// run on the tensor cores (wgmma, hopper.cuh).  The design problem is the
// width: one 64-row bf16 tile at 512 columns is 64 KB, and a 64 x 512 f32
// accumulator is 256 registers a thread of one warpgroup, past the limit
// of 255.  So every kernel here keeps one 64 x 256 f32 accumulator a
// warpgroup (four m64n64 products over 64-column regions, 128 registers),
// walks the reduced head dim 64 columns at a time (a runtime loop of wgmma
// groups, so one instantiation takes every width), and streams the other
// operand in tiles of 32 rows (wgmma N = 32).  Columns a warpgroup owns past
// the real head dim read the last region again and are never stored; the
// copies zero-fill what lies past the head dim or the sequence.
//
// flash_fwd_wgmma_split_kernel: one block of three warpgroups owns 64
//   query rows of one head.  Warpgroup 0 forms S = Q·Kᵀ over the whole Dh
//   from the resident Q tile (64 x Dh, 72 KB at 576) and K tiles of 32 keys
//   in its own 2-stage cp.async ring, runs the online softmax, and hands P
//   (bf16, in the A-operand layout) and each row's correction to
//   warpgroups 1 and 2 through a 2-buffer ring of named barriers.  Those
//   each own a 256-column half of O (Dv <= 512) in registers, rescale it
//   and run O += P·V with their V columns in their own 2-stage rings.  So
//   S(i + 1) and the softmax run while P(i)·V does, and each product the
//   bound counts runs once.  Q + 2 × (K + V) + the P ring = 220 KB at 576 /
//   512: one block an SM.  The main kernel's exp2 softmax (ex2.approx), its
//   select-only mask on edge tiles, its skipped masked tiles and its
//   heaviest-tiles-first order are kept; O is rescaled only when a row's
//   running max moved (a warp vote; multiplying by 1 changes no bit).
// flash_bwd_dkdv_wgmma_split_kernel: one block owns 64 keys of one KV head
//   and one 256-column slice: warpgroup 0 forms Sᵀ = K·Qᵀ over Dh and Pᵀ,
//   hands Pᵀ (f32) to warpgroup 1 through shared memory, and runs
//   dV[:, slice] += Pᵀ·dO[:, slice]; warpgroup 1 forms dPᵀ = V·dOᵀ over Dv,
//   then dSᵀ, and runs dK[:, slice] += dSᵀ·Q[:, slice].  K and V stay
//   resident (64 rows each); the G query heads' live query tiles of 32 rows
//   (Q, dO, their lse and D) are loaded one at a time (K + V + Q + dO = 204
//   KB at 576 / 512 leaves no room for a second stage).  dK and dV are
//   written once, with no atomics.
// flash_bwd_dq_wgmma_split_kernel: one block owns 64 query rows of one
//   head and one 512-column slice of dQ: warpgroup 0 forms S and P over Dh,
//   warpgroup 1 dP over Dv, both hand theirs over (f32), both form the same
//   dS, and warpgroup w runs dQ's 256 columns of the slice += dS·K.  Q and
//   dO stay resident; K / V tiles of 32 keys are loaded one at a time.
// Products against the bound's 5 at Dh = Dv = 512 in the backward: dK/dV 2
//   slices × (S + dP) + dV + dK = 6, dQ S + dP + dQ = 3; 9 / 5 = 1.8×.  The
//   D pass is flash_attention_bwd.cu's flash_bwd_dot_kernel.  Every sum runs
//   in a fixed order with no float atomics, so a second run gives the same
//   bits, and no tile that the mask removes is loaded.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

// flash_attention_bwd.cu: D = rowsum(dO∘O) into dvec
int flash_bwd_dot_bf16(const void* o, const void* dout, float* dvec, int B, int H, int Lq, int Dv,
                       const long long* os, const long long* dos, cudaStream_t stream);

namespace {

using namespace hop;

constexpr int NT = 256;      // threads: two warpgroups
constexpr int BR = 64;       // rows a block owns: queries (forward, dQ) or keys (dK/dV)
constexpr int BT = 32;       // rows of a streamed tile: keys (forward, dQ) or queries (dK/dV)
constexpr int WCOLS = 256;   // output columns of a warpgroup's accumulator: four 64-column pieces
constexpr int MAX_DH = 576;  // the widest head dims (shared memory, split_smem)
constexpr int MAX_DV = 512;
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, l, h;
};

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (B, H, Lq), or null
  int H, KH, Lq, Lk, Dh, Dv, causal, window, q_offset;
  float scale_log2;
  Strides qs, ks, vs, os;
};

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;   // (B, H, Lq)
  const float* dvec;  // (B, H, Lq): D
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, KH, Lq, Lk, Dh, Dv, causal, window, q_offset;
  float scale;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
};

__host__ __device__ constexpr int regions(int d) { return (d + 63) / 64; }

// shared memory of each kernel (bytes), at the head dims' 64-column regions
__host__ __device__ constexpr int smem_fwd(int nrh, int nrv) {
  return 1024 + (BR * nrh + 2 * BT * nrh + 2 * BT * nrv) * ROW_BYTES + (2 * 10 + 2) * 128 * 4;
}
__host__ __device__ constexpr int smem_dkdv(int nrh, int nrv) {
  return 1024 + (BR + BT) * (nrh + nrv) * ROW_BYTES + 2 * BT * 4 + BR * BT * 4;
}
__host__ __device__ constexpr int smem_dq(int nrh, int nrv) {
  return 1024 + (BR + BT) * (nrh + nrv) * ROW_BYTES + 2 * BR * BT * 4;
}
static_assert(smem_fwd(regions(MAX_DH), regions(MAX_DV)) <= SMEM_LIMIT, "forward over the block limit");
static_assert(smem_dkdv(regions(MAX_DH), regions(MAX_DV)) <= SMEM_LIMIT, "dK/dV over the block limit");
static_assert(smem_dq(regions(MAX_DH), regions(MAX_DV)) <= SMEM_LIMIT, "dQ over the block limit");

// Rows [r0, r0 + ROWS) x the 64-column regions [g0, g1) of a bf16 matrix
// (row stride `stride` elements) into shared memory at dst, by NTH threads
// numbered tid: region g at dst + g · ROWS · 128 bytes, 16-byte chunk c of
// row r at chunk c ^ (r % 8) (the 128-byte swizzle).  Rows >= n_rows and
// columns >= d are zero-filled.
template <int ROWS, int NTH>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* g, long long stride, int r0, int n_rows,
                                          int d, int g0, int g1, int tid) {
  static_assert((ROWS * 8) % NTH == 0, "whole chunks per thread");
  for (int reg = g0; reg < g1; ++reg) {
#pragma unroll
    for (int it = 0; it < ROWS * 8 / NTH; ++it) {
      const int i = tid + it * NTH, r = i >> 3, cc = i & 7, c = reg * 8 + cc;
      const uint32_t s = dst + reg * (ROWS * ROW_BYTES) + r * ROW_BYTES + ((cc ^ (r & 7)) << 4);
      const bool ok = r0 + r < n_rows && c * 8 < d;
      cp_async16(s, ok ? g + static_cast<long long>(r0 + r) * stride + c * 8 : g, ok);
    }
  }
}

// D (64 x 32) = A·Bᵀ over nreg 64-column regions of the reduced dim: A 64
// rows (regions BR · 128 bytes apart), B a tile of BT rows (regions BT ·
// 128 apart), both K-major.  One wgmma group a region, then wait.
__device__ __forceinline__ void product_ss(float (&d)[16], uint32_t a, uint32_t b, int nreg) {
  for (int r = 0; r < nreg; ++r) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(d, desc128(a + r * (BR * ROW_BYTES) + kk * 32, 16, 1024),
               desc128(b + r * (BT * ROW_BYTES) + kk * 32, 16, 1024), r > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait0();
  fence_regs(d);
}

// acc (64 x 256: four 64 x 64 pieces) += A·B over BT rows: A the bf16
// fragments of a 64 x 32 f32 accumulator (two k steps of 16), B a tile of BT
// rows, MN-major, its 64-column regions reg0 .. reg0 + 3 (a region past the
// tile's last, nreg - 1, reads that one again: those columns are never
// stored)
__device__ __forceinline__ void product_rs(float (&acc)[4][32], const uint32_t (&a)[2][4], uint32_t b, int reg0,
                                           int nreg) {
#pragma unroll
  for (int p = 0; p < 4; ++p) fence_regs(acc[p]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int reg = min(reg0 + p, nreg - 1);
      wgmma_rs(acc[p], a[kk], desc128(b + reg * (BT * ROW_BYTES) + kk * (16 * ROW_BYTES), BT * ROW_BYTES, 1024));
    }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int p = 0; p < 4; ++p) fence_regs(acc[p]);
}

// a 64 x 32 f32 accumulator as the A operand of two k steps, rounded to bf16
__device__ __forceinline__ void to_frags(const float (&s)[16], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// a warpgroup's 64 x 256 accumulator, row r scaled by mul[r], as bf16
// pairs into rows r0 + row0 (+ 8) and columns c0 .. c0 + 255 of a (row
// stride ld) matrix; rows >= n_rows and columns >= d are dropped
__device__ __forceinline__ void store_cols(bf16* base, long long ld, const float (&acc)[4][32], int r0, int n_rows,
                                           int c0, int d, int row0, int col0, const float (&mul)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row0 + 8 * r;
    if (row >= n_rows) continue;
    bf16* p = base + row * ld;
#pragma unroll
    for (int pc = 0; pc < 4; ++pc)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = c0 + 64 * pc + 8 * n + col0;
        if (c < d)
          *reinterpret_cast<uint32_t*>(p + c) =
              pack_bf16(acc[pc][4 * n + 2 * r] * mul[r], acc[pc][4 * n + 2 * r + 1] * mul[r]);
      }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][32]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
}

// ---------------------------------------------------------------------------
// forward: block (64 query rows, head) of three warpgroups: warpgroup 0 forms
// S and P, warpgroups 1 and 2 each own 256 columns of O
// ---------------------------------------------------------------------------

constexpr int FWD_NT = 384;
constexpr int PWORDS = 10;  // a thread's hand-over: P's 8 bf16 pairs, then its two rows' corr
// named barriers (0 is __syncthreads): P buffer b full / empty, the end,
// and each warpgroup's own (BAR_WG + warpgroup)
enum : int { BAR_FULL = 1, BAR_EMPTY = 3, BAR_FINAL = 5, BAR_WG = 6 };

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// registers a thread of warpgroup 0 / of warpgroups 1 and 2 keeps: the
// kernel starts at 168 each (65,536 over 384 threads), warpgroup 0 hands
// what it does not need to the accumulators (128 x 104 + 256 x 200 = 128 x 168 + 256 x 168)
constexpr int FWD_REGS_S = 104, FWD_REGS_O = 200;

__global__ void __launch_bounds__(FWD_NT, 1) flash_fwd_wgmma_split_kernel(const FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const int nrh = regions(p.Dh), nrv = regions(p.Dv);
  const uint32_t s0 = smem_addr(smem_raw);
  const uint32_t sQ = (s0 + 1023u) & ~1023u;           // BR x Dh
  const uint32_t sK = sQ + nrh * (BR * ROW_BYTES);      // 2 stages x BT x Dh
  const uint32_t sV = sK + 2 * nrh * (BT * ROW_BYTES);  // 2 stages x BT x Dv
  const uint32_t sP = sV + 2 * nrv * (BT * ROW_BYTES);  // 2 buffers x PWORDS x 128 words, then 1 / l
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(smem_raw + (sP - s0));
  float* inv_buf = reinterpret_cast<float*>(pbuf + 2 * PWORDS * 128);

  // heaviest causal query tiles first: blockIdx.y counts down the sequence
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BR, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31;

  // key tiles the block loads: [t_lo, t_lo + n_t)
  const int qpos_lo = p.q_offset + q0;
  const int qpos_hi = p.q_offset + min(q0 + BR, p.Lq) - 1;
  const int k_hi = p.causal ? min(p.Lk, qpos_hi + 1) : p.Lk;
  const int k_lo = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;
  const int t_lo = k_lo / BT, n_t = max(0, (k_hi + BT - 1) / BT - t_lo);

  // this thread's two rows of the accumulator layout: r and r + 8
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FWD_REGS_S));
    // S = Q·Kᵀ over Dh, the online softmax, and P (bf16) with each row's
    // correction handed to warpgroups 1 and 2 through a 2-buffer ring.  Q
    // stays resident; K arrives in a 2-stage ring, tile i + 2 issued once
    // S(i) is done with its stage.
    const bf16* kb = p.k + b * p.ks.b + kh * p.ks.h;
    const int qpos0 = qpos_lo + row0, qpos1 = qpos0 + 8;
    if (n_t > 0) {
      load_rows<BR, 128>(sQ, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, q0, p.Lq, p.Dh, 0, nrh, t);
      load_rows<BT, 128>(sK, kb, p.ks.l, t_lo * BT, p.Lk, p.Dh, 0, nrh, t);
    }
    cp_async_commit();
    if (n_t > 1) load_rows<BT, 128>(sK + nrh * (BT * ROW_BYTES), kb, p.ks.l, (t_lo + 1) * BT, p.Lk, p.Dh, 0, nrh, t);
    cp_async_commit();
    float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
    for (int i = 0; i < n_t; ++i) {
      const int st = i & 1, k0 = (t_lo + i) * BT;
      cp_async_wait<1>();  // K(i) has landed (K(i + 1) may not)
      fence_async_shared();
      bar_sync(BAR_WG, 128);
      float s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      product_ss(s, sQ, sK + st * nrh * (BT * ROW_BYTES), nrh);

      // s[4n + 2r + e]: row row0 + 8r, key k0 + 8n + col0 + e.  m is the
      // running max of the unscaled scores: p = 2^((s - m)·scale_log2), so a
      // row that has seen only masked keys gets exactly 2^0, as on the TPU.
      const bool edge = k0 + BT > p.Lk || (p.causal && k0 + BT - 1 > qpos_lo) ||
                        (p.window > 0 && k0 <= qpos_hi - p.window);
      if (edge) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int kpos = k0 + 8 * (e >> 2) + col0 + (e & 1);
          const int qpos = (e & 2) ? qpos1 : qpos0;
          bool ok = kpos < p.Lk;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          s[e] = ok ? s[e] : rt::NEG_INF;
        }
      }
      float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
      for (int e = 0; e < 16; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = fast_exp2((m[r] - m_new) * p.scale_log2);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = fast_exp2((s[e] - m[r]) * p.scale_log2);
        l[r] += s[e];
      }
      uint32_t a[2][4];
      to_frags(s, a);
      // hand P(i) over: buffer st is free once warpgroups 1 and 2 have read P(i - 2)
      if (i >= 2) bar_sync(BAR_EMPTY + st, FWD_NT);
      uint32_t* pb = pbuf + st * (PWORDS * 128);
#pragma unroll
      for (int w = 0; w < 8; ++w) pb[w * 128 + t] = a[w >> 2][w & 3];
      pb[8 * 128 + t] = __float_as_uint(corr[0]);
      pb[9 * 128 + t] = __float_as_uint(corr[1]);
      __threadfence_block();
      bar_arrive(BAR_FULL + st, FWD_NT);
      // every warp's part of S(i) is done with K's stage st: K(i + 2) goes there
      bar_sync(BAR_WG, 128);
      if (i + 2 < n_t)
        load_rows<BT, 128>(sK + st * nrh * (BT * ROW_BYTES), kb, p.ks.l, k0 + 2 * BT, p.Lk, p.Dh, 0, nrh, t);
      cp_async_commit();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = q0 + row0 + 8 * r;
      // m is the running max of the unscaled scores: the natural-log lse of
      // the scaled ones is m·scale + log(l), with scale = scale_log2·ln 2
      if (p.lse != nullptr && (lane & 3) == 0 && row < p.Lq)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row] =
            m[r] * p.scale_log2 * 0.6931471805599453f + logf(fmaxf(l[r], 1e-30f));
      inv_buf[r * 128 + t] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __threadfence_block();
    bar_arrive(BAR_FINAL, FWD_NT);
    // the last two P buffers' reads, so every barrier ends as it began
    for (int i = max(0, n_t - 2); i < n_t; ++i) bar_sync(BAR_EMPTY + (i & 1), FWD_NT);
    return;
  }

  // warpgroups 1 and 2: O[:, c0 .. c0 + 255] += P·V with V's columns in
  // their own 2-stage ring (regions [g0, g1)), tile i + 2 issued once P(i)·V
  // is done with its stage
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FWD_REGS_O));
  const int c0 = (wg - 1) * WCOLS, g0 = c0 / 64, g1 = min(g0 + 4, nrv);
  const bool has_cols = c0 < p.Dv;  // uniform per warpgroup
  const bf16* vb = p.v + b * p.vs.b + kh * p.vs.h;
  if (has_cols && n_t > 0) load_rows<BT, 128>(sV, vb, p.vs.l, t_lo * BT, p.Lk, p.Dv, g0, g1, t);
  cp_async_commit();
  if (has_cols && n_t > 1)
    load_rows<BT, 128>(sV + nrv * (BT * ROW_BYTES), vb, p.vs.l, (t_lo + 1) * BT, p.Lk, p.Dv, g0, g1, t);
  cp_async_commit();
  float acc[4][32];
  zero(acc);
  for (int i = 0; i < n_t; ++i) {
    const int st = i & 1;
    bar_sync(BAR_FULL + st, FWD_NT);
    const uint32_t* pb = pbuf + st * (PWORDS * 128);
    const float corr[2] = {__uint_as_float(pb[8 * 128 + t]), __uint_as_float(pb[9 * 128 + t])};
    // rescale O only where some row of the warp saw its max move
    // (multiplying by 1 changes no bit)
    if (has_cols && __any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int pc = 0; pc < 4; ++pc)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[pc][e] *= corr[(e >> 1) & 1];
    }
    uint32_t a[2][4];
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w >> 2][w & 3] = pb[w * 128 + t];
    bar_arrive(BAR_EMPTY + st, FWD_NT);
    if (!has_cols) continue;
    cp_async_wait<1>();  // V(i) has landed
    fence_async_shared();
    bar_sync(BAR_WG + wg, 128);
    // P (bf16) the register A operand, 16 keys a k step; V MN-major
    product_rs(acc, a, sV + st * nrv * (BT * ROW_BYTES), g0, nrv);
    bar_sync(BAR_WG + wg, 128);  // every warp's part is done with V's stage st
    if (i + 2 < n_t)
      load_rows<BT, 128>(sV + st * nrv * (BT * ROW_BYTES), vb, p.vs.l, (t_lo + i + 2) * BT, p.Lk, p.Dv, g0, g1, t);
    cp_async_commit();
  }
  cp_async_wait<0>();
  bar_sync(BAR_FINAL, FWD_NT);
  if (!has_cols) return;
  const float inv[2] = {inv_buf[t], inv_buf[128 + t]};
  store_cols(p.o + b * p.os.b + h * p.os.h, p.os.l, acc, q0, p.Lq, c0, p.Dv, row0, col0, inv);
}

// ---------------------------------------------------------------------------
// dK / dV: block (64 keys, KV head, 256-column slice); warpgroup 0 dV's
// slice, warpgroup 1 dK's
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_wgmma_split_kernel(const BwdParams p, int n_sl) {
  extern __shared__ uint8_t smem_raw[];
  const int nrh = regions(p.Dh), nrv = regions(p.Dv);
  const uint32_t s0 = smem_addr(smem_raw);
  const uint32_t sK = (s0 + 1023u) & ~1023u;       // BR x Dh
  const uint32_t sV = sK + nrh * (BR * ROW_BYTES);  // BR x Dv
  const uint32_t sQ = sV + nrv * (BR * ROW_BYTES);  // BT x Dh
  const uint32_t sO = sQ + nrh * (BT * ROW_BYTES);  // BT x Dv (dO)
  const uint32_t sL = sO + nrv * (BT * ROW_BYTES);  // lse, D: BT f32 each
  const uint32_t sP = sL + 2 * BT * 4;              // Pᵀ: 16 f32 a thread of warpgroup 0
  const float* lsd = reinterpret_cast<const float*>(smem_raw + (sL - s0));
  float* pt = reinterpret_cast<float*>(smem_raw + (sP - s0));

  // key tile 0 first: under the causal mask it sees the most queries
  const int kh = blockIdx.x / n_sl, sl = blockIdx.x - kh * n_sl, k0 = blockIdx.y * BR, b = blockIdx.z;
  const int G = p.H / p.KH, tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int c0 = sl * WCOLS;
  const bool has_cols = c0 < (wg == 0 ? p.Dv : p.Dh);  // uniform per warpgroup

  // query rows that see some key of [k0, k0 + BR): [i_lo, i_hi), in query
  // tiles [t_lo, t_lo + n_qt) of each of the G heads
  const int i_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int i_hi = p.window > 0 ? min(p.Lq, k0 + BR - 1 + p.window - p.q_offset) : p.Lq;
  const int t_lo = i_lo / BT;
  const int n_qt = i_hi > i_lo ? (i_hi + BT - 1) / BT - t_lo : 0;
  const int n_it = G * n_qt;

  // this thread's two rows of the accumulator layout (keys) and its columns (queries)
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int kpos0 = k0 + row0;

  if (n_it > 0) {
    load_rows<BR, NT>(sK, p.k + b * p.ks.b + kh * p.ks.h, p.ks.l, k0, p.Lk, p.Dh, 0, nrh, tid);
    load_rows<BR, NT>(sV, p.v + b * p.vs.b + kh * p.vs.h, p.vs.l, k0, p.Lk, p.Dv, 0, nrv, tid);
  }

  float acc[4][32];  // warpgroup 0: dV[:, c0 ...], warpgroup 1: dK[:, c0 ...]
  zero(acc);
  const float scale_log2 = p.scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // query tile `it` of the loop: Q, dO and their lse and D (rows past Lq as 0)
    const int h = kh * G + it / n_qt, q0 = (t_lo + it % n_qt) * BT;
    load_rows<BT, NT>(sQ, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, q0, p.Lq, p.Dh, 0, nrh, tid);
    load_rows<BT, NT>(sO, p.dout + b * p.dos.b + h * p.dos.h, p.dos.l, q0, p.Lq, p.Dv, 0, nrv, tid);
    if (tid < 2 * BT) {  // threads 0-31 lse, 32-63 D
      const int r = tid & (BT - 1);
      const float* src = (tid < BT ? p.lse : p.dvec) + (static_cast<long long>(b) * p.H + h) * p.Lq + q0 + r;
      cp_async4(sL + tid * 4, q0 + r < p.Lq ? src : p.lse, q0 + r < p.Lq);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    // warpgroup 0: Sᵀ = K·Qᵀ over Dh; warpgroup 1: dPᵀ = V·dOᵀ over Dv
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    product_ss(s, wg == 0 ? sK : sV, wg == 0 ? sQ : sO, wg == 0 ? nrh : nrv);
    if (wg == 0) {
      // s[4n + 2r + e]: key kpos0 + 8r, query q0 + 8n + col0 + e.  Masked
      // pairs and rows past Lq / Lk get the score −1e30 (P = 0).
      const int qpos_lo = p.q_offset + q0;
      const bool edge = q0 + BT > p.Lq || k0 + BR > p.Lk || (p.causal && qpos_lo < k0 + BR - 1) ||
                        (p.window > 0 && qpos_lo + BT - 1 - k0 >= p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int qi = q0 + 8 * (i >> 2) + col0 + (i & 1), kpos = kpos0 + 8 * ((i >> 1) & 1);
          bool ok = qi < p.Lq && kpos < p.Lk;
          if (p.causal) ok = ok && p.q_offset + qi >= kpos;
          if (p.window > 0) ok = ok && p.q_offset + qi - kpos < p.window;
          s[i] = ok ? s[i] : rt::NEG_INF;
        }
      }
      // Pᵀ = exp(Sᵀ·scale − lse), lse by column
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lsd + 8 * n + col0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[4 * n + j] = fast_exp2(fmaf(s[4 * n + j], scale_log2, -((j & 1) ? l2.y : l2.x) * LOG2E));
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) pt[i * 128 + t] = s[i];
    }
    __syncthreads();  // Pᵀ handed over
    if (wg == 1) {
      // dSᵀ = Pᵀ∘(dPᵀ − D)·scale, D by column, Pᵀ from warpgroup 0's thread t
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(lsd + BT + 8 * n + col0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[4 * n + j] = pt[(4 * n + j) * 128 + t] * (s[4 * n + j] - ((j & 1) ? d2.y : d2.x)) * p.scale;
      }
    }
    // warpgroup 0: dV += Pᵀ·dO; warpgroup 1: dK += dSᵀ·Q.  The A operand
    // (bf16) from registers, 16 queries a k step; dO / Q MN-major, this
    // slice's four regions
    if (has_cols) {
      uint32_t a[2][4];
      to_frags(s, a);
      product_rs(acc, a, wg == 0 ? sO : sQ, c0 / 64, wg == 0 ? nrv : nrh);
    }
    __syncthreads();  // the tile and Pᵀ are released
  }
  cp_async_wait<0>();

  if (!has_cols) return;
  const float one[2] = {1.f, 1.f};
  if (wg == 0)
    store_cols(p.dv + b * p.dvs.b + kh * p.dvs.h, p.dvs.l, acc, k0, p.Lk, c0, p.Dv, row0, col0, one);
  else
    store_cols(p.dk + b * p.dks.b + kh * p.dks.h, p.dks.l, acc, k0, p.Lk, c0, p.Dh, row0, col0, one);
}

// ---------------------------------------------------------------------------
// dQ: block (64 query rows, head, 512-column slice); warpgroup w the
// slice's columns [256w, 256w + 256)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_wgmma_split_kernel(const BwdParams p, int n_sl) {
  extern __shared__ uint8_t smem_raw[];
  const int nrh = regions(p.Dh), nrv = regions(p.Dv);
  const uint32_t s0 = smem_addr(smem_raw);
  const uint32_t sQ = (s0 + 1023u) & ~1023u;       // BR x Dh
  const uint32_t sO = sQ + nrh * (BR * ROW_BYTES);  // BR x Dv (dO)
  const uint32_t sK = sO + nrv * (BR * ROW_BYTES);  // BT x Dh
  const uint32_t sV = sK + nrh * (BT * ROW_BYTES);  // BT x Dv
  const uint32_t sX = sV + nrv * (BT * ROW_BYTES);  // P, then dP: 16 f32 a thread each
  float* xs = reinterpret_cast<float*>(smem_raw + (sX - s0));

  // heaviest causal query tiles first: blockIdx.y counts down the sequence
  const int h = blockIdx.x / n_sl, sl = blockIdx.x - h * n_sl;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31;
  const int c0 = sl * 2 * WCOLS + wg * WCOLS;
  const bool has_cols = c0 < p.Dh;  // uniform per warpgroup
  const bf16* kb = p.k + b * p.ks.b + kh * p.ks.h;
  const bf16* vb = p.v + b * p.vs.b + kh * p.vs.h;

  // key tiles the block loads, the forward's: [t_lo, t_hi)
  const int qpos_lo = p.q_offset + q0;
  const int qpos_hi = p.q_offset + min(q0 + BR, p.Lq) - 1;
  const int k_hi = p.causal ? min(p.Lk, qpos_hi + 1) : p.Lk;
  const int k_lo = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;
  const int t_lo = k_lo / BT, t_hi = (k_hi + BT - 1) / BT;

  // this thread's two rows of the accumulator layout, r and r + 8: their
  // lse (in log2 units) and D
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int qpos0 = qpos_lo + row0, qpos1 = qpos0 + 8;
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    const long long i = (static_cast<long long>(b) * p.H + h) * p.Lq + row;
    lse2[r] = row < p.Lq ? p.lse[i] * LOG2E : 0.f;
    dr[r] = row < p.Lq ? p.dvec[i] : 0.f;
  }

  if (t_lo < t_hi) {
    load_rows<BR, NT>(sQ, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, q0, p.Lq, p.Dh, 0, nrh, tid);
    load_rows<BR, NT>(sO, p.dout + b * p.dos.b + h * p.dos.h, p.dos.l, q0, p.Lq, p.Dv, 0, nrv, tid);
  }

  float acc[4][32];  // dQ[:, c0 ...]
  zero(acc);
  const float scale_log2 = p.scale * LOG2E;

  for (int j = t_lo; j < t_hi; ++j) {
    const int k0 = j * BT;
    load_rows<BT, NT>(sK, kb, p.ks.l, k0, p.Lk, p.Dh, 0, nrh, tid);
    load_rows<BT, NT>(sV, vb, p.vs.l, k0, p.Lk, p.Dv, 0, nrv, tid);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    // warpgroup 0: S = Q·Kᵀ over Dh; warpgroup 1: dP = dO·Vᵀ over Dv
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0.f;
    product_ss(x, wg == 0 ? sQ : sO, wg == 0 ? sK : sV, wg == 0 ? nrh : nrv);
    if (wg == 0) {
      // x[4n + 2r + e]: row row0 + 8r, key k0 + 8n + col0 + e
      const bool edge = k0 + BT > p.Lk || (p.causal && k0 + BT - 1 > qpos_lo) ||
                        (p.window > 0 && k0 <= qpos_hi - p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          bool ok = kpos < p.Lk;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          x[i] = ok ? x[i] : rt::NEG_INF;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = fast_exp2(fmaf(x[i], scale_log2, -lse2[(i >> 1) & 1]));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) xs[(wg * 16 + i) * 128 + t] = x[i];
    __syncthreads();  // P and dP handed over
    if (has_cols) {
      // dS = P∘(dP − D)·scale, the same bits in both warpgroups; then
      // dQ[:, c0 ...] += dS·K: dS (bf16) the register A operand, 16 keys a
      // k step; K MN-major, this warpgroup's four regions
      float ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float y = xs[((wg ^ 1) * 16 + i) * 128 + t];
        const float pr = wg == 0 ? x[i] : y, dp = wg == 0 ? y : x[i];
        ds[i] = pr * (dp - dr[(i >> 1) & 1]) * p.scale;
      }
      uint32_t a[2][4];
      to_frags(ds, a);
      product_rs(acc, a, sK, c0 / 64, nrh);
    }
    __syncthreads();  // the tile and the hand-over buffer are released
  }
  cp_async_wait<0>();

  if (!has_cols) return;
  const float one[2] = {1.f, 1.f};
  store_cols(p.dq + b * p.dqs.b + h * p.dqs.h, p.dqs.l, acc, q0, p.Lq, c0, p.Dh, row0, col0, one);
}

// The copies take 16-byte chunks: head dims, strides and bases in whole chunks.
bool aligned16(const void* ptr, const long long* strides, int d) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || d % 8 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

bool takes(int dtype, int Dh, int Dv, int H, int KH) {
  return dtype == rt::BF16 && Dh >= 1 && Dv >= 1 && Dh <= MAX_DH && Dv <= MAX_DV && KH > 0 && H % KH == 0;
}

Strides st(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <typename Kernel, typename Params>
int launch(Kernel kernel, const Params& p, dim3 grid, int smem, cudaStream_t stream, int n_sl) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NT, smem, stream>>>(p, n_sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory (bytes) the launcher asks for: kernel 0 the forward, 1
// dK/dV, 2 dQ; -1 for widths the route does not take.
extern "C" int flash_attention_split_smem(int kernel, int Dh, int Dv) {
  if (!takes(rt::BF16, Dh, Dv, 1, 1)) return -1;
  const int nrh = regions(Dh), nrv = regions(Dv);
  return kernel == 0 ? smem_fwd(nrh, nrv) : kernel == 1 ? smem_dkdv(nrh, nrv) : kernel == 2 ? smem_dq(nrh, nrv) : -1;
}

// flash_attention_fwd's arguments (flash_attention.cu): strides (batch,
// sequence, head) in elements, window <= 0 for none, lse a (B, H, Lq) f32
// buffer or null.  bf16 only, Dh <= 576, Dv <= 512, in whole 16-byte chunks.
extern "C" int flash_attention_split_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                                         int H, int KH, int Lq, int Lk, int Dh, int Dv, const long long* q_strides,
                                         const long long* k_strides, const long long* v_strides,
                                         const long long* o_strides, int causal, int window, int q_offset,
                                         float scale, int dtype, void* stream) {
  if (!takes(dtype, Dh, Dv, H, KH)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q, q_strides, Dh) || !aligned16(k, k_strides, Dh) || !aligned16(v, v_strides, Dv) ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || o_strides[0] % 2 || o_strides[1] % 2 || o_strides[2] % 2)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const FwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<bf16*>(o), static_cast<float*>(lse), H, KH, Lq, Lk, Dh, Dv, causal, window, q_offset,
                    scale * LOG2E, st(q_strides), st(k_strides), st(v_strides), st(o_strides)};
  const int smem = smem_fwd(regions(Dh), regions(Dv));
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wgmma_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_wgmma_split_kernel<<<dim3(H, (Lq + BR - 1) / BR, B), FWD_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

// flash_attention_bwd's arguments (flash_attention_bwd.cu).  Three
// launches: D, dK/dV, dQ (dvec is (B, H, Lq) f32 scratch).
extern "C" int flash_attention_split_bwd(const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, const void* lse, void* dvec, void* dq, void* dk, void* dv,
                                         int B, int H, int KH, int Lq, int Lk, int Dh, int Dv,
                                         const long long* q_strides, const long long* k_strides,
                                         const long long* v_strides, const long long* o_strides,
                                         const long long* do_strides, const long long* dq_strides,
                                         const long long* dk_strides, const long long* dv_strides, int causal,
                                         int window, int q_offset, float scale, int dtype, void* stream) {
  if (!takes(dtype, Dh, Dv, H, KH) || B < 1 || Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q, q_strides, Dh) || !aligned16(k, k_strides, Dh) || !aligned16(v, v_strides, Dv) ||
      !aligned16(dout, do_strides, Dv) || !aligned16(dq, dq_strides, Dh) || !aligned16(dk, dk_strides, Dh) ||
      !aligned16(dv, dv_strides, Dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = flash_bwd_dot_bf16(o, dout, static_cast<float*>(dvec), B, H, Lq, Dv, o_strides, do_strides, s);
  if (rc != 0) return rc;
  const BwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(dvec),
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KH, Lq, Lk, Dh, Dv,
                    causal, window, q_offset, scale, st(q_strides), st(k_strides), st(v_strides),
                    st(do_strides), st(dq_strides), st(dk_strides), st(dv_strides)};
  const int nrh = regions(Dh), nrv = regions(Dv);
  const int n_kv = ((Dh > Dv ? Dh : Dv) + WCOLS - 1) / WCOLS, n_q = (Dh + 2 * WCOLS - 1) / (2 * WCOLS);
  rc = launch(flash_bwd_dkdv_wgmma_split_kernel, p, dim3(KH * n_kv, (Lk + BR - 1) / BR, B), smem_dkdv(nrh, nrv), s,
              n_kv);
  if (rc != 0) return rc;
  return launch(flash_bwd_dq_wgmma_split_kernel, p, dim3(H * n_q, (Lq + BR - 1) / BR, B), smem_dq(nrh, nrv), s, n_q);
}
