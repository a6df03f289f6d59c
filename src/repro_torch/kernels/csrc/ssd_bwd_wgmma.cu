// Backward of the Mamba-2 SSD intra-chunk step on the tensor cores (bf16).
//
// Replaces: no Pallas kernel: repro trains mamba2 through jax.grad of the
//           jnp ssd_chunked (src/repro/models/ssm.py:74).  This is the bf16
//           route; float32, and bf16 outside this kernel's envelope, run
//           the SIMT kernels of ssd_wide.cu.
// Computes: per (batch, chunk, group), with s = C_i.B_j, L_ij = exp(cum_i -
//           cum_j) (i >= j), dW = dy_i.x_j, G = dW L dt_j, W = s L dt_j,
//           M = G s, e_j = exp(cum_last - cum_j) and the state terms
//           U = x_j dS^T, V = B_j dS:
//             dx_j  = sum_i W_ij dy_i + e_j dt_j V_j
//             dB_j  = sum_h (sum_i G_ij C_i + e_j dt_j U_j)
//             dC_i  = sum_h sum_j G_ij B_j
//             ddt_j = sum_i dW_ij s_ij L_ij + e_j B_j.U_j
//             dcum  = rowsum(M) - colsum(M) - e_j dt_j B_j.U_j (+ its sum on
//                     the last row)
//           dB and dC sum the group's heads in head order inside the block,
//           in f32 registers: no per-head scratch, no atomics, the same bits
//           on every run.
//
// Bound: ~32 GFLOP of products against ~160 MB at mamba2-130m's train shape
// (x (4, 2048, 24, 64), one group of B / C, cs 256): at 989 TFLOP/s and
// 3.35 TB/s the bytes bound it.  The products run on wgmma (m64nNk16, f32
// accumulators) with every f32 operand rounded once to bf16 (dy and dS by
// the conversion pass, W and G in registers); s, dW, the decay and every
// sum that ddt and dcum take stay f32.
//
// ssd_bwd_cvt_kernel: dy (the permuted f32 view autograd hands the
//   backward) and dS to contiguous bf16 copies that cp.async can copy.
// ssd_bwd_wgmma_kernel, two warpgroups a block (255 registers, 215 KB of
//   shared memory: one block an SM), grid (batch * groups * chunks,
//   2 * tiles); blockIdx.y picks the role and the 64-row tile, the heaviest
//   first (column tiles 0, 1, ..., then row tiles from the last down).  A
//   block walks its group's heads in order; the warpgroups share each head:
//   column role, j tile jt (B_j and C_i, i >= jt, in shared memory once):
//     warpgroup w takes the i tiles jt + w, jt + w + 2, ...: S^T = B_j.C_i^T
//     and dW^T = x_j.dy_i^T (SS, both K-major), then on the accumulator
//     layout W^T, G^T, M^T (interior tiles skip the mask selects), the row
//     sums ddt and colsum(M), and the column sums of M^T over each warp's 16
//     rows (rowsum(M)'s part from this j tile and warp, to scratch, by a
//     reduce-scatter over the warp's lanes: no block barrier); dx +=
//     W^T.dy_i (RS, dy MN-major) and dB += G^T.C_i (RS, C MN-major).  Then
//     warpgroup 0 takes U = x_j.dS^T (SS; dB, ddt, -colsum(M) - q and each
//     warp's sum of q) and warpgroup 1 V = B_j.dS (SS, dS MN-major; dx),
//     each after the other's partials come through shared memory.  dB_j is
//     written once after the last head.
//   row role, i tile it (B_j, j <= it, in shared memory once): warpgroup w
//     takes the j tiles w, w + 2, ...: dW = dy_i.x_j^T (SS), G, dC += G.B_j
//     (RS, B MN-major); dC_i written once after the last head.
//   Every sum of the two warpgroups' partials adds warpgroup 0's first.  A
//   head's x, dy, dS, dt and cum come by 16- and 4-byte cp.async into a
//   two-stage ring (the next head's copies run under this head's
//   products).  Masked entries (i < j, rows past cs) are selected to 0
//   before any product, never multiplied by a 0/1 mask: the decay there may
//   be inf.
// ssd_bwd_tc_dcum_kernel adds rowsum(M) (its parts in (j tile, warp) order)
//   and the chunk's sum of e dt B.U (its parts in the same order) to dcum.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hop;

constexpr int TR = 64;        // rows of a tile (i and j)
constexpr int NT = 128;       // a warpgroup
constexpr int NTB = 2 * NT;   // a block: two warpgroups
constexpr int CS_MAX = 256;   // chunk rows
constexpr int TILES = CS_MAX / TR;
constexpr int NPAD = 128;     // state dim, padded
constexpr int PPAD = 64;      // head dim, padded
constexpr int N_TILE = TR * NPAD * 2;   // 64 rows of B or C: 16 KB
constexpr int P_TILE = TR * PPAD * 2;   // 64 rows of x or dy: 8 KB
constexpr int DS_BYTES = NPAD * PPAD * 2;  // dS: 16 KB
constexpr int VEC_BYTES = 2 * CS_MAX * 4;  // cum and dt of a head
// column role: B_j, the C tiles, then two stages of (x_j, dy tiles, dS, cum, dt)
constexpr int COL_STAGE = P_TILE + TILES * P_TILE + DS_BYTES + VEC_BYTES;
constexpr int COL_FIXED = N_TILE + TILES * N_TILE;
// row role: the B tiles, then two stages of (dy_i, x tiles, cum, dt)
constexpr int ROW_STAGE = P_TILE + TILES * P_TILE + VEC_BYTES;
constexpr int ROW_FIXED = TILES * N_TILE;
// the warpgroups' partial sums: dx (32 a thread) and ddt, colsum (4 a thread)
// each head; dB or dC (64 a thread) at the end, over a stage
constexpr int XCHG = NT * (32 + 4) * 4;
constexpr int SMEM = 1024 + XCHG +
                     (COL_FIXED + 2 * COL_STAGE > ROW_FIXED + 2 * ROW_STAGE ? COL_FIXED + 2 * COL_STAGE
                                                                          : ROW_FIXED + 2 * ROW_STAGE);
static_assert(COL_STAGE % 1024 == 0 && ROW_STAGE % 1024 == 0, "stages keep the swizzle atoms aligned");
static_assert(NT * 64 * 4 <= ROW_STAGE, "a stage holds a warpgroup's 64 x 128 f32 partial");
static_assert(NTB == CS_MAX, "one row of cum and dt per thread");
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* x;
  const float* dt;
  const float* cum;
  const bf16* bm;
  const bf16* cm;
  const bf16* dy;   // (batch, heads, chunks, cs, P) contiguous, from the conversion pass
  const bf16* ds;   // (batch, heads, chunks, N, P) contiguous
  bf16* dx;
  float* ddt;
  float* dcum;
  bf16* db;
  bf16* dc;
  float* rowpart;   // (batch, heads, chunks, tiles, 4, cs): rowsum(M)'s part from each j tile's warps
  float* qsum;      // (batch, heads, chunks, tiles, 4): the sum of e dt B.U over each j tile's warps' rows
  int heads, heads_per_group, n_chunks, cs, P, N, tiles;
  long long xs[4], dts[4], cums[4], bs[4], cms[4], dxs[4], ddts[4], dcums[4], dbs[4], dcs[4];
};

// cum and dt of a head's chunk (rows past cs as 0) into dst: cum, then dt;
// one row a thread of the block
__device__ __forceinline__ void load_vecs(uint32_t dst, const float* cum, long long cs_stride,
                                          const float* dt, long long dt_stride, int cs, int tid) {
  const int r = tid;
  cp_async4(dst + r * 4, r < cs ? cum + r * cs_stride : cum, r < cs);
  cp_async4(dst + (CS_MAX + r) * 4, r < cs ? dt + r * dt_stride : dt, r < cs);
}

// a warpgroup's 64 x 128 f32 accumulator through shared memory, value q of
// thread t at q * NT + t (no bank conflicts)
__device__ __forceinline__ void put64(float* x, const float (&v)[64], int t) {
#pragma unroll
  for (int q = 0; q < 64; ++q) x[q * NT + t] = v[q];
}

// A 64 x 64 f32 accumulator tile as the register A operand of four k steps
// of 16 columns, each value rounded once to bf16
__device__ __forceinline__ void round_frags(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
}

// K-major descriptor of k step kk of a tile of `rows` rows whose K runs over
// 64-column regions `rows` * 128 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  return desc128(tile + (kk >> 2) * (rows * ROW_BYTES) + (kk & 3) * 32, 16, 1024);
}
// MN-major descriptor of k step kk (rows 16 kk .. 16 kk + 15) of a tile of
// `rows` rows whose N runs over 64-column regions
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return desc128(tile + kk * (16 * ROW_BYTES), rows * ROW_BYTES, 1024);
}

// sum over the four lanes of a quad (one row of the accumulator layout)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The column role's elementwise step on one (j tile, i tile) pair, on the
// accumulator layout: s[4n + 2r + e] and dw[...] hold S^T and dW^T at row
// j = j0 + row0 + 8r, column i = i0 + 8n + col0 + e; they leave holding
// W^T and G^T.  ddt and colsum(M) add to this thread's two rows, rp gets the
// two rows' part of each column of M^T.  With MASK, pairs with i < j or a
// row past cs are selected to 0 (their decay may be inf); interior tiles
// have none.
template <bool MASK>
__device__ __forceinline__ void column_tile(float (&s)[32], float (&dw)[32], float (&rp)[16], float (&ddt_acc)[2],
                                            float (&col_acc)[2], const float (&cj)[2], const float (&dtj)[2],
                                            const float* cum_s, int i0, int j0, int row0, int col0, int cs,
                                            bool diag) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + 8 * n + col0 + e;
      const float ci = cum_s[i];
      float msum = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + row0 + 8 * r, q = 4 * n + 2 * r + e;
        const bool ok = !MASK || (i < cs && j < cs && (!diag || i >= j));
        const float L = fast_exp2((ok ? ci - cj[r] : 0.f) * LOG2E);
        const float sl = s[q] * L, ldt = L * dtj[r];
        const float gv = ok ? dw[q] * ldt : 0.f;
        const float m = gv * s[q];
        ddt_acc[r] += ok ? dw[q] * sl : 0.f;
        col_acc[r] += m;
        msum += m;
        s[q] = ok ? s[q] * ldt : 0.f;
        dw[q] = gv;
      }
      rp[2 * n + e] = msum;
    }
}

// Sums v over the 8 row groups of a warp (lanes g * 4 + t, g = 0..7) as a
// reduce-scatter: 14 shuffles, and lane (g, t) is left with the sums of
// v[2g] and v[2g + 1] (columns 8g + 2t and 8g + 2t + 1 of the tile)
__device__ __forceinline__ float2 group_sum_scatter(const float (&v)[16], int lane) {
  float a[8], b2[4];
  const bool hi4 = lane & 16, hi2 = lane & 8, hi1 = lane & 4;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float send = hi4 ? v[k] : v[k + 8], keep = hi4 ? v[k + 8] : v[k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = hi2 ? a[k] : a[k + 4], keep = hi2 ? a[k + 4] : a[k];
    b2[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float out[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = hi1 ? b2[k] : b2[k + 2], keep = hi1 ? b2[k + 2] : b2[k];
    out[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  return make_float2(out[0], out[1]);
}

// ---------------------------------------------------------------------------
// column role: dx_j, dB_j, ddt_j, -colsum(M)_j - q_j, rowsum(M)'s parts
// ---------------------------------------------------------------------------
// Two warpgroups share each head: warpgroup w takes the i tiles jt + w,
// jt + w + 2, ..., with its own dx, ddt, colsum and dB partials; then
// warpgroup 0 forms U = x_j.dS^T (dB, ddt, dcum, q) with warpgroup 1's ddt
// and colsum partials, and warpgroup 1 V = B_j.dS (dx) with warpgroup 0's
// dx partial; each sum adds warpgroup 0's partial first.  dB adds the two
// warpgroups' partials once, after the last head.
__device__ void column_role(const Params& p, uint8_t* base, uint32_t s0, float* xchg, int b, int g, int c,
                            int jt) {
  const int tid = threadIdx.x, wg = tid / NT, t = tid % NT, warp = t >> 5, lane = t & 31;
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int cs = p.cs, tiles = p.tiles, j0 = jt * TR, P = p.P, N = p.N;
  const int h0 = g * p.heads_per_group, nh = p.heads_per_group;
  const uint32_t sB = s0, sC = sB + N_TILE, sStage = sC + TILES * N_TILE;

  const bf16* bb = p.bm + b * p.bs[0] + g * p.bs[1] + c * p.bs[2];
  const bf16* cb = p.cm + b * p.cms[0] + g * p.cms[1] + c * p.cms[2];
  auto load_head = [&](int k) {  // head k's x_j, dy tiles i >= jt, dS, cum and dt
    const int h = h0 + k;
    const uint32_t sx = sStage + (k & 1) * COL_STAGE, sdy = sx + P_TILE, sds = sdy + TILES * P_TILE;
    const long long hc = (static_cast<long long>(b) * p.heads + h) * p.n_chunks + c;
    load_tile<TR, PPAD, NTB>(sx, p.x + b * p.xs[0] + h * p.xs[1] + c * p.xs[2], p.xs[3], j0, cs, P, tid);
    for (int it = jt; it < tiles; ++it)
      load_tile<TR, PPAD, NTB>(sdy + it * P_TILE, p.dy + hc * cs * P, P, it * TR, cs, P, tid);
    load_tile<NPAD, PPAD, NTB>(sds, p.ds + hc * N * P, P, 0, N, P, tid);
    load_vecs(sds + DS_BYTES, p.cum + b * p.cums[0] + h * p.cums[1] + c * p.cums[2], p.cums[3],
              p.dt + b * p.dts[0] + h * p.dts[1] + c * p.dts[2], p.dts[3], cs, tid);
  };

  load_tile<TR, NPAD, NTB>(sB, bb, p.bs[3], j0, cs, N, tid);
  for (int it = jt; it < tiles; ++it) load_tile<TR, NPAD, NTB>(sC + it * N_TILE, cb, p.cms[3], it * TR, cs, N, tid);
  load_head(0);
  cp_async_commit();

  // B_j[row][8n + col0 .. + 1] of this thread's rows (r = 0: row0, 1: row0 + 8)
  // in the 128-byte swizzle: column chunk n & 7 of region n >> 3
  auto b_pair = [&](int r, int n) {
    const int row = row0 + 8 * r;
    const uint8_t* a = base + (n >> 3) * (TR * ROW_BYTES) + row * ROW_BYTES + (((n & 7) ^ (row & 7)) << 4) + col0 * 2;
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a));
  };
  float* xdx = xchg;            // warpgroup 0's dx partial
  float* xdd = xchg + 32 * NT;  // warpgroup 1's ddt and colsum partials

  float db[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) db[q] = 0.f;

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k, st = k & 1;
    if (k + 1 < nh) load_head(k + 1);  // the other stage, released at the end of head k - 1
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group of copies has landed
    fence_async_shared();
    __syncthreads();

    const uint32_t sx = sStage + st * COL_STAGE, sdy = sx + P_TILE, sds = sdy + TILES * P_TILE;
    const float* cum_s = reinterpret_cast<const float*>(base + (sds + DS_BYTES - s0));
    const float* dt_s = cum_s + CS_MAX;
    const long long hc = (static_cast<long long>(b) * p.heads + h) * p.n_chunks + c;
    float cj[2], dtj[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cj[r] = cum_s[j0 + row0 + 8 * r];
      dtj[r] = dt_s[j0 + row0 + 8 * r];
    }
    float dx[32], ddt_acc[2] = {0.f, 0.f}, col_acc[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 32; ++q) dx[q] = 0.f;

    for (int it = jt + wg; it < tiles; it += 2) {
      const int i0 = it * TR;
      const uint32_t sci = sC + it * N_TILE, sdyi = sdy + it * P_TILE;
      // S^T = B_j.C_i^T (K = N) and dW^T = x_j.dy_i^T (K = P), one group
      float s[32], dw[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) s[q] = 0.f, dw[q] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NPAD / 16; ++kk) wgmma_ss(s, kmajor(sB, TR, kk), kmajor(sci, TR, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < PPAD / 16; ++kk) wgmma_ss(dw, kmajor(sx, TR, kk), kmajor(sdyi, TR, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dw);

      // W^T into s, G^T into dw, the row and column sums of M^T
      const bool diag = it == jt;
      float rp[16];
      if (diag || i0 + TR > cs || j0 + TR > cs)
        column_tile<true>(s, dw, rp, ddt_acc, col_acc, cj, dtj, cum_s, i0, j0, row0, col0, cs, diag);
      else
        column_tile<false>(s, dw, rp, ddt_acc, col_acc, cj, dtj, cum_s, i0, j0, row0, col0, cs, diag);
      // dx += W^T.dy_i (dy MN-major), dB += G^T.C_i (C MN-major): K = i
      uint32_t wa[4][4], ga[4][4];
      round_frags(s, wa);
      round_frags(dw, ga);
      fence_regs(dx);
      fence_regs(db);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dx, wa[kk], mnmajor(sdyi, TR, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(db, ga[kk], mnmajor(sci, TR, kk));
      wgmma_commit();
      // rowsum(M)'s part from this j tile and warp: the column sums of the
      // warp's 16 rows of M^T (under the products); the dcum pass adds the
      // parts in order
      const float2 cols = group_sum_scatter(rp, lane);
      float* rpart = p.rowpart + ((hc * tiles + jt) * 4 + warp) * cs + i0 + 2 * lane;
      if (i0 + 2 * lane < cs) rpart[0] = cols.x;
      if (i0 + 2 * lane + 1 < cs) rpart[1] = cols.y;
      wgmma_wait0();
      fence_regs(dx);
      fence_regs(db);
    }

    // the state terms, U on warpgroup 0 and V on warpgroup 1, after the
    // warpgroups swap the partials each needs
    if (wg == 0) {
#pragma unroll
      for (int q = 0; q < 32; ++q) xdx[q * NT + t] = dx[q];
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) xdd[r * NT + t] = ddt_acc[r], xdd[(2 + r) * NT + t] = col_acc[r];
    }
    __syncthreads();
    float cf[2], ee[2];
    const float cum_last = cum_s[cs - 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool live = j0 + row0 + 8 * r < cs;
      ee[r] = live ? expf(cum_last - cj[r]) : 0.f;
      cf[r] = ee[r] * dtj[r];
    }
    if (wg == 0) {  // U = x_j.dS^T (K = P): dB, ddt, dcum, q
      float u[64];
#pragma unroll
      for (int q = 0; q < 64; ++q) u[q] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PPAD / 16; ++kk) wgmma_ss(u, kmajor(sx, TR, kk), kmajor(sds, NPAD, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(u);
      fence_regs(db);
      // u[4n + 2r + e]: row j0 + row0 + 8r, state column 8n + col0 + e
      float bu[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 bv = b_pair(r, n);
          bu[r] += bv.x * u[4 * n + 2 * r] + bv.y * u[4 * n + 2 * r + 1];
          db[4 * n + 2 * r] += cf[r] * u[4 * n + 2 * r];
          db[4 * n + 2 * r + 1] += cf[r] * u[4 * n + 2 * r + 1];
        }
      float* ddtb = p.ddt + b * p.ddts[0] + h * p.ddts[1] + c * p.ddts[2];
      float* dcumb = p.dcum + b * p.dcums[0] + h * p.dcums[1] + c * p.dcums[2];
      float qw[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + row0 + 8 * r;
        const float bur = quad_sum(bu[r]);
        const float col = quad_sum(col_acc[r] + xdd[(2 + r) * NT + t]);
        const float dd = quad_sum(ddt_acc[r] + xdd[r * NT + t]);
        const float q = cf[r] * bur;
        qw[r] = j < cs ? q : 0.f;
        if ((lane & 3) == 0 && j < cs) {
          ddtb[j * p.ddts[3]] = dd + ee[r] * bur;
          dcumb[j * p.dcums[3]] = -col - q;
        }
      }
      // the sum of q over the warp's 16 rows (the dcum pass adds the warps' in order)
      float qt = qw[0] + qw[1];
      qt += __shfl_xor_sync(0xffffffffu, qt, 4);
      qt += __shfl_xor_sync(0xffffffffu, qt, 8);
      qt += __shfl_xor_sync(0xffffffffu, qt, 16);
      if (lane == 0) p.qsum[(hc * tiles + jt) * 4 + warp] = qt;
    } else {  // V = B_j.dS (K = N): dx
      float v[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) v[q] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NPAD / 16; ++kk) wgmma_ss_tb(v, kmajor(sB, TR, kk), mnmajor(sds, NPAD, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(v);
      bf16* dxb = p.dx + b * p.dxs[0] + h * p.dxs[1] + c * p.dxs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + row0 + 8 * r;
        if (j >= cs) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 8 * n + col0, q = 4 * n + 2 * r;
          if (col < P)
            *reinterpret_cast<uint32_t*>(dxb + j * p.dxs[3] + col) =
                pack_bf16((xdx[q * NT + t] + dx[q]) + cf[r] * v[q],
                          (xdx[(q + 1) * NT + t] + dx[q + 1]) + cf[r] * v[q + 1]);
        }
      }
    }
    __syncthreads();  // stage st and the exchange consumed
  }
  cp_async_wait<0>();

  // dB_j = warpgroup 0's partial + warpgroup 1's, over the first stage
  float* xdb = reinterpret_cast<float*>(base + (sStage - s0));
  if (wg == 1) put64(xdb, db, t);
  __syncthreads();
  if (wg == 1) return;
  bf16* dbb = p.db + b * p.dbs[0] + g * p.dbs[1] + c * p.dbs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + row0 + 8 * r;
    if (j >= cs) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + col0, q = 4 * n + 2 * r;
      if (col < N)
        *reinterpret_cast<uint32_t*>(dbb + j * p.dbs[3] + col) =
            pack_bf16(db[q] + xdb[q * NT + t], db[q + 1] + xdb[(q + 1) * NT + t]);
    }
  }
}

// ---------------------------------------------------------------------------
// row role: dC_i
// ---------------------------------------------------------------------------
// Warpgroup w takes the j tiles w, w + 2, ... of each head into its own dC
// partial; dC_i adds warpgroup 0's and warpgroup 1's once, after the last
// head.
__device__ void row_role(const Params& p, uint8_t* base, uint32_t s0, int b, int g, int c, int it) {
  const int tid = threadIdx.x, wg = tid / NT, t = tid % NT, warp = t >> 5, lane = t & 31;
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const int cs = p.cs, i0 = it * TR, P = p.P, N = p.N;
  const int h0 = g * p.heads_per_group, nh = p.heads_per_group;
  const uint32_t sB = s0, sStage = sB + TILES * N_TILE;

  const bf16* bb = p.bm + b * p.bs[0] + g * p.bs[1] + c * p.bs[2];
  auto load_head = [&](int k) {  // head k's dy_i, x tiles 0 .. it, cum and dt
    const int h = h0 + k;
    const uint32_t sdy = sStage + (k & 1) * ROW_STAGE, sx = sdy + P_TILE;
    const long long hc = (static_cast<long long>(b) * p.heads + h) * p.n_chunks + c;
    load_tile<TR, PPAD, NTB>(sdy, p.dy + hc * cs * P, P, i0, cs, P, tid);
    const bf16* xb = p.x + b * p.xs[0] + h * p.xs[1] + c * p.xs[2];
    for (int jt = 0; jt <= it; ++jt) load_tile<TR, PPAD, NTB>(sx + jt * P_TILE, xb, p.xs[3], jt * TR, cs, P, tid);
    load_vecs(sx + TILES * P_TILE, p.cum + b * p.cums[0] + h * p.cums[1] + c * p.cums[2], p.cums[3],
              p.dt + b * p.dts[0] + h * p.dts[1] + c * p.dts[2], p.dts[3], cs, tid);
  };

  for (int jt = 0; jt <= it; ++jt) load_tile<TR, NPAD, NTB>(sB + jt * N_TILE, bb, p.bs[3], jt * TR, cs, N, tid);
  load_head(0);
  cp_async_commit();

  float dc[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) dc[q] = 0.f;

  for (int k = 0; k < nh; ++k) {
    const int st = k & 1;
    if (k + 1 < nh) load_head(k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();

    const uint32_t sdy = sStage + st * ROW_STAGE, sx = sdy + P_TILE;
    const float* cum_s = reinterpret_cast<const float*>(base + (sx + TILES * P_TILE - s0));
    const float* dt_s = cum_s + CS_MAX;
    const float ci[2] = {cum_s[i0 + row0], cum_s[i0 + row0 + 8]};
    for (int jt = wg; jt <= it; jt += 2) {
      const uint32_t sxj = sx + jt * P_TILE;
      float dw[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) dw[q] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PPAD / 16; ++kk) wgmma_ss(dw, kmajor(sdy, TR, kk), kmajor(sxj, TR, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dw);
      // dw[4n + 2r + e]: row i = i0 + row0 + 8r, column j = jt * 64 + 8n + col0 + e
      const bool diag = jt == it;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jt * TR + 8 * n + col0 + e;
          const float cj = cum_s[j], dj = dt_s[j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = i0 + row0 + 8 * r, q = 4 * n + 2 * r + e;
            const bool ok = i < cs && j < cs && (!diag || i >= j);
            const float L = fast_exp2((ok ? ci[r] - cj : 0.f) * LOG2E);
            dw[q] = ok ? dw[q] * L * dj : 0.f;
          }
        }
      // dC += G.B_j: K = j, B_j MN-major
      uint32_t ga[4][4];
      round_frags(dw, ga);
      fence_regs(dc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dc, ga[kk], mnmajor(sB + jt * N_TILE, TR, kk));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dc);
    }
    __syncthreads();  // stage st consumed
  }
  cp_async_wait<0>();

  // dC_i = warpgroup 0's partial + warpgroup 1's, over the first stage
  float* xdc = reinterpret_cast<float*>(base + (sStage - s0));
  if (wg == 1) put64(xdc, dc, t);
  __syncthreads();
  if (wg == 1) return;
  bf16* dcb = p.dc + b * p.dcs[0] + g * p.dcs[1] + c * p.dcs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + row0 + 8 * r;
    if (i >= cs) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + col0, q = 4 * n + 2 * r;
      if (col < N)
        *reinterpret_cast<uint32_t*>(dcb + i * p.dcs[3] + col) =
            pack_bf16(dc[q] + xdc[q * NT + t], dc[q + 1] + xdc[(q + 1) * NT + t]);
    }
  }
}

__global__ void __launch_bounds__(NTB, 1) ssd_bwd_wgmma_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* base = smem_raw + pad;
  const int groups = p.heads / p.heads_per_group;
  const int c = blockIdx.x % p.n_chunks, bg = blockIdx.x / p.n_chunks;
  const int b = bg / groups, g = bg - b * groups;
  const int y = blockIdx.y;
  if (y < p.tiles)
    column_role(p, base, raw + pad, reinterpret_cast<float*>(base + (SMEM - 1024 - XCHG)), b, g, c, y);
  else
    row_role(p, base, raw + pad, b, g, c, 2 * p.tiles - 1 - y);
}

// dy (strides (batch, head, chunk, row), rows contiguous) and dS (strides
// (batch, head, chunk), each N x P matrix contiguous) to contiguous bf16:
// the rows of dy, then those of dS, P / 4 threads a row and 4 columns a
// thread (one 16-byte load where vec is set)
struct CvtParams {
  const float* dy;
  const float* ds;
  bf16* dyb;
  bf16* dsb;
  long long dys[4], dss[3];
  int heads, n_chunks, cs, P, N, dy_rows, rows, vec;
};

__global__ void ssd_bwd_cvt_kernel(const CvtParams q) {
  const unsigned tpr = q.P / 4, total = static_cast<unsigned>(q.rows) * tpr;
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < total; t += gridDim.x * blockDim.x) {
    const unsigned row = t / tpr, m = (t - row * tpr) * 4;
    const bool is_dy = row < static_cast<unsigned>(q.dy_rows);
    const unsigned rr = is_dy ? row : row - q.dy_rows, len = is_dy ? q.cs : q.N;
    const unsigned r = rr % len, hc = rr / len;  // (b * heads + h) * chunks + c
    const unsigned c = hc % q.n_chunks, bh = hc / q.n_chunks, h = bh % q.heads, b = bh / q.heads;
    const float* src = is_dy ? q.dy + b * q.dys[0] + h * q.dys[1] + c * q.dys[2] + r * q.dys[3] + m
                             : q.ds + b * q.dss[0] + h * q.dss[1] + c * q.dss[2] + r * q.P + m;
    const float4 v = q.vec ? *reinterpret_cast<const float4*>(src) : make_float4(src[0], src[1], src[2], src[3]);
    bf16* dst = (is_dy ? q.dyb : q.dsb) + static_cast<long long>(rr) * q.P + m;
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// dcum += rowsum(M), its parts in (j tile, warp) order; on each chunk's last
// row also the sums of e dt B.U in (j tile, warp) order
__global__ void ssd_bwd_tc_dcum_kernel(const Params p, int batch) {
  const int cs = p.cs, nc = p.n_chunks, tiles = p.tiles;
  const long long total = static_cast<long long>(batch) * p.heads * nc * cs;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long hc = idx / cs;  // (b * heads + h) * chunks + c
    const int i = static_cast<int>(idx - hc * cs);
    const int c = static_cast<int>(hc % nc);
    const int h = static_cast<int>((hc / nc) % p.heads);
    const int b = static_cast<int>(hc / nc / p.heads);
    const float* rp = p.rowpart + hc * tiles * 4 * cs + i;
    float v = rp[0];
    for (int k = 1; k < 4 * (i / TR + 1); ++k) v += rp[k * cs];
    if (i == cs - 1)
      for (int k = 0; k < 4 * tiles; ++k) v += p.qsum[hc * tiles * 4 + k];
    p.dcum[b * p.dcums[0] + h * p.dcums[1] + c * p.dcums[2] + i * p.dcums[3]] += v;
  }
}

int grid_stride_blocks(long long total) {
  const long long blocks = (total + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

// The copies take 16-byte chunks: a 16-byte base, the last dim in whole
// chunks, and a stride in whole chunks on every dim with more than one index.
bool aligned16(const void* ptr, const long long* strides, const int* sizes, int d) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || d % 8 != 0) return false;
  for (int i = 0; i < 4; ++i)
    if (sizes[i] > 1 && strides[i] % 8 != 0) return false;
  return true;
}

void copy_strides(long long* dst, const long long* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

}  // namespace

// bf16 only.  Strides are in elements: (batch, head, chunk, row) for x, dt,
// cum, dy, dx, ddt and dcum; (batch, group, chunk, row) for B, C, dB and dC;
// (batch, head, chunk) for dS, whose N x P matrix is contiguous.  dt, cum,
// dy, dS, ddt and dcum are f32; x, B, C, dx, dB and dC bf16.  cs <= 256, P
// <= 64 and N <= 128 in multiples of 8, x / B / C in 16-byte chunks (else
// cudaErrorInvalidValue or cudaErrorMisalignedAddress).  The scratch,
// contiguous: dyb (batch, heads, chunks, cs, P) and dsb (batch, heads,
// chunks, N, P) bf16; rowpart (batch, heads, chunks, ceil(cs / 64), 4, cs)
// and qsum (batch, heads, chunks, ceil(cs / 64), 4) f32.
extern "C" int ssd_intra_chunk_bwd_tc(
    const void* x, const void* dt, const void* cum, const void* b, const void* c, const void* dy,
    const void* ds, void* dx, void* ddt, void* dcum, void* db, void* dc, void* dyb, void* dsb,
    void* rowpart, void* qsum, int batch, int heads, int heads_per_group, int n_chunks, int cs, int P,
    int N, const long long* x_strides, const long long* dt_strides, const long long* cum_strides,
    const long long* b_strides, const long long* c_strides, const long long* dy_strides,
    const long long* ds_strides, const long long* dx_strides, const long long* ddt_strides,
    const long long* dcum_strides, const long long* db_strides, const long long* dc_strides, void* stream) {
  if (P < 8 || P > PPAD || P % 8 || N < 8 || N > NPAD || N % 8 || cs < 1 || cs > CS_MAX || heads < 1 ||
      heads_per_group < 1 || heads % heads_per_group != 0 || n_chunks < 1 || batch < 1 ||
      static_cast<long long>(batch) * (heads / heads_per_group) * n_chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.cum = static_cast<const float*>(cum);
  p.bm = static_cast<const bf16*>(b);
  p.cm = static_cast<const bf16*>(c);
  p.dy = static_cast<const bf16*>(dyb);
  p.ds = static_cast<const bf16*>(dsb);
  p.dx = static_cast<bf16*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dcum = static_cast<float*>(dcum);
  p.db = static_cast<bf16*>(db);
  p.dc = static_cast<bf16*>(dc);
  p.rowpart = static_cast<float*>(rowpart);
  p.qsum = static_cast<float*>(qsum);
  p.heads = heads;
  p.heads_per_group = heads_per_group;
  p.n_chunks = n_chunks;
  p.cs = cs;
  p.P = P;
  p.N = N;
  p.tiles = (cs + TR - 1) / TR;
  copy_strides(p.xs, x_strides, 4);
  copy_strides(p.dts, dt_strides, 4);
  copy_strides(p.cums, cum_strides, 4);
  copy_strides(p.bs, b_strides, 4);
  copy_strides(p.cms, c_strides, 4);
  copy_strides(p.dxs, dx_strides, 4);
  copy_strides(p.ddts, ddt_strides, 4);
  copy_strides(p.dcums, dcum_strides, 4);
  copy_strides(p.dbs, db_strides, 4);
  copy_strides(p.dcs, dc_strides, 4);
  const int groups = heads / heads_per_group;
  const int x_sizes[4] = {batch, heads, n_chunks, cs};
  const int g_sizes[4] = {batch, groups, n_chunks, cs};
  if (!aligned16(x, p.xs, x_sizes, P) || !aligned16(b, p.bs, g_sizes, N) || !aligned16(c, p.cms, g_sizes, N))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  CvtParams q;
  q.dy = static_cast<const float*>(dy);
  q.ds = static_cast<const float*>(ds);
  q.dyb = static_cast<bf16*>(dyb);
  q.dsb = static_cast<bf16*>(dsb);
  copy_strides(q.dys, dy_strides, 4);
  copy_strides(q.dss, ds_strides, 3);
  q.heads = heads;
  q.n_chunks = n_chunks;
  q.cs = cs;
  q.P = P;
  q.N = N;
  const long long hc = static_cast<long long>(batch) * heads * n_chunks;
  if (hc * (cs + N) * (P / 4) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  q.dy_rows = static_cast<int>(hc * cs);
  q.rows = static_cast<int>(hc * (cs + N));
  bool vec = reinterpret_cast<uintptr_t>(dy) % 16 == 0 && reinterpret_cast<uintptr_t>(ds) % 16 == 0;
  for (int i = 0; i < 4; ++i) vec = vec && dy_strides[i] % 4 == 0;
  for (int i = 0; i < 3; ++i) vec = vec && ds_strides[i] % 4 == 0;
  q.vec = vec;
  ssd_bwd_cvt_kernel<<<grid_stride_blocks(static_cast<long long>(q.rows) * (P / 4)), 256, 0, st>>>(q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(ssd_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_wgmma_kernel<<<dim3(batch * groups * n_chunks, 2 * p.tiles), NTB, SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_tc_dcum_kernel<<<grid_stride_blocks(static_cast<long long>(batch) * heads * n_chunks * cs), 256, 0,
                           st>>>(p, batch);
  return static_cast<int>(cudaGetLastError());
}
