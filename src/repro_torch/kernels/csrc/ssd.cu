// Mamba-2 SSD intra-chunk step for Hopper.
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_pallas
//           (body _ssd_kernel).
// Computes: per (batch, head, chunk), in f32 whatever the input type,
//             y_i   = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//             state = sum_j B_j * (exp(cum_last - cum_j) * dt_j) x_j^T      (N x P)
//           with the products in the reference's order.  Head h reads
//           group h / heads_per_group of B and C, so the groups are never
//           expanded to heads in memory.
// Layout:   every operand through strides (batch, head or group, chunk, row)
//           with the last dim contiguous, so the model's (B, L, H, .) tensors
//           are read in place; y and state are f32.
//
// Bound: ~cs^2/2 * (N + P) * 2 flops per chunk against ~cs * (P + 2N)
// elements read.  On the tensor cores (989 TFLOP/s bf16) the bytes bound the
// whole step at the serving shape.  Inside the diagonal tile the masked decay
// (exp of a positive number, possibly inf) is removed by a select, never by a
// multiply with a 0/1 mask (inf * 0 = NaN), and the decay is never factored
// into exp(cum_i) * exp(-cum_j): across a chunk of strong decay those
// overflow.
//
// This file is the bf16 route (the serving and train path) and nothing else:
// ssd_chunk_wgmma_kernel, two blocks per chunk (cs <= 256).  Each holds the
//   whole chunk's B and x and two 64-row tiles of C in shared memory, loaded
//   once by 16-byte cp.async into the 128-byte swizzle and waited for once.
//   Warpgroup 0 computes y for the causal i tiles {0, 3} (block 0) or {1, 2}
//   (block 1), 5 tile products each: S = C_i.B_j^T by wgmma (both K-major
//   from shared memory, as flash's Q.K^T), W = S * exp(cum_i - cum_j) * dt_j
//   on the accumulator layout (the decay as one ex2.approx, branch-free: a
//   branch per element cost about a fifth of the kernel's time on an H100),
//   then y += W.x_j with W as the register A operand and x_j as an MN-major
//   B operand (flash's P.V).  W is f32: it goes in as hi = bf16(W) and lo =
//   bf16(W - hi), two wgmmas into one f32 accumulator, so each term is
//   within ~2^-17 of its f32 value (x is exact in bf16).  Warpgroup 1
//   computes 64 of the N state rows (block 0 rows 0-63, block 1 rows
//   64-127): A = (B_j * w_j)^T, built from shared memory in registers and
//   split hi / lo the same way, B = x_j.  P <= 64 and N <= 128 that are
//   multiples of 8 are padded by zero-filled copies.  135 KB of shared
//   memory: one block an SM; 2 * nc * H blocks per call (384 at the serving
//   shape: 2.9 waves of 132 SMs).
// f32, and bf16 outside this kernel's envelope, run the SIMT kernels of
// ssd_wide.cu (any P, N and chunk; f32 exact for the checks that need it).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TR = 64;  // rows per tile (i and j)

struct SsdParams {
  const void* x;
  const float* dt;
  const float* cum;
  const void* bm;
  const void* cm;
  float* y;
  float* state;
  int heads, heads_per_group, cs, P, N;
  long long xs[4], dts[4], cums[4], bs[4], cms[4], ys[4], sts[3];
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hop;

constexpr int CS_MAX = 256;  // chunk rows a block holds
constexpr int NT = 256;      // warpgroup 0: y; warpgroup 1: state
constexpr int NPAD = 128;    // state dim, padded
constexpr int PPAD = 64;     // head dim, padded
constexpr int C_TILE = TR * NPAD * 2;         // one 64-row tile of C: 16 KB
constexpr int B_BYTES = CS_MAX * NPAD * 2;    // 64 KB
constexpr int X_BYTES = CS_MAX * PPAD * 2;    // 32 KB
constexpr int SMEM = 1024 + 2 * C_TILE + B_BYTES + X_BYTES + 3 * CS_MAX * 4;
static_assert(NT == CS_MAX, "one thread per chunk row loads dt and cum");
constexpr float LOG2E = 1.4426950408889634f;

// hi = bf16(v), lo = bf16(v - hi), two columns packed per register
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// x rows [j0, j0 + 16) as the MN-major B operand of one k step
__device__ __forceinline__ uint64_t x_desc(uint32_t sX, int j0) {
  return desc128(sX + j0 * ROW_BYTES, CS_MAX * ROW_BYTES, 1024);
}

// The state's A operand (B_j * w_j)^T for j tile jt, split hi / lo: fragment
// q of k step kk is row (q & 1 ? nb : na) and columns
// j = 16 kk + col0 + (q & 2 ? 8 : 0) + {0, 1} of the swizzled B; bsw[r][e]
// points at row r's element of column col0 + e of j tile 0.
__device__ __forceinline__ void state_frags(uint32_t (&f)[2][4][4], const uint8_t* const (&bsw)[2][2],
                                            const float* w_s, int jt, int col0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j8 = jt * TR + 16 * kk + ((q & 2) ? 8 : 0);  // j - col0 - e
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = __bfloat162float(*reinterpret_cast<const bf16*>(bsw[q & 1][e] + j8 * ROW_BYTES)) *
               w_s[j8 + col0 + e];
      split2(v[0], v[1], f[0][kk][q], f[1][kk][q]);
    }
}

// state += (B_j * w_j)^T . x_j, hi then lo per k step; issued and committed
__device__ __forceinline__ void state_issue(float (&acc)[32], const uint32_t (&f)[2][4][4], uint32_t sX,
                                            int jt) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = x_desc(sX, jt * TR + 16 * kk);
    wgmma_rs(acc, f[0][kk], db);
    wgmma_rs(acc, f[1][kk], db);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(NT, 1) ssd_chunk_wgmma_kernel(const SsdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t sC = raw + pad;            // 2 x (64 rows x NPAD): this block's i tiles
  const uint32_t sB = sC + 2 * C_TILE;      // CS_MAX rows x NPAD
  const uint32_t sX = sB + B_BYTES;         // CS_MAX rows x PPAD
  float* cum_s = reinterpret_cast<float*>(base + 2 * C_TILE + B_BYTES + X_BYTES);
  float* dt_s = cum_s + CS_MAX;
  float* w_s = dt_s + CS_MAX;  // state weights exp(cum_last - cum_j) * dt_j

  const int half = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.heads, h = bh - b * p.heads, g = h / p.heads_per_group;
  const int cs = p.cs, n_tiles = (cs + TR - 1) / TR;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  const bf16* xb = static_cast<const bf16*>(p.x) + b * p.xs[0] + h * p.xs[1] + c * p.xs[2];
  const bf16* bb = static_cast<const bf16*>(p.bm) + b * p.bs[0] + g * p.bs[1] + c * p.bs[2];
  const bf16* cb = static_cast<const bf16*>(p.cm) + b * p.cms[0] + g * p.cms[1] + c * p.cms[2];
  const float* dtb = p.dt + b * p.dts[0] + h * p.dts[1] + c * p.dts[2];
  const float* cumb = p.cum + b * p.cums[0] + h * p.cums[1] + c * p.cums[2];

  // every byte the block reads, issued at once; rows past cs and columns
  // past N / P arrive as zeros
  const int it0 = half, it1 = 3 - half;  // causal i tiles paired: 5 tile products each
  if (it0 < n_tiles) load_tile<TR, NPAD, NT>(sC, cb, p.cms[3], it0 * TR, cs, p.N, tid);
  if (it1 < n_tiles) load_tile<TR, NPAD, NT>(sC + C_TILE, cb, p.cms[3], it1 * TR, cs, p.N, tid);
  load_tile<CS_MAX, NPAD, NT>(sB, bb, p.bs[3], 0, cs, p.N, tid);
  load_tile<CS_MAX, PPAD, NT>(sX, xb, p.xs[3], 0, cs, p.P, tid);
  cp_async_commit();
  {
    const int j = tid;
    float cj = 0.f, dj = 0.f, wj = 0.f;
    if (j < cs) {
      cj = cumb[j * p.cums[3]];
      dj = dtb[j * p.dts[3]];
      wj = expf(cumb[(cs - 1) * p.cums[3]] - cj) * dj;
    }
    cum_s[j] = cj;
    dt_s[j] = dj;
    w_s[j] = wj;
  }
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();

  // this thread's rows of the accumulator layout: row0 and row0 + 8;
  // acc[4n + 2r + e] is row row0 + 8r, column 8n + col0 + e
  const int row0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);

  if (wg == 0) {
    float* yb = p.y + b * p.ys[0] + h * p.ys[1] + c * p.ys[2];
    for (int s = 0; s < 2; ++s) {
      const int it = s ? it1 : it0;
      if (it >= n_tiles) continue;
      const uint32_t cst = sC + s * C_TILE;
      const int i0 = it * TR;
      const float ci[2] = {cum_s[i0 + row0], cum_s[i0 + row0 + 8]};
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int jt = 0; jt <= it; ++jt) {
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        // S = C_i . B_j^T: k steps of 16 (32 bytes) inside each 64-column region
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NPAD / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;
          const uint64_t da = desc128(cst + (kk >> 2) * (TR * ROW_BYTES) + off, 16, 1024);
          const uint64_t db = desc128(sB + (kk >> 2) * (CS_MAX * ROW_BYTES) + jt * (TR * ROW_BYTES) + off, 16, 1024);
          wgmma_ss(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        // W = S * exp(cum_i - cum_j) * dt_j, branch-free (a branch per
        // element serialises the warps): the exponent of a masked pair
        // (i < j, or a row past cs) is clamped to 0 and the product then
        // removed by a select, never by a multiply
        const bool diag = jt == it;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = jt * TR + 8 * n + col0 + e;
            const float cj = cum_s[j], dj = dt_s[j];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = i0 + row0 + 8 * r;
              const bool ok = i < cs && j < cs && (!diag || i >= j);
              const int k = 4 * n + 2 * r + e;
              const float w = sc[k] * fast_exp2((ok ? ci[r] - cj : 0.f) * LOG2E) * dj;
              sc[k] = ok ? w : 0.f;
            }
          }
        // y += W . x_j: W as hi + lo bf16 register A operands, 16 columns a step
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) split2(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1], ahi[kk][q], alo[kk][q]);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = x_desc(sX, jt * TR + 16 * kk);
          wgmma_rs(acc, ahi[kk], db);
          wgmma_rs(acc, alo[kk], db);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + row0 + 8 * r;
        if (i >= cs) continue;
        float* yr = yb + i * p.ys[3];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 8 * n + col0;
          if (col < p.P) {
            yr[col] = acc[4 * n + 2 * r];
            yr[col + 1] = acc[4 * n + 2 * r + 1];
          }
        }
      }
    }
  } else {
    // state rows n_lo + row0 (+ 8): state = (B * w)^T . x over every j tile
    const int n_lo = half * TR;
    if (n_lo >= p.N) return;
    const int na = n_lo + row0, nb = na + 8;
    // B[j][n] of row n (r = 0: na, 1: nb) and column j = 8 m + col0 + e: the
    // swizzle depends on j % 8 = col0 + e only, so it is fixed per thread
    const uint8_t* bsw[2][2];  // see state_frags
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = r ? nb : na, j = col0 + e;
        bsw[r][e] = base + 2 * C_TILE + ((n >> 6) * CS_MAX + j) * ROW_BYTES +
                    ((((n & 63) >> 3) ^ j) << 4) + (n & 7) * 2;
      }
    float acc[32];
    uint32_t f[2][4][4];  // [hi, lo][k step][register]
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      state_frags(f, bsw, w_s, jt, col0);
      state_issue(acc, f, sX, jt);
      wgmma_wait0();
    }
    fence_regs(acc);
    float* st = p.state + b * p.sts[0] + h * p.sts[1] + c * p.sts[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = r ? nb : na;
      if (n >= p.N) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 8 * q + col0;
        if (col < p.P) {
          st[n * p.P + col] = acc[4 * q + 2 * r];
          st[n * p.P + col + 1] = acc[4 * q + 2 * r + 1];
        }
      }
    }
  }
}

// The copies take 16-byte chunks: a 16-byte base, P and N in whole chunks,
// and a stride that is a whole number of chunks on every dim that has more
// than one index (a dim of size 1 only ever takes index 0).
bool aligned16(const void* ptr, const long long* strides, const int* sizes, int d) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || d % 8 != 0) return false;
  for (int i = 0; i < 4; ++i)
    if (sizes[i] > 1 && strides[i] % 8 != 0) return false;
  return true;
}

int launch(const SsdParams& p, int batch, int n_chunks, cudaStream_t stream) {
  const int groups = p.heads / p.heads_per_group;
  const int x_sizes[4] = {batch, p.heads, n_chunks, p.cs};
  const int g_sizes[4] = {batch, groups, n_chunks, p.cs};
  if (p.cs > CS_MAX || p.P > PPAD || p.N > NPAD) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(p.x, p.xs, x_sizes, p.P) || !aligned16(p.bm, p.bs, g_sizes, p.N) ||
      !aligned16(p.cm, p.cms, g_sizes, p.N))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: the two halves of a chunk (y tiles {0, 3} / {1, 2}, state rows 0-63 / 64-127)
  ssd_chunk_wgmma_kernel<<<dim3(2, n_chunks, batch * p.heads), NT, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

void copy_strides(long long* dst, const long long* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

}  // namespace

// Strides are in elements: (batch, head, chunk, row) for x, dt, cum and y;
// (batch, group, chunk, row) for B and C; (batch, head, chunk) for state,
// whose N x P matrix is contiguous.  x, B and C share one dtype; dt, cum, y
// and state are f32.  bf16 only (ssd_wide.cu takes f32): cs <= 256, P <= 64
// and N <= 128; P, N, bases and strides in 16-byte chunks (else
// cudaErrorMisalignedAddress or cudaErrorInvalidValue).
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dt, const void* cum, const void* b,
                                   const void* c, void* y, void* state, int batch, int heads,
                                   int heads_per_group, int n_chunks, int cs, int P, int N,
                                   const long long* x_strides, const long long* dt_strides,
                                   const long long* cum_strides, const long long* b_strides,
                                   const long long* c_strides, const long long* y_strides,
                                   const long long* state_strides, int dtype, void* stream) {
  if (dtype != rt::BF16 || P < 1 || N < 1 || cs < 1 || heads < 1 || heads_per_group < 1 ||
      heads % heads_per_group != 0 || n_chunks < 1 || n_chunks > 65535 || batch < 1 ||
      static_cast<long long>(batch) * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdParams p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.cum = static_cast<const float*>(cum);
  p.bm = b;
  p.cm = c;
  p.y = static_cast<float*>(y);
  p.state = static_cast<float*>(state);
  p.heads = heads;
  p.heads_per_group = heads_per_group;
  p.cs = cs;
  p.P = P;
  p.N = N;
  copy_strides(p.xs, x_strides, 4);
  copy_strides(p.dts, dt_strides, 4);
  copy_strides(p.cums, cum_strides, 4);
  copy_strides(p.bs, b_strides, 4);
  copy_strides(p.cms, c_strides, 4);
  copy_strides(p.ys, y_strides, 4);
  copy_strides(p.sts, state_strides, 3);
  return tc::launch(p, batch, n_chunks, static_cast<cudaStream_t>(stream));
}
