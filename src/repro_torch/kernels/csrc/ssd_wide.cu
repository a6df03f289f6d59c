// Mamba-2 SSD intra-chunk step, the wide route: forward and backward for
// every f32 shape, and for every bf16 shape the tensor-core route refuses.
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_pallas (body
//           _ssd_kernel) for the shapes ssd.cu does not take, and for the
//           backward the jax.grad of the jnp ssd_chunked
//           (src/repro/models/ssm.py), as ssd_bwd_wgmma.cu does.  The Pallas
//           kernel takes any chunk cs, head dim P and state dim N; the
//           tensor-core route (ssd.cu, ssd_bwd_wgmma.cu) takes bf16 only, at
//           cs <= 256, P <= 64 and N <= 128, with P, N, strides and bases in
//           16-byte chunks.
// Computes: per (batch, head, chunk), in f32, with head h reading group
//           h / heads_per_group of B and C (ssd.cu's function):
//             y_i   = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//             state = sum_j B_j * (exp(cum_last - cum_j) * dt_j) x_j^T
//           and its vector-Jacobian product (ssd/ref.py::ssd_chunk_bwd_ref's
//           formulas; ssd_bwd_wgmma.cu's function): with s = C.B^T, L the causal
//           decay, W = s L dt_j, dW = dy x^T, Gm = dW L dt_j, e_j =
//           exp(cum_last - cum_j), u_j = dS x_j:
//             dx_j  = sum_{i >= j} W_ij dy_i + e_j dt_j dS^T B_j
//             dB_j  = sum_{i >= j} Gm_ij C_i + e_j dt_j u_j   (summed over the group's heads)
//             dC_i  = sum_{j <= i} Gm_ij B_j                  (summed over the group's heads)
//             ddt_j = sum_{i >= j} dW_ij s_ij L_ij + e_j B_j.u_j
//             dcum  = rowsum(dW∘W) - colsum(dW∘W) - e dt B.u, plus sum_j e_j dt_j B_j.u_j on the last row
// Layout:   every operand through strides (batch, head or group, chunk, row)
//           with the last dim contiguous; y, state, dy, dS, ddt and dcum f32.
//
// Bound: operations on the SIMT cores at these widths.  The simple route
// (wide.cuh): every output is cut into 64 x 64 tiles, one block a tile, and
// every product that reduces over a width (N for the scores, P for dW and u,
// N for dS^T B) walks it 64 columns at a time, so no width or chunk length
// is bounded.  The causal decay is applied by a select (the masked decay may
// be inf), never by a multiply.  Forward: one launch, blocks of the y role
// (i tile, P tile) and the state role (N tile, P tile).  Backward: three
// launches, each output written once by one block, in a fixed order, with no
// atomics (the same bits on every run): dx by (j tile, P tile); dB by (j
// tile, N tile) and dC by (i tile, N tile), each block walking its group's
// heads in order with the sum in registers; ddt and dcum by one block a
// chunk, its tiles in order, which also adds the last row's sum.
#include <cstdint>

#include "common.cuh"
#include "wide.cuh"

namespace {

using wide::LD;
using wide::NT;
using wide::TR;
using wide::View;
using wide::view;

struct Args {
  const void* x;
  const float* dt;
  const float* cum;
  const void* bm;
  const void* cm;
  const float* dy;  // backward
  const float* dS;  // backward: each (N, P) matrix contiguous
  float* y;         // forward
  float* state;     // forward
  void* dx;
  float* ddt;
  float* dcum;
  void* dB;
  void* dC;
  int heads, heads_per_group, cs, P, N;
  long long xs[4], dts[4], cums[4], bs[4], cms[4], ys[4], sts[3], dys[4], dSs[3], dxs[4], ddts[4], dcums[4],
      dBs[4], dCs[4];
};

__device__ __forceinline__ int tiles(int n) { return (n + TR - 1) / TR; }

// the per-(b, h, c) or per-(b, g, c) base of an operand with strides s
template <typename T>
__device__ __forceinline__ T* base(T* p, const long long* s, int b, int hg, int c) {
  return p + b * s[0] + hg * s[1] + c * s[2];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) ssd_wide_fwd_kernel(const Args p) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TR * LD;
  float* Ws = Bs + TR * LD;  // decay-weighted scores [i][j], or B_j w_j [j][n]
  float* Xs = Ws + TR * LD;  // x rows [j][p]
  float* ci = Xs + TR * LD;  // TR each
  float* cj = ci + TR;
  float* dj = cj + TR;

  const int cs = p.cs, n_it = tiles(cs), n_pt = tiles(p.P);
  const int c = blockIdx.y, bh = blockIdx.z, b = bh / p.heads, h = bh - b * p.heads, g = h / p.heads_per_group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* xb = base(static_cast<const T*>(p.x), p.xs, b, h, c);
  const T* bb = base(static_cast<const T*>(p.bm), p.bs, b, g, c);
  const T* cb = base(static_cast<const T*>(p.cm), p.cms, b, g, c);
  const float* dtb = base(p.dt, p.dts, b, h, c);
  const float* cumb = base(p.cum, p.cums, b, h, c);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  if (static_cast<int>(blockIdx.x) < n_it * n_pt) {  // y: (i tile, P tile)
    const int i0 = (blockIdx.x / n_pt) * TR, p0 = (blockIdx.x % n_pt) * TR, wp = min(TR, p.P - p0);
    if (tid < TR) ci[tid] = i0 + tid < cs ? cumb[(i0 + tid) * p.cums[3]] : 0.f;
    for (int j0 = 0; j0 <= i0; j0 += TR) {  // tiles above the diagonal are skipped
      float s[4][4];
      wide::walk(s, view(cb + i0 * p.cms[3], p.cms[3], 1, cs - i0), view(bb + j0 * p.bs[3], p.bs[3], 1, cs - j0),
                 p.N, As, Bs);
      if (tid < TR) {
        const int j = j0 + tid;
        cj[tid] = j < cs ? cumb[j * p.cums[3]] : 0.f;
        dj[tid] = j < cs ? dtb[j * p.dts[3]] : 0.f;
      }
      wide::load_tile(Xs, LD, TR, view(xb + j0 * p.xs[3], p.xs[3], 1, cs - j0), p0, wp);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ri = ty + 16 * a, i = i0 + ri;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rj = tx + 16 * k, j = j0 + rj;
          // select, not multiply: the decay for i < j may be inf
          Ws[ri * LD + rj] = (i >= j && i < cs && j < cs) ? s[a][k] * expf(ci[ri] - cj[rj]) * dj[rj] : 0.f;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < TR; ++kk) {
        float wv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) wv[a] = Ws[(ty + 16 * a) * LD + kk];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = Xs[kk * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] += wv[a] * xv[k];
      }
    }
    float* yb = base(p.y, p.ys, b, h, c);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i >= cs) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = tx + 16 * k;
        if (q < wp) yb[i * p.ys[3] + p0 + q] = acc[a][k];
      }
    }
    return;
  }

  // state: (N tile, P tile), rows n, columns p, summed over every row j
  const int r = blockIdx.x - n_it * n_pt;
  const int n0 = (r / n_pt) * TR, p0 = (r % n_pt) * TR, wn = min(TR, p.N - n0), wp = min(TR, p.P - p0);
  const float cum_end = cumb[(cs - 1) * p.cums[3]];
  for (int j0 = 0; j0 < cs; j0 += TR) {
    __syncthreads();  // the previous tile's Ws, Xs, dj consumed
    if (tid < TR) {
      const int j = j0 + tid;
      dj[tid] = j < cs ? expf(cum_end - cumb[j * p.cums[3]]) * dtb[j * p.dts[3]] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < TR * TR; idx += NT) {
      const int rj = idx / TR, n = idx - rj * TR, j = j0 + rj;
      Ws[rj * LD + n] = (j < cs && n < wn) ? rt::to_f32(bb[j * p.bs[3] + n0 + n]) * dj[rj] : 0.f;
    }
    wide::load_tile(Xs, LD, TR, view(xb + j0 * p.xs[3], p.xs[3], 1, cs - j0), p0, wp);
    __syncthreads();
    for (int jj = 0; jj < TR; ++jj) {
      float bv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = Ws[jj * LD + ty + 16 * a];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = Xs[jj * LD + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] += bv[a] * xv[k];
    }
  }
  float* st = p.state + b * p.sts[0] + h * p.sts[1] + c * p.sts[2];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = ty + 16 * a;
    if (n >= wn) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tx + 16 * k;
      if (q < wp) st[(n0 + n) * p.P + p0 + q] = acc[a][k];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dx: block (j tile x P tile, chunk, batch x head)
template <typename T>
__global__ void __launch_bounds__(NT) ssd_wide_dx_kernel(const Args p) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TR * LD;
  float* Ws = Bs + TR * LD;  // [i][j]
  float* Os = Ws + TR * LD;  // dy rows [i][p]
  float* ci = Os + TR * LD;
  float* cj = ci + TR;
  float* dj = cj + TR;

  const int cs = p.cs, n_pt = tiles(p.P);
  const int c = blockIdx.y, bh = blockIdx.z, b = bh / p.heads, h = bh - b * p.heads, g = h / p.heads_per_group;
  const int j0 = (blockIdx.x / n_pt) * TR, p0 = (blockIdx.x % n_pt) * TR, wp = min(TR, p.P - p0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* bb = base(static_cast<const T*>(p.bm), p.bs, b, g, c);
  const T* cb = base(static_cast<const T*>(p.cm), p.cms, b, g, c);
  const float* dyb = base(p.dy, p.dys, b, h, c);
  const float* dtb = base(p.dt, p.dts, b, h, c);
  const float* cumb = base(p.cum, p.cums, b, h, c);
  const float* dSb = p.dS + b * p.dSs[0] + h * p.dSs[1] + c * p.dSs[2];
  if (tid < TR) {
    const int j = j0 + tid;
    cj[tid] = j < cs ? cumb[j * p.cums[3]] : 0.f;
    dj[tid] = j < cs ? dtb[j * p.dts[3]] : 0.f;
  }

  float acc[4][4];  // rows j, columns p
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  for (int i0 = j0; i0 < cs; i0 += TR) {
    float s[4][4];
    wide::walk(s, view(cb + i0 * p.cms[3], p.cms[3], 1, cs - i0), view(bb + j0 * p.bs[3], p.bs[3], 1, cs - j0),
               p.N, As, Bs);
    if (tid < TR) ci[tid] = i0 + tid < cs ? cumb[(i0 + tid) * p.cums[3]] : 0.f;
    wide::load_tile(Os, LD, TR, view(dyb + i0 * p.dys[3], p.dys[3], 1, cs - i0), p0, wp);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ri = ty + 16 * a, i = i0 + ri;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int rj = tx + 16 * k, j = j0 + rj;
        Ws[ri * LD + rj] = (i >= j && i < cs && j < cs) ? s[a][k] * expf(ci[ri] - cj[rj]) * dj[rj] : 0.f;
      }
    }
    __syncthreads();
    for (int ii = 0; ii < TR; ++ii) {
      float wv[4], ov[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) wv[a] = Ws[ii * LD + ty + 16 * a];
#pragma unroll
      for (int k = 0; k < 4; ++k) ov[k] = Os[ii * LD + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] += wv[a] * ov[k];
    }
  }

  // + e_j dt_j (dS^T B_j)_p: B rows j against dS's columns p, over N
  float t[4][4];
  wide::walk(t, view(bb + j0 * p.bs[3], p.bs[3], 1, cs - j0), view(dSb + p0, 1, p.P, wp), p.N, As, Bs);
  const float cum_end = cumb[(cs - 1) * p.cums[3]];
  T* dxb = base(static_cast<T*>(p.dx), p.dxs, b, h, c);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int rj = ty + 16 * a, j = j0 + rj;
    if (j >= cs) continue;
    const float ed = expf(cum_end - cj[rj]) * dj[rj];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tx + 16 * k;
      if (q < wp) dxb[j * p.dxs[3] + p0 + q] = rt::from_f32<T>(acc[a][k] + ed * t[a][k]);
    }
  }
}

// dB (column role: j tile x N tile) and dC (row role: i tile x N tile):
// block (role tile, chunk, batch x group), walking the group's heads in order
template <typename T>
__global__ void __launch_bounds__(NT) ssd_wide_dbdc_kernel(const Args p) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TR * LD;
  float* Gs = Bs + TR * LD;  // Gm [i][j]
  float* Os = Gs + TR * LD;  // C rows [i][n] (dB) or B rows [j][n] (dC)
  float* ci = Os + TR * LD;
  float* cj = ci + TR;
  float* dj = cj + TR;

  const int cs = p.cs, n_t = tiles(cs), n_nt = tiles(p.N), groups = p.heads / p.heads_per_group;
  const bool col = static_cast<int>(blockIdx.x) < n_t * n_nt;
  const int r = col ? blockIdx.x : blockIdx.x - n_t * n_nt;
  const int t0 = (r / n_nt) * TR, n0 = (r % n_nt) * TR, wn = min(TR, p.N - n0);
  const int c = blockIdx.y, b = blockIdx.z / groups, g = blockIdx.z - b * groups;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* bb = base(static_cast<const T*>(p.bm), p.bs, b, g, c);
  const T* cb = base(static_cast<const T*>(p.cm), p.cms, b, g, c);

  float acc[4][4];  // rows of the role's tile, columns n
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  for (int hh = 0; hh < p.heads_per_group; ++hh) {
    const int h = g * p.heads_per_group + hh;
    const T* xb = base(static_cast<const T*>(p.x), p.xs, b, h, c);
    const float* dyb = base(p.dy, p.dys, b, h, c);
    const float* dtb = base(p.dt, p.dts, b, h, c);
    const float* cumb = base(p.cum, p.cums, b, h, c);
    // column role: partners i0 = t0, t0 + 64, ...; row role: j0 = 0 .. t0
    const int first = col ? t0 : 0, last = col ? cs : t0 + 1;
    for (int q0 = first; q0 < last; q0 += TR) {
      const int i0 = col ? q0 : t0, j0 = col ? t0 : q0;
      float dw[4][4];
      wide::walk(dw, view(dyb + i0 * p.dys[3], p.dys[3], 1, cs - i0), view(xb + j0 * p.xs[3], p.xs[3], 1, cs - j0),
                 p.P, As, Bs);
      if (tid < TR) {
        ci[tid] = i0 + tid < cs ? cumb[(i0 + tid) * p.cums[3]] : 0.f;
        cj[tid] = j0 + tid < cs ? cumb[(j0 + tid) * p.cums[3]] : 0.f;
        dj[tid] = j0 + tid < cs ? dtb[(j0 + tid) * p.dts[3]] : 0.f;
      }
      wide::load_tile(Os, LD, TR,
                      col ? view(cb + i0 * p.cms[3], p.cms[3], 1, cs - i0) : view(bb + j0 * p.bs[3], p.bs[3], 1, cs - j0),
                      n0, wn);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ri = ty + 16 * a, i = i0 + ri;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rj = tx + 16 * k, j = j0 + rj;
          Gs[ri * LD + rj] = (i >= j && i < cs && j < cs) ? dw[a][k] * expf(ci[ri] - cj[rj]) * dj[rj] : 0.f;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < TR; ++kk) {
        float gv[4], ov[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) gv[a] = col ? Gs[kk * LD + ty + 16 * a] : Gs[(ty + 16 * a) * LD + kk];
#pragma unroll
        for (int k = 0; k < 4; ++k) ov[k] = Os[kk * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] += gv[a] * ov[k];
      }
    }
    if (col) {  // + e_j dt_j u_j, u_j = dS x_j: x rows j against dS rows n, over P
      const float* dSb = p.dS + b * p.dSs[0] + h * p.dSs[1] + c * p.dSs[2];
      float u[4][4];
      wide::walk(u, view(xb + t0 * p.xs[3], p.xs[3], 1, cs - t0), view(dSb + n0 * p.P, p.P, 1, wn), p.P, As, Bs);
      const float cum_end = cumb[(cs - 1) * p.cums[3]];
#pragma unroll
      for (int a = 0; a < 4; ++a) {  // cj, dj hold this head's j tile (the partner loop ran at least once)
        const int rj = ty + 16 * a;
        const float ed = t0 + rj < cs ? expf(cum_end - cj[rj]) * dj[rj] : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] += ed * u[a][k];
      }
    }
  }

  T* dst = base(static_cast<T*>(col ? p.dB : p.dC), col ? p.dBs : p.dCs, b, g, c);
  const long long rs = col ? p.dBs[3] : p.dCs[3];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = t0 + ty + 16 * a;
    if (row >= cs) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = tx + 16 * k;
      if (n < wn) dst[row * rs + n0 + n] = rt::from_f32<T>(acc[a][k]);
    }
  }
}

// ddt and dcum: one block a (chunk, batch x head), its tiles in order
template <typename T>
__global__ void __launch_bounds__(NT) ssd_wide_scalars_kernel(const Args p) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TR * LD;
  float* red = Bs + TR * LD;   // 2 x 16 x TR: per-ty column partials
  float* rowM = red + 2 * 16 * TR;
  float* colM = rowM + TR;
  float* colD = colM + TR;
  float* bu = colD + TR;
  float* qv = bu + TR;
  float* ci = qv + TR;
  float* cj = ci + TR;
  float* dj = cj + TR;
  __shared__ float last_dcum;

  const int cs = p.cs;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads, g = h / p.heads_per_group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* xb = base(static_cast<const T*>(p.x), p.xs, b, h, c);
  const T* bb = base(static_cast<const T*>(p.bm), p.bs, b, g, c);
  const T* cb = base(static_cast<const T*>(p.cm), p.cms, b, g, c);
  const float* dyb = base(p.dy, p.dys, b, h, c);
  const float* dtb = base(p.dt, p.dts, b, h, c);
  const float* cumb = base(p.cum, p.cums, b, h, c);
  const float* dSb = p.dS + b * p.dSs[0] + h * p.dSs[1] + c * p.dSs[2];
  float* ddtb = base(p.ddt, p.ddts, b, h, c);
  float* dcumb = base(p.dcum, p.dcums, b, h, c);
  const float cum_end = cumb[(cs - 1) * p.cums[3]];
  float qsum = 0.f;  // thread 0's: sum_j e_j dt_j B_j.u_j in row order

  for (int t0 = 0; t0 < cs; t0 += TR) {
    // (1) rowsum(M) for the rows i of this tile: partners j0 <= t0
    float rs4[4] = {0.f, 0.f, 0.f, 0.f};
    // (2) colsum(M) and sum_i dW s L for the rows j of this tile: partners i0 >= t0
    float cm4[4] = {0.f, 0.f, 0.f, 0.f}, cd4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int role = 0; role < 2; ++role) {
      const int first = role == 0 ? 0 : t0, last = role == 0 ? t0 + 1 : cs;
      for (int q0 = first; q0 < last; q0 += TR) {
        const int i0 = role == 0 ? t0 : q0, j0 = role == 0 ? q0 : t0;
        float s[4][4], dw[4][4];
        wide::walk(s, view(cb + i0 * p.cms[3], p.cms[3], 1, cs - i0), view(bb + j0 * p.bs[3], p.bs[3], 1, cs - j0),
                   p.N, As, Bs);
        wide::walk(dw, view(dyb + i0 * p.dys[3], p.dys[3], 1, cs - i0),
                   view(xb + j0 * p.xs[3], p.xs[3], 1, cs - j0), p.P, As, Bs);
        if (tid < TR) {
          ci[tid] = i0 + tid < cs ? cumb[(i0 + tid) * p.cums[3]] : 0.f;
          cj[tid] = j0 + tid < cs ? cumb[(j0 + tid) * p.cums[3]] : 0.f;
          dj[tid] = j0 + tid < cs ? dtb[(j0 + tid) * p.dts[3]] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ri = ty + 16 * a, i = i0 + ri;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int rj = tx + 16 * k, j = j0 + rj;
            if (i >= j && i < cs && j < cs) {
              const float L = expf(ci[ri] - cj[rj]);
              const float m = dw[a][k] * (s[a][k] * L * dj[rj]);
              if (role == 0) {
                rs4[a] += m;
              } else {
                cm4[k] += m;
                cd4[k] += dw[a][k] * s[a][k] * L;
              }
            }
          }
        }
      }
    }
    // rows: a row's 16 owners are one half-warp
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs4[a] += __shfl_xor_sync(0xffffffffu, rs4[a], off);
    }
    __syncthreads();  // the previous tile's rowM, colM, colD, bu, qv read
    if (tx == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) rowM[ty + 16 * a] = rs4[a];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      red[ty * TR + tx + 16 * k] = cm4[k];
      red[16 * TR + ty * TR + tx + 16 * k] = cd4[k];
    }
    __syncthreads();
    if (tid < TR) {  // columns: the 16 row groups in order
      float m = 0.f, d = 0.f;
      for (int r = 0; r < 16; ++r) {
        m += red[r * TR + tid];
        d += red[16 * TR + r * TR + tid];
      }
      colM[tid] = m;
      colD[tid] = d;
    }

    // (3) B_j.u_j, u_j = dS x_j, over N tiles in order
    float b4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n0 = 0; n0 < p.N; n0 += TR) {
      float u[4][4];
      wide::walk(u, view(xb + t0 * p.xs[3], p.xs[3], 1, cs - t0), view(dSb + n0 * p.P, p.P, 1, p.N - n0), p.P,
                 As, Bs);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = t0 + ty + 16 * a;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = n0 + tx + 16 * k;
          if (j < cs && n < p.N) b4[a] += rt::to_f32(bb[j * p.bs[3] + n]) * u[a][k];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) b4[a] += __shfl_xor_sync(0xffffffffu, b4[a], off);
    }
    if (tx == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) bu[ty + 16 * a] = b4[a];
    __syncthreads();

    // (4) the tile's rows
    if (tid < TR) {
      const int j = t0 + tid;
      float q = 0.f;
      if (j < cs) {
        const float e = expf(cum_end - cumb[j * p.cums[3]]);
        q = e * dtb[j * p.dts[3]] * bu[tid];
        ddtb[j * p.ddts[3]] = colD[tid] + e * bu[tid];
        const float dc = rowM[tid] - colM[tid] - q;
        if (j == cs - 1)
          last_dcum = dc;
        else
          dcumb[j * p.dcums[3]] = dc;
      }
      qv[tid] = q;
    }
    __syncthreads();
    if (tid == 0)
      for (int r = 0; r < TR; ++r) qsum += qv[r];
  }
  if (tid == 0) dcumb[(cs - 1) * p.dcums[3]] = last_dcum + qsum;
}

constexpr size_t FWD_SMEM = sizeof(float) * (4 * TR * LD + 3 * TR);
constexpr size_t SCALAR_SMEM = sizeof(float) * (2 * TR * LD + 2 * 16 * TR + 8 * TR);

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

bool grid_fits(int batch, int heads, int n_chunks) {
  return n_chunks >= 1 && n_chunks <= 65535 && batch >= 1 && static_cast<long long>(batch) * heads <= 65535;
}

template <typename T>
int launch_fwd(const Args& p, int batch, int n_chunks, cudaStream_t st) {
  cudaError_t err = allow_smem(ssd_wide_fwd_kernel<T>, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pt = (p.P + TR - 1) / TR;
  const dim3 grid(((p.cs + TR - 1) / TR + (p.N + TR - 1) / TR) * n_pt, n_chunks, batch * p.heads);
  ssd_wide_fwd_kernel<T><<<grid, NT, FWD_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const Args& p, int batch, int n_chunks, cudaStream_t st) {
  cudaError_t err;
  if ((err = allow_smem(ssd_wide_dx_kernel<T>, FWD_SMEM)) != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(ssd_wide_dbdc_kernel<T>, FWD_SMEM)) != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(ssd_wide_scalars_kernel<T>, SCALAR_SMEM)) != cudaSuccess) return static_cast<int>(err);
  const int n_t = (p.cs + TR - 1) / TR, n_pt = (p.P + TR - 1) / TR, n_nt = (p.N + TR - 1) / TR;
  const int groups = p.heads / p.heads_per_group;
  ssd_wide_dx_kernel<T><<<dim3(n_t * n_pt, n_chunks, batch * p.heads), NT, FWD_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_wide_dbdc_kernel<T><<<dim3(2 * n_t * n_nt, n_chunks, batch * groups), NT, FWD_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_wide_scalars_kernel<T><<<dim3(n_chunks, batch * p.heads), NT, SCALAR_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

void copy_strides(long long* dst, const long long* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

Args make_args(const void* x, const void* dt, const void* cum, const void* b, const void* c, int heads,
               int heads_per_group, int cs, int P, int N, const long long* x_strides,
               const long long* dt_strides, const long long* cum_strides, const long long* b_strides,
               const long long* c_strides) {
  Args p = {};
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.cum = static_cast<const float*>(cum);
  p.bm = b;
  p.cm = c;
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
  return p;
}

bool valid(int batch, int heads, int heads_per_group, int n_chunks, int cs, int P, int N) {
  return P >= 1 && N >= 1 && cs >= 1 && heads >= 1 && heads_per_group >= 1 && heads % heads_per_group == 0 &&
         grid_fits(batch, heads, n_chunks);
}

}  // namespace

// The arguments of ssd_intra_chunk_fwd (ssd.cu), any cs, P and N and any
// strides with a contiguous last dim; f32 or bf16.
extern "C" int ssd_intra_chunk_wide_fwd(const void* x, const void* dt, const void* cum, const void* b,
                                        const void* c, void* y, void* state, int batch, int heads,
                                        int heads_per_group, int n_chunks, int cs, int P, int N,
                                        const long long* x_strides, const long long* dt_strides,
                                        const long long* cum_strides, const long long* b_strides,
                                        const long long* c_strides, const long long* y_strides,
                                        const long long* state_strides, int dtype, void* stream) {
  if (!valid(batch, heads, heads_per_group, n_chunks, cs, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  Args p = make_args(x, dt, cum, b, c, heads, heads_per_group, cs, P, N, x_strides, dt_strides, cum_strides,
                     b_strides, c_strides);
  p.y = static_cast<float*>(y);
  p.state = static_cast<float*>(state);
  copy_strides(p.ys, y_strides, 4);
  copy_strides(p.sts, state_strides, 3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16) return launch_fwd<__nv_bfloat16>(p, batch, n_chunks, st);
  if (dtype == rt::F32) return launch_fwd<float>(p, batch, n_chunks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: x, dt, cum, B, C as the forward's; dy (f32, strides of its
// (batch, head, chunk, row)) and dS (f32, each (N, P) matrix contiguous,
// strides of its (batch, head, chunk)); writes dx (x's dtype), ddt and dcum
// (f32) and dB, dC (B's dtype, summed over each group's heads).  Three
// launches, no scratch.
extern "C" int ssd_intra_chunk_wide_bwd(const void* x, const void* dt, const void* cum, const void* b,
                                        const void* c, const void* dy, const void* dS, void* dx, void* ddt,
                                        void* dcum, void* dB, void* dC, int batch, int heads,
                                        int heads_per_group, int n_chunks, int cs, int P, int N,
                                        const long long* x_strides, const long long* dt_strides,
                                        const long long* cum_strides, const long long* b_strides,
                                        const long long* c_strides, const long long* dy_strides,
                                        const long long* dS_strides, const long long* dx_strides,
                                        const long long* ddt_strides, const long long* dcum_strides,
                                        const long long* dB_strides, const long long* dC_strides, int dtype,
                                        void* stream) {
  if (!valid(batch, heads, heads_per_group, n_chunks, cs, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  Args p = make_args(x, dt, cum, b, c, heads, heads_per_group, cs, P, N, x_strides, dt_strides, cum_strides,
                     b_strides, c_strides);
  p.dy = static_cast<const float*>(dy);
  p.dS = static_cast<const float*>(dS);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dcum = static_cast<float*>(dcum);
  p.dB = dB;
  p.dC = dC;
  copy_strides(p.dys, dy_strides, 4);
  copy_strides(p.dSs, dS_strides, 3);
  copy_strides(p.dxs, dx_strides, 4);
  copy_strides(p.ddts, ddt_strides, 4);
  copy_strides(p.dcums, dcum_strides, 4);
  copy_strides(p.dBs, dB_strides, 4);
  copy_strides(p.dCs, dC_strides, 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16) return launch_bwd<__nv_bfloat16>(p, batch, n_chunks, st);
  if (dtype == rt::F32) return launch_bwd<float>(p, batch, n_chunks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
