// Backward of the Mamba-2 SSD intra-chunk step (csrc/ssd.cu) for Hopper:
// the float32 route.  bf16 takes the tensor cores (csrc/ssd_bwd_wgmma.cu).
//
// Replaces: no Pallas kernel.  repro trains mamba2 through jax.grad of the
//           jnp ssd_chunked (src/repro/models/ssm.py:74); this computes the
//           vector-Jacobian product of its intra-chunk part
//           (src/repro/kernels/ssd/ref.py::ssd_chunk_ref), the part
//           src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_pallas runs.
// Computes: per (batch, head, chunk), in f32, with
//           s_ij = C_i.B_j, L_ij = exp(cum_i - cum_j) (i >= j), W_ij =
//           s_ij L_ij dt_j, e_j = exp(cum_last - cum_j), u_j = dS x_j and the
//           cotangents dy (cs x P) and dS (N x P):
//             dW_ij = dy_i . x_j,  G_ij = dW_ij L_ij dt_j,  M_ij = G_ij s_ij
//             dx_j  = sum_{i>=j} W_ij dy_i + e_j dt_j dS^T B_j
//             dC_i  = sum_{j<=i} G_ij B_j
//             dB_j  = sum_{i>=j} G_ij C_i + e_j dt_j u_j
//             ddt_j = sum_{i>=j} dW_ij s_ij L_ij + e_j B_j.u_j
//             dcum  = rowsum(M) - colsum(M) - e_j dt_j B_j.u_j,
//                     plus sum_j e_j dt_j B_j.u_j on the chunk's last row.
//           Head h reads group h / heads_per_group of B and C; dB and dC sum
//           the group's heads.
// Layout:   every operand through strides (batch, head or group, chunk, row)
//           with the last dim contiguous, as the forward reads them; dS's
//           N x P matrix is contiguous.  Every operand is f32.
//
// Bound: ~cs^2/2 * (3N + 2P) * 2 flops of products per (chunk, head) plus
// 4 * cs * N * P for the state terms, against ~cs * (2P + 2N) elements read
// and written: the operations bound it.  This kernel runs them on the SIMT
// cores in f32, recomputing s and dW in each of its two roles:
//
// ssd_bwd_kernel, grid (2 * tiles, chunks, batch * heads), 256 threads, the
//   forward f32 kernel's 64-row tiles and 4 x 4 register blocking:
//   row role (x < tiles) owns a 64-row tile of i and walks the j tiles up to
//     its diagonal: s and dW tiles in registers, G into shared memory, then
//     dC_i += G B_j; it writes its head's dC rows and rowsum(M);
//   column role (x >= tiles) owns a 64-row tile of j and walks the i tiles
//     from its diagonal down: W and G (transposed) into shared memory, then
//     dx_j += W^T dy_i and dB_j += G^T C_i, with ddt and colsum(M) in
//     registers; then the state terms from dS in shared memory.  It writes
//     dx, ddt, its part of dcum, its head's dB rows and the tile's sum of
//     e_j dt_j B_j.u_j.
//   Masked entries (i < j, rows past cs) are selected to 0 before any
//   product, never multiplied by a 0/1 mask: the decay there may be inf.
// ssd_bwd_group_sum_kernel sums the per-head f32 dB and dC rows over each
//   group's heads in head order and converts them; ssd_bwd_dcum_kernel adds
//   rowsum(M) and the last-row term to dcum.  No atomics: the same bits on
//   every run.
#include "common.cuh"

namespace {

constexpr int TR = 64;    // rows per tile (i and j)
constexpr int NT = 256;   // threads: 16 (ty) x 16 (tx)
constexpr int PMAX = 64;  // head dim: 4 columns per thread
constexpr int NMAX = 128; // state dim: 8 columns per thread
constexpr int GP = TR + 1;

struct BwdParams {
  const void* x;
  const float* dt;
  const float* cum;
  const void* bm;
  const void* cm;
  const float* dy;
  const float* ds;
  void* dx;
  float* ddt;
  float* dcum;
  void* db;
  void* dc;
  float* dbh;   // (batch, heads, chunks, cs, N) per-head dB, contiguous
  float* dch;   // the same for dC
  float* rows;  // (batch, heads, chunks, cs) rowsum(M), contiguous
  float* qsum;  // (batch, heads, chunks, tiles) each j tile's sum of e dt B.u
  int heads, heads_per_group, n_chunks, cs, P, N, tiles;
  long long xs[4], dts[4], cums[4], bs[4], cms[4], dys[4], dss[3], dxs[4], ddts[4], dcums[4],
      dbs[4], dcs[4];
};

size_t smem_bytes(int N, int P) {
  const size_t NP = N + 1, PP = P + 1;
  return sizeof(float) * (2 * TR * NP + 2 * TR * PP + 2 * TR * GP + 4 * TR);
}

// rows r0 .. r0 + 63 of a (row, width) operand into shared memory with row
// pitch ld, zero past cs
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, long long stride, int r0, int cs,
                          int width) {
  for (int idx = threadIdx.x; idx < TR * width; idx += NT) {
    const int r = idx / width, col = idx - r * width, row = r0 + r;
    dst[r * ld + col] = row < cs ? rt::to_f32(src[row * stride + col]) : 0.f;
  }
}

// the sum over the 16 tx lanes of a row group (lanes 0-15 and 16-31 apart)
__device__ __forceinline__ float tx_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Chunk {
  const void* x;
  const void* bm;
  const void* cm;
  const float* dt;
  const float* cum;
  const float* dy;
  long long head_chunk;  // (b * heads + h) * chunks + c: the contiguous scratch's index
};

template <typename T>
__device__ Chunk chunk_of(const BwdParams& p, int b, int h, int c) {
  const int g = h / p.heads_per_group;
  Chunk k;
  k.x = static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[1] + c * p.xs[2];
  k.bm = static_cast<const T*>(p.bm) + b * p.bs[0] + g * p.bs[1] + c * p.bs[2];
  k.cm = static_cast<const T*>(p.cm) + b * p.cms[0] + g * p.cms[1] + c * p.cms[2];
  k.dt = p.dt + b * p.dts[0] + h * p.dts[1] + c * p.dts[2];
  k.cum = p.cum + b * p.cums[0] + h * p.cums[1] + c * p.cums[2];
  k.dy = p.dy + b * p.dys[0] + h * p.dys[1] + c * p.dys[2];
  k.head_chunk = (static_cast<long long>(b) * p.heads + h) * p.n_chunks + c;
  return k;
}

// Row role: the i tile `it`.  dC_i = sum_j G_ij B_j and rowsum(M)_i.
template <typename T>
__device__ void row_role(const BwdParams& p, float* smem, const Chunk& k, int it) {
  const int N = p.N, P = p.P, cs = p.cs, NP = N + 1, PP = P + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float* Cs = smem;             // TR x NP: C rows of this i tile
  float* DYs = Cs + TR * NP;    // TR x PP: dy rows of this i tile
  float* Bs = DYs + TR * PP;    // TR x NP: B rows of the j tile
  float* Xs = Bs + TR * NP;     // TR x PP: x rows of the j tile
  float* Gs = Xs + TR * PP;     // TR x GP: G_ij
  float* cum_i = Gs + TR * GP;  // TR
  float* cum_j = cum_i + TR;    // TR
  float* dt_j = cum_j + TR;     // TR
  const T* xb = static_cast<const T*>(k.x);
  const T* bb = static_cast<const T*>(k.bm);
  const T* cb = static_cast<const T*>(k.cm);

  const int i0 = it * TR;
  load_rows(Cs, NP, cb, p.cms[3], i0, cs, N);
  load_rows(DYs, PP, k.dy, p.dys[3], i0, cs, P);
  if (tid < TR) cum_i[tid] = i0 + tid < cs ? k.cum[(i0 + tid) * p.cums[3]] : 0.f;

  float acc[4][8], rsum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rsum[a] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
  }

  for (int j0 = 0; j0 <= i0; j0 += TR) {  // tiles above the diagonal are skipped
    __syncthreads();  // previous tile's Bs, Xs, Gs consumed
    load_rows(Bs, NP, bb, p.bs[3], j0, cs, N);
    load_rows(Xs, PP, xb, p.xs[3], j0, cs, P);
    if (tid < TR) {
      const int j = j0 + tid;
      cum_j[tid] = j < cs ? k.cum[j * p.cums[3]] : 0.f;
      dt_j[tid] = j < cs ? k.dt[j * p.dts[3]] : 0.f;
    }
    __syncthreads();

    // s and dW for rows ty + 16a (i), columns tx + 16q (j) of the tile
    float s[4][4], w[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[a][q] = w[a][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * NP + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * NP + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[a][q] += cv[a] * bv[q];
    }
    for (int m = 0; m < P; ++m) {
      float dv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = DYs[(ty + 16 * a) * PP + m];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = Xs[(tx + 16 * q) * PP + m];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[a][q] += dv[a] * xv[q];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ri = ty + 16 * a, i = i0 + ri;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rj = tx + 16 * q, j = j0 + rj;
        // select, not multiply: the decay for i < j may be inf
        const float L = (i >= j && i < cs && j < cs) ? expf(cum_i[ri] - cum_j[rj]) : 0.f;
        const float g = w[a][q] * L * dt_j[rj];
        Gs[ri * GP + rj] = g;
        rsum[a] += g * s[a][q];
      }
    }
    __syncthreads();

    // dC rows ty + 16a, columns tx + 16q: acc += G B_j
    for (int jj = 0; jj < TR; ++jj) {
      float gv[4], bv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) gv[a] = Gs[(ty + 16 * a) * GP + jj];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        bv[q] = n < N ? Bs[jj * NP + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[a][q] += gv[a] * bv[q];
    }
  }

  float* dch = p.dch + k.head_chunk * cs * N;
  float* rows = p.rows + k.head_chunk * cs;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    const float r = tx_sum(rsum[a]);
    if (i >= cs) continue;
    if (tx == 0) rows[i] = r;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (n < N) dch[static_cast<long long>(i) * N + n] = acc[a][q];
    }
  }
}

// Column role: the j tile `jt`.  dx_j, dB_j, ddt_j, -colsum(M)_j, then the
// state terms.
template <typename T>
__device__ void column_role(const BwdParams& p, float* smem, const Chunk& k, int jt, int b,
                            int h, int c) {
  const int N = p.N, P = p.P, cs = p.cs, NP = N + 1, PP = P + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float* Bs = smem;             // TR x NP: B rows of this j tile
  float* Xs = Bs + TR * NP;     // TR x PP: x rows of this j tile
  float* Cs = Xs + TR * PP;     // TR x NP: C rows of the i tile
  float* DYs = Cs + TR * NP;    // TR x PP: dy rows of the i tile
  float* Ws = DYs + TR * PP;    // TR x GP: W^T (row j, column i)
  float* Gs = Ws + TR * GP;     // TR x GP: G^T
  float* cum_j = Gs + TR * GP;  // TR
  float* dt_j = cum_j + TR;     // TR
  float* cum_i = dt_j + TR;     // TR
  float* qv = cum_i + TR;       // TR: e_j dt_j B_j.u_j of the tile's rows
  float* dSs = Cs;              // N x PP, after the i tiles: dS over Cs and DYs
  const T* xb = static_cast<const T*>(k.x);
  const T* bb = static_cast<const T*>(k.bm);
  const T* cb = static_cast<const T*>(k.cm);

  const int j0 = jt * TR;
  load_rows(Bs, NP, bb, p.bs[3], j0, cs, N);
  load_rows(Xs, PP, xb, p.xs[3], j0, cs, P);
  if (tid < TR) {
    const int j = j0 + tid;
    cum_j[tid] = j < cs ? k.cum[j * p.cums[3]] : 0.f;
    dt_j[tid] = j < cs ? k.dt[j * p.dts[3]] : 0.f;
  }

  float adx[4][4], adb[4][8], csum[4], dd[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    csum[a] = dd[a] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) adx[a][q] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) adb[a][q] = 0.f;
  }

  for (int i0 = j0; i0 < cs; i0 += TR) {  // tiles above the diagonal are skipped
    __syncthreads();  // Bs / Xs written, previous tile's Cs, DYs, Ws, Gs consumed
    load_rows(Cs, NP, cb, p.cms[3], i0, cs, N);
    load_rows(DYs, PP, k.dy, p.dys[3], i0, cs, P);
    if (tid < TR) cum_i[tid] = i0 + tid < cs ? k.cum[(i0 + tid) * p.cums[3]] : 0.f;
    __syncthreads();

    // s and dW for rows ty + 16a (j), columns tx + 16q (i) of the tile
    float s[4][4], w[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[a][q] = w[a][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float bv[4], cv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = Bs[(ty + 16 * a) * NP + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) cv[q] = Cs[(tx + 16 * q) * NP + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[a][q] += bv[a] * cv[q];
    }
    for (int m = 0; m < P; ++m) {
      float xv[4], dv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = Xs[(ty + 16 * a) * PP + m];
#pragma unroll
      for (int q = 0; q < 4; ++q) dv[q] = DYs[(tx + 16 * q) * PP + m];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[a][q] += xv[a] * dv[q];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rj = ty + 16 * a, j = j0 + rj;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ri = tx + 16 * q, i = i0 + ri;
        // select, not multiply: the decay for i < j may be inf
        const float L = (i >= j && i < cs && j < cs) ? expf(cum_i[ri] - cum_j[rj]) : 0.f;
        const float sl = s[a][q] * L;
        const float g = w[a][q] * L * dt_j[rj];
        Ws[rj * GP + ri] = sl * dt_j[rj];
        Gs[rj * GP + ri] = g;
        csum[a] += g * s[a][q];  // M_ij as the row role forms it, to the bit
        dd[a] += w[a][q] * sl;
      }
    }
    __syncthreads();

    // rows ty + 16a of dx (columns tx + 16q) and dB (columns tx + 16q)
    for (int ii = 0; ii < TR; ++ii) {
      float wv[4], gv[4], dv[4], cv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        wv[a] = Ws[(ty + 16 * a) * GP + ii];
        gv[a] = Gs[(ty + 16 * a) * GP + ii];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = tx + 16 * q;
        dv[q] = m < P ? DYs[ii * PP + m] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        cv[q] = n < N ? Cs[ii * NP + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int q = 0; q < 4; ++q) adx[a][q] += wv[a] * dv[q];
#pragma unroll
        for (int q = 0; q < 8; ++q) adb[a][q] += gv[a] * cv[q];
      }
    }
  }

  // the state terms: dS (N x P) over the Cs / DYs space
  __syncthreads();
  const float* dsb = p.ds + b * p.dss[0] + h * p.dss[1] + c * p.dss[2];
  for (int idx = tid; idx < N * P; idx += NT) {
    const int n = idx / P, m = idx - n * P;
    dSs[n * PP + m] = dsb[idx];
  }
  __syncthreads();
  const float cum_end = k.cum[(cs - 1) * p.cums[3]];
  // u_j = dS x_j (columns tx + 16q of N) and v_j = dS^T B_j (columns tx + 16q of P)
  float u[4][8], v[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int q = 0; q < 8; ++q) u[a][q] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v[a][q] = 0.f;
  }
  for (int m = 0; m < P; ++m) {
    float xv[4], sv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = Xs[(ty + 16 * a) * PP + m];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      sv[q] = n < N ? dSs[n * PP + m] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) u[a][q] += xv[a] * sv[q];
  }
  for (int n = 0; n < N; ++n) {
    float bv[4], sv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) bv[a] = Bs[(ty + 16 * a) * NP + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = tx + 16 * q;
      sv[q] = m < P ? dSs[n * PP + m] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[a][q] += bv[a] * sv[q];
  }

  T* dxb = static_cast<T*>(p.dx) + b * p.dxs[0] + h * p.dxs[1] + c * p.dxs[2];
  float* ddtb = p.ddt + b * p.ddts[0] + h * p.ddts[1] + c * p.ddts[2];
  float* dcumb = p.dcum + b * p.dcums[0] + h * p.dcums[1] + c * p.dcums[2];
  float* dbh = p.dbh + k.head_chunk * cs * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int rj = ty + 16 * a, j = j0 + rj;
    const bool live = j < cs;
    const float e = live ? expf(cum_end - cum_j[rj]) : 0.f;
    const float coef = e * dt_j[rj];
    float bu = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      bu += (n < N ? Bs[rj * NP + n] : 0.f) * u[a][q];
    }
    bu = tx_sum(bu);
    const float col = tx_sum(csum[a]);
    const float ddt = tx_sum(dd[a]);
    const float qj = coef * bu;
    if (tx == 0) qv[rj] = live ? qj : 0.f;
    if (!live) continue;
    if (tx == 0) {
      ddtb[j * p.ddts[3]] = ddt + e * bu;
      dcumb[j * p.dcums[3]] = -col - qj;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = tx + 16 * q;
      if (m < P) dxb[j * p.dxs[3] + m] = rt::from_f32<T>(adx[a][q] + coef * v[a][q]);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (n < N) dbh[static_cast<long long>(j) * N + n] = adb[a][q] + coef * u[a][q];
    }
  }
  __syncthreads();
  if (tid == 0) {  // the tile's sum in row order
    float t = 0.f;
    for (int r = 0; r < TR; ++r) t += qv[r];
    p.qsum[k.head_chunk * p.tiles + jt] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const int c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const Chunk k = chunk_of<T>(p, b, h, c);
  if (static_cast<int>(blockIdx.x) < p.tiles)
    row_role<T>(p, smem, k, blockIdx.x);
  else
    column_role<T>(p, smem, k, blockIdx.x - p.tiles, b, h, c);
}

// dB and dC: each group's heads summed in head order, converted to T
template <typename T>
__global__ void ssd_bwd_group_sum_kernel(const BwdParams p, int batch) {
  const int groups = p.heads / p.heads_per_group, N = p.N, cs = p.cs, nc = p.n_chunks;
  const long long total = static_cast<long long>(batch) * groups * nc * cs * N;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long r = idx;
    const int n = static_cast<int>(r % N);
    r /= N;
    const int row = static_cast<int>(r % cs);
    r /= cs;
    const int c = static_cast<int>(r % nc);
    r /= nc;
    const int g = static_cast<int>(r % groups);
    const int b = static_cast<int>(r / groups);
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < p.heads_per_group; ++hh) {
      const long long off =
          (((static_cast<long long>(b) * p.heads + g * p.heads_per_group + hh) * nc + c) * cs + row) *
              N + n;
      sb += p.dbh[off];
      sc += p.dch[off];
    }
    static_cast<T*>(p.db)[b * p.dbs[0] + g * p.dbs[1] + c * p.dbs[2] + row * p.dbs[3] + n] =
        rt::from_f32<T>(sb);
    static_cast<T*>(p.dc)[b * p.dcs[0] + g * p.dcs[1] + c * p.dcs[2] + row * p.dcs[3] + n] =
        rt::from_f32<T>(sc);
  }
}

// dcum += rowsum(M), and the tiles' sums of e dt B.u on each chunk's last row
__global__ void ssd_bwd_dcum_kernel(const BwdParams p, int batch) {
  const int cs = p.cs, nc = p.n_chunks;
  const long long total = static_cast<long long>(batch) * p.heads * nc * cs;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long hc = idx / cs;  // (b * heads + h) * chunks + c
    const int i = static_cast<int>(idx - hc * cs);
    const int c = static_cast<int>(hc % nc);
    const int h = static_cast<int>((hc / nc) % p.heads);
    const int b = static_cast<int>(hc / nc / p.heads);
    float v = p.rows[idx];
    if (i == cs - 1)
      for (int t = 0; t < p.tiles; ++t) v += p.qsum[hc * p.tiles + t];
    p.dcum[b * p.dcums[0] + h * p.dcums[1] + c * p.dcums[2] + i * p.dcums[3]] += v;
  }
}

int grid_stride_blocks(long long total) {
  const long long blocks = (total + NT - 1) / NT;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int launch(const BwdParams& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.N, p.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<T><<<dim3(2 * p.tiles, p.n_chunks, batch * p.heads), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = p.heads / p.heads_per_group;
  ssd_bwd_group_sum_kernel<T><<<grid_stride_blocks(batch * groups * p.n_chunks * p.cs * p.N), NT,
                                0, stream>>>(p, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dcum_kernel<<<grid_stride_blocks(static_cast<long long>(batch) * p.heads * p.n_chunks *
                                           p.cs),
                        NT, 0, stream>>>(p, batch);
  return static_cast<int>(cudaGetLastError());
}

void copy_strides(long long* dst, const long long* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

}  // namespace

// Strides are in elements: (batch, head, chunk, row) for x, dt, cum, dy, dx,
// ddt and dcum; (batch, group, chunk, row) for B, C, dB and dC; (batch,
// head, chunk) for dS, whose N x P matrix is contiguous.  Every operand is
// f32 (bf16 goes to ssd_intra_chunk_bwd_tc).  The
// scratch (f32, contiguous): dbh and dch (batch, heads, chunks, cs, N), rows
// (batch, heads, chunks, cs), qsum (batch, heads, chunks, ceil(cs / 64)).
extern "C" int ssd_intra_chunk_bwd(
    const void* x, const void* dt, const void* cum, const void* b, const void* c, const void* dy,
    const void* ds, void* dx, void* ddt, void* dcum, void* db, void* dc, void* dbh, void* dch,
    void* rows, void* qsum, int batch, int heads, int heads_per_group, int n_chunks, int cs, int P,
    int N, const long long* x_strides, const long long* dt_strides, const long long* cum_strides,
    const long long* b_strides, const long long* c_strides, const long long* dy_strides,
    const long long* ds_strides, const long long* dx_strides, const long long* ddt_strides,
    const long long* dcum_strides, const long long* db_strides, const long long* dc_strides,
    int dtype, void* stream) {
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || cs < 1 || heads < 1 || heads_per_group < 1 ||
      heads % heads_per_group != 0 || n_chunks < 1 || n_chunks > 65535 || batch < 1 ||
      static_cast<long long>(batch) * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.cum = static_cast<const float*>(cum);
  p.bm = b;
  p.cm = c;
  p.dy = static_cast<const float*>(dy);
  p.ds = static_cast<const float*>(ds);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dcum = static_cast<float*>(dcum);
  p.db = db;
  p.dc = dc;
  p.dbh = static_cast<float*>(dbh);
  p.dch = static_cast<float*>(dch);
  p.rows = static_cast<float*>(rows);
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
  copy_strides(p.dys, dy_strides, 4);
  copy_strides(p.dss, ds_strides, 3);
  copy_strides(p.dxs, dx_strides, 4);
  copy_strides(p.ddts, ddt_strides, 4);
  copy_strides(p.dcums, dcum_strides, 4);
  copy_strides(p.dbs, db_strides, 4);
  copy_strides(p.dcs, dc_strides, 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::F32) return launch<float>(p, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
