// Mamba-2 SSD intra-chunk step for Hopper.
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_pallas
//           (body _ssd_kernel).
// Computes: per (batch, head, chunk), in f32 whatever the input type,
//             y_i   = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//             state = sum_j B_j * (exp(cum_last - cum_j) * dt_j) x_j^T      (N x P)
//           with the products in the reference's order.  Any chunk length
//           cs >= 1; head h reads group h / heads_per_group of B and C, so the
//           groups are never expanded to heads in memory.
// Layout:   every operand through strides (batch, head or group, chunk, row)
//           with the last dim contiguous, so the model's (B, L, H, .) tensors
//           are read in place; y and state are f32.
//
// Bound: ~cs^2/2 * (N + P) * 2 flops per chunk against ~cs * (P + 2N) elements
// read, so at cs = 256 the work is bound by operations (f32 here).  Design
// (simple first): the TPU kernel holds a whole 256-row chunk and its 256 x 256
// score tile in VMEM (~0.6 MiB); an SM has 227 KB.  So one block of 256 threads
// owns a 64-row tile of i, keeps its C rows in shared memory, and loops over
// 64-row tiles of j up to its own diagonal only, staging B_j, x_j, dt_j, cum_j:
// score tile (4 x 4 per thread), decay weights, then y_i += W x_j in
// registers.  Tiles above the diagonal are never computed, and inside the
// diagonal tile the masked decay (exp of a positive number, possibly inf) is
// removed by a select, never by a multiply with a 0/1 mask (inf * 0 = NaN).
// One extra block per chunk takes the state role (8 x 4 outputs per thread,
// a loop over 64-row tiles of j).  SIMT f32 FMA; wgmma / TMA are later work.
#include "common.cuh"

namespace {

constexpr int TR = 64;    // rows per tile (i and j)
constexpr int NT = 256;   // threads: 16 (ty) x 16 (tx)
constexpr int PMAX = 64;  // head dim: 4 columns per thread
constexpr int NMAX = 128; // state dim: 8 state rows per thread in the state role

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

size_t smem_bytes(int N, int P) {
  return sizeof(float) * (2 * static_cast<size_t>(TR) * (N + 1) + static_cast<size_t>(TR) * P +
                          static_cast<size_t>(TR) * (TR + 1) + 3 * TR);
}

template <typename T>
__device__ void state_role(const SsdParams& p, float* smem, const T* bb, const T* xb,
                           const float* dtb, const float* cumb, float* st) {
  const int N = p.N, P = p.P, cs = p.cs, NP = N + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float* Bw = smem;          // TR x NP: B_j * wts_j
  float* Xs = Bw + TR * NP;  // TR x P
  float* wts = Xs + TR * P;  // TR
  const float cum_end = cumb[(cs - 1) * p.cums[3]];

  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  for (int j0 = 0; j0 < cs; j0 += TR) {
    __syncthreads();  // previous tile consumed
    if (tid < TR) {
      const int j = j0 + tid;
      wts[tid] = j < cs ? expf(cum_end - cumb[j * p.cums[3]]) * dtb[j * p.dts[3]] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < TR * N; idx += NT) {
      const int r = idx / N, n = idx - r * N, j = j0 + r;
      Bw[r * NP + n] = j < cs ? rt::to_f32(bb[j * p.bs[3] + n]) * wts[r] : 0.f;
    }
    for (int idx = tid; idx < TR * P; idx += NT) {
      const int r = idx / P, q = idx - r * P, j = j0 + r;
      Xs[r * P + q] = j < cs ? rt::to_f32(xb[j * p.xs[3] + q]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < TR; ++jj) {
      float bv[8], xv[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int n = ty + 16 * a;
        bv[a] = n < N ? Bw[jj * NP + n] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = tx + 16 * k;
        xv[k] = q < P ? Xs[jj * P + q] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] += bv[a] * xv[k];
    }
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int n = ty + 16 * a;
    if (n >= N) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tx + 16 * k;
      if (q < P) st[n * P + q] = acc[a][k];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_kernel(const SsdParams p) {
  extern __shared__ float smem[];
  const int N = p.N, P = p.P, cs = p.cs, NP = N + 1;
  const int n_tiles = (cs + TR - 1) / TR;
  const int tile = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.heads, h = bh - b * p.heads, g = h / p.heads_per_group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* xb = static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[1] + c * p.xs[2];
  const T* bb = static_cast<const T*>(p.bm) + b * p.bs[0] + g * p.bs[1] + c * p.bs[2];
  const T* cb = static_cast<const T*>(p.cm) + b * p.cms[0] + g * p.cms[1] + c * p.cms[2];
  const float* dtb = p.dt + b * p.dts[0] + h * p.dts[1] + c * p.dts[2];
  const float* cumb = p.cum + b * p.cums[0] + h * p.cums[1] + c * p.cums[2];

  if (tile == n_tiles) {
    state_role<T>(p, smem, bb, xb, dtb, cumb,
                  p.state + b * p.sts[0] + h * p.sts[1] + c * p.sts[2]);
    return;
  }

  float* Cs = smem;                   // TR x NP: C rows of this i tile
  float* Bs = Cs + TR * NP;           // TR x NP: B rows of the j tile
  float* Xs = Bs + TR * NP;           // TR x P
  float* Ws = Xs + TR * P;            // TR x (TR + 1): decay-weighted scores
  float* cum_i = Ws + TR * (TR + 1);  // TR
  float* cum_j = cum_i + TR;          // TR
  float* dt_j = cum_j + TR;           // TR

  const int i0 = tile * TR;
  for (int idx = tid; idx < TR * N; idx += NT) {
    const int r = idx / N, n = idx - r * N, i = i0 + r;
    Cs[r * NP + n] = i < cs ? rt::to_f32(cb[i * p.cms[3] + n]) : 0.f;
  }
  if (tid < TR) cum_i[tid] = i0 + tid < cs ? cumb[(i0 + tid) * p.cums[3]] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += TR) {  // tiles above the diagonal are skipped
    __syncthreads();  // Cs / cum_i written, previous tile's Bs, Xs, Ws consumed
    for (int idx = tid; idx < TR * N; idx += NT) {
      const int r = idx / N, n = idx - r * N, j = j0 + r;
      Bs[r * NP + n] = j < cs ? rt::to_f32(bb[j * p.bs[3] + n]) : 0.f;
    }
    for (int idx = tid; idx < TR * P; idx += NT) {
      const int r = idx / P, q = idx - r * P, j = j0 + r;
      Xs[r * P + q] = j < cs ? rt::to_f32(xb[j * p.xs[3] + q]) : 0.f;
    }
    if (tid < TR) {
      const int j = j0 + tid;
      cum_j[tid] = j < cs ? cumb[j * p.cums[3]] : 0.f;
      dt_j[tid] = j < cs ? dtb[j * p.dts[3]] : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16a, columns tx + 16k of the tile
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[a][k] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * NP + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = Bs[(tx + 16 * k) * NP + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[a][k] += cv[a] * bv[k];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ri = ty + 16 * a, i = i0 + ri;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int rj = tx + 16 * k, j = j0 + rj;
        // select, not multiply: the decay for i < j may be inf
        Ws[ri * (TR + 1) + rj] = (i >= j && i < cs && j < cs)
                                     ? s[a][k] * expf(cum_i[ri] - cum_j[rj]) * dt_j[rj]
                                     : 0.f;
      }
    }
    __syncthreads();

    // y rows ty + 16a, columns tx + 16k: acc += W x_j
    for (int kk = 0; kk < TR; ++kk) {
      float wv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) wv[a] = Ws[(ty + 16 * a) * (TR + 1) + kk];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = tx + 16 * k;
        xv[k] = q < P ? Xs[kk * P + q] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] += wv[a] * xv[k];
    }
  }

  float* yb = p.y + b * p.ys[0] + h * p.ys[1] + c * p.ys[2];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= cs) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tx + 16 * k;
      if (q < P) yb[i * p.ys[3] + q] = acc[a][k];
    }
  }
}

template <typename T>
int launch(const SsdParams& p, int batch, int n_chunks, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.N, p.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: the i tiles, then one block in the state role
  const dim3 grid((p.cs + TR - 1) / TR + 1, n_chunks, batch * p.heads);
  ssd_chunk_kernel<T><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

void copy_strides(long long* dst, const long long* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

}  // namespace

// Strides are in elements: (batch, head, chunk, row) for x, dt, cum and y;
// (batch, group, chunk, row) for B and C; (batch, head, chunk) for state,
// whose N x P matrix is contiguous.  x, B and C share one dtype; dt, cum, y
// and state are f32.
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dt, const void* cum, const void* b,
                                   const void* c, void* y, void* state, int batch, int heads,
                                   int heads_per_group, int n_chunks, int cs, int P, int N,
                                   const long long* x_strides, const long long* dt_strides,
                                   const long long* cum_strides, const long long* b_strides,
                                   const long long* c_strides, const long long* y_strides,
                                   const long long* state_strides, int dtype, void* stream) {
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || cs < 1 || heads < 1 || heads_per_group < 1 ||
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16) return launch<__nv_bfloat16>(p, batch, n_chunks, st);
  if (dtype == rt::F32) return launch<float>(p, batch, n_chunks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
