// Decode attention (flash-decoding) for Hopper.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
//           (body _decode_kernel).
// Computes: one query token per sequence against its KV cache; the G = H / KH
//           query heads of a group share each K/V row; softmax in f32,
//           l clamped at 1e-30.  Unlike the TPU kernel's scalar pos, pos is a
//           (B,) int32 device tensor: slot s of sequence b is valid where
//           s < min(pos[b] + 1, S).  That one rule is both the full-cache rule
//           (s <= pos[b]) and the ring-window rule, so the ring window needs
//           no flag here (only the writer folds pos % S).
// Layout:   the cache stays in the model's (B, S, KH, D) layout and is read
//           through strides: no transpose per decode step.
// Partial route (a cache slice, for a sequence-sharded cache): the S slots
//           given are global slots [slot_offset, slot_offset + S), valid
//           where slot_offset + s < pos[b] + 1.  Given an lse buffer, the
//           kernel writes out in f32, normalised within the slice, and
//           lse = M + log L, the log-sum-exp of the slice's scaled scores
//           (-inf and zeros where the slice holds no valid slot), so the
//           slices combine exactly as the chunks of one call do.
//
// Bound: device-memory bytes (each valid K/V row is read once for ~4·G·D
// flops, about one flop per byte at G = 1), so the kernel stays on the SIMT
// cores and is built to keep loads in flight.  One launch:
//   - A work list of (sequence, 64-slot chunk, KV head) items, built by every
//     block from pos: block i takes item i, so the blocks with work come
//     first and those past the list (chunks past some pos[b]) exit at once.
//   - Each block issues every 16-byte copy of its chunk's K rows, then its
//     V rows, at once (cp.async into shared memory): the scores start when K
//     has landed, while V is still in flight.  A block pays about one
//     memory latency, not one per row.
//   - Scores: 16 lanes x 8 elements cover 128 columns of a row, two rows
//     per warp per step; a row of up to 256 takes each lane twice (columns
//     8·lane and 128 + 8·lane, summed in the lane before the shuffles); the
//     G query heads of the group reuse each K row.
//   - The chunk's softmax and P.V (8 row groups x 16 lanes x 8 elements per
//     128 columns, summed across the groups in a fixed order in shared
//     memory).
//   - The kernel is templated on the padded head dim DM = 128 or 256 (the
//     wider of Dh, Dv rounded up; decode_attention_padded_dim): the K / V
//     tiles, the query rows and the workspace rows are DM wide, so a head of
//     128 or less keeps its shared memory and its arithmetic.
//   - A sequence that fits one chunk writes its output at once.  Otherwise
//     each chunk writes its (m, l, acc) to one workspace, and the block that
//     takes the last ticket of its (sequence, KV head) from an atomic
//     counter combines the chunks in chunk order (threads over
//     (chunk group, d), a fixed-order sum in shared memory) and sets the
//     counter back to 0.  So the output is deterministic run to run, and
//     sequence b's depends only on its own q, cache, pos[b] and S: the chunk
//     boundaries are multiples of 64 whatever the batch holds, and which
//     block computes a chunk does not change what it computes.
// A cache whose bases, strides or head dims are not whole 16-byte chunks
// takes the same kernel with element-wise loads into shared memory.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CS = 64;   // cache slots per chunk
constexpr int NT = 128;  // threads per block: 4 warps
constexpr int NW = NT / 32;
constexpr int DMAX = 256;     // the widest head dim taken
constexpr int RG = NT / 16;  // row groups of the P.V and combine passes
constexpr int LANE_COLS = 128;  // columns 16 lanes x 8 elements cover

// the padded head dim of the kernel's tiles and workspace rows
constexpr int padded_dim(int Dh, int Dv) { return Dh <= 128 && Dv <= 128 ? 128 : 256; }

// v[e] = row[d0 + e] as f32, 0 where d0 + e >= D; row is 16-byte aligned
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int d0, int D, float (&v)[8]) {
  if (d0 + 8 <= D) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + d0);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = d0 + e < D ? __bfloat162float(row[d0 + e]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* row, int d0, int D, float (&v)[8]) {
  if (d0 + 8 <= D) {
    const float4 a = *reinterpret_cast<const float4*>(row + d0);
    const float4 b = *reinterpret_cast<const float4*>(row + d0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = d0 + e < D ? row[d0 + e] : 0.f;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&a)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

// rows [s0, s0 + ns) x D of a (B, S, KH, D) cache into `dst` (rows DM apart)
template <typename T, bool VEC16, int DM>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long row_stride, int ns, int D,
                                          int tid) {
  if constexpr (VEC16) {
    constexpr int E = 16 / sizeof(T);  // elements per copy
    const int units = D / E;           // D * sizeof(T) is a multiple of 16 here
    for (int i = tid; i < ns * units; i += NT) {
      const int r = i / units, u = i - r * units;
      hop::cp_async16(hop::smem_addr(dst + r * DM + u * E), src + r * row_stride + u * E, true);
    }
  } else {
    for (int i = tid; i < ns * D; i += NT) {
      const int r = i / D, d = i - r * D;
      dst[r * DM + d] = src[r * row_stride + d];
    }
  }
}

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;        // T, or float on the partial route
  float* lse;     // (B, H) contiguous: the partial route; null otherwise
  float* ws_acc;  // (B, KH, n_chunks, G, DM)
  float* ws_ml;   // (B, KH, n_chunks, G, 2): chunk max, chunk sum
  int* tickets;   // (B, KH), 0 between calls
  int B, H, KH, S, Dh, Dv, n_chunks, slot_offset;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
};

// output element i (an offset in elements): f32 on the partial route
template <typename T>
__device__ __forceinline__ void store_out(const DecodeParams& p, long long i, float x) {
  if (p.lse != nullptr)
    static_cast<float*>(p.o)[i] = x;
  else
    static_cast<T*>(p.o)[i] = rt::from_f32<T>(x);
}

// the slice's valid slots of sequence b (may be <= 0)
__device__ __forceinline__ int valid_slots(const DecodeParams& p, int b) {
  return min(p.pos[b] + 1 - p.slot_offset, p.S);
}

template <typename T, int DM>
constexpr size_t smem_bytes(int G, int n_chunks, int B) {
  return 2 * sizeof(T) * CS * DM +
         sizeof(float) * (static_cast<size_t>(G) * (DM + CS + 2) + n_chunks) +
         sizeof(int) * (static_cast<size_t>(B) + 1);
}

template <typename T, bool VEC16, int DM>
__global__ void __launch_bounds__(NT) decode_kernel(const DecodeParams p) {
  constexpr int NU = DM / LANE_COLS;  // 8-element column groups a lane takes
  extern __shared__ float4 sm4[];
  __shared__ int is_last;
  const int G = p.H / p.KH;
  T* Ks = reinterpret_cast<T*>(sm4);   // CS x DM
  T* Vs = Ks + CS * DM;                // CS x DM
  float* qs = reinterpret_cast<float*>(Vs + CS * DM);  // G x DM
  float* ps = qs + G * DM;             // G x CS: scores, then probabilities
  float* ml = ps + G * CS;             // G x 2: the chunk's (m, l), then the combined (M, L)
  float* sc = ml + 2 * G;              // n_chunks: exp(m_c - M) of the combine
  int* first = reinterpret_cast<int*>(sc + p.n_chunks);  // B + 1: first item of each sequence
  float* red = reinterpret_cast<float*>(Ks);  // RG x DM partial sums, once K is consumed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l16 = tid & 15, d0 = 8 * l16, rg = tid >> 4;  // columns d0 + 128u, u < NU

  // The work list: sequence b has max(nc_b, 1) * KH items (chunk-major,
  // KV head fastest), nc_b = ceil(min(pos[b] + 1, S) / CS).  Block i takes
  // item i; the blocks past the list (chunks past some pos[b]) come last
  // and exit at once.
  for (int b = tid; b < p.B; b += NT) {
    const int n_valid = valid_slots(p, b);
    first[b + 1] = max((n_valid + CS - 1) / CS, 1) * p.KH;
  }
  __syncthreads();
  if (tid == 0) {
    first[0] = 0;
    for (int b = 0; b < p.B; ++b) first[b + 1] += first[b];
  }
  __syncthreads();

  const int item = blockIdx.x;
  if (item >= first[p.B]) return;  // past the work list
  int b = 0;
  while (first[b + 1] <= item) ++b;
  const int c = (item - first[b]) / p.KH, kh = item - first[b] - c * p.KH;
  const int n_valid = valid_slots(p, b);
  const int nc = n_valid > 0 ? (n_valid + CS - 1) / CS : 0;
  const long long ob = b * p.o_sb + kh * G * p.o_sh;  // the group's first output element
  float* lse = p.lse != nullptr ? p.lse + static_cast<long long>(b) * p.H + kh * G : nullptr;
  if (nc == 0) {  // nothing valid (pos < 0, or a slice past pos): zeros, lse -inf
    for (int i = tid; i < G * p.Dv; i += NT) store_out<T>(p, ob + (i / p.Dv) * p.o_sh + i % p.Dv, 0.f);
    if (lse != nullptr && tid < G) lse[tid] = -__int_as_float(0x7f800000);
    return;
  }
  const int s0 = c * CS, ns = min(CS, n_valid - s0);

  // every copy of the chunk in flight at once: K, then V
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh + s0 * p.k_ss;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh + s0 * p.v_ss;
  load_rows<T, VEC16, DM>(Ks, kb, p.k_ss, ns, p.Dh, tid);
  hop::cp_async_commit();
  load_rows<T, VEC16, DM>(Vs, vb, p.v_ss, ns, p.Dv, tid);
  hop::cp_async_commit();
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kh * G * p.q_sh;
  for (int i = tid; i < G * DM; i += NT) {
    const int g = i / DM, d = i - g * DM;
    qs[i] = d < p.Dh ? rt::to_f32(qb[g * p.q_sh + d]) : 0.f;
  }
  hop::cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // scores: half-warp h of warp w takes rows 8 step + 2 w + h
  for (int r0 = 0; r0 < ns; r0 += 2 * NW) {
    const int j = r0 + 2 * warp + (lane >> 4);
    float kv[NU][8];
#pragma unroll
    for (int u = 0; u < NU; ++u) load8(Ks + (j < ns ? j : 0) * DM, d0 + LANE_COLS * u, p.Dh, kv[u]);
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + g * DM + d0 + LANE_COLS * u);
        const float4 qb4 = *reinterpret_cast<const float4*>(qs + g * DM + d0 + LANE_COLS * u + 4);
        part += qa.x * kv[u][0] + qa.y * kv[u][1] + qa.z * kv[u][2] + qa.w * kv[u][3] +
                qb4.x * kv[u][4] + qb4.y * kv[u][5] + qb4.z * kv[u][6] + qb4.w * kv[u][7];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (l16 == 0 && j < ns) ps[g * CS + j] = part * p.scale;
    }
  }
  __syncthreads();

  // the chunk's softmax statistics, one warp per head of the group
  for (int g = warp; g < G; g += NW) {
    float mx = rt::NEG_INF;
    for (int j = lane; j < ns; j += 32) mx = fmaxf(mx, ps[g * CS + j]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < ns; j += 32) {
      const float e = expf(ps[g * CS + j] - mx);
      ps[g * CS + j] = e;
      sum += e;
    }
    sum = rt::warp_sum(sum);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = sum;
    }
  }
  hop::cp_async_wait<0>();
  __syncthreads();

  // unnormalised chunk output: row group rg sums rows rg, rg + 8, ...
  const long long row = (static_cast<long long>(b) * p.KH + kh) * p.n_chunks + c;
  for (int g = 0; g < G; ++g) {
    float a[NU][8] = {};
    for (int j = rg; j < ns; j += RG) {
      const float pj = ps[g * CS + j];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float vv[8];
        load8(Vs + j * DM, d0 + LANE_COLS * u, p.Dv, vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) a[u][e] += pj * vv[e];
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) store8(red + rg * DM + d0 + LANE_COLS * u, a[u]);
    __syncthreads();
    for (int d = tid; d < p.Dv; d += NT) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < RG; ++r) s += red[r * DM + d];
      if (nc == 1)
        store_out<T>(p, ob + g * p.o_sh + d, s / fmaxf(ml[2 * g + 1], 1e-30f));
      else
        p.ws_acc[(row * G + g) * DM + d] = s;
    }
    __syncthreads();
  }
  if (nc == 1) {
    if (lse != nullptr && tid < G) lse[tid] = ml[2 * tid] + logf(ml[2 * tid + 1]);
    return;
  }
  for (int i = tid; i < 2 * G; i += NT) p.ws_ml[row * G * 2 + i] = ml[i];

  // the last chunk of (b, kh) to finish combines them all, in chunk order;
  // the barrier, then one thread's fence, publish every thread's partials
  __syncthreads();
  int* ticket = p.tickets + b * p.KH + kh;
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1) == nc - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long long row0 = (static_cast<long long>(b) * p.KH + kh) * p.n_chunks;
  for (int g = 0; g < G; ++g) {
    if (warp == 0) {
      float M = rt::NEG_INF;
      for (int k = lane; k < nc; k += 32) M = fmaxf(M, __ldcg(p.ws_ml + ((row0 + k) * G + g) * 2));
      M = rt::warp_max(M);
      float L = 0.f;
      for (int k = lane; k < nc; k += 32) {
        const float* mlk = p.ws_ml + ((row0 + k) * G + g) * 2;
        const float w = expf(__ldcg(mlk) - M);
        sc[k] = w;
        L += __ldcg(mlk + 1) * w;
      }
      L = rt::warp_sum(L);
      if (lane == 0) {
        ml[2 * g] = M;
        ml[2 * g + 1] = L;
      }
    }
    __syncthreads();
    float a[NU][8] = {};
    for (int k = rg; k < nc; k += RG) {
      const float w = sc[k];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4* src =
            reinterpret_cast<const float4*>(p.ws_acc + ((row0 + k) * G + g) * DM + d0 + LANE_COLS * u);
        const float4 x0 = __ldcg(src), x1 = __ldcg(src + 1);
        a[u][0] += x0.x * w; a[u][1] += x0.y * w; a[u][2] += x0.z * w; a[u][3] += x0.w * w;
        a[u][4] += x1.x * w; a[u][5] += x1.y * w; a[u][6] += x1.z * w; a[u][7] += x1.w * w;
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) store8(red + rg * DM + d0 + LANE_COLS * u, a[u]);
    __syncthreads();
    for (int d = tid; d < p.Dv; d += NT) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < RG; ++r) s += red[r * DM + d];
      store_out<T>(p, ob + g * p.o_sh + d, s / fmaxf(ml[2 * g + 1], 1e-30f));
    }
    if (lse != nullptr && tid == 0) lse[g] = ml[2 * g] + logf(ml[2 * g + 1]);
    __syncthreads();
  }
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
}

// The 16-byte copies need a 16-byte base, (batch, slot, head) strides and a
// head dim that are whole 16-byte chunks.
bool aligned16(const void* ptr, long long sb, long long ss, long long sh, int d, int size) {
  const long long e = 16 / size;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % e == 0 && ss % e == 0 && sh % e == 0 &&
         d % e == 0;
}

template <typename T, bool VEC16, int DM>
int launch_as(const DecodeParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DM>(p.H / p.KH, p.n_chunks, p.B);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, VEC16, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // one block for each item the work list can hold
  const unsigned items = static_cast<unsigned>(p.B) * p.KH * p.n_chunks;
  decode_kernel<T, VEC16, DM><<<items, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DM>
int launch_dm(const DecodeParams& p, cudaStream_t stream) {
  const int size = sizeof(T);
  const bool vec = aligned16(p.k, p.k_sb, p.k_ss, p.k_sh, p.Dh, size) &&
                   aligned16(p.v, p.v_sb, p.v_ss, p.v_sh, p.Dv, size);
  return vec ? launch_as<T, true, DM>(p, stream) : launch_as<T, false, DM>(p, stream);
}

template <typename T>
int launch(const DecodeParams& p, cudaStream_t stream) {
  return padded_dim(p.Dh, p.Dv) == 128 ? launch_dm<T, 128>(p, stream) : launch_dm<T, 256>(p, stream);
}

}  // namespace

extern "C" int decode_attention_chunk() { return CS; }

// the width of a workspace row (and of the kernel's tiles) for these head dims
extern "C" int decode_attention_padded_dim(int Dh, int Dv) { return padded_dim(Dh, Dv); }

// q strides are (batch, head), cache strides (batch, slot, head), out strides
// (batch, head), all in elements with a contiguous last dim.  With lse (a
// contiguous (B, H) f32 buffer) the call takes the partial route: o is f32,
// and the cache's S slots are the global slots from slot_offset (header).  The workspace
// holds B*KH*n_chunks*G*(DM + 2) floats, DM = decode_attention_padded_dim(Dh,
// Dv); tickets holds B*KH ints that are 0
// before the call and are 0 again after it, so one buffer serves every call
// on one stream.  n_chunks = ceil(S / decode_attention_chunk()).  Head dims
// up to 256.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, const int* pos,
                                    void* o, float* lse, float* ws, int* tickets, int B, int H,
                                    int KH, int S, int Dh, int Dv, int n_chunks, int slot_offset,
                                    const long long* q_strides,
                                    const long long* k_strides, const long long* v_strides,
                                    const long long* o_strides, float scale, int dtype,
                                    void* stream) {
  if (Dh > DMAX || Dv > DMAX || Dh < 1 || Dv < 1 || KH <= 0 || H % KH != 0 ||
      n_chunks * CS < S || static_cast<long long>(B) * KH * n_chunks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos = pos;
  p.o = o;
  p.lse = lse;
  const long long n_rows = static_cast<long long>(B) * KH * n_chunks * (H / KH);
  p.ws_acc = ws;
  p.ws_ml = ws + n_rows * padded_dim(Dh, Dv);
  p.tickets = tickets;
  p.B = B;
  p.H = H;
  p.KH = KH;
  p.S = S;
  p.Dh = Dh;
  p.Dv = Dv;
  p.n_chunks = n_chunks;
  p.slot_offset = slot_offset;
  p.q_sb = q_strides[0];
  p.q_sh = q_strides[1];
  p.k_sb = k_strides[0];
  p.k_ss = k_strides[1];
  p.k_sh = k_strides[2];
  p.v_sb = v_strides[0];
  p.v_ss = v_strides[1];
  p.v_sh = v_strides[2];
  p.o_sb = o_strides[0];
  p.o_sh = o_strides[1];
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16) return launch<__nv_bfloat16>(p, st);
  if (dtype == rt::F32) return launch<float>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
