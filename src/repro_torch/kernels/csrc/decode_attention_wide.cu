// Decode attention, the wide route: head dims above 256.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
//           (body _decode_kernel) for the head dims decode_attention.cu does
//           not take: the Pallas kernel checks only S % block_s, so any Dh
//           and Dv; decode_attention.cu's tiles are templated on a padded
//           head dim of 128 or 256.
// Computes: the function of decode_attention.cu, both of its routes: one
//           query token per sequence against its cache, slot s of sequence
//           b valid where s < min(pos[b] + 1 - slot_offset, S); the partial
//           route (an lse buffer given) writes f32 out normalised within the
//           slice and lse = M + log L (-inf and zeros where the slice holds
//           no valid slot).
// Layout:   the cache in the model's (B, S, KH, D) layout through strides.
//
// Bound: device-memory bytes, as decode_attention.cu.  The same launch plan
// (decode_attention/ops.py::work_list): one block an item of the work list
// of (sequence, 64-slot chunk, KV head), built by every block from pos; a
// sequence that fits one chunk writes its output at once, otherwise each
// chunk writes (m, l, acc) to the workspace and the block taking the last
// ticket of its (sequence, KV head) combines the chunks in chunk order and
// resets the counter.  So decode stays deterministic run to run and each
// sequence's output depends on its own position only.  What changes is the
// width: nothing is held a head-dim wide in shared memory.  Scores are one
// warp a slot, the lanes striding the head dim (the G query heads of the
// group reuse each K row through L1); the chunk's P.V and the combine are
// one thread a column, striding Dv, each summing the chunk's slots (or the
// chunks) in order.  Workspace rows are Dv wide.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int CS = 64;   // cache slots per chunk (decode_attention.cu's)
constexpr int NT = 128;  // threads per block: 4 warps
constexpr int NW = NT / 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;        // T, or float on the partial route
  float* lse;     // (B, H) contiguous: the partial route; null otherwise
  float* ws_acc;  // (B, KH, n_chunks, G, Dv)
  float* ws_ml;   // (B, KH, n_chunks, G, 2): chunk max, chunk sum
  int* tickets;   // (B, KH), 0 between calls
  int B, H, KH, S, Dh, Dv, n_chunks, slot_offset;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
};

template <typename T>
__device__ __forceinline__ void store_out(const Params& p, long long i, float x) {
  if (p.lse != nullptr)
    static_cast<float*>(p.o)[i] = x;
  else
    static_cast<T*>(p.o)[i] = rt::from_f32<T>(x);
}

__device__ __forceinline__ int valid_slots(const Params& p, int b) {
  return min(p.pos[b] + 1 - p.slot_offset, p.S);
}

size_t smem_bytes(int G, int n_chunks, int B) {
  return sizeof(float) * (static_cast<size_t>(G) * (CS + 2) + n_chunks) + sizeof(int) * (static_cast<size_t>(B) + 1);
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_wide_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ int is_last;
  const int G = p.H / p.KH;
  float* ps = smem;              // G x CS: scores, then probabilities
  float* ml = ps + G * CS;       // G x 2: the chunk's (m, l), then the combined (M, L)
  float* sc = ml + 2 * G;        // n_chunks: exp(m_c - M) of the combine
  int* first = reinterpret_cast<int*>(sc + p.n_chunks);  // B + 1: first item of each sequence
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the work list, as decode_attention.cu builds it
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
  if (item >= first[p.B]) return;
  int b = 0;
  while (first[b + 1] <= item) ++b;
  const int c = (item - first[b]) / p.KH, kh = item - first[b] - c * p.KH;
  const int n_valid = valid_slots(p, b);
  const int nc = n_valid > 0 ? (n_valid + CS - 1) / CS : 0;
  const long long ob = b * p.o_sb + kh * G * p.o_sh;
  float* lse = p.lse != nullptr ? p.lse + static_cast<long long>(b) * p.H + kh * G : nullptr;
  if (nc == 0) {
    for (int i = tid; i < G * p.Dv; i += NT) store_out<T>(p, ob + (i / p.Dv) * p.o_sh + i % p.Dv, 0.f);
    if (lse != nullptr && tid < G) lse[tid] = -__int_as_float(0x7f800000);
    return;
  }
  const int s0 = c * CS, ns = min(CS, n_valid - s0);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh + s0 * p.k_ss;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh + s0 * p.v_ss;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kh * G * p.q_sh;

  // scores: warp w takes slots w, w + 4, ...; lanes stride the head dim
  for (int j = warp; j < ns; j += NW) {
    const T* krow = kb + j * p.k_ss;
    for (int g = 0; g < G; ++g) {
      const T* qrow = qb + g * p.q_sh;
      float part = 0.f;
      for (int d = lane; d < p.Dh; d += 32) part += rt::to_f32(qrow[d]) * rt::to_f32(krow[d]);
      part = rt::warp_sum(part);
      if (lane == 0) ps[g * CS + j] = part * p.scale;
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
  __syncthreads();

  // unnormalised chunk output: a thread a column, the slots in order
  const long long row = (static_cast<long long>(b) * p.KH + kh) * p.n_chunks + c;
  for (int g = 0; g < G; ++g) {
    for (int d = tid; d < p.Dv; d += NT) {
      float s = 0.f;
      for (int j = 0; j < ns; ++j) s += ps[g * CS + j] * rt::to_f32(vb[j * p.v_ss + d]);
      if (nc == 1)
        store_out<T>(p, ob + g * p.o_sh + d, s / fmaxf(ml[2 * g + 1], 1e-30f));
      else
        p.ws_acc[(row * G + g) * p.Dv + d] = s;
    }
  }
  if (nc == 1) {
    if (lse != nullptr && tid < G) lse[tid] = ml[2 * tid] + logf(ml[2 * tid + 1]);
    return;
  }
  for (int i = tid; i < 2 * G; i += NT) p.ws_ml[row * G * 2 + i] = ml[i];

  // the last chunk of (b, kh) to finish combines them all, in chunk order
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
    for (int d = tid; d < p.Dv; d += NT) {
      float s = 0.f;
      for (int k = 0; k < nc; ++k) s += sc[k] * __ldcg(p.ws_acc + ((row0 + k) * G + g) * p.Dv + d);
      store_out<T>(p, ob + g * p.o_sh + d, s / fmaxf(ml[2 * g + 1], 1e-30f));
    }
    if (lse != nullptr && tid == 0) lse[g] = ml[2 * g] + logf(ml[2 * g + 1]);
    __syncthreads();
  }
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.H / p.KH, p.n_chunks, p.B);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(decode_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned items = static_cast<unsigned>(p.B) * p.KH * p.n_chunks;
  decode_wide_kernel<T><<<items, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of decode_attention_fwd (decode_attention.cu), any head
// dims.  The workspace holds B*KH*n_chunks*G*(Dv + 2) floats; tickets as
// decode_attention_fwd's.
extern "C" int decode_attention_wide_fwd(const void* q, const void* k, const void* v, const int* pos, void* o,
                                         float* lse, float* ws, int* tickets, int B, int H, int KH, int S,
                                         int Dh, int Dv, int n_chunks, int slot_offset,
                                         const long long* q_strides, const long long* k_strides,
                                         const long long* v_strides, const long long* o_strides, float scale,
                                         int dtype, void* stream) {
  if (Dh < 1 || Dv < 1 || KH <= 0 || H % KH != 0 || n_chunks * CS < S ||
      static_cast<long long>(B) * KH * n_chunks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos = pos;
  p.o = o;
  p.lse = lse;
  const long long n_rows = static_cast<long long>(B) * KH * n_chunks * (H / KH);
  p.ws_acc = ws;
  p.ws_ml = ws + n_rows * Dv;
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
