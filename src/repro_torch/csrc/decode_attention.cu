// Decode attention for Hopper (sm_90a): one query token a row against its
// past-only KV cache plus the new token's K/V, with a reduction order that
// depends on no other row and on no other head.
//
// Replaces no TPU kernel.  The reference's decode attention is an einsum
// chain (src/repro/models/attention.py:202 `_attend_decode`), and so was the
// port's: on the card cuBLAS picks each einsum's reduction order from the
// whole call's shapes, so a row's output moved with the batch size and with
// the head count (a rank holding one row, or its own KV heads, got other
// bits than the unsharded step).  This kernel computes the same function:
//   q (B, 1, H, hd) against the cache ck / cv (B, L, KV, hd) and the new
//   token's k / v (B, 1, KV, hd), held apart; cache position l of row b is
//   seen when offset + l < pos[b] (pos per row, or one for all, read from
//   device memory, so a captured CUDA graph replays with new positions);
//   float32 scores scaled by `scale`, a softmax over the seen positions and
//   the new token; the cache part's probabilities rounded to the cache
//   dtype and the new token's to q's dtype before their V products; float32
//   sums; the output in q's dtype.  G = H / KV query heads share a KV head.
//
// What bounds it on an H100.  Each seen K and V row is read once and used
// for 2 * G * hd operations: at minitron-4b's serving shape (G 3, hd 128,
// bf16) that is 1.5 operations a byte, far under the card's ridge, so the
// bytes of the seen cache rows bound it (3.35 TB/s).
//
// Design.  Two launches on the caller's stream, no atomics:
//   * the chunk pass: one block per (chunk of CHUNK positions, KV head,
//     row), 256 threads.  A block past the row's seen positions returns at
//     once, so the work follows pos, not L.  The block keeps its G query
//     heads in shared memory; each warp scores positions (lane j holds
//     elements j, j + 32, ... of the K row, read once for all G heads,
//     summed in that order, then a butterfly over the lanes), then one warp
//     a head takes the chunk's max and exp(s - max) and their sum (lanes
//     strided over the positions, a butterfly), and each thread owns one
//     (head, channel) of the unnormalised P V sum over the chunk's
//     positions in order.  It writes (max, sum, P V) per (row, head, chunk)
//     to a float32 workspace.
//   * the combine pass: one block per (head, row) joins the row's chunks in
//     chunk order with the new token: global max, rescaled sums, and the
//     output; or, in partial mode, the (max, sum, unnormalised P V) over the
//     positions it was given, the new token's term counted only when the
//     caller asks, for a caller that joins pieces of the cache held
//     elsewhere (the sequence-split cache of a mesh).
// Every sum above runs in an order fixed by hd, CHUNK and the row's own
// seen length: a row's bits do not depend on B, H, KV or the other rows,
// and a call on a subset of the KV heads (with their query heads) gives
// those heads' bits of the whole call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;        // positions a chunk block scores
constexpr int THREADS = 256;     // chunk block
constexpr int WARPS = THREADS / 32;
constexpr int COMBINE_THREADS = 128;
constexpr int MAX_HD = 256;
constexpr int MAX_G = 16;        // query heads a KV head serves
constexpr int PER_LANE = MAX_HD / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;          // (B, H, hd) contiguous
  const void* ck;         // row b, position l, head k at b*sbk + l*slk + k*hd
  const void* cv;         // the same with sbv, slv
  const void* kn;         // (B, KV, hd) contiguous
  const void* vn;
  const long long* pos;   // pos[b * pos_stride]
  int pos_stride;
  int B, L, H, KV, G, hd, nchunks;
  long long sbk, slk, sbv, slv;
  float scale;
  long long offset;       // the global position of cache row 0
  int partial, with_new;
  float* ws_m;            // (B, H, nchunks)
  float* ws_l;
  float* ws_o;            // (B, H, nchunks, hd)
  void* out;              // (B, H, hd): T, or float32 in partial mode
  float* m_out;           // (B, H), partial mode
  float* l_out;
};

// cache rows of row b that the query sees
__device__ __forceinline__ int seen(const Args& a, int b) {
  long long p = a.pos[static_cast<long long>(b) * a.pos_stride] - a.offset;
  p = p < 0 ? 0 : p;
  return static_cast<int>(p > a.L ? a.L : p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q . k over hd: lane j sums elements j, j + 32, ... in order, then the
// butterfly; every lane returns the total
template <typename T>
__device__ __forceinline__ float lane_dot(const float* qrow, const T* krow,
                                          int hd, int lane) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int d = lane + 32 * j;
    if (d < hd) s = fmaf(qrow[d], to_f(krow[d]), s);
  }
  return warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_chunk_kernel(const Args a) {
  const int c = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int n_seen = seen(a, b);
  const int start = c * CHUNK;
  if (start >= n_seen) return;
  const int n = min(CHUNK, n_seen - start);
  const int G = a.G, hd = a.hd;
  __shared__ float qs[MAX_G][MAX_HD];
  __shared__ float ps[MAX_G][CHUNK];
  const T* q = static_cast<const T*>(a.q) +
               (static_cast<long long>(b) * a.H + static_cast<long long>(k) * G) *
                   hd;
  for (int i = threadIdx.x; i < G * hd; i += THREADS)
    qs[i / hd][i % hd] = to_f(q[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kbase = static_cast<const T*>(a.ck) +
                   static_cast<long long>(b) * a.sbk +
                   static_cast<long long>(k) * hd;
#pragma unroll 4
  for (int i = warp; i < n; i += WARPS) {
    const T* krow = kbase + static_cast<long long>(start + i) * a.slk;
    float kr[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int d = lane + 32 * j;
      kr[j] = d < hd ? to_f(krow[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) s = fmaf(qs[g][d], kr[j], s);
      }
      s = warp_sum(s);
      if (lane == 0) ps[g][i] = s * a.scale;
    }
  }
  __syncthreads();

  const long long head0 = static_cast<long long>(b) * a.H +
                          static_cast<long long>(k) * G;
  for (int g = warp; g < G; g += WARPS) {
    float m = NEG_INF;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, ps[g][i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(ps[g][i] - m);
      ps[g][i] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const long long idx = (head0 + g) * a.nchunks + c;
      a.ws_m[idx] = m;
      a.ws_l[idx] = l;
    }
  }
  __syncthreads();

  const T* vbase = static_cast<const T*>(a.cv) +
                   static_cast<long long>(b) * a.sbv +
                   static_cast<long long>(k) * hd +
                   static_cast<long long>(start) * a.slv;
  for (int t = threadIdx.x; t < G * hd; t += THREADS) {
    const int g = t / hd, d = t % hd;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i)
      acc = fmaf(round_as<T>(ps[g][i]),
                 to_f(vbase[static_cast<long long>(i) * a.slv + d]), acc);
    a.ws_o[((head0 + g) * a.nchunks + c) * hd + d] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    decode_combine_kernel(const Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int k = h / a.G, hd = a.hd;
  const int nch = (seen(a, b) + CHUNK - 1) / CHUNK;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const long long base = bh * a.nchunks;
  const bool full = a.partial == 0;
  const bool with_new = full || a.with_new != 0;
  const T* vn = static_cast<const T*>(a.vn) +
                (static_cast<long long>(b) * a.KV + k) * hd;
  __shared__ float qs[MAX_HD];
  __shared__ float s_new;
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS)
    qs[d] = to_f(static_cast<const T*>(a.q)[bh * hd + d]);
  __syncthreads();
  if (with_new && threadIdx.x < 32) {
    const T* kn = static_cast<const T*>(a.kn) +
                  (static_cast<long long>(b) * a.KV + k) * hd;
    const float s = lane_dot(qs, kn, hd, threadIdx.x);
    if (threadIdx.x == 0) s_new = s * a.scale;
  }
  __syncthreads();
  float M = with_new ? s_new : NEG_INF;
  for (int c = 0; c < nch; ++c) M = fmaxf(M, a.ws_m[base + c]);
  float S = 0.f;
  for (int c = 0; c < nch; ++c) S += a.ws_l[base + c] * expf(a.ws_m[base + c] - M);
  const float e_new = with_new ? expf(s_new - M) : 0.f;
  S += e_new;
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS) {
    float o = 0.f;
    for (int c = 0; c < nch; ++c)
      o = fmaf(a.ws_o[(base + c) * hd + d], expf(a.ws_m[base + c] - M), o);
    const float v = to_f(vn[d]);
    if (full) {
      static_cast<T*>(a.out)[bh * hd + d] =
          from_f<T>(o / S + round_as<T>(e_new / S) * v);
    } else {
      if (with_new) o += round_as<T>(e_new) * v;
      static_cast<float*>(a.out)[bh * hd + d] = o;
    }
  }
  if (!full && threadIdx.x == 0) {
    a.m_out[bh] = M;
    a.l_out[bh] = S;
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (a.nchunks > 0) {
    decode_chunk_kernel<T><<<dim3(a.nchunks, a.KV, a.B), THREADS, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  decode_combine_kernel<T><<<dim3(a.H, a.B), COMBINE_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, ck, cv, kn, vn alike).  q (B, H, hd),
// kn / vn (B, KV, hd) contiguous; ck / cv: (B, L, KV, hd) with element
// strides (sbk, slk) / (sbv, slv) over rows and positions, heads and
// channels contiguous.  pos: int64 on the device, read at b * pos_stride.
// ws_m / ws_l (B, H, nchunks) and ws_o (B, H, nchunks, hd) float32 with
// nchunks = ceil(L / 64).  Full mode (partial 0): out (B, H, hd) in the
// dtype.  Partial mode: out (B, H, hd), m_out and l_out (B, H) float32, the
// new token counted when with_new.  hd <= 256, H / KV <= 16 (checked by the
// caller).  Returns the launches' error.
int decode_attention(const void* q, const void* ck, const void* cv,
                     const void* kn, const void* vn, const long long* pos,
                     int pos_stride, int dtype, int B, int L, int H, int KV,
                     int hd, long long sbk, long long slk, long long sbv,
                     long long slv, float scale, long long offset,
                     int partial, int with_new, void* ws_m, void* ws_l,
                     void* ws_o, void* out, void* m_out, void* l_out,
                     void* stream) {
  Args a;
  a.q = q;
  a.ck = ck;
  a.cv = cv;
  a.kn = kn;
  a.vn = vn;
  a.pos = pos;
  a.pos_stride = pos_stride;
  a.B = B;
  a.L = L;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.hd = hd;
  a.nchunks = (L + CHUNK - 1) / CHUNK;
  a.sbk = sbk;
  a.slk = slk;
  a.sbv = sbv;
  a.slv = slv;
  a.scale = scale;
  a.offset = offset;
  a.partial = partial;
  a.with_new = with_new;
  a.ws_m = static_cast<float*>(ws_m);
  a.ws_l = static_cast<float*>(ws_l);
  a.ws_o = static_cast<float*>(ws_o);
  a.out = out;
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch<float>(a, st)
                                   : launch<__nv_bfloat16>(a, st);
  return static_cast<int>(e);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
