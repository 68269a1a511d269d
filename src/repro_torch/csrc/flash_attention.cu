// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_kernel`): attention over flattened heads with fp32
// running max / sum / accumulator, so the Sq x L score matrix never reaches
// device memory.  Same layout contract as the reference:
//   q (BH_q, Sq, hd), k (BH_kv, L, hd), v (BH_kv, L, hd_v); query row b
//   reads kv row b / G (GQA, G = BH_q / BH_kv); hd_v may differ from hd.
// The causal mask runs on absolute positions: query i sits at q_offset + i,
// keys at 0..L-1, and keys at or past kv_len are masked.  Unlike the
// reference (static kv_len), q_offset and kv_len are run-time arguments.
// Masked scores take the reference's finite NEG_INF = -1e30.
//
// What bounds it on an H100.  A 2048-long causal prefill does ~2*Sq*L*hd
// FLOPs per head for QK^T and PV over the lower triangle against a few MB
// of q/k/v, so it is bound by arithmetic.  This first version runs the
// products on the fp32 CUDA cores (67 TFLOP/s peak), not the tensor cores
// (989 TFLOP/s bf16): `mma.sync`/`wgmma` tiles are later work.
//
// Design.  One block per (query row b, 64-query tile), 128 threads: two
// threads per query row, each owning half of the head dims (interleaved in
// float4 groups so the pair reads neighbouring shared-memory words).  The
// block walks 32-key tiles of K and V staged in shared memory as fp32, and
// updates the online softmax per 16-key chunk.
//   * The key loop stops at the last key any row of the tile can see
//     (min(kv_len, q_offset + last row + 1) when causal): fully masked
//     blocks are skipped as in the reference.
//   * Keys past that end are staged as zeros and masked keys get p = 0, so
//     garbage in a capacity buffer beyond q_offset + C (chunked prefill)
//     never enters m, l or the accumulator, even if it is not finite.
//     Key 0 is always visible to every row, so for every row the first
//     chunk sets a finite running max, exactly as in the reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 32;         // keys per shared-memory tile
constexpr int CHUNK = 16;       // keys per online-softmax update
constexpr int THREADS = 2 * BQ; // two threads per query row
constexpr int MAXD = 128;       // largest hd / hd_v
constexpr int G4 = MAXD / 8;    // float4 groups per thread (half the dims)
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dim owned by this thread's float4 group g (half h): groups interleave.
__device__ __forceinline__ int dim_of(int g, int h) { return (2 * g + h) * 4; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int L,
             int hd, int hdv, int G, float scale, int q_offset, int kv_len,
             int causal) {
  __shared__ __align__(16) float Ks[BKV][MAXD];
  __shared__ __align__(16) float Vs[BKV][MAXD];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 1, h = tid & 1;
  const int qi = blockIdx.x * BQ + r;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;
  const int kvb = b / G;

  float4 qreg[G4], acc[G4];
  const T* qrow = q + (static_cast<size_t>(b) * Sq + (row_ok ? qi : 0)) * hd;
#pragma unroll
  for (int g = 0; g < G4; ++g) {
    const int d = dim_of(g, h);
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = (row_ok && d + e < hd) ? to_f<T>(qrow[d + e]) : 0.f;
    qreg[g] = make_float4(t[0], t[1], t[2], t[3]);
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  const int last_row = min(Sq, (blockIdx.x + 1) * BQ) - 1;
  int kend = min(kv_len, L);
  if (causal) kend = min(kend, q_offset + last_row + 1);

  const T* kbase = k + static_cast<size_t>(kvb) * L * hd;
  const T* vbase = v + static_cast<size_t>(kvb) * L * hdv;
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();
    for (int idx = tid; idx < BKV * MAXD; idx += THREADS) {
      const int j = idx / MAXD, d = idx % MAXD, kj = k0 + j;
      const bool in = kj < kend;
      Ks[j][d] = (in && d < hd) ? to_f<T>(kbase[static_cast<size_t>(kj) * hd + d]) : 0.f;
      Vs[j][d] = (in && d < hdv) ? to_f<T>(vbase[static_cast<size_t>(kj) * hdv + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < BKV; c += CHUNK) {
      float s[CHUNK];
      float cmax = NEG_INF;
      unsigned ok = 0;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float4* krow = reinterpret_cast<const float4*>(&Ks[c + j][0]);
        float dot = 0.f;
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 kv4 = krow[2 * g + h];
          dot += qreg[g].x * kv4.x + qreg[g].y * kv4.y + qreg[g].z * kv4.z + qreg[g].w * kv4.w;
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const int kj = k0 + c + j;
        const bool vis = kj < kend && kj < kv_len && (!causal || qpos >= kj);
        s[j] = vis ? dot * scale : NEG_INF;
        ok |= static_cast<unsigned>(vis) << j;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        s[j] = ((ok >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        acc[g].x *= alpha; acc[g].y *= alpha; acc[g].z *= alpha; acc[g].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float p = s[j];
        const float4* vrow = reinterpret_cast<const float4*>(&Vs[c + j][0]);
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 v4 = vrow[2 * g + h];
          acc[g].x += p * v4.x; acc[g].y += p * v4.y;
          acc[g].z += p * v4.z; acc[g].w += p * v4.w;
        }
      }
      m = m_new;
    }
  }

  if (!row_ok) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = o + (static_cast<size_t>(b) * Sq + qi) * hdv;
#pragma unroll
  for (int g = 0; g < G4; ++g) {
    const int d = dim_of(g, h);
    const float t[4] = {acc[g].x, acc[g].y, acc[g].z, acc[g].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < hdv) orow[d + e] = from_f<T>(t[e] * inv);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() (0 = ok).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int BHq, int BHkv, int Sq, int L, int hd,
                    int hdv, float scale, int q_offset, int kv_len, int causal,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = BHq / BHkv;
  dim3 grid((Sq + BQ - 1) / BQ, BHq);
  if (dtype == 0)
    flash_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, L, hd, hdv,
        G, scale, q_offset, kv_len, causal);
  else
    flash_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        Sq, L, hd, hdv, G, scale, q_offset, kv_len, causal);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
