// Fused photonic W8A8 MVM for Hopper (sm_90a).
//
// Replaces the TPU kernel `photonic_mvm_fused` (src/repro/kernels/
// photonic_mvm.py, `_kernel_fused` + the scalar-prefetched output index map):
// A8 quantization of floating activations in the prologue, the offset-
// decomposed MVM of paper eq. 6, and the blend epilogue (bias, relu/silu,
// blocked output shuffle) in one pass.
//
// Arithmetic.  The TPU kernel accumulates q(x) . W' with W' = wq/254 + 1/2
// in fp32 next to the offset row sum(q(x)) and recomposes
// y = 2 (q.W' - sum(q)/2) s_x s_w.  Algebraically that is s_x s_w / 127 times
// the exact integer product sum_k q(x)[k] wq[k, n] — the W0 decomposition
// in integer form — so this kernel accumulates q(x) . wq in int32 with
// `__dp4a` (exact, order-independent) and recomposes
// y = float(acc) * (s_x * s_w[n]) / 127.  The plain PyTorch version beside
// it (`kernels/photonic_mvm.py`) keeps the reference's fp32 decomposition;
// the two differ only by that fp32 rounding.  The quantizer matches the
// reference bit for bit: the divide runs in the input dtype (bf16 inputs
// round to the bf16 grid), then round-half-to-even (`rintf`) and clamp to
// [-128, 127].
//
// What bounds it on an H100.  At decode widths (M = 2..8 rows) the work is
// a matrix-vector product: every int8 weight byte is read once for a few
// MACs, so the kernel is bound by device-memory bytes (e.g. 28.3 MB for a
// 3072 x 9216 bank: >= 8.4 us at 3.35 TB/s).  At prefill widths (M up to
// ~2048) it is bound by integer operations.
//
// Design.  One block computes a BM x 128 output tile over a K range:
//   * BM = 16 for M <= 16 (decode) and 128 otherwise, so decode does not
//     waste 8x the MACs of a 128-row tile;
//   * split-K (grid.z) gives decode-width calls enough blocks to keep the
//     memory system busy: each split writes int32 partial sums to a
//     workspace and a second small kernel adds them (integer adds: the
//     result does not depend on the split) and runs the epilogue.  With a
//     single split the epilogue runs in the first kernel;
//   * both OBU orientations: the (N, K) per-row bank (transposed use) is
//     copied word-wise into shared memory, the (K, N) per-column bank is
//     transposed byte-wise on its way into shared memory, so the inner loop
//     always reads 4 consecutive k of one output channel as one 32-bit word;
//   * the blocked output shuffle writes computed column n of block j to
//     inv_perm[j] * block + n % block; the bias is read at that output
//     position.
// Tensor cores (s8 `mma.sync` / `wgmma`), TMA and a pipelined shared-memory
// ring are later work; this kernel is the simple, exact first version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;         // output columns per block
constexpr int BK = 64;          // int8 reduction depth per shared-memory stage
constexpr int BKW = BK / 4;     // 32-bit words per stage row
constexpr int THREADS = 256;    // 16 x 16 threads; each owns TM x 8 outputs

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2 };

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

// A8 grid at the per-tensor scale: divide in the input dtype, round half to
// even, clamp.  `s_t` is the scale already rounded to the input dtype.
template <typename T>
__device__ __forceinline__ int quantize(T x, float s_t) {
  float d = to_f<T>(from_f<T>(to_f<T>(x) / s_t));
  d = fminf(fmaxf(rintf(d), -128.f), 127.f);
  return static_cast<int>(d);
}

// TIA rescale + blend epilogue for one output element (computed column n).
template <typename T>
__device__ __forceinline__ void epilogue(int32_t acc, int m, int n, int N,
                                         float sx, const float* __restrict__ sw,
                                         const T* __restrict__ bias,
                                         const int* __restrict__ inv_perm,
                                         int block, int act, T* __restrict__ out) {
  float y = static_cast<float>(acc) * (sx * sw[n]) / 127.0f;
  int o = n;
  if (inv_perm != nullptr) {
    int j = n / block;
    o = inv_perm[j] * block + (n - j * block);
  }
  T yt = from_f<T>(y);
  if (bias != nullptr) yt = from_f<T>(to_f<T>(yt) + to_f<T>(bias[o]));
  if (act == ACT_RELU) {
    yt = from_f<T>(fmaxf(to_f<T>(yt), 0.f));
  } else if (act == ACT_SILU) {
    // y * 1/(1 + exp(-y)), every op rounded to T: the reference's rounding
    // of y * jax.nn.sigmoid(y) (and of the plain version)
    const float v = to_f<T>(yt);
    const float e = to_f<T>(from_f<T>(expf(-v)));
    const float d = to_f<T>(from_f<T>(1.f + e));
    const float sig = to_f<T>(from_f<T>(1.f / d));
    yt = from_f<T>(v * sig);
  }
  out[static_cast<size_t>(m) * N + o] = yt;
}

template <typename T, bool TRANS, int TM>
__global__ void __launch_bounds__(THREADS)
mvm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sx_ptr, const float* __restrict__ sw,
           const T* __restrict__ bias, const int* __restrict__ inv_perm,
           int block, int act, int M, int K, int N, int k_per_split,
           int32_t* __restrict__ part, T* __restrict__ out) {
  constexpr int BM = 16 * TM;
  __shared__ int32_t As[BM][BKW + 1];
  __shared__ int32_t Bs[BN][BKW + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const float sx = *sx_ptr;
  const float s_t = to_f<T>(from_f<T>(sx));
  const bool vec = (reinterpret_cast<uintptr_t>(w) % 4 == 0) &&
                   ((TRANS ? K : N) % 4 == 0);

  int32_t acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // ---- prologue: quantize a BM x BK activation tile into int8 words
    for (int idx = tid; idx < BM * BKW; idx += THREADS) {
      const int r = idx / BKW, kw = idx % BKW;
      const int m = m0 + r, kb = k0 + kw * 4;
      uint32_t packed = 0;
      if (m < M) {
        const T* src = x + static_cast<size_t>(m) * K;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = (kb + i < k_end) ? quantize<T>(src[kb + i], s_t) : 0;
          packed |= static_cast<uint32_t>(q & 0xff) << (8 * i);
        }
      }
      As[r][kw] = static_cast<int32_t>(packed);
    }
    // ---- weight tile, stored as Bs[n][k/4] in either orientation
    if (TRANS) {
      for (int idx = tid; idx < BN * BKW; idx += THREADS) {
        const int c = idx / BKW, kw = idx % BKW;
        const int n = n0 + c, kb = k0 + kw * 4;
        uint32_t packed = 0;
        if (n < N) {
          const int8_t* src = w + static_cast<size_t>(n) * K + kb;
          if (vec && kb + 4 <= k_end) {
            packed = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (kb + i < k_end)
                packed |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * i);
          }
        }
        Bs[c][kw] = static_cast<int32_t>(packed);
      }
    } else {
      uint8_t* bs8 = reinterpret_cast<uint8_t*>(&Bs[0][0]);
      for (int idx = tid; idx < BK * (BN / 4); idx += THREADS) {
        const int kr = idx / (BN / 4), c4 = idx % (BN / 4);
        const int k = k0 + kr, n = n0 + c4 * 4;
        uint32_t v4 = 0;
        if (k < k_end) {
          const int8_t* src = w + static_cast<size_t>(k) * N + n;
          if (vec && n + 4 <= N) {
            v4 = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (n + i < N)
                v4 |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * i);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bs8[(c4 * 4 + i) * (BKW + 1) * 4 + kr] = static_cast<uint8_t>(v4 >> (8 * i));
      }
    }
    __syncthreads();
    // ---- exact integer product: 4 int8 MACs per __dp4a
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      int32_t a[TM], b[8];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (split) {
        part[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = acc[i][j];
      } else {
        epilogue<T>(acc[i][j], m, n, N, sx, sw, bias, inv_perm, block, act, out);
      }
    }
  }
}

// Split-K finish: add the int32 partials of every split, then the epilogue.
template <typename T>
__global__ void reduce_kernel(const int32_t* __restrict__ part, int ksplit,
                              int M, int N, const float* __restrict__ sx_ptr,
                              const float* __restrict__ sw,
                              const T* __restrict__ bias,
                              const int* __restrict__ inv_perm, int block,
                              int act, T* __restrict__ out) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int32_t s = 0;
  for (int z = 0; z < ksplit; ++z) s += part[static_cast<size_t>(z) * total + idx];
  const int m = static_cast<int>(idx / N), n = static_cast<int>(idx % N);
  epilogue<T>(s, m, n, N, *sx_ptr, sw, bias, inv_perm, block, act, out);
}

template <typename T, bool TRANS, int TM>
void launch_mvm(dim3 grid, cudaStream_t st, const void* x, const void* w,
                const float* sx, const float* sw, const void* bias,
                const int* inv_perm, int block, int act, int M, int K, int N,
                int k_per_split, void* part, void* out) {
  mvm_kernel<T, TRANS, TM><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), sx, sw,
      static_cast<const T*>(bias), inv_perm, block, act, M, K, N, k_per_split,
      static_cast<int32_t*>(part), static_cast<T*>(out));
}

template <typename T>
void launch_all(int trans, int bm, dim3 grid, cudaStream_t st, const void* x,
                const void* w, const float* sx, const float* sw,
                const void* bias, const int* inv_perm, int block, int act,
                int M, int K, int N, int k_per_split, void* part, void* out) {
  if (trans) {
    if (bm == 16)
      launch_mvm<T, true, 1>(grid, st, x, w, sx, sw, bias, inv_perm, block, act, M, K, N, k_per_split, part, out);
    else
      launch_mvm<T, true, 8>(grid, st, x, w, sx, sw, bias, inv_perm, block, act, M, K, N, k_per_split, part, out);
  } else {
    if (bm == 16)
      launch_mvm<T, false, 1>(grid, st, x, w, sx, sw, bias, inv_perm, block, act, M, K, N, k_per_split, part, out);
    else
      launch_mvm<T, false, 8>(grid, st, x, w, sx, sw, bias, inv_perm, block, act, M, K, N, k_per_split, part, out);
  }
  const int ksplit = static_cast<int>(grid.z);
  if (ksplit > 1) {
    const size_t total = static_cast<size_t>(M) * N;
    const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
    reduce_kernel<T><<<blocks, 256, 0, st>>>(
        static_cast<const int32_t*>(part), ksplit, M, N, sx, sw,
        static_cast<const T*>(bias), inv_perm, block, act, static_cast<T*>(out));
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  trans: weight is (N, K) per-row.
// bm: 16 or 128.  k_per_split: multiple of 64; ceil(K / k_per_split) splits,
// which need an int32 workspace of splits * M * N when there is more than one.
// Returns cudaGetLastError() after the launches (0 on success).
int photonic_mvm_fused(const void* x, int dtype, const void* w, int trans,
                       const float* sx, const float* sw, const void* bias,
                       const int* inv_perm, int block, int act, int M, int K,
                       int N, int bm, int k_per_split, void* workspace,
                       void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksplit = (K + k_per_split - 1) / k_per_split;
  dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, ksplit);
  if (dtype == 0)
    launch_all<float>(trans, bm, grid, st, x, w, sx, sw, bias, inv_perm, block, act, M, K, N, k_per_split, workspace, out);
  else
    launch_all<__nv_bfloat16>(trans, bm, grid, st, x, w, sx, sw, bias, inv_perm, block, act, M, K, N, k_per_split, workspace, out);
  return static_cast<int>(cudaGetLastError());
}

const char* photonic_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
