// Shared main loop of the photonic W8A8 MVM kernels for Hopper (sm_90a):
// `photonic_mvm_fused.cu` (A8 quantization in the prologue, blend
// epilogue) and `photonic_mvm_split.cu` (int8 activations in, float32 out).
//
// One block computes a BM x BN output tile over a K range as an exact int32
// product with `__dp4a`.  The activation tile is filled by the caller's
// loader (quantize-on-load or an int8 copy); the weight tile is stored as
// Bs[n][k/4] in either OBU orientation: the (N, K) per-row bank (the
// transposed use) is copied word-wise, the (K, N) per-column bank is
// transposed byte-wise on its way into shared memory, so the inner loop
// always reads 4 consecutive k of one output channel as one 32-bit word.
//
// The TIA rescale `rescale` is the one place the integer product becomes a
// float: both kernels use it, so the split pipeline's float32 output cast to
// the activation dtype equals the fused kernel's output bit for bit.  The
// reuse-resident kernel (`photonic_mvm_resident.cu`) has its own schedule
// but the same rescale, so each of its streams equals the split output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pmvm {

constexpr int BN = 128;         // output columns per block
constexpr int BK = 64;          // int8 reduction depth per shared-memory stage
constexpr int BKW = BK / 4;     // 32-bit words per stage row
constexpr int THREADS = 256;    // 16 x 16 threads; each owns TM x 8 outputs

// y = 2 (q.W' - sum(q)/2) s_x s_w  ==  acc * s_x * s_w / 127 for the exact
// integer product acc = sum_k q[k] wq[k, n] (paper eq. 6 in integer form).
__device__ __forceinline__ float rescale(int32_t acc, float sx, float swn) {
  return static_cast<float>(acc) * (sx * swn) / 127.0f;
}

// Fill Bs[c][kw] (c < BN output channels from n0, kw < BKW words from k0).
template <bool TRANS>
__device__ __forceinline__ void load_w_tile(int32_t (*Bs)[BKW + 1],
                                            const int8_t* __restrict__ w,
                                            int n0, int k0, int k_end, int K,
                                            int N, bool vec) {
  const int tid = threadIdx.x;
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
}

// acc[i][j] += sum over the k range of A[m0 + ty + 16 i][k] * W[k][n0 + tx + 16 j].
// `load_a(As, k0, k_end)` fills As[r][kw] (r < 16 TM rows from m0) with four
// int8 activations per word, zero past k_end and past the last row.
template <bool TRANS, int TM, typename LoadA>
__device__ __forceinline__ void mainloop(LoadA load_a,
                                         const int8_t* __restrict__ w,
                                         int n0, int k_begin, int k_end,
                                         int K, int N,
                                         int32_t (&acc)[TM][8]) {
  constexpr int BM = 16 * TM;
  __shared__ int32_t As[BM][BKW + 1];
  __shared__ int32_t Bs[BN][BKW + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = (reinterpret_cast<uintptr_t>(w) % 4 == 0) &&
                   ((TRANS ? K : N) % 4 == 0);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_a(As, k0, k_end);
    load_w_tile<TRANS>(Bs, w, n0, k0, k_end, K, N, vec);
    __syncthreads();
    // exact integer product: 4 int8 MACs per __dp4a
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
}

}  // namespace pmvm
