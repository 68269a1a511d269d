// Shared pieces of the photonic W8A8 MVM kernels for Hopper (sm_90a).
//
// The TIA rescale `rescale` is the one place the integer product becomes a
// float: every MVM kernel uses it (`photonic_mvm_fused.cu`,
// `photonic_mvm_split.cu`, `photonic_mvm_resident.cu`), so the split
// pipeline's float32 output cast to the activation dtype equals the fused
// kernel's output bit for bit, and each stream of the reuse-resident
// kernel equals the split output.
//
// `mainloop` is the split (K, N) kernel's CUDA-core loop: one block
// computes a BM x BN output tile over a K range as an exact int32 product
// with `__dp4a`.  The activation tile is filled by the caller's loader; the
// (K, N) per-column bank is transposed byte-wise on its way into shared
// memory, Bs[n][k/4], so the inner loop reads 4 consecutive k of one
// output channel as one 32-bit word.

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

// Fill Bs[c][kw] (c < BN output channels from n0, kw < BKW words from k0)
// from the (K, N) bank, transposed byte-wise.
__device__ __forceinline__ void load_w_tile(int32_t (*Bs)[BKW + 1],
                                            const int8_t* __restrict__ w,
                                            int n0, int k0, int k_end, int N,
                                            bool vec) {
  const int tid = threadIdx.x;
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

// acc[i][j] += sum over the k range of A[m0 + ty + 16 i][k] * W[k][n0 + tx + 16 j].
// `load_a(As, k0, k_end)` fills As[r][kw] (r < 16 TM rows from m0) with four
// int8 activations per word, zero past k_end and past the last row.
template <int TM, typename LoadA>
__device__ __forceinline__ void mainloop(LoadA load_a,
                                         const int8_t* __restrict__ w,
                                         int n0, int k_begin, int k_end,
                                         int N, int32_t (&acc)[TM][8]) {
  constexpr int BM = 16 * TM;
  __shared__ int32_t As[BM][BKW + 1];
  __shared__ int32_t Bs[BN][BKW + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = (reinterpret_cast<uintptr_t>(w) % 4 == 0) && (N % 4 == 0);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_a(As, k0, k_end);
    load_w_tile(Bs, w, n0, k0, k_end, N, vec);
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
