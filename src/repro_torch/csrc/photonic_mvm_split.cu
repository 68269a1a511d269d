// Split photonic W8A8 MVM for Hopper (sm_90a): int8 activations in,
// float32 out, both OBU orientations.
//
// Replaces the TPU kernels `photonic_mvm` and `photonic_mvm_t`
// (src/repro/kernels/photonic_mvm.py, `_kernel` / `_kernel_t`): the split
// pipeline's MVM, which the comparator `Backend(fused=False)` and the fault
// model (`ops.photonic_matmul_noisy`) run between an A8 quantization pass
// and a separate blend/noise pass.
//
// Arithmetic.  The TPU kernels accumulate q . W' with W' = wq/254 + 1/2 in
// fp32 beside the offset row sum(q) and recompose
// y = 2 (q.W' - sum(q)/2) s_x s_w.  That is s_x s_w / 127 times the exact
// integer product sum_k q[k] wq[k, n], so this kernel accumulates it in
// int32 with `__dp4a` and rescales once with `pmvm::rescale`, the same
// expression as the fused kernel: with noise off, the split pipeline's
// output cast to the activation dtype equals the fused kernel's bit for bit.
// The plain PyTorch version (`kernels/photonic_mvm.py`) keeps the
// reference's fp32 decomposition; the two differ only by its rounding.
//
// What bounds it on an H100.  At decode widths (M = 2..8) every int8 weight
// byte is read once for a few MACs: device-memory bytes (28.3 MB for a
// 3072 x 9216 bank, >= 8.4 us at 3.35 TB/s).  At prefill widths (M ~ 2048)
// integer operations.
//
// Design.  The main loop of the fused kernel (`photonic_mvm_common.cuh`):
// BM x 128 output tiles (BM = 16 for M <= 16, else 128), the (N, K) bank
// copied word-wise and the (K, N) bank transposed byte-wise into shared
// memory, `__dp4a` on 32-bit words.  The int8 activation tile is copied
// word-wise when rows are 4-byte aligned.  Split-K (grid.z) writes int32
// partials that a second kernel adds (integer adds: the split never changes
// the result) before the rescale.  Tensor cores, TMA and pipelining are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "photonic_mvm_common.cuh"

namespace {

using pmvm::BKW;
using pmvm::BN;
using pmvm::THREADS;

template <bool TRANS, int TM>
__global__ void __launch_bounds__(THREADS)
split_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
             const float* __restrict__ sx_ptr, const float* __restrict__ sw,
             int M, int K, int N, int k_per_split,
             int32_t* __restrict__ part, float* __restrict__ out) {
  constexpr int BM = 16 * TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool xvec = (reinterpret_cast<uintptr_t>(xq) % 4 == 0) && (K % 4 == 0);

  auto load_a = [&](int32_t (*As)[BKW + 1], int k0, int kend) {
    for (int idx = threadIdx.x; idx < BM * BKW; idx += THREADS) {
      const int r = idx / BKW, kw = idx % BKW;
      const int m = m0 + r, kb = k0 + kw * 4;
      uint32_t packed = 0;
      if (m < M) {
        const int8_t* src = xq + static_cast<size_t>(m) * K + kb;
        if (xvec && kb + 4 <= kend) {
          packed = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (kb + i < kend)
              packed |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * i);
        }
      }
      As[r][kw] = static_cast<int32_t>(packed);
    }
  };
  int32_t acc[TM][8];
  pmvm::mainloop<TRANS, TM>(load_a, w, n0, k_begin, k_end, K, N, acc);

  const bool split = gridDim.z > 1;
  const float sx = *sx_ptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + n;
      if (split) {
        part[static_cast<size_t>(blockIdx.z) * M * N + o] = acc[i][j];
      } else {
        out[o] = pmvm::rescale(acc[i][j], sx, sw[n]);
      }
    }
  }
}

// Split-K finish: add the int32 partials of every split, then rescale.
__global__ void split_reduce_kernel(const int32_t* __restrict__ part,
                                    int ksplit, int M, int N,
                                    const float* __restrict__ sx_ptr,
                                    const float* __restrict__ sw,
                                    float* __restrict__ out) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int32_t s = 0;
  for (int z = 0; z < ksplit; ++z) s += part[static_cast<size_t>(z) * total + idx];
  out[idx] = pmvm::rescale(s, *sx_ptr, sw[idx % N]);
}

template <bool TRANS, int TM>
void launch(dim3 grid, cudaStream_t st, const int8_t* xq, const int8_t* w,
            const float* sx, const float* sw, int M, int K, int N,
            int k_per_split, int32_t* part, float* out) {
  split_kernel<TRANS, TM><<<grid, THREADS, 0, st>>>(xq, w, sx, sw, M, K, N,
                                                    k_per_split, part, out);
}

}  // namespace

extern "C" {

// trans: the weight is (N, K) per-row (photonic_mvm_t); else (K, N).
// bm: 16 or 128.  k_per_split: multiple of 64; ceil(K / k_per_split)
// splits, which need an int32 workspace of splits * M * N when there is more
// than one.  Returns cudaGetLastError() after the launches (0 on success).
int photonic_mvm_split(const void* xq, const void* w, int trans,
                       const float* sx, const float* sw, int M, int K, int N,
                       int bm, int k_per_split, void* workspace, void* out,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksplit = (K + k_per_split - 1) / k_per_split;
  dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, ksplit);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  int32_t* part = static_cast<int32_t*>(workspace);
  float* y = static_cast<float*>(out);
  if (trans) {
    if (bm == 16) launch<true, 1>(grid, st, x8, w8, sx, sw, M, K, N, k_per_split, part, y);
    else launch<true, 8>(grid, st, x8, w8, sx, sw, M, K, N, k_per_split, part, y);
  } else {
    if (bm == 16) launch<false, 1>(grid, st, x8, w8, sx, sw, M, K, N, k_per_split, part, y);
    else launch<false, 8>(grid, st, x8, w8, sx, sw, M, K, N, k_per_split, part, y);
  }
  if (ksplit > 1) {
    const size_t total = static_cast<size_t>(M) * N;
    const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
    split_reduce_kernel<<<blocks, 256, 0, st>>>(part, ksplit, M, N, sx, sw, y);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* photonic_mvm_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
