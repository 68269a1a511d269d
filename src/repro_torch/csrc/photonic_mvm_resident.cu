// Reuse-resident photonic W8A8 MVM for Hopper (sm_90a): T int8 activation
// streams, each with its own A8 scale, through ONE programmed (K, N) bank.
//
// Replaces the TPU kernel `photonic_mvm_resident` (src/repro/kernels/
// photonic_mvm.py, `_kernel_resident`): the PRM-blended MoE experts' matmul,
// where the E / R_e logical experts blended from one basic expert pass their
// token buffers through the same bank (`Backend.reuse_dot`).
//
// Arithmetic.  The TPU kernel computes y = 2 (q.W' - sum(q)/2) s_x[t] s_w
// with W' = wq/254 + 1/2 in fp32.  That is s_x[t] s_w / 127 times the exact
// integer product sum_k q[k] wq[k, n], so this kernel accumulates it in
// int32 with `__dp4a` and rescales once with `pmvm::rescale` — the same
// expression as the split kernel (`photonic_mvm_split.cu`): stream t of the
// output equals `photonic_mvm(xq[t], wq, x_scale[t], w_scale)` bit for bit.
// The plain PyTorch version (`kernels/photonic_mvm.py`) keeps the
// reference's fp32 decomposition; the two differ only by its rounding.
//
// Schedule.  Weight-stationary, as the reference's BlockSpec (the weight
// index map ignores the streaming grid dims): each block owns RBN = 32
// output columns, copies the full-depth (K, 32) int8 tile of the bank into
// shared memory once (transposed byte-wise, so the inner loop reads 4
// consecutive k of one column as one 32-bit word), then streams all T * M
// activation rows through it in row blocks of 16 * TM.  K is not split
// (the reference does not grid it either): the tile needs
// 32 * (ceil(K / 64) * 16 + 1) words of dynamic shared memory, so K is
// limited to RESIDENT_MAX_K = 4096 (131 KB); the wrapper refuses a larger K.
// Each row block's activations are staged 64 bytes of K at a time.
//
// What bounds it on an H100.  At decode widths (T * M = 32 rows) the bank
// bytes (K * N int8, 0.5 MB for 1024 x 512) bound the work; at prefill
// widths (T * M ~ 2560 rows) integer operations.  The grid is only N / 32
// blocks (16 or 32 on the MoE path), so the kernel uses a fraction of the
// card's 132 SMs: a row-split grid, tensor cores and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "photonic_mvm_common.cuh"

namespace {

constexpr int RBN = 32;             // bank columns per block
constexpr int RBK = 64;             // activation bytes of K per stage
constexpr int RBKW = RBK / 4;       // 32-bit words per stage row
constexpr int RTHREADS = 256;       // 16 x 16 threads; each owns TM x 2 outputs
constexpr int RESIDENT_MAX_K = 4096;

// Words per shared-memory bank row: K rounded up to whole stages, plus one
// word of padding so the 16 rows read by a warp fall in distinct banks.
__host__ __device__ inline int ws_stride(int K) {
  return (K + RBK - 1) / RBK * RBKW + 1;
}

template <int TM>
__global__ void __launch_bounds__(RTHREADS)
resident_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                const float* __restrict__ xs, const float* __restrict__ sw,
                int rows, int M, int K, int N, float* __restrict__ out) {
  extern __shared__ int32_t Ws[];             // [RBN][ws_stride(K)]
  constexpr int BM = 16 * TM;
  __shared__ int32_t As[BM][RBKW + 1];
  const int stride = ws_stride(K);
  const int kpad = (stride - 1) * 4;          // K rounded up to a stage
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * RBN;

  // Program the bank tile once: byte k of word row c is wq[k, n0 + c];
  // zero past K and past N.
  uint8_t* ws8 = reinterpret_cast<uint8_t*>(Ws);
  const bool wvec = (reinterpret_cast<uintptr_t>(w) % 4 == 0) && (N % 4 == 0);
  for (int idx = threadIdx.x; idx < kpad * (RBN / 4); idx += RTHREADS) {
    const int k = idx / (RBN / 4), c4 = idx % (RBN / 4);
    const int n = n0 + c4 * 4;
    uint32_t v4 = 0;
    if (k < K) {
      const int8_t* src = w + static_cast<size_t>(k) * N + n;
      if (wvec && n + 4 <= N) {
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
      ws8[(c4 * 4 + i) * stride * 4 + k] = static_cast<uint8_t>(v4 >> (8 * i));
  }
  __syncthreads();

  // Stream every activation row of every reuse through the resident tile.
  const bool xvec = (reinterpret_cast<uintptr_t>(xq) % 4 == 0) && (K % 4 == 0);
  for (int m0 = 0; m0 < rows; m0 += BM) {
    int32_t acc[TM][2];
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = 0;
    for (int k0 = 0; k0 < K; k0 += RBK) {
      for (int idx = threadIdx.x; idx < BM * RBKW; idx += RTHREADS) {
        const int r = idx / RBKW, kw = idx % RBKW;
        const int m = m0 + r, kb = k0 + kw * 4;
        uint32_t packed = 0;
        if (m < rows && kb < K) {
          const int8_t* src = xq + static_cast<size_t>(m) * K + kb;
          if (xvec) {
            packed = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (kb + i < K)
                packed |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * i);
          }
        }
        As[r][kw] = static_cast<int32_t>(packed);
      }
      __syncthreads();
      const int32_t* w0 = Ws + k0 / 4;
      // exact integer product: 4 int8 MACs per __dp4a
#pragma unroll
      for (int kw = 0; kw < RBKW; ++kw) {
        int32_t a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[ty + 16 * i][kw];
        const int32_t b0 = w0[tx * stride + kw];
        const int32_t b1 = w0[(tx + 16) * stride + kw];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = __dp4a(a[i], b0, acc[i][0]);
          acc[i][1] = __dp4a(a[i], b1, acc[i][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= rows) continue;
      const float sx = xs[m / M];             // this row's stream scale
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N)
          out[static_cast<size_t>(m) * N + n] = pmvm::rescale(acc[i][j], sx, sw[n]);
      }
    }
  }
}

template <int TM>
int launch(const int8_t* xq, const int8_t* w, const float* xs, const float* sw,
           int rows, int M, int K, int N, float* out, cudaStream_t st) {
  const int smem = RBN * ws_stride(K) * static_cast<int>(sizeof(int32_t));
  // more than 48 KB of shared memory needs the opt-in: raise the limit
  // once, to what the largest K takes
  static bool opted_in = false;
  if (!opted_in) {
    const int most = RBN * ws_stride(RESIDENT_MAX_K) *
                     static_cast<int>(sizeof(int32_t));
    cudaError_t err = cudaFuncSetAttribute(
        resident_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((N + RBN - 1) / RBN);
  resident_kernel<TM><<<grid, RTHREADS, smem, st>>>(xq, w, xs, sw, rows, M, K,
                                                    N, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int photonic_mvm_resident_max_k() { return RESIDENT_MAX_K; }

// xq: int8 (T, M, K) contiguous; w: int8 (K, N); xs: float32 (T,); sw:
// float32 (N,); out: float32 (T, M, N).  tm: 2 (row blocks of 32) or 8 (of
// 128).  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for K > RESIDENT_MAX_K or a bad tm.
int photonic_mvm_resident(const void* xq, const void* w, const float* xs,
                          const float* sw, int T, int M, int K, int N, int tm,
                          void* out, void* stream) {
  if (K < 1 || K > RESIDENT_MAX_K || (tm != 2 && tm != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  float* y = static_cast<float*>(out);
  const int rows = T * M;
  if (tm == 2) return launch<2>(x8, w8, xs, sw, rows, M, K, N, y, st);
  return launch<8>(x8, w8, xs, sw, rows, M, K, N, y, st);
}

const char* photonic_mvm_resident_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
