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
// int32 and rescales once with `pmvm::rescale` — the same expression as the
// split kernel (`photonic_mvm_split.cu`): stream t of the output equals
// `photonic_mvm(xq[t], wq, x_scale[t], w_scale)` bit for bit.  The plain
// PyTorch version (`kernels/photonic_mvm.py`) keeps the reference's fp32
// decomposition; the two differ only by its rounding.
//
// What bounds it on an H100.  At decode widths (T * M = 32 rows on the MoE
// path) the bank's bytes (K * N int8, 0.5 MB for 1024 x 512: 0.16 us at
// 3.35 TB/s) and, far above them, the latency of one launch; at prefill
// widths (T * M up to ~2560 rows) integer operations.
//
// Schedule.  The T * M rows are one int8 matrix (leading dimension K):
// `resident_mma_kernel` runs `pint8::mma_tile<false>` (s8 `wgmma` from a
// cp.async ring, the (K, N) bank transposed in registers) on 128 x 128
// tiles, each row scaled by its stream's x_scale[m / M] (a tile may
// straddle two streams).  The row tiles of one column block run together,
// so each bank tile comes from device memory once and then from L2: the
// reference's weight-stationary intent on this card.  K is walked in
// 128-byte stages, so any K fits.  When the tiles fill less than a wave, K
// splits within the launch (per-tile arrival counters; the last block of
// a tile adds the int32 partials), down to one 128-byte stage per split.
// At decode widths that took 0.0149 / 0.0136 ms for T = 4 streams of 8
// rows, 1024->512 / 512->1024, where the fused kernel's (K, N) decode
// stream over the 32 rows took 0.0196 / 0.0191 ms (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md): one tile loop serves every width.

#include <cuda_runtime.h>
#include <stdint.h>

#include "photonic_mvm_int8.cuh"

namespace {

__global__ void __launch_bounds__(pmma::THREADS, 2)
resident_mma_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ xs, const float* __restrict__ sw,
                    int rows, int M, int K, int N, int k_per_split,
                    int32_t* part, unsigned* counters, float* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  pint8::mma_tile<false>(xq, w, xs, M, sw, rows, K, N, k_per_split, part,
                         counters, out, smem);
}

}  // namespace

extern "C" {

// xq: int8 (T, M, K) contiguous; w: int8 (K, N); xs: float32 (T,); sw:
// float32 (N,); out: float32 (T, M, N).  k_per_split: a multiple of 128;
// ceil(K / k_per_split) splits, which need an int32 workspace `part` of
// splits * T * M * N and `counters`, one zero word per output tile (the
// kernel leaves them zero), when there is more than one.  Returns
// cudaGetLastError() after the launch (0 on success).
int photonic_mvm_resident(const void* xq, const void* w, const float* xs,
                          const float* sw, int T, int M, int K, int N,
                          int k_per_split, void* part, void* counters,
                          void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = T * M;
  const int splits = (K + k_per_split - 1) / k_per_split;
  // more than 48 KB of dynamic shared memory: say so once
  static const cudaError_t attr = cudaFuncSetAttribute(
      resident_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pmma::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((rows + pmma::BM - 1) / pmma::BM, (N + pmma::BN - 1) / pmma::BN,
            splits);
  resident_mma_kernel<<<grid, pmma::THREADS, pmma::SMEM_BYTES, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), xs, sw,
      rows, M, K, N, k_per_split, static_cast<int32_t*>(part),
      static_cast<unsigned*>(counters), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* photonic_mvm_resident_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
