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
// integer product sum_k q[k] wq[k, n], so these kernels accumulate it in
// int32 and rescale once with `pmvm::rescale`, the same expression as the
// fused kernel: with noise off, the split pipeline's output cast to the
// activation dtype equals the fused kernel's bit for bit, and the two
// orientations of one bank give the same output bit for bit.  The plain
// PyTorch version (`kernels/photonic_mvm.py`) keeps the reference's fp32
// decomposition; the two differ only by its rounding.
//
// What bounds it on an H100.  At decode widths (M = 2..8) every int8 weight
// byte is read once for a few MACs: device-memory bytes (28.3 MB for a
// 3072 x 9216 bank, >= 8.4 us at 3.35 TB/s).  At prefill widths (M ~ 2048)
// integer operations.
//
// (N, K) bank, `photonic_mvm_t`: two regimes, chosen by the wrapper from M
// (`split_t_launch_plan`), the fused kernel's with an int8 source:
//   * decode (M <= 8): `split_t_gemv_kernel`, the fused kernel's (N, K)
//     decode stream (`gemv_t_kernel` there) with the rows copied into
//     shared memory instead of quantized.  It is a copy: shared through a
//     header, the same code changed the fused kernel's register allocation
//     and slowed its tensor-core kernel (PERF.md).  A CPU test holds the
//     copied code equal to the fused kernel's
//     (`tests/test_torch_kernels.py`);
//   * prefill: `split_t_mma_kernel`, `pint8::mma_tile<true>` straight on
//     xq (the bank is K-major already, as the s8 tensor cores read it).
// Both split K in one launch (per-tile arrival counters; the last block of
// a tile adds the int32 partials and rescales).
//
// (K, N) bank, `photonic_mvm`: the CUDA-core main loop of
// `photonic_mvm_common.cuh`, BM x 128 output tiles (BM = 16 for M <= 16,
// else 128), the bank transposed byte-wise into shared memory, `__dp4a`
// on 32-bit words.  Split-K (grid.z) writes int32 partials that a second
// kernel adds before the rescale.  Its redesign is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "photonic_mvm_common.cuh"
#include "photonic_mvm_int8.cuh"

namespace {

using pmvm::BKW;
using pmvm::BN;
using pmvm::THREADS;

// ------------------------------------------------------ (K, N) bank
template <int TM>
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
  pmvm::mainloop<TM>(load_a, w, n0, k_begin, k_end, N, acc);

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

template <int TM>
void launch(dim3 grid, cudaStream_t st, const int8_t* xq, const int8_t* w,
            const float* sx, const float* sw, int M, int K, int N,
            int k_per_split, int32_t* part, float* out) {
  split_kernel<TM><<<grid, THREADS, 0, st>>>(xq, w, sx, sw, M, K, N,
                                             k_per_split, part, out);
}

// ------------------------------------------------------ (N, K) bank
// Copy int8 rows x[0..M)[k_begin..k_end) into xs[MT][ks] (int8 words), zero
// past M and past k_end.
template <int MT>
__device__ __forceinline__ void copy_rows(const int8_t* __restrict__ x, int M,
                                          int K, int k_begin, int k_end,
                                          int ks, uint32_t* xs) {
  const int words = ks / 4;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  for (int idx = threadIdx.x; idx < MT * words; idx += blockDim.x) {
    const int m = idx / words, k = k_begin + 4 * (idx % words);
    uint32_t v = 0u;
    if (m < M && k < k_end) {
      const int8_t* src = x + static_cast<size_t>(m) * K + k;
      if (vec && k + 4 <= k_end) {
        v = __ldg(reinterpret_cast<const uint32_t*>(src));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < k_end)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * i);
      }
    }
    xs[idx] = v;
  }
}

// Decode: M <= MT rows; grid (ceil(N / 64), splits); dynamic shared memory
// MT * k_per_split bytes of int8 rows.  A bank row is bound by its bytes:
// each is read once, with eight 16-byte loads in flight per lane, the
// first issued before the rows are copied, and taken with `__dp4a` from
// registers.  A warp pass covers ROWS = 32 / MT channels and reduces
// across its lanes with a butterfly that leaves one total per lane.
constexpr int T_THREADS = 256;
constexpr int T_COLS = 64;      // channels per block

template <int MT, bool FAST>
__device__ __forceinline__ void load_rows_nk(uint4 (&wv)[8],
                                             const int8_t* __restrict__ w,
                                             int K, int N, int nb, int k_begin,
                                             int k_end, int nchunks, int it) {
  constexpr int ROWS = 32 / MT, CH = 8 / ROWS;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const int c = (it * CH + cc) * 32 + lane;
      const int n = nb + r;
      if (FAST) {
        // rows past N and chunks past the range load a valid address; their
        // products are dropped
        const int nn = min(n, N - 1), kc = k_begin + 16 * min(c, nchunks - 1);
        wv[r * CH + cc] = __ldg(reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(nn) * K + kc));
      } else {
        const int k = k_begin + 16 * c;
        uint32_t b[4] = {0u, 0u, 0u, 0u};
        if (n < N && c < nchunks) {
          const int8_t* src = w + static_cast<size_t>(n) * K + k;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (k + i < k_end)
              b[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i]))
                           << (8 * (i & 3));
        }
        wv[r * CH + cc] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
}

// One step of a reduce-and-transpose across the warp: lanes with bit D set
// keep (and receive the partner's copy of) values D..2D-1, the others
// values 0..D-1.  Five steps leave lane l with the warp total of value l.
template <int D>
__device__ __forceinline__ void butterfly(int32_t (&acc)[32], int lane) {
  const bool upper = lane & D;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const int32_t send = upper ? acc[i] : acc[i + D];
    const int32_t keep = upper ? acc[i + D] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, D);
  }
}

template <int MT, bool FAST>
__device__ __forceinline__ void gemv_t(const int8_t* __restrict__ xq,
                                       const int8_t* __restrict__ w,
                                       const float* __restrict__ sx_ptr,
                                       const float* __restrict__ sw, int M,
                                       int K, int N, int k_per_split,
                                       int32_t* part, unsigned* counters,
                                       float* out, uint32_t* xs) {
  constexpr int ROWS = 32 / MT, CH = 8 / ROWS;
  constexpr int PASSES = T_COLS / (8 * ROWS);
  __shared__ float sws[T_COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * T_COLS;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nchunks = (k_end - k_begin + 15) / 16;
  const int iters = (nchunks + 32 * CH - 1) / (32 * CH);
  const int xrow = k_per_split / 16;          // uint4 per row of xs
  const bool split = gridDim.y > 1;
  uint4 wv[8];
  auto nb_of = [&](int p) { return n0 + (p * 8 + warp) * ROWS; };
  load_rows_nk<MT, FAST>(wv, w, K, N, nb_of(0), k_begin, k_end, nchunks, 0);
  const float sx = *sx_ptr;
  const int t = threadIdx.x;
  const float swt = t < T_COLS && n0 + t < N ? sw[n0 + t] : 0.f;
  copy_rows<MT>(xq, M, K, k_begin, k_end, k_per_split, xs);
  if (t < T_COLS) sws[t] = swt;
  __syncthreads();
  const uint4* xs4 = reinterpret_cast<const uint4*>(xs);

#pragma unroll 1
  for (int p = 0; p < PASSES; ++p) {
    const int nb = nb_of(p);
    int32_t acc[32];        // acc[r * MT + m]
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[v] = 0;
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
      if (it > 0 || p > 0)
        load_rows_nk<MT, FAST>(wv, w, K, N, nb, k_begin, k_end, nchunks, it);
#pragma unroll
      for (int cc = 0; cc < CH; ++cc) {
        const int c = (it * CH + cc) * 32 + lane;
        if (c >= nchunks) break;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint4 xv = xs4[m * xrow + c];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const uint4 wr = wv[r * CH + cc];
            int32_t a = acc[r * MT + m];
            a = __dp4a(static_cast<int>(wr.x), static_cast<int>(xv.x), a);
            a = __dp4a(static_cast<int>(wr.y), static_cast<int>(xv.y), a);
            a = __dp4a(static_cast<int>(wr.z), static_cast<int>(xv.z), a);
            a = __dp4a(static_cast<int>(wr.w), static_cast<int>(xv.w), a);
            acc[r * MT + m] = a;
          }
        }
      }
    }
    // lane l takes the warp total of acc[l]
    butterfly<16>(acc, lane);
    butterfly<8>(acc, lane);
    butterfly<4>(acc, lane);
    butterfly<2>(acc, lane);
    butterfly<1>(acc, lane);
    const int m = lane % MT, n = nb + lane / MT;
    if (m < M && n < N) {
      if (split)
        part[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = acc[0];
      else
        out[static_cast<size_t>(m) * N + n] =
            pmvm::rescale(acc[0], sx, sws[n - n0]);
    }
  }
  if (split && pint8::last_arrival(counters + blockIdx.x, gridDim.y))
    pint8::finish_tile<1, 16>(
        part, gridDim.y, M, N, 0, M, n0, T_COLS,
        [&](int, int col, size_t at, int32_t sum) {
          out[at] = pmvm::rescale(sum, sx, sws[col]);
        });
}

template <int MT>
__global__ void __launch_bounds__(T_THREADS, 2)
split_t_gemv_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    int M, int K, int N, int k_per_split, int32_t* part,
                    unsigned* counters, float* out) {
  extern __shared__ __align__(16) uint32_t xs[];
  if (K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    gemv_t<MT, true>(xq, w, sx, sw, M, K, N, k_per_split, part, counters, out,
                     xs);
  else
    gemv_t<MT, false>(xq, w, sx, sw, M, K, N, k_per_split, part, counters,
                      out, xs);
}

// Prefill: grid (ceil(M / 128), ceil(N / 128), splits).
__global__ void __launch_bounds__(pmma::THREADS, 2)
split_t_mma_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ w, const float* __restrict__ sx,
                   const float* __restrict__ sw, int M, int K, int N,
                   int k_per_split, int32_t* part, unsigned* counters,
                   float* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  pint8::mma_tile<true>(xq, w, sx, M, sw, M, K, N, k_per_split, part,
                        counters, out, smem);
}

}  // namespace

extern "C" {

// photonic_mvm: xq int8 (M, K), w int8 (K, N).  bm: 16 or 128.
// k_per_split: multiple of 64; ceil(K / k_per_split) splits, which need an
// int32 workspace of splits * M * N when there is more than one.  Returns
// cudaGetLastError() after the launches (0 on success).
int photonic_mvm_split(const void* xq, const void* w, const float* sx,
                       const float* sw, int M, int K, int N, int bm,
                       int k_per_split, void* workspace, void* out,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksplit = (K + k_per_split - 1) / k_per_split;
  dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, ksplit);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  int32_t* part = static_cast<int32_t*>(workspace);
  float* y = static_cast<float*>(out);
  if (bm == 16) launch<1>(grid, st, x8, w8, sx, sw, M, K, N, k_per_split, part, y);
  else launch<8>(grid, st, x8, w8, sx, sw, M, K, N, k_per_split, part, y);
  if (ksplit > 1) {
    const size_t total = static_cast<size_t>(M) * N;
    const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
    split_reduce_kernel<<<blocks, 256, 0, st>>>(part, ksplit, M, N, sx, sw, y);
  }
  return static_cast<int>(cudaGetLastError());
}

// photonic_mvm_t: xq int8 (M, K), w int8 (N, K).  regime: 0 = decode
// (`rows` = 4 or 8 >= M), 1 = tensor cores.  k_per_split: a multiple of 64;
// ceil(K / k_per_split) splits, which need an int32 workspace `part` of
// splits * M * N and `counters`, one zero word per output tile (the
// kernels leave them zero), when there is more than one.  Returns
// cudaGetLastError() after the launch (0 on success).
int photonic_mvm_split_t(const void* xq, const void* w, const float* sx,
                         const float* sw, int M, int K, int N, int regime,
                         int rows, int k_per_split, void* part,
                         void* counters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K + k_per_split - 1) / k_per_split;
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  int32_t* p = static_cast<int32_t*>(part);
  unsigned* c = static_cast<unsigned*>(counters);
  float* y = static_cast<float*>(out);
  if (regime == 0) {
    dim3 grid((N + T_COLS - 1) / T_COLS, splits);
    const int smem = rows * k_per_split;
    if (rows == 4)
      split_t_gemv_kernel<4><<<grid, T_THREADS, smem, st>>>(
          x8, w8, sx, sw, M, K, N, k_per_split, p, c, y);
    else if (rows == 8)
      split_t_gemv_kernel<8><<<grid, T_THREADS, smem, st>>>(
          x8, w8, sx, sw, M, K, N, k_per_split, p, c, y);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  // more than 48 KB of dynamic shared memory: say so once
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_t_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pmma::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((M + pmma::BM - 1) / pmma::BM, (N + pmma::BN - 1) / pmma::BN,
            splits);
  split_t_mma_kernel<<<grid, pmma::THREADS, pmma::SMEM_BYTES, st>>>(
      x8, w8, sx, sw, M, K, N, k_per_split, p, c, y);
  return static_cast<int>(cudaGetLastError());
}

const char* photonic_mvm_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
