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
// What bounds it on an H100.  At decode widths (M = 1..8) every int8 weight
// byte is read once for a few MACs: device-memory bytes (28.3 MB for a
// 3072 x 9216 bank, >= 8.4 us at 3.35 TB/s).  At prefill widths (M ~ 2048)
// integer operations.
//
// Both orientations run the fused kernel's two regimes on int8 rows, chosen
// by the wrapper from M (`split_kn_launch_plan`, `split_t_launch_plan`):
//   * decode (M <= 8): the fused kernel's decode stream of that orientation
//     (`gemv_kernel` / `gemv_t_kernel` there) with the rows copied into
//     shared memory instead of quantized: `split_gemv_kernel` for the
//     (K, N) bank, `split_t_gemv_kernel` for the (N, K) one.  They are
//     copies: shared through a header, the same code changed the fused
//     kernel's register allocation and slowed its tensor-core kernel
//     (PERF.md).  A CPU test holds the copied code equal to the fused
//     kernel's (`tests/test_torch_kernels.py`);
//   * prefill: `pint8::mma_tile` straight on xq, one stream of M rows at
//     one scale: `split_mma_kernel` transposes the (K, N) bank in registers
//     on its way to the s8 tensor cores, `split_t_mma_kernel` reads the
//     (N, K) bank as it is (K-major already).
// Every kernel splits K in one launch (per-tile arrival counters; the last
// block of a tile adds the int32 partials and rescales).

#include <cuda_runtime.h>
#include <stdint.h>

#include "photonic_mvm_common.cuh"
#include "photonic_mvm_int8.cuh"

namespace {

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

// ------------------------------------------------------ (N, K) bank
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

// ------------------------------------------------------ (K, N) bank
// Decode: M <= MT rows; grid (ceil(N / 128), splits); dynamic shared memory
// MT * k_per_split bytes of int8 rows + MT x 128 int32.  A bank row is
// bound by its bytes: each lane owns 4 adjacent columns and has KN_UNROLL k
// quads (4 rows each) of 32-bit loads in flight per iteration, the first
// issued before the rows are copied; it transposes a quad in registers
// (`pmma::transpose4x4`), so one `__dp4a` word holds four k of one column.
// The block's warps split its K range and merge through shared-memory
// atomics.
constexpr int KN_THREADS = 256;
constexpr int KN_COLS = 128;     // columns per block
constexpr int KN_UNROLL = 4;     // k quads in flight per lane

template <bool FAST>
__device__ __forceinline__ void load_quads_kn(
    uint32_t (&raw)[KN_UNROLL][4], const int8_t* __restrict__ w, int K,
    int N, int n, int k_begin, int k_end, int q0) {
#pragma unroll
  for (int u = 0; u < KN_UNROLL; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k_begin + 4 * (q0 + u) + i;
      if (FAST) {
        // rows past the range multiply zero activations (or are dropped),
        // columns past N are dropped: load a valid address instead
        raw[u][i] = __ldg(reinterpret_cast<const uint32_t*>(
            w + static_cast<size_t>(min(k, K - 1)) * N + min(n, N - 4)));
      } else {
        uint32_t v = 0u;
        if (k < k_end) {
          const int8_t* src = w + static_cast<size_t>(k) * N + n;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(src[j]))
                   << (8 * j);
        }
        raw[u][i] = v;
      }
    }
}

template <int MT, bool FAST>
__device__ __forceinline__ void gemv_kn(const int8_t* __restrict__ xq,
                                        const int8_t* __restrict__ w,
                                        const float* __restrict__ sx_ptr,
                                        const float* __restrict__ sw, int M,
                                        int K, int N, int k_per_split,
                                        int32_t* part, unsigned* counters,
                                        float* out, uint32_t* xs) {
  __shared__ float sws[KN_COLS];
  int32_t* red = reinterpret_cast<int32_t*>(xs + MT * (k_per_split / 4));
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n0 = blockIdx.x * KN_COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n0 + 4 * lane;
  const int nquads = (k_end - k_begin + 3) / 4;
  const int xrow = k_per_split / 4;            // words per row of xs
  const bool split = gridDim.y > 1;
  uint32_t raw[KN_UNROLL][4];
  load_quads_kn<FAST>(raw, w, K, N, n, k_begin, k_end, warp * KN_UNROLL);
  const float sx = *sx_ptr;
  const int t = threadIdx.x;
  const float swt = t < KN_COLS && n0 + t < N ? sw[n0 + t] : 0.f;
  copy_rows<MT>(xq, M, K, k_begin, k_end, k_per_split, xs);
  if (t < KN_COLS) sws[t] = swt;
  for (int i = threadIdx.x; i < MT * KN_COLS; i += KN_THREADS) red[i] = 0;
  __syncthreads();

  int32_t acc[4][MT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[j][m] = 0;
#pragma unroll 1
  for (int q0 = warp * KN_UNROLL; q0 < nquads; q0 += 8 * KN_UNROLL) {
    if (q0 != warp * KN_UNROLL)
      load_quads_kn<FAST>(raw, w, K, N, n, k_begin, k_end, q0);
#pragma unroll
    for (int u = 0; u < KN_UNROLL; ++u) {
      if (q0 + u >= nquads) break;
      uint32_t col[4];
      pmma::transpose4x4(raw[u][0], raw[u][1], raw[u][2], raw[u][3], col[0],
                         col[1], col[2], col[3]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int xw = static_cast<int>(xs[m * xrow + q0 + u]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j][m] = __dp4a(static_cast<int>(col[j]), xw, acc[j][m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      atomicAdd(&red[m * KN_COLS + 4 * lane + j], acc[j][m]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * KN_COLS; i += KN_THREADS) {
    const int m = i / KN_COLS, c = i % KN_COLS;
    if (n0 + c >= N) continue;
    if (split)
      part[(static_cast<size_t>(blockIdx.y) * M + m) * N + n0 + c] = red[i];
    else
      out[static_cast<size_t>(m) * N + n0 + c] =
          pmvm::rescale(red[i], sx, sws[c]);
  }
  if (split && pint8::last_arrival(counters + blockIdx.x, gridDim.y))
    pint8::finish_tile<2, 8>(
        part, gridDim.y, M, N, 0, M, n0, KN_COLS,
        [&](int, int col, size_t at, int32_t sum) {
          out[at] = pmvm::rescale(sum, sx, sws[col]);
        });
}

// Decode blocks per SM, fixed by the launch bounds (the fused kernel's):
// the wrapper sizes the K split to one wave of them (GEMV_BLOCKS_PER_SM in
// kernels/photonic_mvm.py).
template <int MT>
__global__ void __launch_bounds__(KN_THREADS, MT == 4 ? 4 : 3)
split_gemv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  int M, int K, int N, int k_per_split, int32_t* part,
                  unsigned* counters, float* out) {
  extern __shared__ __align__(16) uint32_t xs[];
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0)
    gemv_kn<MT, true>(xq, w, sx, sw, M, K, N, k_per_split, part, counters,
                      out, xs);
  else
    gemv_kn<MT, false>(xq, w, sx, sw, M, K, N, k_per_split, part, counters,
                       out, xs);
}

// ------------------------------------------------------ prefill
// grid (ceil(M / 128), ceil(N / 128), splits); one stream: group = M rows
// at the scale sx.
__global__ void __launch_bounds__(pmma::THREADS, 2)
split_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 int M, int K, int N, int k_per_split, int32_t* part,
                 unsigned* counters, float* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  pint8::mma_tile<false>(xq, w, sx, M, sw, M, K, N, k_per_split, part,
                         counters, out, smem);
}

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

template <int MT>
cudaError_t launch_gemv(int trans, const int8_t* xq, const int8_t* w,
                        const float* sx, const float* sw, int M, int K, int N,
                        int kps, int splits, int32_t* part,
                        unsigned* counters, float* out, cudaStream_t st) {
  if (trans) {
    dim3 grid((N + T_COLS - 1) / T_COLS, splits);
    split_t_gemv_kernel<MT><<<grid, T_THREADS, MT * kps, st>>>(
        xq, w, sx, sw, M, K, N, kps, part, counters, out);
  } else {
    dim3 grid((N + KN_COLS - 1) / KN_COLS, splits);
    split_gemv_kernel<MT><<<grid, KN_THREADS, MT * kps + 4 * MT * KN_COLS,
                            st>>>(xq, w, sx, sw, M, K, N, kps, part,
                                  counters, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xq int8 (M, K); w int8 (K, N) (`photonic_mvm`), or (N, K) with trans
// (`photonic_mvm_t`).  regime: 0 = decode (`rows` = 4 or 8 >= M), 1 =
// tensor cores.  k_per_split: a multiple of 64; ceil(K / k_per_split)
// splits, which need an int32 workspace `part` of splits * M * N and
// `counters`, one zero word per output tile (the kernels leave them zero),
// when there is more than one.  One launch; returns cudaGetLastError()
// after it (0 on success).
int photonic_mvm_split(const void* xq, const void* w, int trans,
                       const float* sx, const float* sw, int M, int K, int N,
                       int regime, int rows, int k_per_split, void* part,
                       void* counters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K + k_per_split - 1) / k_per_split;
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  int32_t* p = static_cast<int32_t*>(part);
  unsigned* c = static_cast<unsigned*>(counters);
  float* y = static_cast<float*>(out);
  if (regime == 0) {
    if (rows == 4)
      return static_cast<int>(launch_gemv<4>(trans, x8, w8, sx, sw, M, K, N,
                                             k_per_split, splits, p, c, y,
                                             st));
    if (rows == 8)
      return static_cast<int>(launch_gemv<8>(trans, x8, w8, sx, sw, M, K, N,
                                             k_per_split, splits, p, c, y,
                                             st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((M + pmma::BM - 1) / pmma::BM, (N + pmma::BN - 1) / pmma::BN,
            splits);
  // more than 48 KB of dynamic shared memory: say so once per kernel
  if (trans) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        split_t_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pmma::SMEM_BYTES);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    split_t_mma_kernel<<<grid, pmma::THREADS, pmma::SMEM_BYTES, st>>>(
        x8, w8, sx, sw, M, K, N, k_per_split, p, c, y);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        split_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pmma::SMEM_BYTES);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    split_mma_kernel<<<grid, pmma::THREADS, pmma::SMEM_BYTES, st>>>(
        x8, w8, sx, sw, M, K, N, k_per_split, p, c, y);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* photonic_mvm_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
