// The int8-in, float32-out photonic MVM tile on Hopper's s8 tensor cores,
// shared by the split kernels of both orientations (`photonic_mvm_split.cu`)
// and the reuse-resident kernel (`photonic_mvm_resident.cu`).
//
// out[m][n] = pmvm::rescale(sum_k a[m][k] W[k][n], xs[m / group], sw[n])
// for int8 rows `a` (M rows of K bytes, already on the A8 grid: no
// quantize step) grouped in streams of `group` rows, stream t with its own
// A8 scale xs[t] (the split kernel: one stream, group = M), and an int8
// bank in either OBU orientation.  One block computes a 128 x 128 output
// tile over a K range with `pmma::tile_loop` (`wgmma.m64n128k32` s8 from a
// 3-stage cp.async ring; the (K, N) bank is transposed in registers on its
// way in, the (N, K) bank is K-major already).  The grid is (row tiles,
// column tiles, K splits): the row tiles of one column block run together,
// so each bank tile comes from device memory once and then from L2.  A
// split call writes int32 partials and the last block of each tile adds
// them (`finish_tile`): one launch, and integer sums make the split
// invisible in the result.
//
// The epilogue's scales (the tile's 128 column scales and its 128 row
// scales) are fetched into registers before the main loop and reach
// shared memory once per block: read per element between the output
// stores, each would cost a memory round trip.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "photonic_mvm_common.cuh"
#include "photonic_mvm_mma.cuh"

namespace pint8 {

// The one-launch split-K finish (also used by the split kernels' decode
// streams) is the fused kernel's (`photonic_mvm_fused.cu`), which keeps its
// own copy: moved into a shared header, the same code changed the fused
// tensor-core kernel's register allocation and slowed it at M = 2048
// (PERF.md).  A CPU test holds the two copies equal
// (`tests/test_torch_kernels.py`).
//
// Split K: every block writes its int32 partials; the last block of an
// output tile to arrive adds all splits' partials and runs the epilogue,
// then re-arms the tile's counter for the next call.  Returns true in that
// last block.
__device__ __forceinline__ bool last_arrival(unsigned* counter,
                                             unsigned splits) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == splits - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block of a split tile adds every split's partials (splits, M,
// N) and hands each sum to `store(m, c, at, sum)` (row m, tile column c,
// flat index at = m * N + n0 + c), over the tile's valid rows in chunks:
// each thread sums EC elements, ZU splits at a time, so EC x ZU loads are
// in flight before the chunk's first output store.
template <int EC, int ZU, typename Store>
__device__ __forceinline__ void finish_tile(const int32_t* part, int splits,
                                            int M, int N, int m0, int rows,
                                            int n0, int cols, Store store) {
  const size_t plane = static_cast<size_t>(M) * N;
  const int elems = min(rows, M - m0) * cols;
  for (int base = 0; base < elems; base += EC * blockDim.x) {
    int32_t sum[EC];
    size_t at[EC];          // (m, n0 + c) of element e; 0 if it is not one
    bool ok[EC];
#pragma unroll
    for (int e = 0; e < EC; ++e) {
      const int i = base + threadIdx.x + e * blockDim.x;
      const int m = m0 + i / cols, c = i % cols;
      ok[e] = i < elems && n0 + c < N;
      at[e] = ok[e] ? static_cast<size_t>(m) * N + n0 + c : 0;
      sum[e] = 0;
    }
    // branch-free batches (clamped addresses, zero for what is not there),
    // so all EC x ZU loads issue before the first add waits
#pragma unroll 1
    for (int z0 = 0; z0 < splits; z0 += ZU)
#pragma unroll
      for (int zu = 0; zu < ZU; ++zu) {
        const bool z_ok = z0 + zu < splits;
        const int32_t* pz = part + min(z0 + zu, splits - 1) * plane;
#pragma unroll
        for (int e = 0; e < EC; ++e) {
          const int32_t v = __ldcg(pz + at[e]);
          sum[e] += (z_ok && ok[e]) ? v : 0;
        }
      }
#pragma unroll
    for (int e = 0; e < EC; ++e) {
      if (!ok[e]) continue;
      const int i = base + threadIdx.x + e * blockDim.x;
      store(m0 + i / cols, i % cols, at[e], sum[e]);
    }
  }
}


// `part` (splits, M, N) int32 and `counters` (one zero word per output
// tile) are used only when gridDim.z > 1.
template <bool TRANS>
__device__ __forceinline__ void mma_tile(
    const int8_t* __restrict__ a, const int8_t* __restrict__ w,
    const float* __restrict__ xs, int group, const float* __restrict__ sw,
    int M, int K, int N, int k_per_split, int32_t* __restrict__ part,
    unsigned* counters, float* __restrict__ out, uint8_t* smem) {
  using pmma::BM;
  using pmma::BN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  // rows start 16-byte aligned only when K is a multiple of 16; otherwise
  // the loader copies them byte-wise
  const bool a_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  // threads 0..127 fetch column n0 + t's scale, 128..255 row m0 + t's
  __shared__ float sws[BN], sxs[BM];
  const int t = threadIdx.x % BN;
  const bool col_thread = threadIdx.x < BN;
  float scale = 0.f;
  if (col_thread ? n0 + t < N : m0 + t < M)
    scale = col_thread ? sw[n0 + t] : xs[(m0 + t) / group];
  int32_t acc[64];
  pmma::tile_loop<TRANS>(a, K, a_vec, w, M, N, K, m0, n0, k_begin, k_end,
                         smem, acc);
  if (col_thread)
    sws[t] = scale;
  else
    sxs[t] = scale;
  __syncthreads();
  if (gridDim.z > 1) {
#pragma unroll
    for (int v = 0; v < 64; ++v) {
      const int m = m0 + pmma::acc_row(v), n = n0 + pmma::acc_col(v);
      if (m < M && n < N)
        part[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = acc[v];
    }
    if (last_arrival(counters + blockIdx.y * gridDim.x + blockIdx.x,
                     gridDim.z))
      finish_tile<4, 4>(
          part, gridDim.z, M, N, m0, BM, n0, BN,
          [&](int m, int c, size_t at, int32_t sum) {
            out[at] = pmvm::rescale(sum, sxs[m - m0], sws[c]);
          });
    return;
  }
  // accumulators v, v + 1 are columns n, n + 1 of one row: one 8-byte
  // store where the row allows it
#pragma unroll
  for (int g = 0; g < 16; ++g) {            // 8-column group
    const int cn = pmma::acc_col(4 * g), n = n0 + cn;
    if (n >= N) continue;
    const bool pair = n + 1 < N && N % 2 == 0;
    const float s0 = sws[cn], s1 = sws[cn + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {           // rows lane / 4 and + 8
      const int v = 4 * g + 2 * h;
      const int r = pmma::acc_row(v), m = m0 + r;
      if (m >= M) continue;
      float* row = out + static_cast<size_t>(m) * N;
      const float y0 = pmvm::rescale(acc[v], sxs[r], s0);
      const float y1 = pmvm::rescale(acc[v + 1], sxs[r], s1);
      if (pair) {
        *reinterpret_cast<float2*>(row + n) = make_float2(y0, y1);
      } else {
        row[n] = y0;
        if (n + 1 < N) row[n + 1] = y1;
      }
    }
  }
}

}  // namespace pint8
