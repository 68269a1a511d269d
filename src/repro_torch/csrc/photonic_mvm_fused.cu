// Fused photonic W8A8 MVM for Hopper (sm_90a).
//
// Replaces the TPU kernel `photonic_mvm_fused` (src/repro/kernels/
// photonic_mvm.py, `_kernel_fused` + the scalar-prefetched output index map):
// A8 quantization of floating activations, the offset-decomposed MVM of
// paper eq. 6, and the blend epilogue (bias, relu/silu, blocked output
// shuffle).
//
// Arithmetic.  The TPU kernel accumulates q(x) . W' with W' = wq/254 + 1/2
// in fp32 next to the offset row sum(q(x)) and recomposes
// y = 2 (q.W' - sum(q)/2) s_x s_w.  Algebraically that is s_x s_w / 127 times
// the exact integer product sum_k q(x)[k] wq[k, n] — the W0 decomposition
// in integer form — so this kernel accumulates q(x) . wq in int32 (exact,
// independent of tiling, split and order) and recomposes
// y = float(acc) * (s_x * s_w[n]) / 127 with `pmvm::rescale`, the split
// kernel's expression.  The plain PyTorch version beside it
// (`kernels/photonic_mvm.py`) keeps the reference's fp32 decomposition; the
// two differ only by that fp32 rounding.  The quantizer matches the
// reference bit for bit: the divide runs in the input dtype (bf16 inputs
// round to the bf16 grid), then round-half-to-even (`rintf`) and clamp to
// [-128, 127].
//
// Two regimes, chosen by the wrapper from M (`launch_plan`):
//
// Decode widths (M <= 8): a matrix-vector product, bound by the weight
// bytes (28.3 MB for a 3072 x 9216 bank: >= 8.4 us at 3.35 TB/s).  The
// kernels stream every weight byte once, with several loads in flight per
// thread (eight of 16 bytes, or sixteen of 4 bytes for a (K, N) bank), and
// take the product with `__dp4a` from registers.  A block
// quantizes the M rows of its own K range into shared memory (cheap next
// to the weight bytes, and no second launch on a host-bound decode step)
// while its first weight loads are in flight.  (N, K) bank: each warp
// streams 32 / MT K-contiguous rows with 16-byte loads and reduces across
// its lanes with a butterfly that leaves one total per lane.  (K, N) bank:
// each lane owns four adjacent columns, loads four consecutive k rows of
// them as 32-bit words and transposes them in registers
// (`pmma::transpose4x4`), so one `__dp4a` word holds four k of one column;
// the block's warps split its K range and merge through shared-memory
// atomics.  K splits across blocks while they fit one wave; the int32
// partials go to a workspace, and the last block of a tile to arrive adds
// them up (integer adds: the split never changes the result) and runs the
// epilogue, so a split call is still one launch.
//
// Prefill widths (M > 8): bound by integer operations (2 M K N) at full
// width; at 9-16 rows the tensor-core tiles also read the bank faster than
// the decode kernels do.
// `quantize_kernel` writes the A8 grid of x once into an int8 (M, Kp)
// workspace (Kp = K rounded up to 16, zero-padded), then `mma_kernel` runs
// the product on the s8 tensor cores (`pmma::tile_loop` in
// `photonic_mvm_mma.cuh`: 128 x 128 x 128 tiles, a 3-stage cp.async ring,
// `wgmma.m64n128k32` from shared-memory descriptors, the (K, N) bank
// transposed in registers on its way in).  Blocks walk the M tiles of one column block
// together, so a bank as wide as the 256000-column lm_head is read from
// device memory once.  Short prompts (few tiles) split K as the decode
// regime does.  The epilogue stores adjacent output columns as one word.
//
// Epilogue (both regimes): the blocked output shuffle writes computed
// column n of block j to inv_perm[j] * block + n % block; the bias is read
// at that output position; relu or silu with every op rounded to the
// output type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "photonic_mvm_common.cuh"
#include "photonic_mvm_mma.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2 };

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_COLS = 128;     // (K, N) bank: columns per block
constexpr int GEMV_T_COLS = 64;    // (N, K) bank: channels per block
constexpr int KN_UNROLL = 4;       // (K, N) bank: k quads in flight per lane

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

// Four quantized activations x[m][k..k+3] (zero past K) packed into a word.
template <typename T>
__device__ __forceinline__ uint32_t quantize4(const T* __restrict__ row, int k,
                                              int K, float s_t) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = (k + i < K) ? quantize<T>(row[k + i], s_t) : 0;
    packed |= static_cast<uint32_t>(q & 0xff) << (8 * i);
  }
  return packed;
}

// Epilogue arguments shared by every kernel of this file.
template <typename T>
struct Out {
  const float* sx_ptr;
  const float* sw;
  const T* bias;
  const int* inv_perm;
  int block, act;
  int32_t* part;        // split-K partials (splits, M, N), or null
  unsigned* counters;   // split-K arrivals per output tile (zero between calls)
  T* out;
};

// Epilogue data of computed column n: its scale, its output position under
// the blocked shuffle, and the bias at that position.
struct Col {
  float sw;
  int o;
  float bias;
};

template <typename T>
__device__ __forceinline__ Col column(const Out<T>& o, int n) {
  Col c;
  c.sw = o.sw[n];
  c.o = n;
  if (o.inv_perm != nullptr) {
    const int j = n / o.block;
    c.o = o.inv_perm[j] * o.block + (n - j * o.block);
  }
  c.bias = o.bias != nullptr ? to_f<T>(o.bias[c.o]) : 0.f;
  return c;
}

// TIA rescale + blend epilogue of one exact product: bias, then relu or
// silu, every op rounded to T.
template <typename T>
__device__ __forceinline__ T finish_value(const Out<T>& o, const Col& c,
                                          int32_t acc, float sx) {
  T yt = from_f<T>(pmvm::rescale(acc, sx, c.sw));
  if (o.bias != nullptr) yt = from_f<T>(to_f<T>(yt) + c.bias);
  if (o.act == ACT_RELU) {
    yt = from_f<T>(fmaxf(to_f<T>(yt), 0.f));
  } else if (o.act == ACT_SILU) {
    // y * 1/(1 + exp(-y)), every op rounded to T: the reference's rounding
    // of y * jax.nn.sigmoid(y) (and of the plain version)
    const float v = to_f<T>(yt);
    const float e = to_f<T>(from_f<T>(expf(-v)));
    const float d = to_f<T>(from_f<T>(1.f + e));
    const float sig = to_f<T>(from_f<T>(1.f / d));
    yt = from_f<T>(v * sig);
  }
  return yt;
}

// Split K: every block writes its int32 partials; the last block of an
// output tile to arrive adds all splits' partials (integer adds, so the
// split never changes the result) and runs the epilogue, then re-arms the
// tile's counter for the next call.  Returns true in that last block.
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

// The epilogue data of the block's `cols` (<= 128) output columns from n0
// goes to shared memory once per block: thread t fetches column n0 + t into
// registers early in the prologue, so the loads overlap the prologue's
// other loads, and publishes it before the prologue's barrier.  (Read per
// element between the output stores, each would cost a memory round trip:
// the compiler cannot move a load past a store that may alias it.)
template <typename T>
__device__ __forceinline__ Col fetch_column(const Out<T>& o, int n0,
                                               int cols, int N) {
  Col c{};
  if (static_cast<int>(threadIdx.x) < cols && n0 + threadIdx.x < N)
    c = column(o, n0 + threadIdx.x);
  return c;
}

__device__ __forceinline__ const Col* publish_column(const Col& c,
                                                        int n0, int cols,
                                                        int N) {
  __shared__ Col cs[GEMV_COLS];
  if (static_cast<int>(threadIdx.x) < cols && n0 + threadIdx.x < N)
    cs[threadIdx.x] = c;
  return cs;                // visible after the caller's next barrier
}

// The last block of a split tile adds every split's partials and runs the
// epilogue, over the tile's valid rows in chunks: each thread sums EC
// elements, ZU splits at a time, so EC x ZU loads are in flight before the
// chunk's first output store.
template <typename T, int EC, int ZU>
__device__ __forceinline__ void finish_tile(const Out<T>& o, int splits,
                                            int M, int N, int m0, int rows,
                                            int n0, int cols, float sx,
                                            const Col* cs) {
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
        const int32_t* pz = o.part + min(z0 + zu, splits - 1) * plane;
#pragma unroll
        for (int e = 0; e < EC; ++e) {
          const int32_t v = __ldcg(pz + at[e]);
          sum[e] += (z_ok && ok[e]) ? v : 0;
        }
      }
#pragma unroll
    for (int e = 0; e < EC; ++e) {
      if (!ok[e]) continue;
      const int c = (base + threadIdx.x + e * blockDim.x) % cols;
      o.out[at[e] - (n0 + c) + cs[c].o] = finish_value(o, cs[c], sum[e], sx);
    }
  }
}

// Quantize x[0..M)[k_begin..k_end) into xs[MT][ks] (int8 words), zero past
// M and past k_end.
template <typename T, int MT>
__device__ __forceinline__ void quantize_rows(const T* __restrict__ x, int M,
                                              int K, int k_begin, int k_end,
                                              int ks, float s_t,
                                              uint32_t* xs) {
  const int words = ks / 4;
  for (int idx = threadIdx.x; idx < MT * words; idx += blockDim.x) {
    const int m = idx / words, kw = idx % words;
    const int k = k_begin + 4 * kw;
    xs[idx] = (m < M && k < k_end)
                  ? quantize4<T>(x + static_cast<size_t>(m) * K, k, k_end, s_t)
                  : 0u;
  }
}

// ---------------------------------------------------------------- decode
// (N, K) bank, M <= MT rows.  grid (ceil(N / 64), splits); dynamic shared
// memory MT * k_per_split bytes of quantized activations.  A warp pass
// covers ROWS = 32 / MT channels; per iteration each lane has ROWS x CH =
// 8 16-byte loads in flight (CH = 8 / ROWS chunks of each row), and the
// first iteration's loads are issued before the quantize prologue.
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

template <typename T, int MT, bool FAST>
__device__ __forceinline__ void gemv_nk(const T* __restrict__ x,
                                        const int8_t* __restrict__ w, int M,
                                        int K, int N, int k_per_split,
                                        const Out<T>& o, uint32_t* xs) {
  constexpr int ROWS = 32 / MT, CH = 8 / ROWS;
  constexpr int PASSES = GEMV_T_COLS / (8 * ROWS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nchunks = (k_end - k_begin + 15) / 16;
  const int iters = (nchunks + 32 * CH - 1) / (32 * CH);
  const int xrow = k_per_split / 16;          // uint4 per quantized row
  uint4 wv[8];
  auto nb_of = [&](int p) {
    return static_cast<int>(blockIdx.x) * GEMV_T_COLS + (p * 8 + warp) * ROWS;
  };
  load_rows_nk<MT, FAST>(wv, w, K, N, nb_of(0), k_begin, k_end, nchunks, 0);
  const float sx = *o.sx_ptr;
  const int n0 = blockIdx.x * GEMV_T_COLS;
  const Col col = fetch_column(o, n0, GEMV_T_COLS, N);
  quantize_rows<T, MT>(x, M, K, k_begin, k_end, k_per_split,
                       to_f<T>(from_f<T>(sx)), xs);
  const Col* cs = publish_column(col, n0, GEMV_T_COLS, N);
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
      if (o.part != nullptr)
        o.part[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = acc[0];
      else
        o.out[static_cast<size_t>(m) * N + cs[n - n0].o] =
            finish_value(o, cs[n - n0], acc[0], sx);
    }
  }
  if (o.part != nullptr && last_arrival(o.counters + blockIdx.x, gridDim.y))
    finish_tile<T, 1, 16>(o, gridDim.y, M, N, 0, M, n0, GEMV_T_COLS, sx, cs);
}

// Resident decode blocks per SM, fixed by the launch bounds: the wrapper
// sizes the K split to one wave of them (GEMV_BLOCKS_PER_SM in
// kernels/photonic_mvm.py).
template <int MT, bool TRANS>
constexpr int gemv_blocks_per_sm() {
  return TRANS ? 2 : (MT == 4 ? 4 : 3);
}

template <typename T, int MT>
__global__ void __launch_bounds__(GEMV_THREADS, gemv_blocks_per_sm<MT, true>())
gemv_t_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, int M,
              int K, int N, int k_per_split, Out<T> o) {
  extern __shared__ __align__(16) uint32_t xs[];
  if (K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    gemv_nk<T, MT, true>(x, w, M, K, N, k_per_split, o, xs);
  else
    gemv_nk<T, MT, false>(x, w, M, K, N, k_per_split, o, xs);
}

// (K, N) bank, M <= MT rows.  grid (ceil(N / 128), splits); dynamic shared
// memory MT * k_per_split bytes of quantized activations + MT x 128 int32.
// Each lane owns 4 adjacent columns; per iteration it has KN_UNROLL k quads
// (4 rows each) of 32-bit loads in flight, the first issued before the
// quantize prologue.
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

template <typename T, int MT, bool FAST>
__device__ __forceinline__ void gemv_kn(const T* __restrict__ x,
                                        const int8_t* __restrict__ w, int M,
                                        int K, int N, int k_per_split,
                                        const Out<T>& o, uint32_t* xs) {
  int32_t* red = reinterpret_cast<int32_t*>(xs + MT * (k_per_split / 4));
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n0 = blockIdx.x * GEMV_COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n0 + 4 * lane;
  const int nquads = (k_end - k_begin + 3) / 4;
  const int xrow = k_per_split / 4;            // words per quantized row
  uint32_t raw[KN_UNROLL][4];
  load_quads_kn<FAST>(raw, w, K, N, n, k_begin, k_end, warp * KN_UNROLL);
  const float sx = *o.sx_ptr;
  const Col col = fetch_column(o, n0, GEMV_COLS, N);
  quantize_rows<T, MT>(x, M, K, k_begin, k_end, k_per_split,
                       to_f<T>(from_f<T>(sx)), xs);
  const Col* cs = publish_column(col, n0, GEMV_COLS, N);
  for (int i = threadIdx.x; i < MT * GEMV_COLS; i += GEMV_THREADS) red[i] = 0;
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
      atomicAdd(&red[m * GEMV_COLS + 4 * lane + j], acc[j][m]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * GEMV_COLS; i += GEMV_THREADS) {
    const int m = i / GEMV_COLS, c = i % GEMV_COLS;
    if (n0 + c >= N) continue;
    if (o.part != nullptr)
      o.part[(static_cast<size_t>(blockIdx.y) * M + m) * N + n0 + c] = red[i];
    else
      o.out[static_cast<size_t>(m) * N + cs[c].o] =
          finish_value(o, cs[c], red[i], sx);
  }
  if (o.part != nullptr && last_arrival(o.counters + blockIdx.x, gridDim.y))
    finish_tile<T, 2, 8>(o, gridDim.y, M, N, 0, M, n0, GEMV_COLS, sx, cs);
}

template <typename T, int MT>
__global__ void __launch_bounds__(GEMV_THREADS, gemv_blocks_per_sm<MT, false>())
gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, int M,
            int K, int N, int k_per_split, Out<T> o) {
  extern __shared__ __align__(16) uint32_t xs[];
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0)
    gemv_kn<T, MT, true>(x, w, M, K, N, k_per_split, o, xs);
  else
    gemv_kn<T, MT, false>(x, w, M, K, N, k_per_split, o, xs);
}

// --------------------------------------------------------------- prefill
// Element i of eight packed in 32-bit words (two bf16 or one float each).
template <typename T>
__device__ __forceinline__ T element(const uint32_t (&raw)[8], int i);
template <>
__device__ __forceinline__ float element<float>(const uint32_t (&raw)[8], int i) {
  return __uint_as_float(raw[i]);
}
template <>
__device__ __forceinline__ __nv_bfloat16 element<__nv_bfloat16>(
    const uint32_t (&raw)[8], int i) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(raw[i / 2] >> (16 * (i % 2))));
}

// x (M, K) -> the A8 grid as int8 (M, Kp), Kp = K rounded up to 16, zero
// in the padding.  One thread per 8 bytes, read with one 16-byte (bf16) or
// two 16-byte (float32) loads where the row allows.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                const float* __restrict__ sx_ptr, int M, int K,
                                int Kp, uint2* __restrict__ xq) {
  const size_t octs = static_cast<size_t>(M) * (Kp / 8);
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= octs) return;
  const int m = static_cast<int>(idx / (Kp / 8));
  const int k = 8 * static_cast<int>(idx % (Kp / 8));
  const float s_t = to_f<T>(from_f<T>(*sx_ptr));
  const T* row = x + static_cast<size_t>(m) * K;
  uint2 q;
  if (K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && k + 8 <= K) {
    const uint4* src = reinterpret_cast<const uint4*>(row + k);
    const uint4 a = __ldg(src);
    const uint4 b = sizeof(T) == 4 ? __ldg(src + 1) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t raw[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i / 4] |= static_cast<uint32_t>(quantize<T>(element<T>(raw, i), s_t) &
                                        0xff)
                  << (8 * (i % 4));
    q = make_uint2(w[0], w[1]);
  } else {
    q = make_uint2(quantize4<T>(row, k, K, s_t), quantize4<T>(row, k + 4, K, s_t));
  }
  xq[idx] = q;
}

// grid (ceil(M / 128), ceil(N / 128), splits): the M tiles of one column
// block run together, so each bank tile comes from device memory once.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(pmma::THREADS, 2)
mma_kernel(const int8_t* __restrict__ xq, int Kp, const int8_t* __restrict__ w,
           int M, int K, int N, int k_per_split, Out<T> o) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int m0 = blockIdx.x * pmma::BM, n0 = blockIdx.y * pmma::BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool a_vec = reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  const Col col = fetch_column(o, n0, pmma::BN, N);
  int32_t acc[64];
  pmma::tile_loop<TRANS>(xq, Kp, a_vec, w, M, N, K, m0, n0, k_begin, k_end,
                         smem, acc);
  const Col* cs = publish_column(col, n0, pmma::BN, N);
  __syncthreads();
  const float sx = *o.sx_ptr;
  if (o.part != nullptr) {
#pragma unroll
    for (int v = 0; v < 64; ++v) {
      const int m = m0 + pmma::acc_row(v), n = n0 + pmma::acc_col(v);
      if (m < M && n < N)
        o.part[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = acc[v];
    }
    if (last_arrival(o.counters + blockIdx.y * gridDim.x + blockIdx.x,
                     gridDim.z))
      finish_tile<T, 4, 4>(o, gridDim.z, M, N, m0, pmma::BM, n0, pmma::BN, sx,
                           cs);
    return;
  }
  // epilogue: accumulators v, v + 1 are columns n, n + 1 of one row; where
  // the blocked shuffle keeps them adjacent they are stored as one word
#pragma unroll
  for (int g = 0; g < 16; ++g) {            // 8-column group
    const int cn = pmma::acc_col(4 * g), n = n0 + cn;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const Col c0 = cs[cn];
    const Col c1 = two ? cs[cn + 1] : c0;
    const bool pair = two && c1.o == c0.o + 1 && c0.o % 2 == 0 && N % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {           // rows lane / 4 and + 8
      const int v = 4 * g + 2 * h;
      const int m = m0 + pmma::acc_row(v);
      if (m >= M) continue;
      T* row = o.out + static_cast<size_t>(m) * N;
      const T y0 = finish_value(o, c0, acc[v], sx);
      if (pair) {
        const T y1 = finish_value(o, c1, acc[v + 1], sx);
        if (sizeof(T) == 2) {
          const unsigned short lo = *reinterpret_cast<const unsigned short*>(&y0);
          const unsigned short hi = *reinterpret_cast<const unsigned short*>(&y1);
          *reinterpret_cast<uint32_t*>(row + c0.o) =
              static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
        } else {
          *reinterpret_cast<float2*>(row + c0.o) =
              make_float2(to_f<T>(y0), to_f<T>(y1));
        }
      } else {
        row[c0.o] = y0;
        if (two) row[c1.o] = finish_value(o, c1, acc[v + 1], sx);
      }
    }
  }
}

template <typename T, int MT>
cudaError_t launch_gemv(int trans, int M, int K, int N, int kps, int splits,
                        const void* x, const void* w, const Out<T>& o,
                        cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  if (trans) {
    dim3 grid((N + GEMV_T_COLS - 1) / GEMV_T_COLS, splits);
    gemv_t_kernel<T, MT><<<grid, GEMV_THREADS, MT * kps, st>>>(xt, wt, M, K,
                                                               N, kps, o);
  } else {
    dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, splits);
    gemv_kernel<T, MT><<<grid, GEMV_THREADS, MT * kps + 4 * MT * GEMV_COLS,
                         st>>>(xt, wt, M, K, N, kps, o);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(int regime, int rows, int trans, int M, int K, int N,
                       int kps, const void* x, const void* w, void* xq,
                       const Out<T>& o, cudaStream_t st) {
  const int splits = (K + kps - 1) / kps;
  if (regime == 0) {
    if (rows == 4)
      return launch_gemv<T, 4>(trans, M, K, N, kps, splits, x, w, o, st);
    if (rows == 8)
      return launch_gemv<T, 8>(trans, M, K, N, kps, splits, x, w, o, st);
    return cudaErrorInvalidValue;
  }
  const int Kp = (K + 15) / 16 * 16;
  const size_t octs = static_cast<size_t>(M) * (Kp / 8);
  quantize_kernel<T><<<static_cast<unsigned>((octs + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(x), o.sx_ptr, M, K, Kp, static_cast<uint2*>(xq));
  dim3 grid((M + pmma::BM - 1) / pmma::BM, (N + pmma::BN - 1) / pmma::BN,
            splits);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* wt = static_cast<const int8_t*>(w);
  if (trans) {
    // more than 48 KB of dynamic shared memory: say so once
    static const cudaError_t attr = cudaFuncSetAttribute(
        mma_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pmma::SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
    mma_kernel<T, true><<<grid, pmma::THREADS, pmma::SMEM_BYTES, st>>>(
        a, Kp, wt, M, K, N, kps, o);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        mma_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pmma::SMEM_BYTES);
    if (attr != cudaSuccess) return attr;
    mma_kernel<T, false><<<grid, pmma::THREADS, pmma::SMEM_BYTES, st>>>(
        a, Kp, wt, M, K, N, kps, o);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  trans: weight is (N, K) per-row.
// regime: 0 = decode (`rows` = 4 or 8 >= M), 1 = tensor cores (needs the
// int8 workspace xq of M x roundup(K, 16) bytes).  k_per_split: a multiple
// of 64; ceil(K / k_per_split) splits, which need an int32 workspace
// `part` of splits * M * N and `counters`, one zero word per output tile
// (the kernels leave them zero), when there is more than one.
// Returns the first CUDA error of the launches (0 on success).
int photonic_mvm_fused(const void* x, int dtype, const void* w, int trans,
                       const float* sx, const float* sw, const void* bias,
                       const int* inv_perm, int block, int act, int M, int K,
                       int N, int regime, int rows, int k_per_split, void* xq,
                       void* part, void* counters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = (K + k_per_split - 1) / k_per_split > 1;
  int32_t* p = split ? static_cast<int32_t*>(part) : nullptr;
  unsigned* c = static_cast<unsigned*>(counters);
  cudaError_t e;
  if (dtype == 0) {
    Out<float> o{sx, sw, static_cast<const float*>(bias), inv_perm, block, act,
                 p, c, static_cast<float*>(out)};
    e = launch_all<float>(regime, rows, trans, M, K, N, k_per_split, x, w, xq,
                          o, st);
  } else {
    Out<__nv_bfloat16> o{sx, sw, static_cast<const __nv_bfloat16*>(bias),
                         inv_perm, block, act, p, c,
                         static_cast<__nv_bfloat16*>(out)};
    e = launch_all<__nv_bfloat16>(regime, rows, trans, M, K, N, k_per_split,
                                  x, w, xq, o, st);
  }
  return static_cast<int>(e);
}

const char* photonic_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
