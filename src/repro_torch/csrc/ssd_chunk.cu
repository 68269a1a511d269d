// Mamba-2 intra-chunk SSD for Hopper (sm_90a), float32 on the CUDA cores.
//
// Replaces the TPU kernel `ssd_chunk` (src/repro/kernels/ssd.py, `_kernel`).
// Per (batch*chunk g, head h) cell of a chunk of L steps:
//   cs      = cumsum(dA)                            (L,)
//   y[i, :] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x[j, :]   (L, P)
//   st      = sum_j B_j^T exp(cs_{L-1} - cs_j) x[j, :]             (N, P)
// x (b, nc, L, H, P) arrives dt-folded; dA (b, nc, H, L); B, C (b, nc, L,
// H, N), head-broadcast.  Every input is read through its own element
// strides, so a stride-0 head axis (B/C shared by every head of a group)
// is read in place and gives the same bits as a materialised copy.
// Outputs are contiguous: y (b, nc, L, H, P), st (b, nc, H, N, P).
//
// What bounds it on an H100.  Per cell the lower triangle of C B^T takes
// L(L+1)/2 * N multiply-adds, its product with x L(L+1)/2 * P and the
// state L * N * P, against L*(2N + P + 1) inputs: at mamba2's widths
// (L 256, N 128, P 64) ~17 MFLOP per 0.4 MB, so the work is bound by
// arithmetic.  This first version runs it in float32 on the CUDA cores
// (67 TFLOP/s peak), not the tensor cores (TF32 would round the inputs to
// 10 mantissa bits): `wgmma` tiles are later work.
//
// The TPU kernel's design does not fit: it keeps the whole (L, L) decay
// matrix and the L x N B and C tiles of a cell in VMEM (640 KB at L 256,
// N 128), while a block has 227 KB of shared memory.  So the work is tiled
// the way flash attention tiles a causal score matrix:
//   * grid (nq + 1, H, b*nc), nq = ceil(L / 64): blocks 0..nq-1 each own
//     one 64-row query tile (heaviest first), block nq the chunk state;
//   * every block forms cs once in shared memory (a warp scan);
//   * a query block walks only the key tiles j <= i: per key tile it forms
//     the 64 x 64 scores C_i B_j^T over N in chunks of 32, applies the
//     decay exp(cs_i - cs_j) on the lower triangle (masked entries are set
//     to 0, never exponentiated: cs_i - cs_j > 0 there), stages them in
//     shared memory and accumulates their product with x_j into a 64 x 64
//     y tile held in registers (4 x 4 per thread);
//   * the state block reduces over all L rows, 64 state rows at a time.
// Tiles are zero-filled past L, N and P, so any L <= 4096, any N and
// P <= 64 are right (the smoke models' L 8, N 8, P 16 among them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int BP = 64;        // head dims per tile: P <= BP
constexpr int BN = 64;        // state rows per tile of the state block
constexpr int NC = 32;        // state dims per shared-memory chunk of C B^T
constexpr int PAD = 4;        // row padding of the transposed tiles
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_L = 4096;

struct Strides {              // element strides of the inputs
  long long x[5];             // (b, nc, L, H, P)
  long long dA[4];            // (b, nc, H, L)
  long long B[5];             // (b, nc, L, H, N)
  long long C[5];             // (b, nc, L, H, N)
};

__host__ __device__ constexpr int cs_floats(int L) { return (L + 3) / 4 * 4; }

constexpr int TILE_FLOATS = NC * (BQ + PAD) + NC * (BK + PAD) + BK * BP +
                            BK * (BQ + PAD);

size_t smem_bytes(int L) {
  return sizeof(float) * (static_cast<size_t>(cs_floats(L)) + TILE_FLOATS);
}

// cs = cumsum(dA) over the L steps of one cell, by warp 0: lane k sums its
// own run of rows, then the lanes' totals are scanned with shuffles.
__device__ void chunk_cumsum(const float* __restrict__ dA, long long sl,
                             int L, float* cs) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (L + 31) / 32;
    const int lo = min(lane * per, L), hi = min(lo + per, L);
    float run = 0.f;
    for (int l = lo; l < hi; ++l) {
      run += dA[l * sl];
      cs[l] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float base = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) base = 0.f;
    for (int l = lo; l < hi; ++l) cs[l] += base;
  }
  for (int l = L + threadIdx.x; l < cs_floats(L); l += blockDim.x) cs[l] = 0.f;
  __syncthreads();
}

// x rows j0..j0+BK-1 into sX [BK][BP], zero past L and P.
__device__ __forceinline__ void load_x(const float* __restrict__ xg,
                                       const Strides& s, int j0, int L, int P,
                                       float* sX) {
  for (int e = threadIdx.x; e < BK * BP; e += THREADS) {
    const int jj = e / BP, p = e % BP, j = j0 + jj;
    sX[e] = (j < L && p < P) ? xg[j * s.x[2] + p * s.x[4]] : 0.f;
  }
}

__device__ __forceinline__ void outer_fma(float acc[4][4], const float4& a,
                                          const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

__device__ void state_tile(const float* __restrict__ xg,
                           const float* __restrict__ Bg, const Strides& s,
                           const float* cs, int L, int P, int N, float* sX,
                           float* sBd, float* __restrict__ st) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float cl = cs[L - 1];
  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[4][4] = {};
    for (int j0 = 0; j0 < L; j0 += BK) {
      __syncthreads();
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int jj = e / BN, nn = e % BN, j = j0 + jj, n = n0 + nn;
        sBd[jj * (BN + PAD) + nn] =
            (j < L && n < N) ? Bg[j * s.B[2] + n * s.B[4]] * expf(cl - cs[j])
                             : 0.f;
      }
      load_x(xg, s, j0, L, P, sX);
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < BK; ++jj) {
        const float4 a =
            *reinterpret_cast<const float4*>(&sBd[jj * (BN + PAD) + ty * 4]);
        const float4 b =
            *reinterpret_cast<const float4*>(&sX[jj * BP + tx * 4]);
        outer_fma(acc, a, b);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx * 4 + c;
        if (n < N && p < P) st[static_cast<long long>(n) * P + p] = acc[r][c];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                 const float* __restrict__ B, const float* __restrict__ C,
                 Strides s, int nc, int L, int H, int P, int N, int nq,
                 float* __restrict__ y, float* __restrict__ st) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;
  float* sC = cs + cs_floats(L);             // [NC][BQ + PAD], transposed
  float* sB = sC + NC * (BQ + PAD);          // [NC][BK + PAD], transposed
  float* sX = sB + NC * (BK + PAD);          // [BK][BP]
  float* sS = sX + BK * BP;                  // [BK][BQ + PAD], transposed

  const int g = blockIdx.z, h = blockIdx.y;
  const long long bi = g / nc, ci = g % nc;
  const float* xg = x + bi * s.x[0] + ci * s.x[1] + h * s.x[3];
  const float* dAg = dA + bi * s.dA[0] + ci * s.dA[1] + h * s.dA[2];
  const float* Bg = B + bi * s.B[0] + ci * s.B[1] + h * s.B[3];
  const float* Cg = C + bi * s.C[0] + ci * s.C[1] + h * s.C[3];
  chunk_cumsum(dAg, s.dA[3], L, cs);

  if (blockIdx.x == nq) {
    state_tile(xg, Bg, s, cs, L, P, N, sX, sS,
               st + (static_cast<long long>(g) * H + h) * N * P);
    return;
  }
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = nq - 1 - blockIdx.x;        // heaviest query tiles first
  const int i0 = qt * BQ;
  float acc[4][4] = {};
  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * BK;
    float sc[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += NC) {
      __syncthreads();
      for (int e = tid; e < NC * BQ; e += THREADS) {
        const int k = e % NC, r = e / NC, n = n0 + k;
        const int i = i0 + r, j = j0 + r;
        sC[k * (BQ + PAD) + r] =
            (n < N && i < L) ? Cg[i * s.C[2] + n * s.C[4]] : 0.f;
        sB[k * (BK + PAD) + r] =
            (n < N && j < L) ? Bg[j * s.B[2] + n * s.B[4]] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < NC; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(&sC[k * (BQ + PAD) + ty * 4]);
        const float4 b =
            *reinterpret_cast<const float4*>(&sB[k * (BK + PAD) + tx * 4]);
        outer_fma(sc, a, b);
      }
    }
    // the previous key tile's product is done (the syncs above), so the
    // x tile and the decayed scores can be restaged
    load_x(xg, s, j0, L, P, sX);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx * 4 + c;
        const float v =
            (i < L && j <= i) ? sc[r][c] * expf(cs[i] - cs[j]) : 0.f;
        sS[(tx * 4 + c) * (BQ + PAD) + ty * 4 + r] = v;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < BK; ++jj) {
      const float4 a =
          *reinterpret_cast<const float4*>(&sS[jj * (BQ + PAD) + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sX[jj * BP + tx * 4]);
      outer_fma(acc, a, b);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= L) continue;
    float* yrow = y + ((static_cast<long long>(g) * L + i) * H + h) * P;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx * 4 + c;
      if (p < P) yrow[p] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// x, dA, B, C: float32 device pointers read through `strides` (19 element
// strides on the host: x's 5, dA's 4, B's 5, C's 5, in the layouts above).
// y (b, nc, L, H, P) and st (b, nc, H, N, P): contiguous float32.  The
// caller checks 1 <= L <= MAX_L, 1 <= P <= BP, N >= 1, H and b * nc within
// the grid's limits.  Returns cudaGetLastError() after the launch (or the
// error of raising the shared-memory limit).
int ssd_chunk(const float* x, const float* dA, const float* B, const float* C,
              const long long* strides, int b, int nc, int L, int H, int P,
              int N, float* y, float* st, void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(MAX_L)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  Strides s;
  for (int i = 0; i < 5; ++i) s.x[i] = strides[i];
  for (int i = 0; i < 4; ++i) s.dA[i] = strides[5 + i];
  for (int i = 0; i < 5; ++i) s.B[i] = strides[9 + i];
  for (int i = 0; i < 5; ++i) s.C[i] = strides[14 + i];
  const int nq = (L + BQ - 1) / BQ;
  dim3 grid(nq + 1, H, b * nc);
  ssd_chunk_kernel<<<grid, THREADS, smem_bytes(L),
                     static_cast<cudaStream_t>(stream)>>>(
      x, dA, B, C, s, nc, L, H, P, N, nq, y, st);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
