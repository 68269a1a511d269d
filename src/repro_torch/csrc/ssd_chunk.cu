// Mamba-2 intra-chunk SSD for Hopper (sm_90a) on the TF32 tensor cores,
// error-compensated ("3xTF32") to float32 accuracy.
//
// Replaces the TPU kernel `ssd_chunk` (src/repro/kernels/ssd.py, `_kernel`).
// Per (batch*chunk g, head h) cell of a chunk of L steps:
//   cs      = cumsum(dA)                            (L,)
//   y[i, :] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x[j, :]   (L, P)
//   st      = sum_j B_j^T exp(cs_{L-1} - cs_j) x[j, :]             (N, P)
// x (b, nc, L, H, P) arrives dt-folded; dA (b, nc, H, L); B, C (b, nc, L,
// H, N), head-broadcast.  Every input is read through its own element
// strides, so a stride-0 head axis (B/C shared by every head of a group)
// is read in place.  Outputs are contiguous: y (b, nc, L, H, P), st (b,
// nc, H, N, P).
//
// What bounds it on an H100.  Per cell the lower triangle of C B^T takes
// L(L+1)/2 * N multiply-adds, its product with x L(L+1)/2 * P and the
// state L * N * P.  The serving path passes B and C as a stride-0 view
// over the heads (one group), so C B^T is one matrix per chunk: computed
// once per group of heads it is half the work at mamba2's widths (L 256,
// N 128, P 64, 48 heads).  That work is bound by arithmetic, so all three
// products run on the TF32 tensor cores, each operand split as a = hi +
// lo (hi = tf32(a), lo = tf32(a - hi), both rounded to nearest, ties
// away) and each product taken as lo*hi + hi*lo + hi*hi into float32
// accumulators: float32-level accuracy, where one-pass TF32 rounds every
// input to 10 mantissa bits and would move the A8 roundings of the next
// matmul.
//
// Design.  256 threads (two warpgroups), two blocks per SM at L <= 256;
// one launch, a flat grid of blocks, heaviest first; each block serves a
// group of heads (the launch plan in kernels/ssd.py picks the groups'
// sizes).  Each product is `wgmma.m64nNk8` in TF32, three times (lo*hi,
// hi*lo, hi*hi), each warpgroup taking one half of the contraction:
//   * a query block owns a 64-row query tile and walks the key tiles
//     j <= i in strips of SK tiles.  Per strip it computes the scores
//     C_i B_j^T over N: per 32-wide N slice the raw C and B slices (copied
//     with cp.async) are split once into hi and lo TF32 tiles in the
//     K-major, 128-byte-swizzled layout wgmma reads, and warpgroup k runs
//     `m64n32k8` for key half k with both operands in shared memory.  The
//     scores stay in shared memory in the accumulator layout: with stride-0
//     B/C once for all heads of the group, with materialised B/C once per
//     head, in the same order (so both give the same bits).  Then one
//     pipeline of (head, key tile) stages: the stage's raw x tile (and a
//     head's dA row) arrives by cp.async, is split into hi and lo tiles
//     transposed to K-major, and the copy of the next stage starts into
//     the freed buffer.  Warpgroup k takes key half k: it forms the decay
//     exp(cs_i - cs_j) on the causal triangle only (masked entries are set
//     to 0, never exponentiated: cs_i - cs_j > 0 there and would
//     overflow), multiplies it into its scores, splits them in registers
//     (the A operand) and runs `m64n64k8` against the x tile.  The halves
//     are added through shared memory per head; a strip past the first
//     adds into y.
//   * a state block owns 64 state rows (of N) and runs (B o d)^T x over
//     all L keys, d = exp(cs_{L-1} - cs), in the same stages: warpgroup k
//     forms (B o d)^T for key half k in registers from the raw B tile.
// The accumulator layout (a thread holds columns 2t, 2t+1 of each 8-wide
// tile) differs from the A operand's (columns t, t+4): the key index, the
// contraction axis of both x products, is permuted the same way in the A
// operand and in the x tile (position t is key 2t, position t+4 key 2t+1
// of each 8 keys), so the scores feed the next product as they sit.
// Accumulators start with wgmma's scale-d = 0, never zeroed by other
// instructions, which would serialise the wgmmas.  Tiles are zero-filled
// past L, N and P, so any L <= MAX_L, any N and P <= BP are right (the
// smoke models' L 8, N 8, P 16 among them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int BP = 64;        // head dims: P <= BP
constexpr int BN = 64;        // state rows per state block
constexpr int NCH = 32;       // N per staged slice of the scores
constexpr int SK = 3;         // key tiles per strip of scores
constexpr int THREADS = 256;  // 8 warps, two warpgroups
constexpr int MAX_L = 4096;
constexpr int C_LD = NCH + 8;   // raw C and B slices [row][n]
constexpr int X_LD = BP + 4;    // raw x tile [key][p], = 4 mod 32
constexpr int B_LD = BN + 4;    // raw state B tile [key][n], = 4 mod 32
constexpr int TILE = 64 * 64;   // one 64 x 64 float tile
constexpr int XT = 64 * X_LD;
constexpr int BT = 64 * B_LD;
constexpr int SLICE = 64 * NCH;  // one split 64 x 32 slice (hi or lo)
// Shared memory of a block, in floats, after cs and two dA rows (3 * csf),
// from a 1024-byte boundary (the swizzle's period): for a query block the
// stage area, which holds either the four split scores slices (C and B,
// hi and lo) and the two raw slices, or the split x tile (hi, lo) and the
// raw x tile, then the scores strip; for a state block the split x tile,
// the raw B and x tiles and the decay row.  The halves' sum reuses the
// split x tile.  At L <= 256 two blocks fit an SM (106.5 KB each).
constexpr int STAGE_C = 4 * SLICE + 2 * 64 * C_LD;
constexpr int STAGE_X = 2 * TILE + XT;
constexpr int STAGE_Q = STAGE_C > STAGE_X ? STAGE_C : STAGE_X;
constexpr int REGION_Q = STAGE_Q + SK * TILE;
constexpr int REGION_S = 2 * TILE + BT + XT;

struct Strides {              // element strides of the inputs
  long long x[5];             // (b, nc, L, H, P)
  long long dA[4];            // (b, nc, H, L)
  long long B[5];             // (b, nc, L, H, N)
  long long C[5];             // (b, nc, L, H, N)
};

struct Args {
  const float* x;
  const float* dA;
  const float* B;
  const float* C;
  float* y;
  float* st;
  Strides s;
  int nc, L, H, P, N;
  int nq, nn;                 // query tiles, state blocks per cell
  int hb, nhg, qcells;        // query blocks: heads per block, groups, cells
  int hbs, nsg, scells;       // state blocks: the same
  int heavy;                  // query tiles launched ahead of the state
  int csf;                    // floats of a cumsum row (nq * 64)
  int shared;                 // B and C have head stride 0
  int vx, vB, vC;             // 16-byte cp.async allowed
};

size_t smem_floats(int L) {
  const int csf = (L + 63) / 64 * 64;
  const int q = REGION_Q, s = REGION_S + csf;
  return 3 * static_cast<size_t>(csf) + 256 + (q > s ? q : s);
}

// ---------------------------------------------------------------- PTX
// hi = tf32(a), lo = tf32(a - hi), each `cvt.rna.tf32.f32` (round to
// nearest, ties away: sm_90 runs it as add half a TF32 ulp, clear the 13
// low bits, behind a guard that keeps inf and NaN, so a NaN in x or the
// scores stays NaN in y).  In one asm block, so the compiler cannot fold
// lo = a - hi to 0.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  asm("{\n\t.reg .f32 h, r;\n\t"
      "cvt.rna.tf32.f32 %0, %2;\n\t"
      "mov.b32 h, %0;\n\t"
      "sub.f32 r, %2, h;\n\t"
      "cvt.rna.tf32.f32 %1, r;\n\t}"
      : "=r"(hi), "=r"(lo)
      : "f"(a));
}

// d (64 x 64 of the warpgroup, f32) = a (64 x 8, this thread's four TF32
// values) . b (8 x 64, K-major in shared memory, descriptor db), plus d
// when `acc` (the first product of a sum passes 0: the accumulators are
// never zeroed by other instructions, which would serialise the wgmmas)
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

// d (64 x 32 of the warpgroup, f32) = a (64 x 8) . b (8 x 32), both
// K-major in shared memory (descriptors da, db), plus d when `acc`
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4][4], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// the 3xTF32 product of one 8-key step on the warpgroup
__device__ __forceinline__ void wgmma3(float (&d)[8][4],
                                       const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint64_t bh,
                                       uint64_t bl, int acc) {
  wgmma_tf32(d, al, bh, acc);
  wgmma_tf32(d, ah, bl, 1);
  wgmma_tf32(d, ah, bh, 1);
}

// Keeps the compiler from moving accumulator accesses into a wgmma group
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's shared-memory writes become visible to the tensor cores
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major tile at shared address `addr` (1024-byte
// aligned rows of 128 bytes, 128-byte swizzle): start address, leading
// byte offset (unused here), 1024 bytes between 8-row groups, swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- staging
// A ROWS x COLS tile of a strided matrix (element (r, c) at src + r * rs +
// c * cstr) into dst [ROWS][ld], zero past nr rows and ncol columns.  With
// `vec` (cstr 1, rs a multiple of 4, src 16-byte aligned) 16 bytes a copy.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, long long rs,
                                          long long cstr, int nr, int ncol,
                                          bool vec) {
  if (vec) {
    constexpr int Q = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * Q; e += THREADS) {
      const int r = e / Q, c = (e % Q) * 4;
      const int n = r < nr ? min(max(ncol - c, 0), 4) : 0;
      cp_async16(dst + r * ld + c, n ? src + r * rs + c : src, 4 * n);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const bool ok = r < nr && c < ncol;
      cp_async4(dst + r * ld + c, ok ? src + r * rs + c * cstr : src,
                ok ? 4 : 0);
    }
  }
}

// dA's L steps of one cell (stride sl) into dst, queued with the tile
// copies of the stage that first needs them
__device__ __forceinline__ void load_dA(float* dst, const float* dA,
                                        long long sl, int L) {
  for (int l = threadIdx.x; l < L; l += THREADS)
    cp_async4(dst + l, dA + l * sl, 4);
}

// cs = cumsum(d) over L steps staged in shared memory, by warp 0: lane k
// sums its own run of rows, then the lanes' totals are scanned with
// shuffles.  Zero from L to csf.  The caller synchronises after.
__device__ __forceinline__ void cumsum(const float* d, int L, int csf,
                                       float* cs) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (L + 31) / 32;
    const int lo = min(lane * per, L), hi = min(lo + per, L);
    float run = 0.f;
    for (int l = lo; l < hi; ++l) {
      run += d[l];
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
  for (int l = L + threadIdx.x; l < csf; l += THREADS) cs[l] = 0.f;
}

// A raw x tile [64 keys][X_LD] into its hi and lo TF32 tiles (at xt and
// xt + TILE), transposed to K-major: row p holds the 64 keys in two
// 128-byte blocks (keys 0..31, then 32..63, TILE / 2 floats apart), each
// 8 keys in the permuted order 0 2 4 6 1 3 5 7, 16-byte chunk c of row p
// at chunk c ^ (p % 8).  Ends with the async-proxy fence; the caller
// synchronises.
__device__ __forceinline__ void split_x(const float* raw, float* xt) {
  for (int e = threadIdx.x; e < 64 * 16; e += THREADS) {
    const int p = e & 63, c = e >> 6;            // chunk c: positions 4c..
    const int k0 = (c >> 1) * 8 + (c & 1);       // keys k0, k0 + 2, ...
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split(raw[(k0 + 2 * q) * X_LD + p], hi[q], lo[q]);
    const int off = (c >> 3) * (TILE / 2) + p * 32 + (((c & 7) ^ (p & 7)) << 2);
    *reinterpret_cast<uint4*>(xt + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xt + TILE + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  fence_proxy_async();
}

// s * exp(ci - cj) on the causal triangle (`keep`), else 0.  A masked
// entry's difference (> 0 there, it would overflow) is never
// exponentiated: exp runs on 0 and the select drops it, without a branch.
__device__ __forceinline__ float decayed(float s, float ci, float cj,
                                         bool keep) {
  const float e = expf(keep ? ci - cj : 0.f);
  return keep ? s * e : 0.f;
}

// The descriptors of 8-key step ks (0..7) of the split x tile
__device__ __forceinline__ void x_desc(const float* xt, int ks, uint64_t& bh,
                                       uint64_t& bl) {
  const uint32_t a =
      smem_addr(xt) + (ks >> 2) * (TILE / 2) * 4 + (ks & 3) * 32;
  bh = smem_desc(a);
  bl = smem_desc(a + TILE * 4);
}

// --------------------------------------------------------- query block
// A raw 64 x NCH slice [row][C_LD] into its hi and lo TF32 tiles (at dst
// and dst + SLICE): K-major rows of 128 bytes, 16-byte chunk c of row r at
// chunk c ^ (r % 8).  Each thread splits four 16-byte chunks.
__device__ __forceinline__ void split_slice(const float* raw, float* dst,
                                            int e) {
  const int r = e >> 3, c = e & 7;
  const float4 v = *reinterpret_cast<const float4*>(raw + r * C_LD + 4 * c);
  uint32_t hi[4], lo[4];
  split(v.x, hi[0], lo[0]);
  split(v.y, hi[1], lo[1]);
  split(v.z, hi[2], lo[2]);
  split(v.w, hi[3], lo[3]);
  const int off = r * NCH + ((c ^ (r & 7)) << 2);
  *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + SLICE + off) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Scores C_i B_j^T of key tiles s0..s1-1 over N into sS, in the
// accumulator layout: float4 [key tile][row tile][key block][lane].  Per
// 32-wide N slice: the raw C and B slices are split into TF32 hi / lo
// tiles, the copy of the next slice starts, and warpgroup k runs
// `wgmma.m64n32k8` for key half k, both operands from shared memory.
__device__ void scores(const Args& a, const float* Cg, const float* Bg,
                       int i0, int s0, int s1, float* stage, float* sS) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp & 3, kh = warp >> 2;
  const int nch = (a.N + NCH - 1) / NCH;
  const int total = (s1 - s0) * nch;
  float* tiles = stage;                        // C hi, C lo, B hi, B lo
  float* rawC = stage + 4 * SLICE;
  float* rawB = rawC + 64 * C_LD;
  auto load = [&](int st) {
    const int kt = s0 + st / nch, n0 = (st % nch) * NCH, j0 = kt * BK;
    load_tile<64, NCH>(rawC, C_LD, Cg + i0 * a.s.C[2] + n0 * a.s.C[4],
                       a.s.C[2], a.s.C[4], a.L - i0, a.N - n0, a.vC);
    load_tile<64, NCH>(rawB, C_LD, Bg + j0 * a.s.B[2] + n0 * a.s.B[4],
                       a.s.B[2], a.s.B[4], a.L - j0, a.N - n0, a.vB);
    cp_commit();
  };
  load(0);
  float acc[4][4] = {};
  const uint32_t ta = smem_addr(tiles);
  for (int st = 0; st < total; ++st) {
    const int c = st % nch;
    cp_wait<0>();
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * 64 * (NCH / 4); e += THREADS) {
      const bool isB = e >= 64 * (NCH / 4);
      split_slice(isB ? rawB : rawC, tiles + (isB ? 2 * SLICE : 0),
                  e & (64 * (NCH / 4) - 1));
    }
    fence_proxy_async();
    __syncthreads();
    if (st + 1 < total) load(st + 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NCH / 8; ++ks) {
      const uint32_t ca = ta + ks * 32;
      const uint32_t cb = ta + 2 * SLICE * 4 + kh * 32 * 128 + ks * 32;
      wgmma_tf32_ss(acc, smem_desc(ca + SLICE * 4), smem_desc(cb),
                    ks > 0 || c > 0);
      wgmma_tf32_ss(acc, smem_desc(ca), smem_desc(cb + SLICE * 4), 1);
      wgmma_tf32_ss(acc, smem_desc(ca), smem_desc(cb), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
    if (c == nch - 1) {
      float4* s4 = reinterpret_cast<float4*>(sS) +
                   (((st / nch) * 4 + mt) * 8 + kh * 4) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        s4[nt * 32] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2],
                                  acc[nt][3]);
    }
    __syncthreads();                 // the split tiles are free
  }
}

// The two key halves' sums of the 64 x 64 y tile (warpgroup k holds key
// half k; rows mt * 16 + g, + 8, columns nt * 8 + 2t, + 1) added through
// `red` (TILE floats): each warp keeps the column tiles of its own half
// and writes rows < nrows and columns < P of out (row stride rs), adding
// to what is there with `add`.
__device__ __forceinline__ void sum_halves_store(const float (&acc)[8][4],
                                                 float* red, float* out,
                                                 long long rs, int nrows,
                                                 int P, bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp & 3, kh = warp >> 2;
  float4* r4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    if ((nt >> 2) != kh)
      r4[(mt * 8 + nt) * 32 + lane] =
          make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
  __syncthreads();
  const int r0 = mt * 16 + (lane >> 2);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int nt = kh * 4 + q;
    const float4 o = r4[(mt * 8 + nt) * 32 + lane];
    const float v[4] = {acc[nt][0] + o.x, acc[nt][1] + o.y,
                        acc[nt][2] + o.z, acc[nt][3] + o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >> 1) * 8;
      const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
      if (r < nrows && c < P) {
        float* o_ = out + r * rs + c;
        *o_ = add ? *o_ + v[e] : v[e];
      }
    }
  }
}

// y of heads hA..hB-1 over the strip's key tiles s0..s1-1: one pipeline
// of (head, key tile) stages.  A stage splits its raw x tile, then starts
// the copy of the next stage's tile into the freed buffer, so the copy
// runs under the stage's decay and tensor-core work.
__device__ void y_stages(const Args& a, long long bi, long long ci, int g,
                         int i0, int s0, int s1, int hA, int hB, float* smem,
                         float* xt, const float* sS) {
  float* cs = smem;
  float* dAb = smem + a.csf;
  float* raw = xt + 2 * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp & 3, kh = warp >> 2, t = lane & 3;
  const int ia = i0 + mt * 16 + (lane >> 2), ib = ia + 8;
  const bool va = ia < a.L, vb = ib < a.L;
  const int nk = s1 - s0, total = (hB - hA) * nk;
  auto load = [&](int s) {
    const int h = hA + s / nk, kt = s0 + s % nk, j0 = kt * BK;
    const long long off = bi * a.s.x[0] + ci * a.s.x[1] + h * a.s.x[3];
    load_tile<64, BP>(raw, X_LD, a.x + off + j0 * a.s.x[2], a.s.x[2],
                      a.s.x[4], a.L - j0, a.P, a.vx);
    if (kt == s0)
      load_dA(dAb + ((s / nk) & 1) * a.csf,
              a.dA + bi * a.s.dA[0] + ci * a.s.dA[1] + h * a.s.dA[2],
              a.s.dA[3], a.L);
    cp_commit();
  };
  load(0);
  float acc[8][4] = {};
  float ca = 0.f, cb = 0.f;
  for (int s = 0; s < total; ++s) {
    const int h = hA + s / nk, kt = s0 + s % nk;
    cp_wait<0>();
    __syncthreads();
    split_x(raw, xt);
    if (kt == s0) cumsum(dAb + ((s / nk) & 1) * a.csf, a.L, a.csf, cs);
    __syncthreads();
    if (s + 1 < total) load(s + 1);
    if (kt == s0) {
      ca = cs[ia];
      cb = cs[ib];
    }
    // this warpgroup's key half: decayed scores as the A operand
    const float4* s4 = reinterpret_cast<const float4*>(sS) +
                       (((kt - s0) * 4 + mt) * 8 + kh * 4) * 32 + lane;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float4 sv = s4[ks * 32];
      const int ja = kt * BK + kh * 32 + ks * 8 + 2 * t, jb = ja + 1;
      const float2 cj = *reinterpret_cast<const float2*>(cs + ja);
      split(decayed(sv.x, ca, cj.x, va && ja <= ia), ah[ks][0], al[ks][0]);
      split(decayed(sv.z, cb, cj.x, vb && ja <= ib), ah[ks][1], al[ks][1]);
      split(decayed(sv.y, ca, cj.y, va && jb <= ia), ah[ks][2], al[ks][2]);
      split(decayed(sv.w, cb, cj.y, vb && jb <= ib), ah[ks][3], al[ks][3]);
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint64_t bh, bl;
      x_desc(xt, kh * 4 + ks, bh, bl);
      wgmma3(acc, ah[ks], al[ks], bh, bl, ks > 0 || kt > s0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
    __syncthreads();                 // both halves done with the x tile
    if (kt == s1 - 1)
      sum_halves_store(
          acc, xt,
          a.y + ((static_cast<long long>(g) * a.L + i0) * a.H + h) * a.P,
          static_cast<long long>(a.H) * a.P, a.L - i0, a.P, s0 > 0);
  }
  __syncthreads();
}

__device__ void query_block(const Args& a, int qt, int g, int h0, int h1,
                            float* smem, float* xt) {
  float* sS = xt + STAGE_Q;
  const long long bi = g / a.nc, ci = g % a.nc;
  const int i0 = qt * BQ, nk = qt + 1;
  for (int s0 = 0; s0 < nk; s0 += SK) {
    const int s1 = min(nk, s0 + SK);
    // stride-0 B/C: one scores strip for every head of the group
    const int step = a.shared ? h1 - h0 : 1;
    for (int h = h0; h < h1; h += step) {
      __syncthreads();
      scores(a, a.C + bi * a.s.C[0] + ci * a.s.C[1] + h * a.s.C[3],
             a.B + bi * a.s.B[0] + ci * a.s.B[1] + h * a.s.B[3], i0, s0, s1,
             xt, sS);
      y_stages(a, bi, ci, g, i0, s0, s1, h, h + step, smem, xt, sS);
    }
  }
}

// --------------------------------------------------------- state block
// (B o d)^T x over all L keys, d = exp(cs_{L-1} - cs), for the 64 state
// rows from ns * BN and heads h0..h1-1, one pipeline of (head, key tile)
// stages: a stage splits the raw x tile, forms (B o d)^T for its key half
// (warpgroup k: keys 32k..32k+31) in registers, then starts the next
// stage's copies into the freed buffers, under its tensor-core work.  The
// halves' sums are added per head, as in the query block.
__device__ void state_block(const Args& a, int ns, int g, int h0, int h1,
                            float* smem, float* xt) {
  float* cs = smem;
  float* dAb = smem + a.csf;
  float* rawB = xt + 2 * TILE;
  float* rawx = rawB + BT;
  float* dd = rawx + XT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp & 3, kh = warp >> 2, gq = lane >> 2, t = lane & 3;
  const long long bi = g / a.nc, ci = g % a.nc;
  const int n0 = ns * BN, nq = a.nq, total = (h1 - h0) * nq;
  auto load = [&](int s) {
    const int h = h0 + s / nq, kt = s % nq, j0 = kt * BK;
    load_tile<64, BN>(rawB, B_LD,
                      a.B + bi * a.s.B[0] + ci * a.s.B[1] + h * a.s.B[3] +
                          n0 * a.s.B[4] + j0 * a.s.B[2],
                      a.s.B[2], a.s.B[4], a.L - j0, a.N - n0, a.vB);
    load_tile<64, BP>(rawx, X_LD,
                      a.x + bi * a.s.x[0] + ci * a.s.x[1] + h * a.s.x[3] +
                          j0 * a.s.x[2],
                      a.s.x[2], a.s.x[4], a.L - j0, a.P, a.vx);
    if (kt == 0)
      load_dA(dAb + ((s / nq) & 1) * a.csf,
              a.dA + bi * a.s.dA[0] + ci * a.s.dA[1] + h * a.s.dA[2],
              a.s.dA[3], a.L);
    cp_commit();
  };
  load(0);
  float acc[8][4] = {};
  for (int s = 0; s < total; ++s) {
    const int h = h0 + s / nq, kt = s % nq;
    cp_wait<0>();
    __syncthreads();
    split_x(rawx, xt);
    if (kt == 0) {
      cumsum(dAb + ((s / nq) & 1) * a.csf, a.L, a.csf, cs);
      __syncthreads();
      const float cl = cs[a.L - 1];
      for (int l = threadIdx.x; l < a.csf; l += THREADS)
        dd[l] = l < a.L ? expf(cl - cs[l]) : 0.f;
    }
    __syncthreads();
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int kb = kh * 32 + ks * 8;
      const float2 d =
          *reinterpret_cast<const float2*>(dd + kt * BK + kb + 2 * t);
      const float* bp = rawB + (kb + 2 * t) * B_LD + mt * 16 + gq;
      split(bp[0] * d.x, ah[ks][0], al[ks][0]);
      split(bp[8] * d.x, ah[ks][1], al[ks][1]);
      split(bp[B_LD] * d.y, ah[ks][2], al[ks][2]);
      split(bp[B_LD + 8] * d.y, ah[ks][3], al[ks][3]);
    }
    __syncthreads();                 // the raw tiles are free
    if (s + 1 < total) load(s + 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint64_t bh, bl;
      x_desc(xt, kh * 4 + ks, bh, bl);
      wgmma3(acc, ah[ks], al[ks], bh, bl, ks > 0 || kt > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
    __syncthreads();                 // both halves done with the x tile
    if (kt == nq - 1)
      sum_halves_store(
          acc, xt,
          a.st + ((static_cast<long long>(g) * a.H + h) * a.N + n0) * a.P,
          a.P, a.N - n0, a.P, false);
  }
  __syncthreads();
}

// Block f of the flat grid, heaviest first: the `heavy` longest query
// tiles of every query cell, then the state blocks of every state cell,
// then the other query tiles.  A query cell is (batch * chunk, group of hb
// heads), a state cell (batch * chunk, group of hbs heads).
__global__ void __launch_bounds__(THREADS, 2) ssd_mma_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  // the split x tile starts at a 1024-byte boundary (the swizzle's period)
  const uint32_t base = smem_addr(smem + 3 * a.csf);
  float* xt = smem + 3 * a.csf + (((base + 1023) & ~1023u) - base) / 4;
  int f = blockIdx.x;
  const int front = a.heavy * a.qcells, states = a.nn * a.scells;
  if (f >= front && f < front + states) {
    f -= front;
    const int cell = f % a.scells, g = cell / a.nsg;
    const int h0 = (cell % a.nsg) * a.hbs;
    state_block(a, f / a.scells, g, h0, min(a.H, h0 + a.hbs), smem, xt);
    return;
  }
  if (f >= front) f -= states;
  const int cell = f % a.qcells, g = cell / a.nhg;
  const int h0 = (cell % a.nhg) * a.hb;
  query_block(a, a.nq - 1 - f / a.qcells, g, h0, min(a.H, h0 + a.hb), smem,
              xt);
}

}  // namespace

extern "C" {

// x, dA, B, C: float32 device pointers read through `strides` (19 element
// strides on the host: x's 5, dA's 4, B's 5, C's 5, in the layouts above).
// y (b, nc, L, H, P) and st (b, nc, H, N, P): contiguous float32.  `hb`
// heads per query block, `hbs` per state block and `heavy` query tiles
// ahead of the state blocks come from the launch plan (kernels/ssd.py
// `ssd_launch_plan`); `vec` bit 0/1/2 allows 16-byte copies of x / B / C.
// The caller checks 1 <= L <= MAX_L, 1 <= P <= BP, N >= 1, hb, hbs >= 1
// and the grid's size.  Returns cudaGetLastError() after the launch (or
// the error of raising the shared-memory limit).
int ssd_chunk(const float* x, const float* dA, const float* B, const float* C,
              const long long* strides, int b, int nc, int L, int H, int P,
              int N, int hb, int hbs, int heavy, int vec, float* y,
              float* st, void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * smem_floats(MAX_L)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  Args a;
  a.x = x;
  a.dA = dA;
  a.B = B;
  a.C = C;
  a.y = y;
  a.st = st;
  for (int i = 0; i < 5; ++i) a.s.x[i] = strides[i];
  for (int i = 0; i < 4; ++i) a.s.dA[i] = strides[5 + i];
  for (int i = 0; i < 5; ++i) a.s.B[i] = strides[9 + i];
  for (int i = 0; i < 5; ++i) a.s.C[i] = strides[14 + i];
  a.nc = nc;
  a.L = L;
  a.H = H;
  a.P = P;
  a.N = N;
  a.nq = (L + BQ - 1) / BQ;
  a.nn = (N + BN - 1) / BN;
  a.hb = hb;
  a.nhg = (H + hb - 1) / hb;
  a.qcells = b * nc * a.nhg;
  a.hbs = hbs;
  a.nsg = (H + hbs - 1) / hbs;
  a.scells = b * nc * a.nsg;
  a.heavy = heavy;
  a.csf = a.nq * BQ;
  a.shared = a.s.B[3] == 0 && a.s.C[3] == 0;
  a.vx = vec & 1;
  a.vB = (vec >> 1) & 1;
  a.vC = (vec >> 2) & 1;
  const long long blocks = static_cast<long long>(a.nq) * a.qcells +
                           static_cast<long long>(a.nn) * a.scells;
  ssd_mma_kernel<<<static_cast<unsigned>(blocks), THREADS,
                   sizeof(float) * smem_floats(L),
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
