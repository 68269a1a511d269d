// Tensor-core tile loop of the photonic W8A8 MVM for Hopper (sm_90a), and
// the register byte transpose that turns an N-contiguous (K, N) bank into
// the K-major layout int8 tensor cores read.
//
// `tile_loop` computes one BM x BN block of the exact int32 product
// acc[m][n] = sum_k a[m][k] * W[k][n] over a K range, from an int8
// activation matrix `a` (M rows, leading dimension lda) and an int8 bank in
// either OBU orientation:
//   * the (N, K) per-row bank (TRANS) is K-major already, as is `a`: both
//     are copied with 16-byte `cp.async` into a STAGES-deep shared-memory
//     ring;
//   * the (K, N) per-column bank has N contiguous.  Each thread loads a
//     16 (k) x 4 (n) byte block as sixteen 32-bit words, transposes it in
//     registers with `__byte_perm` (`transpose4x4`) and stores one 16-byte
//     K-major chunk per column.  The loads for a stage are issued before
//     the product of the current stage and stored after it, so they are in
//     flight while the tensor cores run.
// The product is Hopper's warpgroup MMA, `wgmma.mma_async.m64n128k32` s8 x
// s8 -> s32 with both operands read from shared memory through matrix
// descriptors: two warpgroups, each owning 64 rows of the 128 x 128 tile
// (64 int32 accumulators per thread, no operand registers).  Tiles are
// rows of BK = 128 bytes in the 128-byte swizzle the descriptors name:
// 16-byte chunk c of row r sits at chunk c ^ (r % 8), and each thread's
// transposed (K, N) stores are ordered so a store phase hits eight
// distinct bank groups.  Rows past M or N and bytes past the K range are
// zero in shared memory: ragged edges need no host padding.
//
// Integer products are exact, so the result does not depend on the tile
// shape, the K split or the summation order: the kernels that adopt this
// loop keep the bit-for-bit equalities of `photonic_mvm_common.cuh`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pmma {

constexpr int BM = 128;          // activation rows per block
constexpr int BN = 128;          // output columns per block
constexpr int BK = 128;          // int8 reduction depth per stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;     // 2 warpgroups, 64 rows each
constexpr int WG_ROWS = 64;
constexpr int CHUNKS = BK / 16;  // 16-byte chunks per tile row
constexpr int STAGE_BYTES = (BM + BN) * BK;
// 96 KB of tiles, plus room to align them to the 1024 bytes the swizzle
// pattern repeats over: dynamic
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;

// 4 x 4 byte transpose: r_i holds row i's bytes (cols 0..3); c_j gets
// column j's bytes (rows 0..3), row 0 in the low byte.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t& c0, uint32_t& c1,
                                             uint32_t& c2, uint32_t& c3) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);   // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);   // r2.0 r3.0 r2.1 r3.1
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);   // r0.2 r1.2 r0.3 r1.3
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c0 = __byte_perm(t0, t1, 0x5410);
  c1 = __byte_perm(t0, t1, 0x7632);
  c2 = __byte_perm(t2, t3, 0x5410);
  c3 = __byte_perm(t2, t3, 0x7632);
}

// Byte offset of 16-byte chunk c of tile row r (128-byte swizzle).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * BK + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d));
}
// Shared-memory matrix descriptor of a K-major tile at `addr` (1024-byte
// aligned, 128-byte swizzle): start address, leading byte offset (unused
// for this layout), 1024 bytes between 8-row groups, swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// Writes by this thread's generic proxy (cp.async, st.shared) become
// visible to the tensor cores' async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d += A (64 x 32, descriptor da) . B (128 x 32, descriptor db)^T, s8 -> s32.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// Copies one K-major operand tile per stage: rows r0.. of a row-major int8
// matrix (leading dimension ld), bytes [k0, k0 + BK) clipped at k_end.
// Thread t always copies chunk t % 8 of rows t / 8 + 32 i (i < 4), so the
// row offsets, swizzled destinations and row bounds are set up once; a
// whole, aligned stage is four 16-byte cp.async, a ragged one is copied
// byte-wise with zeros past the rows and k_end.
struct KmajorLoader {
  static constexpr int ROWS_PER_PASS = THREADS / CHUNKS;     // 32
  static constexpr int PASSES = BM / ROWS_PER_PASS;          // 4
  const int8_t* src;      // row r0 + t / 8, byte 16 (t % 8)
  int ld, chunk_k, rows_ok;
  uint32_t dst[PASSES];

  __device__ __forceinline__ KmajorLoader(const int8_t* m, int ld_, int r0,
                                          int rows) {
    const int r = threadIdx.x / CHUNKS, c = threadIdx.x % CHUNKS;
    ld = ld_;
    chunk_k = 16 * c;
    src = m + static_cast<size_t>(r0 + r) * ld + chunk_k;
    rows_ok = 0;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      dst[i] = swz(r + ROWS_PER_PASS * i, c);
      rows_ok |= (r0 + r + ROWS_PER_PASS * i < rows) << i;
    }
  }

  // `whole`: the stage lies inside [k_begin, k_end) and the rows are
  // 16-byte aligned (block-uniform)
  __device__ __forceinline__ void issue(uint32_t tile, int k0, int k_end,
                                        bool whole) const {
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int8_t* p = src + static_cast<size_t>(ROWS_PER_PASS * i) * ld + k0;
      if (whole && (rows_ok >> i & 1)) {
        cp_async16(tile + dst[i], p);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (rows_ok >> i & 1) {
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (k0 + chunk_k + b < k_end)
              w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[b]))
                           << (8 * (b & 3));
        }
        st_shared16(tile + dst[i], w[0], w[1], w[2], w[3]);
      }
    }
  }
};

// The (K, N) bank: this thread's 16 (k) x 4 (n) byte block of a stage, as
// sixteen words (row i of the block in word i).
struct KnBlock {
  uint32_t w[16];
};

// Thread t loads columns n0 + 4 (t % 32) .. + 3 of rows k0 + 16 (t / 32)
// .. + 15 of a stage.
struct KnLoader {
  const int8_t* src;      // row 16 (t / 32), column n0 + 4 (t % 32)
  int N, n, kb;
  bool cols_ok;           // the 4 columns exist and are 4-byte aligned

  __device__ __forceinline__ KnLoader(const int8_t* w, int N_, int n0,
                                      bool vec) {
    N = N_;
    n = n0 + 4 * (threadIdx.x % 32);
    kb = 16 * (threadIdx.x / 32);
    src = w + static_cast<size_t>(kb) * N + n;
    cols_ok = vec && n + 4 <= N;
  }

  __device__ __forceinline__ void load(KnBlock& blk, int k0, int k_end,
                                       bool whole) const {
    const int8_t* base = src + static_cast<size_t>(k0) * N;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int8_t* p = base + static_cast<size_t>(i) * N;
      if (whole && cols_ok) {
        blk.w[i] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
        uint32_t v = 0u;
        if (k0 + kb + i < k_end) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
        }
        blk.w[i] = v;
      }
    }
  }
};

// Transpose the block and store column n0 + 4 (t % 32) + j's 16 k bytes as
// one chunk of tile row 4 (t % 32) + j.  At step s a thread stores column
// j = (s + (t % 32) / 2) % 4, so the 8 lanes of a store phase write rows
// with 8 distinct residues mod 8: 8 distinct bank groups.
__device__ __forceinline__ void store_kn(const KnBlock& blk, uint32_t tile) {
  const int c4 = threadIdx.x % 32, chunk = threadIdx.x / 32;
  uint32_t col[4][4];   // col[j][q]: column j, k rows 4q..4q+3
#pragma unroll
  for (int q = 0; q < 4; ++q)
    transpose4x4(blk.w[4 * q], blk.w[4 * q + 1], blk.w[4 * q + 2],
                 blk.w[4 * q + 3], col[0][q], col[1][q], col[2][q], col[3][q]);
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int j = (step + (c4 >> 1)) & 3;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = j == 0 ? col[0][q] : j == 1 ? col[1][q] : j == 2 ? col[2][q]
                                                               : col[3][q];
    st_shared16(tile + swz(4 * c4 + j, chunk), v[0], v[1], v[2], v[3]);
  }
}

// acc[v]: accumulator v of this thread's warpgroup tile; `acc_row` /
// `acc_col` say where it sits in the block tile.
template <bool TRANS>
__device__ __forceinline__ void tile_loop(const int8_t* __restrict__ a,
                                          int lda, bool a_vec,
                                          const int8_t* __restrict__ w,
                                          int M, int N, int K, int m0, int n0,
                                          int k_begin, int k_end,
                                          uint8_t* smem, int32_t (&acc)[64]) {
  const int wg = threadIdx.x / 128;
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const bool w_vec = TRANS ? (K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
                           : (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0);
#pragma unroll
  for (int v = 0; v < 64; ++v) acc[v] = 0;

  const int ktiles = (k_end - k_begin + BK - 1) / BK;
  KnBlock blk;
  auto a_tile = [&](int s) { return base + s * STAGE_BYTES; };
  auto b_tile = [&](int s) { return base + s * STAGE_BYTES + BM * BK; };
  const KmajorLoader a_ld(a, lda, m0, M);
  const KmajorLoader b_ld(w, K, n0, N);     // the (N, K) bank
  const KnLoader kn_ld(w, N, n0, w_vec);    // the (K, N) bank
  auto issue = [&](int s, int kt) {
    const int k0 = k_begin + kt * BK;
    const bool whole = k0 + BK <= k_end;
    a_ld.issue(a_tile(s), k0, k_end, whole && a_vec);
    if (TRANS)
      b_ld.issue(b_tile(s), k0, k_end, whole && w_vec);
    else
      kn_ld.load(blk, k0, k_end, whole);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      issue(s, s);
      if (!TRANS) store_kn(blk, b_tile(s));
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    // refill the slot read in iteration kt - 1 (its products are done)
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) issue(nk % STAGES, nk);
    cp_async_commit();

    const uint64_t da = smem_desc(a_tile(kt % STAGES) + wg * WG_ROWS * BK);
    const uint64_t db = smem_desc(b_tile(kt % STAGES));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)       // 32 bytes = 2 descriptor units
      wgmma_s8(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    if (!TRANS && nk < ktiles) store_kn(blk, b_tile(nk % STAGES));
    wgmma_wait0();
  }
  cp_async_wait<0>();
}

// Tile-relative row and column of accumulator v: 8-column group v / 4,
// rows lane / 4 (+ 8 for v % 4 >= 2) of this warp's 16 in its warpgroup.
__device__ __forceinline__ int acc_row(int v) {
  return WG_ROWS * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) +
         (threadIdx.x % 32) / 4 + 8 * ((v % 4) / 2);
}
__device__ __forceinline__ int acc_col(int v) {
  return 8 * (v / 4) + 2 * (threadIdx.x % 4) + (v % 2);
}

}  // namespace pmma
