// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_kernel`): attention over flattened heads with fp32
// running max / sum / accumulator, so the Sq x L score matrix never reaches
// device memory.  Same layout contract as the reference:
//   q (BH_q, Sq, hd), k (BH_kv, L, hd), v (BH_kv, L, hd_v); query row b
//   reads kv row b / G (GQA, G = BH_q / BH_kv); hd_v may differ from hd.
// The causal mask runs on absolute positions: query i sits at q_offset + i,
// keys at 0..L-1, and keys at or past kv_len are masked.  Unlike the
// reference (static kv_len), q_offset and kv_len are run-time arguments.
// Masked scores take the reference's finite NEG_INF = -1e30.
//
// What bounds it on an H100.  A 2048-long causal prefill does ~2*Sq*L*hd
// FLOPs per head for QK^T and PV over the lower triangle against a few MB
// of q/k/v, so it is bound by arithmetic: 989 TFLOP/s on the bf16 tensor
// cores, 67 on the fp32 CUDA cores.
//
// Two variants, chosen by the wrapper from the dtype and head dims:
//
// `flash_mma_kernel` (bf16, hd and hd_v multiples of 16 up to 256): an
// FA2-style kernel on the bf16 tensor cores.  A block takes 64 query rows
// (four warps of 16, Q held in registers as `mma` A fragments, or read
// from shared memory per k-step where registers run short) and walks
// 64-key K/V tiles double-buffered with 16-byte `cp.async` in XOR-swizzled
// shared memory.  S = Q K^T and O += P V run as `mma.sync.m16n8k16` bf16 ->
// fp32 fed by `ldmatrix` (`.trans` for V); the running max, sum and O stay
// in fp32 registers, and P is rounded to bf16 for the PV product (one more
// rounding than the fp32 reference, ~1e-3 rel-L2).  Causal query tiles are
// issued longest first.
//
// `flash_kernel` (float32, or head dims the tensor-core variant does not
// take, up to 256): one block per (query row b, 64-query tile), two
// threads per query row (four past 128 dims), each owning a share of the
// head dims (interleaved in float4 groups so the threads of a row read
// neighbouring shared-memory words); 32-key tiles of K and V staged in
// shared memory as fp32 (dynamic past 48 KB), the online softmax updated
// per 16-key chunk, products on the fp32 CUDA cores.
//
// Head dims.  Both kernels are templates on the largest hd (DQ) and hd_v
// (DV) they take, which size the registers and shared tiles; the launcher
// picks the smallest of three instantiations: (128, 128) for every config
// with both dims up to 128 (the code before MLA, unchanged), (192, 128)
// for MLA's q/k of nope 128 + rope 64 against v 128 (DeepSeek-V2), and
// (256, 256) for anything else up to the 256 limit.  At (256, 256) the
// tensor-core kernel reads Q's k-slices from shared memory with
// `ldmatrix` per step instead of holding them: a thread's 128 fp32
// accumulators for hd_v 256 leave no room for 64 registers of Q.
//
// Both variants:
//   * stop the key loop at the last key any row of the tile can see
//     (min(kv_len, q_offset + last row + 1) when causal): fully masked
//     blocks are skipped as in the reference;
//   * stage keys past that end as zeros and give masked keys p = 0, so
//     garbage in a capacity buffer beyond q_offset + C (chunked prefill)
//     never enters m, l or the accumulator, even if it is not finite (in
//     a tensor-core product 0 * NaN would be NaN).  Key 0 is always visible
//     to every row, so every row's first tile sets a finite running max.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 32;         // keys per shared-memory tile
constexpr int CHUNK = 16;       // keys per online-softmax update
constexpr int MAX_HEAD_DIM = 256;
constexpr float NEG_INF = -1e30f;

// CUDA-core kernel at head dims up to (DQ, DV): TPR threads per query row,
// each owning 1/TPR of the dims in float4 groups; shared tiles Ks[BKV][DQ],
// Vs[BKV][DV], static where they fit in 48 KB, else dynamic (DYN_SMEM
// bytes at launch).
template <int DQ, int DV>
struct Simt {
  static constexpr int TPR = DQ + DV > 256 ? 4 : 2;
  static constexpr int THREADS = TPR * BQ;
  static constexpr int GQ = DQ / (4 * TPR);   // float4 groups of q per thread
  static constexpr int GV = DV / (4 * TPR);   // of the accumulator
  static constexpr int DMAX = DQ > DV ? DQ : DV;
  static constexpr int SMEM = BKV * (DQ + DV) * 4;
  static constexpr bool STATIC = SMEM <= 48 * 1024;
  static constexpr int DYN_SMEM = STATIC ? 0 : SMEM;
};

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

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(Simt<DQ, DV>::THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int L,
             int hd, int hdv, int G, float scale, int q_offset, int kv_len,
             int causal) {
  using P = Simt<DQ, DV>;
  constexpr int TPR = P::TPR;
  __shared__ __align__(16) float ssmem[P::STATIC ? BKV * (DQ + DV) : 1];
  extern __shared__ __align__(16) float dsmem[];
  float* smem = P::STATIC ? ssmem : dsmem;
  float (*Ks)[DQ] = reinterpret_cast<float (*)[DQ]>(smem);
  float (*Vs)[DV] = reinterpret_cast<float (*)[DV]>(smem + BKV * DQ);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / TPR, h = tid % TPR;
  const int qi = blockIdx.x * BQ + r;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;
  const int kvb = b / G;

  // dim of this thread's float4 group g: the TPR threads of a row
  // interleave their groups
  auto dim_of = [&](int g) { return (TPR * g + h) * 4; };
  float4 qreg[P::GQ], acc[P::GV];
  const T* qrow = q + (static_cast<size_t>(b) * Sq + (row_ok ? qi : 0)) * hd;
#pragma unroll
  for (int g = 0; g < P::GQ; ++g) {
    const int d = dim_of(g);
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = (row_ok && d + e < hd) ? to_f<T>(qrow[d + e]) : 0.f;
    qreg[g] = make_float4(t[0], t[1], t[2], t[3]);
  }
#pragma unroll
  for (int g = 0; g < P::GV; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = NEG_INF, l = 0.f;

  const int last_row = min(Sq, (blockIdx.x + 1) * BQ) - 1;
  int kend = min(kv_len, L);
  if (causal) kend = min(kend, q_offset + last_row + 1);

  const T* kbase = k + static_cast<size_t>(kvb) * L * hd;
  const T* vbase = v + static_cast<size_t>(kvb) * L * hdv;
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();
    for (int idx = tid; idx < BKV * P::DMAX; idx += P::THREADS) {
      const int j = idx / P::DMAX, d = idx % P::DMAX, kj = k0 + j;
      const bool in = kj < kend;
      if (d < DQ)
        Ks[j][d] = (in && d < hd) ? to_f<T>(kbase[static_cast<size_t>(kj) * hd + d]) : 0.f;
      if (d < DV)
        Vs[j][d] = (in && d < hdv) ? to_f<T>(vbase[static_cast<size_t>(kj) * hdv + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < BKV; c += CHUNK) {
      float s[CHUNK];
      float cmax = NEG_INF;
      unsigned ok = 0;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float4* krow = reinterpret_cast<const float4*>(&Ks[c + j][0]);
        float dot = 0.f;
#pragma unroll
        for (int g = 0; g < P::GQ; ++g) {
          const float4 kv4 = krow[TPR * g + h];
          dot += qreg[g].x * kv4.x + qreg[g].y * kv4.y + qreg[g].z * kv4.z + qreg[g].w * kv4.w;
        }
#pragma unroll
        for (int sh = 1; sh < TPR; sh *= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, sh);
        const int kj = k0 + c + j;
        const bool vis = kj < kend && kj < kv_len && (!causal || qpos >= kj);
        s[j] = vis ? dot * scale : NEG_INF;
        ok |= static_cast<unsigned>(vis) << j;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        s[j] = ((ok >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int g = 0; g < P::GV; ++g) {
        acc[g].x *= alpha; acc[g].y *= alpha; acc[g].z *= alpha; acc[g].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float p = s[j];
        const float4* vrow = reinterpret_cast<const float4*>(&Vs[c + j][0]);
#pragma unroll
        for (int g = 0; g < P::GV; ++g) {
          const float4 v4 = vrow[TPR * g + h];
          acc[g].x += p * v4.x; acc[g].y += p * v4.y;
          acc[g].z += p * v4.z; acc[g].w += p * v4.w;
        }
      }
      m = m_new;
    }
  }

  if (!row_ok) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = o + (static_cast<size_t>(b) * Sq + qi) * hdv;
#pragma unroll
  for (int g = 0; g < P::GV; ++g) {
    const int d = dim_of(g);
    const float t[4] = {acc[g].x, acc[g].y, acc[g].z, acc[g].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < hdv) orow[d + e] = from_f<T>(t[e] * inv);
  }
}


__device__ __forceinline__ void cp_async_commit_f() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait_f() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ tensor cores
constexpr int MQ = 64;            // query rows per block: 4 warps x 16
constexpr int MKV = 64;           // keys per K/V tile
constexpr int MTHREADS = 128;

// Tensor-core kernel at head dims up to (DQ, DV): shared-memory rows of
// DQ (Q, K) and DV (V) bf16, Q + 2 x (K, V) tiles; QREG: Q's fragments
// held in registers for the whole key loop (else read per k-step).
template <int DQ, int DV>
struct Mma {
  static constexpr int ROWQ = DQ * 2;     // bytes per Q / K row
  static constexpr int ROWV = DV * 2;     // bytes per V row
  static constexpr int SMEM = MQ * ROWQ + 2 * MKV * (ROWQ + ROWV);
  static constexpr bool QREG = DQ + DV <= 320;
  static_assert(DQ % 64 == 0 && DV % 64 == 0,
                "the swizzle permutes 8 chunks of 16 bytes within a row");
};

// Byte offset of 16-byte chunk c (8 dims) of row r in rows of `rowb`
// bytes; chunks XOR-swizzled so `ldmatrix` over 8 consecutive rows hits 8
// distinct bank groups.
__device__ __forceinline__ uint32_t fswz(int r, int c, int rowb) {
  return static_cast<uint32_t>(r * rowb + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + n) of a (rows, d) bf16 matrix into shared-memory rows of
// `rowb` bytes; rows at or past `valid` are zero-filled (their source is
// never read).
__device__ __forceinline__ void load_rows(uint32_t tile, const __nv_bfloat16* m,
                                          int r0, int n, int valid, int d,
                                          int rowb) {
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < n * chunks; idx += MTHREADS) {
    const int r = idx / chunks, c = idx % chunks;
    const bool in = r0 + r < valid;
    const __nv_bfloat16* src = m + (in ? static_cast<size_t>(r0 + r) * d + 8 * c : 0);
    cp_async16_zfill(tile + fswz(r, c, rowb), src, in ? 16 : 0);
  }
}

// grid (BH_q, ceil(Sq / 64)): blockIdx.y counts query tiles from the last
// (longest under the causal mask) down.
template <int DQ, int DV>
__global__ void __launch_bounds__(MTHREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int Sq, int L, int hd, int hdv,
                 int G, float scale_log2, int q_offset, int kv_len,
                 int causal) {
  using P = Mma<DQ, DV>;
  constexpr int ROWQ = P::ROWQ, ROWV = P::ROWV;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t qs = base;
  auto ks_tile = [&](int buf) {
    return base + MQ * ROWQ + buf * MKV * (ROWQ + ROWV);
  };
  auto vs_tile = [&](int buf) { return ks_tile(buf) + MKV * ROWQ; };

  const int b = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = tile * MQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvb = b / G;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Sq * hd;
  const __nv_bfloat16* kb = k + static_cast<size_t>(kvb) * L * hd;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kvb) * L * hdv;

  const int last_row = min(Sq, q0 + MQ) - 1;
  int kend = min(kv_len, L);
  if (causal) kend = min(kend, q_offset + last_row + 1);
  const int ntiles = (kend + MKV - 1) / MKV;

  load_rows(qs, qb, q0, MQ, Sq, hd, ROWQ);
  cp_async_commit_f();
  if (ntiles > 0) {
    load_rows(ks_tile(0), kb, 0, MKV, kend, hd, ROWQ);
    load_rows(vs_tile(0), vb, 0, MKV, kend, hdv, ROWV);
  }
  cp_async_commit_f();
  cp_async_wait_f<1>();
  __syncthreads();

  // Q fragments: k-step ks covers dims 16 ks .. 16 ks + 15 (kept in
  // registers when P::QREG, else read again at every key tile)
  auto q_frag = [&](int ks, uint32_t (&f)[4]) {
    ldsm_x4(qs + fswz(16 * warp + lane % 16, 2 * ks + lane / 16, ROWQ), f);
  };
  uint32_t qf[P::QREG ? DQ / 16 : 1][4];
  if constexpr (P::QREG) {
#pragma unroll
    for (int ks = 0; ks < DQ / 16; ++ks)
      if (16 * ks < hd) q_frag(ks, qf[ks]);
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const int qpos0 = q_offset + q0 + 16 * warp + g;   // row g; row g+8 is +8

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_rows(ks_tile(buf ^ 1), kb, (it + 1) * MKV, MKV, kend, hd, ROWQ);
      load_rows(vs_tile(buf ^ 1), vb, (it + 1) * MKV, MKV, kend, hdv, ROWV);
    }
    cp_async_commit_f();
    cp_async_wait_f<1>();
    __syncthreads();
    const uint32_t kt = ks_tile(buf), vt = vs_tile(buf);
    const int k0 = it * MKV;

    // S = Q K^T: 8 MMA tiles of 8 keys
    float s[MKV / 8][4];
#pragma unroll
    for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DQ / 16; ++ks) {
      if (16 * ks >= hd) break;
      uint32_t (&a)[4] = qf[P::QREG ? ks : 0];
      if constexpr (!P::QREG) q_frag(ks, a);
#pragma unroll
      for (int jj = 0; jj < MKV / 16; ++jj) {
        uint32_t kf[4];
        ldsm_x4(kt + fswz(16 * jj + lane % 8 + 8 * (lane / 16),
                          2 * ks + (lane / 8) % 2, ROWQ), kf);
        mma_bf16(s[2 * jj], a, kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], a, kf[2], kf[3]);
      }
    }

    // mask, tile max, online-softmax update (rows g and g + 8)
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + 8 * j + 2 * t + (c & 1);
        const int h = c >> 1;
        const bool vis = kj < kend && (!causal || qpos0 + 8 * h >= kj);
        s[j][c] = vis ? s[j][c] * scale_log2 : NEG_INF;
        tmax[h] = fmaxf(tmax[h], s[j][c]);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      m_new[h] = fmaxf(m_run[h], tmax[h]);
      alpha[h] = exp2f(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
      l_run[h] *= alpha[h];
    }
    // P in bf16 as A fragments of the PV product; the sum takes the
    // rounded values, so the weights that reach O sum to l exactly
    uint32_t pf[MKV / 16][4];
#pragma unroll
    for (int j = 0; j < MKV / 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[c] = s[j][c] > 0.5f * NEG_INF ? exp2f(s[j][c] - m_new[c >> 1]) : 0.f;
      const uint32_t lo = pack_bf16(p[0], p[1]), hi = pack_bf16(p[2], p[3]);
      const __nv_bfloat162 l2 = *reinterpret_cast<const __nv_bfloat162*>(&lo);
      const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi);
      l_run[0] += __low2float(l2) + __high2float(l2);
      l_run[1] += __low2float(h2) + __high2float(h2);
      pf[j / 2][(j & 1) * 2] = lo;
      pf[j / 2][(j & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
    }
    // O += P V: V tiles through ldmatrix.trans, 16 dims per x4 load
#pragma unroll
    for (int kk = 0; kk < MKV / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < DV / 16; ++jj) {
        if (16 * jj >= hdv) break;
        uint32_t vf[4];
        ldsm_x4_t(vt + fswz(16 * kk + lane % 8 + 8 * ((lane / 8) % 2),
                            2 * jj + lane / 16, ROWV), vf);
        mma_bf16(acc[2 * jj], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * jj + 1], pf[kk], vf[2], vf[3]);
      }
    __syncthreads();   // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + 16 * warp + g + 8 * h;
    if (qi >= Sq) continue;
    const float inv = l_run[h] > 0.f ? 1.f / l_run[h] : 0.f;
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * Sq + qi) * hdv;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (8 * j >= hdv) break;
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int BHq, G, Sq, L, hd, hdv;
  float scale;
  int q_offset, kv_len, causal;
  cudaStream_t st;
};

// Each launch helper sets its kernel's shared-memory ceiling once.
template <int DQ, int DV>
cudaError_t launch_mma(const Args& a) {
  constexpr int smem = Mma<DQ, DV>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.BHq, (a.Sq + MQ - 1) / MQ);
  flash_mma_kernel<DQ, DV><<<grid, MTHREADS, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o),
      a.Sq, a.L, a.hd, a.hdv, a.G, a.scale * 1.4426950408889634f, a.q_offset,
      a.kv_len, a.causal);
  return cudaGetLastError();
}

template <typename T, int DQ, int DV>
cudaError_t launch_simt(const Args& a) {
  using P = Simt<DQ, DV>;
  if (!P::STATIC) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_kernel<T, DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::DYN_SMEM);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.BHq);
  flash_kernel<T, DQ, DV><<<grid, P::THREADS, P::DYN_SMEM, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.L, a.hd, a.hdv,
      a.G, a.scale, a.q_offset, a.kv_len, a.causal);
  return cudaGetLastError();
}

template <int DQ, int DV>
cudaError_t launch(const Args& a, int dtype, int variant) {
  if (variant == 1) return launch_mma<DQ, DV>(a);
  return dtype == 0 ? launch_simt<float, DQ, DV>(a)
                    : launch_simt<__nv_bfloat16, DQ, DV>(a);
}
}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = CUDA cores (float32 or
// bf16, head dims up to 256), 1 = bf16 tensor cores (hd and hd_v multiples
// of 16 up to 256, 16-byte aligned rows).  The instantiation is the
// smallest (DQ, DV) of (128, 128), (192, 128), (256, 256) that holds both
// head dims.  Returns cudaGetLastError().
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int variant, int BHq, int BHkv, int Sq, int L,
                    int hd, int hdv, float scale, int q_offset, int kv_len,
                    int causal, void* stream) {
  if (hd < 1 || hdv < 1 || hd > MAX_HEAD_DIM || hdv > MAX_HEAD_DIM ||
      (variant == 1 && (dtype != 1 || hd % 16 || hdv % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, BHq, BHq / BHkv, Sq, L, hd, hdv, scale, q_offset,
               kv_len, causal, static_cast<cudaStream_t>(stream)};
  cudaError_t rc;
  if (hd <= 128 && hdv <= 128)
    rc = launch<128, 128>(a, dtype, variant);
  else if (hd <= 192 && hdv <= 128)
    rc = launch<192, 128>(a, dtype, variant);
  else
    rc = launch<256, 256>(a, dtype, variant);
  return static_cast<int>(rc);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
