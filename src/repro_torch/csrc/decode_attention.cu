// Decode attention for Hopper (sm_90a): one query token a row against its
// past-only KV cache plus the new token's K/V, with a reduction order that
// depends on no other row and on no other head.
//
// Replaces no TPU kernel.  The reference's decode attention is an einsum
// chain (src/repro/models/attention.py:202 `_attend_decode`), and so was the
// port's: on the card cuBLAS picks each einsum's reduction order from the
// whole call's shapes, so a row's output moved with the batch size and with
// the head count (a rank holding one row, or its own KV heads, got other
// bits than the unsharded step).  This kernel computes the same function:
//   q (B, 1, H, hd) against the cache ck / cv (B, L, KV, hd) and the new
//   token's k / v (B, 1, KV, hd), held apart; cache position l of row b is
//   seen when offset + l < pos[b] (pos per row, or one for all, read from
//   device memory, so a captured CUDA graph replays with new positions);
//   float32 scores scaled by `scale`, a softmax over the seen positions and
//   the new token; the cache part's probabilities rounded to the cache
//   dtype and the new token's to q's dtype before their V products; float32
//   sums; the output in q's dtype.  G = H / KV query heads share a KV head.
//
// What bounds it on an H100.  Each seen K and V row is read once and used
// for 2 * G * hd operations: at minitron-4b's serving shape (G 3, hd 128,
// bf16) that is 1.5 operations a byte, far under the card's ridge, so the
// bytes of the seen cache rows bound it (3.35 TB/s).  CUDA cores are enough
// for that arithmetic; the design is about keeping bytes in flight and the
// chain of dependent memory round trips short.
//
// Design.  One launch on the caller's stream, 256 threads a block, no
// floating-point atomics:
//   * split-K over fixed position blocks: a block takes one (row, KV
//     head, split of SPLIT positions).  SPLIT is a compile-time constant,
//     never derived from the call's shape or the SM count.  Positions live
//     in device memory, so the host launches a flat grid of B x ceil(L /
//     SPLIT) units a KV head (KV heads fastest); each block reads every
//     row's position and takes the u-th unit that has work (rows in order,
//     a row's max(1, ceil(seen / SPLIT)) splits in order).  The blocks
//     with work are thus the first to reach the SMs, and the rest return
//     after one read of the positions.
//   * wide lanes: a lane owns 8 consecutive elements of a row (16 bytes in
//     bf16, two 16-byte chunks in float32), so a warp takes 2 rows of hd
//     128 or 4 of hd 64 a step.  Position i of the split belongs to warp
//     (i / RPW) % WARPS, row slot i % RPW: each warp walks its own rows,
//     K's and then V's.
//   * bytes in flight: each lane streams its own slices of its warp's rows
//     into shared memory by 16-byte `cp.async.cg` copies, a ring of STAGES
//     steps a lane, so every warp keeps STAGES steps of K, then V, in
//     flight with no block barrier between steps (a lane reads only what it
//     copied).  cp.async and not TMA: the rows are gathered at the caller's
//     row stride, a KV head's row (256 B at hd 128 bf16) is one warp's
//     step, and no tensor map has to be built on the host per call.  The
//     ring runs straight from a warp's last K step into its first V steps,
//     so V's copies are in flight while the split's softmax is formed.  q
//     and the new token's K and V are staged by cp.async with the first
//     steps' copies, so their round trip is the same one.  A cache whose
//     rows or strides are not 16-byte aligned is read element by element in
//     the same order (same arithmetic, slower).
//   * scores: a lane's 8 products in element order, then a butterfly over
//     the row's LPR lanes (offsets LPR / 2 .. 1), the G heads' butterflies
//     interleaved.  The split's softmax: a warp a head takes the max of the
//     split's scores, exp(s - max) and their sum (lanes strided over the
//     positions, then a butterfly); the weights round to the cache dtype
//     before their V products.
//   * P V: each V slice in shared memory is read once for all G query
//     heads; a lane keeps G x 8 float32 sums over its positions in position
//     order; the row slots join by a butterfly (offsets 16 .. LPR), the
//     warps in warp order through shared memory.
//   * one launch: each block writes its split's (max, sum, P V) to a
//     float32 workspace.  A row of one split joins it in the same block;
//     with more, each block counts its arrival on an integer counter of its
//     (row, KV head), and the last to arrive joins every split of the pair
//     in split order
//     with the new token (global max; the sum of l_c exp(m_c - M) and the
//     P V sums rescaled, each in split order; the output; or, in partial
//     mode, the (max, sum, unnormalised P V) over the positions it was
//     given, the new token's term counted only when the caller asks) and
//     re-arms the counter to 0.  The join reads the splits in split order
//     whichever block arrives last, so the bits do not depend on arrival.
// Every sum above runs in an order fixed by hd, SPLIT, WARPS, the lane
// slice and the row's own seen length: a row's bits do not depend on B, H,
// KV, STAGES or the other rows, and a call on a subset of the KV heads
// (with their query heads) gives those heads' bits of the whole call.
//
// Two calls in flight.  The counters are one buffer per device (the
// wrapper's), zero between calls: calls on one device must run in stream
// order, one after the other, as the port runs them (one stream a process;
// ranks are processes with buffers of their own; a captured decode step
// replays on that stream).  Two calls in flight at once on two streams of
// one device would share counters and are not supported.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DECODE_SPLIT
#define DECODE_SPLIT 128
#endif
#ifndef DECODE_STAGES
#define DECODE_STAGES 4
#endif

namespace {

// DECODE_TRACE (a measurement build, tools/probe_decode_attention.py
// --trace): thread 0 of each block records %globaltimer and clock64 at
// TRACE_POINTS points of its work, read back by decode_attention_trace.
#ifdef DECODE_TRACE
constexpr int TRACE_BLOCKS = 4096;
constexpr int TRACE_POINTS = 12;
__device__ unsigned long long g_trace[TRACE_BLOCKS * TRACE_POINTS * 2];
__device__ __forceinline__ void stamp(unsigned long long (&t)[2]) {
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t[0]));
  t[1] = clock64();
}
// block `blk` = (row * KV + KV head) * splits + split
__device__ __forceinline__ void trace_put(int blk, int point,
                                          const unsigned long long (&t)[2]) {
  if (threadIdx.x != 0 || blk >= TRACE_BLOCKS) return;
  g_trace[(blk * TRACE_POINTS + point) * 2] = t[0];
  g_trace[(blk * TRACE_POINTS + point) * 2 + 1] = t[1];
}
#else
__device__ __forceinline__ void stamp(unsigned long long (&)[2]) {}
__device__ __forceinline__ void trace_put(int, int,
                                          const unsigned long long (&)[2]) {}
#endif
__device__ __forceinline__ void trace(int blk, int point) {
  unsigned long long t[2];
  stamp(t);
  trace_put(blk, point, t);
}

constexpr int SPLIT = DECODE_SPLIT;        // positions a block takes
constexpr int STAGES = DECODE_STAGES;      // steps in flight a lane
// blocks an SM holds at least, for an instantiation at G <= GT: enough
// that a call's blocks with work fit one wave at the serving shapes; one
// past G 4 (G x 8 sums a lane: no spills)
__host__ __device__ constexpr int min_blocks(int GT) {
  return GT == 1 ? 4 : (GT == 2 ? 3 : (GT <= 4 ? 2 : 1));
}
constexpr int JOIN_REGS = 16;              // splits a join holds in registers
// a thread's (head, channel) items whose P V sums a join asks for first
__host__ __device__ constexpr int join_items(int GT) { return GT <= 1 ? 1 : 2; }
constexpr int THREADS = 256;               // a block
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = 8;                   // elements a lane owns
constexpr int MAX_HD = 256;
constexpr int MAX_G = 16;                  // query heads a KV head serves
constexpr float NEG_INF = -1e30f;
static_assert(SPLIT % 32 == 0, "SPLIT is a multiple of 32 positions");
static_assert(STAGES >= 2, "the ring needs two steps or more");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 8 elements of a lane's slice in shared memory (16-byte aligned)
__device__ __forceinline__ void load_slice(const float* p, float (&f)[SLICE]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p,
                                           float (&f)[SLICE]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    f[2 * j] = __low2float(h);
    f[2 * j + 1] = __high2float(h);
  }
}

// a lane's slice from its ring slot: its 16-byte chunks 32 lanes apart
__device__ __forceinline__ void load_ring(const uint4* p, float (&f)[SLICE],
                                          float) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 32);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load_ring(const uint4* p, float (&f)[SLICE],
                                          __nv_bfloat16) {
  load_slice(reinterpret_cast<const __nv_bfloat16*>(p), f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const void* q;          // (B, H, hd) contiguous
  const void* ck;         // row b, position l, head k at b*sbk + l*slk + k*hd
  const void* cv;         // the same with sbv, slv
  const void* kn;         // (B, KV, hd) contiguous
  const void* vn;
  const long long* pos;   // pos[b * pos_stride]
  int pos_stride;
  int B, L, H, KV, G, hd;
  long long sbk, slk, sbv, slv;
  float scale;
  long long offset;       // the global position of cache row 0
  int partial, with_new;
  int nsplit;             // splits a row's cache spans: max(1, ceil(L / SPLIT))
  int hdp;                // hd padded to whole lane slices
  int lpr;                // lanes a row: a power of two >= hdp / SLICE
  int vec;                // cache rows and strides 16-byte aligned
  int vec_new;            // q and the new K / V rows 16-byte aligned
  float* ws_m;            // (B, KV, nsplit, G)
  float* ws_l;
  float* ws_o;            // (B, KV, nsplit, G, hd)
  unsigned* counters;     // (B, KV) arrivals, zero between calls
  void* out;              // (B, H, hd): T, or float32 in partial mode
  float* m_out;           // (B, H), partial mode
  float* l_out;
};

// cache rows of row b that the query sees
__device__ __forceinline__ int seen(const Args& a, int b) {
  long long p = a.pos[static_cast<long long>(b) * a.pos_stride] - a.offset;
  p = p < 0 ? 0 : p;
  return static_cast<int>(p > a.L ? a.L : p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// each lane's 8 products in element order (fmaf), then the butterfly over
// the row's lpr lanes (offsets lpr / 2 .. 1), for heads [0, N) at once;
// every lane of the row returns the sums
template <int N>
__device__ __forceinline__ void slice_dots(const float (*q)[SLICE],
                                           const float (&k)[SLICE], bool own,
                                           int lpr, float (&s)[N]) {
#pragma unroll
  for (int g = 0; g < N; ++g) {
    s[g] = 0.f;
    if (own) {
#pragma unroll
      for (int e = 0; e < SLICE; ++e) s[g] = fmaf(q[g][e], k[e], s[g]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < lpr) {
#pragma unroll
      for (int g = 0; g < N; ++g)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    }
  }
}

// Split K: every block writes its split's partials; the last block of a
// (row, KV head) to arrive joins all splits and re-arms the counter.  The
// barrier orders the block's writes before thread 0's release; the last
// block reads the others' partials after thread 0's acquire and the barrier.
__device__ __forceinline__ bool last_arrival(unsigned* counter,
                                             unsigned splits) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    last = old == splits - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  return last;
}

// shared memory of a block: the lanes' rings (reused for the warps' P V
// partials), q, the new K and V, the split's scores / weights
__host__ __device__ __forceinline__ int region_bytes(int hdp, int G,
                                                     int size) {
  const int ring = WARPS * STAGES * 32 * SLICE * size;
  const int part = WARPS * G * hdp * 4;
  return ring > part ? ring : part;
}
__host__ __device__ __forceinline__ int smem_bytes(int hdp, int G, int size) {
  return region_bytes(hdp, G, size) + (G + 2) * hdp * size + G * SPLIT * 4;
}

// q's G rows, then the new K and V rows, of (row b, KV head k) into
// shared-memory rows of hdp elements, the pad zero: one 16-byte chunk a
// thread by cp.async (committed by the caller), else element by element
template <typename T>
__device__ __forceinline__ void stage_new(const Args& a, int b, int k,
                                          T* dst) {
  const int G = a.G, hd = a.hd, hdp = a.hdp;
  const T* q = static_cast<const T*>(a.q) +
               (static_cast<long long>(b) * a.H + static_cast<long long>(k) * G) *
                   hd;
  const long long head = (static_cast<long long>(b) * a.KV + k) * hd;
  const T* kn = static_cast<const T*>(a.kn) + head;
  const T* vn = static_cast<const T*>(a.vn) + head;
  if (a.vec_new) {
    constexpr int PER = 16 / sizeof(T);
    const int cpr = hdp / PER;
    for (int c = threadIdx.x; c < (G + 2) * cpr; c += THREADS) {
      const int r = c / cpr, e = (c % cpr) * PER;
      const T* row = r < G ? q + r * hd : (r == G ? kn : vn);
      cp_async16(dst + r * hdp + e, e < hd ? row + e : row, e < hd ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < (G + 2) * hdp; i += THREADS) {
      const int r = i / hdp, d = i % hdp;
      const T* row = r < G ? q + r * hd : (r == G ? kn : vn);
      dst[i] = d < hd ? row[d] : from_f<T>(0.f);
    }
  }
}

// A lane's work item j of 2 * steps (its warp's K rows, then its V rows):
// the cache row it reads (or nullptr past the split's seen rows)
template <typename T>
__device__ __forceinline__ const T* item_row(const Args& a, int j, int steps,
                                             int n, int w, int r, int rpw,
                                             const T* kbase, const T* vbase) {
  const bool is_v = j >= steps;
  const int i = ((is_v ? j - steps : j) * WARPS + w) * rpw + r;
  if (i >= n) return nullptr;
  return (is_v ? vbase : kbase) +
         static_cast<long long>(i) * (is_v ? a.slv : a.slk);
}

// item j's slice into the lane's ring slot j % STAGES (16-byte copies)
template <typename T>
__device__ __forceinline__ void fetch(const Args& a, const T* row, int ls,
                                      uint4* slot) {
  constexpr int CH = SLICE * sizeof(T) / 16;      // chunks a slice
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int e = ls * SLICE + q * PER;
    cp_async16(slot + 32 * q, e < a.hd ? row + e : row, e < a.hd ? 16 : 0);
  }
}

// the lane's slice of `row` read straight from the cache (unaligned rows)
template <typename T>
__device__ __forceinline__ void read_direct(const Args& a, const T* row,
                                            int ls, float (&x)[SLICE]) {
#pragma unroll
  for (int e = 0; e < SLICE; ++e) {
    const int d = ls * SLICE + e;
    x[e] = d < a.hd ? to_f(row[d]) : 0.f;
  }
}

// The new token's score of each of the G heads (q and the new K staged),
// NEG_INF where the call leaves it out; a warp a head
template <typename T>
__device__ __forceinline__ void new_scores(const Args& a, const T* staged,
                                           float* sn) {
  const int G = a.G, hdp = a.hdp, lpr = a.lpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ls = lane % lpr;
  const bool own = ls * SLICE < hdp;
  const bool with_new = a.partial == 0 || a.with_new != 0;
  for (int g = warp; g < G; g += WARPS) {
    float qv[1][SLICE] = {}, kv[SLICE] = {}, s1[1];
    if (own) {
      load_slice(staged + g * hdp + ls * SLICE, qv[0]);
      load_slice(staged + G * hdp + ls * SLICE, kv);
    }
    slice_dots<1>(qv, kv, own, lpr, s1);
    if (lane == 0) sn[g] = with_new ? s1[0] * a.scale : NEG_INF;
  }
}

// Join the row's `ns` splits (max m, sum l, P V o of split c at
// m[c * G + g], l[...], o[(c * G + g) * hd + d], in the workspace) with
// the new token (score sn[g]), in split order, and write the output of KV
// head k of row b.  Each thread first asks for the P V sums of its first
// JOIN_ITEMS (head, channel) items (up to JOIN_REGS splits); meanwhile a
// warp a head loads the splits' maxima and sums (lanes over the splits),
// forms the global max M, the factors exp(m_c - M) and the sum of
// l_c exp(m_c - M) in split order; then each item's P V sum in split
// order.  So the join costs one round trip to the workspace (L2: __ldcg,
// since other blocks wrote it).
template <typename T, int GT>
__device__ __forceinline__ void join(const Args& a, int b, int k, int ns,
                                     const float* m, const float* l,
                                     const float* o, const T* staged,
                                     const float* sn, int blk) {
  __shared__ float Mj[MAX_G], Sj[MAX_G], Ej[MAX_G];
  __shared__ float fj[MAX_G][JOIN_REGS];
  const int G = a.G, hd = a.hd, hdp = a.hdp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool with_new = a.partial == 0 || a.with_new != 0;
  const T* vn = staged + (G + 1) * hdp;
  const auto rd = [](const float* p) { return __ldcg(p); };
  const bool held = ns <= JOIN_REGS;
  constexpr int JOIN_ITEMS = join_items(GT);
  float ov[JOIN_ITEMS][JOIN_REGS];
#pragma unroll
  for (int t = 0; t < JOIN_ITEMS; ++t) {
    const int it = threadIdx.x + t * THREADS;
    const int g = it / hd, d = it % hd;
#pragma unroll
    for (int c = 0; c < JOIN_REGS; ++c)
      if (held && it < G * hd && c < ns)
        ov[t][c] = rd(o + (c * G + g) * hd + d);
  }
  trace(blk, 8);
  for (int g = warp; g < G; g += WARPS) {
    // a lane's first split's max and sum come in one load each
    const float m0 = lane < ns ? rd(m + lane * G + g) : NEG_INF;
    const float l0 = lane < ns ? rd(l + lane * G + g) : 0.f;
    float M = m0;
    for (int c = lane + 32; c < ns; c += 32) M = fmaxf(M, rd(m + c * G + g));
    M = fmaxf(warp_max(M), sn[g]);
    float S = 0.f;
    for (int c0 = 0; c0 < ns; c0 += 32) {
      const int c = c0 + lane;
      float lc = 0.f, f = 0.f;
      if (c < ns) {
        lc = c0 == 0 ? l0 : rd(l + c * G + g);
        f = expf((c0 == 0 ? m0 : rd(m + c * G + g)) - M);
        if (c < JOIN_REGS) fj[g][c] = f;
      }
      const int last = min(32, ns - c0);
      for (int j = 0; j < last; ++j)
        S = fmaf(__shfl_sync(0xffffffffu, lc, j),
                 __shfl_sync(0xffffffffu, f, j), S);
    }
    const float e_new = with_new ? expf(sn[g] - M) : 0.f;
    if (lane == 0) {
      Mj[g] = M;
      Sj[g] = S + e_new;
      Ej[g] = e_new;
    }
  }
  trace(blk, 9);
  __syncthreads();
  trace(blk, 10);
  const bool full = a.partial == 0;
  const long long bh0 = static_cast<long long>(b) * a.H +
                        static_cast<long long>(k) * G;
  for (int it = threadIdx.x, t = 0; it < G * hd; it += THREADS, ++t) {
    const int g = it / hd, d = it % hd;
    const float M = Mj[g], S = Sj[g], e_new = Ej[g];
    float acc = 0.f;
    if (held) {
#pragma unroll
      for (int c = 0; c < JOIN_REGS; ++c) {
        if (c < ns) {
          float oc = 0.f;
#pragma unroll
          for (int u = 0; u < JOIN_ITEMS; ++u)
            if (u == t) oc = ov[u][c];
          if (t >= JOIN_ITEMS) oc = rd(o + (c * G + g) * hd + d);
          acc = fmaf(oc, fj[g][c], acc);
        }
      }
    } else {
#pragma unroll 8
      for (int c = 0; c < ns; ++c)
        acc = fmaf(rd(o + (c * G + g) * hd + d),
                   expf(rd(m + c * G + g) - M), acc);
    }
    const float v = to_f(vn[d]);
    const long long idx = (bh0 + g) * hd + d;
    if (full) {
      static_cast<T*>(a.out)[idx] =
          from_f<T>(fmaf(round_as<T>(e_new / S), v, acc / S));
    } else {
      if (with_new) acc = fmaf(round_as<T>(e_new), v, acc);
      static_cast<float*>(a.out)[idx] = acc;
      if (d == 0) {
        a.m_out[bh0 + g] = M;
        a.l_out[bh0 + g] = S;
      }
    }
  }
}

// The (row, split) of work unit u of a KV head: the units are every row's
// splits, max(1, ceil(seen / SPLIT)) a row (a row that sees nothing still
// joins the new token), rows in order.  Warp 0 reads the positions and
// scans; returns false past the last unit.
__device__ __forceinline__ bool find_unit(const Args& a, int u, int* row,
                                          int* split, int* n_seen) {
  __shared__ int unit[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    if (lane == 0) unit[0] = -1;
    __syncwarp();
    for (int b0 = 0; b0 < a.B; b0 += 32) {
      const int b = b0 + lane;
      const int sn = b < a.B ? seen(a, b) : 0;
      const int units = b < a.B ? max(1, (sn + SPLIT - 1) / SPLIT) : 0;
      int incl = units;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      if (b < a.B && u >= base + incl - units && u < base + incl) {
        unit[0] = b;
        unit[1] = u - (base + incl - units);
        unit[2] = sn;
      }
      base += __shfl_sync(0xffffffffu, incl, 31);
      if (u < base) break;
    }
  }
  __syncthreads();
  *row = unit[0];
  *split = unit[1];
  *n_seen = unit[2];
  return unit[0] >= 0;
}

// GT: the largest G this instantiation takes (its register arrays); G <= GT
template <typename T, int GT>
__global__ void __launch_bounds__(THREADS, min_blocks(GT))
    decode_attention_kernel(const Args a) {
  unsigned long long t0[2];
  stamp(t0);
  // a flat grid, KV heads fastest: the units that have work come first,
  // so they are the first blocks to reach the SMs
  const int k = static_cast<int>(blockIdx.x % a.KV);
  int b, s, n_seen;
  if (!find_unit(a, static_cast<int>(blockIdx.x / a.KV), &b, &s, &n_seen))
    return;
  const int G = a.G, hd = a.hd, hdp = a.hdp, lpr = a.lpr, rpw = 32 / lpr;
  extern __shared__ __align__(16) char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* part = reinterpret_cast<float*>(smem);   // after the rings are done
  T* staged = reinterpret_cast<T*>(smem + region_bytes(hdp, G, sizeof(T)));
  float* ss = reinterpret_cast<float*>(staged + (G + 2) * hdp);  // scores,
                                                  // then weights
  __shared__ float m_s[MAX_G], l_s[MAX_G], sn[MAX_G];
  const long long bkv = static_cast<long long>(b) * a.KV + k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / lpr, ls = lane % lpr;
  const bool own = ls * SLICE < hdp;
  const int ns = (n_seen + SPLIT - 1) / SPLIT;
  const int blk = static_cast<int>((bkv * a.nsplit) + s);
  trace_put(blk, 0, t0);

  stage_new<T>(a, b, k, staged);                  // q, the new K / V
  cp_async_commit();
  const int start = s * SPLIT;
  const int n = ns > 0 ? min(SPLIT, n_seen - start) : 0;
  const int steps = (n + WARPS * rpw - 1) / (WARPS * rpw);
  const T* kbase = static_cast<const T*>(a.ck) + b * a.sbk +
                   static_cast<long long>(start) * a.slk +
                   static_cast<long long>(k) * hd;
  const T* vbase = static_cast<const T*>(a.cv) + b * a.sbv +
                   static_cast<long long>(start) * a.slv +
                   static_cast<long long>(k) * hd;
  constexpr int CH = SLICE * sizeof(T) / 16;      // 16-byte chunks a slice
  constexpr int SLOT = 32 * CH;                   // uint4s a ring slot
  uint4* lane_ring = ring + warp * STAGES * SLOT + lane;
  const bool copy = a.vec && own;
#pragma unroll
  for (int j = 0; j < STAGES; ++j) {
    if (copy && j < 2 * steps) {
      const T* row = item_row<T>(a, j, steps, n, warp, r, rpw, kbase, vbase);
      if (row != nullptr) fetch<T>(a, row, ls, lane_ring + j * SLOT);
    }
    cp_async_commit();
  }
  cp_async_wait<STAGES>();                        // q, the new K / V
  __syncthreads();
  trace(blk, 1);

  if (ns > 0) {
    constexpr bool QREG = GT <= 4;
    float qr[QREG ? GT : 1][SLICE];
    if constexpr (QREG) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < G && own) {
          load_slice(staged + g * hdp + ls * SLICE, qr[g]);
        } else {
#pragma unroll
          for (int e = 0; e < SLICE; ++e) qr[g][e] = 0.f;
        }
      }
    }
    float acc[GT][SLICE];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < SLICE; ++e) acc[g][e] = 0.f;

    for (int j = 0; j < 2 * steps; ++j) {
      if (j == steps) {
        // every score of the split is in: its max, weights and their sum
        __syncthreads();
        trace(blk, 2);
        for (int g = warp; g < G; g += WARPS) {
          float m = NEG_INF;
          for (int i = lane; i < n; i += 32) m = fmaxf(m, ss[g * SPLIT + i]);
          m = warp_max(m);
          float l = 0.f;
          for (int i = lane; i < n; i += 32) {
            const float p = expf(ss[g * SPLIT + i] - m);
            ss[g * SPLIT + i] = p;
            l += p;
          }
          l = warp_sum(l);
          if (lane == 0) {
            m_s[g] = m;
            l_s[g] = l;
          }
        }
        new_scores<T>(a, staged, sn);
        __syncthreads();
        trace(blk, 3);
      }
      cp_async_wait<STAGES - 1>();                // item j has landed
      const bool is_v = j >= steps;
      const int i = ((is_v ? j - steps : j) * WARPS + warp) * rpw + r;
      const bool live = i < n && own;
      float x[SLICE];
      if (live && a.vec) {
        load_ring(lane_ring + (j % STAGES) * SLOT, x, T());
      } else if (live) {
        read_direct<T>(a, item_row<T>(a, j, steps, n, warp, r, rpw, kbase,
                                      vbase), ls, x);
      } else {
#pragma unroll
        for (int e = 0; e < SLICE; ++e) x[e] = 0.f;
      }
      if (!is_v) {
        float sc[GT];
        if constexpr (QREG) {
          slice_dots<GT>(qr, x, own, lpr, sc);
        } else {
#pragma unroll
          for (int g0 = 0; g0 < GT; g0 += 4) {
            if (g0 < G) {
              float qv[4][SLICE], s4[4];
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                if (g0 + g < G && own) {
                  load_slice(staged + (g0 + g) * hdp + ls * SLICE, qv[g]);
                } else {
#pragma unroll
                  for (int e = 0; e < SLICE; ++e) qv[g][e] = 0.f;
                }
              }
              slice_dots<4>(qv, x, own, lpr, s4);
#pragma unroll
              for (int g = 0; g < 4; ++g) sc[g0 + g] = s4[g];
            }
          }
        }
        if (i < n && ls == 0) {
#pragma unroll
          for (int g = 0; g < GT; ++g)
            if (g < G) ss[g * SPLIT + i] = sc[g] * a.scale;
        }
      } else if (live) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g < G) {
            const float p = round_as<T>(ss[g * SPLIT + i]);
#pragma unroll
            for (int e = 0; e < SLICE; ++e)
              acc[g][e] = fmaf(p, x[e], acc[g][e]);
          }
        }
      }
      // the slot of item j is this lane's again: fetch item j + STAGES
      if (copy && j + STAGES < 2 * steps) {
        const T* row = item_row<T>(a, j + STAGES, steps, n, warp, r, rpw,
                                   kbase, vbase);
        if (row != nullptr)
          fetch<T>(a, row, ls, lane_ring + (j % STAGES) * SLOT);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    trace(blk, 4);
    // the row slots of a warp: butterfly over offsets 16 .. lpr
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o >= lpr) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < SLICE; ++e)
            acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
    __syncthreads();                                // the rings are free
    if (r == 0 && own) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < SLICE; ++e)
            part[(warp * G + g) * hdp + ls * SLICE + e] = acc[g][e];
    }
    __syncthreads();
    // the warps in warp order, into the workspace
    const long long slot = (bkv * a.nsplit + s) * G;
    for (int it = threadIdx.x; it < G * hd; it += THREADS) {
      const int g = it / hd, d = it % hd;
      float o = part[g * hdp + d];
      for (int w = 1; w < WARPS; ++w) o += part[(w * G + g) * hdp + d];
      a.ws_o[(slot + g) * hd + d] = o;
    }
    if (threadIdx.x < G) {
      a.ws_m[slot + threadIdx.x] = m_s[threadIdx.x];
      a.ws_l[slot + threadIdx.x] = l_s[threadIdx.x];
    }
  } else {
    new_scores<T>(a, staged, sn);
  }
  trace(blk, 5);

  // a row of one split joins it here; else the last of its splits' blocks
  if (ns > 1) {
    if (!last_arrival(a.counters + bkv, static_cast<unsigned>(ns))) return;
    trace(blk, 6);
  } else {
    __syncthreads();
  }
  const long long first = bkv * a.nsplit * G;
  join<T, GT>(a, b, k, ns, a.ws_m + first, a.ws_l + first,
              a.ws_o + first * hd, staged, sn, blk);
  trace(blk, 7);
}

// the largest shared memory any call of an instantiation asks for (hd 256,
// G = GT), capped at what a block may opt in to
int max_smem(int G, int size) {
  int most = smem_bytes(MAX_HD, G, size);
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) == cudaSuccess)
    most = most < cap - 1024 ? most : cap - 1024;
  return most;
}

template <typename T, int GT>
cudaError_t launch_g(const Args& a, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, GT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem(GT, sizeof(T)));
  if (attr != cudaSuccess) return attr;
  const int smem = smem_bytes(a.hdp, a.G, sizeof(T));
  const long long blocks = static_cast<long long>(a.KV) * a.B * a.nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  decode_attention_kernel<T, GT>
      <<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  switch (a.G) {
    case 1: return launch_g<T, 1>(a, st);
    case 2: return launch_g<T, 2>(a, st);
    case 3: return launch_g<T, 3>(a, st);
    case 4: return launch_g<T, 4>(a, st);
    default: return launch_g<T, MAX_G>(a, st);
  }
}

}  // namespace

extern "C" {

// Positions one block takes (the wrapper sizes its workspace by it).
int decode_attention_split() { return SPLIT; }

#ifdef DECODE_TRACE
// The trace of the last call (DECODE_TRACE builds): blocks x TRACE_POINTS
// pairs (globaltimer ns, clock64), zero where a block did not pass a point;
// reset = 1 zeroes it instead.
int decode_attention_trace(void* dst, int blocks, int reset) {
  const size_t bytes = static_cast<size_t>(blocks) * TRACE_POINTS * 2 *
                       sizeof(unsigned long long);
  if (reset) {
    void* p = nullptr;
    cudaError_t e = cudaGetSymbolAddress(&p, g_trace);
    if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_trace));
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, bytes));
}
#endif

// dtype: 0 = float32, 1 = bfloat16 (q, ck, cv, kn, vn alike).  q (B, H, hd),
// kn / vn (B, KV, hd) contiguous; ck / cv: (B, L, KV, hd) with element
// strides (sbk, slk) / (sbv, slv) over rows and positions, heads and
// channels contiguous.  pos: int64 on the device, read at b * pos_stride.
// ws_m / ws_l (B, H, nsplit) and ws_o (B, H, nsplit, hd) float32 with
// nsplit = max(1, ceil(L / SPLIT)); counters: B * KV zero uint32 words,
// left zero.  Full mode (partial 0): out (B, H, hd) in the dtype.  Partial
// mode: out (B, H, hd), m_out and l_out (B, H) float32, the new token
// counted when with_new.  hd <= 256, H / KV <= 16 (checked by the caller).
// Returns the launch's error.
int decode_attention(const void* q, const void* ck, const void* cv,
                     const void* kn, const void* vn, const long long* pos,
                     int pos_stride, int dtype, int B, int L, int H, int KV,
                     int hd, long long sbk, long long slk, long long sbv,
                     long long slv, float scale, long long offset,
                     int partial, int with_new, void* ws_m, void* ws_l,
                     void* ws_o, void* counters, void* out, void* m_out,
                     void* l_out, void* stream) {
  Args a;
  a.q = q;
  a.ck = ck;
  a.cv = cv;
  a.kn = kn;
  a.vn = vn;
  a.pos = pos;
  a.pos_stride = pos_stride;
  a.B = B;
  a.L = L;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.hd = hd;
  a.sbk = sbk;
  a.slk = slk;
  a.sbv = sbv;
  a.slv = slv;
  a.scale = scale;
  a.offset = offset;
  a.partial = partial;
  a.with_new = with_new;
  a.nsplit = L > SPLIT ? (L + SPLIT - 1) / SPLIT : 1;
  a.hdp = (hd + SLICE - 1) / SLICE * SLICE;
  a.lpr = 1;
  while (a.lpr * SLICE < a.hdp) a.lpr *= 2;
  const int size = dtype == 0 ? 4 : 2;
  const auto al = [size](long long x) { return (x * size) % 16 == 0; };
  const auto al_ptr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec = al_ptr(ck) && al_ptr(cv) && al(sbk) && al(slk) && al(sbv) &&
          al(slv) && al(hd);
  a.vec_new = al_ptr(q) && al_ptr(kn) && al_ptr(vn) && al(hd);
  a.ws_m = static_cast<float*>(ws_m);
  a.ws_l = static_cast<float*>(ws_l);
  a.ws_o = static_cast<float*>(ws_o);
  a.counters = static_cast<unsigned*>(counters);
  a.out = out;
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch<float>(a, st)
                                   : launch<__nv_bfloat16>(a, st);
  return static_cast<int>(e);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
