// OBU blend for Hopper (sm_90a): blocked channel shuffle fused with bias and
// activation, y[:, block j] = act(x[:, block perm[j]] + bias[block j]).
//
// Replaces the TPU kernel `blend_shuffle` (src/repro/kernels/blend.py),
// whose input BlockSpec index map reads block perm[j] while writing block j:
// the shuffle rides the copy a bias/activation epilogue needed anyway.
//
// What bounds it on an H100: device-memory bytes (each element read and
// written once; 25 MB for 2048 x 3072 bf16, >= 7.5 us at 3.35 TB/s).  It is
// a gather plus an elementwise epilogue, so the design is one pass with the
// widest accesses the layout allows.  The row padding of the TPU kernel is
// not needed.  Two kernels, chosen by the wrapper (`kernels/blend.py`):
//   * `blend_vec_kernel`, where `block` is a multiple of the vector width
//     (16 bytes: 8 bf16 or 4 float32) and x, out and bias start 16-byte
//     aligned: a 2-D grid of (vectors of a row, rows).  A thread owns one
//     16-byte vector of output columns in one row; it finds the vector's
//     source offset perm[j] * block + (c % block) and its bias vector once
//     (rows past the grid's 65535 are strided).  Within a block of channels
//     the source is contiguous, so every vector is one aligned load.  More
//     rows per thread measured no faster at 2048 rows and slower at 4
//     (PERF.md);
//   * `blend_kernel` otherwise (a ragged block, an unaligned view): one
//     element per thread through a grid-stride loop, 2-byte or 4-byte
//     accesses, coalesced within a block of channels.
//
// Arithmetic in the input dtype T (float32 or bf16), the same in both: the
// bias add rounds to T, relu is exact, and silu rounds every op to T,
// y * (1 / (1 + exp(-y))), as XLA evaluates y * jax.nn.sigmoid(y) (the
// reference) and as the plain version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2 };

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

// The low bits of a 32-bit word as T, and T as the low bits of a word.
template <typename T> __device__ __forceinline__ T from_bits(uint32_t u);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t u) {
  return __uint_as_float(u);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(
    uint32_t u) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu));
}
template <typename T> __device__ __forceinline__ uint32_t to_bits(T v);
template <> __device__ __forceinline__ uint32_t to_bits<float>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ uint32_t to_bits<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// The epilogue of one element: bias add, then relu or silu.
template <typename T>
__device__ __forceinline__ T epilogue(T y, bool has_bias, T b, int act) {
  if (has_bias) y = from_f<T>(to_f<T>(y) + to_f<T>(b));
  if (act == ACT_RELU) {
    y = from_f<T>(fmaxf(to_f<T>(y), 0.f));
  } else if (act == ACT_SILU) {
    const float v = to_f<T>(y);
    const float e = to_f<T>(from_f<T>(expf(-v)));
    const float d = to_f<T>(from_f<T>(1.f + e));
    const float sig = to_f<T>(from_f<T>(1.f / d));
    y = from_f<T>(v * sig);
  }
  return y;
}

// The epilogue of a 16-byte vector of T (bias vector bv), with the bias and
// the activation fixed at compile time: no branch between the elements, so
// their work interleaves (a silu per element is a chain of dependent ops).
template <typename T, bool BIAS, int ACT>
__device__ __forceinline__ uint4 epilogue16_of(uint4 xv, uint4 bv) {
  constexpr int PER = 4 / sizeof(T);        // elements per 32-bit word
  const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
  uint32_t o[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    o[w] = 0u;
#pragma unroll
    for (int h = 0; h < PER; ++h) {
      const int shift = 16 * h;
      const T y = epilogue<T>(from_bits<T>(xw[w] >> shift), BIAS,
                              from_bits<T>(bw[w] >> shift), ACT);
      o[w] |= to_bits<T>(y) << shift;
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <typename T>
__device__ __forceinline__ uint4 epilogue16(uint4 xv, uint4 bv, bool bias,
                                            int act) {
  if (act == ACT_SILU)
    return bias ? epilogue16_of<T, true, ACT_SILU>(xv, bv)
                : epilogue16_of<T, false, ACT_SILU>(xv, bv);
  if (act == ACT_RELU)
    return bias ? epilogue16_of<T, true, ACT_RELU>(xv, bv)
                : epilogue16_of<T, false, ACT_RELU>(xv, bv);
  return bias ? epilogue16_of<T, true, ACT_NONE>(xv, bv) : xv;
}

constexpr int VEC_THREADS = 128;

// grid (ceil(C / V / VEC_THREADS), min(M, 65535)).
template <typename T>
__global__ void __launch_bounds__(VEC_THREADS)
blend_vec_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                 const int* __restrict__ perm, int block, int act, int64_t M,
                 int C, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const int c = (blockIdx.x * VEC_THREADS + threadIdx.x) * V;
  if (c >= C) return;
  const int j = c / block;
  const int src = perm[j] * block + (c - j * block);
  const bool has_bias = bias != nullptr;
  const uint4 bv = has_bias ? __ldg(reinterpret_cast<const uint4*>(bias + c))
                            : make_uint4(0u, 0u, 0u, 0u);
  for (int64_t m = blockIdx.y; m < M; m += gridDim.y) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + m * C + src));
    *reinterpret_cast<uint4*>(out + m * C + c) =
        epilogue16<T>(v, bv, has_bias, act);
  }
}

template <typename T>
__global__ void blend_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                             const int* __restrict__ perm, int block, int act,
                             int64_t M, int C, T* __restrict__ out) {
  const int64_t total = M * C;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t m = idx / C;
    const int c = static_cast<int>(idx - m * C);
    const int j = c / block;
    const int src = perm[j] * block + (c - j * block);
    const bool has_bias = bias != nullptr;
    out[idx] = epilogue<T>(x[m * C + src], has_bias,
                           has_bias ? bias[c] : from_f<T>(0.f), act);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* bias, const int* perm, int block,
                   int act, int64_t M, int C, int vec, void* out,
                   cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(out);
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    if (block % V != 0 || !aligned16(x) || !aligned16(out) ||
        (bias != nullptr && !aligned16(bias)))
      return cudaErrorInvalidValue;
    // at least one block on each axis: an empty x launches a no-op
    const int cols = (C / V + VEC_THREADS - 1) / VEC_THREADS;
    dim3 grid(cols > 1 ? cols : 1,
              M > 65535 ? 65535u : static_cast<unsigned>(M > 1 ? M : 1));
    blend_vec_kernel<T><<<grid, VEC_THREADS, 0, st>>>(xt, bt, perm, block, act,
                                                      M, C, yt);
    return cudaGetLastError();
  }
  const int64_t total = M * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;       // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  blend_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      xt, bt, perm, block, act, M, C, yt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, out: (M, C) contiguous; bias: (C,)
// or null; perm: (C / block,) int32 on the device, a permutation (checked by
// the caller).  act: 0 none, 1 relu, 2 silu.  vec: 1 = the 16-byte vector
// pass (block a multiple of 16 bytes of T, x, out and bias 16-byte aligned;
// refused otherwise), 0 = the element pass.  Returns the launch's error.
int blend_shuffle(const void* x, int dtype, const void* bias, const int* perm,
                  int block, int act, long long M, int C, int vec, void* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0
          ? launch<float>(x, bias, perm, block, act, M, C, vec, out, st)
          : launch<__nv_bfloat16>(x, bias, perm, block, act, M, C, vec, out,
                                  st);
  return static_cast<int>(e);
}

const char* blend_shuffle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
