// OBU blend for Hopper (sm_90a): blocked channel shuffle fused with bias and
// activation, y[:, block j] = act(x[:, block perm[j]] + bias[block j]).
//
// Replaces the TPU kernel `blend_shuffle` (src/repro/kernels/blend.py),
// whose input BlockSpec index map reads block perm[j] while writing block j:
// the shuffle rides the copy a bias/activation epilogue needed anyway.
// Here each thread writes one output element and reads its source element
// at perm[j] * block + (c % block); within a block of channels both the
// reads and the writes are contiguous, so warps stay coalesced.
//
// What bounds it on an H100: device-memory bytes (each element read and
// written once; 25 MB for 2048 x 3072 bf16, >= 7.5 us at 3.35 TB/s).  It is
// a gather plus an elementwise epilogue, so a plain grid-stride kernel is
// the whole design.  The row padding of the TPU kernel is not needed.
//
// Arithmetic in the input dtype T (float32 or bf16): the bias add rounds to
// T, relu is exact, and silu rounds every op to T, y * (1 / (1 + exp(-y))),
// as XLA evaluates y * jax.nn.sigmoid(y) (the reference) and as the plain
// version does.

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
    T y = x[m * C + src];
    if (bias != nullptr) y = from_f<T>(to_f<T>(y) + to_f<T>(bias[c]));
    if (act == ACT_RELU) {
      y = from_f<T>(fmaxf(to_f<T>(y), 0.f));
    } else if (act == ACT_SILU) {
      const float v = to_f<T>(y);
      const float e = to_f<T>(from_f<T>(expf(-v)));
      const float d = to_f<T>(from_f<T>(1.f + e));
      const float sig = to_f<T>(from_f<T>(1.f / d));
      y = from_f<T>(v * sig);
    }
    out[idx] = y;
  }
}

template <typename T>
void launch(const void* x, const void* bias, const int* perm, int block,
            int act, int64_t M, int C, void* out, cudaStream_t st) {
  const int64_t total = M * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;       // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  blend_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), perm, block, act,
      M, C, static_cast<T*>(out));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, out: (M, C) contiguous; bias: (C,)
// or null; perm: (C / block,) int32 on the device, a permutation (checked by
// the caller).  act: 0 none, 1 relu, 2 silu.  Returns cudaGetLastError().
int blend_shuffle(const void* x, int dtype, const void* bias, const int* perm,
                  int block, int act, long long M, int C, void* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, bias, perm, block, act, M, C, out, st);
  else
    launch<__nv_bfloat16>(x, bias, perm, block, act, M, C, out, st);
  return static_cast<int>(cudaGetLastError());
}

const char* blend_shuffle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
