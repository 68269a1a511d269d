// Shared piece of the photonic W8A8 MVM kernels for Hopper (sm_90a).
//
// The TIA rescale `rescale` is the one place the integer product becomes a
// float: every MVM kernel uses it (`photonic_mvm_fused.cu`,
// `photonic_mvm_split.cu`, `photonic_mvm_resident.cu`), so the split
// pipeline's float32 output cast to the activation dtype equals the fused
// kernel's output bit for bit, and each stream of the reuse-resident
// kernel equals the split output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pmvm {

// y = 2 (q.W' - sum(q)/2) s_x s_w  ==  acc * s_x * s_w / 127 for the exact
// integer product acc = sum_k q[k] wq[k, n] (paper eq. 6 in integer form).
__device__ __forceinline__ float rescale(int32_t acc, float sx, float swn) {
  return static_cast<float>(acc) * (sx * swn) / 127.0f;
}

}  // namespace pmvm
