// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel here is fp32 with FFMA arithmetic (no TF32 tensor cores): the
// JAX reference computes in fp32 throughout, and the serving engine must stay
// token-exact against it.  Every reduction has a fixed order that depends on
// nothing but the row it reduces (no atomics, no split chosen from the batch
// size), so a sequence's numbers are the same at batch 4 as at batch 1.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Large-negative instead of -inf, as in the Pallas kernels: masked softmax
// entries stay finite and an empty row finishes as 0 / max(l, 1e-30) = 0.
constexpr float kNegInf = -1e30f;

// Shared memory one block may use on an H100 (above 48 KB only as dynamic
// shared memory after cudaFuncSetAttribute).
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace repro_torch
