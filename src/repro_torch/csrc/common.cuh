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

// Asynchronous copies global -> shared (sm_80+).  `valid` false copies no
// byte and fills the destination with zeros (src-size 0); `src` must still
// be a mapped address.  A thread sees its own copies after cp_async_wait;
// other threads after a barrier (__syncwarp / __syncthreads) that follows it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The paged cache's layout, for every paged kernel: logical column col of
// (sequence b, kv head h) is row col % P of block table[b, col / P] (table
// (B, MP) int32), the block clipped to [0, N-1] as the Pallas kernels'
// table is.  Returns the row index into the (N * P * Hk, width) view of the
// pages; `blk` gets the block, whose int8 scales are scale[blk * Hk + h].
__device__ __forceinline__ size_t paged_row(const int* table, int MP, int P, int N, int Hk,
                                            int b, int h, int col, int& blk) {
  blk = min(max(table[(size_t)b * MP + col / P], 0), N - 1);
  return ((size_t)blk * P + col % P) * Hk + h;
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device
// (cudaFuncAttributeMaxDynamicSharedMemorySize).  `set` is the launch
// site's record of the limit already set on each device, so the runtime is
// called only when a launch needs more than the last one did, not on every
// launch.
constexpr int kMaxDevices = 64;
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, int (&set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set[dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) set[dev] = static_cast<int>(bytes);
  return err;
}

// Widths are padded to a multiple of 4 floats in shared memory (float4 reads).
__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

// Where logical row `col` of (sequence b, kv head h) of a KV cache lives, as
// a row index of the (rows, width) view of the K (or V) tensor; `blk` gets
// the page (0 for the dense cache).  The attention kernels (flash_decode.cu,
// flash_attention.cu) are templates over these, so nothing else in them
// knows how the cache is laid out, and an fp32 paged row runs the dense
// row's arithmetic.

// Dense cache: k (B, S, Hk, D), v (B, S, Hk, Dv).
struct DenseRows {
  int S, Hk;
  __device__ __forceinline__ size_t row(int b, int h, int col, int& blk) const {
    blk = 0;
    return ((size_t)b * S + col) * Hk + h;
  }
};

// Paged cache: pages (N, P, Hk, D/Dv), table (B, MP) int32 (paged_row).
struct PagedRows {
  const int* table;
  int MP, P, N, Hk;
  __device__ __forceinline__ size_t row(int b, int h, int col, int& blk) const {
    return paged_row(table, MP, P, N, Hk, b, h, col, blk);
  }
};

}  // namespace repro_torch
