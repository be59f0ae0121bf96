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

// KV row sources of the chunk-attention kernels (flash_attention.cu;
// flash_decode.cu stages its rows itself).  The kernels are templates over
// the source and take the K and V base pointers as __restrict__ parameters
// of element type Source::Elem.  A source stages one 64-row logical K/V
// tile of (sequence b, kv head h) from column j0 into shared memory as fp32
// — K rows padded to D+1 floats, V rows Dv wide — with rows j >= n
// zero-filled and never loaded; nothing else in a kernel knows how the
// cache is laid out.  The kernels only ever ask for rows below their last
// allowed column.

// Dense cache: k (B, S, Hk, D), v (B, S, Hk, Dv).  These are the dense
// kernels' staging loops as they were before the paged source existed.
struct DenseKV {
  using Elem = float;
  int S, Hk;
  template <int THREADS, int BKV>
  __device__ __forceinline__ void stage(const float* __restrict__ k,
                                        const float* __restrict__ v, const float*,
                                        const float*, float* ks, float* vs, int b, int h,
                                        int j0, int n, int D, int Dv) const {
    for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
      const int j = i / D, d = i % D;
      ks[j * (D + 1) + d] = j < n ? k[(((size_t)b * S + j0 + j) * Hk + h) * D + d] : 0.f;
    }
    for (int i = threadIdx.x; i < BKV * Dv; i += THREADS) {
      const int j = i / Dv, d = i % Dv;
      vs[i] = j < n ? v[(((size_t)b * S + j0 + j) * Hk + h) * Dv + d] : 0.f;
    }
  }
};

// Paged cache: pages_k (N, P, Hk, D), pages_v (N, P, Hk, Dv), table (B, MP)
// int32, rows located by paged_row.  T = int8_t: each element is
// dequantized as float(x) * scale[block, h] with the (N, Hk) fp32 sidecars.
// One warp stages one tile row at a time: the table is read once per row,
// not once per element, and the lanes read the row's contiguous elements
// together.
template <typename T>
struct PagedKV {
  using Elem = T;
  const int* table;
  int MP, P, N, Hk;
  template <int THREADS, int BKV>
  __device__ __forceinline__ void stage(const T* __restrict__ k, const T* __restrict__ v,
                                        const float* __restrict__ k_scale,
                                        const float* __restrict__ v_scale, float* ks,
                                        float* vs, int b, int h, int j0, int n, int D,
                                        int Dv) const {
    const int lane = threadIdx.x % 32;
    for (int j = threadIdx.x / 32; j < BKV; j += THREADS / 32) {
      float* kr = ks + j * (D + 1);
      float* vr = vs + j * Dv;
      if (j >= n) {                       // warp-uniform: no divergence
        for (int d = lane; d < D; d += 32) kr[d] = 0.f;
        for (int d = lane; d < Dv; d += 32) vr[d] = 0.f;
        continue;
      }
      int blk;
      const size_t row = paged_row(table, MP, P, N, Hk, b, h, j0 + j, blk);
      if constexpr (sizeof(T) == 1) {
        const float sk = k_scale[(size_t)blk * Hk + h], sv = v_scale[(size_t)blk * Hk + h];
        for (int d = lane; d < D; d += 32) kr[d] = static_cast<float>(k[row * D + d]) * sk;
        for (int d = lane; d < Dv; d += 32) vr[d] = static_cast<float>(v[row * Dv + d]) * sv;
      } else {
        for (int d = lane; d < D; d += 32) kr[d] = k[row * D + d];
        for (int d = lane; d < Dv; d += 32) vr[d] = v[row * Dv + d];
      }
    }
  }
};

}  // namespace repro_torch
