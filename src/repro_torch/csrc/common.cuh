// Shared helpers of the port's hand-written Hopper kernels.
//
// Every fp32 kernel here computes with FFMA arithmetic (no TF32 tensor
// cores): the JAX reference computes in fp32 throughout, and the serving
// engine must stay token-exact against it.  The bf16 entries follow the
// Pallas kernels' contract for bf16 inputs: every sum and the softmax
// state in fp32, one rounding to bf16 (to nearest even) on store.  The bf16
// partial decode's upcasts on load (exact) and runs the fp32 entry's
// arithmetic, so its bf16 result is the fp32 kernel's result on x.float()
// rounded once; gemm's, batched_gemm's and flash_attention's multiply on
// the tensor cores (wgmma, fp32 accumulator; gemm.cu, flash_attention.cu,
// wgmma.cuh), both flash_decode bodies' and ssd_scan's too (mma.sync, the
// helpers below; flash_decode.cu, ssd.cu), and rmsnorm's has a bf16 layout
// of its own (rmsnorm.cu).
// Every reduction has a fixed order that depends on nothing but the row it
// reduces (no atomics, no split chosen from the batch size), so a
// sequence's numbers are the same at batch 4 as at batch 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four bf16 values packed little-endian in 8 bytes -> fp32 (exact: the 16
// bits are the top half of the float).
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Four consecutive values as fp32: p 16-byte (fp32) or 8-byte (bf16) aligned.
__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const bf16* p) {
  return bf16x4_to_float4(*reinterpret_cast<const uint2*>(p));
}

// Store four fp32 values at p (aligned as for load4f), rounding to bf16.
__device__ __forceinline__ void store4f(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4f(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

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

// The tensor-core helpers of the mma.sync bodies (the narrow and wide bf16
// decodes in flash_decode.cu, ssd_scan_bf16 in ssd.cu).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix: 8x8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// rows of matrix i; lane t gets row t / 4, columns 2 (t % 4) and + 1 of
// each (.trans: column t / 4, rows 2 (t % 4) and + 1).
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += A B on the tensor cores: A 16x16 bf16 (a0, a2 rows t / 4; a1, a3
// rows t / 4 + 8), B 16x8 bf16, c 16x8 fp32 (c[0], c[1] row t / 4 columns
// 2 (t % 4), + 1; c[2], c[3] row t / 4 + 8).
__device__ __forceinline__ void mma16816(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// (a, b) as two bf16 pairs whose sum holds their first 16 significant bits:
// hi = (a, b) rounded to bf16, lo = what hi leaves, rounded.  A product with
// hi, then one with lo, is a product with an fp32 factor at a relative
// error of about 2^-17.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

// One element global -> shared, 0 when !valid: an fp32 element by cp.async
// (4 bytes), a bf16 one by a plain load and store (cp.async copies 4, 8 or
// 16 bytes).  Other threads see either after the barrier that follows the
// cp_async_wait.
__device__ __forceinline__ void copy1(float* dst, const float* src, bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src, bool valid) {
  *reinterpret_cast<unsigned short*>(dst) =
      valid ? *reinterpret_cast<const unsigned short*>(src) : static_cast<unsigned short>(0);
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
