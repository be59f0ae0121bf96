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

// KV row sources of the attention kernels.  The kernels are templates over
// the source and take the K and V base pointers as __restrict__ parameters
// of element type Source::Elem.  A source stages one 64-row logical K/V
// tile of (sequence b, kv head h) from column j0 into shared memory as fp32
// — K rows padded to D+1 floats, V rows Dv wide — with rows j >= n
// zero-filled and never loaded; nothing else in a kernel knows how the
// cache is laid out.  The kernels only ever ask for rows below the
// sequence's length (decode) or its last allowed column (chunk).

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
// int32.  Logical column col of sequence b is row col % P of block
// table[b, col / P], clipped to [0, N-1] as the Pallas kernel's table is.
// T = int8_t: each element is dequantized as float(x) * scale[block, h]
// with the (N, Hk) fp32 sidecars.  One warp stages one tile row at a time:
// the table is read once per row, not once per element, and the lanes read
// the row's contiguous elements together.
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
      const int col = j0 + j;
      const int blk = min(max(table[(size_t)b * MP + col / P], 0), N - 1);
      const size_t row = ((size_t)blk * P + col % P) * Hk + h;
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
