// rmsnorm: y = (x [+ residual]) * rsqrt(mean((x [+ residual])^2) + eps) * w,
// row-wise over the last dim; x, residual, w and y all fp32 (rmsnorm_f32) or
// all bf16 (rmsnorm_bf16), every sum in fp32.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (bodies _rmsnorm_kernel and
// _rmsnorm_res_kernel), behind `rmsnorm` pallas (ops.py:261).
//
// What bounds it on the H100: bytes.  It does 3-4 flops per 4-byte element
// read, so its least time is the rows' bytes over 3.35 TB/s: 5.0 us for a
// 1024 x 2048 prefill, 0.03 us for a 4 x 3072 decode, where the launch
// itself (a few us) is the floor.
//
// Design: a row is held in registers and read from device memory once.
// Its ceil(D / 4) groups of 4 floats go to row_threads(D) threads (the
// fewest, a power of 2 from 32 to 256, that hold them at most MAX_VPT a
// thread), group v * tpr + t to thread t; a 256-thread block takes 256 / tpr
// rows.  Each thread loads its groups of w, then of x (and the residual, added
// in registers) as float4s, sums their squares in group order, reduces by a
// fixed warp-shuffle tree and, across the row's warps, through shared memory
// in warp order; then scales its registers and writes them.  Rows and
// pointers off 16 bytes (D % 4 != 0, or an offset view) take the same groups
// element by element, zeros past D, so the sums are the same.  Past D = 8192
// a thread holds more than MAX_VPT groups; that path (no served width takes
// it) sums the same groups in the same order and reads the row again to
// write it.  The layout depends on D alone, never on the row count, so a
// row's result is the same in a 1-row and a 1024-row call.
//
// bf16 (rmsnorm_bf16): the same kernel on 2-byte elements, as the Pallas
// kernel takes them: x, the residual and w are upcast as they are loaded (a
// group of 4 is 8 bytes), x + residual is added in fp32 and never rounded,
// and only y is rounded to bf16, once.  The bytes, and so the bound, halve.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VPT = 8;   // float4 groups a thread holds in registers

// Threads per row (kernels/rmsnorm.py::row_layout mirrors it).
int row_threads(int D) {
  const int g4 = (D + 3) / 4;
  int t = 32;
  while (t < THREADS && t * MAX_VPT < g4) t <<= 1;
  return t;
}

template <bool VEC, typename T>
__device__ __forceinline__ float4 load4(const T* p, int g, int D) {
  using repro_torch::to_f32;
  if (VEC) return repro_torch::load4f(p + 4 * g);
  const int d = 4 * g;
  return make_float4(d < D ? to_f32(p[d]) : 0.f, d + 1 < D ? to_f32(p[d + 1]) : 0.f,
                     d + 2 < D ? to_f32(p[d + 2]) : 0.f, d + 3 < D ? to_f32(p[d + 3]) : 0.f);
}

template <bool VEC, typename T>
__device__ __forceinline__ void store4(T* p, int g, int D, float4 v) {
  if (VEC) {
    repro_torch::store4f(p + 4 * g, v);
    return;
  }
  using repro_torch::from_f32;
  const int d = 4 * g;
  if (d < D) p[d] = from_f32<T>(v.x);
  if (d + 1 < D) p[d + 1] = from_f32<T>(v.y);
  if (d + 2 < D) p[d + 2] = from_f32<T>(v.z);
  if (d + 3 < D) p[d + 3] = from_f32<T>(v.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float sq4(float4 v, float ss) {
  ss = fmaf(v.x, v.x, ss);
  ss = fmaf(v.y, v.y, ss);
  ss = fmaf(v.z, v.z, ss);
  return fmaf(v.w, v.w, ss);
}

__device__ __forceinline__ float4 scale4(float4 v, float inv, float4 w) {
  return make_float4(v.x * inv * w.x, v.y * inv * w.y, v.z * inv * w.z, v.w * inv * w.w);
}

// The row's sum of squares from each thread's part: a warp-shuffle tree,
// then the row's warps in order.  Every thread of the block calls it.
__device__ __forceinline__ float row_sum(float ss, int tpr, float* part) {
  ss = repro_torch::warp_sum(ss);
  if (tpr == 32) return ss;
  const int warp = threadIdx.x / 32, nw = tpr / 32, first = warp / nw * nw;
  if (threadIdx.x % 32 == 0) part[warp] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int k = 0; k < nw; ++k) tot += part[first + k];
  return tot;
}

// VPT > 0: up to VPT groups a thread, in registers; VPT == 0: any number,
// the row read twice.  T: the element type of x, res, w and y.
template <int VPT, bool VEC, typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w,
               T* __restrict__ y, int rows, int D, float eps, int tpr) {
  __shared__ float part[THREADS / 32];
  const int t = threadIdx.x % tpr, g4 = (D + 3) / 4;
  const int row = blockIdx.x * (THREADS / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;     // a dead row's threads still reach the barrier
  const size_t base = static_cast<size_t>(live ? row : 0) * D;
  const T* xr = x + base;
  const T* rr = res == nullptr ? nullptr : res + base;
  T* yr = y + base;

  if constexpr (VPT > 0) {
    float4 wv[VPT], v[VPT];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) wv[k] = v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int g = k * tpr + t;
      if (g < g4) wv[k] = load4<VEC>(w, g, D);
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int g = k * tpr + t;
      if (live && g < g4) {
        v[k] = load4<VEC>(xr, g, D);
        if (rr != nullptr) v[k] = add4(v[k], load4<VEC>(rr, g, D));
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (live && k * tpr + t < g4) ss = sq4(v[k], ss);
    const float inv = rsqrtf(row_sum(ss, tpr, part) / static_cast<float>(D) + eps);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int g = k * tpr + t;
      if (live && g < g4) store4<VEC>(yr, g, D, scale4(v[k], inv, wv[k]));
    }
  } else {
    float ss = 0.f;
    for (int g = t; live && g < g4; g += tpr) {
      float4 v = load4<VEC>(xr, g, D);
      if (rr != nullptr) v = add4(v, load4<VEC>(rr, g, D));
      ss = sq4(v, ss);
    }
    const float inv = rsqrtf(row_sum(ss, tpr, part) / static_cast<float>(D) + eps);
    for (int g = t; live && g < g4; g += tpr) {
      float4 v = load4<VEC>(xr, g, D);
      if (rr != nullptr) v = add4(v, load4<VEC>(rr, g, D));
      store4<VEC>(yr, g, D, scale4(v, inv, load4<VEC>(w, g, D)));
    }
  }
}

template <bool VEC, typename T>
cudaError_t launch(const T* x, const T* res, const T* w, T* y, int rows, int D, float eps,
                   cudaStream_t s) {
  const int tpr = row_threads(D), vpt = ((D + 3) / 4 + tpr - 1) / tpr;
  const int grid = (rows + THREADS / tpr - 1) / (THREADS / tpr);
  if (vpt <= 1)
    rmsnorm_kernel<1, VEC, T><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else if (vpt <= 2)
    rmsnorm_kernel<2, VEC, T><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else if (vpt <= 4)
    rmsnorm_kernel<4, VEC, T><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else if (vpt <= MAX_VPT)
    rmsnorm_kernel<MAX_VPT, VEC, T><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else
    rmsnorm_kernel<0, VEC, T><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  return cudaGetLastError();
}

// Groups of 4 as one load or store where D % 4 == 0 and every pointer is
// aligned to a group (16 bytes fp32, 8 bf16).
template <typename T>
int run(const T* x, const T* residual, const T* w, T* y, int rows, int D, float eps,
        void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(residual);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D % 4 == 0 && bits % (4 * sizeof(T)) == 0
                              ? launch<true>(x, residual, w, y, rows, D, eps, s)
                              : launch<false>(x, residual, w, y, rows, D, eps, s);
  return static_cast<int>(err);
}

__global__ void empty_kernel() {}

}  // namespace

// residual may be null (the plain form).  rows > 0, D > 0.
extern "C" int rmsnorm_f32(const float* x, const float* residual, const float* w,
                           float* y, int rows, int D, float eps, void* stream) {
  return run(x, residual, w, y, rows, D, eps, stream);
}

extern "C" int rmsnorm_bf16(const __nv_bfloat16* x, const __nv_bfloat16* residual,
                            const __nv_bfloat16* w, __nv_bfloat16* y, int rows, int D,
                            float eps, void* stream) {
  return run(x, residual, w, y, rows, D, eps, stream);
}

// One launch of an empty kernel on `stream`: the floor under every wrapper's
// launch path (chip_smoke.py times it through the same ctypes call).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
