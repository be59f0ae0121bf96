// rmsnorm: y = (x [+ residual]) * rsqrt(mean((x [+ residual])^2) + eps) * w,
// row-wise over the last dim, fp32.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (bodies _rmsnorm_kernel and
// _rmsnorm_res_kernel), behind `rmsnorm` pallas (ops.py:261).
//
// What bounds it on the H100: bytes.  It does 3-4 flops per 4-byte element
// read, so its least time is the rows' bytes over 3.35 TB/s; at the serving
// widths (D = 3072, 4..256 rows) that is a few microseconds and the launch
// itself is a large share.
//
// Design: one 256-thread block per row.  Pass 1 sums x^2 in a fixed strided
// order per thread, then a fixed warp-shuffle tree and a fixed tree across the
// 8 warps; pass 2 rereads the row (from L1/L2, it was just touched) and
// writes the scaled result, so device memory sees each byte about once.  The
// reduction order depends only on D, never on the number of rows, so a row's
// result is the same in any batch.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, NWARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ res,
               const float* __restrict__ w, float* __restrict__ y, int D, float eps) {
  __shared__ float part[NWARPS];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const float* xr = x + base;
  const float* rr = res == nullptr ? nullptr : res + base;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    float v = xr[i];
    if (rr != nullptr) v += rr[i];
    ss = fmaf(v, v, ss);
  }
  ss = repro_torch::warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < NWARPS ? part[lane] : 0.f;
    v = repro_torch::warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(D) + eps);

  float* yr = y + base;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    float v = xr[i];
    if (rr != nullptr) v += rr[i];
    yr[i] = v * inv * w[i];
  }
}

}  // namespace

// residual may be null (the plain form).
extern "C" int rmsnorm_f32(const float* x, const float* residual, const float* w,
                           float* y, int rows, int D, float eps, void* stream) {
  rmsnorm_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, residual, w, y, D, eps);
  return static_cast<int>(cudaGetLastError());
}
