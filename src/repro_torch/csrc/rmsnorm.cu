// rmsnorm: y = (x [+ residual]) * rsqrt(mean((x [+ residual])^2) + eps) * w,
// row-wise over the last dim; x, residual, w and y all fp32 (rmsnorm_f32) or
// all bf16 (rmsnorm_bf16), every sum in fp32.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (bodies _rmsnorm_kernel and
// _rmsnorm_res_kernel, src/repro/kernels/rmsnorm.py:39), behind `rmsnorm`
// pallas (ops.py:261).
//
// What bounds it on the H100: bytes.  It does 3-4 flops per element read,
// so its least time is the rows' bytes over 3.35 TB/s: 5.0 us for a 4096 x
// 1024 bf16 encoder row block, 8.8 us for a 1024 x 7168 bf16 prefill, 0.01
// us for a 4 x 1024 decode step, where the launch itself (a few us) is the
// floor.  Reaching the bound takes tens of KB of loads in flight on every
// SM.
//
// fp32 (rmsnorm_f32, rmsnorm_kernel): a row is held in registers and read
// from device memory once.  Its ceil(D / 4) groups of 4 floats go to
// row_threads(D) threads (the fewest, a power of 2 from 32 to 256, that hold
// them at most MAX_VPT a thread), group v * tpr + t to thread t; a
// 256-thread block takes 256 / tpr rows.  Each thread loads its groups of w,
// then of x (and the residual, added in registers) as float4s, sums their
// squares in group order, reduces by a fixed warp-shuffle tree and, across
// the row's warps, through shared memory in warp order; then scales its
// registers and writes them.  Rows and pointers off 16 bytes (D % 4 != 0,
// or an offset view) take the same groups element by element, zeros past
// D, so the sums are the same.  Past D = 8192 a thread holds more than
// MAX_VPT groups; that path (no served width takes it) sums the same groups
// in the same order and reads the row again to write it.
//
// bf16 (rmsnorm_bf16, rmsnorm_bf16_kernel): a layout of its own, in pieces
// of 8 bf16 values, 16 bytes, one load or store a piece.  The row's
// ceil(D / 8) pieces go to row_threads_bf16(D) threads (the fewest, a power
// of 2 from 32 to 256, that hold them at most MAX_PPT a thread), piece
// k * tpr + t to thread t, so a warp's lanes read 512 consecutive bytes a
// load.  A thread keeps its pieces of x (and of the residual) as loaded,
// packed bf16, 4 registers a piece, not as fp32: that is the choice made
// for the bytes in flight.  Fewer registers a thread (about 40 without the
// residual) let an SM hold up to 56 warps of 256-thread blocks, each with
// all of its row's pieces in flight at once (up to 2 KB a warp), instead of
// the fp32 layout's fp32 registers, which held 8-byte groups and let two
// or three blocks an SM.  The alternative, more rows a warp with the next
// row's loads issued before this row's reduction, needs the same registers
// twice and gains nothing while the card has room for more warps.  w is
// read once a block: its pieces are copied (cp.async) into shared memory
// while the rows load, and every row of the block scales from there.  The
// squares are summed in fp32, x + residual in fp32 and never rounded, in
// piece order and value order within a piece, then by the warp-shuffle
// tree and across the row's warps in warp order: an order fixed by D alone,
// never by the row count, so a row's bits are the same in a 1-row and a
// 4096-row call.  y is rounded to bf16 once.  Rows and pointers off 16
// bytes (D % 8 != 0, or an offset view) take the same pieces element by
// element, zeros past D, so the sums are the same.  Past D = 8192 (more
// than MAX_PPT pieces a thread at 256 threads) the two-pass path sums the
// same pieces in the same order and reads the row and w again to write it.
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

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int g, int D) {
  if (VEC) return repro_torch::load4f(p + 4 * g);
  const int d = 4 * g;
  return make_float4(d < D ? p[d] : 0.f, d + 1 < D ? p[d + 1] : 0.f, d + 2 < D ? p[d + 2] : 0.f,
                     d + 3 < D ? p[d + 3] : 0.f);
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int g, int D, float4 v) {
  if (VEC) {
    repro_torch::store4f(p + 4 * g, v);
    return;
  }
  const int d = 4 * g;
  if (d < D) p[d] = v.x;
  if (d + 1 < D) p[d + 1] = v.y;
  if (d + 2 < D) p[d + 2] = v.z;
  if (d + 3 < D) p[d + 3] = v.w;
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
// the row read twice.
template <int VPT, bool VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ res,
               const float* __restrict__ w, float* __restrict__ y, int rows, int D, float eps,
               int tpr) {
  __shared__ float part[THREADS / 32];
  const int t = threadIdx.x % tpr, g4 = (D + 3) / 4;
  const int row = blockIdx.x * (THREADS / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;     // a dead row's threads still reach the barrier
  const size_t base = static_cast<size_t>(live ? row : 0) * D;
  const float* xr = x + base;
  const float* rr = res == nullptr ? nullptr : res + base;
  float* yr = y + base;

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

template <bool VEC>
cudaError_t launch(const float* x, const float* res, const float* w, float* y, int rows, int D,
                   float eps, cudaStream_t s) {
  const int tpr = row_threads(D), vpt = ((D + 3) / 4 + tpr - 1) / tpr;
  const int grid = (rows + THREADS / tpr - 1) / (THREADS / tpr);
  if (vpt <= 1)
    rmsnorm_kernel<1, VEC><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else if (vpt <= 2)
    rmsnorm_kernel<2, VEC><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else if (vpt <= 4)
    rmsnorm_kernel<4, VEC><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else if (vpt <= MAX_VPT)
    rmsnorm_kernel<MAX_VPT, VEC><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  else
    rmsnorm_kernel<0, VEC><<<grid, THREADS, 0, s>>>(x, res, w, y, rows, D, eps, tpr);
  return cudaGetLastError();
}

// Groups of 4 as one load or store where D % 4 == 0 and every pointer is
// aligned to a group (16 bytes).
int run(const float* x, const float* residual, const float* w, float* y, int rows, int D,
        float eps, void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(residual);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D % 4 == 0 && bits % 16 == 0
                              ? launch<true>(x, residual, w, y, rows, D, eps, s)
                              : launch<false>(x, residual, w, y, rows, D, eps, s);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// the bf16 body

using repro_torch::bf16;

constexpr int BF16_THREADS = 256;
constexpr int PIECE = 8;     // bf16 values a piece: 16 bytes
constexpr int MAX_PPT = 4;   // pieces a thread holds in registers

// Threads per row of the bf16 body (kernels/rmsnorm.py::row_layout_bf16
// mirrors it).
int row_threads_bf16(int D) {
  const int np = (D + PIECE - 1) / PIECE;
  int t = 32;
  while (t < BF16_THREADS && t * MAX_PPT < np) t <<= 1;
  return t;
}

__device__ __forceinline__ unsigned raw16(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// Piece `i` of a row as 8 packed bf16 values: one 16-byte load (VEC: the
// row 16-byte aligned, D % 8 == 0), or element by element with zeros past D.
template <bool VEC>
__device__ __forceinline__ uint4 load_piece(const bf16* row, int i, int D) {
  if (VEC) return *reinterpret_cast<const uint4*>(row + PIECE * i);
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = PIECE * i + 2 * j;
    u[j] = (d < D ? raw16(row + d) : 0u) | ((d + 1 < D ? raw16(row + d + 1) : 0u) << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The 8 fp32 values of a piece (x, plus the residual's in fp32 with RES).
template <bool RES>
__device__ __forceinline__ void piece_values(uint4 x, uint4 r, float (&v)[8]) {
  const unsigned xs[4] = {x.x, x.y, x.z, x.w}, rs[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(xs[j] << 16);
    v[2 * j + 1] = __uint_as_float(xs[j] & 0xffff0000u);
    if (RES) {
      v[2 * j] += __uint_as_float(rs[j] << 16);
      v[2 * j + 1] += __uint_as_float(rs[j] & 0xffff0000u);
    }
  }
}

template <bool RES>
__device__ __forceinline__ float sq_piece(uint4 x, uint4 r, float ss) {
  float v[8];
  piece_values<RES>(x, r, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
  return ss;
}

// y's piece: (x [+ r]) * inv * w, rounded once to bf16; stored as one
// 16-byte store (VEC) or element by element up to D.
template <bool VEC, bool RES>
__device__ __forceinline__ void store_piece(bf16* row, int i, int D, uint4 x, uint4 r, float inv,
                                            uint4 w) {
  float v[8], wv[8];
  piece_values<RES>(x, r, v);
  piece_values<false>(w, w, wv);
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 b =
        __floats2bfloat162_rn(v[2 * j] * inv * wv[2 * j], v[2 * j + 1] * inv * wv[2 * j + 1]);
    u[j] = *reinterpret_cast<const unsigned*>(&b);
  }
  if (VEC) {
    *reinterpret_cast<uint4*>(row + PIECE * i) = make_uint4(u[0], u[1], u[2], u[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = PIECE * i + j;
    if (d < D)
      *reinterpret_cast<unsigned short*>(row + d) =
          static_cast<unsigned short>(u[j / 2] >> (16 * (j % 2)));
  }
}

// PPT > 0: up to PPT pieces a thread, in registers, w in shared memory;
// PPT == 0: any number, the row (and w) read twice.  RES: the residual is
// added.  Dynamic shared memory: w's pieces, ceil(D / 8) * 16 bytes (PPT > 0).
template <int PPT, bool VEC, bool RES>
__global__ void __launch_bounds__(BF16_THREADS)
rmsnorm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                    const bf16* __restrict__ w, bf16* __restrict__ y, int rows, int D, float eps,
                    int tpr) {
  extern __shared__ __align__(16) uint4 ws[];
  __shared__ float part[BF16_THREADS / 32];
  const int t = threadIdx.x % tpr, np = (D + PIECE - 1) / PIECE;
  const int row = blockIdx.x * (BF16_THREADS / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;     // a dead row's threads still reach the barriers
  const size_t base = static_cast<size_t>(live ? row : 0) * D;
  const bf16* xr = x + base;
  const bf16* rr = RES ? res + base : nullptr;
  bf16* yr = y + base;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if constexpr (PPT > 0) {
    // w's pieces into shared memory, once a block, while the rows load
    for (int i = threadIdx.x; i < np; i += BF16_THREADS) {
      if (VEC)
        repro_torch::cp_async16(ws + i, w + PIECE * i);
      else
        ws[i] = load_piece<false>(w, i, D);
    }
    repro_torch::cp_async_commit();
    uint4 xv[PPT], rv[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = k * tpr + t;
      xv[k] = live && i < np ? load_piece<VEC>(xr, i, D) : zero;
      rv[k] = RES && live && i < np ? load_piece<VEC>(rr, i, D) : zero;
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (k * tpr + t < np) ss = sq_piece<RES>(xv[k], rv[k], ss);
    const float inv = rsqrtf(row_sum(ss, tpr, part) / static_cast<float>(D) + eps);
    repro_torch::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = k * tpr + t;
      if (live && i < np) store_piece<VEC, RES>(yr, i, D, xv[k], rv[k], inv, ws[i]);
    }
  } else {
    float ss = 0.f;
    for (int i = t; live && i < np; i += tpr)
      ss = sq_piece<RES>(load_piece<VEC>(xr, i, D), RES ? load_piece<VEC>(rr, i, D) : zero, ss);
    const float inv = rsqrtf(row_sum(ss, tpr, part) / static_cast<float>(D) + eps);
    for (int i = t; live && i < np; i += tpr)
      store_piece<VEC, RES>(yr, i, D, load_piece<VEC>(xr, i, D),
                            RES ? load_piece<VEC>(rr, i, D) : zero, inv,
                            load_piece<VEC>(w, i, D));
  }
}

template <bool VEC, bool RES>
cudaError_t launch_bf16(const bf16* x, const bf16* res, const bf16* w, bf16* y, int rows, int D,
                        float eps, cudaStream_t s) {
  const int tpr = row_threads_bf16(D), np = (D + PIECE - 1) / PIECE, ppt = (np + tpr - 1) / tpr;
  const int grid = (rows + BF16_THREADS / tpr - 1) / (BF16_THREADS / tpr);
  const size_t smem = static_cast<size_t>(np) * 16;
  if (ppt <= 1)
    rmsnorm_bf16_kernel<1, VEC, RES><<<grid, BF16_THREADS, smem, s>>>(x, res, w, y, rows, D, eps,
                                                                      tpr);
  else if (ppt <= 2)
    rmsnorm_bf16_kernel<2, VEC, RES><<<grid, BF16_THREADS, smem, s>>>(x, res, w, y, rows, D, eps,
                                                                      tpr);
  else if (ppt <= MAX_PPT)
    rmsnorm_bf16_kernel<MAX_PPT, VEC, RES><<<grid, BF16_THREADS, smem, s>>>(x, res, w, y, rows,
                                                                            D, eps, tpr);
  else
    rmsnorm_bf16_kernel<0, VEC, RES><<<grid, BF16_THREADS, 0, s>>>(x, res, w, y, rows, D, eps,
                                                                   tpr);
  return cudaGetLastError();
}

// Pieces of 8 as one load or store where D % 8 == 0 and every pointer is
// 16-byte aligned; the residual's instances apart from the plain ones.
int run_bf16(const bf16* x, const bf16* residual, const bf16* w, bf16* y, int rows, int D,
             float eps, void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(residual);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % PIECE == 0 && bits % 16 == 0;
  cudaError_t err;
  if (residual != nullptr)
    err = vec ? launch_bf16<true, true>(x, residual, w, y, rows, D, eps, s)
              : launch_bf16<false, true>(x, residual, w, y, rows, D, eps, s);
  else
    err = vec ? launch_bf16<true, false>(x, residual, w, y, rows, D, eps, s)
              : launch_bf16<false, false>(x, residual, w, y, rows, D, eps, s);
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
  return run_bf16(x, residual, w, y, rows, D, eps, stream);
}

// One launch of an empty kernel on `stream`: the floor under every wrapper's
// launch path (chip_smoke.py times it through the same ctypes call).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
