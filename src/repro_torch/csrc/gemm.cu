// gemm: C (M, N) = A (M, K) @ B (K, N), fp32, row-major, FFMA.
//
// Replaces: src/repro/kernels/gemm.py::gemm (body _gemm_kernel), the Pallas
// MXU-tiled GEMM behind every `dense` node (`dense` pallas, ops.py:453).
//
// What bounds it on the H100: at decode (M = 1..4) the product reads each
// weight once and does 2*M flops per 4-byte weight, far below the fp32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20 flop/byte), so it is bound by bytes; at
// prefill (M = 256) it does 128 flop/byte and is bound by fp32 FFMA issue.
//
// Design: one fixed 64x64 output tile per 256-thread block, a 16-deep K step
// staged in shared memory (double-buffered, next step prefetched into
// registers during the current one), and a 4x4 micro-tile per thread.  At
// M <= 64 the grid is one row of blocks and every weight byte is read by
// exactly one block, so the bytes-bound decode case streams W once.  The
// tile, the K step and the K order never depend on M: each output element
// is one FMA chain over k = 0..K-1, so a row of C is bit-identical whatever
// other rows share its launch (the serving engine's batch-4 product equals
// its batch-1 reference).
// Ragged M, N and K edges are masked with zero fill.
//
// batched_gemm: C[e] (M, N) = A[e] (M, K) @ B[e] (K, N) for e < E, the expert
// as blockIdx.z.  Replaces src/repro/kernels/gemm.py::batched_gemm (the
// Pallas grid (E, M/bm, N/bn, K/bk), behind `moe_gemm` pallas, ops.py:386).
// The same body with per-expert strides, so a row of expert e's output is
// the same FMA chain as in gemm_f32 and bitwise independent of M: the MoE
// layer folds the decode batch into M (one (E, B*cap, d) launch per
// projection), reading each expert's weights once per step.  At qwen2's
// decode (E = 64, M = 32, 2048 -> 1408) the launch reads 738 MB of weights
// at 2*M flops per 4-byte weight: bound by bytes; at a 1024-token prefill
// (M = 80) by FFMA issue.
//
// Known limits of both: at M <= 64 gemm_f32's grid has only ceil(N/64)
// blocks (48 for N = 3072, fewer than the 132 SMs), and FFMA from shared
// memory reaches a fraction of the fp32 peak; wgmma/TMA and split-K with a
// fixed split are later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int TM = 4, TN = 4;  // micro-tile per thread: rows ty+16i, cols tx+16j

// kBatched: the expert is blockIdx.z, its operands `stride_*` floats apart.
// The offsets go into the indices, and gemm_f32's instance has none: moving
// the __restrict__ pointers themselves made the plain GEMM a fifth slower
// on the H100.
template <bool kBatched>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K, size_t stride_a, size_t stride_b,
            size_t stride_c) {
  // A is stored transposed ([k][m]) so the inner loop reads a column of the
  // tile with a broadcast; +4 pads the rows against bank conflicts on store.
  __shared__ float As[2][BK][BM + 4];
  __shared__ float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int b_row = tid / BN, b_col = tid % BN;
  const size_t a0 = kBatched ? blockIdx.z * stride_a : 0;
  const size_t b0 = kBatched ? blockIdx.z * stride_b : 0;
  const size_t c0 = kBatched ? blockIdx.z * stride_c : 0;

  float a_reg[4], b_reg[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i, gk = k0 + tx;
      a_reg[i] = (gm < M && gk < K) ? A[a0 + (size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + b_row + 4 * i, gn = n0 + b_col;
      b_reg[i] = (gk < K && gn < N) ? B[b0 + (size_t)gk * N + gn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][tx][ty + 16 * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[buf][b_row + 4 * i][b_col] = b_reg[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_steps = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_steps) load((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[cur][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[cur][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // buffer cur^1 was last read before the barrier that ended step t-1
    if (t + 1 < n_steps) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[c0 + (size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int gemm_f32(const float* a, const float* b, float* c, int M, int N,
                        int K, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, M, N,
                                                                               K, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// a (E, M, K), b (E, K, N), c (E, M, N), each contiguous; E <= 65535.
extern "C" int batched_gemm_f32(const float* a, const float* b, float* c, int E, int M,
                                int N, int K, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  gemm_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, N, K, (size_t)M * K, (size_t)K * N, (size_t)M * N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
