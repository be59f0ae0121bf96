// gemm: C (M, N) = A (M, K) @ B (K, N), row-major: fp32 operands on FFMA
// (gemm_f32_*), bf16 ones on the tensor cores (gemm_bf16, below).
//
// Replaces: src/repro/kernels/gemm.py::gemm (body _gemm_kernel), the Pallas
// MXU-tiled GEMM behind every `dense` node (`dense` pallas, ops.py:453).
//
// What bounds it on the H100: at decode (M = 1..16) the product reads each
// weight once and does 2*M flops per 4-byte weight, far below the fp32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20 flop/byte), so it is bound by bytes; at
// prefill (M = 256) it does 128 flop/byte and is bound by fp32 FFMA issue.
//
// Two kernels, chosen by the wrapper from M (gemm.py SKINNY_MAX_M):
// - gemm_f32_skinny, M <= 16: a 128-thread block per 32-column strip of B
//   (16-column strips for N <= 2048, so a small N still covers the SMs):
//   thread (column, slot) keeps its rows' accumulators in registers, and
//   B and A stream through a 4-slot ring of 128-deep K steps with 16-byte
//   cp.async copies (48 KB of B in flight per block at 32 columns).  Each
//   weight byte is read by exactly one block: N = 3072 gives 96 blocks,
//   N = 262144 gives 8192.
// - gemm_f32_tiled, M > 16: 128x128 output tiles on 256 threads with an
//   8x8 micro-tile per thread where M >= 128 and that gives about one block
//   per SM, else 32x64 tiles on 128 threads with a 4x4 micro-tile (gemm.py
//   gemm_tile); float4 reads from shared memory, a 4-slot cp.async ring of
//   16-deep K steps (A stored transposed by 4-byte copies, B by 16-byte
//   ones).
// In both, every output element is one FMA chain over k = 0..K-1 from 0
// (the steps past K are zero-filled and add fma(0, 0, acc) = acc), with no
// split-K: a row of C is bit-identical whatever M is and whichever kernel
// or tile ran it, so the serving engine's batch-4 product equals its
// batch-1 reference.  Ragged M, N and K edges are zero-filled; widths that
// are not a multiple of 4, or unaligned pointers, take 4-byte copies.
// Known limits: without split-K a small N with a long K (gemma3-1b's down
// projection, N = 1152, K = 6912) leaves SMs idle, and the tiled kernel
// reaches about half the fp32 FFMA peak.
//
// batched_gemm: C[e] (M, N) = A[e] (M, K) @ B[e] (K, N) for e < E.  Replaces
// src/repro/kernels/gemm.py::batched_gemm (the Pallas grid (E, M/bm, N/bn,
// K/bk), behind `moe_gemm` pallas, ops.py:386).  The MoE layer folds the
// decode batch into M (one (E, B*cap, d) launch per projection), reading
// each expert's weights once per step: at qwen2's decode (E = 64, M = 32,
// 2048 -> 1408) a launch reads 738 MB of weights at 2*M flops per 4-byte
// weight, near both bounds; at a 1024-token prefill (M = 80) FFMA issue
// bounds it.  It runs the two kernels above per expert, the expert as
// blockIdx.z (the same M <= 16 / M > 16 split and tiles), each an instance
// with kBatched = true: only those offset A, B and C by the expert, so
// gemm_f32's instances are the code they were (offsetting its __restrict__
// pointers always cost the single GEMM 20%).  Every element is the same one
// FMA chain, so a row of expert e is bitwise the same whatever M, kernel or
// tile, and equal to gemm_f32's row of the product A[e] @ B[e].
//
// bf16 (gemm_bf16, batched_gemm_bf16): one tensor-core body, wgmma.
// Replaces the same two Pallas kernels for bf16 operands, whose body is a
// dot_general on bf16 tiles with an f32 accumulator and one cast on store:
// A, B and C bf16, the sum fp32 in registers, each output rounded once to
// bf16.  On the tensor cores (989 TFLOP/s dense bf16, 15x the FFMA rate) a
// prefill product is bound by operations only where it has more than ~295
// flops a byte; decode (M <= 64 rows against every weight) is bound by the
// weight bytes, half the fp32 entry's.
// - Block (x, y, z): C[z][64 NWG y : +64 NWG, BN x : +BN], NWG = 1 or 2
//   consumer warpgroups of 64 rows each, BN = 64 or 128 (the wrapper's
//   gemm_bf16_plan, from M, N and the expert count alone), plus one
//   producer warpgroup.  K runs through a ring of WG_NST stages of WG_BK =
//   64: A [64 NWG][64] K-major and B as the weights are stored, (K, N)
//   row-major, as BN / 64 panels of [64 k][64 n] (N-major: wgmma reads it
//   through its transposed-B descriptor; no weight is copied or
//   transposed).  Both are in wgmma's 128-byte swizzle (16-byte chunk c
//   of a 128-byte row r at chunk c ^ (r % 8)), stage bases 1024-aligned.
// - Staging: with K and N multiples of 8 and A, B 16-byte aligned (TMA's
//   stride rule), one producer thread issues 3-D TMA loads (the expert is
//   the third coordinate; ragged M, N, K zero-filled by TMA) that complete
//   on the stage's full mbarrier; otherwise the producer warpgroup's 128
//   threads load element by element into the same swizzled layout, fence
//   the async proxy and arrive.  Consumers release a stage on its empty
//   mbarrier once the wgmma group that read it has retired (wait_group 1).
//   The tensor maps are encoded on the host at every launch
//   (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint).
// - One K order for every row: each output element is the same chain of
//   wgmma.m64n64k16 instructions (one instruction shape in every plan: a
//   128-wide tile issues two of them over the same A) over 16-deep chunks
//   of K from 0 upward, into an fp32 accumulator that starts at 0; the
//   chunks past K are zero (each adds 0 to the sum).  No split-K, and no
//   plan reads anything but M, N and the expert count, so a row's bits
//   depend neither on M, nor on the plan, nor on which of the two kernels
//   ran it; decode rows (M <= 16) run the same instruction with the rows
//   past M zero.  A bf16 result is not the fp32 entry's result rounded:
//   the tensor core sums each 16-deep chunk in its own order.
// - Decode shapes take 64x64 tiles, so N / 64 blocks a product (gemma3-1b's
//   head: 4096; qwen2's experts: 22 x 64) stream the weights once each.
#include <cuda.h>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------- skinny --
constexpr int SK_BK = 128, SK_NST = 4, SK_THREADS = 128;

// BN columns per block; SL = 128 / BN threads share a column, thread slot q
// taking rows q, q + SL, ... (RW of them); As holds MA = SL * RW >= MT rows,
// those past M zero-filled.
template <int MT, int BN>
struct Skinny {
  static constexpr int SL = SK_THREADS / BN, RW = (MT + SL - 1) / SL, MA = SL * RW;
  static constexpr int SLOT = SK_BK * BN + MA * SK_BK;  // floats of one ring slot
  static constexpr size_t SMEM = sizeof(float) * SK_NST * SLOT;
};

// Block x: columns [BN x, BN x + BN) of C, all of its M <= MT rows, so each
// weight is staged once.  Slot s holds Bs [SK_BK][BN] and As [MA][SK_BK]
// (rows of A as they are stored).
template <int MT, int BN, bool kBatched>
__global__ void __launch_bounds__(SK_THREADS)
gemm_skinny_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, bool vec_a, bool vec_b) {
  using S = Skinny<MT, BN>;
  if constexpr (kBatched) {  // the expert blockIdx.z
    A += (size_t)blockIdx.z * M * K;
    B += (size_t)blockIdx.z * K * N;
    C += (size_t)blockIdx.z * M * N;
  }
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, col = tid % BN, q = tid / BN, n0 = blockIdx.x * BN;

  auto stage = [&](int t) {
    const int k0 = t * SK_BK;
    float* bsl = smem + (t % SK_NST) * S::SLOT;
    float* asl = bsl + SK_BK * BN;
    if (vec_b) {
#pragma unroll
      for (int i = 0; i < SK_BK * BN / 4 / SK_THREADS; ++i) {
        const int p = tid + SK_THREADS * i, r = p / (BN / 4), c = 4 * (p % (BN / 4));
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = gk < K && gn < N;
        repro_torch::cp_async16(bsl + r * BN + c, ok ? B + (size_t)gk * N + gn : B, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < SK_BK * BN / SK_THREADS; ++i) {
        const int p = tid + SK_THREADS * i, r = p / BN, c = p % BN;
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = gk < K && gn < N;
        repro_torch::cp_async4(bsl + r * BN + c, ok ? B + (size_t)gk * N + gn : B, ok);
      }
    }
    if (vec_a) {
      for (int p = tid; p < S::MA * SK_BK / 4; p += SK_THREADS) {
        const int m = p / (SK_BK / 4), c = 4 * (p % (SK_BK / 4));
        const bool ok = m < M && k0 + c < K;
        repro_torch::cp_async16(asl + m * SK_BK + c, ok ? A + (size_t)m * K + k0 + c : A, ok);
      }
    } else {
      for (int p = tid; p < S::MA * SK_BK; p += SK_THREADS) {
        const int m = p / SK_BK, c = p % SK_BK;
        const bool ok = m < M && k0 + c < K;
        repro_torch::cp_async4(asl + m * SK_BK + c, ok ? A + (size_t)m * K + k0 + c : A, ok);
      }
    }
  };

  float acc[S::RW];
#pragma unroll
  for (int i = 0; i < S::RW; ++i) acc[i] = 0.f;

  const int n_steps = (K + SK_BK - 1) / SK_BK;
#pragma unroll
  for (int s = 0; s < SK_NST - 1; ++s) {
    if (s < n_steps) stage(s);
    repro_torch::cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    repro_torch::cp_async_wait<SK_NST - 2>();
    __syncthreads();  // step t is visible, and every thread is done with step t - 1's slot
    if (t + SK_NST - 1 < n_steps) stage(t + SK_NST - 1);
    repro_torch::cp_async_commit();
    const float* bsl = smem + (t % SK_NST) * S::SLOT;
    const float* asl = bsl + SK_BK * BN;
#pragma unroll 8
    for (int kk = 0; kk < SK_BK; kk += 4) {
      const float b0 = bsl[(kk + 0) * BN + col], b1 = bsl[(kk + 1) * BN + col];
      const float b2 = bsl[(kk + 2) * BN + col], b3 = bsl[(kk + 3) * BN + col];
#pragma unroll
      for (int i = 0; i < S::RW; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(asl + (q + S::SL * i) * SK_BK + kk);
        acc[i] = fmaf(a.x, b0, acc[i]);
        acc[i] = fmaf(a.y, b1, acc[i]);
        acc[i] = fmaf(a.z, b2, acc[i]);
        acc[i] = fmaf(a.w, b3, acc[i]);
      }
    }
  }
  repro_torch::cp_async_wait<0>();

  const int gn = n0 + col;
  if (gn < N) {
#pragma unroll
    for (int i = 0; i < S::RW; ++i) {
      const int m = q + S::SL * i;
      if (m < M) C[(size_t)m * N + gn] = acc[i];
    }
  }
}

// ----------------------------------------------------------------- tiled --
constexpr int TL_NST = 4;

template <int BM, int BN, int BK>
constexpr size_t tiled_smem_bytes() {
  return sizeof(float) * TL_NST * ((size_t)BK * (BM + 4) + (size_t)BK * BN);
}

// Block (x, y): C[BM y : BM y + BM, BN x : BN x + BN] by (BM / TM) x
// (BN / TN) threads.  Thread (tx, ty) owns a TM x TN micro-tile: rows
// 4ty + i + 4 TY u and columns 4tx + j + 4 TX v (i, j < 4; TY = BM / TM,
// TX = BN / TN threads along m and n), read as float4 from shared memory.
// Slot s holds As [BK][BM + 4] (A transposed; the pad spreads one m's
// 4-byte stores over 8 banks) and Bs [BK][BN].
template <int BM, int BN, int TM, int TN, int BK, int MINB, bool kBatched>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
gemm_tiled_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, bool vec_b) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY, AS = BM + 4;
  if constexpr (kBatched) {  // the expert blockIdx.z
    A += (size_t)blockIdx.z * M * K;
    B += (size_t)blockIdx.z * K * N;
    C += (size_t)blockIdx.z * M * N;
  }
  constexpr int UM = TM / 4, UN = TN / 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  auto as = [&](int s) { return smem + (size_t)s * (BK * AS + BK * BN); };

  auto stage = [&](int t) {
    const int k0 = t * BK;
    float* asl = as(t % TL_NST);
    float* bsl = asl + BK * AS;
    // A: consecutive threads read consecutive k of one row
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int e = tid + NT * i, m = e / BK, kk = e % BK;
      const bool ok = m0 + m < M && k0 + kk < K;
      repro_torch::cp_async4(asl + kk * AS + m, ok ? A + (size_t)(m0 + m) * K + k0 + kk : A, ok);
    }
    if (vec_b) {
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / NT; ++i) {
        const int p = tid + NT * i, r = p / (BN / 4), c = 4 * (p % (BN / 4));
        const bool ok = k0 + r < K && n0 + c < N;
        repro_torch::cp_async16(bsl + r * BN + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B,
                                ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * BN / NT; ++i) {
        const int p = tid + NT * i, r = p / BN, c = p % BN;
        const bool ok = k0 + r < K && n0 + c < N;
        repro_torch::cp_async4(bsl + r * BN + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_steps = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < TL_NST - 1; ++s) {
    if (s < n_steps) stage(s);
    repro_torch::cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    repro_torch::cp_async_wait<TL_NST - 2>();
    __syncthreads();  // step t is visible, and every thread is done with step t - 1's slot
    if (t + TL_NST - 1 < n_steps) stage(t + TL_NST - 1);
    repro_torch::cp_async_commit();
    const float* asl = as(t % TL_NST);
    const float* bsl = asl + BK * AS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(asl + kk * AS + 4 * TY * u + 4 * ty);
        a[4 * u] = v.x, a[4 * u + 1] = v.y, a[4 * u + 2] = v.z, a[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(bsl + kk * BN + 4 * TX * u + 4 * tx);
        b[4 * u] = v.x, b[4 * u + 1] = v.y, b[4 * u + 2] = v.z, b[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  repro_torch::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + 4 * TY * (i / 4) + 4 * ty + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + 4 * TX * (j / 4) + 4 * tx + j % 4;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// E > 1 only with kBatched (grid z = E).
template <int MT, int BN, bool kBatched>
int launch_skinny(const float* a, const float* b, float* c, int E, int M, int N, int K,
                  cudaStream_t stream) {
  constexpr size_t smem = Skinny<MT, BN>::SMEM;
  auto kernel = gemm_skinny_kernel<MT, BN, kBatched>;
  static int smem_set[repro_torch::kMaxDevices];
  const cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + BN - 1) / BN, 1, E), SK_THREADS, smem, stream>>>(
      a, b, c, M, N, K, K % 4 == 0 && aligned16(a), N % 4 == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int TN, int BK, int MINB, bool kBatched>
int launch_tiled(const float* a, const float* b, float* c, int E, int M, int N, int K,
                 cudaStream_t stream) {
  constexpr size_t smem = tiled_smem_bytes<BM, BN, BK>();
  auto kernel = gemm_tiled_kernel<BM, BN, TM, TN, BK, MINB, kBatched>;
  static int smem_set[repro_torch::kMaxDevices];
  const cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((M + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  kernel<<<grid, (BM / TM) * (BN / TN), smem, stream>>>(a, b, c, M, N, K,
                                                       N % 4 == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool kBatched>
int skinny_rows(const float* a, const float* b, float* c, int E, int M, int N, int K,
                cudaStream_t st) {
  if (M <= 4) return launch_skinny<4, BN, kBatched>(a, b, c, E, M, N, K, st);
  if (M <= 8) return launch_skinny<8, BN, kBatched>(a, b, c, E, M, N, K, st);
  return launch_skinny<16, BN, kBatched>(a, b, c, E, M, N, K, st);
}

// M <= 16 (the wrapper's SKINNY_MAX_M).  16-column strips up to N = 2048
// (twice the blocks where 32-column ones leave SMs idle), 32 above.
template <bool kBatched>
int skinny(const float* a, const float* b, float* c, int E, int M, int N, int K,
           cudaStream_t st) {
  if (M < 1 || M > 16) return static_cast<int>(cudaErrorInvalidValue);
  return N <= 2048 ? skinny_rows<16, kBatched>(a, b, c, E, M, N, K, st)
                   : skinny_rows<32, kBatched>(a, b, c, E, M, N, K, st);
}

// M > 16; the tile (bm, bn) is 128x128 or 32x64 (the wrapper's gemm_tile).
template <bool kBatched>
int tiled(const float* a, const float* b, float* c, int E, int M, int N, int K, int bm, int bn,
          cudaStream_t st) {
  if (bm == 128 && bn == 128)
    return launch_tiled<128, 128, 8, 8, 16, 1, kBatched>(a, b, c, E, M, N, K, st);
  if (bm == 32 && bn == 64)
    return launch_tiled<32, 64, 4, 4, 16, 4, kBatched>(a, b, c, E, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ----------------------------------------------------------- bf16, wgmma --
using repro_torch::bf16;
using namespace repro_torch::hopper;

constexpr int WG_BK = 64;        // K depth of a ring stage: four k16 instructions
constexpr int WG_NST = 4;        // ring stages
constexpr int WG_THREADS = 128;  // a warpgroup
constexpr int WG_PANEL = WG_BK * 64 * 2;  // bytes of a [64][64] bf16 panel

// NWG consumer warpgroups of 64 rows, BN columns (BN / 64 panels of B).
template <int NWG, int BN>
struct Wg {
  static constexpr int BM = 64 * NWG, NJ = BN / 64;
  static constexpr int A_BYTES = BM * WG_BK * 2, STAGE = A_BYTES + NJ * WG_PANEL;
  static constexpr int THREADS = (NWG + 1) * WG_THREADS;
  // the ring, its 2 * WG_NST mbarriers, and the slack to align it to 1024
  static constexpr size_t SMEM = 1024 + (size_t)WG_NST * STAGE + 16 * WG_NST;
};

// Warpgroup 0 stages, warpgroups 1..NWG multiply (header).  A (E, M, K), B
// (E, K, N), C (E, M, N); with `tma` the tensor maps describe A and B,
// else they are unused and the producer reads A and B itself.
template <int NWG, int BN>
__global__ void __launch_bounds__(Wg<NWG, BN>::THREADS)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ A,
                  const bf16* __restrict__ B, bf16* __restrict__ C, int M, int N, int K,
                  int tma) {
  using W = Wg<NWG, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // the ring, as a generic pointer
  const uint32_t bars = base + WG_NST * W::STAGE;        // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WG_NST + s); };
  auto a_at = [&](int s) { return static_cast<uint32_t>(s * W::STAGE); };
  auto b_at = [&](int s) { return static_cast<uint32_t>(s * W::STAGE + W::A_BYTES); };
  const int e = blockIdx.z, m0 = blockIdx.y * W::BM, n0 = blockIdx.x * BN;
  const int n_steps = (K + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_NST; ++s) {
      mbar_init(full(s), tma ? 1 : WG_THREADS);
      mbar_init(empty(s), NWG * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer --
    if (tma) {
      if (tid != 0) return;
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % WG_NST;
        if (t >= WG_NST) mbar_wait(empty(s), ((t / WG_NST) - 1) & 1);
        mbar_expect_tx(full(s), W::STAGE);
        tma_load_3d(base + a_at(s), &map_a, full(s), t * WG_BK, m0, e);
#pragma unroll
        for (int j = 0; j < W::NJ; ++j)
          tma_load_3d(base + b_at(s) + j * WG_PANEL, &map_b, full(s), n0 + 64 * j, t * WG_BK, e);
      }
      return;
    }
    const unsigned short* a = reinterpret_cast<const unsigned short*>(A) + (size_t)e * M * K;
    const unsigned short* b = reinterpret_cast<const unsigned short*>(B) + (size_t)e * K * N;
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % WG_NST, k0 = t * WG_BK;
      if (t >= WG_NST) mbar_wait(empty(s), ((t / WG_NST) - 1) & 1);
      for (int i = tid; i < W::BM * WG_BK; i += WG_THREADS) {
        const int r = i / WG_BK, c = i % WG_BK, gm = m0 + r, gk = k0 + c;
        *reinterpret_cast<unsigned short*>(gbase + a_at(s) + swz128(128 * r + 2 * c)) =
            gm < M && gk < K ? a[(size_t)gm * K + gk] : static_cast<unsigned short>(0);
      }
      for (int i = tid; i < WG_BK * BN; i += WG_THREADS) {
        const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
        *reinterpret_cast<unsigned short*>(gbase + b_at(s) + (c / 64) * WG_PANEL +
                                           swz128(128 * r + 2 * (c % 64))) =
            gk < K && gn < N ? b[(size_t)gk * N + gn] : static_cast<unsigned short>(0);
      }
      fence_proxy_async();  // visible to wgmma
      mbar_arrive(full(s));
    }
    return;
  }

  // ------------------------------------------------------------ consumers --
  const int cw = wg - 1;  // rows [64 cw, 64 cw + 64) of the tile
  float acc[W::NJ][32];
#pragma unroll
  for (int j = 0; j < W::NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    fence_regs(acc[j]);
  }
  for (int t = 0; t < n_steps; ++t) {
    const int s = t % WG_NST;
    mbar_wait(full(s), (t / WG_NST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: rows of 128 bytes, 8-row groups 1024 apart, k16 = 32 bytes on;
      // B: k rows of 128 bytes, 8-row groups 1024 apart, panels WG_PANEL
      // apart, k16 = 16 rows on
      const uint64_t da = smem_desc(base + a_at(s) + 64 * 128 * cw + 32 * kk, 16, 1024);
#pragma unroll
      for (int j = 0; j < W::NJ; ++j)
        wgmma_m64n64k16<1>(acc[j], da,
                        smem_desc(base + b_at(s) + j * WG_PANEL + 2048 * kk, WG_PANEL, 1024));
    }
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < W::NJ; ++j) fence_regs(acc[j]);
    // the group of step t - 1 has retired: its stage may be refilled
    wgmma_wait<1>();
    if (t > 0) mbar_arrive(empty((t - 1) % WG_NST));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < W::NJ; ++j) fence_regs(acc[j]);

  // accumulator fragment: warp w, lane l holds, for pair p < 16 of panel j,
  // row 16 w + l / 4 + 8 (p % 2), columns 64 j + 8 (p / 2) + 2 (l % 4) + {0, 1}
  bf16* c = C + (size_t)e * M * N;
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < W::NJ; ++j) {
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int row = m0 + 64 * cw + 16 * warp + lane / 4 + 8 * (p % 2);
      const int col = n0 + 64 * j + 8 * (p / 2) + 2 * (lane % 4);
      if (row >= M || col >= N) continue;
      bf16* dst = c + (size_t)row * N + col;
      if (col + 1 < N && N % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[j][2 * p], acc[j][2 * p + 1]);
      } else {
        dst[0] = __float2bfloat16_rn(acc[j][2 * p]);
        if (col + 1 < N) dst[1] = __float2bfloat16_rn(acc[j][2 * p + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once (no -lcuda); null if absent
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D bf16 tensor (E, rows, inner), inner contiguous, read in boxes of
// (1, box_rows, 64) under the 128-byte swizzle; out of bounds reads zero.
bool encode_map(CUtensorMap* map, const bf16* ptr, int inner, int rows, int E, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {2ull * inner, 2ull * inner * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1}, step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int BN>
int launch_wgmma(const bf16* a, const bf16* b, bf16* c, int E, int M, int N, int K,
                 cudaStream_t stream) {
  using W = Wg<NWG, BN>;
  auto kernel = gemm_wgmma_kernel<NWG, BN>;
  static int smem_set[repro_torch::kMaxDevices];
  const cudaError_t err = repro_torch::allow_smem(kernel, W::SMEM, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((M + W::BM - 1) / W::BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a{}, map_b{};
  // TMA's rule: global strides multiples of 16 bytes, the base 16-byte aligned
  const bool tma = K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(b);
  if (tma && !(encode_map(&map_a, a, K, M, E, W::BM) && encode_map(&map_b, b, N, K, E, WG_BK)))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3((N + BN - 1) / BN, (M + W::BM - 1) / W::BM, E), W::THREADS, W::SMEM, stream>>>(
      map_a, map_b, a, b, c, M, N, K, tma ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// a (E, M, K), b (E, K, N), c (E, M, N), each contiguous; the plan (bm, bn)
// is 64x64 or 128x128 (the wrapper's gemm_bf16_plan).
int wgmma(const bf16* a, const bf16* b, bf16* c, int E, int M, int N, int K, int bm, int bn,
          cudaStream_t st) {
  if (E < 1 || E > 65535 || M < 1 || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 64 && bn == 64) return launch_wgmma<1, 64>(a, b, c, E, M, N, K, st);
  if (bm == 128 && bn == 128) return launch_wgmma<2, 128>(a, b, c, E, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int gemm_f32_skinny(const float* a, const float* b, float* c, int M, int N, int K,
                               void* stream) {
  return skinny<false>(a, b, c, 1, M, N, K, static_cast<cudaStream_t>(stream));
}

extern "C" int gemm_f32_tiled(const float* a, const float* b, float* c, int M, int N, int K,
                              int bm, int bn, void* stream) {
  return tiled<false>(a, b, c, 1, M, N, K, bm, bn, static_cast<cudaStream_t>(stream));
}

// a (E, M, K), b (E, K, N), c (E, M, N), each contiguous; E <= 65535.  M <=
// 16 runs the skinny kernel, M > 16 the tiled one with the tile (bm, bn).
extern "C" int batched_gemm_f32(const float* a, const float* b, float* c, int E, int M, int N,
                                int K, int bm, int bn, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return M <= 16 ? skinny<true>(a, b, c, E, M, N, K, st)
                 : tiled<true>(a, b, c, E, M, N, K, bm, bn, st);
}

// bf16 a, b and c (M, K) @ (K, N) on the tensor cores with the plan (bm, bn).
extern "C" int gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c,
                         int M, int N, int K, int bm, int bn, void* stream) {
  return wgmma(a, b, c, 1, M, N, K, bm, bn, static_cast<cudaStream_t>(stream));
}

// bf16 a (E, M, K), b (E, K, N), c (E, M, N): gemm_bf16's body per expert
// (blockIdx.z), so expert e's row is gemm_bf16's row of a[e] @ b[e].
extern "C" int batched_gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                 __nv_bfloat16* c, int E, int M, int N, int K, int bm, int bn,
                                 void* stream) {
  return wgmma(a, b, c, E, M, N, K, bm, bn, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
