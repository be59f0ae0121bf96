// gemm: C (M, N) = A (M, K) @ B (K, N), row-major, FFMA with an fp32
// accumulator; A, B and C all fp32 (gemm_f32_*) or all bf16 (gemm_bf16_*).
//
// Replaces: src/repro/kernels/gemm.py::gemm (body _gemm_kernel), the Pallas
// MXU-tiled GEMM behind every `dense` node (`dense` pallas, ops.py:453), for
// fp32 and bf16 inputs (its dot_general takes bf16 tiles with an f32
// accumulator and writes x.dtype).
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
// bf16 (gemm_bf16_skinny, gemm_bf16_tiled): the same two kernels, templated
// on the element type.  B (and the skinny kernel's A) are staged as bf16
// (16-byte copies move 8 values; widths off 8 or unaligned pointers take
// 2-byte loads and stores) and upcast when read; the tiled kernel's A is
// upcast into its transposed fp32 tile: 8 values of a row loaded (16 bytes)
// into registers when its step is staged and stored after the current
// step's products, so the load overlaps them.  Every element is
// the fp32 kernel's FMA chain on the upcast values, rounded once to bf16 on
// store, so a row's bits still depend neither on M nor on the kernel or
// tile.  Decode reads half the weight bytes; the products still run on the
// FFMA units, not the tensor cores.
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
// batched_gemm_bf16: the same per-expert launch of the bf16 instances
// (kBatched = true, T = bf16): a row of expert e is gemm_bf16's row of
// A[e] @ B[e], the fp32 chain on the upcast values rounded once, whatever M
// is.  A decode launch reads half the fp32 weight bytes (qwen2's 738 MB
// becomes 369 MB); the products still run on the FFMA units.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- skinny --
constexpr int SK_BK = 128, SK_NST = 4, SK_THREADS = 128;

// BN columns per block; SL = 128 / BN threads share a column, thread slot q
// taking rows q, q + SL, ... (RW of them); As holds MA = SL * RW >= MT rows,
// those past M zero-filled.  T is the element type staged (fp32 or bf16).
template <int MT, int BN, typename T>
struct Skinny {
  static constexpr int SL = SK_THREADS / BN, RW = (MT + SL - 1) / SL, MA = SL * RW;
  static constexpr int SLOT = SK_BK * BN + MA * SK_BK;  // elements of one ring slot
  static constexpr size_t SMEM = sizeof(T) * SK_NST * SLOT;
};

// Block x: columns [BN x, BN x + BN) of C, all of its M <= MT rows, so each
// weight is staged once.  Slot s holds Bs [SK_BK][BN] and As [MA][SK_BK]
// (rows of A as they are stored), both of type T; VE values a 16-byte copy.
template <int MT, int BN, bool kBatched, typename T>
__global__ void __launch_bounds__(SK_THREADS)
gemm_skinny_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int M,
                   int N, int K, bool vec_a, bool vec_b) {
  using S = Skinny<MT, BN, T>;
  constexpr int VE = 16 / sizeof(T);
  if constexpr (kBatched) {  // the expert blockIdx.z
    A += (size_t)blockIdx.z * M * K;
    B += (size_t)blockIdx.z * K * N;
    C += (size_t)blockIdx.z * M * N;
  }
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  const int tid = threadIdx.x, col = tid % BN, q = tid / BN, n0 = blockIdx.x * BN;

  auto stage = [&](int t) {
    const int k0 = t * SK_BK;
    T* bsl = smem + (t % SK_NST) * S::SLOT;
    T* asl = bsl + SK_BK * BN;
    if (vec_b) {
#pragma unroll
      for (int i = 0; i < SK_BK * BN / VE / SK_THREADS; ++i) {
        const int p = tid + SK_THREADS * i, r = p / (BN / VE), c = VE * (p % (BN / VE));
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
        repro_torch::copy1(bsl + r * BN + c, ok ? B + (size_t)gk * N + gn : B, ok);
      }
    }
    if (vec_a) {
      for (int p = tid; p < S::MA * SK_BK / VE; p += SK_THREADS) {
        const int m = p / (SK_BK / VE), c = VE * (p % (SK_BK / VE));
        const bool ok = m < M && k0 + c < K;
        repro_torch::cp_async16(asl + m * SK_BK + c, ok ? A + (size_t)m * K + k0 + c : A, ok);
      }
    } else {
      for (int p = tid; p < S::MA * SK_BK; p += SK_THREADS) {
        const int m = p / SK_BK, c = p % SK_BK;
        const bool ok = m < M && k0 + c < K;
        repro_torch::copy1(asl + m * SK_BK + c, ok ? A + (size_t)m * K + k0 + c : A, ok);
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
    const T* bsl = smem + (t % SK_NST) * S::SLOT;
    const T* asl = bsl + SK_BK * BN;
#pragma unroll 8
    for (int kk = 0; kk < SK_BK; kk += 4) {
      using repro_torch::to_f32;
      const float b0 = to_f32(bsl[(kk + 0) * BN + col]), b1 = to_f32(bsl[(kk + 1) * BN + col]);
      const float b2 = to_f32(bsl[(kk + 2) * BN + col]), b3 = to_f32(bsl[(kk + 3) * BN + col]);
#pragma unroll
      for (int i = 0; i < S::RW; ++i) {
        const float4 a = repro_torch::load4f(asl + (q + S::SL * i) * SK_BK + kk);
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
      if (m < M) C[(size_t)m * N + gn] = repro_torch::from_f32<T>(acc[i]);
    }
  }
}

// ----------------------------------------------------------------- tiled --
constexpr int TL_NST = 4;

// bytes of one ring slot: As [BK][BM + 4] fp32, then Bs [BK][BN] of type T
template <int BM, int BN, int BK, typename T>
__host__ __device__ constexpr size_t tiled_slot_bytes() {
  return sizeof(float) * BK * (BM + 4) + sizeof(T) * BK * BN;
}

template <int BM, int BN, int BK, typename T>
constexpr size_t tiled_smem_bytes() {
  return TL_NST * tiled_slot_bytes<BM, BN, BK, T>();
}

// Block (x, y): C[BM y : BM y + BM, BN x : BN x + BN] by (BM / TM) x
// (BN / TN) threads.  Thread (tx, ty) owns a TM x TN micro-tile: rows
// 4ty + i + 4 TY u and columns 4tx + j + 4 TX v (i, j < 4; TY = BM / TM,
// TX = BN / TN threads along m and n), read as float4 from shared memory.
// Slot s holds As [BK][BM + 4] fp32 (A transposed; the pad spreads one m's
// 4-byte stores over 8 banks) and Bs [BK][BN] of type T.  A bf16 A is
// upcast on its way into As (no cp.async writes a 2-byte element): with
// vec_a (K % 8 == 0, A 16-byte aligned) a thread loads 8 values of a row
// into registers when the step is staged (stage) and stores them after
// the products of the step before (a_land); otherwise by plain loads and
// stores as the step is staged.
template <int BM, int BN, int TM, int TN, int BK, int MINB, bool kBatched, typename T>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
gemm_tiled_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int M,
                  int N, int K, bool vec_a, bool vec_b) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY, AS = BM + 4;
  constexpr int VE = 16 / sizeof(T);
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int APT = (BM * BK / 8 + NT - 1) / NT;  // bf16 A: 8-value pieces a thread
  if constexpr (kBatched) {  // the expert blockIdx.z
    A += (size_t)blockIdx.z * M * K;
    B += (size_t)blockIdx.z * K * N;
    C += (size_t)blockIdx.z * M * N;
  }
  constexpr int UM = TM / 4, UN = TN / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  auto as = [&](int s) {
    return reinterpret_cast<float*>(smem + (size_t)s * tiled_slot_bytes<BM, BN, BK, T>());
  };

  uint4 areg[APT];
  // bf16 A with vec_a: piece p = tid + NT i is row p / (BK / 8), k 8 (p % (BK / 8))
  auto a_land = [&](int t) {
    if constexpr (!kF32) {
      if (!vec_a) return;
      float* asl = as(t % TL_NST);
#pragma unroll
      for (int i = 0; i < APT; ++i) {
        const int p = tid + NT * i, m = p / (BK / 8), k8 = 8 * (p % (BK / 8));
        if (p >= BM * BK / 8) continue;
        const float4 lo = repro_torch::bf16x4_to_float4(make_uint2(areg[i].x, areg[i].y));
        const float4 hi = repro_torch::bf16x4_to_float4(make_uint2(areg[i].z, areg[i].w));
        const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) asl[(k8 + e) * AS + m] = v[e];
      }
    }
  };

  auto stage = [&](int t) {
    const int k0 = t * BK;
    float* asl = as(t % TL_NST);
    T* bsl = reinterpret_cast<T*>(asl + BK * AS);
    if (kF32 || !vec_a) {
      // A: consecutive threads read consecutive k of one row
#pragma unroll
      for (int i = 0; i < BM * BK / NT; ++i) {
        const int e = tid + NT * i, m = e / BK, kk = e % BK;
        const bool ok = m0 + m < M && k0 + kk < K;
        if constexpr (kF32)
          repro_torch::cp_async4(asl + kk * AS + m,
                                 ok ? A + (size_t)(m0 + m) * K + k0 + kk : A, ok);
        else
          asl[kk * AS + m] = ok ? repro_torch::to_f32(A[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < APT; ++i) {
        const int p = tid + NT * i, m = p / (BK / 8), k8 = 8 * (p % (BK / 8));
        const bool ok = p < BM * BK / 8 && m0 + m < M && k0 + k8 < K;
        areg[i] = ok ? *reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + k0 + k8)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (vec_b) {
#pragma unroll
      for (int i = 0; i < BK * BN / VE / NT; ++i) {
        const int p = tid + NT * i, r = p / (BN / VE), c = VE * (p % (BN / VE));
        const bool ok = k0 + r < K && n0 + c < N;
        repro_torch::cp_async16(bsl + r * BN + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B,
                                ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * BN / NT; ++i) {
        const int p = tid + NT * i, r = p / BN, c = p % BN;
        const bool ok = k0 + r < K && n0 + c < N;
        repro_torch::copy1(bsl + r * BN + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
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
    if (s < n_steps) {
      stage(s);
      a_land(s);
    }
    repro_torch::cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    repro_torch::cp_async_wait<TL_NST - 2>();
    __syncthreads();  // step t is visible, and every thread is done with step t - 1's slot
    const bool ahead = t + TL_NST - 1 < n_steps;
    if (ahead) stage(t + TL_NST - 1);
    repro_torch::cp_async_commit();
    const float* asl = as(t % TL_NST);
    const T* bsl = reinterpret_cast<const T*>(asl + BK * AS);
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
        const float4 v = repro_torch::load4f(bsl + kk * BN + 4 * TX * u + 4 * tx);
        b[4 * u] = v.x, b[4 * u + 1] = v.y, b[4 * u + 2] = v.z, b[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (ahead) a_land(t + TL_NST - 1);  // its slot was step t - 1's: free since the barrier
  }
  repro_torch::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + 4 * TY * (i / 4) + 4 * ty + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + 4 * TX * (j / 4) + 4 * tx + j % 4;
      if (gn < N) C[(size_t)gm * N + gn] = repro_torch::from_f32<T>(acc[i][j]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// E > 1 only with kBatched (grid z = E).  16-byte copies of A and B where
// K and N are multiples of their 4 (fp32) or 8 (bf16) values and the
// pointers are 16-byte aligned.
template <int MT, int BN, bool kBatched, typename T>
int launch_skinny(const T* a, const T* b, T* c, int E, int M, int N, int K,
                  cudaStream_t stream) {
  constexpr size_t smem = Skinny<MT, BN, T>::SMEM;
  constexpr int ve = 16 / sizeof(T);
  auto kernel = gemm_skinny_kernel<MT, BN, kBatched, T>;
  static int smem_set[repro_torch::kMaxDevices];
  const cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + BN - 1) / BN, 1, E), SK_THREADS, smem, stream>>>(
      a, b, c, M, N, K, K % ve == 0 && aligned16(a), N % ve == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int TN, int BK, int MINB, bool kBatched, typename T>
int launch_tiled(const T* a, const T* b, T* c, int E, int M, int N, int K,
                 cudaStream_t stream) {
  constexpr size_t smem = tiled_smem_bytes<BM, BN, BK, T>();
  constexpr int ve = 16 / sizeof(T);
  auto kernel = gemm_tiled_kernel<BM, BN, TM, TN, BK, MINB, kBatched, T>;
  static int smem_set[repro_torch::kMaxDevices];
  const cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((M + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  kernel<<<grid, (BM / TM) * (BN / TN), smem, stream>>>(
      a, b, c, M, N, K, K % 8 == 0 && aligned16(a), N % ve == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool kBatched, typename T>
int skinny_rows(const T* a, const T* b, T* c, int E, int M, int N, int K, cudaStream_t st) {
  if (M <= 4) return launch_skinny<4, BN, kBatched>(a, b, c, E, M, N, K, st);
  if (M <= 8) return launch_skinny<8, BN, kBatched>(a, b, c, E, M, N, K, st);
  return launch_skinny<16, BN, kBatched>(a, b, c, E, M, N, K, st);
}

// M <= 16 (the wrapper's SKINNY_MAX_M).  16-column strips up to N = 2048
// (twice the blocks where 32-column ones leave SMs idle), 32 above.
template <bool kBatched, typename T>
int skinny(const T* a, const T* b, T* c, int E, int M, int N, int K, cudaStream_t st) {
  if (M < 1 || M > 16) return static_cast<int>(cudaErrorInvalidValue);
  return N <= 2048 ? skinny_rows<16, kBatched>(a, b, c, E, M, N, K, st)
                   : skinny_rows<32, kBatched>(a, b, c, E, M, N, K, st);
}

// M > 16; the tile (bm, bn) is 128x128 or 32x64 (the wrapper's gemm_tile).
template <bool kBatched, typename T>
int tiled(const T* a, const T* b, T* c, int E, int M, int N, int K, int bm, int bn,
          cudaStream_t st) {
  if (bm == 128 && bn == 128)
    return launch_tiled<128, 128, 8, 8, 16, 1, kBatched>(a, b, c, E, M, N, K, st);
  if (bm == 32 && bn == 64)
    return launch_tiled<32, 64, 4, 4, 16, 4, kBatched>(a, b, c, E, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a (E, M, K), b (E, K, N), c (E, M, N), each contiguous; E <= 65535.  M <=
// 16 runs the skinny kernel, M > 16 the tiled one with the tile (bm, bn).
template <typename T>
int batched(const T* a, const T* b, T* c, int E, int M, int N, int K, int bm, int bn,
            cudaStream_t st) {
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return M <= 16 ? skinny<true>(a, b, c, E, M, N, K, st)
                 : tiled<true>(a, b, c, E, M, N, K, bm, bn, st);
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

// bf16 a, b and c; the fp32 entries' kernels, variant and tiles.
extern "C" int gemm_bf16_skinny(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                __nv_bfloat16* c, int M, int N, int K, void* stream) {
  return skinny<false>(a, b, c, 1, M, N, K, static_cast<cudaStream_t>(stream));
}

extern "C" int gemm_bf16_tiled(const __nv_bfloat16* a, const __nv_bfloat16* b,
                               __nv_bfloat16* c, int M, int N, int K, int bm, int bn,
                               void* stream) {
  return tiled<false>(a, b, c, 1, M, N, K, bm, bn, static_cast<cudaStream_t>(stream));
}

// The batched product (batched above) on fp32 or bf16 operands.
extern "C" int batched_gemm_f32(const float* a, const float* b, float* c, int E, int M, int N,
                                int K, int bm, int bn, void* stream) {
  return batched(a, b, c, E, M, N, K, bm, bn, static_cast<cudaStream_t>(stream));
}

// bf16 a, b and c; batched_gemm_f32's kernels, variant and tiles.
extern "C" int batched_gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                 __nv_bfloat16* c, int E, int M, int N, int K, int bm, int bn,
                                 void* stream) {
  return batched(a, b, c, E, M, N, K, bm, bn, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
