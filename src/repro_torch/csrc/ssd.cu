// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan, fp32, FFMA;
// x, B, C and y fp32 (ssd_scan_f32) or bf16 (ssd_scan_bf16).
//
// Replaces: src/repro/kernels/ssd.py::ssd_scan (body _ssd_kernel, and the
// elementwise x * dt, dt * A and D x around it), the Pallas kernel behind
// `ssd` pallas (ops.py:336) that every Mamba2 prefill runs.
//
// Inputs: x (B, S, H, P), dt (B, S, H), A (H,), optional D (H,), Bm, Cm
// (B, S, G, N); head h reads group h / (H / G).  S % Q == 0, 0 < Q <= 128.
// Outputs: y (B, S, H, P) with the D term, final state (B, H, P, N).
// Per chunk c of Q steps, with xbar = x dt, la = dt A and cs the inclusive
// cumsum of la over the chunk (cs_last its last entry):
//   dS_c = sum_j exp(cs_last - cs_j) xbar_j B_j^T                    (P x N)
//   S_0  = 0,  S_{c+1} = exp(cs_last) S_c + dS_c     (S_nc: the final state)
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xbar_j + (exp(cs_i) C_i) . S_c
//          + D x_i
//
// What bounds it on the H100: operations.  mamba2's prefill (B = 1, S =
// 1024, H = 32, P = 64, N = 128, Q = 128, G = 1) needs ~1.36 GFLOP with the
// scores C_i . B_j formed once per group (0.020 ms at 67 TFLOP/s fp32) on
// ~19 MB of inputs and outputs (0.006 ms at 3.35 TB/s).
//
// Design: the state-passing decomposition of Mamba2's GPU kernels (Dao & Gu
// 2024, section 7).  One C entry launches three kernels in order on the
// caller's stream; only the second walks the chunks in order.
// 1. chunk_kernel, grid (chunk, state tiles + score tiles, sequence): every
//    chunk at once.  A state tile (head, 64 state columns p, 64 state rows n)
//    forms the chunk's cumsum (one warp, a fixed order; written to the cs
//    scratch) and dS_c's tile; a score tile (group, 64 query rows i, 64 key
//    rows j <= i's tile) forms C_i . B_j once for all heads of the group.
// 2. pass_kernel, grid (32 x 64 slices of the state, head, sequence): S_c
//    in registers over the chunks in order, the dS of 8 chunks loaded at
//    once; each chunk's start state replaces its dS_c in the scratch, and the
//    final state goes out through a transpose in shared memory.
// 3. output_kernel, grid (chunk x 64-row tile, head x 64-column tile of P,
//    sequence): every chunk at once.  y's tile is one contraction, over the
//    key rows j (the scores, masked and decayed, against xbar) and then over
//    N (C scaled by exp(cs_i) against S_c; skipped for chunk 0, whose start
//    state is 0), into one sum per element.
// Every product is a 64 x 64 output tile of a 256-thread block, a 4 x 4
// register micro-tile per thread, over contraction steps of 32 staged by
// cp.async through a ring of STAGES buffers (the next step loads while one
// multiplies).  Every shared load is a float4 and feeds 8 FMAs; at that
// ratio shared memory, not the FMA units, sets the products' pace: a warp's
// 16-byte load takes four of shared memory's cycles, its 8 FMAs two of the
// SM's FMA issue, so the products run at up to half the fp32 peak.  8 x 8
// and 8 x 4 micro-tiles on 64- and 128-thread
// blocks, deeper rings and 16-step stages were each no faster on the card
// at mamba2's widths, and slower at short prompts, where fewer warps share
// an SM.  The scalings that need a tile's values (x * dt * w, the decay and
// mask of the scores, x * dt, C exp(cs_i)) are applied by each thread to
// the pieces it copied, after its own copies land and before the barrier
// that publishes the tile.  Shared memory is static (36 KB, 8 KB and 35 KB
// a block).  At mamba2's 1024-token prefill phases 1 and 3 run 536 and 512
// blocks.
//
// Exactness: every sum has a fixed order that depends only on (S, H, P, G,
// N, Q): the cumsum by runs of ceil(Q / 32) and a shuffle scan, each product
// over its contraction in order, the state pass over the chunks in order.
// No atomics; no block reads another sequence, so a sequence's y and final
// state are the same bits at any B.  exp(cs_i - cs_j) is formed only for j
// <= i (elsewhere the difference is positive and could overflow), and
// masked scores are selected away, never multiplied by 0.
//
// bf16 (ssd_scan_bf16): x, B, C and y bf16, dt, A and D fp32 (as the mamba
// layer passes them), the final state and every scratch fp32; the same three
// kernels, chunk_kernel and output_kernel instantiated on the element type.
// A bf16 piece of 4 values is loaded into registers (one 8-byte load where
// P and N are multiples of 4 and the pointers 8-byte aligned, else 2-byte
// loads), upcast and stored to the fp32 tile as its step is staged, so
// every product, scaling and sum is the fp32 kernel's on the upcast values;
// y's element is formed in fp32 with its D term (fmaf(x, D, acc)) and
// rounded once to bf16 on store.  So y is the fp32 entry's y on the upcast
// inputs rounded once, and the state is the fp32 entry's state.  (JAX's
// Pallas kernel rounds y to bf16 before its wrapper adds D x and rounds
// again.)  The load of a bf16 piece is not asynchronous: the thread waits
// for it as it stages, and the other warps of the SM cover the wait.
#include <cstdint>

#include "common.cuh"

namespace {

using repro_torch::bf16;
using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;

constexpr int THREADS = 256;   // 16 x 16
constexpr int TILE = 64;       // output tile of every product (64 x 64)
constexpr int KT = 32;         // contraction step of one staged buffer
constexpr int STAGES = 2;      // staged buffers: STAGES - 1 steps load while one multiplies
constexpr int KP = KT + 4;     // row of a contraction-contiguous tile (the pad spreads
                               // rows over the banks)
constexpr int MAX_Q = 128;     // chunk length: the cumsum's runs and the per-chunk vectors
constexpr int PASS_THREADS = 256;
constexpr int PASS_N = 32;     // state rows of a pass block (x 64 columns)
constexpr int PASS_GROUP = 8;  // chunks whose dS the state pass loads at once

// Static shared memory, in floats, of each kernel (under 48 KB at any shape).
constexpr int SMEM_CHUNK = STAGES * 2 * TILE * KP;   // scores: C, B [STAGES][TILE][KP] (>= states)
constexpr int SMEM_OUT = STAGES * (TILE * KP + KT * TILE) + 2 * MAX_Q;
constexpr int SMEM_PASS = TILE * (PASS_N + 1);

struct Geo {
  int S, H, P, G, N, Q;
  int nc;    // chunks, S / Q
  int nrt;   // 64-row tiles of a chunk, ceil(Q / 64)
  int ntp;   // 64-column tiles of P
  int ntn;   // 64-row tiles of N
  int QR;    // nrt * 64: the score scratch's row length
  int PP;    // ntp * 64: the state scratch's row length
};

// One 4-float piece: dst[0..3] <- src[0..n-1], zeros at and past n (all zeros
// for n <= 0, reading `any`, a mapped address).  VEC: one 16-byte copy (n is
// then a multiple of 4 or <= 0), else 4-byte ones.
template <bool VEC>
__device__ __forceinline__ void piece(float* dst, const float* src, int n, const float* any) {
  if (VEC) {
    cp_async16(dst, n > 0 ? src : any, n > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < n ? src + e : any, e < n);
  }
}

// The same piece from bf16 values, upcast through registers into dst (16-byte
// aligned); VEC: one 8-byte load.  The thread sees it at once, the others
// after the barrier that publishes the step.
template <bool VEC>
__device__ __forceinline__ void piece(float* dst, const bf16* src, int n, const bf16*) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (n > 0) v = repro_torch::load4f(src);
  } else {
    if (n > 0) v.x = repro_torch::to_f32(src[0]);
    if (n > 1) v.y = repro_torch::to_f32(src[1]);
    if (n > 2) v.z = repro_torch::to_f32(src[2]);
    if (n > 3) v.w = repro_torch::to_f32(src[3]);
  }
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[m][e] += sum_k A[k][ty*4 + m] Bk[k][tx*4 + e], k = 0..KT-1 in order;
// both tiles k-major with rows of TILE.
__device__ __forceinline__ void mma_kk(const float* A, const float* Bk, int ty, int tx,
                                       float (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * TILE + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bk + k * TILE + tx * 4);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = fmaf(at(a, m), at(b, e), acc[m][e]);
  }
}

// acc[m][e] += sum_k A[ty + 16m][k] Bm[tx + 16e][k]; both tiles
// contraction-contiguous with rows of KP.
__device__ __forceinline__ void mma_rr(const float* A, const float* Bm, int ty, int tx,
                                       float (&acc)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < KT; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = *reinterpret_cast<const float4*>(A + (ty + 16 * m) * KP + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      b[e] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * e) * KP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = fmaf(at(a[m], kk), at(b[e], kk), acc[m][e]);
  }
}

// acc[m][e] += sum_k A[ty + 16m][k] Bk[k][tx*4 + e]; A contraction-contiguous
// with rows of KP, Bk k-major with rows of TILE.
__device__ __forceinline__ void mma_rk(const float* A, const float* Bk, int ty, int tx,
                                       float (&acc)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < KT; k += 4) {
    float4 a[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = *reinterpret_cast<const float4*>(A + (ty + 16 * m) * KP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Bk + (k + kk) * TILE + tx * 4);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = fmaf(at(a[m], kk), at(b, e), acc[m][e]);
    }
  }
}

// The contraction's nk steps through the ring of STAGES buffers.
// stage(t, buf) issues step t's copies into buffer buf; land(t, buf) applies
// this thread's scalings to the pieces it copied; mul(t, buf) multiplies.
// Each step's copies are one commit group, and so is each (empty) group past
// the last step, so waiting until at most STAGES - 1 groups are in flight
// leaves step t landed.  ring_start issues the first STAGES - 1 steps.
template <class Stage>
__device__ __forceinline__ void ring_start(int nk, Stage stage) {
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) stage(t, t);
    cp_async_commit();
  }
}

template <class Stage, class Land, class Mul>
__device__ __forceinline__ void ring_run(int nk, Stage stage, Land land, Mul mul) {
  for (int t = 0; t < nk; ++t) {
    const int next = t + STAGES - 1;
    if (next < nk) stage(next, next % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    land(t, t % STAGES);
    __syncthreads();
    mul(t, t % STAGES);
    __syncthreads();
  }
}

// Inclusive cumsum of la_j = dt_j a over the chunk's Q steps into cs[j], by
// warp 0 in a fixed order: lane l sums its run of ceil(Q / 32) steps in
// order, then an inclusive shuffle scan of the run totals gives each run
// the sum of the runs before it.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a, float* cs, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, per = (Q + 31) / 32, lo = lane * per;
  float run[MAX_Q / 32], tot = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    if (k < per && lo + k < Q) tot += dts[lo + k] * a;
    run[k] = tot;
  }
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k)
    if (k < per && lo + k < Q) cs[lo + k] = before + run[k];
}

// Phase 1.  Blocks y < H * ntp * ntn: dS_c's tile (head h, columns p0.., rows
// n0..) into st (B, nc, H, N, PP) as [n][p]; the tiles with p0 = n0 = 0 also
// write the chunk's cumsum into cs (B, H, S).  Blocks above: the scores of
// (group, row tile r, column tile t <= r) into sc (B, nc, G, QR, QR).  T: the
// type of x, Bm and Cm (fp32 or bf16).
template <bool VEC, typename T>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, float* __restrict__ st, float* __restrict__ sc,
             float* __restrict__ cs_out, Geo g) {
  __shared__ __align__(16) float smem[SMEM_CHUNK];
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s0 = c * g.Q, n_state = g.H * g.ntp * g.ntn;
  float acc[4][4] = {};

  if (static_cast<int>(blockIdx.y) < n_state) {
    const int h = blockIdx.y / (g.ntp * g.ntn), rest = blockIdx.y % (g.ntp * g.ntn);
    const int p0 = rest / g.ntn * TILE, n0 = rest % g.ntn * TILE, grp = h / (g.H / g.G);
    float* X = smem;                       // [STAGES][KT][TILE]: x, then x dt w
    float* Bk = X + STAGES * KT * TILE;    // [STAGES][KT][TILE]
    float* dts = Bk + STAGES * KT * TILE;  // [MAX_Q]
    float* cs = dts + MAX_Q;          // [MAX_Q]
    float* wl = cs + MAX_Q;           // [MAX_Q] exp(cs_last - cs_j)
    auto stage = [&](int kt, int buf) {
      for (int q = tid; q < KT * TILE / 4; q += THREADS) {
        const int r = q / (TILE / 4), col = q % (TILE / 4) * 4, j = kt * KT + r;
        const size_t row = (size_t)b * g.S + s0 + j;
        const bool in = j < g.Q;
        piece<VEC>(X + (buf * KT + r) * TILE + col, x + (row * g.H + h) * g.P + p0 + col,
                   in ? g.P - p0 - col : 0, x);
        piece<VEC>(Bk + (buf * KT + r) * TILE + col, Bm + (row * g.G + grp) * g.N + n0 + col,
                   in ? g.N - n0 - col : 0, Bm);
      }
    };
    const int nk = (g.Q + KT - 1) / KT;
    ring_start(nk, stage);
    if (tid < MAX_Q) dts[tid] = tid < g.Q ? dt[((size_t)b * g.S + s0 + tid) * g.H + h] : 0.f;
    __syncthreads();
    chunk_cumsum(dts, A[h], cs, g.Q);
    __syncthreads();
    if (tid < MAX_Q) wl[tid] = tid < g.Q ? expf(cs[g.Q - 1] - cs[tid]) : 0.f;
    if (rest == 0 && tid < g.Q) cs_out[((size_t)b * g.H + h) * g.S + s0 + tid] = cs[tid];
    __syncthreads();
    ring_run(nk, stage, [&](int kt, int buf) {      // (x dt) w on this thread's pieces
      for (int q = tid; q < KT * TILE / 4; q += THREADS) {
        const int r = q / (TILE / 4), j = kt * KT + r;
        float4* v = reinterpret_cast<float4*>(X + (buf * KT + r) * TILE + q % (TILE / 4) * 4);
        const float d = dts[j], w = wl[j];
        *v = make_float4(v->x * d * w, v->y * d * w, v->z * d * w, v->w * d * w);
      }
    }, [&](int, int buf) { mma_kk(X + buf * KT * TILE, Bk + buf * KT * TILE, ty, tx, acc); });
    float* out = st + (((size_t)b * g.nc + c) * g.H + h) * g.N * g.PP + p0 + ty * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + tx * 4 + e;
      if (n < g.N)
        *reinterpret_cast<float4*>(out + (size_t)n * g.PP) =
            make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
    }
    return;
  }

  const int nst = g.nrt * (g.nrt + 1) / 2;
  int t = blockIdx.y - n_state;
  const int grp = t / nst;
  t %= nst;
  int r = 0;
  while (t > r) t -= ++r;                // t -> (r, t <= r): (0,0) (1,0) (1,1) ...
  const int i0 = r * TILE, j0 = t * TILE;
  float* Cs = smem;                       // [STAGES][TILE][KP]
  float* Bs = Cs + STAGES * TILE * KP;    // [STAGES][TILE][KP]
  auto stage = [&](int kt, int buf) {
    for (int q = tid; q < TILE * KT / 4; q += THREADS) {
      const int rr = q / (KT / 4), col = q % (KT / 4) * 4, n = kt * KT + col;
      const int i = i0 + rr, j = j0 + rr;
      piece<VEC>(Cs + (buf * TILE + rr) * KP + col,
                 Cm + (((size_t)b * g.S + s0 + i) * g.G + grp) * g.N + n,
                 i < g.Q ? g.N - n : 0, Cm);
      piece<VEC>(Bs + (buf * TILE + rr) * KP + col,
                 Bm + (((size_t)b * g.S + s0 + j) * g.G + grp) * g.N + n,
                 j < g.Q ? g.N - n : 0, Bm);
    }
  };
  const int nk = (g.N + KT - 1) / KT;
  ring_start(nk, stage);
  ring_run(nk, stage, [](int, int) {}, [&](int, int buf) {
    mma_rr(Cs + buf * TILE * KP, Bs + buf * TILE * KP, ty, tx, acc);
  });
  float* out = sc + (((size_t)b * g.nc + c) * g.G + grp) * g.QR * g.QR;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)(i0 + ty + 16 * m) * g.QR + j0 + tx + 16 * e] = acc[m][e];
}

// Phase 2.  Block (32 state rows n0.. x 64 columns p0.., head, sequence):
// S over the chunks in order; chunk c's slot of st gets S_c (its start
// state) in place of dS_c; the final state goes to state_out (B, H, P, N).
__global__ void __launch_bounds__(PASS_THREADS)
pass_kernel(float* __restrict__ st, const float* __restrict__ cs, float* __restrict__ state_out,
            Geo g) {
  __shared__ float T[SMEM_PASS];        // [TILE][PASS_N + 1]: the final state as [p][n]
  const int nn = (g.N + PASS_N - 1) / PASS_N;
  const int n0 = blockIdx.x % nn * PASS_N, p0 = blockIdx.x / nn * TILE;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, pl = tid % 16 * 4;
  float4 S[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  const size_t chunk_stride = (size_t)g.H * g.N * g.PP;
  float* base = st + ((size_t)b * g.nc * g.H + h) * g.N * g.PP + p0 + pl;
  for (int c0 = 0; c0 < g.nc; c0 += PASS_GROUP) {
    float4 d[PASS_GROUP][2];
    float decay[PASS_GROUP];
#pragma unroll
    for (int u = 0; u < PASS_GROUP; ++u) {       // every load of the group before any store
      const int c = c0 + u;
      if (c >= g.nc) break;
      decay[u] = expf(cs[((size_t)b * g.H + h) * g.S + c * g.Q + g.Q - 1]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int n = n0 + tid / 16 + 16 * k;
        if (n < g.N)
          d[u][k] = *reinterpret_cast<const float4*>(base + c * chunk_stride + (size_t)n * g.PP);
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_GROUP; ++u) {
      const int c = c0 + u;
      if (c >= g.nc) break;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int n = n0 + tid / 16 + 16 * k;
        if (n >= g.N) continue;
        *reinterpret_cast<float4*>(base + c * chunk_stride + (size_t)n * g.PP) = S[k];
        S[k] = make_float4(S[k].x * decay[u] + d[u][k].x, S[k].y * decay[u] + d[u][k].y,
                           S[k].z * decay[u] + d[u][k].z, S[k].w * decay[u] + d[u][k].w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int nl = tid / 16 + 16 * k;
    T[(pl + 0) * (PASS_N + 1) + nl] = S[k].x;
    T[(pl + 1) * (PASS_N + 1) + nl] = S[k].y;
    T[(pl + 2) * (PASS_N + 1) + nl] = S[k].z;
    T[(pl + 3) * (PASS_N + 1) + nl] = S[k].w;
  }
  __syncthreads();
  const int p = p0 + tid / 4, nq = tid % 4 * 8;
  if (p >= g.P) return;
  float* out = state_out + (((size_t)b * g.H + h) * g.P + p) * g.N;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = n0 + nq + e;
    if (n < g.N) out[n] = T[(tid / 4) * (PASS_N + 1) + nq + e];
  }
}

// Phase 3.  Block (chunk, row tile, head, column tile of P, sequence): y's
// 64 x 64 tile.  Steps kt < n_in contract over the key rows j of the
// decayed, masked scores against xbar; the steps after, over N, C exp(cs_i)
// against the chunk's start state; all into one accumulator.  T: the type of
// x, Cm and y; y + D x is formed in fp32 and rounded once to T.
template <bool VEC, typename T>
__global__ void __launch_bounds__(THREADS)
output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ D, const T* __restrict__ Cm,
              const float* __restrict__ st, const float* __restrict__ sc,
              const float* __restrict__ cs, T* __restrict__ y, Geo g) {
  __shared__ __align__(16) float smem[SMEM_OUT];
  float* A_s = smem;                    // [STAGES][TILE][KP]: decayed scores, or C exp(cs_i)
  float* B_s = A_s + STAGES * TILE * KP;  // [STAGES][KT][TILE]: xbar, or the start state
  float* css = B_s + STAGES * KT * TILE;  // [MAX_Q]
  float* dts = css + MAX_Q;             // [MAX_Q]
  const int c = blockIdx.x / g.nrt, r = g.nrt - 1 - blockIdx.x % g.nrt;   // long rows first
  const int h = blockIdx.y / g.ntp, p0 = blockIdx.y % g.ntp * TILE, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int grp = h / (g.H / g.G), s0 = c * g.Q, i0 = r * TILE;
  const int n_in = (min(g.Q, i0 + TILE) + KT - 1) / KT;
  const int nk = n_in + (c > 0 ? (g.N + KT - 1) / KT : 0);
  const float* scores = sc + (((size_t)b * g.nc + c) * g.G + grp) * g.QR * g.QR;
  const float* start = st + (((size_t)b * g.nc + c) * g.H + h) * g.N * g.PP;

  if (tid < MAX_Q) {
    css[tid] = tid < g.Q ? cs[((size_t)b * g.H + h) * g.S + s0 + tid] : 0.f;
    dts[tid] = tid < g.Q ? dt[((size_t)b * g.S + s0 + tid) * g.H + h] : 0.f;
  }
  auto stage = [&](int kt, int buf) {
    float* As = A_s + buf * TILE * KP;
    float* Bs = B_s + buf * KT * TILE;
    if (kt < n_in) {
      const int j0 = kt * KT;
      for (int q = tid; q < TILE * KT / 4; q += THREADS) {
        const int rr = q / (KT / 4), col = q % (KT / 4) * 4;
        cp_async16(As + rr * KP + col, scores + (size_t)(i0 + rr) * g.QR + j0 + col);
      }
      for (int q = tid; q < KT * TILE / 4; q += THREADS) {
        const int k = q / (TILE / 4), col = q % (TILE / 4) * 4, j = j0 + k;
        piece<VEC>(Bs + k * TILE + col, x + (((size_t)b * g.S + s0 + j) * g.H + h) * g.P + p0 + col,
                   j < g.Q ? g.P - p0 - col : 0, x);
      }
    } else {
      const int n0 = (kt - n_in) * KT;
      for (int q = tid; q < TILE * KT / 4; q += THREADS) {
        const int rr = q / (KT / 4), col = q % (KT / 4) * 4, i = i0 + rr;
        piece<VEC>(As + rr * KP + col,
                   Cm + (((size_t)b * g.S + s0 + i) * g.G + grp) * g.N + n0 + col,
                   i < g.Q ? g.N - n0 - col : 0, Cm);
      }
      for (int q = tid; q < KT * TILE / 4; q += THREADS) {
        const int k = q / (TILE / 4), col = q % (TILE / 4) * 4, n = n0 + k;
        cp_async16(Bs + k * TILE + col, n < g.N ? start + (size_t)n * g.PP + p0 + col : start,
                   n < g.N);
      }
    }
  };

  auto land = [&](int kt, int buf) {
    float* As = A_s + buf * TILE * KP;
    float* Bs = B_s + buf * KT * TILE;
    if (kt < n_in) {                     // on this thread's pieces: decay and mask, x dt
      const int j0 = kt * KT;
      for (int q = tid; q < TILE * KT / 4; q += THREADS) {
        const int rr = q / (KT / 4), col = q % (KT / 4) * 4, i = i0 + rr;
        float* v = As + rr * KP + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + col + e;
          v[e] = (i < g.Q && j <= i) ? v[e] * expf(css[i] - css[j]) : 0.f;
        }
      }
      for (int q = tid; q < KT * TILE / 4; q += THREADS) {
        const int k = q / (TILE / 4);
        float4* v = reinterpret_cast<float4*>(Bs + k * TILE + q % (TILE / 4) * 4);
        const float d = dts[j0 + k];
        *v = make_float4(v->x * d, v->y * d, v->z * d, v->w * d);
      }
    } else {                             // C exp(cs_i) (rows past Q are zeros)
      for (int q = tid; q < TILE * KT / 4; q += THREADS) {
        const int rr = q / (KT / 4), i = i0 + rr;
        float4* v = reinterpret_cast<float4*>(As + rr * KP + q % (KT / 4) * 4);
        const float e = i < g.Q ? expf(css[i]) : 0.f;
        *v = make_float4(v->x * e, v->y * e, v->z * e, v->w * e);
      }
    }
  };
  float acc[4][4] = {};
  ring_start(nk, stage);
  __syncthreads();                       // css, dts
  ring_run(nk, stage, land, [&](int, int buf) {
    mma_rk(A_s + buf * TILE * KP, B_s + buf * KT * TILE, ty, tx, acc);
  });

  const float dh = D != nullptr ? D[h] : 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m, p = p0 + tx * 4;
    if (i >= g.Q || p >= g.P) continue;
    const size_t row = (((size_t)b * g.S + s0 + i) * g.H + h) * g.P;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = acc[m][e];
      if (D != nullptr && p + e < g.P)
        o[e] = fmaf(repro_torch::to_f32(x[row + p + e]), dh, o[e]);
    }
    if (VEC) {
      repro_torch::store4f(y + row + p, make_float4(o[0], o[1], o[2], o[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p + e < g.P) y[row + p + e] = repro_torch::from_f32<T>(o[e]);
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// x (B,S,H,P), dt (B,S,H), A (H,), D (H,) or null, Bm/Cm (B,S,G,N) -> y
// (B,S,H,P), state (B,H,P,N); x, Bm, Cm and y of type T, the rest fp32, all
// contiguous; S % Q == 0, 0 < Q <= 128, H % G == 0.  Scratch
// (kernels/ssd.py::scan_scratch, times B): st (B, S/Q, H, N, PP), sc (B,
// S/Q, G, QR, QR), cs (B, H, S), 16-byte aligned, with PP and QR P and Q
// rounded up to 64.
template <typename T>
int scan(const T* x, const float* dt, const float* A, const float* D, const T* Bm,
         const T* Cm, T* y, float* state, float* st, float* sc, float* cs, int B, int S, int H,
         int P, int G, int N, int Q, void* stream) {
  Geo g;
  g.S = S; g.H = H; g.P = P; g.G = G; g.N = N; g.Q = Q;
  g.nc = S / Q;
  g.nrt = (Q + TILE - 1) / TILE;
  g.ntp = (P + TILE - 1) / TILE;
  g.ntn = (N + TILE - 1) / TILE;
  g.QR = g.nrt * TILE;
  g.PP = g.ntp * TILE;
  // pieces of 4 values: 16 bytes of fp32, 8 of bf16
  const size_t al = 4 * sizeof(T);
  const bool vec = P % 4 == 0 && N % 4 == 0 && aligned(x, al) && aligned(Bm, al) &&
                   aligned(Cm, al) && aligned(y, al);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g1(g.nc, H * g.ntp * g.ntn + G * g.nrt * (g.nrt + 1) / 2, B);
  if (vec)
    chunk_kernel<true, T><<<g1, THREADS, 0, s>>>(x, dt, A, Bm, Cm, st, sc, cs, g);
  else
    chunk_kernel<false, T><<<g1, THREADS, 0, s>>>(x, dt, A, Bm, Cm, st, sc, cs, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((N + PASS_N - 1) / PASS_N * g.ntp, H, B);
  pass_kernel<<<g2, PASS_THREADS, 0, s>>>(st, cs, state, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g3(g.nc * g.nrt, H * g.ntp, B);
  if (vec)
    output_kernel<true, T><<<g3, THREADS, 0, s>>>(x, dt, D, Cm, st, sc, cs, y, g);
  else
    output_kernel<false, T><<<g3, THREADS, 0, s>>>(x, dt, D, Cm, st, sc, cs, y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scan (scan above) with x, Bm, Cm and y fp32.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A, const float* D,
                            const float* Bm, const float* Cm, float* y, float* state,
                            float* st, float* sc, float* cs, int B, int S, int H, int P,
                            int G, int N, int Q, void* stream) {
  return scan(x, dt, A, D, Bm, Cm, y, state, st, sc, cs, B, S, H, P, G, N, Q, stream);
}

// The same with x, Bm, Cm and y bf16 (dt, A, D, the state and the scratch fp32).
extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                             const float* D, const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
                             __nv_bfloat16* y, float* state, float* st, float* sc, float* cs,
                             int B, int S, int H, int P, int G, int N, int Q, void* stream) {
  return scan(x, dt, A, D, Bm, Cm, y, state, st, sc, cs, B, S, H, P, G, N, Q, stream);
}
