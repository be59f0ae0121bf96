// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan; x, B, C and
// y fp32 (ssd_scan_f32: FFMA) or bf16 (ssd_scan_bf16: the tensor cores).
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
// layer passes them), the final state and every scratch fp32, on a body of
// its own on the tensor cores.  (The FFMA kernels above on upcast tiles, the
// former bf16 body, stay callable as ssd_scan_bf16_ffma: the yardstick
// chip_smoke.py times this body against; no path runs it.)  Bytes bound
// the bf16 scan: mamba2's 1024-token prefill moves ~10 MB at 2 bytes a bf16
// value (0.003 ms at 3.35 TB/s) for 1.36 GFLOP (0.0014 ms at 989 TFLOP/s).
// What held the FFMA body back: its products at up to half the fp32 FFMA
// peak, and bf16 pieces loaded through registers and upcast into fp32
// tiles.  This body's answers:
// - The products on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), tiles
//   staged by 16-byte cp.async as they are stored (2-byte loads where P or
//   N is off 8 or a pointer unaligned) and read by ldmatrix, every row
//   padded by 8 values so that ldmatrix's 8 rows fall in 8 bank groups.
//   mma.sync, not wgmma: a warp's tile here is 16 rows (a causal chunk's
//   rows see different key counts, so the diagonal tile skips the 16-key
//   groups past a warp's rows), and a kernel's products are a few hundred
//   instructions a warp; wgmma's 64-row tiles would lose both.
// - state_tc_kernel (grid as chunk_kernel's): a state block forms dS_c =
//   (x s)^T B, s_j = dt_j exp(cs_last - cs_j) (x^T by ldmatrix.trans,
//   scaled in registers; B by ldmatrix.trans) and writes it [n][p] fp32,
//   and the chunk's cumsum, as chunk_kernel does; a score block (score_tile)
//   forms C_i . B_j for a 64 x 64 tile of a chunk, once per group for all
//   its heads, straight from the bf16 inputs (exact) into the sc scratch.
//   The scores stay in scratch on purpose: the output kernel forming them
//   itself, once per head (no sc, no score blocks), measured slower on the
//   card at mamba2's and zamba2's widths (32 and 112 heads on one group).
// - pass_kernel<true>: the fp32 state pass, which stores each start state
//   S_c as the operand the output kernel stages: each 8-column group of a
//   row as [8 hi][8 lo] bf16 in the 32 bytes its floats took (split_bf16).
// - output_tc_kernel (grid as output_kernel's, long row tiles first; warp w
//   rows i0 + 16 w ..): for c > 0, acc = C S_c^T over 64-value pieces of N
//   (S_c's hi, then its lo), then acc *= exp(cs_i); for each 64-row key
//   tile j0 <= i0 its x rows and fp32 scores (on the diagonal tile only the
//   16-key groups at or below the warp's rows): L = (scores exp(cs_i -
//   cs_j)) dt_j where j <= i, split hi + lo in registers as the A operand,
//   and acc += L x (x by ldmatrix.trans); y = acc + D x in fp32, rounded
//   once.  The steps go through a ring of STAGES buffers (TC_OUT_BYTES of
//   dynamic shared memory).
// The precision split: C, B and x go in as they are stored (bf16, exact);
// every fp32 factor goes in as hi + lo bf16 halves (split_bf16, about 16
// significant bits), hi's product first: x s in dS_c, the decayed scores
// L, and S_c; exp(cs_i) is applied to the fp32 accumulator after C S_c^T,
// not to C (the same product, one rounding fewer).  A bf16 factor alone
// misses BF16_TOL, as flash_attention.cu found for its P.  The cumsum, the
// decay, exp, the state pass and every accumulator stay fp32.
// The plan is the fp32 body's grid (TILE-wide tiles of P, N and Q), read
// from (S, H, P, G, N, Q) alone.  Every sum's order is fixed by those and
// a row's position (the products over their contractions in 16-deep chunks
// in order, hi before lo; the pass over the chunks in order); no block
// reads another sequence; no atomics: a sequence's y and state are the same
// bits at any B.  They are not the fp32 entry's bits (the tensor cores sum
// each 16-deep chunk their own way): chip_smoke.py holds y within BF16_TOL
// of the plain version and the state within 1e-4.  ptxas (sm_90a):
// state_tc_kernel 92 / 96 registers (element / 16-byte staging),
// output_tc_kernel 128 / 145, pass_kernel<true> 116, no spill;
// chip_smoke.py phase 2 prints them.  (JAX's Pallas kernel rounds y to bf16
// before its wrapper adds D x and rounds again.)
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
// SPLIT (the bf16 body): S_c goes into the slot as the bf16 pairs of
// split_bf16, each row's 8-column groups as [8 hi][8 lo] in the 32 bytes
// their floats took: the operand output_tc_kernel stages.  The two lanes
// of a group read their dS before either writes (__syncwarp).  Every S is
// the same fp32 sum either way.
template <bool SPLIT>
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
    if (SPLIT) __syncwarp();
#pragma unroll
    for (int u = 0; u < PASS_GROUP; ++u) {
      const int c = c0 + u;
      if (c >= g.nc) break;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int n = n0 + tid / 16 + 16 * k;
        if (n >= g.N) continue;
        float* slot = base + c * chunk_stride + (size_t)n * g.PP;
        if (SPLIT) {
          // this lane's 4 columns: hi at bf16 (pl / 8) 16 + pl % 8, lo 8 on
          uint2 hi, lo;
          repro_torch::split_bf16(S[k].x, S[k].y, hi.x, lo.x);
          repro_torch::split_bf16(S[k].z, S[k].w, hi.y, lo.y);
          uint2* out = reinterpret_cast<uint2*>(slot - pl % 8 / 2);
          out[0] = hi;
          out[2] = lo;
        } else {
          *reinterpret_cast<float4*>(slot) = S[k];
        }
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

// ---------------------------------------------------------------------------
// The bf16 body on the tensor cores (ssd_scan_bf16): state_tc_kernel,
// pass_kernel<true>, output_tc_kernel.  See the note at the top.

using repro_torch::ldsm_x4;
using repro_torch::ldsm_x4_trans;
using repro_torch::mma16816;
using repro_torch::split_bf16;

constexpr int TC_THREADS = 128;           // 4 warps, 16 output rows each
constexpr int TC_ROW = TILE + 8;          // a staged row of 64 bf16 values, padded by 8: ldmatrix's
                                          // 8 rows fall in 8 bank groups
constexpr int TC_SROW = 2 * TILE + 8;     // a staged row of S_c's 64 columns as hi and lo pairs
constexpr int TC_NK = 64;                 // the output kernel's pieces of N
constexpr int TC_KROW = TC_NK + 8;        // a staged row of a piece of N
constexpr int TC_FROW = TILE + 8;         // a staged row of 64 fp32 scores, padded by 8
// a step of the output kernel's ring, in bf16 values: a piece of C and one
// of the start state's hi and lo rows, or a key tile's x rows and scores
constexpr int TC_STAGE = TILE * TC_KROW + TC_NK * TC_SROW > TILE * TC_ROW + 2 * TILE * TC_FROW
                             ? TILE * TC_KROW + TC_NK * TC_SROW
                             : TILE * TC_ROW + 2 * TILE * TC_FROW;
constexpr int TC_OUT_BYTES = STAGES * TC_STAGE * 2;   // the output kernel's dynamic shared memory

// A bf16 pair as two floats (exact).
__device__ __forceinline__ float lo_f32(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// `rows` rows of COLS bf16 values into dst (rows of DS): row r from src + r *
// stride, zeros in rows at or past n and in columns at or past w.  VEC:
// 16-byte cp.async pieces (w a multiple of 8, src 16-byte aligned); else
// 2-byte loads and stores.  All the block's threads take part.
template <bool VEC, int COLS, int DS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t stride, int rows,
                                           int n, int w) {
  if (VEC) {
    for (int q = threadIdx.x; q < rows * (COLS / 8); q += TC_THREADS) {
      const int r = q / (COLS / 8), c = q % (COLS / 8) * 8;
      const bool ok = r < n && c < w;
      repro_torch::cp_async16(dst + r * DS + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int q = threadIdx.x; q < rows * COLS; q += TC_THREADS) {
      const int r = q / COLS, c = q % COLS;
      repro_torch::copy1(dst + r * DS + c, src + r * stride + c, r < n && c < w);
    }
  }
}

// The scores of (group grp, 64 query rows i0.., 64 key rows j0 <= i0 of a
// chunk) into sc (B, nc, G, QR, QR) as chunk_kernel's score blocks write
// them: C_i . B_j over N's 64-value pieces, straight from the bf16 inputs
// (exact), warp w the rows i0 + 16 w .., one accumulator chain a score.
// Once a group for all its heads.  `t` numbers (group, (r, t <= r)).
template <bool VEC>
__device__ __forceinline__ void score_tile(const bf16* Bm, const bf16* Cm, float* sc, bf16* c_s,
                                           bf16* b_s, const Geo& g, int b, int c, int t) {
  const int nst = g.nrt * (g.nrt + 1) / 2, grp = t / nst;
  t %= nst;
  int r = 0;
  while (t > r) t -= ++r;                // t -> (r, t <= r): (0,0) (1,0) (1,1) ...
  const int i0 = r * TILE, j0 = t * TILE, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t row0 = (size_t)b * g.S + (size_t)c * g.Q;
  const int a_off = (16 * warp + lane % 16) * TC_ROW + 8 * (lane / 16);
  const int k_off = ((lane % 8) + 8 * (lane / 16)) * TC_ROW + 8 * (lane / 8 % 2);
  float acc[8][4] = {};
  for (int n0 = 0; n0 < g.N; n0 += TILE) {
    stage_rows<VEC, TILE, TC_ROW>(c_s, Cm + ((row0 + i0) * g.G + grp) * g.N + n0,
                                  (size_t)g.G * g.N, TILE, g.Q - i0, g.N - n0);
    stage_rows<VEC, TILE, TC_ROW>(b_s, Bm + ((row0 + j0) * g.G + grp) * g.N + n0,
                                  (size_t)g.G * g.N, TILE, g.Q - j0, g.N - n0);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<0>();
    __syncthreads();
    const int kn = (min(TILE, g.N - n0) + 15) / 16;
    for (int kk = 0; kk < kn; ++kk) {
      unsigned a[4];
      ldsm_x4(a, c_s + a_off + 16 * kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned bb[4];
        ldsm_x4(bb, b_s + k_off + 16 * q * TC_ROW + 16 * kk);
        mma16816(acc[2 * q], a[0], a[1], a[2], a[3], bb[0], bb[1]);
        mma16816(acc[2 * q + 1], a[0], a[1], a[2], a[3], bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
  // acc[e]: rows i0 + 16 warp + lane / 4 (+ 8), columns j0 + 8 e + 2 (lane % 4) (+ 1)
  float* out = sc + (((size_t)b * g.nc + c) * g.G + grp) * g.QR * g.QR +
               (size_t)(i0 + 16 * warp + lane / 4) * g.QR + j0 + 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    *reinterpret_cast<float2*>(out + 8 * e) = make_float2(acc[e][0], acc[e][1]);
    *reinterpret_cast<float2*>(out + 8 * g.QR + 8 * e) = make_float2(acc[e][2], acc[e][3]);
  }
}

// Phase 1 at bf16.  Block (chunk c, (head h, 64 columns p0 of P, 64 rows n0
// of N), sequence b): dS_c's tile into st as chunk_kernel writes it ([n][p]
// fp32); the blocks with p0 = n0 = 0 also the chunk's cumsum into cs.  Warp w
// owns p0 + 16 w .. + 15: dS = (x s)^T B over the chunk's steps j in 16-deep
// chunks, s_j = dt_j exp(cs_last - cs_j), x^T by ldmatrix.trans, scaled in
// registers and split hi + lo, B by ldmatrix.trans.
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
state_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, float* __restrict__ st, float* __restrict__ sc,
                float* __restrict__ cs_out, Geo g) {
  __shared__ __align__(16) bf16 xs[MAX_Q * TC_ROW];   // x [j][p0 ..], or C's piece
  __shared__ __align__(16) bf16 bs[MAX_Q * TC_ROW];   // B [j][n0 ..], or B's piece
  __shared__ float dts[MAX_Q], cs[MAX_Q], sj[MAX_Q];
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (static_cast<int>(blockIdx.y) >= g.H * g.ntp * g.ntn) {
    score_tile<VEC>(Bm, Cm, sc, xs, bs, g, b, c, blockIdx.y - g.H * g.ntp * g.ntn);
    return;
  }
  const int h = blockIdx.y / (g.ntp * g.ntn), rest = blockIdx.y % (g.ntp * g.ntn);
  const int p0 = rest / g.ntn * TILE, n0 = rest % g.ntn * TILE, grp = h / (g.H / g.G);
  const int nk = (g.Q + 15) / 16;
  const size_t row0 = (size_t)b * g.S + (size_t)c * g.Q;
  stage_rows<VEC, TILE, TC_ROW>(xs, x + (row0 * g.H + h) * g.P + p0, (size_t)g.H * g.P,
                                16 * nk, g.Q, g.P - p0);
  stage_rows<VEC, TILE, TC_ROW>(bs, Bm + (row0 * g.G + grp) * g.N + n0, (size_t)g.G * g.N,
                                16 * nk, g.Q, g.N - n0);
  repro_torch::cp_async_commit();
  if (tid < MAX_Q) dts[tid] = tid < g.Q ? dt[(row0 + tid) * g.H + h] : 0.f;
  __syncthreads();
  chunk_cumsum(dts, A[h], cs, g.Q);
  __syncthreads();
  if (tid < MAX_Q) sj[tid] = tid < g.Q ? dts[tid] * expf(cs[g.Q - 1] - cs[tid]) : 0.f;
  if (rest == 0 && tid < g.Q) cs_out[((size_t)b * g.H + h) * g.S + (size_t)c * g.Q + tid] = cs[tid];
  repro_torch::cp_async_wait<0>();
  __syncthreads();

  const int gq = lane / 4, tq = lane % 4;
  // the lanes' ldmatrix rows: x^T (.trans: rows j, columns p), B (.trans:
  // rows j, columns n, two 8-column tiles an instruction)
  const bf16* x_lane =
      xs + ((lane % 8) + 8 * (lane / 16)) * TC_ROW + 16 * warp + 8 * (lane / 8 % 2);
  const bf16* b_lane = bs + ((lane % 8) + 8 * (lane / 8 % 2)) * TC_ROW + 8 * (lane / 16);
  float acc[8][4] = {};
  for (int kk = 0; kk < nk; ++kk) {
    unsigned a[4], ahi[4], alo[4];
    ldsm_x4_trans(a, x_lane + 16 * kk * TC_ROW);
    const int j = 16 * kk + 2 * tq;
    const float s0 = sj[j], s1 = sj[j + 1], s8 = sj[j + 8], s9 = sj[j + 9];
    split_bf16(lo_f32(a[0]) * s0, hi_f32(a[0]) * s1, ahi[0], alo[0]);
    split_bf16(lo_f32(a[1]) * s0, hi_f32(a[1]) * s1, ahi[1], alo[1]);
    split_bf16(lo_f32(a[2]) * s8, hi_f32(a[2]) * s9, ahi[2], alo[2]);
    split_bf16(lo_f32(a[3]) * s8, hi_f32(a[3]) * s9, ahi[3], alo[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned bb[4];
      ldsm_x4_trans(bb, b_lane + 16 * kk * TC_ROW + 16 * q);
      mma16816(acc[2 * q], ahi[0], ahi[1], ahi[2], ahi[3], bb[0], bb[1]);
      mma16816(acc[2 * q], alo[0], alo[1], alo[2], alo[3], bb[0], bb[1]);
      mma16816(acc[2 * q + 1], ahi[0], ahi[1], ahi[2], ahi[3], bb[2], bb[3]);
      mma16816(acc[2 * q + 1], alo[0], alo[1], alo[2], alo[3], bb[2], bb[3]);
    }
  }
  // acc[e]: rows p0 + 16 warp + gq (+ 8), columns n0 + 8 e + 2 tq (+ 1)
  float* out = st + (((size_t)b * g.nc + c) * g.H + h) * g.N * g.PP + p0 + 16 * warp + gq;
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = n0 + 8 * e + 2 * tq + u;
      if (n < g.N) {
        out[(size_t)n * g.PP] = acc[e][u];
        out[(size_t)n * g.PP + 8] = acc[e][2 + u];
      }
    }
}

// Phase 3 at bf16.  Block (chunk c x 64-row tile r, head h x 64 columns p0 of
// P, sequence b): y's tile, warp w its rows i0 + 16 w .. + 15, one fp32
// accumulator, over a ring of steps:
// - for c > 0, one step a 64-value piece of N: acc += C S_c^T (C's piece of
//   the tile's rows; S_c's rows of the piece, hi then lo, as
//   pass_kernel<true> wrote them); then acc *= exp(cs_i);
// - one step a 64-row key tile j0 <= i0: its x rows and the group's fp32
//   scores (state_tc_kernel's score blocks); L = (scores exp(cs_i - cs_j))
//   dt_j where j <= i (0 elsewhere, selected), split hi + lo into the A
//   operand in registers, and acc += L x (x by ldmatrix.trans); on the
//   diagonal tile only the 16-key groups at or below the warp's rows;
// then y = acc + D x in fp32, rounded once.
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
output_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ D, const bf16* __restrict__ Cm,
                 const float* __restrict__ st, const float* __restrict__ sc,
                 const float* __restrict__ cs, bf16* __restrict__ y, Geo g) {
  extern __shared__ __align__(16) unsigned char smem_out[];
  bf16* ring = reinterpret_cast<bf16*>(smem_out);   // [STAGES][TC_STAGE]
  __shared__ float css[MAX_Q], dts[MAX_Q];
  const int c = blockIdx.x / g.nrt, r = g.nrt - 1 - blockIdx.x % g.nrt;   // long rows first
  const int h = blockIdx.y / g.ntp, p0 = blockIdx.y % g.ntp * TILE, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, gq = lane / 4, tq = lane % 4;
  const int grp = h / (g.H / g.G), i0 = r * TILE;
  const size_t row0 = (size_t)b * g.S + (size_t)c * g.Q;
  const int n_inter = c > 0 ? (g.N + TC_NK - 1) / TC_NK : 0;   // pieces of N
  const int nk = n_inter + r + 1;
  const bf16* start = reinterpret_cast<const bf16*>(
      st + (((size_t)b * g.nc + c) * g.H + h) * g.N * g.PP) + 2 * p0;
  const bf16* c_rows = Cm + ((row0 + i0) * g.G + grp) * g.N;
  const float* scores = sc + (((size_t)b * g.nc + c) * g.G + grp) * g.QR * g.QR +
                        (size_t)i0 * g.QR;
  if (tid < MAX_Q) {
    css[tid] = tid < g.Q ? cs[((size_t)b * g.H + h) * g.S + (size_t)c * g.Q + tid] : 0.f;
    dts[tid] = tid < g.Q ? dt[(row0 + tid) * g.H + h] : 0.f;
  }

  // step t < n_inter: C's piece t and S_c's rows of it; else key tile
  // t - n_inter: its x rows and the scores of the tile's rows against it
  auto stage = [&](int t, int buf) {
    bf16* sp = ring + buf * TC_STAGE;
    if (t < n_inter) {
      const int nc0 = t * TC_NK, rows = min(TC_NK, g.N - nc0);
      stage_rows<VEC, TC_NK, TC_KROW>(sp, c_rows + nc0, (size_t)g.G * g.N, TILE, g.Q - i0,
                                      g.N - nc0);
      bf16* s_rows = sp + TILE * TC_KROW;
      for (int q = tid; q < TC_NK * 16; q += TC_THREADS) {
        const int rr = q / 16, cc = q % 16 * 8;
        const bool ok = rr < rows;
        repro_torch::cp_async16(s_rows + rr * TC_SROW + cc,
                                start + (size_t)(ok ? nc0 + rr : 0) * 2 * g.PP + cc, ok);
      }
    } else {
      const int j0 = (t - n_inter) * TILE;
      stage_rows<VEC, TILE, TC_ROW>(sp, x + ((row0 + j0) * g.H + h) * g.P + p0,
                                    (size_t)g.H * g.P, TILE, g.Q - j0, g.P - p0);
      float* s_tile = reinterpret_cast<float*>(sp + TILE * TC_ROW);
      for (int q = tid; q < TILE * 16; q += TC_THREADS) {
        const int rr = q / 16, cc = q % 16 * 4;
        repro_torch::cp_async16(s_tile + rr * TC_FROW + cc, scores + (size_t)rr * g.QR + j0 + cc);
      }
    }
  };

  // the lanes' ldmatrix rows: C (rows i, columns n), x and S_c (.trans:
  // rows j or n, columns p; two 8-column tiles, or one tile's hi and lo)
  const int a_off = (16 * warp + lane % 16) * TC_KROW + 8 * (lane / 16);
  const int t_off = ((lane % 8) + 8 * (lane / 8 % 2)) * TC_ROW + 8 * (lane / 16);
  const int s_off = ((lane % 8) + 8 * (lane / 8 % 2)) * TC_SROW + 8 * (lane / 16);
  const int ia = i0 + 16 * warp + gq, ib = ia + 8;      // this lane's two rows
  float acc[8][4] = {};

  auto mul = [&](int t, int buf) {
    const bf16* sp = ring + buf * TC_STAGE;
    if (t < n_inter) {                                      // acc += C S_c^T
      const bf16* s_rows = sp + TILE * TC_KROW;
      const int kn = (min(TC_NK, g.N - t * TC_NK) + 15) / 16;
      for (int kk = 0; kk < kn; ++kk) {
        unsigned a[4];
        ldsm_x4(a, sp + a_off + 16 * kk);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          unsigned bb[4];
          ldsm_x4_trans(bb, s_rows + s_off + 16 * kk * TC_SROW + 16 * q);
          mma16816(acc[q], a[0], a[1], a[2], a[3], bb[0], bb[1]);
          mma16816(acc[q], a[0], a[1], a[2], a[3], bb[2], bb[3]);
        }
      }
      if (t == n_inter - 1) {
        const float ea = expf(css[ia]), eb = expf(css[ib]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          acc[q][0] *= ea;
          acc[q][1] *= ea;
          acc[q][2] *= eb;
          acc[q][3] *= eb;
        }
      }
      return;
    }
    const int kt = t - n_inter, j0 = kt * TILE;
    // the 16-key groups this warp needs: all below the diagonal tile, on it
    // those at or below the warp's rows
    const int ng = kt < r ? 4 : warp + 1;
    const float* s_tile = reinterpret_cast<const float*>(sp + TILE * TC_ROW);
    const float ca = css[ia], cb = css[ib];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= ng) continue;
      // L over keys j0 + 16 q .. + 15 as this lane's A registers: rows ia,
      // ib; keys 2 tq, + 1 of each 8-key half
      unsigned hi[4], lo[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jl = 16 * q + 8 * half + 2 * tq, j = j0 + jl;
        const float2 sa =
            *reinterpret_cast<const float2*>(s_tile + (16 * warp + gq) * TC_FROW + jl);
        const float2 sb =
            *reinterpret_cast<const float2*>(s_tile + (16 * warp + gq + 8) * TC_FROW + jl);
        const float sv[4] = {sa.x, sa.y, sb.x, sb.y};
        float l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, jj = j + e % 2;
          l[e] = (i < g.Q && jj <= i) ? sv[e] * expf((e < 2 ? ca : cb) - css[jj]) * dts[jj]
                                      : 0.f;
        }
        split_bf16(l[0], l[1], hi[2 * half], lo[2 * half]);
        split_bf16(l[2], l[3], hi[2 * half + 1], lo[2 * half + 1]);
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        unsigned bb[4];
        ldsm_x4_trans(bb, sp + t_off + 16 * q * TC_ROW + 16 * pp);
        mma16816(acc[2 * pp], hi[0], hi[1], hi[2], hi[3], bb[0], bb[1]);
        mma16816(acc[2 * pp], lo[0], lo[1], lo[2], lo[3], bb[0], bb[1]);
        mma16816(acc[2 * pp + 1], hi[0], hi[1], hi[2], hi[3], bb[2], bb[3]);
        mma16816(acc[2 * pp + 1], lo[0], lo[1], lo[2], lo[3], bb[2], bb[3]);
      }
    }
  };
  ring_start(nk, stage);
  ring_run(nk, stage, [](int, int) {}, mul);

  // acc[e]: rows ia, ib; columns p0 + 8 e + 2 tq, + 1
  const float dh = D != nullptr ? D[h] : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? ib : ia;
    if (i >= g.Q) continue;
    const size_t row = ((row0 + i) * g.H + h) * g.P;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int p = p0 + 8 * e + 2 * tq;
      float o0 = acc[e][2 * half], o1 = acc[e][2 * half + 1];
      if (D != nullptr) {
        if (p < g.P) o0 = fmaf(repro_torch::to_f32(x[row + p]), dh, o0);
        if (p + 1 < g.P) o1 = fmaf(repro_torch::to_f32(x[row + p + 1]), dh, o1);
      }
      if (VEC) {
        if (p < g.P)
          *reinterpret_cast<unsigned*>(y + row + p) = repro_torch::pack_bf16(o0, o1);
      } else {
        if (p < g.P) y[row + p] = __float2bfloat16_rn(o0);
        if (p + 1 < g.P) y[row + p + 1] = __float2bfloat16_rn(o1);
      }
    }
  }
}

// The tensor-core body: phase 1 (its state and score blocks), the state
// pass in its bf16 layout, phase 3, on the caller's stream.
int scan_tc(const bf16* x, const float* dt, const float* A, const float* D, const bf16* Bm,
            const bf16* Cm, bf16* y, float* state, float* st, float* sc, float* cs, const Geo& g,
            int B, bool vec, cudaStream_t s) {
  static int smem_set[2][repro_torch::kMaxDevices];
  const dim3 g1(g.nc, g.H * g.ntp * g.ntn + g.G * g.nrt * (g.nrt + 1) / 2, B);
  if (vec)
    state_tc_kernel<true><<<g1, TC_THREADS, 0, s>>>(x, dt, A, Bm, Cm, st, sc, cs, g);
  else
    state_tc_kernel<false><<<g1, TC_THREADS, 0, s>>>(x, dt, A, Bm, Cm, st, sc, cs, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((g.N + PASS_N - 1) / PASS_N * g.ntp, g.H, B);
  pass_kernel<true><<<g2, PASS_THREADS, 0, s>>>(st, cs, state, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g3(g.nc * g.nrt, g.H * g.ntp, B);
  auto kernel = vec ? &output_tc_kernel<true> : &output_tc_kernel<false>;
  err = repro_torch::allow_smem(kernel, TC_OUT_BYTES, smem_set[vec]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g3, TC_THREADS, TC_OUT_BYTES, s>>>(x, dt, D, Cm, st, sc, cs, y, g);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

Geo geometry(int S, int H, int P, int G, int N, int Q) {
  Geo g;
  g.S = S; g.H = H; g.P = P; g.G = G; g.N = N; g.Q = Q;
  g.nc = S / Q;
  g.nrt = (Q + TILE - 1) / TILE;
  g.ntp = (P + TILE - 1) / TILE;
  g.ntn = (N + TILE - 1) / TILE;
  g.QR = g.nrt * TILE;
  g.PP = g.ntp * TILE;
  return g;
}

// x (B,S,H,P), dt (B,S,H), A (H,), D (H,) or null, Bm/Cm (B,S,G,N) -> y
// (B,S,H,P), state (B,H,P,N); x, Bm, Cm and y of type T, the rest fp32, all
// contiguous; S % Q == 0, 0 < Q <= 128, H % G == 0.  Scratch
// (kernels/ssd.py::scan_scratch, times B): st (B, S/Q, H, N, PP), sc (B,
// S/Q, G, QR, QR), cs (B, H, S), 16-byte aligned, with PP and QR P and Q
// rounded up to 64.  The FFMA body: the fp32 entry, and the former bf16 body.
template <typename T>
int scan(const T* x, const float* dt, const float* A, const float* D, const T* Bm,
         const T* Cm, T* y, float* state, float* st, float* sc, float* cs, int B, int S, int H,
         int P, int G, int N, int Q, void* stream) {
  const Geo g = geometry(S, H, P, G, N, Q);
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
  pass_kernel<false><<<g2, PASS_THREADS, 0, s>>>(st, cs, state, g);
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

// The scan with x, Bm, Cm and y bf16 (dt, A, D, the state and the scratch
// fp32) on the tensor-core body.
extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                             const float* D, const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
                             __nv_bfloat16* y, float* state, float* st, float* sc, float* cs,
                             int B, int S, int H, int P, int G, int N, int Q, void* stream) {
  const bool vec = P % 8 == 0 && N % 8 == 0 && aligned(x, 16) && aligned(Bm, 16) &&
                   aligned(Cm, 16) && aligned(y, 16);
  return scan_tc(x, dt, A, D, Bm, Cm, y, state, st, sc, cs, geometry(S, H, P, G, N, Q), B, vec,
                 static_cast<cudaStream_t>(stream));
}

// The same arguments on the former bf16 body (scan above: bf16 pieces upcast
// into the fp32 tiles, FFMA): no path runs it; chip_smoke.py times the
// tensor-core body beside it.
extern "C" int ssd_scan_bf16_ffma(const __nv_bfloat16* x, const float* dt, const float* A,
                                  const float* D, const __nv_bfloat16* Bm,
                                  const __nv_bfloat16* Cm, __nv_bfloat16* y, float* state,
                                  float* st, float* sc, float* cs, int B, int S, int H, int P,
                                  int G, int N, int Q, void* stream) {
  return scan(x, dt, A, D, Bm, Cm, y, state, st, sc, cs, B, S, H, P, G, N, Q, stream);
}
