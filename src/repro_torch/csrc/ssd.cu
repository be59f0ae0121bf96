// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan, fp32, FFMA.
//
// Replaces: src/repro/kernels/ssd.py::ssd_scan (body _ssd_kernel), the Pallas
// kernel behind `ssd` pallas (ops.py:336) that every Mamba2 prefill runs.
//
// Inputs, as the wrapper prepares them (JAX precomputes the same two):
//   xbar (B, S, H, P) = x * dt,  la (B, S, H) = dt * A (log decay, <= 0),
//   Bm, Cm (B, S, G, N); head h reads group h / (H / G).  S % Q == 0.
// Outputs: y (B, S, H, P) without the D term, final state (B, H, P, N).
// Per chunk of Q steps, with cs the inclusive cumsum of la over the chunk:
//   y[i]  = sum_{j<=i} exp(cs_i - cs_j) (C_i . B_j) xbar_j + exp(cs_i) C_i . state
//   state = exp(cs_last) state + sum_j exp(cs_last - cs_j) xbar_j B_j^T
//
// What bounds it on the H100: mamba2's prefill (B = 1, H = 32, P = 64,
// N = 128, Q = 128) does ~10.5 MFLOP per (head, chunk) on 19 MB in all for a
// 1024-token prompt, so it is bound by operations (2.68 GFLOP, 0.040 ms at
// 67 TFLOP/s fp32), and with 32 heads it needs more blocks than (B, H) give.
//
// Design: one 256-thread block per (16 state columns p, head, sequence); the
// chunks run in order inside the block with the (16, N) slice of the state
// in shared memory, never in device memory (the Pallas grid's sequential
// chunk axis).  State columns are independent, so at B = 1 the grid has
// 4 x 32 = 128 blocks; each block recomputes the chunk's (Q, Q) scores
// C_i . B_j, which do not depend on p.  The B and C chunks (Q x N each), the
// xbar columns and the state slice sit in shared memory (165 KB at Q = N =
// 128), so the scores are built in tiles of 32 rows.  exp(cs_i - cs_j) is
// computed only for j <= i: for j > i the difference is positive and could
// overflow, so it is never formed.  Every sum has a fixed order that
// depends only on the shapes.  Known limits: scalar FFMA from shared memory
// (one B or C load per FMA in the score loop); no tensor cores; the cumsum
// is one warp's work per chunk.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PT = 16;      // state columns per block
constexpr int RT = 32;      // score rows per tile (8 warps x 4 rows)
constexpr int MAX_Q = 128;  // chunk length the score tile is sized for

// Scores of rows i0 + warp + 8m (m < 4) against columns j = lane + 32t
// (t < NT), masked and decayed, into Sc[RT][MAX_Q].
template <int NT>
__device__ __forceinline__ void score_tile(const float* Cs, const float* Bs, const float* cs,
                                           float* Sc, int i0, int Q, int N) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int NP = N + 1;
  float acc[4][NT];
  int crow[4], bcol[NT];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    crow[m] = min(i0 + warp + 8 * m, Q - 1) * N;   // rows past Q are computed, not kept
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[m][t] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) bcol[t] = min(lane + 32 * t, Q - 1) * NP;
  for (int n = 0; n < N; ++n) {
    float c[4], bb[NT];
#pragma unroll
    for (int m = 0; m < 4; ++m) c[m] = Cs[crow[m] + n];       // broadcast
#pragma unroll
    for (int t = 0; t < NT; ++t) bb[t] = Bs[bcol[t] + n];     // rows padded to N+1
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[m][t] = fmaf(c[m], bb[t], acc[m][t]);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = warp + 8 * m, i = i0 + r;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      Sc[r * MAX_Q + j] = (i < Q && j <= i) ? acc[m][t] * expf(cs[i] - cs[j]) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ xbar, const float* __restrict__ la,
           const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* Bs = smem;               // [Q][N+1]
  float* Cs = Bs + Q * NP;        // [Q][N]
  float* Xs = Cs + Q * N;         // [Q][PT]   xbar columns p0 .. p0+PT-1
  float* St = Xs + Q * PT;        // [PT][N+1] the state slice
  float* cs = St + PT * NP;       // [MAX_Q]   inclusive cumsum of la
  float* wl = cs + MAX_Q;         // [MAX_Q]   exp(cs_last - cs_j)
  float* Sc = wl + MAX_Q;         // [RT][MAX_Q] one tile of masked, decayed scores

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);

  for (int i = tid; i < PT * NP; i += THREADS) St[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with Bs, Cs, Xs, cs and St
    for (int i = tid; i < Q * N; i += THREADS) {
      const int j = i / N, n = i % N;
      const size_t src = (((size_t)b * S + s0 + j) * G + g) * N + n;
      Bs[j * NP + n] = Bm[src];
      Cs[i] = Cm[src];
    }
    for (int i = tid; i < Q * PT; i += THREADS) {
      const int j = i / PT, p = p0 + i % PT;
      Xs[i] = p < P ? xbar[(((size_t)b * S + s0 + j) * H + h) * P + p] : 0.f;
    }
    if (warp == 0) {
      // lane l sums its run of Q/32 steps in order, then a shuffle scan
      // adds the runs before it
      const int per = (Q + 31) / 32, lo = lane * per, hi = min(lo + per, Q);
      float run[MAX_Q / 32], tot = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k) {
        const int j = lo + k;
        if (j < hi) tot += la[((size_t)b * S + s0 + j) * H + h];
        run[k] = tot;
      }
      float incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float before = incl - tot;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k)
        if (lo + k < hi) cs[lo + k] = before + run[k];
    }
    __syncthreads();
    for (int j = tid; j < Q; j += THREADS) wl[j] = expf(cs[Q - 1] - cs[j]);

    // y, one tile of RT rows at a time (it reads the state before the update)
    for (int i0 = 0; i0 < Q; i0 += RT) {
      const int nt = (min(Q, i0 + RT) + 31) / 32;     // column groups rows < i0+RT can see
      switch (nt) {
        case 1: score_tile<1>(Cs, Bs, cs, Sc, i0, Q, N); break;
        case 2: score_tile<2>(Cs, Bs, cs, Sc, i0, Q, N); break;
        case 3: score_tile<3>(Cs, Bs, cs, Sc, i0, Q, N); break;
        default: score_tile<4>(Cs, Bs, cs, Sc, i0, Q, N); break;
      }
      __syncthreads();
      const int pp = tid % PT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = tid / PT + 16 * half, i = i0 + r;
        if (i >= Q) continue;
        float yi = 0.f, yo = 0.f;
        for (int j = 0; j <= i; ++j) yi = fmaf(Sc[r * MAX_Q + j], Xs[j * PT + pp], yi);
        for (int n = 0; n < N; ++n) yo = fmaf(Cs[i * N + n], St[pp * NP + n], yo);
        const int p = p0 + pp;
        if (p < P) y[(((size_t)b * S + s0 + i) * H + h) * P + p] = yi + yo * expf(cs[i]);
      }
      __syncthreads();  // Sc is rewritten by the next tile; St by the update
    }

    // state = exp(cs_last) state + sum_j (xbar_j w_j) B_j^T
    const float decay = expf(cs[Q - 1]);
    for (int i = tid; i < PT * N; i += THREADS) {
      const int pp = i / N, n = i % N;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(Xs[j * PT + pp] * wl[j], Bs[j * NP + n], acc);
      St[pp * NP + n] = St[pp * NP + n] * decay + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < PT * N; i += THREADS) {
    const int pp = i / N, n = i % N, p = p0 + pp;
    if (p < P) state_out[(((size_t)b * H + h) * P + p) * N + n] = St[pp * NP + n];
  }
}

// Shared memory of one block, in bytes (kernels/ssd.py::scan_fits checks the same sum).
int smem_bytes(int N, int Q) {
  return 4 * (Q * (N + 1) + Q * N + Q * PT + PT * (N + 1) + 2 * MAX_Q + RT * MAX_Q);
}

}  // namespace

// xbar (B,S,H,P), la (B,S,H), Bm/Cm (B,S,G,N) -> y (B,S,H,P), state (B,H,P,N);
// all fp32 and contiguous; S % Q == 0, 0 < Q <= 128, H % G == 0.
extern "C" int ssd_scan_f32(const float* xbar, const float* la, const float* Bm,
                            const float* Cm, float* y, float* state, int B, int S, int H,
                            int P, int G, int N, int Q, void* stream) {
  const int smem = smem_bytes(N, Q);
  static int smem_set[repro_torch::kMaxDevices];
  const cudaError_t err = repro_torch::allow_smem(ssd_kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + PT - 1) / PT, H, B);
  ssd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      xbar, la, Bm, Cm, y, state, S, H, P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}
