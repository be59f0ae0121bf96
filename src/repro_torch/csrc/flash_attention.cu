// Flash attention over a KV cache or a sequence's own K/V, fp32 arithmetic.
//   q (B, T, Hq, D) -> o (B, T, Hq, Dv).  Four entry points share one kernel
//   body, attention_kernel, a template over the KV source (dense or paged
//   fp32 rows, int8 pages) and a mask policy:
//   flash_chunk_attention_f32        dense k (B, S, Hk, D), v (B, S, Hk, Dv);
//                                    query row t sits at start[b] + t and
//                                    attends cache columns <= start[b] + t;
//   flash_paged_chunk_attention_f32  the same over pages (N, P, Hk, D/Dv) fp32
//                                    through block tables (B, MP);
//   flash_paged_chunk_attention_i8   int8 pages with (N, Hk) fp32 scales,
//                                    dequantized as float(x) * scale;
//   flash_attention_f32              dense k/v (B, Skv, Hk, D/Dv); query row i
//                                    sits at the static position Skv - T + i;
//                                    causal (columns <= row) or not, and an
//                                    optional sliding window (columns
//                                    > row - window);
//   flash_attention_bf16             the same on bf16 q, k, v and o, on the
//                                    tensor cores (attention_wgmma_kernel,
//                                    below).
//   Each cuts the S columns into shards of `shard` columns (the wrapper's
//   attention_shard_cols(S), never a function of B or T).  A row whose
//   visible columns lie in one shard is written by the block of that
//   shard; the others get each shard's unnormalised partials (acc, m, l)
//   in a workspace the wrapper allocates, merged by combine_kernel in shard
//   order.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_chunk_attention (body
// _chunk_flash_kernel), behind `chunk_attention` pallas (serving_ops.py:329),
// flash_paged_chunk_attention (bodies _paged_chunk_kernel and
// _paged_chunk_q_kernel), behind `paged_chunk_attention[_q]` pallas
// (serving_ops.py:513, :849), and flash_attention (body _flash_kernel), behind
// `attention` pallas (ops.py:95), which the layer-stack models' prefill uses.
//
// What bounds it on the H100: fp32 FFMA issue.  A whole prefill (T = S =
// 1024, D = 256) does ~256 flop/byte and an engine chunk (T = 64 rows
// against up to ~700 cache rows, D = 96) ~30, both above the fp32 ridge of
// 20 flop/byte (67 TFLOP/s over 3.35 TB/s).  What sets the rate is how many
// FMAs each shared-memory load feeds and how evenly the work covers the 132
// SMs.
//
// Design:
// - Grid (query tiles x shards, B * Hk): one 256-thread block per (query
//   tile, shard, sequence, kv head) holding BR = 64 query rows: BQ = 64 / GP
//   positions of all G = Hq / Hk query heads of the kv head (GP: G rounded
//   up to a power of 2; rows of heads >= G are idle), so a staged K/V tile
//   serves G x BQ rows.  Block x takes query tile n_qt - 1 - x / NS: the
//   tiles with the longest causal walks start first.  A block whose shard
//   holds no column its tile may see returns at once.
// - KV tiles of BKV = 64 columns aligned to column 0 of the cache.  Shared
//   memory: Q [64][D4] pre-scaled, K [64][D4 + 4] (the pad spreads 8 rows
//   over the banks), V [64][Dv4], P [64][64]; 91 KB at D = 96 and 113 KB at
//   D = 128 (two blocks per SM), 209 KB at D = 256 (one).
// - Register micro-tiles.  Thread (ty, tx) = (tid / 16, tid % 16) owns
//   rows ty + 16 i (i < 4) of both products, score columns tx + 16 j and
//   the float4 groups tx + 16 v of Dv.  Q.K^T reads a float4 of Q per row
//   and of K per column: each load feeds 4 rows or columns x 4 FMAs.  P.V
//   reads P as float4 along the columns and V as float4 groups.
// - Softmax in registers: a row's max and sum over its 16 threads by a
//   fixed xor butterfly (offsets 8, 4, 2, 1); O rescaled in registers.
// - Staging overlaps the math: Q comes by cp.async with the first K tile
//   (each thread then scales the pieces it copied), K of tile j + 1 is
//   copied (cp.async, zero fill past the walk) while P.V of tile j runs,
//   and V of tile j while Q.K^T of tile j runs; two barriers per tile.  int8 pages are loaded 4
//   bytes a thread into registers at the same points and dequantized into
//   the fp32 tile just before the barrier that publishes it.
//
// Exactness.  Every FMA chain runs in a fixed order: a score over d = 0..D-1,
// a row's output over the columns of a tile in order, tiles in order, shards
// merged in order.  A column a row may not see weighs exactly 0 (p = 0; a
// tile it sees nothing of leaves m, l and O unchanged: alpha = exp(0) = 1),
// and the tiles and shards are fixed in absolute columns, so a row's result
// depends neither on the batch, nor on T, nor on where its chunk starts.
// One shard merged alone gives acc * 1 / max(l * 1, 1e-30): the bits of the
// direct write.  The softmax keeps the Pallas kernel's finite -1e30 and its
// acc / max(l, 1e-30) finish: a row that sees no column gives 0.  No atomics.
//
// Paged: the same tiles, each row located through the block table by
// common.cuh's paged_row; table entries past a tile's last allowed column
// (junk) are never read.  fp32 pages run the dense rows' arithmetic, so an
// fp32 paged row is bitwise equal to the dense kernel's row on the gathered
// cache.
//
// bf16 (flash_attention_bf16): its own body, attention_wgmma_kernel, with
// both products on the tensor cores.  The fp32 FFMA body above tops out at
// 67 TFLOP/s; wgmma reaches 989.  It computes what the Pallas kernel's
// _flash_kernel computes on bf16 q, k and v: scores, softmax state and
// output in fp32, the output rounded once to bf16.
// - Block: one warpgroup (128 threads) owns the 64 query rows of the fp32
//   body's GQA packing (G heads of a kv head at 64 / GP positions), a shard
//   of the wrapper's attention_shard_cols_bf16(S, Hq, Hk) columns, and the
//   same grid, longest causal walks first.  Shared memory holds Q, K and V
//   as [64 rows][64 values] bf16 panels, one 128-byte row a row under
//   wgmma's 128-byte swizzle: Q and K in pad64(D) / 64 panels along D
//   (K-major), V in pad64(Dv) / 64 panels along Dv.  One K and one V tile,
//   as the fp32 body: 99,328 B at D = Dv = 256, 50,176 at 128, 66,560 at
//   192 / 128, 25,600 at 64.  Registers, not shared memory, set the blocks
//   an SM: O takes 32 fp32 registers a thread a panel of Dv (241 registers
//   a thread at Dv = 256: two blocks; 167 at 128: three; 127 at 64: four).
// - Staging: the warpgroup itself copies with cp.async, 16 bytes a copy,
//   into the swizzled layout: Q with the first K tile, V of tile j while Q
//   K^T and the softmax of tile j run, K of tile j + 1 (once every warp's
//   Q K^T is done) while the softmax and P V of tile j run; three barriers
//   a tile.  Where D or Dv is off 8 or a
//   pointer is not 16-byte aligned it loads element by element into the
//   same layout.  Columns past the walk and values past D or Dv are zero,
//   so a masked column multiplies 0.  fence.proxy.async, then the barrier,
//   publish a tile to wgmma.
// - S = Q K^T (64 x 64, fp32 registers): wgmma.m64n64k16 over D's 16-deep
//   chunks from 0 upward, A and B both K-major in shared memory.  It is
//   scaled in fp32 (q is not rounded after scaling), masked to -1e30, and
//   the softmax runs in registers: a row's max and sum over its four lanes
//   by a fixed xor order (1, 2) after each lane's 16 columns in order; l
//   sums the fp32 p, as the reference does.
// - O += P V: p is split into hi = bf16(p) and lo = bf16(p - hi) (p within
//   2^-17 of hi + lo; a bf16 P alone puts an error of up to 2^-9 of V's
//   spread into O, more than one bf16 ulp of a small output), each packed
//   in the accumulator's own fragment layout as wgmma's register A.  V is
//   read N-major (imm-trans-b 1): for each 64-column panel of Dv and each
//   16-column chunk of the tile in order, one m64n64k16 on hi, then one on
//   lo.  O (64 x pad64(Dv)) stays in fp32 registers and finishes as O /
//   max(l, 1e-30), or goes out as a shard's partial.
// One order for every row: the instruction sequence depends on (D, Dv)
// alone, tiles are 64 columns from column 0, a row's shards come from (S,
// Hq, Hk) alone, and a tile a row sees nothing of leaves it unchanged (p = 0
// exactly, alpha = exp(0) = 1, and P V adds products of 0).  So a row's bits
// depend neither on the batch, nor on Sq, nor on its place in the tile.  A
// bf16 result is not the fp32 entry's rounded: the tensor core sums each
// 16-deep chunk in its own order.
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using repro_torch::DenseRows;
using repro_torch::PagedRows;
using repro_torch::kNegInf;
using repro_torch::pad4;

constexpr int THREADS = 256;  // 16 x 16
constexpr int BR = 64;        // query rows per block
constexpr int RPT = BR / 16;  // rows per thread
constexpr int BKV = 64;       // columns per K/V tile
constexpr int WIDE = 128;     // D, Dv (padded) up to this: 2 float4 groups of Dv a thread
                              // (NV) and two blocks an SM at D = 128; wider: 4
constexpr int MAX_SHARDS = 8; // the wrapper's attention_shard_cols keeps NS <= 8

// floats of dynamic shared memory: Q [BR][D4], K [BKV][D4 + 4], V [BKV][Dv4],
// P [BR][BKV]
__host__ __device__ inline size_t attn_smem_floats(int D, int Dv) {
  return (size_t)BR * pad4(D) + (size_t)BKV * (pad4(D) + 4) + (size_t)BKV * pad4(Dv) +
         (size_t)BR * BKV;
}

// Mask policies: pos0(b, t) is the position of query row t of sequence b;
// a row at position `pos` sees columns lo(pos) .. hi(pos, S) (none when
// lo > hi), a range that moves right with pos.

// Chunked prefill: row t of sequence b at start[b] + t, columns <= row.
struct OffsetCausal {
  const int* __restrict__ start;
  __device__ __forceinline__ int pos0(int b, int t) const { return start[b] + t; }
  __device__ __forceinline__ int lo(int) const { return 0; }
  __device__ __forceinline__ int hi(int pos, int S) const { return min(S - 1, pos); }
};

// Whole-sequence attention: row i at the static offset + i (offset = Skv - T),
// columns <= row when causal, columns > row - window when window > 0.
struct StaticWindow {
  int offset, causal, window;
  __device__ __forceinline__ int pos0(int, int t) const { return offset + t; }
  __device__ __forceinline__ int lo(int pos) const {
    return window > 0 ? max(0, pos - window + 1) : 0;
  }
  __device__ __forceinline__ int hi(int pos, int S) const {
    return causal ? min(S - 1, pos) : S - 1;
  }
};

// KV sources.  issue() starts staging rows j0 .. j0 + n - 1 of (b, h)
// (width W, W4 = pad4(W)) into dst (row stride ST), rows j >= n and
// columns >= W zero; land() completes it before the barrier that publishes
// the tile (with cp_async_wait).  Regs<NP> carries a thread's loads (NP
// pieces) from one to the other.

// fp32 rows (dense or paged): cp.async straight into the tile, 16-byte
// pieces when `vec` (W % 4 == 0 and 16-byte aligned bases), else 4-byte ones.
template <class Rows>
struct F32Source {
  using Elem = float;
  template <int NP>
  struct Regs {};
  Rows rows;
  template <class R>
  __device__ __forceinline__ void issue(const float* __restrict__ src, const float*, float* dst,
                                        int ST, int W, int b, int h, int j0, int n, bool vec,
                                        R&) const {
    if (vec) {
      const int nc = W / 4;
      for (int e = threadIdx.x; e < BKV * nc; e += THREADS) {
        const int j = e / nc, c = e % nc;
        const bool ok = j < n;
        int blk;
        repro_torch::cp_async16(dst + j * ST + 4 * c,
                                ok ? src + rows.row(b, h, j0 + j, blk) * W + 4 * c : src, ok);
      }
    } else {
      const int W4 = pad4(W);
      for (int e = threadIdx.x; e < BKV * W4; e += THREADS) {
        const int j = e / W4, d = e % W4;
        const bool ok = j < n && d < W;
        int blk;
        repro_torch::cp_async4(dst + j * ST + d,
                               ok ? src + rows.row(b, h, j0 + j, blk) * W + d : src, ok);
      }
    }
  }
  template <class R>
  __device__ __forceinline__ void land(float*, int, int, bool, R&) const {}
};

// int8 pages: 4 bytes a thread piece (piece e = tid + 256 i is row e / (W/4),
// bytes 4 (e % (W/4)) ..) loaded into registers with the row's scale, and
// stored as float(x) * scale.  Without `vec` (W % 4 != 0 or an unaligned
// base) issue() loads and stores element by element.
struct I8Source {
  using Elem = int8_t;
  template <int NP>  // pieces per thread: BKV * W4 / 4 / THREADS <= NP
  struct Regs {
    char4 x[NP];
    float s[NP];
  };
  PagedRows rows;
  int Hk;
  template <class R>
  __device__ __forceinline__ void issue(const int8_t* __restrict__ src,
                                        const float* __restrict__ scales, float* dst, int ST,
                                        int W, int b, int h, int j0, int n, bool vec,
                                        R& r) const {
    constexpr int NP = sizeof(R::x) / sizeof(char4);
    if (vec) {
      const int nc = W / 4;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int e = threadIdx.x + THREADS * i;
        r.x[i] = make_char4(0, 0, 0, 0);
        r.s[i] = 0.f;
        if (e < BKV * nc && e / nc < n) {
          int blk;
          const size_t row = rows.row(b, h, j0 + e / nc, blk);
          r.x[i] = *reinterpret_cast<const char4*>(src + row * W + 4 * (e % nc));
          r.s[i] = scales[(size_t)blk * Hk + h];
        }
      }
    } else {
      const int W4 = pad4(W);
      for (int e = threadIdx.x; e < BKV * W4; e += THREADS) {
        const int j = e / W4, d = e % W4;
        float x = 0.f;
        if (j < n && d < W) {
          int blk;
          const size_t row = rows.row(b, h, j0 + j, blk);
          x = static_cast<float>(src[row * W + d]) * scales[(size_t)blk * Hk + h];
        }
        dst[j * ST + d] = x;
      }
    }
  }
  template <class R>
  __device__ __forceinline__ void land(float* dst, int ST, int W, bool vec, R& r) const {
    constexpr int NP = sizeof(R::x) / sizeof(char4);
    if (!vec) return;
    const int nc = W / 4;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int e = threadIdx.x + THREADS * i;
      if (e < BKV * nc) {
        const float s = r.s[i];
        *reinterpret_cast<float4*>(dst + (e / nc) * ST + 4 * (e % nc)) =
            make_float4(static_cast<float>(r.x[i].x) * s, static_cast<float>(r.x[i].y) * s,
                        static_cast<float>(r.x[i].z) * s, static_cast<float>(r.x[i].w) * s);
      }
    }
  }
};

__device__ __forceinline__ float group_max(float v) {  // over the 16 lanes of a row
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block (x, y): query tile n_qt - 1 - x / NS, shard x % NS, sequence y / Hk,
// kv head y % Hk.  Row r of the tile is query head h * G + r / BQ at
// position t0 + r % BQ.  acc_ws (NS, R, Dv), m_ws and l_ws (NS, R) with R =
// B * T * Hq rows (b, t, hq); unused (null) when NS = 1.
template <class Src, class Mask, int NV>
__global__ void __launch_bounds__(THREADS, NV == 2 ? 2 : 1)
attention_kernel(const float* __restrict__ q, const typename Src::Elem* __restrict__ k,
                 const typename Src::Elem* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const Src src, const Mask mask,
                 float* __restrict__ o, float* __restrict__ acc_ws, float* __restrict__ m_ws,
                 float* __restrict__ l_ws, int B, int T, int Hq, int Hk, int S, int D, int Dv,
                 int BQ, int shard, int NS, float scale, bool vec) {
  constexpr int NC = BKV / 16;  // score columns per thread; NV float4 groups of Dv: Dv4 <= 64 NV
  extern __shared__ __align__(16) float smem[];
  const int D4 = pad4(D), Dv4 = pad4(Dv), KST = D4 + 4, G = Hq / Hk;
  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x / NS, s = blockIdx.x % NS;
  const int b = blockIdx.y / Hk, h = blockIdx.y % Hk;
  const int t0 = qt * BQ, nq = min(BQ, T - t0);
  const int pos0 = mask.pos0(b, t0);
  // the columns any row of the tile may see, within this shard, from the
  // aligned tile holding the first
  const int c_begin = max(s * shard, mask.lo(pos0) / BKV * BKV);
  const int c_end = min(min(S, (s + 1) * shard), mask.hi(pos0 + nq - 1, S) + 1);
  if (s > 0 && c_begin >= c_end) return;  // block-uniform; shard 0 writes the empty rows

  float* qs = smem;
  float* ks = qs + BR * D4;
  float* vs = ks + BKV * KST;
  float* ps = vs + BKV * Dv4;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  int lo[RPT], hi[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i, tq = r % BQ;
    const bool valid = r / BQ < G && tq < nq;
    lo[i] = valid ? mask.lo(pos0 + tq) : 1;
    hi[i] = valid ? mask.hi(pos0 + tq, S) : 0;
  }
  // Q by cp.async with the first K tile, then each thread scales the
  // pieces it copied (its own copies are visible to it after the wait)
  const size_t q_row0 = ((size_t)b * T + t0) * Hq + (size_t)h * G;  // row (t0, head 0)
  auto q_src = [&](int r) { return q + (q_row0 + (size_t)(r % BQ) * Hq + r / BQ) * D; };
  if (vec) {
    for (int e = tid; e < BR * D4 / 4; e += THREADS) {
      const int r = e / (D4 / 4), c = 4 * (e % (D4 / 4));
      const bool ok = r / BQ < G && r % BQ < nq;
      repro_torch::cp_async16(qs + r * D4 + c, ok ? q_src(r) + c : q, ok);
    }
  } else {
    for (int e = tid; e < BR * D4; e += THREADS) {
      const int r = e / D4, d = e % D4;
      const bool ok = r / BQ < G && r % BQ < nq && d < D;
      repro_torch::cp_async4(qs + e, ok ? q_src(r) + d : q, ok);
    }
  }

  float m[RPT], l[RPT];
  float4 acc[RPT][NV];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int w = 0; w < NV; ++w) acc[i][w] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  typename Src::template Regs<4 * NV> regs;  // widths <= 64 NV: 4 NV int8 pieces a thread
  const int n_tiles = c_begin < c_end ? (c_end - c_begin + BKV - 1) / BKV : 0;
  if (n_tiles > 0)
    src.issue(k, k_scale, ks, KST, D, b, h, c_begin, min(BKV, c_end - c_begin),
                            vec, regs);
  repro_torch::cp_async_commit();
  repro_torch::cp_async_wait<0>();
  if (vec) {  // the pieces this thread copied
    for (int e = tid; e < BR * D4 / 4; e += THREADS) {
      float4* x = reinterpret_cast<float4*>(qs) + e;
      x->x *= scale, x->y *= scale, x->z *= scale, x->w *= scale;
    }
  } else {
    for (int e = tid; e < BR * D4; e += THREADS) qs[e] *= scale;
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = c_begin + it * BKV, n = min(BKV, c_end - j0);
    src.land(ks, KST, D, vec, regs);
    repro_torch::cp_async_wait<0>();
    __syncthreads();  // K of this tile (and Q) visible; P.V of the last tile done: V, P free
    src.issue(v, v_scale, vs, Dv4, Dv, b, h, j0, n, vec, regs);
    repro_torch::cp_async_commit();

    float sc[RPT][NC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      float4 qv[RPT], kv[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * D4 + d);
#pragma unroll
      for (int j = 0; j < NC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * KST + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bool ok[NC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + 16 * j, col = j0 + c;
        ok[j] = c < n && col >= lo[i] && col <= hi[i];
        sc[i][j] = ok[j] ? sc[i][j] : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * BKV + tx + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        acc[i][w].x *= alpha;
        acc[i][w].y *= alpha;
        acc[i][w].z *= alpha;
        acc[i][w].w *= alpha;
      }
    }
    src.land(vs, Dv4, Dv, vec, regs);
    repro_torch::cp_async_wait<0>();
    __syncthreads();  // P and V visible; Q.K^T done: K free
    if (it + 1 < n_tiles)
      src.issue(k, k_scale, ks, KST, D, b, h, j0 + BKV,
                              min(BKV, c_end - j0 - BKV), vec, regs);
    repro_torch::cp_async_commit();

    // columns >= n have p = 0 and add nothing: the loop stops at n
    for (int c4 = 0; c4 < n; c4 += 4) {
      float p[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * BKV + c4);
        p[i][0] = x.x, p[i][1] = x.y, p[i][2] = x.z, p[i][3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          const int gi = tx + 16 * w;
          if (4 * gi < Dv4) {
            const float4 x = *reinterpret_cast<const float4*>(vs + (c4 + cc) * Dv4 + 4 * gi);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              acc[i][w].x = fmaf(p[i][cc], x.x, acc[i][w].x);
              acc[i][w].y = fmaf(p[i][cc], x.y, acc[i][w].y);
              acc[i][w].z = fmaf(p[i][cc], x.z, acc[i][w].z);
              acc[i][w].w = fmaf(p[i][cc], x.w, acc[i][w].w);
            }
          }
        }
      }
    }
  }
  repro_torch::cp_async_wait<0>();

  const size_t R = (size_t)B * T * Hq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i, g = r / BQ, tq = r % BQ;
    if (g >= G || tq >= nq) continue;
    // the shards this row's columns span; a row that sees nothing is
    // written (as 0) by shard 0
    const int s_lo = lo[i] <= hi[i] ? lo[i] / shard : 0;
    const int s_hi = lo[i] <= hi[i] ? hi[i] / shard : 0;
    if (s < s_lo || s > s_hi) continue;
    const size_t row = ((size_t)b * T + t0 + tq) * Hq + (size_t)h * G + g;
    const bool direct = s_lo == s_hi;
    float* dst = direct ? o + row * Dv : acc_ws + ((size_t)s * R + row) * Dv;
    const float lsum = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int w = 0; w < NV; ++w) {
      const int d = 4 * (tx + 16 * w);
      const float x[4] = {acc[i][w].x, acc[i][w].y, acc[i][w].z, acc[i][w].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < Dv) dst[d + e] = direct ? x[e] / lsum : x[e];
    }
    if (!direct && tx == 0) {
      m_ws[(size_t)s * R + row] = m[i];
      l_ws[(size_t)s * R + row] = l[i];
    }
  }
}

// One warp per row of the R = B * T * Hq rows whose columns span more than
// one shard: the partials of its shards s_lo .. s_hi merged in shard order
// as combine_partials_f32 (flash_decode.cu) merges all of them — max of m,
// then l and acc summed with weights exp(m_i - m), out = acc / max(l,
// 1e-30).  The shards outside s_lo .. s_hi hold nothing of the row (acc 0,
// m -1e30, l 0: weight 0) and are not read.  TO: o's type.
template <class Mask, typename TO>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ acc_ws, const float* __restrict__ m_ws,
               const float* __restrict__ l_ws, const Mask mask, TO* __restrict__ o, int R,
               int T, int Hq, int S, int Dv, int shard) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const int t = (row / Hq) % T, b = row / Hq / T;
  const int pos = mask.pos0(b, t), lo = mask.lo(pos), hi = mask.hi(pos, S);
  if (lo > hi || lo / shard == hi / shard) return;  // written by the attention kernel
  const int s_lo = lo / shard, s_hi = hi / shard;
  float mm = m_ws[(size_t)s_lo * R + row];
  for (int s = s_lo + 1; s <= s_hi; ++s) mm = fmaxf(mm, m_ws[(size_t)s * R + row]);
  float w[MAX_SHARDS];
  float ls = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_SHARDS; ++s) {
    w[s] = 0.f;
    if (s >= s_lo && s <= s_hi) {
      w[s] = expf(m_ws[(size_t)s * R + row] - mm);
      ls = ls + l_ws[(size_t)s * R + row] * w[s];
    }
  }
  ls = fmaxf(ls, 1e-30f);
  for (int d = lane; d < Dv; d += 32) {
    float x = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SHARDS; ++s)
      if (s >= s_lo && s <= s_hi) x = x + acc_ws[((size_t)s * R + row) * Dv + d] * w[s];
    o[(size_t)row * Dv + d] = repro_torch::from_f32<TO>(x / ls);
  }
}

template <class Src, class Mask, int NV>
int run(const float* q, const typename Src::Elem* k, const typename Src::Elem* v,
        const float* k_scale, const float* v_scale, const Src& src, const Mask& mask, float* o,
        float* acc, float* m, float* l, int B, int T, int Hq, int Hk, int S, int D, int Dv,
        int BQ, int shard, int NS, float scale, bool vec, cudaStream_t stream) {
  const size_t smem = attn_smem_floats(D, Dv) * sizeof(float);
  auto kernel = attention_kernel<Src, Mask, NV>;
  static int smem_set[repro_torch::kMaxDevices];
  cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((T + BQ - 1) / BQ) * NS, B * Hk);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, k_scale, v_scale, src, mask, o, acc, m, l, B,
                                          T, Hq, Hk, S, D, Dv, BQ, shard, NS, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS == 1) return static_cast<int>(err);
  const int R = B * T * Hq, rows_per_block = THREADS / 32;
  combine_kernel<Mask, float>
      <<<(R + rows_per_block - 1) / rows_per_block, THREADS, 0, stream>>>(
          acc, m, l, mask, o, R, T, Hq, S, Dv, shard);
  return static_cast<int>(cudaGetLastError());
}

// The shapes both bodies take (whole GQA groups of at most BR heads, D and
// Dv <= 256, shards of whole tiles, at most MAX_SHARDS of them, and the
// partials' workspace `ws` where there are several): the positions a tile
// holds, BQ = BR / G rounded up to a power of 2; 0 for a shape refused.
int tile_positions(int B, int T, int Hq, int Hk, int S, int D, int Dv, int shard, bool ws) {
  if (B < 1 || T < 1 || Hk < 1 || Hq % Hk || Hq / Hk > BR || D < 1 || Dv < 1 || D > 256 ||
      Dv > 256 || S < 1 || shard < 64 || shard % 64 || B * Hk > 65535)
    return 0;
  const int NS = (S + shard - 1) / shard;
  if (NS > MAX_SHARDS || (NS > 1 && !ws)) return 0;
  int gp = 1;
  while (gp < Hq / Hk) gp *= 2;
  return BR / gp;
}

// Checks the shapes, then runs the instance for the widths.  acc, m and l:
// the workspace of the shards' partials (see attention_kernel), null when
// S <= shard.
template <class Src, class Mask>
int launch(const float* q, const typename Src::Elem* k, const typename Src::Elem* v,
           const float* k_scale, const float* v_scale, const Src& src, const Mask& mask,
           float* o, float* acc, float* m, float* l, int B, int T, int Hq, int Hk, int S, int D,
           int Dv, int shard, float scale, void* stream) {
  const int BQ = tile_positions(B, T, Hq, Hk, S, D, Dv, shard, acc && m && l);
  if (BQ == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int NS = (S + shard - 1) / shard;
  const size_t al = sizeof(typename Src::Elem) == 1 ? 4 : 16;
  const bool vec = D % 4 == 0 && Dv % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % al == 0 &&
                   reinterpret_cast<uintptr_t>(v) % al == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pad4(D) <= WIDE && pad4(Dv) <= WIDE)
    return run<Src, Mask, 2>(q, k, v, k_scale, v_scale, src, mask, o, acc, m, l, B, T, Hq, Hk, S,
                             D, Dv, BQ, shard, NS, scale, vec, st);
  return run<Src, Mask, 4>(q, k, v, k_scale, v_scale, src, mask, o, acc, m, l, B, T, Hq, Hk, S,
                           D, Dv, BQ, shard, NS, scale, vec, st);
}

// ------------------------------------------------- bf16, on the tensor cores --
using repro_torch::bf16;
using namespace repro_torch::hopper;

constexpr int TC_THREADS = 128;          // one warpgroup
constexpr int TC_PANEL = 64 * 64 * 2;    // bytes of a [64 rows][64 values] bf16 panel

__host__ __device__ inline int panels64(int w) { return (w + 63) / 64; }

// Bytes of dynamic shared memory of the bf16 body: Q and K (pad64(D) / 64
// panels each), V (pad64(Dv) / 64), and the slack to align them to 1024
// (the swizzle's period).
__host__ __device__ inline size_t tc_smem_bytes(int D, int Dv) {
  return 1024 + (size_t)TC_PANEL * (2 * panels64(D) + panels64(Dv));
}

// Rows 0 .. n - 1 of a tile of rows of W values into NP panels at offset
// `at` of the 1024-aligned base: row(j) is tile row j's first value, or
// null for a row left zero; rows >= n and values >= W are zero.  Thread t
// copies 16-byte chunk t % 8 of rows t / 8 + 16 i: by cp.async with `vec`
// (W % 8 == 0, rows 16-byte aligned), else value by value.  x: any mapped
// address, the source of the copies that only zero.
template <class RowPtr>
__device__ __forceinline__ void stage_rows(unsigned char* gbase, uint32_t at, int NP, int W,
                                           int n, bool vec, const bf16* x, RowPtr row) {
  const int cc = threadIdx.x % 8, r0 = threadIdx.x / 8;
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = r0 + 16 * i, d = 64 * p + 8 * cc;
      const bf16* src = j < n ? row(j) : nullptr;
      const uint32_t dst = swz128(at + TC_PANEL * p + 128 * j + 16 * cc);
      if (vec) {
        const bool ok = src != nullptr && d < W;
        repro_torch::cp_async16(gbase + dst, ok ? src + d : x, ok);
      } else {
        const unsigned short* u16 = reinterpret_cast<const unsigned short*>(src);
        uint32_t e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = src != nullptr && d + u < W ? u16[d + u] : 0u;
        *reinterpret_cast<uint4*>(gbase + dst) =
            make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
      }
    }
  }
}

// Block (x, y) as attention_kernel's (query tile n_qt - 1 - x / NS, shard x
// % NS, sequence y / Hk, kv head y % Hk; row r of the tile is query head h
// * G + r / BQ at position t0 + r % BQ); NV = pad64(Dv) / 64.  Thread
// (warp w, lane l) holds rows 16 w + l / 4 + 8 hr (hr = 0, 1) of S and O:
// element 4 c + 2 hr + e of a 64-column accumulator is column 8 c + 2 (l %
// 4) + e.
template <int NV>
__global__ void __launch_bounds__(TC_THREADS)
attention_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const StaticWindow mask, bf16* __restrict__ o,
                       float* __restrict__ acc_ws, float* __restrict__ m_ws,
                       float* __restrict__ l_ws, int B, int T, int Hq, int Hk, int S, int D,
                       int Dv, int BQ, int shard, int NS, float scale, bool vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const int NPD = panels64(D), G = Hq / Hk;
  const uint32_t k_at = TC_PANEL * NPD, v_at = 2 * TC_PANEL * NPD;  // Q at 0

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x / NS, s = blockIdx.x % NS;
  const int b = blockIdx.y / Hk, h = blockIdx.y % Hk;
  const int t0 = qt * BQ, nq = min(BQ, T - t0);
  const int pos0 = mask.pos0(b, t0);
  const int c_begin = max(s * shard, mask.lo(pos0) / BKV * BKV);
  const int c_end = min(min(S, (s + 1) * shard), mask.hi(pos0 + nq - 1, S) + 1);
  if (s > 0 && c_begin >= c_end) return;  // block-uniform; shard 0 writes the empty rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int lo[2], hi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * warp + lane / 4 + 8 * hr, tq = r % BQ;
    const bool valid = r / BQ < G && tq < nq;
    lo[hr] = valid ? mask.lo(pos0 + tq) : 1;
    hi[hr] = valid ? mask.hi(pos0 + tq, S) : 0;
  }

  // Q (rows past the group or the sequence zero) and the first tile
  const size_t q_row0 = ((size_t)b * T + t0) * Hq + (size_t)h * G;  // row (t0, head 0)
  stage_rows(gbase, 0, NPD, D, BR, vec, q, [&](int r) {
    const bool ok = r / BQ < G && r % BQ < nq;
    return ok ? q + (q_row0 + (size_t)(r % BQ) * Hq + r / BQ) * D : nullptr;
  });
  auto k_row = [&](int j0) {
    return [=](int j) { return k + (((size_t)b * S + j0 + j) * Hk + h) * D; };
  };
  auto v_row = [&](int j0) {
    return [=](int j) { return v + (((size_t)b * S + j0 + j) * Hk + h) * Dv; };
  };
  const int n_tiles = c_begin < c_end ? (c_end - c_begin + BKV - 1) / BKV : 0;
  if (n_tiles > 0)
    stage_rows(gbase, k_at, NPD, D, min(BKV, c_end - c_begin), vec, k, k_row(c_begin));
  repro_torch::cp_async_commit();

  float acc[NV][32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  }
  const int n_k16 = (D + 15) / 16;
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = c_begin + it * BKV, n = min(BKV, c_end - j0);
    repro_torch::cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // K of this tile (and Q) visible to wgmma; P V of the last done: V free
    stage_rows(gbase, v_at, NV, Dv, n, vec, v, v_row(j0));
    repro_torch::cp_async_commit();

    // S = Q K^T over D's 16-deep chunks from 0 (32 bytes on in a panel's row)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    for (int kd = 0; kd < n_k16; ++kd) {
      const uint32_t off = TC_PANEL * (kd / 4) + 32 * (kd % 4);
      wgmma_m64n64k16<0>(sc, smem_desc(base + off, 16, 1024),
                         smem_desc(base + k_at + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncthreads();  // Q K^T done in every warp: K free
    if (it + 1 < n_tiles)
      stage_rows(gbase, k_at, NPD, D, min(BKV, c_end - j0 - BKV), vec, k, k_row(j0 + BKV));
    repro_torch::cp_async_commit();

    // softmax: sc becomes p (0 where masked), O rescaled; the columns of
    // the tile a row sees are clo .. chi (none when clo > chi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int clo = max(lo[hr] - j0, 0), chi = min(hi[hr] - j0, n - 1);
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * hr + e, col = 8 * c + 2 * (lane % 4) + e;
          sc[i] = col >= clo && col <= chi ? sc[i] * scale : kNegInf;
          mx = fmaxf(mx, sc[i]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * hr + e, col = 8 * c + 2 * (lane % 4) + e;
          sc[i] = col >= clo && col <= chi ? __expf(sc[i] - m_new) : 0.f;
          sum += sc[i];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m[hr] - m_new);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[j][4 * c + 2 * hr] *= alpha;
          acc[j][4 * c + 2 * hr + 1] *= alpha;
        }
      }
    }
    // P = hi + lo, both bf16, as wgmma's register A: columns 16 kk .. 16 kk
    // + 15 are sc[8 kk .. 8 kk + 7]
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p0 = sc[8 * kk + 2 * x], p1 = sc[8 * kk + 2 * x + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 l2 =
            __floats2bfloat162_rn(p0 - __low2float(h2), p1 - __high2float(h2));
        ph[kk][x] = *reinterpret_cast<const uint32_t*>(&h2);
        pl[kk][x] = *reinterpret_cast<const uint32_t*>(&l2);
      }
    }
    repro_torch::cp_async_wait<1>();  // V of this tile (K of the next may be in flight)
    fence_proxy_async();
    __syncthreads();  // V of this tile visible to wgmma
    // O += P_hi V, then P_lo V, for each 16-column chunk in order: V's
    // [64 columns][64 values] panels N-major, 16 rows (2048 bytes) a chunk
#pragma unroll
    for (int j = 0; j < NV; ++j) fence_regs(acc[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = smem_desc(base + v_at + TC_PANEL * j + 2048 * kk, TC_PANEL, 1024);
        wgmma_m64n64k16_rs<1>(acc[j], ph[kk], dv);
        wgmma_m64n64k16_rs<1>(acc[j], pl[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NV; ++j) fence_regs(acc[j]);
  }
  repro_torch::cp_async_wait<0>();

  const size_t R = (size_t)B * T * Hq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * warp + lane / 4 + 8 * hr, g = r / BQ, tq = r % BQ;
    if (g >= G || tq >= nq) continue;
    // the shards this row's columns span; a row that sees nothing is
    // written (as 0) by shard 0
    const int s_lo = lo[hr] <= hi[hr] ? lo[hr] / shard : 0;
    const int s_hi = lo[hr] <= hi[hr] ? hi[hr] / shard : 0;
    if (s < s_lo || s > s_hi) continue;
    const size_t row = ((size_t)b * T + t0 + tq) * Hq + (size_t)h * G + g;
    const bool direct = s_lo == s_hi;
    bf16* out = o + row * Dv;
    float* part = direct ? nullptr : acc_ws + ((size_t)s * R + row) * Dv;
    const float lsum = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int d = 64 * j + 8 * c + 2 * (lane % 4);
        const float x0 = acc[j][4 * c + 2 * hr], x1 = acc[j][4 * c + 2 * hr + 1];
        if (d >= Dv) continue;
        if (!direct) {
          part[d] = x0;
          if (d + 1 < Dv) part[d + 1] = x1;
        } else if (d + 1 < Dv && Dv % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(x0 / lsum, x1 / lsum);
        } else {
          out[d] = __float2bfloat16_rn(x0 / lsum);
          if (d + 1 < Dv) out[d + 1] = __float2bfloat16_rn(x1 / lsum);
        }
      }
    }
    if (!direct && lane % 4 == 0) {
      m_ws[(size_t)s * R + row] = m[hr];
      l_ws[(size_t)s * R + row] = l[hr];
    }
  }
}

template <int NV>
int run_bf16(const bf16* q, const bf16* k, const bf16* v, const StaticWindow& mask, bf16* o,
             float* acc, float* m, float* l, int B, int T, int Hq, int Hk, int S, int D, int Dv,
             int BQ, int shard, int NS, float scale, bool vec, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(D, Dv);
  auto kernel = attention_wgmma_kernel<NV>;
  static int smem_set[repro_torch::kMaxDevices];
  cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((T + BQ - 1) / BQ) * NS, B * Hk);
  kernel<<<grid, TC_THREADS, smem, stream>>>(q, k, v, mask, o, acc, m, l, B, T, Hq, Hk, S, D, Dv,
                                             BQ, shard, NS, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS == 1) return static_cast<int>(err);
  const int R = B * T * Hq, rows_per_block = THREADS / 32;
  combine_kernel<StaticWindow, bf16>
      <<<(R + rows_per_block - 1) / rows_per_block, THREADS, 0, stream>>>(
          acc, m, l, mask, o, R, T, Hq, S, Dv, shard);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shapes, then runs the instance for Dv's panels.
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const StaticWindow& mask, bf16* o,
                float* acc, float* m, float* l, int B, int T, int Hq, int Hk, int S, int D, int Dv,
                int shard, float scale, void* stream) {
  const int BQ = tile_positions(B, T, Hq, Hk, S, D, Dv, shard, acc && m && l);
  if (BQ == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int NS = (S + shard - 1) / shard;
  // 16-byte copies of 8 values where the widths allow them and every row
  // starts aligned
  const bool vec = D % 8 == 0 && Dv % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (panels64(Dv)) {
    case 1:
      return run_bf16<1>(q, k, v, mask, o, acc, m, l, B, T, Hq, Hk, S, D, Dv, BQ, shard, NS,
                         scale, vec, st);
    case 2:
      return run_bf16<2>(q, k, v, mask, o, acc, m, l, B, T, Hq, Hk, S, D, Dv, BQ, shard, NS,
                         scale, vec, st);
    case 3:
      return run_bf16<3>(q, k, v, mask, o, acc, m, l, B, T, Hq, Hk, S, D, Dv, BQ, shard, NS,
                         scale, vec, st);
    default:
      return run_bf16<4>(q, k, v, mask, o, acc, m, l, B, T, Hq, Hk, S, D, Dv, BQ, shard, NS,
                         scale, vec, st);
  }
}

}  // namespace

extern "C" int flash_chunk_attention_f32(const float* q, const float* k, const float* v,
                                         const int* start, float* acc, float* m, float* l,
                                         float* o, int B, int T, int Hq, int Hk, int S, int D,
                                         int Dv, int shard, float scale, void* stream) {
  return launch(q, k, v, nullptr, nullptr, F32Source<DenseRows>{DenseRows{S, Hk}},
                OffsetCausal{start}, o, acc, m, l, B, T, Hq, Hk, S, D, Dv, shard, scale, stream);
}

extern "C" int flash_paged_chunk_attention_f32(const float* q, const float* pages_k,
                                               const float* pages_v, const int* tables,
                                               const int* start, float* acc, float* m, float* l,
                                               float* o, int B, int T, int Hq, int Hk, int N,
                                               int P, int MP, int D, int Dv, int shard,
                                               float scale, void* stream) {
  return launch(q, pages_k, pages_v, nullptr, nullptr,
                F32Source<PagedRows>{PagedRows{tables, MP, P, N, Hk}}, OffsetCausal{start}, o,
                acc, m, l, B, T, Hq, Hk, MP * P, D, Dv, shard, scale, stream);
}

extern "C" int flash_paged_chunk_attention_i8(const float* q, const int8_t* pages_k,
                                              const float* k_scales, const int8_t* pages_v,
                                              const float* v_scales, const int* tables,
                                              const int* start, float* acc, float* m, float* l,
                                              float* o, int B, int T, int Hq, int Hk, int N,
                                              int P, int MP, int D, int Dv, int shard,
                                              float scale, void* stream) {
  return launch(q, pages_k, pages_v, k_scales, v_scales,
                I8Source{PagedRows{tables, MP, P, N, Hk}, Hk}, OffsetCausal{start}, o, acc, m,
                l, B, T, Hq, Hk, MP * P, D, Dv, shard, scale, stream);
}

// window <= 0: no window.  T may exceed Skv: rows before position 0 of a
// causal mask see nothing and give 0.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* acc,
                                   float* m, float* l, float* o, int B, int T, int Hq, int Hk,
                                   int Skv, int D, int Dv, int causal, int window, int shard,
                                   float scale, void* stream) {
  return launch(q, k, v, nullptr, nullptr, F32Source<DenseRows>{DenseRows{Skv, Hk}},
                StaticWindow{Skv - T, causal, window}, o, acc, m, l, B, T, Hq, Hk, Skv, D, Dv,
                shard, scale, stream);
}

// bf16 q, k, v and o on the tensor cores (attention_wgmma_kernel); the
// shards' partials fp32.  shard: the wrapper's attention_shard_cols_bf16.
extern "C" int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, float* acc, float* m, float* l,
                                    __nv_bfloat16* o, int B, int T, int Hq, int Hk, int Skv,
                                    int D, int Dv, int causal, int window, int shard,
                                    float scale, void* stream) {
  return launch_bf16(q, k, v, StaticWindow{Skv - T, causal, window}, o, acc, m, l, B, T, Hq, Hk,
                     Skv, D, Dv, shard, scale, stream);
}
