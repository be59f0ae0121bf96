// flash_decode: one-token GQA attention over a KV cache.
//   q (B, Hq, D), lengths (B,) int32 -> o (B, Hq, Dv); cache positions
//   >= lengths[b] are masked.  Every entry point but the narrow bf16 decode
//   runs one fp32 kernel body, decode_shard_kernel, a template over the KV
//   row source:
//   flash_decode_f32        dense k (B, S, Hk, D), v (B, S, Hk, Dv);
//   flash_paged_decode_f32  pages (N, P, Hk, D/Dv) fp32 through block
//                           tables (B, MP);
//   flash_paged_decode_i8   int8 pages with (N, Hk) fp32 scales, dequantized
//                           as float(x) * scale while a tile is staged;
//   these three cut the cache into shards of `shard` rows (the wrapper's
//   decode_shard_rows(S), never a function of B), write each shard's
//   unnormalised partials (acc, m, l) into a workspace the wrapper
//   allocates, and merge them with combine_kernel in shard order;
//   flash_decode_partial_f32  the same body over n_splits shards of
//                           S / n_splits rows, partials out (no combine):
//                           acc (n_splits, B, Hq, Dv), m and l (n_splits,
//                           B, Hq);
//   combine_partials_f32    (acc, m, l) over NS shards -> out, in shard
//                           index order (ref.combine_partials_ref);
//   flash_decode_bf16       bf16 q, k, v and o.  D, Dv <= 256 (every
//                           served head but MLA's): decode_tc_kernel, a body
//                           of its own on the tensor cores, one launch (the
//                           last section of this note).  Wider (MLA's D 576,
//                           Dv 512): flash_decode_f32's wide layout on bf16
//                           rings, q and each staged K/V row upcast as they
//                           are loaded, the partials fp32, the combine
//                           writing o rounded once to bf16
//                           (combine_partials_bf16 alone: the same merge
//                           with a bf16 out);
//   flash_decode_partial_bf16  flash_decode_partial_f32 on bf16 q, k, v
//                           (both layouts), the bf16 rings above, each
//                           shard's acc rounded once to bf16 as it is
//                           written, m and l fp32 (JAX's partial: acc in
//                           q's dtype, m and l float32).
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode (_flash_decode,
// body _decode_kernel with emit_stats=False), behind `decode_attention`
// pallas (ops.py:147), and flash_paged_decode (bodies _paged_decode_kernel
// and _paged_decode_q_kernel), behind `paged_decode_attention[_q]` pallas
// (serving_ops.py:619, :941), and flash_decode_partial (the same body with
// emit_stats=True), behind `decode_attention` pallas_split (ops.py:178-208),
// which calls it once per shard in a Python loop.  decode_tc_kernel
// replaces _decode_kernel (src/repro/kernels/flash_decode.py:148, emit_stats
// False) for bf16 heads up to 256 wide.
//
// What bounds it on the H100: bytes.  Each cache byte is read once per step
// for O(1) flops (about 0.5 flop/byte at Hq = Hk), so its least time is the
// live cache rows over 3.35 TB/s.  Reaching it takes many SMs, each with
// tens of KB of cache rows in flight.
//
// Design:
// - Grid (B * Hk * ceil(G / GM), shards): one 128-thread block per
//   (sequence, kv head, group of up to GM = 8 query heads of that kv head,
//   shard), so K/V are read once per query group and a long sequence is
//   spread over S / shard blocks.  A shard past lengths[b] writes the empty
//   partial (acc 0, m -1e30, l 0) and returns.
// - Each warp walks its own 4-row tiles of the shard (tile t to warp t % 4)
//   with its own online softmax, and stages them through its own ring of
//   NST = 3 slots with 16-byte cp.async copies (4-byte ones when a width is
//   not a multiple of 4 or a pointer not 16-byte aligned): two tiles are in
//   flight while one is scored, and no barrier other than __syncwarp runs
//   inside the loop.  int8 pages are loaded 4 bytes at a time and
//   dequantized into the fp32 slot as they are staged.  At D = Dv = 256 the
//   block takes 104 KB of shared memory, so two blocks fit on an SM.
// - Scores: the lanes split D, each holding float4 groups 4c..4c+3 for
//   c = lane, lane + 32, ... (NCK groups a lane); a lane's products are one
//   FMA chain in that order and warp_sum (a fixed xor butterfly) adds the
//   lanes.  P.V: each lane owns float4 groups of Dv the same way (NCV a
//   lane) and adds the tile's rows in row order into its accumulator after
//   the exp(m_old - m_new) rescale.  Widths are padded to a multiple of 4
//   with zeros in shared memory.
// - Widths: D, Dv <= 256 run with NCK = NCV = NCH = 2 and up to GMAX query
//   heads a block.  The dense entries (flash_decode_f32,
//   flash_decode_partial_f32, flash_decode_bf16) also take the wide layout,
//   D <= 640 and Dv <= 512 (NCK = 5, NCV = 4; MLA's absorbed decode is D
//   576 = latent 512 + rope 64, Dv 512): there a block takes at most
//   WIDE_GMAX = 4 query heads, so the accumulators (WIDE_GMAX x NCV float4)
//   stay in registers, and the block's shared memory (227,328 B at 576 /
//   512 in fp32, 122,880 B with bf16 rings) leaves one block an SM.  The
//   layout is chosen from D and Dv alone, never from B.
// - At the end of the shard the four warps' (acc, m, l) are merged in warp
//   order, then the shards' in shard order (combine_kernel) — the merge of
//   ref.combine_partials_ref: max of m, then l and acc summed with weights
//   exp(m_i - m).  The softmax keeps the Pallas kernel's finite -1e30 and
//   its acc / max(l, 1e-30) finish, so an empty cache (length 0: an idle
//   slot) gives 0.
// - Every order above is fixed by D, Dv, the shard size and a row's
//   position: tiles start at the shard's first row, the shard size is not
//   chosen from B and tiles past a length are skipped, so a sequence's
//   result does not depend on the batch.  No atomics.
//
// Paged: the same rows, located through the block table by common.cuh's
// paged_row (logical column col is row col % P of block table[b, col / P],
// clipped to [0, N-1]); rows past lengths[b] (junk table entries) are never
// loaded.  The score and P.V code
// is the dense code, so an fp32 paged row is bitwise equal to the dense
// kernel's row on the gathered cache.  int8 pages read a quarter of the
// bytes; the bound is then the int8 rows plus the scale sidecars.
//
// Partial (split-KV, flash_decode_partial_f32): shard = S / n_splits, the
// caller's n_splits equal shards, partials out; the bound adds the
// partials, n_splits * B * Hq * (Dv + 2) floats written once.  The bf16
// partial (flash_decode_partial_bf16) is the same body with bf16 rings and
// a bf16 acc: every sum is the fp32 entry's, so its acc is the fp32
// entry's acc on the upcast inputs rounded once and its m and l are the
// fp32 entry's bit for bit; the shard still comes from S and n_splits
// alone.  Its bound: the live rows at 2 bytes a value, the partials at 2
// bytes an acc value and 8 bytes an (m, l) pair.
//
// bf16 on the fp32 body (the wide flash_decode_bf16 and the bf16 partial):
// the ring's slots hold bf16 rows, copied by cp.async (16-byte pieces of 8
// values where D and Dv are multiples of 8 and K, V 16-byte aligned, else
// 2-byte loads and stores) and upcast as a lane reads its groups (8 bytes
// a group of 4); q is upcast as it is staged.  The tiles, groups and every
// sum are the fp32 kernel's, so the output is the fp32 kernel's on the
// upcast inputs, rounded once.  Its bound is the live rows at 2 bytes a
// value.  The wide layout stages its 576- and 512-value rows the same way
// (72 and 64 16-byte pieces a row); each lane upcasts NCK + NCV groups a
// row, which adds live values to a body that already holds WIDE_GMAX x NCV
// float4 accumulators (the registers and spills are in the build's ptxas
// lines).
//
// The narrow bf16 body (flash_decode_bf16 at D, Dv <= 256: decode_tc_kernel
// below).  Bytes bound it as they bound the fp32 body: about 0.5 flop a
// byte at G = 1, far under the H100's 295 flop a byte in bf16.  The fp32
// body on bf16 rings spent its time elsewhere: a 32-lane butterfly a score,
// half the lanes idle at D 64, 64-row shards whose 4-row tiles never filled
// the ring, and a second launch to merge.  This body's answers:
// - The products on the tensor cores, straight from the bf16 ring:
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate), with the group's query
//   heads (up to TC_HEADS = 8; G is 1 or 4 at the served configs) as rows
//   0-7 of the 16-row A tile of Q K^T and rows 8-15 zero, K rows as the
//   8-wide N side (ldmatrix from the row-major ring).  P V runs transposed,
//   O^T = V^T P^T: V^T by ldmatrix.trans is the A tile, 16 Dv columns with
//   every row live, and the scores' registers are the B operand as they
//   stand (a head's 16 keys), so a 16-key tile takes 2 products a 16 Dv
//   columns (hi, lo) and 4 accumulator registers, not 4 and 8.  No upcast
//   staging, no butterfly (a score is one accumulator element; the row max
//   and sum take two xor shuffles within a quad).  mma.sync, not wgmma: a
//   decode has at most 8 query rows, so wgmma's 64-row tile would be 8x
//   padding, and its warpgroup-wide issue and fences buy nothing for a
//   body that bytes bound.  G = 1 wastes 15 of 16 rows too, but the tensor
//   cores have room to spare at this intensity.
// - P = hi + lo, two bf16 products in a fixed order (a bf16 P alone misses
//   BF16_TOL; flash_attention.cu found it), l summed from the fp32 p; the
//   softmax in fp32, in log2 units (scale * log2 e folded into the score).
// - Staging: each warp walks its own 16-row tiles of the shard (tile t to
//   warp t % TC_WARPS), TC_NST = 3 slots a warp by 16-byte cp.async (2-byte
//   loads where D or Dv is off 8 or K, V unaligned; q likewise, in a group of
//   its own ahead of the first tiles), so two tiles are in flight while one
//   is multiplied.  A row is padded to 16 values and 8 more, so ldmatrix's
//   8 rows fall in 8 bank groups.  Rows past the length are zero-filled
//   (their p is 0, and 0 x a stale NaN would not be).
// - Shards and the merge in one launch: decode_plan_bf16 (Python) cuts the
//   cache into up to TC_CLUSTER shards of whole tiles, fewer where a
//   sequence has many kv heads (a block's fixed cost: q, the merges and the
//   barriers); the blocks of a (sequence, kv head, group) form one thread-
//   block cluster.  Each block merges its warps in warp order into a
//   partial in shared memory; the cluster's blocks then read each other's
//   partials through distributed shared memory and merge them in rank
//   (shard) order, each block writing a slice of the output, rounded once.
//   No workspace, no second launch, no atomics.
// - One order for every row: a sequence's tiles start at its shard's first
//   row in absolute positions, the shard plan reads S and the head counts,
//   never B, and every sum's order is fixed by D, Dv and the plan, so a row
//   of a batch-4 call is bitwise the batch-1 call; its bits are not the
//   fp32 body's rounded (the tensor cores sum each 16-deep chunk their own
//   way), so it is held to its plain version within one bf16 ulp instead.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using repro_torch::DenseRows;
using repro_torch::PagedRows;
using repro_torch::pad4;

constexpr int THREADS = 128, NWARPS = THREADS / 32;
constexpr int ROWS = 4;  // rows per warp tile
constexpr int NST = 3;   // ring slots per warp
constexpr int GMAX = 8;  // query heads per block
constexpr int NCH = 2;   // float4 groups per lane: D, Dv <= 32 * 4 * NCH = 256
// the wide layout of the dense entries: D <= 32 * 4 * WIDE_NCK = 640, Dv <=
// 32 * 4 * WIDE_NCV = 512, at most WIDE_GMAX query heads a block
constexpr int WIDE_NCK = 5, WIDE_NCV = 4, WIDE_GMAX = 4;

// floats of dynamic shared memory: q [GMAX][D4], then each warp's ring of
// NST slots of ROWS K rows [D4] and ROWS V rows [Dv4].  After the loop the
// rings hold the warps' (m, l, acc) for the merge.
__host__ __device__ inline size_t decode_smem_floats(int D, int Dv) {
  return (size_t)GMAX * pad4(D) + (size_t)NWARPS * NST * ROWS * (pad4(D) + pad4(Dv));
}

// Bytes of the same for bf16 rings: q [GMAX][D4] fp32, the rings in bf16,
// or the warps' partials of the merge (fp32, [NWARPS][GMAX] m and l and
// [NWARPS][GMAX][Dv4] acc) where those take more.
__host__ __device__ inline size_t decode_smem_bytes_bf16(int D, int Dv) {
  const size_t ring = 2 * (size_t)NWARPS * NST * ROWS * (pad4(D) + pad4(Dv));
  const size_t merge = 4 * (size_t)NWARPS * GMAX * (2 + pad4(Dv));
  return 4 * (size_t)GMAX * pad4(D) + (ring > merge ? ring : merge);
}

// One row of width W (padded to W4) from src (its first element) into dst,
// by the warp's lanes: fp32 with cp.async (16-byte pieces when `vec`),
// int8 with 4-byte loads dequantized as float(x) * s.  Pad columns get 0.
__device__ __forceinline__ void stage_row(float* dst, const float* src, float, int W, int W4,
                                          bool vec, int lane) {
  if (vec) {
    for (int c = lane; c < W / 4; c += 32) repro_torch::cp_async16(dst + 4 * c, src + 4 * c);
  } else {
    for (int d = lane; d < W4; d += 32) {
      if (d < W)
        repro_torch::cp_async4(dst + d, src + d);
      else
        dst[d] = 0.f;
    }
  }
}

__device__ __forceinline__ void stage_row(repro_torch::bf16* dst, const repro_torch::bf16* src,
                                          float, int W, int W4, bool vec, int lane) {
  if (vec) {
    for (int c = lane; c < W / 8; c += 32) repro_torch::cp_async16(dst + 8 * c, src + 8 * c);
  } else {
    for (int d = lane; d < W4; d += 32) repro_torch::copy1(dst + d, src + d, d < W);
  }
}

__device__ __forceinline__ void stage_row(float* dst, const int8_t* src, float s, int W, int W4,
                                          bool vec, int lane) {
  if (vec) {
    for (int c = lane; c < W / 4; c += 32) {
      const char4 x = *reinterpret_cast<const char4*>(src + 4 * c);
      *reinterpret_cast<float4*>(dst + 4 * c) =
          make_float4(static_cast<float>(x.x) * s, static_cast<float>(x.y) * s,
                      static_cast<float>(x.z) * s, static_cast<float>(x.w) * s);
    }
  } else {
    for (int d = lane; d < W4; d += 32) dst[d] = d < W ? static_cast<float>(src[d]) * s : 0.f;
  }
}

__device__ __forceinline__ void fma4(float p, const float4& v, float4& a) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// Block (x, i): rows [i * shard, (i + 1) * shard) of the sequence, the
// query heads g0 .. g0 + gn - 1 of kv head h; writes rows (i, b, h * G + g0
// + g) of the (shards, B, Hq) partials.  GM is a compile-time bound on gn
// (1, 2, 4 or 8), so the accumulators stay in registers; NCK and NCV are the
// float4 groups a lane holds of a K row and of a V row.  TQ: q's type
// (fp32, or bf16 with bf16 K/V); T: K/V's (fp32, bf16 or int8); the ring
// holds T's rows as fp32 (fp32, int8 dequantized) or bf16.  TA: the
// partial acc's type (fp32; bf16 rounded once for flash_decode_partial_bf16).
template <class Rows, typename TQ, typename T, typename TA, int GM, int NCK, int NCV>
__global__ void __launch_bounds__(THREADS, 2)
decode_shard_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const Rows rows,
                    const int* __restrict__ lengths, TA* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int B, int Hq,
                    int Hk, int S, int D, int Dv, int shard, float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int G = Hq / Hk, n_grp = (G + GM - 1) / GM;
  const int bh = blockIdx.x / n_grp, g0 = (blockIdx.x % n_grp) * GM;
  const int b = bh / Hk, h = bh % Hk, gn = min(GM, G - g0);
  const int row0 = blockIdx.y * shard;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int D4 = pad4(D), Dv4 = pad4(Dv);
  const size_t out_row = ((size_t)blockIdx.y * B + b) * Hq + (size_t)h * G + g0;

  const int len = min(max(min(max(lengths[b], 0), S) - row0, 0), shard);
  if (len == 0) {  // block-uniform
    for (int i = tid; i < gn * Dv; i += THREADS)
      acc_out[out_row * Dv + i] = repro_torch::from_f32<TA>(0.f);
    for (int g = tid; g < gn; g += THREADS) {
      m_out[out_row + g] = repro_torch::kNegInf;
      l_out[out_row + g] = 0.f;
    }
    return;
  }

  float* qs = smem;  // [GMAX][D4], pre-scaled, zero past D and gn
  const size_t q_base = ((size_t)b * Hq + (size_t)h * G + g0) * D;
  for (int i = tid; i < GM * D4; i += THREADS) {
    const int g = i / D4, d = i % D4;
    qs[i] = (g < gn && d < D) ? repro_torch::to_f32(q[q_base + (size_t)g * D + d]) * scale
                              : 0.f;
  }
  __syncthreads();

  using TS = typename std::conditional<std::is_same<T, repro_torch::bf16>::value,
                                       repro_torch::bf16, float>::type;
  const int slot_elems = ROWS * (D4 + Dv4);
  TS* ring = reinterpret_cast<TS*>(smem + GMAX * D4) + (size_t)warp * NST * slot_elems;
  const int n_tiles = (len + ROWS - 1) / ROWS;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + NWARPS - 1) / NWARPS : 0;

  // stage this warp's i-th tile (tile warp + NWARPS * i) into slot i % NST
  auto stage = [&](int i) {
    const int j0 = (warp + NWARPS * i) * ROWS, n = min(ROWS, len - j0);
    TS* ks = ring + (i % NST) * slot_elems;
    TS* vs = ks + ROWS * D4;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < n) {
        int blk;
        const size_t row = rows.row(b, h, row0 + j0 + r, blk);
        float sk = 1.f, sv = 1.f;
        if constexpr (sizeof(T) == 1) {
          sk = k_scale[(size_t)blk * Hk + h];
          sv = v_scale[(size_t)blk * Hk + h];
        }
        stage_row(ks + r * D4, k + row * D, sk, D, D4, vec, lane);
        stage_row(vs + r * Dv4, v + row * Dv, sv, Dv, Dv4, vec, lane);
      }
    }
  };

  float m[GM], l[GM];
  float4 acc[GM][NCV];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = repro_torch::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NCV; ++c) acc[g][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int nk = D4 / 4, nv = Dv4 / 4;  // float4 groups of a K row and a V row

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < my_tiles) stage(s);
    repro_torch::cp_async_commit();
  }
  for (int i = 0; i < my_tiles; ++i) {
    if (i + NST - 1 < my_tiles) stage(i + NST - 1);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<NST - 1>();
    __syncwarp();

    const int n = min(ROWS, len - (warp + NWARPS * i) * ROWS);
    const TS* ks = ring + (i % NST) * slot_elems;
    const TS* vs = ks + ROWS * D4;
    float p[GM][ROWS];  // scores, then probabilities
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float4 kr[NCK];
#pragma unroll
      for (int c = 0; c < NCK; ++c) {
        const int cc = lane + 32 * c;
        kr[c] = (r < n && cc < nk) ? repro_torch::load4f(ks + r * D4 + 4 * cc)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < NCK; ++c) {
          const int cc = lane + 32 * c;
          if (cc < nk) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D4 + 4 * cc);
            part = fmaf(qv.x, kr[c].x, part);
            part = fmaf(qv.y, kr[c].y, part);
            part = fmaf(qv.z, kr[c].z, part);
            part = fmaf(qv.w, kr[c].w, part);
          }
        }
        const float sum = repro_torch::warp_sum(part);
        p[g][r] = r < n ? sum : repro_torch::kNegInf;
      }
    }

    float alpha[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = p[g][0];
#pragma unroll
      for (int r = 1; r < ROWS; ++r) mx = fmaxf(mx, p[g][r]);
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        p[g][r] = r < n ? expf(p[g][r] - m_new) : 0.f;
        sum += p[g][r];
      }
      alpha[g] = expf(m[g] - m_new);
      l[g] = l[g] * alpha[g] + sum;
      m[g] = m_new;
    }
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
      const int cc = lane + 32 * c;
      if (cc < nv) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          acc[g][c].x *= alpha[g];
          acc[g][c].y *= alpha[g];
          acc[g][c].z *= alpha[g];
          acc[g][c].w *= alpha[g];
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < n) {
            const float4 vv = repro_torch::load4f(vs + r * Dv4 + 4 * cc);
#pragma unroll
            for (int g = 0; g < GM; ++g) fma4(p[g][r], vv, acc[g][c]);
          }
        }
      }
    }
    __syncwarp();  // slot i % NST is staged again in the next iteration
  }
  repro_torch::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the rings: reuse them

  // the warps' partials: [NWARPS][GM] m, [NWARPS][GM] l, [NWARPS][GM][Dv4] acc
  float* wm = smem + GMAX * D4;
  float* wl = wm + NWARPS * GM;
  float* wacc = wl + NWARPS * GM;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      wm[warp * GM + g] = m[g];
      wl[warp * GM + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
      const int cc = lane + 32 * c;
      if (cc < nv) *reinterpret_cast<float4*>(wacc + ((size_t)warp * GM + g) * Dv4 + 4 * cc) =
          acc[g][c];
    }
  __syncthreads();

  for (int i = tid; i < gn * Dv; i += THREADS) {
    const int g = i / Dv, d = i % Dv;
    float mm = wm[g];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) mm = fmaxf(mm, wm[w * GM + g]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float a = expf(wm[w * GM + g] - mm);
      ls = ls + wl[w * GM + g] * a;
      o = o + wacc[((size_t)w * GM + g) * Dv4 + d] * a;
    }
    acc_out[(out_row + g) * Dv + d] = repro_torch::from_f32<TA>(o);
    if (d == 0) {
      m_out[out_row + g] = mm;
      l_out[out_row + g] = ls;
    }
  }
}

// Block `row` of the R = B * Hq rows: the NS shards' weights exp(m_i - m)
// once into shared memory, then out[row, d] = sum_i acc_i[d] * w_i /
// max(sum_i l_i * w_i, 1e-30), every sum in shard order; TO: out's type
// (fp32, or bf16 rounded once).
template <typename TO>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
               const float* __restrict__ l, TO* __restrict__ out, int NS, int R, int Dv) {
  extern __shared__ float w[];  // [NS] weights
  __shared__ float l_sum;
  const int row = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    float mm = m[row];
    for (int i = 1; i < NS; ++i) mm = fmaxf(mm, m[(size_t)i * R + row]);
    float ls = 0.f;
    for (int i = 0; i < NS; ++i) {
      const float a = expf(m[(size_t)i * R + row] - mm);
      w[i] = a;
      ls = ls + l[(size_t)i * R + row] * a;
    }
    l_sum = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  for (int d = tid; d < Dv; d += THREADS) {
    float o = 0.f;
#pragma unroll 8
    for (int i = 0; i < NS; ++i) o = o + acc[((size_t)i * R + row) * Dv + d] * w[i];
    out[(size_t)row * Dv + d] = repro_torch::from_f32<TO>(o / l_sum);
  }
}

template <typename TO>
int combine(const float* acc, const float* m, const float* l, TO* out, int NS, int R, int Dv,
            cudaStream_t stream) {
  const size_t smem = (size_t)NS * sizeof(float);
  if (NS < 1 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  combine_kernel<TO><<<R, THREADS, smem, stream>>>(acc, m, l, out, NS, R, Dv);
  return static_cast<int>(cudaGetLastError());
}

template <class Rows, typename TQ, typename T, typename TA, int GM, int NCK, int NCV>
int launch_shards_gm(const TQ* q, const T* k, const T* v, const float* k_scale,
                     const float* v_scale, const Rows& rows, const int* lengths, TA* acc,
                     float* m, float* l, int B, int Hq, int Hk, int S, int D, int Dv, int shard,
                     float scale, bool vec, cudaStream_t stream) {
  const size_t smem = std::is_same<T, repro_torch::bf16>::value
                          ? decode_smem_bytes_bf16(D, Dv)
                          : decode_smem_floats(D, Dv) * sizeof(float);
  auto kernel = decode_shard_kernel<Rows, TQ, T, TA, GM, NCK, NCV>;
  static int smem_set[repro_torch::kMaxDevices];
  const cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = Hq / Hk;
  const dim3 grid(B * Hk * ((G + GM - 1) / GM), (S + shard - 1) / shard);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, k_scale, v_scale, rows, lengths, acc, m, l, B,
                                          Hq, Hk, S, D, Dv, shard, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// The shard kernel over shards of `shard` rows; partials (ceil(S / shard), B,
// Hq[, Dv]) into acc, m, l.  D, Dv <= 256 take the narrow layout; wider
// heads (dense fp32 or bf16 rows only) the wide one.
template <class Rows, typename TQ, typename T, typename TA>
int launch_shards(const TQ* q, const T* k, const T* v, const float* k_scale,
                  const float* v_scale, const Rows& rows, const int* lengths, TA* acc,
                  float* m, float* l, int B, int Hq, int Hk, int S, int D, int Dv, int shard,
                  float scale, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, repro_torch::bf16>::value;
  constexpr bool kWideOk =
      std::is_same<Rows, DenseRows>::value && (std::is_same<T, float>::value || kBf16);
  const bool wide = D > 32 * 4 * NCH || Dv > 32 * 4 * NCH;
  const size_t smem =
      kBf16 ? decode_smem_bytes_bf16(D, Dv) : decode_smem_floats(D, Dv) * sizeof(float);
  if (B < 1 || Hk < 1 || Hq % Hk || D < 1 || Dv < 1 || (wide && !kWideOk) ||
      D > 32 * 4 * WIDE_NCK || Dv > 32 * 4 * WIDE_NCV || S < 1 || shard < 1 ||
      smem > (size_t)repro_torch::kMaxSmemBytes || (S + shard - 1) / shard > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies of 4 fp32 or 8 bf16 values, or 4-byte int8 loads, where
  // every row starts aligned
  constexpr int vw = sizeof(T) == 2 ? 8 : 4;
  constexpr size_t al = sizeof(T) == 1 ? 4 : 16;
  const bool vec = D % vw == 0 && Dv % vw == 0 && reinterpret_cast<uintptr_t>(k) % al == 0 &&
                   reinterpret_cast<uintptr_t>(v) % al == 0;
  const int G = Hq / Hk;
#define REPRO_SHARDS(GM, NCK, NCV)                                                        \
  launch_shards_gm<Rows, TQ, T, TA, GM, NCK, NCV>(q, k, v, k_scale, v_scale, rows, lengths, acc, \
                                              m, l, B, Hq, Hk, S, D, Dv, shard, scale, vec, stream)
  if constexpr (kWideOk) {
    if (wide) {
      if (G == 1) return REPRO_SHARDS(1, WIDE_NCK, WIDE_NCV);
      if (G == 2) return REPRO_SHARDS(2, WIDE_NCK, WIDE_NCV);
      return REPRO_SHARDS(WIDE_GMAX, WIDE_NCK, WIDE_NCV);
    }
  }
  if (G == 1) return REPRO_SHARDS(1, NCH, NCH);
  if (G == 2) return REPRO_SHARDS(2, NCH, NCH);
  if (G <= 4) return REPRO_SHARDS(4, NCH, NCH);
  return REPRO_SHARDS(GMAX, NCH, NCH);
#undef REPRO_SHARDS
}

// Shards, then their combine into o (q's type).
template <class Rows, typename TQ, typename T>
int decode(const TQ* q, const T* k, const T* v, const float* k_scale, const float* v_scale,
           const Rows& rows, const int* lengths, float* acc, float* m, float* l, TQ* o,
           int B, int Hq, int Hk, int S, int D, int Dv, int shard, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_shards(q, k, v, k_scale, v_scale, rows, lengths, acc, m, l, B, Hq, Hk, S, D,
                          Dv, shard, scale, st);
  if (err) return err;
  return combine(acc, m, l, o, (S + shard - 1) / shard, B * Hq, Dv, st);
}

// ---------------------------------------------------------------------------
// The narrow bf16 body on the tensor cores (flash_decode_bf16, D, Dv <= 256):
// decode_tc_kernel.  See the note at the top.

using repro_torch::bf16;

constexpr int TC_THREADS = 128, TC_WARPS = TC_THREADS / 32;
constexpr int TC_ROWS = 16;     // key rows a warp tile: one k16 step of P V
constexpr int TC_NST = 3;       // ring slots a warp
constexpr int TC_HEADS = 8;     // query heads a block: rows 0-7 of the m16 tile
constexpr int TC_CLUSTER = 8;   // most shards (blocks) a cluster: one (sequence, kv head, group)

// bf16 values a staged row of width W takes: W padded to 16 (the k16 and
// n16 steps), then 8 more, so that a row is an odd number of 16-byte
// pieces and ldmatrix's 8 rows fall in 8 different bank groups.
__host__ __device__ inline int tc_stride(int W) { return (W + 15) / 16 * 16 + 8; }

// Dynamic shared memory of one block (kernels/flash_decode.py
// decode_tc_smem_bytes): q [TC_HEADS][KS], then each warp's TC_NST slots of
// TC_ROWS K rows [KS] and TC_ROWS V rows [VS] in bf16; after the loop the
// rings hold the fp32 merge: each warp's (m, l) and acc [TC_HEADS][Dv16],
// the block's, where the cluster reads them, and the weights of the warps
// and of the cluster's blocks with their sums of l.
__host__ __device__ inline size_t decode_tc_smem_bytes(int D, int Dv) {
  const int KS = tc_stride(D), VS = tc_stride(Dv), Dv16 = (Dv + 15) / 16 * 16;
  const size_t ring = 2 * (size_t)TC_WARPS * TC_NST * TC_ROWS * (KS + VS);
  const size_t merge = 4 * ((size_t)(TC_WARPS + 1) * TC_HEADS * (2 + Dv16) +
                            (size_t)(TC_WARPS + TC_CLUSTER + 1) * TC_HEADS);
  return 2 * (size_t)TC_HEADS * KS + (ring > merge ? ring : merge);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix: 8x8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// rows of matrix i; lane t gets row t / 4, columns 2 (t % 4) and + 1 of
// each (.trans: column t / 4, rows 2 (t % 4) and + 1).
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += A B on the tensor cores: A 16x16 bf16 (a0, a2 rows t / 4; a1, a3
// rows t / 4 + 8), B 16x8 bf16, c 16x8 fp32 (c[0], c[1] row t / 4 columns
// 2 (t % 4), + 1; c[2], c[3] row t / 4 + 8).
__device__ __forceinline__ void mma16816(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A lane's walk over the 16-byte pieces of TC_ROWS rows of W8 pieces (W8 <=
// 32): piece c = lane + 32 i is row c / W8, piece c % W8; the divisions
// once, then steps of 32.
struct PieceWalk {
  int r0, p0, dr, dp, W8;
  __device__ PieceWalk(int W8_, int lane)
      : r0(lane / W8_), p0(lane % W8_), dr(32 / W8_), dp(32 % W8_), W8(W8_) {}
};

// TC_ROWS rows of width W from src (row r at src + r * stride) into dst
// (row stride DS) by the warp's lanes: rows r >= n as zeros.  vec: 16-byte
// cp.async pieces (W % 8 == 0, src 16-byte aligned) along `walk`; else
// 2-byte loads and stores up to W padded to 16, zeros past W (unrolled, so
// that the loads of several elements are in flight together).
__device__ __forceinline__ void tc_stage(bf16* dst, const bf16* src, size_t stride, int W, int DS,
                                         int n, bool vec, int lane, const PieceWalk& walk) {
  if (vec) {
    for (int r = walk.r0, p8 = walk.p0; r < TC_ROWS;) {
      const bool ok = r < n;
      repro_torch::cp_async16(dst + r * DS + 8 * p8, src + (ok ? r : 0) * stride + 8 * p8, ok);
      r += walk.dr;
      p8 += walk.dp;
      if (p8 >= walk.W8) {
        p8 -= walk.W8;
        ++r;
      }
    }
  } else {
    const int W16 = (W + 15) / 16 * 16;
#pragma unroll 8
    for (int c = lane; c < TC_ROWS * W16; c += 32) {
      const int r = c / W16, d = c % W16;
      repro_torch::copy1(dst + r * DS + d, src + r * stride + d, r < n && d < W);
    }
  }
}

// Block (rank, y) of a cluster of gridDim.x blocks: y = (sequence b, kv head
// h, group of TC_HEADS query heads); rank: rows [rank * shard, (rank + 1) *
// shard) of the cache.  Writes o rows b, h * G + g0 .. + gn - 1, rounded
// once to bf16.  NV: the most 16-column chunks of Dv (Dv16 / 16 <= NV).
template <int NV>
__global__ void __launch_bounds__(TC_THREADS, 1)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ lengths,
                 bf16* __restrict__ o, int Hq, int Hk, int S, int D, int Dv, int shard,
                 float scale_log2, bool vec, bool vec_q) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_rank = static_cast<int>(gridDim.x);   // the cluster spans grid.x
  const int G = Hq / Hk, n_grp = (G + TC_HEADS - 1) / TC_HEADS;
  const int bh = blockIdx.y / n_grp, g0 = (blockIdx.y % n_grp) * TC_HEADS;
  const int b = bh / Hk, h = bh % Hk, gn = min(TC_HEADS, G - g0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int KS = tc_stride(D), VS = tc_stride(Dv);
  const int nk = (D + 15) / 16, nv = (Dv + 15) / 16, Dv16 = 16 * nv;
  const int row0 = rank * shard;
  const int len = min(max(min(max(lengths[b], 0), S) - row0, 0), shard);

  bf16* qs = reinterpret_cast<bf16*>(smem_tc);               // [TC_HEADS][KS]
  bf16* ring = qs + TC_HEADS * KS;
  const int slot = TC_ROWS * (KS + VS);                       // K rows, then V rows
  bf16* my_ring = ring + (size_t)warp * TC_NST * slot;

  // q's rows of this group, zeros past D and gn: 16-byte cp.async pieces
  // (vec_q) in a group of their own ahead of the first tiles, else 2-byte
  // loads (any alignment); columns D .. D16 zeroed by plain stores
  const size_t q_base = ((size_t)b * Hq + (size_t)h * G + g0) * D;
  const int D16 = 16 * nk;
  if (vec_q) {
    for (int i = tid; i < TC_HEADS * (D / 8); i += TC_THREADS) {
      const int g = i / (D / 8), p8 = i % (D / 8);
      repro_torch::cp_async16(qs + g * KS + 8 * p8, q + q_base + (size_t)(g < gn ? g : 0) * D + 8 * p8,
                              g < gn);
    }
    for (int i = tid; i < TC_HEADS * (D16 - D); i += TC_THREADS)
      *reinterpret_cast<unsigned short*>(qs + i / (D16 - D) * KS + D + i % (D16 - D)) = 0;
  } else {
#pragma unroll 8
    for (int i = tid; i < TC_HEADS * D16; i += TC_THREADS) {
      const int g = i / D16, d = i % D16;
      repro_torch::copy1(qs + g * KS + d, q + q_base + (size_t)g * D + d, g < gn && d < D);
    }
  }
  repro_torch::cp_async_commit();
  // with 16-byte staging, the columns D .. D16 and Dv .. Dv16 of every slot's
  // rows: zeros, never staged over (the 2-byte staging writes them itself)
  if (vec && (D % 16 || Dv % 16)) {
    for (int i = tid; i < TC_WARPS * TC_NST * TC_ROWS * 8; i += TC_THREADS) {
      const int r = i / 8, c = i % 8;
      bf16* base = ring + (size_t)(r / TC_ROWS) * slot;
      if (D % 16) *reinterpret_cast<unsigned short*>(base + (r % TC_ROWS) * KS + D + c) = 0;
      if (Dv % 16)
        *reinterpret_cast<unsigned short*>(base + TC_ROWS * KS + (r % TC_ROWS) * VS + Dv + c) = 0;
    }
  }

  const int n_tiles = (len + TC_ROWS - 1) / TC_ROWS;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + TC_WARPS - 1) / TC_WARPS : 0;
  const size_t kv0 = ((size_t)b * S + row0) * Hk + h;         // (b, row0, h) as a cache row
  const PieceWalk walk_k(vec ? D / 8 : 1, lane), walk_v(vec ? Dv / 8 : 1, lane);

  // stage this warp's i-th tile (shard tile warp + TC_WARPS * i) into slot i % TC_NST
  auto stage = [&](int i) {
    const int j0 = (warp + TC_WARPS * i) * TC_ROWS, n = min(TC_ROWS, len - j0);
    bf16* ks = my_ring + (i % TC_NST) * slot;
    const size_t r0 = kv0 + (size_t)j0 * Hk;
    tc_stage(ks, k + r0 * D, (size_t)Hk * D, D, KS, n, vec, lane, walk_k);
    tc_stage(ks + TC_ROWS * KS, v + r0 * Dv, (size_t)Hk * Dv, Dv, VS, n, vec, lane, walk_v);
  };

  // query head t / 4's running max (log2 units) and this thread's part of
  // its l; acc[c]: the m16n8 accumulator of O^T over Dv columns 16 c ..
  // 16 c + 15 (rows) and the 8 query heads (columns): acc[c][0], [1] heads
  // 2 (t % 4) and + 1 at column 16 c + t / 4, acc[c][2], [3] at + 8
  float m_run = repro_torch::kNegInf, l_part = 0.f;
  float acc[NV][4];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  // the lanes' ldmatrix rows: q (x2), K (x4), V (x4.trans)
  const bf16* q_lane = qs + (lane % 8) * KS + (lane / 8) % 2 * 8;
  const int k_lane = (lane / 16 * 8 + lane % 8) * KS + (lane / 8) % 2 * 8;
  const int v_lane = (lane / 16 * 8 + lane % 8) * VS + (lane / 8) % 2 * 8;

#pragma unroll
  for (int s = 0; s < TC_NST - 1; ++s) {
    if (s < my_tiles) stage(s);
    repro_torch::cp_async_commit();
  }
  repro_torch::cp_async_wait<TC_NST - 1>();  // q's group, while the first tiles fly
  __syncthreads();                           // q and the zeroed columns, for every warp
  for (int i = 0; i < my_tiles; ++i) {
    if (i + TC_NST - 1 < my_tiles) stage(i + TC_NST - 1);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<TC_NST - 1>();
    __syncwarp();
    const int j0 = (warp + TC_WARPS * i) * TC_ROWS;
    const bf16* ks = my_ring + (i % TC_NST) * slot;
    const bf16* vs = ks + TC_ROWS * KS;

    // S = q K^T over D's 16-deep chunks: sc[t2] (keys 8 t2 .. + 7) sums the
    // even chunks in order, sc[2 + t2] the odd ones, then the two are added:
    // four independent chains of products, in an order fixed by D
    float sc[4][4] = {};
    for (int kd = 0; kd < nk; kd += 2) {
      unsigned a0, a2, kb[4];
      ldsm_x2(a0, a2, q_lane + 16 * kd);
      ldsm_x4(kb, ks + k_lane + 16 * kd);
      mma16816(sc[0], a0, 0u, a2, 0u, kb[0], kb[1]);
      mma16816(sc[1], a0, 0u, a2, 0u, kb[2], kb[3]);
      if (kd + 1 < nk) {
        ldsm_x2(a0, a2, q_lane + 16 * (kd + 1));
        ldsm_x4(kb, ks + k_lane + 16 * (kd + 1));
        mma16816(sc[2], a0, 0u, a2, 0u, kb[0], kb[1]);
        mma16816(sc[3], a0, 0u, a2, 0u, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[0][e] += sc[2][e];
      sc[1][e] += sc[3][e];
    }
    // the online softmax of row t / 4 over keys 2 (t % 4) + {0, 1, 8, 9}
    const int jl = j0 + 2 * (lane % 4);
    float x[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
    const int off[4] = {0, 1, 8, 9};
    float mx = repro_torch::kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = jl + off[e] < len ? x[e] * scale_log2 : repro_torch::kNegInf;
      mx = fmaxf(mx, x[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = jl + off[e] < len ? exp2f(x[e] - m_new) : 0.f;
    l_part = l_part * alpha + (((p[0] + p[1]) + p[2]) + p[3]);
    m_run = m_new;
    // O^T += V^T P^T: this thread's p (head t / 4, keys 2 (t % 4), + 1 and
    // + 8) are the B operand as they stand, P = hi + lo two bf16 products
    // (a bf16 P alone misses BF16_TOL); V^T by ldmatrix.trans, one chunk
    // ahead; the rescale takes the alpha of the heads 2 (t % 4) and + 1
    const unsigned hi0 = pack_bf16(p[0], p[1]), hi1 = pack_bf16(p[2], p[3]);
    const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&hi0);
    const __nv_bfloat162 h1 = *reinterpret_cast<const __nv_bfloat162*>(&hi1);
    const unsigned lo0 = pack_bf16(p[0] - __low2float(h0), p[1] - __high2float(h0));
    const unsigned lo1 = pack_bf16(p[2] - __low2float(h1), p[3] - __high2float(h1));
    const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * (lane % 4));
    const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * (lane % 4) + 4);
    unsigned va[4];
    ldsm_x4_trans(va, vs + v_lane);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (c < nv) {
        unsigned vn[4] = {va[0], va[1], va[2], va[3]};
        if (c + 1 < nv) ldsm_x4_trans(vn, vs + v_lane + 16 * (c + 1));
        acc[c][0] *= al0;
        acc[c][1] *= al1;
        acc[c][2] *= al0;
        acc[c][3] *= al1;
        mma16816(acc[c], va[0], va[1], va[2], va[3], hi0, hi1);
        mma16816(acc[c], va[0], va[1], va[2], va[3], lo0, lo1);
#pragma unroll
        for (int e = 0; e < 4; ++e) va[e] = vn[e];
      }
    }
    __syncwarp();  // slot i % TC_NST is staged again in the next iteration
  }
  repro_torch::cp_async_wait<0>();
  float l_row = l_part + __shfl_xor_sync(0xffffffffu, l_part, 1);
  l_row = l_row + __shfl_xor_sync(0xffffffffu, l_row, 2);
  __syncthreads();  // every warp is done with the rings: reuse them

  // the warps' partials: m and l [TC_WARPS][TC_HEADS], acc
  // [TC_WARPS][TC_HEADS][Dv16]; then the block's, which the cluster reads
  // (m and l [TC_HEADS], acc [TC_HEADS][Dv16]); then the weights of the
  // warps [TC_WARPS][TC_HEADS] and of the cluster's blocks
  // [TC_CLUSTER][TC_HEADS] with their sums of l [TC_HEADS]
  float* wm = reinterpret_cast<float*>(ring);
  float* wl = wm + TC_WARPS * TC_HEADS;
  float* wacc = wl + TC_WARPS * TC_HEADS;
  float* bm = wacc + TC_WARPS * TC_HEADS * Dv16;
  float* bl = bm + TC_HEADS;
  float* bacc = bl + TC_HEADS;
  float* ww = bacc + TC_HEADS * Dv16;
  float* wt = ww + TC_WARPS * TC_HEADS;
  float* wsum = wt + TC_CLUSTER * TC_HEADS;
  const int g_lane = lane / 4;
  if (lane % 4 == 0) {
    wm[warp * TC_HEADS + g_lane] = m_run;
    wl[warp * TC_HEADS + g_lane] = l_row;
  }
  float* wacc_lane = wacc + ((size_t)warp * TC_HEADS + 2 * (lane % 4)) * Dv16 + g_lane;
#pragma unroll
  for (int c = 0; c < NV; ++c)
    if (c < nv) {
      wacc_lane[16 * c] = acc[c][0];
      wacc_lane[Dv16 + 16 * c] = acc[c][1];
      wacc_lane[16 * c + 8] = acc[c][2];
      wacc_lane[Dv16 + 16 * c + 8] = acc[c][3];
    }
  __syncthreads();
  // the block's partial: its warps in warp order, the weights exp2(m_w -
  // max) once a query head
  if (tid < gn) {
    float mm = wm[tid];
#pragma unroll
    for (int w = 1; w < TC_WARPS; ++w) mm = fmaxf(mm, wm[w * TC_HEADS + tid]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float f = exp2f(wm[w * TC_HEADS + tid] - mm);
      ww[w * TC_HEADS + tid] = f;
      ls = ls + wl[w * TC_HEADS + tid] * f;
    }
    bm[tid] = mm;
    bl[tid] = ls;
  }
  __syncthreads();
  for (int i = tid; i < gn * Dv16; i += TC_THREADS) {
    const int g = i / Dv16, d = i % Dv16;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w)
      a = a + wacc[((size_t)w * TC_HEADS + g) * Dv16 + d] * ww[w * TC_HEADS + g];
    bacc[i] = a;
  }
  cluster.sync();  // every block's partial is written
  // the cluster's blocks in rank order: each block computes the weights
  // exp2(m_r - max) of the ranks' partials and their sum of l (one thread a
  // query head, its remote loads issued together), then merges its slice
  // of the outputs
  if (tid < gn) {
    float mr[TC_CLUSTER], lr[TC_CLUSTER];
#pragma unroll
    for (int r = 0; r < TC_CLUSTER; ++r) {
      mr[r] = r < n_rank ? cluster.map_shared_rank(bm, r)[tid] : repro_torch::kNegInf;
      lr[r] = r < n_rank ? cluster.map_shared_rank(bl, r)[tid] : 0.f;
    }
    float mm = mr[0];
#pragma unroll
    for (int r = 1; r < TC_CLUSTER; ++r) mm = fmaxf(mm, mr[r]);
    float ls = 0.f;
#pragma unroll
    for (int r = 0; r < TC_CLUSTER; ++r) {
      const float f = r < n_rank ? exp2f(mr[r] - mm) : 0.f;
      wt[r * TC_HEADS + tid] = f;
      ls = ls + lr[r] * f;
    }
    wsum[tid] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  for (int i = rank * TC_THREADS + tid; i < gn * Dv; i += n_rank * TC_THREADS) {
    const int g = i / Dv, d = i % Dv;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < TC_CLUSTER; ++r)
      if (r < n_rank)
        a = a + cluster.map_shared_rank(bacc, r)[g * Dv16 + d] * wt[r * TC_HEADS + g];
    o[((size_t)b * Hq + (size_t)h * G + g0 + g) * Dv + d] = __float2bfloat16_rn(a / wsum[g]);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int NV>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const int* lengths, bf16* o, int B,
              int Hq, int Hk, int S, int D, int Dv, int shard, float scale, bool vec, bool vec_q,
              cudaStream_t stream) {
  auto kernel = decode_tc_kernel<NV>;
  const size_t smem = decode_tc_smem_bytes(D, Dv);
  static int smem_set[repro_torch::kMaxDevices];
  cudaError_t err = repro_torch::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_grp = (Hq / Hk + TC_HEADS - 1) / TC_HEADS, cluster = (S + shard - 1) / shard;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B * Hk * n_grp);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, k, v, lengths, o, Hq, Hk, S, D, Dv, shard,
                           scale * 1.4426950408889634f, vec, vec_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The narrow bf16 decode in one launch: shards of `shard` rows (the
// wrapper's decode_plan_bf16: a multiple of TC_ROWS, at most TC_CLUSTER of
// them), merged inside the cluster.
int decode_tc(const bf16* q, const bf16* k, const bf16* v, const int* lengths, bf16* o, int B,
              int Hq, int Hk, int S, int D, int Dv, int shard, float scale, void* stream) {
  if (B < 1 || Hk < 1 || Hq % Hk || D < 1 || Dv < 1 || D > 32 * 4 * NCH || Dv > 32 * 4 * NCH ||
      S < 1 || shard < 1 || shard % TC_ROWS || (S + shard - 1) / shard > TC_CLUSTER ||
      (size_t)B * Hk * ((Hq / Hk + TC_HEADS - 1) / TC_HEADS) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 8 == 0 && Dv % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const bool vec_q = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = (Dv + 15) / 16;
#define REPRO_TC(NV) \
  launch_tc<NV>(q, k, v, lengths, o, B, Hq, Hk, S, D, Dv, shard, scale, vec, vec_q, st)
  if (nv <= 4) return REPRO_TC(4);
  if (nv <= 8) return REPRO_TC(8);
  return REPRO_TC(16);
#undef REPRO_TC
}

}  // namespace

// acc (ceil(S / shard), B, Hq, Dv), m and l (ceil(S / shard), B, Hq): the
// workspace of the shards' partials.
extern "C" int flash_decode_f32(const float* q, const float* k, const float* v,
                                const int* lengths, float* acc, float* m, float* l, float* o,
                                int B, int Hq, int Hk, int S, int D, int Dv, int shard,
                                float scale, void* stream) {
  return decode(q, k, v, nullptr, nullptr, DenseRows{S, Hk}, lengths, acc, m, l, o, B, Hq, Hk,
                S, D, Dv, shard, scale, stream);
}

extern "C" int flash_paged_decode_f32(const float* q, const float* pages_k,
                                      const float* pages_v, const int* tables,
                                      const int* lengths, float* acc, float* m, float* l,
                                      float* o, int B, int Hq, int Hk, int N, int P, int MP,
                                      int D, int Dv, int shard, float scale, void* stream) {
  return decode(q, pages_k, pages_v, nullptr, nullptr, PagedRows{tables, MP, P, N, Hk}, lengths,
                acc, m, l, o, B, Hq, Hk, MP * P, D, Dv, shard, scale, stream);
}

extern "C" int flash_paged_decode_i8(const float* q, const int8_t* pages_k,
                                     const float* k_scales, const int8_t* pages_v,
                                     const float* v_scales, const int* tables,
                                     const int* lengths, float* acc, float* m, float* l,
                                     float* o, int B, int Hq, int Hk, int N, int P, int MP,
                                     int D, int Dv, int shard, float scale, void* stream) {
  return decode(q, pages_k, pages_v, k_scales, v_scales, PagedRows{tables, MP, P, N, Hk},
                lengths, acc, m, l, o, B, Hq, Hk, MP * P, D, Dv, shard, scale, stream);
}

extern "C" int flash_decode_partial_f32(const float* q, const float* k, const float* v,
                                        const int* lengths, float* acc, float* m, float* l,
                                        int B, int Hq, int Hk, int S, int D, int Dv,
                                        int n_splits, float scale, void* stream) {
  if (n_splits < 1 || S % n_splits) return static_cast<int>(cudaErrorInvalidValue);
  return launch_shards(q, k, v, nullptr, nullptr, DenseRows{S, Hk}, lengths, acc, m, l, B, Hq,
                       Hk, S, D, Dv, S / n_splits, scale, static_cast<cudaStream_t>(stream));
}

// acc (NS, R, Dv), m and l (NS, R) -> out (R, Dv).
extern "C" int combine_partials_f32(const float* acc, const float* m, const float* l,
                                    float* out, int NS, int R, int Dv, void* stream) {
  return combine(acc, m, l, out, NS, R, Dv, static_cast<cudaStream_t>(stream));
}

extern "C" int combine_partials_bf16(const float* acc, const float* m, const float* l,
                                     __nv_bfloat16* out, int NS, int R, int Dv, void* stream) {
  return combine(acc, m, l, out, NS, R, Dv, static_cast<cudaStream_t>(stream));
}

// flash_decode_f32's arguments with q, k, v and o bf16.  D, Dv <= 256: the
// tensor-core body, one launch, `shard` from decode_plan_bf16, acc, m and l
// unused (may be null); wider: the wide layout over the fp32 workspace and
// the combine, `shard` from decode_shard_rows.
extern "C" int flash_decode_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const int* lengths, float* acc,
                                 float* m, float* l, __nv_bfloat16* o, int B, int Hq, int Hk,
                                 int S, int D, int Dv, int shard, float scale, void* stream) {
  if (D <= 32 * 4 * NCH && Dv <= 32 * 4 * NCH)
    return decode_tc(q, k, v, lengths, o, B, Hq, Hk, S, D, Dv, shard, scale, stream);
  return decode(q, k, v, nullptr, nullptr, DenseRows{S, Hk}, lengths, acc, m, l, o, B, Hq, Hk,
                S, D, Dv, shard, scale, stream);
}

// flash_decode_partial_f32's arguments with q, k and v bf16 (either layout)
// and acc bf16, each shard's fp32 acc rounded once; m and l fp32.
extern "C" int flash_decode_partial_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, const int* lengths,
                                         __nv_bfloat16* acc, float* m, float* l, int B, int Hq,
                                         int Hk, int S, int D, int Dv, int n_splits, float scale,
                                         void* stream) {
  if (n_splits < 1 || S % n_splits) return static_cast<int>(cudaErrorInvalidValue);
  return launch_shards(q, k, v, nullptr, nullptr, DenseRows{S, Hk}, lengths, acc, m, l, B, Hq,
                       Hk, S, D, Dv, S / n_splits, scale, static_cast<cudaStream_t>(stream));
}
