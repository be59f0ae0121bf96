// flash_decode: one-token GQA attention over a KV cache, fp32 arithmetic.
//   q (B, Hq, D), lengths (B,) int32 -> o (B, Hq, Dv); cache positions
//   >= lengths[b] are masked.  Three entry points share one kernel body,
//   a template over the KV row source (common.cuh):
//   flash_decode_f32        dense k (B, S, Hk, D), v (B, S, Hk, Dv);
//   flash_paged_decode_f32  pages (N, P, Hk, D/Dv) fp32 through block
//                           tables (B, MP);
//   flash_paged_decode_i8   int8 pages with (N, Hk) fp32 scales, dequantized
//                           as float(x) * scale while a tile is staged;
//   flash_decode_partial_f32  the dense cache cut into n_splits shards of
//                           part = S / n_splits rows, all in one launch:
//                           acc (n_splits, B, Hq, Dv), m and l (n_splits, B,
//                           Hq), the unnormalised flash partials of each
//                           shard (the body with its finish swapped).
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode (_flash_decode,
// body _decode_kernel with emit_stats=False), behind `decode_attention`
// pallas (ops.py:147), and flash_paged_decode (bodies _paged_decode_kernel
// and _paged_decode_q_kernel), behind `paged_decode_attention[_q]` pallas
// (serving_ops.py:619, :941), and flash_decode_partial (the same body with
// emit_stats=True), behind `decode_attention` pallas_split (ops.py:178-208),
// which calls it once per shard in a Python loop.
//
// What bounds it on the H100: bytes.  Each cache byte is read once per step
// for O(1) flops (about 0.5 flop/byte at Hq = Hk), so its least time is the
// live cache rows over 3.35 TB/s.
//
// Design: one 128-thread block per (b, kv head) holds that head's whole query
// group, so K/V are read once per group, not once per query head.  K/V tiles
// of 64 rows stream through dynamic shared memory (at D = Dv = 96 one K tile
// plus one V tile is 48 KiB, the whole static limit, hence
// cudaFuncSetAttribute); K rows are padded to D+1 floats so the score loop,
// where each thread walks one row, is free of bank conflicts.  The online
// softmax runs in fp32 with the Pallas kernel's finite -1e30 and its
// acc / max(l, 1e-30) finish, so an empty cache (length 0: an idle slot)
// gives 0.  Tiles start at row 0 and have a fixed size, and tiles past
// lengths[b] are skipped: a sequence's result does not depend on the batch.
//
// Paged: the kernel walks the same fixed 64-row logical tiles from column 0
// as the dense one and fills each tile row by row through the block table,
// for any page size P (the Pallas kernel takes one page per grid step).  The
// score and P.V loops are the dense ones, so an fp32 paged row is bitwise
// equal to the dense kernel's row on the gathered cache, and shared memory
// does not depend on P.  Rows past lengths[b] (junk table entries) are never
// loaded: they are zero-filled in shared memory like the dense tail.  int8
// pages read a quarter of the bytes; the bound is then the int8 rows plus
// the scale sidecars.
//
// Partial (split-KV): grid (B * Hk, n_splits); block (bh, i) runs the same
// loop over shard i, rows [i * part, (i + 1) * part), with the shard's
// length clip(len - i * part, 0, part) and its 64-row tiles counted from the
// shard's first row, and writes (acc, m, l) instead of acc / max(l, 1e-30).
// An empty shard writes acc 0, m -1e30, l 0.  One launch covers the shards
// that JAX's backend computes in n_splits calls, and it multiplies the
// blocks by n_splits: the dense kernel has only B * Hk of them (4 on 132
// SMs at gemma3-1b's batch-4 decode).  The bound is the dense kernel's plus
// the partials, n_splits * B * Hq * (Dv + 2) floats written once and read
// once by the combine.  The combine (ref.combine_partials_ref) runs after
// it in plain PyTorch, over the splits in index order; the shards do not
// depend on B, so neither does a row's result.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128, NWARPS = THREADS / 32, BKV = 64;

// floats of dynamic shared memory for a query group of G heads
__host__ __device__ inline size_t decode_smem_floats(int G, int D, int Dv) {
  return (size_t)G * D + (size_t)G * Dv + (size_t)G * BKV + 3 * (size_t)G +
         (size_t)BKV * (D + 1) + (size_t)BKV * Dv;
}

// kPartial: block (bh, blockIdx.y) covers shard blockIdx.y of `part` rows
// and writes its unnormalised (acc, m, l); otherwise part == S, one shard.
template <bool kPartial, class KV>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const float* __restrict__ q, const typename KV::Elem* __restrict__ k,
                    const typename KV::Elem* __restrict__ v,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const KV kv, const int* __restrict__ lengths, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int Hq, int Hk, int S, int D, int Dv, int part, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hk, h = blockIdx.x % Hk;
  const int split = blockIdx.y, row0 = split * part;
  const int G = Hq / Hk;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* qs = smem;                 // [G][D], pre-scaled
  float* acc = qs + G * D;          // [G][Dv]
  float* sc = acc + G * Dv;         // [G][BKV] scores, then probabilities
  float* ms = sc + G * BKV;         // [G] running max
  float* ls = ms + G;               // [G] running sum of exp
  float* al = ls + G;               // [G] rescale factor of this tile
  float* ks = al + G;               // [BKV][D+1]
  float* vs = ks + BKV * (D + 1);   // [BKV][Dv]

  const int len = min(max(min(max(lengths[b], 0), S) - row0, 0), part);
  const size_t q_base = ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = q[q_base + i] * scale;
  for (int i = tid; i < G * Dv; i += THREADS) acc[i] = 0.f;
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = repro_torch::kNegInf;
    ls[g] = 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < len; j0 += BKV) {
    const int n = min(BKV, len - j0);
    kv.template stage<THREADS, BKV>(k, v, k_scale, v_scale, ks, vs, b, h, row0 + j0, n, D,
                                    Dv);
    __syncthreads();

    for (int i = tid; i < G * BKV; i += THREADS) {
      const int g = i / BKV, j = i % BKV;
      const float* qr = qs + g * D;
      const float* kr = ks + j * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      sc[i] = j < n ? s : repro_torch::kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      float* row = sc + g * BKV;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, repro_torch::warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      const float sum = repro_torch::warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * Dv; i += THREADS) {
      const int g = i / Dv, d = i % Dv;
      const float* p = sc + g * BKV;
      float pv = 0.f;
      for (int j = 0; j < n; ++j) pv = fmaf(p[j], vs[j * Dv + d], pv);
      acc[i] = acc[i] * al[g] + pv;
    }
    __syncthreads();
  }

  // row (split, b, h * G + g) of the (n_splits, B, Hq) outputs
  const size_t row_base = ((size_t)split * (gridDim.x / Hk) + b) * Hq + (size_t)h * G;
  if constexpr (kPartial) {
    for (int i = tid; i < G * Dv; i += THREADS) o[row_base * Dv + i] = acc[i];
    for (int g = tid; g < G; g += THREADS) {
      m_out[row_base + g] = ms[g];
      l_out[row_base + g] = ls[g];
    }
  } else {
    for (int i = tid; i < G * Dv; i += THREADS) {
      const int g = i / Dv;
      o[row_base * Dv + i] = acc[i] / fmaxf(ls[g], 1e-30f);
    }
  }
}

template <bool kPartial = false, class KV>
int launch(const float* q, const typename KV::Elem* k, const typename KV::Elem* v,
           const float* k_scale, const float* v_scale, const KV& kv, const int* lengths,
           float* o, int B, int Hq, int Hk, int S, int D, int Dv, float scale, void* stream,
           float* m_out = nullptr, float* l_out = nullptr, int n_splits = 1) {
  const size_t smem = decode_smem_floats(Hq / Hk, D, Dv) * sizeof(float);
  if (smem > (size_t)repro_torch::kMaxSmemBytes || n_splits < 1 || S % n_splits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<kPartial, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hk, n_splits);
  flash_decode_kernel<kPartial, KV><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, k_scale, v_scale, kv, lengths, o, m_out, l_out, Hq, Hk, S, D, Dv, S / n_splits,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_decode_f32(const float* q, const float* k, const float* v,
                                const int* lengths, float* o, int B, int Hq, int Hk,
                                int S, int D, int Dv, float scale, void* stream) {
  return launch(q, k, v, nullptr, nullptr, repro_torch::DenseKV{S, Hk}, lengths, o, B, Hq,
                Hk, S, D, Dv, scale, stream);
}

extern "C" int flash_paged_decode_f32(const float* q, const float* pages_k,
                                      const float* pages_v, const int* tables,
                                      const int* lengths, float* o, int B, int Hq, int Hk,
                                      int N, int P, int MP, int D, int Dv, float scale,
                                      void* stream) {
  return launch(q, pages_k, pages_v, nullptr, nullptr,
                repro_torch::PagedKV<float>{tables, MP, P, N, Hk}, lengths, o, B, Hq, Hk,
                MP * P, D, Dv, scale, stream);
}

extern "C" int flash_paged_decode_i8(const float* q, const int8_t* pages_k,
                                     const float* k_scales, const int8_t* pages_v,
                                     const float* v_scales, const int* tables,
                                     const int* lengths, float* o, int B, int Hq, int Hk,
                                     int N, int P, int MP, int D, int Dv, float scale,
                                     void* stream) {
  return launch(q, pages_k, pages_v, k_scales, v_scales,
                repro_torch::PagedKV<int8_t>{tables, MP, P, N, Hk}, lengths, o, B, Hq, Hk,
                MP * P, D, Dv, scale, stream);
}

extern "C" int flash_decode_partial_f32(const float* q, const float* k, const float* v,
                                        const int* lengths, float* acc, float* m, float* l,
                                        int B, int Hq, int Hk, int S, int D, int Dv,
                                        int n_splits, float scale, void* stream) {
  return launch<true>(q, k, v, nullptr, nullptr, repro_torch::DenseKV{S, Hk}, lengths, acc, B,
                      Hq, Hk, S, D, Dv, scale, stream, m, l, n_splits);
}
