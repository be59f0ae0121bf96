// Flash attention over a KV cache or a sequence's own K/V, fp32 arithmetic.
//   q (B, T, Hq, D) -> o (B, T, Hq, Dv).  Four entry points share one kernel
//   body, a template over the KV row source (common.cuh) and a mask policy:
//   flash_chunk_attention_f32        dense k (B, S, Hk, D), v (B, S, Hk, Dv);
//                                    query row t sits at start[b] + t and
//                                    attends cache columns <= start[b] + t;
//   flash_paged_chunk_attention_f32  the same over pages (N, P, Hk, D/Dv) fp32
//                                    through block tables (B, MP);
//   flash_paged_chunk_attention_i8   int8 pages with (N, Hk) fp32 scales,
//                                    dequantized while a tile is staged;
//   flash_attention_f32              dense k/v (B, Skv, Hk, D/Dv); query row i
//                                    sits at the static position Skv - T + i;
//                                    causal (columns <= row) or not, and an
//                                    optional sliding window (columns
//                                    > row - window).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_chunk_attention (body
// _chunk_flash_kernel), behind `chunk_attention` pallas (serving_ops.py:329),
// flash_paged_chunk_attention (bodies _paged_chunk_kernel and
// _paged_chunk_q_kernel), behind `paged_chunk_attention[_q]` pallas
// (serving_ops.py:513, :849), and flash_attention (body _flash_kernel), behind
// `attention` pallas (ops.py:95), which the layer-stack models' prefill uses.
//
// What bounds it on the H100: at the serving shapes (T = 64 rows against up
// to ~1k cache rows, D = 96) it does about 4*T*cols*D flops over
// (T + 2*cols)*D*4 bytes, around 10 flop/byte: below the fp32 ridge of
// 20 flop/byte, so bytes bound it, with FFMA issue close behind.  A whole
// prefill (flash_attention at T = Skv = 1024, D = 256) does ~256 flop/byte:
// fp32 FFMA issue bounds it.
//
// Design: one 256-thread block per (b, query head, 32-row query tile).  It
// walks fixed 64-row K/V tiles, staging them in dynamic shared memory (Q + K
// + V + scores + accumulator is ~81 KB at D = 96 and 205,440 B at D = 256,
// past the 48 KB static limit), K rows padded to D+1 floats.  Each thread
// owns 8 score rows of one column, so a K element is read once per 8 FMAs.
// The online softmax is fp32 with the Pallas kernel's -1e30 mask and
// acc / max(l, 1e-30) finish.  The mask policy gives each query tile the
// first and last column any of its rows may see; the walk starts at the
// 64-aligned tile holding the first (block skipping: a sliding-window tile
// never reads the columns its window has left behind) and ends at the tile
// holding the last.  KV tiles have a fixed size and fixed alignment, and a
// column a row may not see adds an exact zero (p = 0, rescale exp(0) = 1;
// a tile a row sees nothing of leaves it unchanged), so a row's result
// depends neither on the chunk size T nor on the batch.  A row that sees no
// column at all finishes as 0, as in Pallas when its blocks are skipped.
//
// Paged: the same fixed 64-row logical tiles from column 0, each filled row
// by row through the block table, for any page size P; the score, softmax
// and P.V loops are the dense ones, so an fp32 paged row is bitwise equal to
// the dense kernel's row on the gathered cache.  Table entries past the
// tile's last allowed column (junk) are never read; rows past it are
// zero-filled in shared memory.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256, NWARPS = THREADS / 32, BQ = 32, BKV = 64;
constexpr int ROWS_PER_THREAD = BQ * BKV / THREADS;  // 8 score rows per thread

__host__ __device__ inline size_t chunk_smem_floats(int D, int Dv) {
  return (size_t)BQ * D + (size_t)BQ * Dv + (size_t)BQ * BKV + 3 * (size_t)BQ +
         (size_t)BKV * (D + 1) + (size_t)BKV * Dv;
}

// Mask policies.  pos0: the position of the query tile's row 0 (row r sits
// at pos0 + r); first_col / end_col: the first column any of its nq rows may
// see and one past the last; allowed: whether the row at position `row`
// sees column `col`.

// Chunked prefill: row t of sequence b at start[b] + t, columns <= row.
struct OffsetCausal {
  const int* __restrict__ start;
  __device__ __forceinline__ int pos0(int b, int t0) const { return start[b] + t0; }
  __device__ __forceinline__ int first_col(int) const { return 0; }
  __device__ __forceinline__ int end_col(int pos0, int nq, int S) const {
    return min(S, pos0 + nq);
  }
  __device__ __forceinline__ bool allowed(int col, int row) const { return col <= row; }
};

// Whole-sequence attention: row i at the static offset + i (offset = Skv - T),
// columns <= row when causal, columns > row - window when window > 0.
struct StaticWindow {
  int offset, causal, window;
  __device__ __forceinline__ int pos0(int, int t0) const { return offset + t0; }
  __device__ __forceinline__ int first_col(int pos0) const {
    return window > 0 ? max(0, pos0 - window + 1) : 0;
  }
  __device__ __forceinline__ int end_col(int pos0, int nq, int S) const {
    return causal ? min(S, pos0 + nq) : S;
  }
  __device__ __forceinline__ bool allowed(int col, int row) const {
    return (!causal || col <= row) && (window <= 0 || col > row - window);
  }
};

template <class KV, class Mask>
__global__ void __launch_bounds__(THREADS)
chunk_attention_kernel(const float* __restrict__ q, const typename KV::Elem* __restrict__ k,
                       const typename KV::Elem* __restrict__ v,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       const KV kv, const Mask mask, float* __restrict__ o,
                       int T, int Hq, int Hk, int S, int D, int Dv, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hq, hq = blockIdx.x % Hq;
  const int h = hq / (Hq / Hk);
  const int t0 = blockIdx.y * BQ;
  const int nq = min(BQ, T - t0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* qs = smem;                 // [BQ][D], pre-scaled
  float* acc = qs + BQ * D;         // [BQ][Dv]
  float* sc = acc + BQ * Dv;        // [BQ][BKV] scores, then probabilities
  float* ms = sc + BQ * BKV;        // [BQ]
  float* ls = ms + BQ;              // [BQ]
  float* al = ls + BQ;              // [BQ]
  float* ks = al + BQ;              // [BKV][D+1]
  float* vs = ks + BKV * (D + 1);   // [BKV][Dv]

  const int pos0 = mask.pos0(b, t0);  // absolute position of query row 0
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[i] = r < nq ? q[(((size_t)b * T + t0 + r) * Hq + hq) * D + d] * scale : 0.f;
  }
  for (int i = tid; i < BQ * Dv; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < BQ; r += THREADS) {
    ms[r] = repro_torch::kNegInf;
    ls[r] = 0.f;
  }
  __syncthreads();

  // the aligned tile holding the first column any row of this tile may
  // attend, and one past the last such column
  const int kv_begin = mask.first_col(pos0) / BKV * BKV;
  const int kv_end = mask.end_col(pos0, nq, S);
  const int col = tid % BKV, row0 = tid / BKV;  // score rows row0 + 4*r
  for (int j0 = kv_begin; j0 < kv_end; j0 += BKV) {
    const int n = min(BKV, kv_end - j0);
    kv.template stage<THREADS, BKV>(k, v, k_scale, v_scale, ks, vs, b, h, j0, n, D, Dv);
    __syncthreads();

    float s[ROWS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) s[r] = 0.f;
    const float* kr = ks + col * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
        s[r] = fmaf(qs[(row0 + 4 * r) * D + d], kd, s[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const int row = row0 + 4 * r;
      const bool allowed = col < n && mask.allowed(j0 + col, pos0 + row);
      sc[row * BKV + col] = allowed ? s[r] : repro_torch::kNegInf;
    }
    __syncthreads();

    for (int row = warp; row < BQ; row += NWARPS) {
      float* srow = sc + row * BKV;
      const int rpos = pos0 + row;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      const float m_prev = ms[row];
      const float m_new = fmaxf(m_prev, repro_torch::warp_max(fmaxf(s0, s1)));
      const float p0 = (lane < n && mask.allowed(j0 + lane, rpos)) ? expf(s0 - m_new) : 0.f;
      const float p1 =
          (lane + 32 < n && mask.allowed(j0 + lane + 32, rpos)) ? expf(s1 - m_new) : 0.f;
      const float sum = repro_torch::warp_sum(p0 + p1);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[row] = alpha;
        ls[row] = ls[row] * alpha + sum;
        ms[row] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * Dv; i += THREADS) {
      const int r = i / Dv, d = i % Dv;
      const float* p = sc + r * BKV;
      float pv = 0.f;
      for (int j = 0; j < n; ++j) pv = fmaf(p[j], vs[j * Dv + d], pv);
      acc[i] = acc[i] * al[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * Dv; i += THREADS) {
    const int r = i / Dv, d = i % Dv;
    o[(((size_t)b * T + t0 + r) * Hq + hq) * Dv + d] = acc[i] / fmaxf(ls[r], 1e-30f);
  }
}

template <class KV, class Mask>
int launch(const float* q, const typename KV::Elem* k, const typename KV::Elem* v,
           const float* k_scale, const float* v_scale, const KV& kv, const Mask& mask,
           float* o, int B, int T, int Hq, int Hk, int S, int D, int Dv, float scale,
           void* stream) {
  const size_t smem = chunk_smem_floats(D, Dv) * sizeof(float);
  if (smem > (size_t)repro_torch::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_attention_kernel<KV, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * Hq, (T + BQ - 1) / BQ);
  chunk_attention_kernel<KV, Mask><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, k_scale, v_scale, kv, mask, o, T, Hq, Hk, S, D, Dv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_chunk_attention_f32(const float* q, const float* k, const float* v,
                                         const int* start, float* o, int B, int T, int Hq,
                                         int Hk, int S, int D, int Dv, float scale,
                                         void* stream) {
  return launch(q, k, v, nullptr, nullptr, repro_torch::DenseKV{S, Hk}, OffsetCausal{start}, o,
                B, T, Hq, Hk, S, D, Dv, scale, stream);
}

extern "C" int flash_paged_chunk_attention_f32(const float* q, const float* pages_k,
                                               const float* pages_v, const int* tables,
                                               const int* start, float* o, int B, int T,
                                               int Hq, int Hk, int N, int P, int MP, int D,
                                               int Dv, float scale, void* stream) {
  return launch(q, pages_k, pages_v, nullptr, nullptr,
                repro_torch::PagedKV<float>{tables, MP, P, N, Hk}, OffsetCausal{start}, o,
                B, T, Hq, Hk, MP * P, D, Dv, scale, stream);
}

extern "C" int flash_paged_chunk_attention_i8(const float* q, const int8_t* pages_k,
                                              const float* k_scales, const int8_t* pages_v,
                                              const float* v_scales, const int* tables,
                                              const int* start, float* o, int B, int T,
                                              int Hq, int Hk, int N, int P, int MP, int D,
                                              int Dv, float scale, void* stream) {
  return launch(q, pages_k, pages_v, k_scales, v_scales,
                repro_torch::PagedKV<int8_t>{tables, MP, P, N, Hk}, OffsetCausal{start}, o,
                B, T, Hq, Hk, MP * P, D, Dv, scale, stream);
}

// window <= 0: no window.  T may exceed Skv: rows before position 0 of a
// causal mask see nothing and give 0.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                   int B, int T, int Hq, int Hk, int Skv, int D, int Dv,
                                   int causal, int window, float scale, void* stream) {
  return launch(q, k, v, nullptr, nullptr, repro_torch::DenseKV{Skv, Hk},
                StaticWindow{Skv - T, causal, window}, o, B, T, Hq, Hk, Skv, D, Dv, scale,
                stream);
}
