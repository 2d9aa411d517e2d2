// Ragged multi-query GQA attention over the KV cache: the dense window, and
// the paged pool read through block tables.  The main-cache source of the
// speculative verify step (S = k+1 queries a row), and of any mix of decode,
// prefill-chunk and verify rows.
//
// Replaces: calfkit_tpu/inference/pallas_attention.py:357
//   ragged_attention_pallas (kernel body _ragged_attn_kernel, :298), entry
//   point calfkit_ragged_attention; and pallas_attention.py:467
//   ragged_attention_paged_pallas (kernel body _ragged_paged_attn_kernel,
//   :413), entry point calfkit_ragged_paged_attention.  Both share one body.
//
// Computes, for every (batch row b, kv head k) and each of its S*G queries,
// flattened as r = j * G + g (query j of the row, query head g of the group):
//   s[w] = (q[r] . k[w]) * scale, masked to -1e30 where
//          w >= min(kv_lens[b], q_starts[b] + j + 1)     (the ragged mask law)
//   m    = max(max_w s[w], -1e29)
//   z    = sum_w exp(s[w] - m)
//   o    = sum_w exp(s[w] - m) * v[w]      (UNnormalized, f32)
// into o [B, K, S, G, hd], m and z [B, K, S, G]: the (o, m, z) contract that
// logsumexp_merge folds with the verify chunk's own source.  Verify rows have
// start = kv_len (every query sees the whole valid cache); prefill-kind rows
// have start < kv_len and get the within-row causal triangle.
//
// What bounds it on an H100: bytes, at the verify shapes.  A cached position
// costs 2*hd*sizeof(T) bytes of K/V once for the whole block and 4*hd
// operations per query it serves: at S*G = 20 queries that is 20 operations
// per bf16 byte, below the ~295 where the tensor cores would be the limit.
// The least time is the K/V bytes of the positions some query of a row sees
// over the 3.35 TB/s of device memory.  This kernel does its arithmetic in
// f32 on the CUDA cores, whose 67 TFLOP/s make it compute-heavy at large S*G.
//
// What the design does about it:
// - The TPU kernel holds all S*G queries of a row in one VMEM block and
//   streams the window in 512-position chunks.  Here a block owns one
//   (b, kv head, query tile) of up to 32 query rows (kRows), so any S*G
//   works: S = k+1 for verify, up to a prefill chunk for prefill-kind rows.
//   The q tile (16 KB at hd = 128) and the score tile sit in shared memory,
//   the output accumulators in registers (16 a thread at hd = 128).
// - K/V stream in 64-position tiles through the decode kernel's cp.async
//   ring of three stages; one tile read from device memory serves every
//   query row of the block, the amortization speculation exists for.
// - A thread scores one position against 8 query rows from one read of its
//   K row; a warp runs the online softmax of 4 rows; a thread accumulates
//   one output column of 16 (hd 128) or 8 (hd 64) rows.
// - The block stops at the last position its last query sees,
//   min(kv_len, start + j_last + 1): positions past a query's limit add
//   exp(-1e30 - m) = 0 with m >= -1e29 and rescale by exp(0) = 1, so
//   stopping early gives the same (o, m, z) as visiting the whole window.
//   Rows with nothing to see write o = 0, m = -1e29, z = 0.
// - Both forms read K/V in place through strides: the dense window view of
//   [L, B, K, S, hd]; a layer of the paged pool with the row's block table
//   staged in shared memory (pages past the row's last visible position,
//   the trash page among them, are never read).
// Left for later: tensor cores (the score and p*v products at S*G >= 16 are
// mma-shaped), splitting the window across blocks, TMA.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // kv positions per tile
constexpr int kStages = 3;     // tiles in the cp.async ring
constexpr int kRows = 32;      // query rows (query x head) per block
constexpr int kScoreStep = kThreads / kTile;  // rows between one thread's scores

template <typename T, int HD>
struct RaggedLayout {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  // +16 bytes a row: lanes reading one column of successive rows with
  // 16-byte loads fall on distinct banks
  static constexpr int kRow = HD + kVec;
  static constexpr size_t kTileBytes = sizeof(T) * kTile * kRow;
  static constexpr size_t kBytes = kStages * 2 * kTileBytes +
                                   sizeof(float) * (kRows * HD + kRows * kTile + 3 * kRows) +
                                   sizeof(int) * kRows;
};

// The shared body: the block's n_rows query rows, rows row0 .. row0 +
// n_rows - 1 of its (batch row, kv head), attend that head's K/V rows under
// the ragged mask law with the row's start and kv_len (kv_len already
// clamped to the window).  Uses RaggedLayout<T, HD>::kBytes of shared memory.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend_rows(
    unsigned char* smem,
    const float* __restrict__ q,  // the block's first query row: [n_rows, HD]
    const Rows& krows, const Rows& vrows, int row0, int n_rows, int G, int start,
    int kv_len,
    float* __restrict__ o,      // [n_rows, HD]
    float* __restrict__ m_out,  // [n_rows]
    float* __restrict__ z_out,  // [n_rows]
    float scale) {
  using L = RaggedLayout<T, HD>;
  constexpr int kVec = L::kVec;
  constexpr int kRow = L::kRow;
  constexpr int kChunksPerRow = HD / kVec;
  constexpr int kDots = kRows / kScoreStep;  // score rows per thread
  constexpr int kPvStep = kThreads / HD;     // rows between one thread's accumulators
  constexpr int kAcc = kRows / kPvStep;

  T* tiles = reinterpret_cast<T*>(smem);  // [kStages][K, V][kTile][kRow]
  float* q_s = reinterpret_cast<float*>(smem + kStages * 2 * L::kTileBytes);  // [kRows][HD]
  float* p_s = q_s + kRows * HD;  // [kRows][kTile] scores, then probabilities
  float* m_s = p_s + kRows * kTile;
  float* z_s = m_s + kRows;
  float* alpha_s = z_s + kRows;
  int* lim_s = reinterpret_cast<int*>(alpha_s + kRows);  // each row's visible length

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < n_rows * HD; idx += kThreads) q_s[idx] = q[idx];
  if (tid < kRows) {
    // row r is query j = (row0 + r) / G of the row
    const int limit = min(kv_len, start + (row0 + tid) / G + 1);
    lim_s[tid] = tid < n_rows ? max(0, limit) : 0;
    m_s[tid] = -1e30f;
    z_s[tid] = 0.0f;
  }
  // the last query of the block sees the most
  const int stop = max(0, min(kv_len, start + (row0 + n_rows - 1) / G + 1));
  const int n_tiles = (stop + kTile - 1) / kTile;

  auto load_tile = [&](int tile, int stage) {
    T* ks = tiles + stage * 2 * kTile * kRow;
    T* vs = ks + kTile * kRow;
    for (int c = tid; c < kTile * kChunksPerRow; c += kThreads) {
      const int j = c / kChunksPerRow, col = (c % kChunksPerRow) * kVec;
      const int pos = tile * kTile + j;
      const bool valid = pos < stop;
      cp_async16(ks + j * kRow + col, valid ? krows.at(pos) + col : krows.base, valid);
      cp_async16(vs + j * kRow + col, valid ? vrows.at(pos) + col : vrows.base, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();  // one group per tile slot, empty or not
  }

  const int j_own = tid % kTile;    // score: this thread's kv position
  const int r_score = tid / kTile;  // and its first row
  const int d_own = tid % HD;       // output: this thread's column
  const int r_pv = tid / HD;        // and its first row
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // for every thread; and tile t-1 is done with
    {
      const int next = t + kStages - 1;  // into the stage tile t-1 used
      if (next < n_tiles) load_tile(next, next % kStages);
      cp_async_commit();
    }
    const T* ks = tiles + (t % kStages) * 2 * kTile * kRow;
    const T* vs = ks + kTile * kRow;

    // scores: thread (j_own, r_score) -> rows r_score, r_score + kScoreStep, ...
    float dots[kDots];
#pragma unroll
    for (int i = 0; i < kDots; ++i) dots[i] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < HD; c += kVec) {
      float kv[kVec];
      load16(ks + j_own * kRow + c, kv);
#pragma unroll
      for (int i = 0; i < kDots; ++i) {
        const int r = r_score + i * kScoreStep;
        if (r < n_rows) {
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(q_s + r * HD + c + e);
            dots[i] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] + qv.w * kv[e + 3];
          }
        }
      }
    }
    const int pos = t * kTile + j_own;
#pragma unroll
    for (int i = 0; i < kDots; ++i) {
      const int r = r_score + i * kScoreStep;
      if (r < n_rows) p_s[r * kTile + j_own] = pos < lim_s[r] ? dots[i] * scale : -1e30f;
    }
    __syncthreads();

    // online softmax: warp w -> rows w, w + 8, ...; lane -> positions lane, lane + 32
    for (int r = warp; r < n_rows; r += kThreads / 32) {
      float* row = p_s + r * kTile;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(fmaxf(m_old, warp_max(fmaxf(s0, s1))), -1e29f);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float tile_sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        m_s[r] = m_new;
        z_s[r] = z_s[r] * alpha + tile_sum;
      }
    }
    __syncthreads();

    // o += p v: thread (d_own, r_pv) -> rows r_pv, r_pv + kPvStep, ...
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r_pv + i * kPvStep;
      if (r < n_rows) acc[i] *= alpha_s[r];
    }
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = to_f32(vs[(j + e) * kRow + d_own]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int r = r_pv + i * kPvStep;
        if (r < n_rows) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + r * kTile + j);
          acc[i] += p.x * v[0] + p.y * v[1] + p.z * v[2] + p.w * v[3];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = r_pv + i * kPvStep;
    if (r < n_rows) o[r * HD + d_own] = acc[i];
  }
  if (tid < n_rows) {
    m_out[tid] = fmaxf(m_s[tid], -1e29f);
    z_out[tid] = z_s[tid];
  }
}

// grid (K, B, query tiles): block (k, b, t) owns rows t * kRows .. of the
// S*G query rows of (b, k)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) ragged_attn_kernel(
    const float* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ starts, const int* __restrict__ lens, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ z_out, int K, int SG, int G, int W,
    int64_t k_sb, int64_t k_sk, int64_t k_sw,
    int64_t v_sb, int64_t v_sk, int64_t v_sw,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int64_t first = (static_cast<int64_t>(b) * K + k) * SG + row0;  // global row index
  const DenseRows<T> krows{kc + b * k_sb + k * k_sk, k_sw};
  const DenseRows<T> vrows{vc + b * v_sb + k * v_sk, v_sw};
  attend_rows<T, HD>(smem, q + first * HD, krows, vrows, row0, min(kRows, SG - row0), G,
                     starts[b], max(0, min(lens[b], W)), o + first * HD, m_out + first,
                     z_out + first, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) ragged_paged_attn_kernel(
    const float* __restrict__ q,
    const T* __restrict__ pk, const T* __restrict__ pv,  // one layer: [N, K, page, HD]
    const int* __restrict__ tables,  // [B, table_stride]
    const int* __restrict__ starts, const int* __restrict__ lens, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ z_out, int K, int SG, int G, int wpages,
    int page, int64_t table_stride,
    int64_t k_sn, int64_t k_sk, int64_t k_sp,
    int64_t v_sn, int64_t v_sk, int64_t v_sp,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* pages = reinterpret_cast<int*>(smem + RaggedLayout<T, HD>::kBytes);  // [wpages]
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int n_rows = min(kRows, SG - row0);
  const int64_t first = (static_cast<int64_t>(b) * K + k) * SG + row0;
  const int start = starts[b];
  const int len = max(0, min(lens[b], wpages * page));
  // only the pages the block's last query can see: attend_rows stops there
  const int stop = max(0, min(len, start + (row0 + n_rows - 1) / G + 1));
  const int n_pages = (stop + page - 1) / page;
  for (int p = threadIdx.x; p < n_pages; p += kThreads) pages[p] = tables[b * table_stride + p];
  __syncthreads();  // the table row is read by every thread's copies
  const PagedRows<T> krows{pk + k * k_sk, pages, page, k_sn, k_sp};
  const PagedRows<T> vrows{pv + k * v_sk, pages, page, v_sn, v_sp};
  attend_rows<T, HD>(smem, q + first * HD, krows, vrows, row0, n_rows, G, start, len,
                     o + first * HD, m_out + first, z_out + first, scale);
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const int* starts, const int* lens,
           void* o, void* m, void* z, int B, int K, int S, int G, int W, int64_t k_sb,
           int64_t k_sk, int64_t k_sw, int64_t v_sb, int64_t v_sk, int64_t v_sw, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = RaggedLayout<T, HD>::kBytes;
  cudaError_t err = allow_smem(ragged_attn_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int SG = S * G;
  dim3 grid(K, B, (SG + kRows - 1) / kRows);
  ragged_attn_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      starts, lens, static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(z), K,
      SG, G, W, k_sb, k_sk, k_sw, v_sb, v_sk, v_sw, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_paged(const void* q, const void* pk, const void* pv, const int* tables,
                 const int* starts, const int* lens, void* o, void* m, void* z, int B, int K,
                 int S, int G, int wpages, int page, int64_t table_stride, int64_t k_sn,
                 int64_t k_sk, int64_t k_sp, int64_t v_sn, int64_t v_sk, int64_t v_sp,
                 float scale, cudaStream_t stream) {
  const size_t bytes = RaggedLayout<T, HD>::kBytes + sizeof(int) * static_cast<size_t>(wpages);
  cudaError_t err = allow_smem(ragged_paged_attn_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int SG = S * G;
  dim3 grid(K, B, (SG + kRows - 1) / kRows);
  ragged_paged_attn_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      tables, starts, lens, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(z), K, SG, G, wpages, page, table_stride, k_sn, k_sk, k_sp, v_sn,
      v_sk, v_sp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q is [B, K, S, G, hd] f32 contiguous; o the same, m and z [B, K, S, G].
// kv_dtype: 0 = float32, 1 = bfloat16.  The cache pointers and every cache
// stride must be 16-byte multiples (the wrapper checks).  Returns 0 on
// success, the CUDA error code of a refused launch, or -1 for a shape or
// type the kernel does not take.
extern "C" int calfkit_ragged_attention(
    int kv_dtype, int hd, const void* q, const void* kc, const void* vc, const int* starts,
    const int* lens, void* o, void* m, void* z, int B, int K, int S, int G, int W,
    long long k_sb, long long k_sk, long long k_sw, long long v_sb, long long v_sk,
    long long v_sw, float scale, void* stream) {
  if (G < 1 || S < 1 || B < 0 || K < 0 || W < 0) return -1;
  if (B == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALFKIT_RAGGED(T, HD)                                                                   \
  return launch<T, HD>(q, kc, vc, starts, lens, o, m, z, B, K, S, G, W, k_sb, k_sk, k_sw, v_sb, \
                       v_sk, v_sw, scale, s)
  if (kv_dtype == 0 && hd == 64) CALFKIT_RAGGED(float, 64);
  if (kv_dtype == 0 && hd == 128) CALFKIT_RAGGED(float, 128);
  if (kv_dtype == 1 && hd == 64) CALFKIT_RAGGED(__nv_bfloat16, 64);
  if (kv_dtype == 1 && hd == 128) CALFKIT_RAGGED(__nv_bfloat16, 128);
#undef CALFKIT_RAGGED
  return -1;
}

// The paged form: pk/pv point at one layer of the pool [L, N, K, page, hd]
// (k_sn/k_sk/k_sp: its page, head and position strides, in elements);
// tables is [B, table_stride] int32 with at least wpages entries a row.
// Any page size >= 1; the same return codes as above.
extern "C" int calfkit_ragged_paged_attention(
    int kv_dtype, int hd, const void* q, const void* pk, const void* pv, const int* tables,
    const int* starts, const int* lens, void* o, void* m, void* z, int B, int K, int S, int G,
    int wpages, int page, long long table_stride, long long k_sn, long long k_sk,
    long long k_sp, long long v_sn, long long v_sk, long long v_sp, float scale, void* stream) {
  if (G < 1 || S < 1 || B < 0 || K < 0 || wpages < 0 || page < 1) return -1;
  if (B == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALFKIT_RAGGED_PAGED(T, HD)                                                        \
  return launch_paged<T, HD>(q, pk, pv, tables, starts, lens, o, m, z, B, K, S, G, wpages, \
                             page, table_stride, k_sn, k_sk, k_sp, v_sn, v_sk, v_sp, scale, s)
  if (kv_dtype == 0 && hd == 64) CALFKIT_RAGGED_PAGED(float, 64);
  if (kv_dtype == 0 && hd == 128) CALFKIT_RAGGED_PAGED(float, 128);
  if (kv_dtype == 1 && hd == 64) CALFKIT_RAGGED_PAGED(__nv_bfloat16, 64);
  if (kv_dtype == 1 && hd == 128) CALFKIT_RAGGED_PAGED(__nv_bfloat16, 128);
#undef CALFKIT_RAGGED_PAGED
  return -1;
}
