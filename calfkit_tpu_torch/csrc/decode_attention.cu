// Single-query GQA decode attention over the KV cache: the dense window, and
// the paged pool read through block tables.
//
// Replaces: calfkit_tpu/inference/pallas_attention.py:60
//   decode_attention_pallas (kernel body _decode_attn_kernel, :33), entry
//   point calfkit_decode_attention; and pallas_attention.py:153
//   paged_decode_attention_pallas (kernel body _paged_attn_kernel, :99),
//   entry point calfkit_paged_decode_attention.  Both share one body.
//
// Computes, for every (batch row b, kv head k) and each of its G query heads:
//   s[w] = (q . k[w]) * scale, masked to -1e30 where w >= base_lens[b]
//   m    = max(max_w s[w], -1e29)          (the floor keeps fresh rows finite)
//   z    = sum_w exp(s[w] - m)
//   o    = sum_w exp(s[w] - m) * v[w]      (UNnormalized, f32)
// and returns (o, m, z), the contract logsumexp_merge folds with the
// fresh-token ring.  In the paged form, position w of row b lives in page
// tables[b, w / page] of the pool's layer, at offset w % page.
//
// What bounds it on an H100: bytes.  Each query head does 4*hd operations
// per cached position while the position costs 2*hd*sizeof(T) bytes of K/V,
// far below the ~295 operations per byte where the tensor cores would be
// the limit.  The least time is the K/V bytes of the valid positions
// (valid positions x K x hd x 2 x sizeof(T)) over the 3.35 TB/s of device
// memory.
//
// What the design does about it:
// - The TPU kernel holds the whole [W, hd] slice in VMEM.  At W=2048,
//   hd=128, bf16 that is 512 KB per operand, above the 227 KB of shared
//   memory a block may use, so this kernel streams the window in tiles of
//   64 positions with a running max and sum (flash accumulation).  The
//   paged TPU kernel runs its page axis as a sequential grid dimension with
//   the statistics in VMEM scratch; here the same running statistics live
//   in the block's shared memory across its own loop over tiles.
// - One block per (b, kv head) serves all G query heads of the group from
//   each K/V tile, so every cache byte is read from device memory once.
// - A block has one SM to itself, so what bounds it is the bytes it keeps
//   in flight: tiles arrive by cp.async, 16 bytes a copy, in a ring of
//   three stages, two tiles loading while the third is computed on.
// - Tiles past base_lens[b] are all masked and change nothing, so the block
//   stops at the row's length; the ragged tail of the last tile is
//   zero-filled, not read: the bytes read are those of valid positions.
//   The paged TPU kernel visits all wpages pages, but a page past
//   ceil(len / page) adds exact zeros: its scores are -1e30, and with the
//   running max m >= -1e29, exp(-1e30 - m) is 0 in f32, while the rescale
//   factor exp(m - m) is 1.  So stopping at the last valid page gives the
//   same (o, m, z); table entries past it (the trash page) are never read.
// - The dense cache is read through its strides: the engine passes a window
//   view of [L, B, K, S, hd] and nothing is copied.  The paged form takes a
//   layer of the whole pool as a strided view (base pointer plus page, head
//   and position strides); TPU scalar prefetch of the block table has no
//   counterpart, so the block copies its row of the table (the pages its
//   length needs) into shared memory once, and each 16-byte copy works out
//   its own page, w / page.  No window is gathered and no layer is copied.
// Left for later: splitting the window across blocks (flash-decoding; B*K
// blocks leave SMs idle at small batch), TMA.

#include "attention_common.cuh"

namespace {

// 8 warps: at serving batch sizes a block is alone on its SM, and its own
// warps are all there are to hide the latency of shared memory and the FMAs
constexpr int kThreads = 256;
constexpr int kTile = 64;      // kv positions per tile
constexpr int kStages = 3;     // tiles in the cp.async ring
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kScoreStep = kThreads / kTile;  // heads between one thread's scores

template <typename T, int HD>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  // +16 bytes a row: lanes reading one column of successive rows with
  // 16-byte loads fall on distinct banks
  static constexpr int kRow = HD + kVec;
  static constexpr size_t kTileBytes = sizeof(T) * kTile * kRow;
  static constexpr size_t kBytes =
      kStages * 2 * kTileBytes + sizeof(float) * (kMaxG * HD + kMaxG * kTile + 3 * kMaxG);
};

// The shared body: the block of (batch row, kv head) `head` attends the
// first `len` positions of its K/V rows.  Uses Layout<T, HD>::kBytes of
// shared memory from `smem`.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend(
    unsigned char* smem,
    const float* __restrict__ q,  // [B, K, G, HD] contiguous
    const Rows& krows, const Rows& vrows, int len, int64_t head, int G,
    float* __restrict__ o,      // [B, K, G, HD]
    float* __restrict__ m_out,  // [B, K, G]
    float* __restrict__ z_out,  // [B, K, G]
    float scale) {
  using L = Layout<T, HD>;
  constexpr int kVec = L::kVec;
  constexpr int kRow = L::kRow;
  constexpr int kChunksPerRow = HD / kVec;
  constexpr int kPvStep = kThreads / HD;  // heads between one thread's accumulators
  constexpr int kAcc = kMaxG / kPvStep;

  T* tiles = reinterpret_cast<T*>(smem);  // [kStages][K, V][kTile][kRow]
  float* q_s = reinterpret_cast<float*>(smem + kStages * 2 * L::kTileBytes);  // [kMaxG][HD]
  float* p_s = q_s + kMaxG * HD;  // [kMaxG][kTile] scores, then probabilities
  float* m_s = p_s + kMaxG * kTile;
  float* z_s = m_s + kMaxG;
  float* alpha_s = z_s + kMaxG;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < G * HD; idx += kThreads) q_s[idx] = q[head * G * HD + idx];
  if (tid < G) {
    m_s[tid] = -1e30f;
    z_s[tid] = 0.0f;
  }

  const int n_tiles = (len + kTile - 1) / kTile;

  auto load_tile = [&](int tile, int stage) {
    T* ks = tiles + stage * 2 * kTile * kRow;
    T* vs = ks + kTile * kRow;
    for (int c = tid; c < kTile * kChunksPerRow; c += kThreads) {
      const int j = c / kChunksPerRow, col = (c % kChunksPerRow) * kVec;
      const int pos = tile * kTile + j;
      const bool valid = pos < len;
      cp_async16(ks + j * kRow + col, valid ? krows.at(pos) + col : krows.base, valid);
      cp_async16(vs + j * kRow + col, valid ? vrows.at(pos) + col : vrows.base, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();  // one group per tile slot, empty or not
  }

  const int j_own = tid % kTile;           // score: this thread's kv position
  const int g_score = tid / kTile;         // and its first head
  const int d_own = tid % HD;              // output: this thread's column
  const int g_pv = tid / HD;               // and its first head
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

    // scores: thread (j_own, g_score) -> heads g_score, g_score + kScoreStep
    float dots[kMaxG / kScoreStep];
#pragma unroll
    for (int i = 0; i < kMaxG / kScoreStep; ++i) dots[i] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < HD; c += kVec) {
      float kv[kVec];
      load16(ks + j_own * kRow + c, kv);
#pragma unroll
      for (int i = 0; i < kMaxG / kScoreStep; ++i) {
        const int g = g_score + i * kScoreStep;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) dots[i] += q_s[g * HD + c + e] * kv[e];
        }
      }
    }
    const bool keep = t * kTile + j_own < len;
#pragma unroll
    for (int i = 0; i < kMaxG / kScoreStep; ++i) {
      const int g = g_score + i * kScoreStep;
      if (g < G) p_s[g * kTile + j_own] = keep ? dots[i] * scale : -1e30f;
    }
    __syncthreads();

    // online softmax: warp w -> head w; lane -> positions lane, lane + 32
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = p_s + g * kTile;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(fmaxf(m_old, warp_max(fmaxf(s0, s1))), -1e29f);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float tile_sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        m_s[g] = m_new;
        z_s[g] = z_s[g] * alpha + tile_sum;
      }
    }
    __syncthreads();

    // o += p v: thread (d_own, g_pv) -> heads g_pv, g_pv + kPvStep, ...
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = g_pv + i * kPvStep;
      if (g < G) acc[i] *= alpha_s[g];
    }
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = to_f32(vs[(j + e) * kRow + d_own]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int g = g_pv + i * kPvStep;
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + g * kTile + j);
          acc[i] += p.x * v[0] + p.y * v[1] + p.z * v[2] + p.w * v[3];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = g_pv + i * kPvStep;
    if (g < G) o[(head * G + g) * HD + d_own] = acc[i];
  }
  if (tid < G) {
    m_out[head * G + tid] = fmaxf(m_s[tid], -1e29f);
    z_out[head * G + tid] = z_s[tid];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const float* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ lens, float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ z_out, int K, int G, int W,
    int64_t k_sb, int64_t k_sk, int64_t k_sw,
    int64_t v_sb, int64_t v_sk, int64_t v_sw,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const DenseRows<T> krows{kc + b * k_sb + k * k_sk, k_sw};
  const DenseRows<T> vrows{vc + b * v_sb + k * v_sk, v_sw};
  attend<T, HD>(smem, q, krows, vrows, max(0, min(lens[b], W)),
                static_cast<int64_t>(b) * K + k, G, o, m_out, z_out, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_attn_kernel(
    const float* __restrict__ q,
    const T* __restrict__ pk, const T* __restrict__ pv,  // one layer: [N, K, page, HD]
    const int* __restrict__ tables,  // [B, table_stride]
    const int* __restrict__ lens, float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ z_out, int K, int G, int wpages, int page, int64_t table_stride,
    int64_t k_sn, int64_t k_sk, int64_t k_sp,
    int64_t v_sn, int64_t v_sk, int64_t v_sp,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* pages = reinterpret_cast<int*>(smem + Layout<T, HD>::kBytes);  // [wpages]
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(0, min(lens[b], wpages * page));
  const int n_pages = (len + page - 1) / page;
  for (int p = threadIdx.x; p < n_pages; p += kThreads) pages[p] = tables[b * table_stride + p];
  __syncthreads();  // the table row is read by every thread's copies
  const PagedRows<T> krows{pk + k * k_sk, pages, page, k_sn, k_sp};
  const PagedRows<T> vrows{pv + k * v_sk, pages, page, v_sn, v_sp};
  attend<T, HD>(smem, q, krows, vrows, len, static_cast<int64_t>(b) * K + k, G, o, m_out,
                z_out, scale);
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const int* lens, void* o,
           void* m, void* z, int B, int K, int G, int W, int64_t k_sb, int64_t k_sk,
           int64_t k_sw, int64_t v_sb, int64_t v_sk, int64_t v_sw, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, HD>::kBytes;
  cudaError_t err = allow_smem(decode_attn_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K, B);
  decode_attn_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      lens, static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(z), K, G, W,
      k_sb, k_sk, k_sw, v_sb, v_sk, v_sw, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_paged(const void* q, const void* pk, const void* pv, const int* tables,
                 const int* lens, void* o, void* m, void* z, int B, int K, int G, int wpages,
                 int page, int64_t table_stride, int64_t k_sn, int64_t k_sk, int64_t k_sp,
                 int64_t v_sn, int64_t v_sk, int64_t v_sp, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<T, HD>::kBytes + sizeof(int) * static_cast<size_t>(wpages);
  cudaError_t err = allow_smem(paged_decode_attn_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K, B);
  paged_decode_attn_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      tables, lens, static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(z), K,
      G, wpages, page, table_stride, k_sn, k_sk, k_sp, v_sn, v_sk, v_sp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_dtype: 0 = float32, 1 = bfloat16.  The cache pointers and every cache
// stride must be 16-byte multiples (the wrapper checks).  Returns 0 on
// success, the CUDA error code of a refused launch, or -1 for a shape or
// type the kernel does not take.
extern "C" int calfkit_decode_attention(
    int kv_dtype, int hd, const void* q, const void* kc, const void* vc, const int* lens,
    void* o, void* m, void* z, int B, int K, int G, int W, long long k_sb, long long k_sk,
    long long k_sw, long long v_sb, long long v_sk, long long v_sw, float scale,
    void* stream) {
  if (G < 1 || G > kMaxG || B < 0 || K < 0 || W < 0) return -1;
  if (B == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALFKIT_DECODE(T, HD) \
  return launch<T, HD>(q, kc, vc, lens, o, m, z, B, K, G, W, k_sb, k_sk, k_sw, v_sb, v_sk, v_sw, scale, s)
  if (kv_dtype == 0 && hd == 64) CALFKIT_DECODE(float, 64);
  if (kv_dtype == 0 && hd == 128) CALFKIT_DECODE(float, 128);
  if (kv_dtype == 1 && hd == 64) CALFKIT_DECODE(__nv_bfloat16, 64);
  if (kv_dtype == 1 && hd == 128) CALFKIT_DECODE(__nv_bfloat16, 128);
#undef CALFKIT_DECODE
  return -1;
}

// The paged form: pk/pv point at one layer of the pool [L, N, K, page, hd]
// (k_sn/k_sk/k_sp: its page, head and position strides, in elements);
// tables is [B, table_stride] int32 with at least wpages entries a row.
// Any page size >= 1; the same return codes as above.
extern "C" int calfkit_paged_decode_attention(
    int kv_dtype, int hd, const void* q, const void* pk, const void* pv, const int* tables,
    const int* lens, void* o, void* m, void* z, int B, int K, int G, int wpages, int page,
    long long table_stride, long long k_sn, long long k_sk, long long k_sp, long long v_sn,
    long long v_sk, long long v_sp, float scale, void* stream) {
  if (G < 1 || G > kMaxG || B < 0 || K < 0 || wpages < 0 || page < 1) return -1;
  if (B == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALFKIT_PAGED(T, HD)                                                                     \
  return launch_paged<T, HD>(q, pk, pv, tables, lens, o, m, z, B, K, G, wpages, page,          \
                             table_stride, k_sn, k_sk, k_sp, v_sn, v_sk, v_sp, scale, s)
  if (kv_dtype == 0 && hd == 64) CALFKIT_PAGED(float, 64);
  if (kv_dtype == 0 && hd == 128) CALFKIT_PAGED(float, 128);
  if (kv_dtype == 1 && hd == 64) CALFKIT_PAGED(__nv_bfloat16, 64);
  if (kv_dtype == 1 && hd == 128) CALFKIT_PAGED(__nv_bfloat16, 128);
#undef CALFKIT_PAGED
  return -1;
}
