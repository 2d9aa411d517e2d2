// Causal GQA flash attention for prefill over the (chunk-updated) KV cache.
//
// Replaces: calfkit_tpu/inference/pallas_attention.py:687
//   prefill_attention_pallas (kernel body _prefill_attn_kernel, :622).
//
// Computes out[b, s, h] = softmax_w(q[b, s, h] . k[b, h / G, w] * scale) v
// over the positions w with w <= q_pos[b, s] and w < seq_lens[b] (masked
// scores are -1e30, the running max is floored at -1e29), NORMALIZED as
// acc / max(z, 1e-30) and written in q's dtype, [B, Sq, H, hd].
//
// What bounds it on an H100: operations.  Each (query head, key) pair it
// keeps costs 2*hd multiply-adds (q.k and p*v), hundreds of operations per
// byte of Q/K/V; the least time is the causal operation count over the
// tensor cores' peak.
//
// What the design does about it:
// - Each block owns 64 query rows of one (b, kv head): 64/G query positions
//   times all G heads of the group, so each K/V tile it loads from device
//   memory serves every head that shares it.
// - K/V stream through shared memory in tiles with an online softmax; the
//   [Sq, Skv] score matrix is never materialized.
// - Tiles entirely above the causal diagonal of the block (or past the
//   row's seq_len) are skipped, which halves the work of a full prefill.
// - bf16 q and cache (the serving path): both products run on the tensor
//   cores through warp-level mma (WMMA, 16x16x16 bf16 -> f32).  Each warp
//   owns 16 of the 64 rows, so the online softmax needs no block barrier,
//   and two lanes share a row, so its 16 rows proceed at once; the
//   probabilities are rounded to bf16 for the p*v product, as flash
//   attention does.  K/V tiles of 64 positions arrive by cp.async into two
//   stages, the next tile loading while this one is computed on.
// - float32 (or mixed) inputs keep f32 arithmetic on the CUDA cores, so an
//   f32 run stays within f32 rounding of the plain attention.
// Left for later: wgmma with TMA-fed tiles and warp specialization, and
// keeping the output accumulator in registers instead of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // query rows (position x head) per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16-byte global -> shared copy; with valid == false it writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// f32 arithmetic on the CUDA cores (float32 or mixed q / cache types)
// --------------------------------------------------------------------------

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 32;      // kv positions per tile: one per lane

template <int HD>
constexpr size_t smem_bytes() {
  // q, k, v tiles (+1 column against bank conflicts), probabilities, and
  // per-row max / sum / rescale / query position
  return sizeof(float) * ((kRows + 2 * kTile) * (HD + 1) + kRows * (kTile + 1) + 4 * kRows);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads) prefill_attn_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kc, const TKV* __restrict__ vc,
    const int* __restrict__ q_pos, const int* __restrict__ seq_lens,
    TQ* __restrict__ out,  // [B, Sq, H, HD] contiguous
    int Sq, int H, int G, int Skv,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_sk, int64_t k_ss,
    int64_t v_sb, int64_t v_sk, int64_t v_ss,
    int64_t qp_sb, float scale) {
  extern __shared__ float smem[];
  float(*q_s)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(smem);
  float(*k_s)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(smem + kRows * (HD + 1));
  float(*v_s)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(smem + (kRows + kTile) * (HD + 1));
  float(*p_s)[kTile + 1] =
      reinterpret_cast<float(*)[kTile + 1]>(smem + (kRows + 2 * kTile) * (HD + 1));
  float* m_s = smem + (kRows + 2 * kTile) * (HD + 1) + kRows * (kTile + 1);
  float* z_s = m_s + kRows;
  float* alpha_s = z_s + kRows;
  int* qpos_s = reinterpret_cast<int*>(alpha_s + kRows);

  constexpr int kAcc = kRows * HD / kThreads;
  constexpr int kRowStep = kThreads / HD;  // rows between one thread's accumulators
  const int bq = kRows / G;                // query positions per block
  const int s0 = blockIdx.x * bq;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // row r = (query position s0 + r / G, head kh * G + r % G)
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, s = s0 + r / G;
    q_s[r][d] = s < Sq ? to_f32(q[b * q_sb + s * q_ss + (kh * G + r % G) * q_sh + d]) : 0.0f;
  }
  if (tid < kRows) {
    const int s = s0 + tid / G;
    qpos_s[tid] = s < Sq ? q_pos[b * qp_sb + s] : -1;  // -1: a padding row, all masked
    m_s[tid] = -1e30f;
    z_s[tid] = 0.0f;
  }
  __syncthreads();

  const int seq_len = seq_lens[b];
  int max_qpos = -1;
  for (int r = 0; r < kRows; ++r) max_qpos = max(max_qpos, qpos_s[r]);
  // tiles past this are masked for every row of the block: skip them
  const int kv_end = max(0, min(min(Skv, seq_len), max_qpos + 1));

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int d_own = tid % HD;
  const int r_own = tid / HD;

  const TKV* kb = kc + b * k_sb + kh * k_sk;
  const TKV* vb = vc + b * v_sb + kh * v_sk;

  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kTile * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, pos = t0 + j;
      k_s[j][d] = pos < Skv ? to_f32(kb[pos * k_ss + d]) : 0.0f;
      v_s[j][d] = pos < Skv ? to_f32(vb[pos * v_ss + d]) : 0.0f;
    }
    __syncthreads();
    // scores + online softmax: warp w owns rows w, w + 8, ...; lane j owns
    // kv position t0 + j of each
    const int pos = t0 + lane;
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += q_s[r][d] * k_s[lane][d];
      const bool keep = pos <= qpos_s[r] && pos < seq_len && pos < Skv;
      const float s = keep ? dot * scale : -1e30f;
      const float m_old = m_s[r];
      const float m_new = fmaxf(fmaxf(m_old, warp_max(s)), -1e29f);
      const float p = expf(s - m_new);
      const float tile_sum = warp_sum(p);
      p_s[r][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        m_s[r] = m_new;
        z_s[r] = z_s[r] * alpha + tile_sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r_own + i * kRowStep;
      float a = acc[i] * alpha_s[r];
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a += p_s[r][j] * v_s[j][d_own];
      acc[i] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = r_own + i * kRowStep, s = s0 + r / G;
    if (r < bq * G && s < Sq) {
      const int64_t off = ((static_cast<int64_t>(b) * Sq + s) * H + kh * G + r % G) * HD + d_own;
      store(out + off, acc[i] / fmaxf(z_s[r], 1e-30f));
    }
  }
}

// --------------------------------------------------------------------------
// bf16 q and cache: tensor cores through WMMA
// --------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps, each owning 16 of the 64 rows
constexpr int kTcTile = 64;      // kv positions per tile
constexpr int kTcStages = 2;     // K/V tiles in the cp.async ring

template <int HD>
struct TcLayout {
  // row pitches in elements; the extra 16 bytes put successive rows on
  // other banks, and keep every 16-row fragment 32-byte aligned for WMMA
  static constexpr int kQRow = HD + 8;       // bf16: q, k and v rows
  static constexpr int kSRow = kTcTile + 4;  // f32 scores
  static constexpr int kPRow = kTcTile + 8;  // bf16 probabilities
  static constexpr int kORow = HD + 4;       // f32 output accumulator
  static constexpr size_t kQ = sizeof(bf16) * kRows * kQRow;
  static constexpr size_t kKV = sizeof(bf16) * kTcTile * kQRow;  // one K or V tile
  static constexpr size_t kS = sizeof(float) * kRows * kSRow;
  static constexpr size_t kP = sizeof(bf16) * kRows * kPRow;
  static constexpr size_t kO = sizeof(float) * kRows * kORow;
  static constexpr size_t kBytes = kQ + kTcStages * 2 * kKV + kS + kP + kO + 3 * sizeof(float) * kRows;
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads) prefill_attn_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kc, const bf16* __restrict__ vc,
    const int* __restrict__ q_pos, const int* __restrict__ seq_lens,
    bf16* __restrict__ out,  // [B, Sq, H, HD] contiguous
    int Sq, int H, int G, int Skv,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_sk, int64_t k_ss,
    int64_t v_sb, int64_t v_sk, int64_t v_ss,
    int64_t qp_sb, float scale) {
  using L = TcLayout<HD>;
  constexpr int kQRow = L::kQRow, kSRow = L::kSRow, kPRow = L::kPRow, kORow = L::kORow;
  constexpr int kChunks = HD / 8;  // 16-byte copies per row
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);             // [kRows][kQRow]
  bf16* kv_s = reinterpret_cast<bf16*>(tc_smem + L::kQ);    // [stage][K, V][kTcTile][kQRow]
  unsigned char* rest = tc_smem + L::kQ + kTcStages * 2 * L::kKV;
  float* s_s = reinterpret_cast<float*>(rest);                         // [kRows][kSRow]
  bf16* p_s = reinterpret_cast<bf16*>(rest + L::kS);                   // [kRows][kPRow]
  float* o_s = reinterpret_cast<float*>(rest + L::kS + L::kP);         // [kRows][kORow]
  float* m_s = o_s + kRows * kORow;
  float* z_s = m_s + kRows;
  int* qpos_s = reinterpret_cast<int*>(z_s + kRows);

  const int bq = kRows / G;  // query positions per block
  const int s0 = blockIdx.x * bq;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16;  // this warp's first row
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  // row r = (query position s0 + r / G, head kh * G + r % G); zeros past Sq
  for (int c = tid; c < kRows * kChunks; c += kTcThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8, s = s0 + r / G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < Sq)
      val = *reinterpret_cast<const uint4*>(q + b * q_sb + s * q_ss + (kh * G + r % G) * q_sh + col);
    *reinterpret_cast<uint4*>(q_s + r * kQRow + col) = val;
  }
  for (int idx = tid; idx < kRows * HD; idx += kTcThreads) o_s[(idx / HD) * kORow + idx % HD] = 0.0f;
  if (tid < kRows) {
    const int s = s0 + tid / G;
    qpos_s[tid] = s < Sq ? q_pos[b * qp_sb + s] : -1;  // -1: a padding row, all masked
    m_s[tid] = -1e30f;
    z_s[tid] = 0.0f;
  }
  __syncthreads();

  const int lim = min(Skv, seq_lens[b]);
  int max_qpos = -1;
  for (int r = 0; r < kRows; ++r) max_qpos = max(max_qpos, qpos_s[r]);
  // tiles past this are masked for every row of the block: skip them
  const int kv_end = max(0, min(lim, max_qpos + 1));
  const int n_tiles = (kv_end + kTcTile - 1) / kTcTile;

  const bf16* kb = kc + b * k_sb + kh * k_sk;
  const bf16* vb = vc + b * v_sb + kh * v_sk;
  auto load_tile = [&](int tile, int stage) {
    bf16* ks = kv_s + stage * 2 * kTcTile * kQRow;
    bf16* vs = ks + kTcTile * kQRow;
    for (int c = tid; c < kTcTile * kChunks; c += kTcThreads) {
      const int j = c / kChunks, col = (c % kChunks) * 8, pos = tile * kTcTile + j;
      const bool valid = pos < kv_end;
      const int64_t src = valid ? pos : 0;
      cp_async16(ks + j * kQRow + col, kb + src * k_ss + col, valid);
      cp_async16(vs + j * kQRow + col, vb + src * v_ss + col, valid);
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // this warp's 16 query rows stay in registers for the whole block
  wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wm::load_matrix_sync(qf[kk], q_s + r0 * kQRow + kk * 16, kQRow);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t has landed
    __syncthreads();      // for every warp; and tile t-1's stage is free
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) % kTcStages);
    cp_async_commit();
    const bf16* ks = kv_s + (t % kTcStages) * 2 * kTcTile * kQRow;
    const bf16* vs = ks + kTcTile * kQRow;

    // s = q k^T for this warp's rows: [16, kTcTile]
#pragma unroll
    for (int n = 0; n < kTcTile / 16; ++n) {
      wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
      wm::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kf;
        wm::load_matrix_sync(kf, ks + n * 16 * kQRow + kk * 16, kQRow);
        wm::mma_sync(acc, qf[kk], kf, acc);
      }
      wm::store_matrix_sync(s_s + r0 * kSRow + n * 16, acc, kSRow, wm::mem_row_major);
    }
    __syncwarp();

    // online softmax in base 2 (scores pre-scaled by log2(e)): lane pair
    // (row r0 + lane / 2, half lane % 2) takes 32 of the row's 64 scores,
    // so the 16 rows proceed at once; each lane walks its columns (and its
    // half of the output row) rotated by its lane number, which puts the
    // 32 lanes on 32 different banks
    {
      const int r = r0 + (lane >> 1), half = lane & 1;
      const int qp = qpos_s[r];
      const int pos0 = t * kTcTile + half * 32;
      const float* srow = s_s + r * kSRow + half * 32;
      float sv[32];
      float mx = -1e30f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i + lane) & 31, pos = pos0 + c;
        sv[i] = pos <= qp && pos < lim ? srow[c] * scale_log2 : -1e30f;
        mx = fmaxf(mx, sv[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(fmaxf(m_old, mx), -1e29f);
      bf16* prow = p_s + r * kPRow + half * 32;
      float sum = 0.0f;  // of the rounded probabilities the p*v product uses
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bf16 p = __float2bfloat16(exp2f(sv[i] - m_new));
        prow[(i + lane) & 31] = p;
        sum += __bfloat162float(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);  // both lanes have read m_s[r]
      const float alpha = exp2f(m_old - m_new);
      float* orow = o_s + r * kORow + half * (HD / 2);
#pragma unroll 8
      for (int i = 0; i < HD / 2; ++i) orow[(i + lane) & (HD / 2 - 1)] *= alpha;
      if (half == 0) {
        m_s[r] = m_new;
        z_s[r] = z_s[r] * alpha + sum;
      }
    }
    __syncwarp();

    // o += p v for this warp's rows: [16, HD]
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pf[kTcTile / 16];
#pragma unroll
    for (int kk = 0; kk < kTcTile / 16; ++kk) wm::load_matrix_sync(pf[kk], p_s + r0 * kPRow + kk * 16, kPRow);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
      wm::load_matrix_sync(acc, o_s + r0 * kORow + n * 16, kORow, wm::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTcTile / 16; ++kk) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vf;
        wm::load_matrix_sync(vf, vs + kk * 16 * kQRow + n * 16, kQRow);
        wm::mma_sync(acc, pf[kk], vf, acc);
      }
      wm::store_matrix_sync(o_s + r0 * kORow + n * 16, acc, kORow, wm::mem_row_major);
    }
    __syncwarp();
  }

  for (int r = r0; r < r0 + 16; ++r) {
    const int s = s0 + r / G;
    if (s >= Sq) continue;
    const float z = fmaxf(z_s[r], 1e-30f);
    bf16* dst = out + ((static_cast<int64_t>(b) * Sq + s) * H + kh * G + r % G) * HD;
    for (int d = lane; d < HD; d += 32) dst[d] = __float2bfloat16(o_s[r * kORow + d] / z);
  }
}

struct Args {
  const void *q, *kc, *vc;
  const int *q_pos, *seq_lens;
  void* out;
  int B, Sq, H, K, Skv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_sk, k_ss, v_sb, v_sk, v_ss, qp_sb;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, typename Kernel>
int launch_with(Kernel kernel, size_t bytes, int threads, const Args& a) {
  // above 48 KB only after the opt-in, which holds for the current device
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.H / a.K;
  const int bq = kRows / G;
  dim3 grid((a.Sq + bq - 1) / bq, a.K, a.B);
  kernel<<<grid, threads, bytes, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kc), static_cast<const TKV*>(a.vc),
      a.q_pos, a.seq_lens, static_cast<TQ*>(a.out), a.Sq, a.H, G, a.Skv, a.q_sb, a.q_ss,
      a.q_sh, a.k_sb, a.k_sk, a.k_ss, a.v_sb, a.v_sk, a.v_ss, a.qp_sb, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int HD>
int launch(const Args& a) {
  return launch_with<TQ, TKV>(prefill_attn_kernel<TQ, TKV, HD>, smem_bytes<HD>(), kThreads, a);
}

template <int HD>
int launch_tc(const Args& a) {
  return launch_with<bf16, bf16>(prefill_attn_tc_kernel<HD>, TcLayout<HD>::kBytes, kTcThreads, a);
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  With both bfloat16 (the
// tensor-core kernel) every pointer and every stride of q, k and v must be
// a 16-byte multiple (the wrapper checks).  Returns 0 on success, the CUDA
// error code of a refused launch, or -1 for a shape or type the kernel does
// not take.
extern "C" int calfkit_prefill_attention(
    int q_dtype, int kv_dtype, int hd, const void* q, const void* kc, const void* vc,
    const int* q_pos, const int* seq_lens, void* out, int B, int Sq, int H, int K, int Skv,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_sk,
    long long k_ss, long long v_sb, long long v_sk, long long v_ss, long long qp_sb,
    float scale, void* stream) {
  if (K < 1 || H % K != 0 || kRows % (H / K) != 0 || B < 0 || Sq < 0 || Skv < 0) return -1;
  if (B == 0 || Sq == 0) return 0;
  const Args a{q, kc, vc, q_pos, seq_lens, out, B, Sq, H, K, Skv, q_sb, q_ss, q_sh,
               k_sb, k_sk, k_ss, v_sb, v_sk, v_ss, qp_sb, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 1 && kv_dtype == 1) {
    if (hd == 64) return launch_tc<64>(a);
    if (hd == 128) return launch_tc<128>(a);
    return -1;
  }
  if (q_dtype == 0 && kv_dtype == 0 && hd == 64) return launch<float, float, 64>(a);
  if (q_dtype == 0 && kv_dtype == 0 && hd == 128) return launch<float, float, 128>(a);
  if (q_dtype == 0 && kv_dtype == 1 && hd == 64) return launch<float, bf16, 64>(a);
  if (q_dtype == 0 && kv_dtype == 1 && hd == 128) return launch<float, bf16, 128>(a);
  if (q_dtype == 1 && kv_dtype == 0 && hd == 64) return launch<bf16, float, 64>(a);
  if (q_dtype == 1 && kv_dtype == 0 && hd == 128) return launch<bf16, float, 128>(a);
  return -1;
}
