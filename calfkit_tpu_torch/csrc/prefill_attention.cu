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
// Both kernels give a block 64 query rows of one (b, kv head): 64/G query
// positions times all G heads of the group, so each K/V tile it loads from
// device memory serves every head that shares it.  K/V stream by in tiles
// under an online softmax (the [Sq, Skv] score matrix is never formed), and
// tiles past the block's last visible position are skipped, which halves
// the work of a whole prompt.
//
// bf16 q and cache (the serving path) take the warpgroup kernel.  What it
// does about each limit of the WMMA body it replaced:
// 1. Occupancy.  A block is one consumer warpgroup (the 64 rows: wgmma's M)
//    and one producer warp, and its shared memory holds only Q and the K/V
//    ring (81 KB at hd 128, was 148 KB), so two blocks share an SM and one
//    block's softmax runs while the other's products do.  Blocks start
//    heaviest first (the latest query positions), so a causal launch ends
//    on short blocks.
// 2. Shared-memory round trips.  Scores, probabilities and the output
//    accumulator stay in registers for the whole block.  A row's values sit
//    in one quad of lanes, so its max takes two shuffles; each lane keeps
//    its share of z, summed across the quad once at the end; rescaling o by
//    alpha is a register multiply.
// 3. Tensor cores.  S = Q K^T by wgmma m64n64k16 with both operands read
//    from shared memory through descriptors; O += P V by wgmma m64n{hd}k16
//    with P (rounded to bf16; the accumulator layout of S is the A
//    fragment's) in registers and the V tile read transposed.  z sums the
//    rounded probabilities the product uses.  Base 2, scale*log2(e) folded
//    into one fma.
// 4. Copies.  The producer keeps TMA loads of the next tiles in flight in
//    an mbarrier ring (2 stages at hd 128, 4 at hd 64) while the warpgroup
//    computes.  The tensor maps read the cache view in place through its
//    strides, land each 64-column slab 128-byte swizzled as the wgmma
//    descriptors read it, and fill rows past Skv with zeros.
// 5. Masks.  A tile below every valid row's q_pos and below seq_len takes
//    no mask; only tiles on the diagonal or at seq_len are masked.
// 6. Narrow launches (the draft path's forwards of 1-8 queries, whose
//    blocks are mostly padding rows) are bound by their K/V bytes: the
//    padding rows cost only tensor-core instructions, and are never written.
// 7. Epilogue.  The normalized bf16 rows are staged in Q's shared memory
//    and written with 16-byte stores.
//
// float32 (or mixed) inputs keep f32 arithmetic on the CUDA cores, so an f32
// run stays within f32 rounding of the plain attention.

#include <cuda.h>  // CUtensorMap; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// bf16 q and cache: warpgroup tensor-core products (wgmma), K/V fed by TMA
// --------------------------------------------------------------------------

constexpr int kConsumers = 128;              // one warpgroup: the rows' products and softmax
constexpr int kWgThreads = kConsumers + 32;  // and a producer warp, whose lane 0 starts the copies
constexpr int kKvTile = 64;                  // kv positions per tile
constexpr int kSlab = 64 * 128;              // bytes of 64 rows of one 128-byte swizzle row

template <int HD>
struct WgLayout {
  static constexpr int kSlabs = HD / 64;  // 64-column slabs of a row
  static constexpr int kStages = HD == 128 ? 2 : 4;
  static constexpr int kTileBytes = kSlabs * kSlab;  // Q, or one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // slack to align the swizzled tiles to 1 KB; Q; the ring; its full and
  // empty barriers; the rows' query positions
  static constexpr size_t kBytes =
      1024 + kTileBytes + kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + kRows * sizeof(int);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a [64 rows][HD] bf16 tile
// stored as 64-column slabs, 128-byte swizzled (chunk c % 8 of a 128-byte
// row lands at (c % 8) ^ (r % 8)): the layout TMA writes and wgmma reads
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c >> 3) * kSlab + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// a wgmma shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}
// K-major (Q, K: the contracted hd axis contiguous): 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return smem_desc(addr, 16, 1024); }
// MN-major (V read transposed: hd contiguous): the next 64 columns one slab
// on, the next 8 positions 1 KB on
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) { return smem_desc(addr, kSlab, 1024); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one 64 x 64 box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// plain shared-memory stores, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of the consumer warpgroup alone (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= a b for m64n64k16, both operands in shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a b for m64n64k16: a (bf16 pairs) in registers, b in shared memory
// MN-major (read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b for m64n128k16: a (bf16 pairs) in registers, b in shared memory
// MN-major (read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 2) prefill_attn_wgmma_kernel(
    const __grid_constant__ CUtensorMap k_map,  // the K view as (hd, Skv, K, B)
    const __grid_constant__ CUtensorMap v_map,
    const bf16* __restrict__ q, const int* __restrict__ q_pos, const int* __restrict__ seq_lens,
    bf16* __restrict__ out,  // [B, Sq, H, HD] contiguous
    int Sq, int H, int G, int Skv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t qp_sb,
    float scale) {
  using L = WgLayout<HD>;
  constexpr int kStages = L::kStages;
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  extern __shared__ unsigned char wg_smem[];
  unsigned char* q_s = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* ring = q_s + L::kTileBytes;  // [stage][K, V] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;
  int* qpos_s = reinterpret_cast<int*>(empty + kStages);

  // the heaviest blocks (the latest query positions) first: grid z runs
  // over the query blocks backwards, y over batch rows, x over kv heads
  const int bq = kRows / G;  // query positions per block
  const int s0 = (gridDim.z - 1 - blockIdx.z) * bq;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  // row r = (query position s0 + r / G, head kh * G + r % G)
  if (tid < kRows) {
    const int s = s0 + tid / G;
    qpos_s[tid] = s < Sq ? q_pos[b * qp_sb + s] : -1;  // -1: a padding row, all masked
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);            // the producer's arrival, then the tile's bytes
      mbar_init(&empty[i], kConsumers);  // every consumer is done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the valid rows (positions before Sq) decide the tiles: those from
  // kv_end on are masked for every row and skipped; those before n_full are
  // visible to every row and take no mask
  const int lim = min(Skv, seq_lens[b]);
  int lo = 0x7fffffff, hi = -1;
  for (int i = 0; i < bq && s0 + i < Sq; ++i) {
    lo = min(lo, qpos_s[i * G]);
    hi = max(hi, qpos_s[i * G]);
  }
  const int kv_end = max(0, min(lim, hi + 1));
  const int n_tiles = (kv_end + kKvTile - 1) / kKvTile;
  const int n_full = max(0, min(lim - 1, lo) + 1) / kKvTile;

  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        unsigned char* kt = ring + st * L::kStageBytes;
        mbar_expect_tx(&full[st], L::kStageBytes);
#pragma unroll
        for (int c = 0; c < L::kSlabs; ++c) {
          tma_load_4d(kt + c * kSlab, &k_map, &full[st], c * 64, t * kKvTile, kh, b);
          tma_load_4d(kt + L::kTileBytes + c * kSlab, &v_map, &full[st], c * 64, t * kKvTile, kh, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup; thread (warp w, lane l) holds, of every 8
  // columns of a product, columns 2 (l % 4) and 2 (l % 4) + 1 of rows
  // 16 w + l / 4 ("a") and that + 8 ("b")
  const int lane = tid & 31;
  const int ra = (tid >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);

  // Q, zeros past Sq, in the layout the descriptors read
  for (int c = tid; c < kRows * kChunks; c += kConsumers) {
    const int r = c / kChunks, ch = c % kChunks, s = s0 + r / G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < Sq)
      val = *reinterpret_cast<const uint4*>(q + b * q_sb + s * q_ss + (kh * G + r % G) * q_sh + ch * 8);
    *reinterpret_cast<uint4*>(q_s + swizzled(r, ch)) = val;
  }
  fence_proxy_async();
  consumers_sync();

  const int qp_a = qpos_s[ra], qp_b = qpos_s[ra + 8];
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const float neg_inf = __int_as_float(0xff800000);
  const uint32_t q_addr = smem_u32(q_s);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m_a = -1e30f, m_b = -1e30f;  // running max of the scaled scores, base 2
  float z_a = 0.0f, z_b = 0.0f;      // this lane's share of the rows' sums

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t k_addr = smem_u32(ring + st * L::kStageBytes);
    const uint32_t v_addr = k_addr + L::kTileBytes;
    mbar_wait(&full[st], (t / kStages) & 1);

    // s = q k^T, [64 rows, 64 positions], in hd / 16 steps of 16
    float s[32];
    wgmma_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
      wgmma_ss_n64(s, kmajor_desc(q_addr + off), kmajor_desc(k_addr + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    if (t >= n_full) {  // an edge tile: masked scores -inf, which gives p = 0
      const int pos0 = t * kKvTile + cq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = pos0 + 8 * j + e;
          if (pos > qp_a || pos >= lim) s[4 * j + e] = neg_inf;
          if (pos > qp_b || pos >= lim) s[4 * j + 2 + e] = neg_inf;
        }
      }
      // cache rows at or past seq_len may hold anything, and a NaN there
      // would survive p = 0: zero them (rows past Skv arrive as zeros)
      const int tail = lim - t * kKvTile;
      if (tail > 0 && tail < kKvTile && lim < Skv) {
        unsigned char* vt = ring + st * L::kStageBytes + L::kTileBytes;
        for (int i = tid; i < (kKvTile - tail) * L::kSlabs * 8; i += kConsumers) {
          const int r = tail + i / (L::kSlabs * 8), c = i % (L::kSlabs * 8);
          *reinterpret_cast<uint4*>(vt + (c >> 3) * kSlab + r * 128 + (c & 7) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        consumers_sync();
      }
    }

    // online softmax: a row's 64 scores lie in one quad of lanes
    float mx_a = neg_inf, mx_b = neg_inf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(fmaxf(m_a, mx_a * scale_log2), -1e29f);
    const float mn_b = fmaxf(fmaxf(m_b, mx_b * scale_log2), -1e29f);
    const float alpha_a = fast_exp2(m_a - mn_a), alpha_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // p rounded to bf16, packed as the A fragments of o += p v: k step kk
    // takes p[4 kk .. 4 kk + 3]; z sums the rounded values the product uses
    uint32_t p[16];
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 pa = __floats2bfloat162_rn(fast_exp2(fmaf(s[4 * j], scale_log2, -mn_a)),
                                                      fast_exp2(fmaf(s[4 * j + 1], scale_log2, -mn_a)));
      const __nv_bfloat162 pb = __floats2bfloat162_rn(fast_exp2(fmaf(s[4 * j + 2], scale_log2, -mn_b)),
                                                      fast_exp2(fmaf(s[4 * j + 3], scale_log2, -mn_b)));
      const float2 fa = __bfloat1622float2(pa), fb = __bfloat1622float2(pb);
      sum_a += fa.x + fa.y;
      sum_b += fb.x + fb.y;
      p[2 * j] = *reinterpret_cast<const uint32_t*>(&pa);
      p[2 * j + 1] = *reinterpret_cast<const uint32_t*>(&pb);
    }
    z_a = z_a * alpha_a + sum_a;
    z_b = z_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }

    // o += p v, in 4 steps of 16 positions
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kKvTile / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_rs(o, a, mnmajor_desc(v_addr + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[st]);  // the stage is free for the producer
  }

  // normalize; stage the bf16 rows in Q's space, then 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    z_a += __shfl_xor_sync(0xffffffffu, z_a, off);
    z_b += __shfl_xor_sync(0xffffffffu, z_b, off);
  }
  const float inv_a = 1.0f / fmaxf(z_a, 1e-30f), inv_b = 1.0f / fmaxf(z_b, 1e-30f);
  consumers_sync();  // every warp's last product has read Q
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(q_s + swizzled(ra, j) + 2 * cq) =
        __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(q_s + swizzled(ra + 8, j) + 2 * cq) =
        __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
  consumers_sync();
  const int rows = min(kRows, (Sq - s0) * G);  // padding rows are never written
  for (int c = tid; c < rows * kChunks; c += kConsumers) {
    const int r = c / kChunks, ch = c % kChunks, s = s0 + r / G;
    bf16* dst = out + ((static_cast<int64_t>(b) * Sq + s) * H + kh * G + r % G) * HD + ch * 8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(q_s + swizzled(r, ch));
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

template <typename TQ, typename TKV, int HD>
int launch(const Args& a) {
  // above 48 KB only after the opt-in, which holds for the current device
  const auto kernel = prefill_attn_kernel<TQ, TKV, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<HD>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = kRows / (a.H / a.K);
  const dim3 grid((a.Sq + bq - 1) / bq, a.K, a.B);
  kernel<<<grid, kThreads, smem_bytes<HD>(), a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kc), static_cast<const TKV*>(a.vc),
      a.q_pos, a.seq_lens, static_cast<TQ*>(a.out), a.Sq, a.H, a.H / a.K, a.Skv, a.q_sb, a.q_ss,
      a.q_sh, a.k_sb, a.k_sk, a.k_ss, a.v_sb, a.v_sk, a.v_ss, a.qp_sb, a.scale);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda at run time, so the library
// links nothing beyond the CUDA runtime; null where libcuda lacks it
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// the tensor map of a bf16 [B, K, Skv, hd] cache view (element strides sb,
// sk, ss; unit last axis) as dims (hd, Skv, K, B): boxes of 64 columns x 64
// positions, 128-byte swizzled, zeros past Skv
bool encode_kv_map(CUtensorMap* map, const void* base, int B, int K, int Skv, int hd, int64_t sb,
                   int64_t sk, int64_t ss) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(max(Skv, 1)),
                              static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(B)};
  const int64_t given[3] = {ss, sk, sb};
  // an axis of extent 1 may carry any stride: give it the span of the axes
  // inside it, a 16-byte multiple as the map requires
  cuuint64_t strides[3];
  cuuint64_t span = dims[0] * sizeof(bf16);
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? span : static_cast<cuuint64_t>(given[i]) * sizeof(bf16);
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, kKvTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMapRefused = -2;

template <int HD>
int launch_wgmma(const Args& a) {
  CUtensorMap k_map, v_map;
  if (!encode_kv_map(&k_map, a.kc, a.B, a.K, a.Skv, HD, a.k_sb, a.k_sk, a.k_ss) ||
      !encode_kv_map(&v_map, a.vc, a.B, a.K, a.Skv, HD, a.v_sb, a.v_sk, a.v_ss))
    return kMapRefused;
  const auto kernel = prefill_attn_wgmma_kernel<HD>;
  constexpr size_t bytes = WgLayout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = kRows / (a.H / a.K);
  const dim3 grid(a.K, a.B, (a.Sq + bq - 1) / bq);
  kernel<<<grid, kWgThreads, bytes, a.stream>>>(
      k_map, v_map, static_cast<const bf16*>(a.q), a.q_pos, a.seq_lens, static_cast<bf16*>(a.out),
      a.Sq, a.H, a.H / a.K, a.Skv, a.q_sb, a.q_ss, a.q_sh, a.qp_sb, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  With both bfloat16 (the
// wgmma kernel) every pointer and every stride of q, k and v must be a
// 16-byte multiple (the wrapper checks).  Returns 0 on success, the CUDA
// error code of a refused launch, -1 for a shape or type the kernels do not
// take, or -2 when a TMA tensor map of the cache cannot be encoded.
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
    if (hd == 64) return launch_wgmma<64>(a);
    if (hd == 128) return launch_wgmma<128>(a);
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
