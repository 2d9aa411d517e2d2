// The split-window attention body shared by the decode kernels
// (decode_attention.cu) and the ragged multi-query kernels
// (ragged_attention.cu) over the dense window, and by their paged forms over
// f32 pools (bf16 pools take the walk of paged_attention.cuh, which runs
// TcBody's products).
//
// A launch computes, for every (batch row b, kv head k) and each of its S*G
// query rows r = j * G + g (query j of the row, query head g of the group):
//   s[w] = (q[r] . k[w]) * scale, masked to -1e30 where
//          w >= min(kv_len[b], start[b] + j + 1)     (the ragged mask law)
//   m    = max(max_w s[w], -1e29)
//   z    = sum_w exp(s[w] - m)
//   o    = sum_w exp(s[w] - m) * v[w]      (UNnormalized, f32)
// Decode is the law at S = 1 with start = kv_len.
//
// The grid is (kv head, row, split x query tile).  A split is a run of
// whole 64-position tiles (split_pos positions; the wrapper derives it from
// the shape).  A block walks its split only, up to the stop of its query
// tile, min(kv_len, start + j_last + 1); a split at or past the stop exits
// at once and writes nothing (split 0 always runs, so a row with nothing to
// see still gets o = 0, m = -1e29, z = 0).  Where a query tile has more
// than one live split, each writes its partial (o, m, z) to f32 scratch and
// takes a ticket; the last to arrive resets the ticket to 0 and folds the
// partials in split order (m = max m_i, w_i = exp(m_i - m), o = sum w_i o_i,
// z = sum w_i z_i), so the result is the same bits from run to run.  A
// split's masked positions add exp(-1e30 - m) = 0 with m >= -1e29, so the
// fold of the splits is the whole window's (o, m, z).
//
// bf16 caches: the products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate) and stay f32-exact.  K and V are exact in bf16;
// q (f32) and the probabilities p are each carried as the sum of three bf16
// terms (x = hi + mid + lo leaves |x| * 2^-24), one product per term, all
// accumulated in f32.  A q that arrives in bf16 is one term.  A block has
// 16 or 32 query rows (one or two m16 tiles) and four warps a row tile,
// each on 16 positions of every 64-position tile, with its own running
// max and sum; the four fold in order when the split is done.
//
// f32 caches: the products run in f32 on the CUDA cores, a block of 8
// query rows (where S*G fits) or 32 over 256 threads, in the same split grid.

#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kTile = 64;       // kv positions per tile
constexpr int kMaxSplits = 64;  // splits of one window (the wrapper keeps to it)

struct SplitArgs {
  const void* q;  // [B, K, S, G, HD] through its strides (unit last stride)
  int64_t q_sb, q_sk, q_ss, q_sg;
  const int* starts;  // [B]
  const int* lens;    // [B]
  float* o;           // [B, K, S, G, HD] contiguous
  float* m;           // [B, K, S, G]
  float* z;
  float* po;          // partials: [n_splits, B*K*S*G, HD]
  float* pm;          // [n_splits, B*K*S*G]
  float* pz;
  unsigned* tickets;  // one a query tile of a (row, kv head); 0 between launches
  int B, K, S, G;
  int window;         // positions the row may hold: kv_len is clamped to it
  int n_splits, split_pos;
  int qtiles;         // query tiles a (row, kv head): set at launch
  float scale;
};

// ---------------------------------------------------------------- tensor cores

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b: a the m16k16 row-major fragment, (b0, b1) the k16n8 column one
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as N bf16 terms, largest first: x - (t0 + ... + t_{N-1}) is below
// |x| * 2^-(8N) (each rounding to bf16 keeps 8 significant bits)
template <int N>
__device__ __forceinline__ void bf16_terms(float x, __nv_bfloat16 (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(t[i]);
  }
}

// a pair (x0, x1) of one row as N packed bf16x2 terms (x0 in the low half)
template <int N>
__device__ __forceinline__ void pack_terms(float x0, float x1, uint32_t (&out)[N]) {
  __nv_bfloat16 a[N], b[N];
  bf16_terms<N>(x0, a);
  bf16_terms<N>(x1, b);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    __nv_bfloat162 h;
    h.x = a[i];
    h.y = b[i];
    out[i] = *reinterpret_cast<uint32_t*>(&h);
  }
}

constexpr int kPTerms = 3;  // bf16 terms of each probability

template <typename TQ, int HD, int RT>
struct TcBody {
  static constexpr int kQTerms = std::is_same<TQ, __nv_bfloat16>::value ? 1 : 3;
  static constexpr int kRows = 16 * RT;         // query rows a block
  static constexpr int kThreads = 128 * RT;     // four warps a row tile
  static constexpr int kStages = 2;  // two blocks an SM, with an f32 q's three terms too
  static constexpr int kMinBlocks = 2;  // and registers for two: at most 128 a thread at RT = 2
  // +16 bytes a row: the eight rows an ldmatrix reads fall on distinct banks
  static constexpr int kRow = HD + 8;
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kRing = kStages * 2 * kTileBytes;
  static constexpr size_t kQ = sizeof(__nv_bfloat16) * kQTerms * kRows * kRow;
  static constexpr size_t kLoop = kRing + kQ + sizeof(int) * kRows;
  // after the loop: the four position groups' o [4][kRows][HD], m, z and
  // fold weights [4][kRows] each, the block's m and z, the split fold's
  // weights and z [2][kRows][kMaxSplits]
  static constexpr size_t kEpilogue =
      sizeof(float) * (4 * kRows * HD + 3 * 4 * kRows + 2 * kRows + 2 * kRows * kMaxSplits);
  static constexpr size_t kBytes = kLoop > kEpilogue ? kLoop : kEpilogue;

  // The block's query rows row0 .. row0 + n_rows - 1 (qb: query 0, head 0
  // of its (row, kv head)) attend positions lo .. hi - 1 under the ragged
  // law; leaves the block's (o [kRows][HD], m, z) in shared memory.
  template <typename Rows>
  static __device__ __forceinline__ void run(unsigned char* smem, const SplitArgs& a,
                                             const TQ* __restrict__ qb, const Rows& krows,
                                             const Rows& vrows, int row0, int n_rows, int start,
                                             int kv_len, int lo, int hi, float*& res_o,
                                             float*& res_m, float*& res_z, float*& fold_w) {
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][K, V][kTile][kRow]
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + kRing);  // [term][kRows][kRow]
    int* lim_s = reinterpret_cast<int*>(smem + kRing + kQ);  // each row's visible length

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int rt = warp >> 2;  // this warp's row tile
    const int pg = warp & 3;   // and its 16 positions of each tile

    const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
    auto load_tile = [&](int t, int stage) {
      __nv_bfloat16* ks = ring + stage * 2 * kTile * kRow;
      __nv_bfloat16* vs = ks + kTile * kRow;
      constexpr int kChunks = HD / 8;  // 16-byte copies a row
      for (int c = tid; c < kTile * kChunks; c += kThreads) {
        const int j = c / kChunks, col = (c % kChunks) * 8;
        const int pos = lo + t * kTile + j;
        const bool valid = pos < hi;
        cp_async16(ks + j * kRow + col, valid ? krows.at(pos) + col : krows.base, valid);
        cp_async16(vs + j * kRow + col, valid ? vrows.at(pos) + col : vrows.base, valid);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_tile(s, s);
      cp_async_commit();  // one group per tile slot, empty or not
    }

    // q while the first tiles load: a thread's loads all issued before any
    // is waited on; rows past n_rows are zero
    constexpr int kQPer = kRows * HD / kThreads;
    float qv[kQPer];
#pragma unroll
    for (int e = 0; e < kQPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / HD, row = row0 + r;
      qv[e] = r < n_rows ? to_f32(qb[(row / a.G) * a.q_ss + (row % a.G) * a.q_sg + idx % HD])
                         : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kQPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / HD, d = idx % HD;
      __nv_bfloat16 t[kQTerms];  // a bf16 q is exact in one
      bf16_terms<kQTerms>(qv[e], t);
#pragma unroll
      for (int i = 0; i < kQTerms; ++i) q_s[(i * kRows + r) * kRow + d] = t[i];
    }
    if (tid < kRows)
      lim_s[tid] = tid < n_rows ? max(0, min(kv_len, start + (row0 + tid) / a.G + 1)) : 0;
    // the first tile's barrier makes q and the limits visible

    // the m16n8 accumulator: this thread's rows g and g + 8 of the row
    // tile, columns 2 * tq and 2 * tq + 1 of each n8 tile
    const int g = lane >> 2, tq = lane & 3;
    float o_acc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o_acc[n][c] = 0.f;
    float m_run[2] = {-1e30f, -1e30f};
    float z_run[2] = {0.f, 0.f};  // this thread's columns only, until the end
    // ldmatrix row addresses: lane / 8 picks the 8x8 matrix, lane % 8 its row
    const int mat = lane >> 3, mrow = lane & 7;

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();  // tile t has landed
      __syncthreads();               // for every thread; and tile t-1 is done with
      {
        const int next = t + kStages - 1;  // into the stage tile t-1 used
        if (next < n_tiles) load_tile(next, next % kStages);
        cp_async_commit();
      }
      const __nv_bfloat16* ks = ring + (t % kStages) * 2 * kTile * kRow;
      const __nv_bfloat16* vs = ks + kTile * kRow;

      // s = q k^T over this warp's 16 positions: two n8 tiles
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];  // (positions 0-7, 8-15) x (dims 0-7, 8-15) of this k16 step
        ldmatrix_x4(kb, ks + (pg * 16 + (mat >> 1) * 8 + mrow) * kRow + kk * 16 + (mat & 1) * 8);
#pragma unroll
        for (int i = 0; i < kQTerms; ++i) {
          uint32_t qa[4];
          ldmatrix_x4(qa, q_s + (i * kRows + rt * 16 + (mat & 1) * 8 + mrow) * kRow + kk * 16 +
                              (mat >> 1) * 8);
          mma_bf16(s[0], qa, kb[0], kb[1]);
          mma_bf16(s[1], qa, kb[2], kb[3]);
        }
      }

      // online softmax of rows g (h = 0) and g + 8 (h = 1)
      const int base = lo + t * kTile + pg * 16 + 2 * tq;
      const int lim0 = lim_s[rt * 16 + g], lim1 = lim_s[rt * 16 + g + 8];
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const int pos = base + n * 8 + (c & 1);
          s[n][c] = pos < (h ? lim1 : lim0) ? s[n][c] * a.scale : -1e30f;
          mx[h] = fmaxf(mx[h], s[n][c]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(fmaxf(m_run[h], mx[h]), -1e29f);
        alpha[h] = expf(m_run[h] - m_new);
        m_run[h] = m_new;
      }
      float p[2][4];
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[n][c] = expf(s[n][c] - m_run[c >> 1]);
          psum[c >> 1] += p[n][c];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) z_run[h] = z_run[h] * alpha[h] + psum[h];

      // o = o * alpha + p v: p, the accumulator of s, is the A fragment as
      // it lies.  A tile's terms sum in a fresh accumulator and join o by
      // one rounded f32 FMA: the tensor cores' own f32 accumulation does
      // not round to nearest, and its error would grow with the window
      uint32_t pa[kPTerms][4];
      {
        uint32_t t0[kPTerms], t1[kPTerms], t2[kPTerms], t3[kPTerms];
        pack_terms<kPTerms>(p[0][0], p[0][1], t0);  // row g, k 0-7
        pack_terms<kPTerms>(p[0][2], p[0][3], t1);  // row g + 8, k 0-7
        pack_terms<kPTerms>(p[1][0], p[1][1], t2);  // row g, k 8-15
        pack_terms<kPTerms>(p[1][2], p[1][3], t3);  // row g + 8, k 8-15
#pragma unroll
        for (int i = 0; i < kPTerms; ++i) {
          pa[i][0] = t0[i];
          pa[i][1] = t1[i];
          pa[i][2] = t2[i];
          pa[i][3] = t3[i];
        }
      }
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 16) {
        uint32_t vb[4];  // (positions 0-7, 8-15) x (dims d0.., d0+8..), transposed
        ldmatrix_x4_trans(vb, vs + (pg * 16 + (mat & 1) * 8 + mrow) * kRow + d0 + (mat >> 1) * 8);
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kPTerms; ++i) {
          mma_bf16(t0, pa[i], vb[0], vb[1]);
          mma_bf16(t1, pa[i], vb[2], vb[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o_acc[d0 / 8][c] = fmaf(o_acc[d0 / 8][c], alpha[c >> 1], t0[c]);
          o_acc[d0 / 8 + 1][c] = fmaf(o_acc[d0 / 8 + 1][c], alpha[c >> 1], t1[c]);
        }
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      z_run[h] += __shfl_xor_sync(0xffffffffu, z_run[h], 1);
      z_run[h] += __shfl_xor_sync(0xffffffffu, z_run[h], 2);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and q are done with: the epilogue reuses them

    // fold the four position groups of each row tile, in order
    float* wo = reinterpret_cast<float*>(smem);  // [pg][kRows][HD]; slot 0 ends as o
    float* wm = wo + 4 * kRows * HD;             // [pg][kRows]
    float* wz = wm + 4 * kRows;
    float* cw = wz + 4 * kRows;                  // [kRows][pg]
    res_m = cw + 4 * kRows;
    res_z = res_m + kRows;
    fold_w = res_z + kRows;
    const int r0 = rt * 16 + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(wo + (pg * kRows + r0) * HD + col) =
          make_float2(o_acc[n][0], o_acc[n][1]);
      *reinterpret_cast<float2*>(wo + (pg * kRows + r0 + 8) * HD + col) =
          make_float2(o_acc[n][2], o_acc[n][3]);
    }
    if (tq == 0) {
      wm[pg * kRows + r0] = m_run[0];
      wm[pg * kRows + r0 + 8] = m_run[1];
      wz[pg * kRows + r0] = z_run[0];
      wz[pg * kRows + r0 + 8] = z_run[1];
    }
    __syncthreads();
    if (tid < kRows) {
      float mm = -1e29f;
#pragma unroll
      for (int i = 0; i < 4; ++i) mm = fmaxf(mm, wm[i * kRows + tid]);
      float zz = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = expf(wm[i * kRows + tid] - mm);
        cw[tid * 4 + i] = w;
        zz += w * wz[i * kRows + tid];
      }
      res_m[tid] = mm;
      res_z[tid] = zz;
    }
    __syncthreads();
    for (int idx = tid; idx < kRows * HD; idx += kThreads) {
      const float* w = cw + (idx / HD) * 4;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc += w[i] * wo[i * kRows * HD + idx];
      wo[idx] = acc;  // slot 0, element by element: each thread its own
    }
    __syncthreads();
    res_o = wo;
  }
};

// ----------------------------------------------------------------- CUDA cores

// RT = 1: 8 query rows a block (decode's G <= 8), else 32
template <typename TQ, int HD, int RT>
struct CcBody {
  static constexpr int kRows = RT == 1 ? 8 : 32;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 1;  // the ring takes most of an SM's shared memory
  static constexpr int kVec = 4;  // f32 elements a 16-byte copy
  // +16 bytes a row: lanes reading one column of successive rows with
  // 16-byte loads fall on distinct banks
  static constexpr int kRow = HD + kVec;
  static constexpr size_t kTileBytes = sizeof(float) * kTile * kRow;
  static constexpr size_t kBytes = kStages * 2 * kTileBytes +
                                   sizeof(float) * (kRows * HD + kRows * kTile + 3 * kRows) +
                                   sizeof(int) * kRows;
  static_assert(sizeof(float) * (kRows * HD + 2 * kRows + 2 * kRows * kMaxSplits) <=
                    kStages * 2 * kTileBytes,
                "the epilogue fits in the ring");

  // as TcBody::run, in f32 on the CUDA cores: a thread scores one position
  // against kRows / 4 query rows from one read of its K row; a warp runs
  // the online softmax of kRows / 8 rows; a thread accumulates one output
  // column of kRows / 2 (hd 128) or kRows / 4 (hd 64) rows
  template <typename Rows>
  static __device__ __forceinline__ void run(unsigned char* smem, const SplitArgs& a,
                                             const TQ* __restrict__ qb, const Rows& krows,
                                             const Rows& vrows, int row0, int n_rows, int start,
                                             int kv_len, int lo, int hi, float*& res_o,
                                             float*& res_m, float*& res_z, float*& fold_w) {
    constexpr int kChunksPerRow = HD / kVec;
    constexpr int kScoreStep = kThreads / kTile;  // rows between one thread's scores
    constexpr int kDots = kRows / kScoreStep;
    constexpr int kPvStep = kThreads / HD;  // rows between one thread's accumulators
    constexpr int kAcc = kRows / kPvStep;

    float* tiles = reinterpret_cast<float*>(smem);  // [kStages][K, V][kTile][kRow]
    float* q_s = reinterpret_cast<float*>(smem + kStages * 2 * kTileBytes);  // [kRows][HD]
    float* p_s = q_s + kRows * HD;  // [kRows][kTile] scores, then probabilities
    float* m_s = p_s + kRows * kTile;
    float* z_s = m_s + kRows;
    float* alpha_s = z_s + kRows;
    int* lim_s = reinterpret_cast<int*>(alpha_s + kRows);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
    auto load_tile = [&](int tile, int stage) {
      float* ks = tiles + stage * 2 * kTile * kRow;
      float* vs = ks + kTile * kRow;
      for (int c = tid; c < kTile * kChunksPerRow; c += kThreads) {
        const int j = c / kChunksPerRow, col = (c % kChunksPerRow) * kVec;
        const int pos = lo + tile * kTile + j;
        const bool valid = pos < hi;
        cp_async16(ks + j * kRow + col, valid ? krows.at(pos) + col : krows.base, valid);
        cp_async16(vs + j * kRow + col, valid ? vrows.at(pos) + col : vrows.base, valid);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_tile(s, s);
      cp_async_commit();
    }

    // q while the first tiles load, a thread's loads all in flight at once
    constexpr int kQPer = kRows * HD / kThreads;
    float qv[kQPer];
#pragma unroll
    for (int e = 0; e < kQPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / HD, row = row0 + r;
      qv[e] = r < n_rows ? to_f32(qb[(row / a.G) * a.q_ss + (row % a.G) * a.q_sg + idx % HD])
                         : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kQPer; ++e) q_s[tid + e * kThreads] = qv[e];
    if (tid < kRows) {
      lim_s[tid] = tid < n_rows ? max(0, min(kv_len, start + (row0 + tid) / a.G + 1)) : 0;
      m_s[tid] = -1e30f;
      z_s[tid] = 0.0f;
    }
    // the first tile's barrier makes q and the limits visible

    const int j_own = tid % kTile;    // score: this thread's kv position
    const int r_score = tid / kTile;  // and its first row
    const int d_own = tid % HD;       // output: this thread's column
    const int r_pv = tid / HD;        // and its first row
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      {
        const int next = t + kStages - 1;
        if (next < n_tiles) load_tile(next, next % kStages);
        cp_async_commit();
      }
      const float* ks = tiles + (t % kStages) * 2 * kTile * kRow;
      const float* vs = ks + kTile * kRow;

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
            const float4 qv = *reinterpret_cast<const float4*>(q_s + r * HD + c);
            dots[i] += qv.x * kv[0] + qv.y * kv[1] + qv.z * kv[2] + qv.w * kv[3];
          }
        }
      }
      const int pos = lo + t * kTile + j_own;
#pragma unroll
      for (int i = 0; i < kDots; ++i) {
        const int r = r_score + i * kScoreStep;
        if (r < n_rows) p_s[r * kTile + j_own] = pos < lim_s[r] ? dots[i] * a.scale : -1e30f;
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

      // o = o * alpha + p v, the tile's sum in a fresh register: a long
      // split then rounds like its tiles' sums, not like one running sum
      float part[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) part[i] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < kTile; j += 4) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = vs[(j + e) * kRow + d_own];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int r = r_pv + i * kPvStep;
          if (r < n_rows) {
            const float4 p = *reinterpret_cast<const float4*>(p_s + r * kTile + j);
            part[i] += p.x * v[0] + p.y * v[1] + p.z * v[2] + p.w * v[3];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int r = r_pv + i * kPvStep;
        if (r < n_rows) acc[i] = fmaf(acc[i], alpha_s[r], part[i]);
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // the ring is done with: the epilogue reuses it
    res_o = reinterpret_cast<float*>(smem);  // [kRows][HD]
    res_m = res_o + kRows * HD;
    res_z = res_m + kRows;
    fold_w = res_z + kRows;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r_pv + i * kPvStep;
      if (r < n_rows) res_o[r * HD + d_own] = acc[i];
    }
    if (tid < kRows) {
      res_m[tid] = fmaxf(m_s[tid], -1e29f);
      res_z[tid] = z_s[tid];
    }
    __syncthreads();
  }
};

template <typename T, typename TQ, int HD, int RT>
struct Body;
template <typename TQ, int HD, int RT>
struct Body<__nv_bfloat16, TQ, HD, RT> : TcBody<TQ, HD, RT> {};
template <typename TQ, int HD, int RT>
struct Body<float, TQ, HD, RT> : CcBody<TQ, HD, RT> {};

// ------------------------------------------------------------ the split fold

// Write the block's (o, m, z) (res_*: shared memory, n_rows of them): to the
// output when its query tile has one live split; else to the partials,
// then the last split of the tile to arrive folds them all in split order.
template <int ROWS, int THREADS, int HD>
__device__ __forceinline__ void finish(const SplitArgs& a, const float* res_o,
                                       const float* res_m, const float* res_z, float* fold_w,
                                       int n_rows, int64_t first, int64_t ticket, int split,
                                       int n_live) {
  const int tid = threadIdx.x;
  if (n_live == 1) {
    for (int idx = tid; idx < n_rows * HD; idx += THREADS) a.o[first * HD + idx] = res_o[idx];
    if (tid < n_rows) {
      a.m[first + tid] = res_m[tid];
      a.z[first + tid] = res_z[tid];
    }
    return;
  }
  const int64_t NR = static_cast<int64_t>(a.B) * a.K * a.S * a.G;
  {
    float* po = a.po + (split * NR + first) * HD;
    for (int idx = tid; idx < n_rows * HD; idx += THREADS) po[idx] = res_o[idx];
    if (tid < n_rows) {
      a.pm[split * NR + first + tid] = res_m[tid];
      a.pz[split * NR + first + tid] = res_z[tid];
    }
  }
  __shared__ bool last;
  __threadfence();  // the partials are visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + ticket, 1u) == static_cast<unsigned>(n_live - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) a.tickets[ticket] = 0;  // every split of the tile has taken its ticket
  // the other blocks' partials are read from L2 (__ldcg), never a stale L1
  // line; a thread's loads are all issued before any is waited on
  float* fold_z = fold_w + ROWS * kMaxSplits;
  constexpr int kPer = (ROWS * kMaxSplits + THREADS - 1) / THREADS;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = tid + e * THREADS;
    const int r = idx / kMaxSplits, i = idx % kMaxSplits;
    if (r < n_rows && i < n_live) {
      fold_w[idx] = __ldcg(a.pm + i * NR + first + r);
      fold_z[idx] = __ldcg(a.pz + i * NR + first + r);
    }
  }
  __syncthreads();
  for (int r = tid; r < n_rows; r += THREADS) {
    float* w = fold_w + r * kMaxSplits;
    const float* zi = fold_z + r * kMaxSplits;
    float mm = -1e29f;
    for (int i = 0; i < n_live; ++i) mm = fmaxf(mm, w[i]);
    float zz = 0.f;
    for (int i = 0; i < n_live; ++i) {
      w[i] = expf(w[i] - mm);
      zz += w[i] * zi[i];
    }
    a.m[first + r] = mm;
    a.z[first + r] = zz;
  }
  __syncthreads();
  constexpr int kOut = ROWS * HD / THREADS;  // output elements a thread
  float acc[kOut];
#pragma unroll
  for (int e = 0; e < kOut; ++e) acc[e] = 0.f;
  for (int i = 0; i < n_live; ++i) {
    const float* po = a.po + (i * NR + first) * HD;
    float v[kOut];
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int idx = tid + e * THREADS;
      v[e] = idx < n_rows * HD ? __ldcg(po + idx) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kOut; ++e)
      acc[e] += fold_w[((tid + e * THREADS) / HD) * kMaxSplits + i] * v[e];
  }
#pragma unroll
  for (int e = 0; e < kOut; ++e) {
    const int idx = tid + e * THREADS;
    if (idx < n_rows * HD) a.o[first * HD + idx] = acc[e];
  }
}

// ------------------------------------------------------------------- sources

// the dense window view [B, K, W, HD] through its strides (elements)
struct DenseSource {
  const void* k;
  const void* v;
  int64_t k_sb, k_sk, k_sw, v_sb, v_sk, v_sw;
  template <typename T>
  using Rows = DenseRows<T>;
  template <typename T>
  __device__ __forceinline__ void rows(int b, int kh, int, int, int*, DenseRows<T>& kr,
                                       DenseRows<T>& vr) const {
    kr = DenseRows<T>{static_cast<const T*>(k) + b * k_sb + kh * k_sk, k_sw};
    vr = DenseRows<T>{static_cast<const T*>(v) + b * v_sb + kh * v_sk, v_sw};
  }
};

// one layer of an f32 paged pool [N, K, page, HD] (page, head and position
// strides) read through block tables [B, table_stride]; the block stages
// the table entries of its split's positions lo .. hi - 1 only
struct PagedSource {
  const void* k;
  const void* v;
  const int* tables;
  int64_t table_stride;
  int page;
  int64_t k_sn, k_sk, k_sp, v_sn, v_sk, v_sp;
  template <typename T>
  using Rows = PagedRows<T>;
  template <typename T>
  __device__ __forceinline__ void rows(int b, int kh, int lo, int hi, int* staged,
                                       PagedRows<T>& kr, PagedRows<T>& vr) const {
    const int p0 = lo / page;
    const int n = hi > lo ? (hi - 1) / page - p0 + 1 : 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x) staged[p] = tables[b * table_stride + p0 + p];
    __syncthreads();  // every thread's copies read the staged entries
    kr = PagedRows<T>{static_cast<const T*>(k) + kh * k_sk, staged, p0, page, k_sn, k_sp};
    vr = PagedRows<T>{static_cast<const T*>(v) + kh * v_sk, staged, p0, page, v_sn, v_sp};
  }
};

// grid (K, B, split x query tile): block (kh, b, z) owns query tile z %
// qtiles of (b, kh) and split z / qtiles of its window
template <typename T, typename TQ, int HD, int RT, typename Source>
__global__ void __launch_bounds__(Body<T, TQ, HD, RT>::kThreads, Body<T, TQ, HD, RT>::kMinBlocks)
    split_attn_kernel(const SplitArgs a, const Source src) {
  using Bd = Body<T, TQ, HD, RT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int qt = blockIdx.z % a.qtiles, split = blockIdx.z / a.qtiles;
  const int SG = a.S * a.G;
  const int row0 = qt * Bd::kRows;
  const int n_rows = min(Bd::kRows, SG - row0);
  const int start = a.starts[b];
  const int kv_len = max(0, min(a.lens[b], a.window));
  // the last query of the tile sees the most
  const int stop = max(0, min(kv_len, start + (row0 + n_rows - 1) / a.G + 1));
  const int n_live = max(1, (stop + a.split_pos - 1) / a.split_pos);
  if (split >= n_live) return;  // past the tile's stop: nothing to see, nothing written
  const int lo = split * a.split_pos;
  const int hi = min(stop, lo + a.split_pos);
  typename Source::template Rows<T> kr, vr;
  src.template rows<T>(b, kh, lo, hi, reinterpret_cast<int*>(smem + Bd::kBytes), kr, vr);
  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb + kh * a.q_sk;
  float *res_o, *res_m, *res_z, *fold_w;
  Bd::run(smem, a, qb, kr, vr, row0, n_rows, start, kv_len, lo, hi, res_o, res_m, res_z, fold_w);
  const int64_t head = static_cast<int64_t>(b) * a.K + kh;
  finish<Bd::kRows, Bd::kThreads, HD>(a, res_o, res_m, res_z, fold_w, n_rows, head * SG + row0,
                                       head * a.qtiles + qt, split, n_live);
}

template <typename T, typename TQ, int HD, int RT, typename Source>
int launch_split(SplitArgs a, const Source& src, int staged, cudaStream_t stream) {
  using Bd = Body<T, TQ, HD, RT>;
  const size_t bytes = Bd::kBytes + sizeof(int) * static_cast<size_t>(staged);
  auto kernel = split_attn_kernel<T, TQ, HD, RT, Source>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.qtiles = (a.S * a.G + Bd::kRows - 1) / Bd::kRows;
  dim3 grid(a.K, a.B, a.qtiles * a.n_splits);
  kernel<<<grid, Bd::kThreads, bytes, stream>>>(a, src);
  return static_cast<int>(cudaGetLastError());
}

// query tiles of the block_rows the wrapper planned (its tickets and its
// split plan count them): 16 (bf16 caches) or 8 (f32), or 32 for the
// ragged kernels; kDecode (S*G = G <= 8) instantiates the first only
template <typename T, typename TQ, int HD, bool kDecode, typename Source>
int launch_rows(const SplitArgs& a, int block_rows, const Source& src, int staged,
                cudaStream_t stream) {
  if (block_rows == Body<T, TQ, HD, 1>::kRows)
    return launch_split<T, TQ, HD, 1>(a, src, staged, stream);
  if constexpr (!kDecode) {
    if (block_rows == Body<T, TQ, HD, 2>::kRows)
      return launch_split<T, TQ, HD, 2>(a, src, staged, stream);
  }
  return -1;
}

// dtype codes: 0 = float32, 1 = bfloat16; kF32Only: f32 caches only (the
// paged forms, whose bf16 pools take the walk).  Returns 0 on success, the
// CUDA error code of a refused launch, or -1 for a shape, type or split
// plan the kernels do not take.
template <bool kDecode, bool kF32Only, typename Source>
int dispatch(int kv_dtype, int q_dtype, int hd, int block_rows, const SplitArgs& a,
             const Source& src, int staged, void* stream) {
  if (a.G < 1 || a.S < 1 || a.B < 0 || a.K < 0 || a.window < 0) return -1;
  if (kDecode && a.S * a.G > 8) return -1;
  if (a.split_pos < kTile || a.split_pos % kTile || a.n_splits < 1 || a.n_splits > kMaxSplits ||
      static_cast<int64_t>(a.n_splits) * a.split_pos < a.window)
    return -1;
  if (a.n_splits > 1 && !(a.po && a.pm && a.pz && a.tickets)) return -1;
  if (a.B == 0 || a.K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define CALFKIT_SPLIT(KV, Q, T, TQ, HD)                                        \
  if (kv_dtype == KV && q_dtype == Q && hd == HD)                              \
    return launch_rows<T, TQ, HD, kDecode>(a, block_rows, src, staged, s);
  if constexpr (!kF32Only) {
    CALFKIT_SPLIT(1, 1, bf, bf, 128)
    CALFKIT_SPLIT(1, 0, bf, float, 128)
    CALFKIT_SPLIT(1, 1, bf, bf, 64)
    CALFKIT_SPLIT(1, 0, bf, float, 64)
  }
  CALFKIT_SPLIT(0, 1, float, bf, 128)
  CALFKIT_SPLIT(0, 0, float, float, 128)
  CALFKIT_SPLIT(0, 1, float, bf, 64)
  CALFKIT_SPLIT(0, 0, float, float, 64)
#undef CALFKIT_SPLIT
  return -1;
}

// the arguments every entry point shares, in their C order
#define CALFKIT_SPLIT_PARAMS                                                                  \
  int kv_dtype, int q_dtype, int hd, int block_rows, const void *q, long long q_sb,        \
      long long q_sk, long long q_ss, long long q_sg, void *o, void *m, void *z, void *po,   \
      void *pm, void *pz, void *tickets, int n_splits, int split_pos, float scale, void *stream

inline SplitArgs split_args(const void* q, long long q_sb, long long q_sk, long long q_ss,
                            long long q_sg, void* o, void* m, void* z, void* po, void* pm,
                            void* pz, void* tickets, int n_splits, int split_pos, float scale,
                            const int* starts, const int* lens, int B, int K, int S, int G,
                            int window) {
  SplitArgs a;
  a.q = q;
  a.q_sb = q_sb;
  a.q_sk = q_sk;
  a.q_ss = q_ss;
  a.q_sg = q_sg;
  a.starts = starts;
  a.lens = lens;
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.z = static_cast<float*>(z);
  a.po = static_cast<float*>(po);
  a.pm = static_cast<float*>(pm);
  a.pz = static_cast<float*>(pz);
  a.tickets = static_cast<unsigned*>(tickets);
  a.B = B;
  a.K = K;
  a.S = S;
  a.G = G;
  a.window = window;
  a.n_splits = n_splits;
  a.split_pos = split_pos;
  a.qtiles = 1;
  a.scale = scale;
  return a;
}

// table entries a split of the paged window can touch
inline int staged_entries(int split_pos, int page, int wpages) {
  const int most = split_pos / page + 2;
  return wpages < most ? wpages : most;
}

#define CALFKIT_SPLIT_ARGS(starts, lens, B, K, S, G, window)                                   \
  split_args(q, q_sb, q_sk, q_ss, q_sg, o, m, z, po, pm, pz, tickets, n_splits, split_pos,   \
             scale, starts, lens, B, K, S, G, window)

}  // namespace
