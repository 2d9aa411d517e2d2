// The paged attention body for bf16 pools: one persistent walk over the
// pool, length-balanced across blocks and fed page by page by TMA.  The
// paged decode kernel (decode_attention.cu) and the paged ragged kernel
// (ragged_attention.cu) both run it; decode is the ragged law at S = 1 with
// start = kv_len.
//
// A launch computes, for every (batch row b, kv head k) and each of its S*G
// query rows r = j * G + g:
//   s[w] = (q[r] . k[w]) * scale, masked to -1e30 where
//          w >= min(kv_len[b], start[b] + j + 1)     (the ragged mask law)
//   m    = max(max_w s[w], -1e29)
//   z    = sum_w exp(s[w] - m)
//   o    = sum_w exp(s[w] - m) * v[w]      (UNnormalized, f32)
// with position w of row b in page tables[b, w / page] of layer `layer` of
// the pool [L, N, K, page, HD], at offset w % page.
//
// The plan (walk_plan in inference/attention.py mirrors it in Python):
// - A unit is a (row b, kv head k, query tile qt), numbered u = (b * K + k)
//   * qtiles + qt.  Its stop is min(kv_len, start + j_last + 1), j_last the
//   last query of the tile; it has ceil(stop / 64) live tiles of 64
//   positions, and a unit that sees nothing (stop 0) counts one empty tile,
//   so that it has exactly one writer.
// - The T tiles of all units, in unit order, are cut into C = min(blocks,
//   max(1, T / min_tiles)) chunks, chunk c the tiles [c T / C, (c + 1) T /
//   C): equal to within one tile.  Block c walks chunk c; blocks past C exit.
//   Every block reads the lengths and computes the same plan, so the host
//   reads nothing and there is no second launch.
// - A chunk crosses units: its piece of a unit is a segment.  A unit whose
//   tiles lie in one chunk is written by that block.  Otherwise its
//   segments, chunks c_first .. c_last, write f32 partials at ids u + c
//   (distinct: both grow along the walk) and take the unit's ticket; the
//   last to take it resets it and folds the partials in segment order
//   (m = max m_i, w_i = exp(m_i - m), o = sum w_i o_i, z = sum w_i z_i),
//   so the result is the same bits from run to run.  The host sizes the
//   partials by U + blocks and the tickets by U, bounds that need no
//   lengths.
//
// A block is 4 * RT consumer warps (RT tiles of 16 query rows; four warps a
// row tile, each on 16 positions of every tile) and one producer warp.  The
// producer walks the same segments.  It copies a bf16 q's rows for each
// segment by cp.async into one of two buffers ahead of the consumers (an
// f32 q is loaded and split into its three bf16 terms by the consumers).
// It keeps the ring's stages full: one TMA box of box_rows positions x 64
// columns a copy, box_rows = gcd(page, 64), the page id (from the row's
// block table, read 32 entries at a time) and the layer as coordinates of
// one tensor map over the whole pool (hd, position in page, kv head, page,
// layer); the box lands 128-byte swizzled, which the consumers' ldmatrix
// reads without bank conflicts.  Its loads run straight on across
// segments, so the next segment's first tiles are in flight while the last
// one's partial is written and folded.  The stage of a segment's last tile
// is held through its epilogue as the scratch of the fold of the four
// position groups, and released after it.
//
// The products are TcBody's (split_attention.cuh): mma.sync m16n8k16, bf16
// in and f32 accumulation, f32-exact (q (f32) and p as three bf16 terms; a
// bf16 q is one term).  Positions past the stop in a tile hold whatever the
// page held (or an earlier tile): their scores are masked, and the V rows
// are zeroed before the products, since 0 * NaN would survive p = 0.

#pragma once

#include <cstring>

#include "split_attention.cuh"

namespace {

constexpr int kSlabBytes = kTile * 128;  // 64 positions x one 128-byte swizzle row (64 bf16)

struct WalkArgs {
  SplitArgs s;  // q, starts, lens, the outputs, partials and tickets, B, K, S, G, window, scale
  const int* tables;  // [B, table_stride]
  int64_t table_stride;
  int page;
  int box_rows;   // positions a TMA box: gcd(page, 64), a multiple of 8
  int layer;
  int min_tiles;  // the least tiles a chunk, where there are enough
};

// The tiles lie as TMA writes them: 64-column slabs of 64 rows of 128
// bytes, 128-byte swizzled, so 16-byte chunk c of row r is at byte
//   (c >> 3) * kSlabBytes + (row_bits(r) ^ ((c & 7) << 4)),
// row_bits(r) = r * 128 | (r & 7) << 4: a lane's row gives one register,
// and each unrolled step's chunk an immediate XOR and add.
__device__ __forceinline__ uint32_t row_bits(int r) {
  return static_cast<uint32_t>(r * 128 | (r & 7) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the chunk of a plan of T tiles in C chunks that holds tile t
__device__ __forceinline__ int chunk_of(int t, int T, int C) {
  return static_cast<int>((static_cast<int64_t>(t + 1) * C - 1) / T);
}

template <typename TQ, int HD, int RT>
struct Walk {
  static constexpr int kQTerms = std::is_same<TQ, __nv_bfloat16>::value ? 1 : 3;
  static constexpr int kRows = 16 * RT;
  static constexpr int kWarps = 4 * RT;  // consumer warps
  static constexpr int kConsumers = 32 * kWarps;
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  // 16 rows: three stages and two blocks an SM; 32 rows: four stages and
  // one block an SM.  Either way ptxas holds a thread to 168 registers
  // (three warps on some of an SM's four schedulers)
  static constexpr int kStages = RT == 1 ? 3 : 4;
  static constexpr int kMinBlocks = RT == 1 ? 2 : 1;
  static constexpr int kSlabs = HD / 64;
  static constexpr int kTileBytes = kSlabs * kSlabBytes;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kQRow = HD + 8;  // +16 bytes a row: ldmatrix's rows on distinct banks
  // a bf16 q is copied by the producer a segment ahead, into one of two
  // buffers; an f32 q is split into its three terms by the consumers
  static constexpr int kQBufs = kQTerms == 1 ? 2 : 1;
  static constexpr int kQBuf = kQTerms * kRows * kQRow;  // elements of a q buffer
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kOffGroup = kRing + 2 * kQBufs * kQBuf;  // m, z of each warp's 16 rows
  static constexpr int kOffBar = (kOffGroup + 2 * 4 * kWarps * 16 + 7) / 8 * 8;
  static constexpr int kOffPlan = kOffBar + 8 * (2 * kStages + 2 * kQBufs);
  static constexpr int kPlanInts = 8;
  static constexpr size_t kBytes = 1024 + kOffPlan + 4 * kPlanInts;  // +1 KB: aligning the ring
  // the first fold round writes two warps' o of every row tile into the held stage
  static_assert(2 * RT * 16 * HD * 4 <= kStageBytes, "the group fold fits in a stage");
};

__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// the stop (positions any query of the tile sees) of unit (b, qt)
__device__ __forceinline__ int unit_stop(const SplitArgs& a, int rows, int b, int qt) {
  const int row0 = qt * rows;
  const int n_rows = min(rows, a.S * a.G - row0);
  const int kv_len = max(0, min(__ldg(a.lens + b), a.window));
  return max(0, min(kv_len, __ldg(a.starts + b) + (row0 + n_rows - 1) / a.G + 1));
}
__device__ __forceinline__ int unit_tiles(int stop) { return max(1, (stop + kTile - 1) / kTile); }

// where a segment's result goes: its unit, the unit's first output row
// and rows, and the unit's first chunk and segments
struct SegMeta {
  int64_t first;
  int u, n_rows, c_first, n_seg;
};

// a block's walk over its chunk: the unit (b, k, qt) it is in, the unit's
// first tile in plan order, and the chunk's next tile and end
struct Cursor {
  int b, k, qt, unit0, pos, end;
  __device__ __forceinline__ void next_unit(int n_tiles, int K, int qtiles) {
    unit0 += n_tiles;
    if (++qt == qtiles) {
      qt = 0;
      if (++k == K) {
        k = 0;
        ++b;
      }
    }
  }
};

template <typename TQ, int HD, int RT>
__global__ void __launch_bounds__(Walk<TQ, HD, RT>::kThreads, Walk<TQ, HD, RT>::kMinBlocks)
    paged_walk_attn_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const WalkArgs w) {
  using Wk = Walk<TQ, HD, RT>;
  constexpr int kRows = Wk::kRows;
  constexpr int kStages = Wk::kStages;
  constexpr int kQRow = Wk::kQRow;
  constexpr int kQTerms = Wk::kQTerms;
  const SplitArgs& a = w.s;
  extern __shared__ unsigned char walk_smem[];
  unsigned char* ring = walk_smem + ((1024 - (smem_u32(walk_smem) & 1023)) & 1023);
  // [buffer][term][kRows][kQRow]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(ring + Wk::kRing);
  float* gm_s = reinterpret_cast<float*>(ring + Wk::kOffGroup);  // [warp][16]
  float* gz_s = gm_s + Wk::kWarps * 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Wk::kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;  // [kQBufs]: a bf16 q buffer has landed
  uint64_t* q_empty = q_full + Wk::kQBufs;  // and every consumer warp is done with it
  int* plan_s = reinterpret_cast<int*>(ring + Wk::kOffPlan);

  const int tid = threadIdx.x;
  const int K = a.K, qtiles = a.qtiles, SG = a.S * a.G;

  // ---- the plan: warp 0 finds T, C and where this block's chunk starts
  if (tid < 32) {
    int rows_tiles = 0;  // this lane's rows' tiles, over their query tiles
    for (int b = tid; b < a.B; b += 32)
      for (int qt = 0; qt < qtiles; ++qt) rows_tiles += unit_tiles(unit_stop(a, kRows, b, qt));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) rows_tiles += __shfl_xor_sync(0xffffffffu, rows_tiles, off);
    const int T = K * rows_tiles;
    const int C = min(static_cast<int>(gridDim.x), max(1, T / w.min_tiles));
    const int c = blockIdx.x;
    if (c < C) {
      const int lo = static_cast<int>(static_cast<int64_t>(c) * T / C);
      // the row holding tile lo: a scan of K * (a row's tiles) over the rows
      int row_start = 0, found = -1;
      for (int b0 = 0; b0 < a.B && found < 0; b0 += 32) {
        const int b = b0 + tid;
        int mine = 0;
        if (b < a.B)
          for (int qt = 0; qt < qtiles; ++qt) mine += unit_tiles(unit_stop(a, kRows, b, qt));
        mine *= K;
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, off);
          if (tid >= off) incl += v;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, b < a.B && row_start + incl > lo);
        if (hit) {
          const int l = __ffs(hit) - 1;
          found = b0 + l;
          row_start += __shfl_sync(0xffffffffu, incl - mine, l);
        } else {
          row_start += __shfl_sync(0xffffffffu, incl, 31);
        }
      }
      if (tid == 0) {
        int per_head = 0;
        for (int qt = 0; qt < qtiles; ++qt) per_head += unit_tiles(unit_stop(a, kRows, found, qt));
        const int k = (lo - row_start) / per_head;
        int unit0 = row_start + k * per_head, qt = 0;
        for (;; ++qt) {
          const int n = unit_tiles(unit_stop(a, kRows, found, qt));
          if (lo < unit0 + n) break;
          unit0 += n;
        }
        plan_s[0] = C;
        plan_s[1] = T;
        plan_s[2] = found;
        plan_s[3] = k;
        plan_s[4] = qt;
        plan_s[5] = unit0;
        plan_s[6] = lo;
        plan_s[7] = static_cast<int>(static_cast<int64_t>(c + 1) * T / C);
      }
    } else if (tid == 0) {
      plan_s[0] = C;
    }
  } else if (tid == Wk::kConsumers) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);            // the producer's arrival, then the tile's bytes
      mbar_init(&empty[i], Wk::kWarps);  // every consumer warp is done with the stage
    }
    for (int i = 0; i < Wk::kQBufs; ++i) {
      mbar_init(&q_full[i], 32);  // each producer lane's copies
      mbar_init(&q_empty[i], Wk::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int C = plan_s[0];
  if (static_cast<int>(blockIdx.x) >= C) return;  // a chunk for every block only where there are tiles
  Cursor cur{plan_s[2], plan_s[3], plan_s[4], plan_s[5], plan_s[6], plan_s[7]};

  if (tid >= Wk::kConsumers) {  // ---- the producer warp
    const int lane = tid & 31;
    int it = 0;  // tiles issued: stage it % kStages, its (it / kStages)-th use
    int q_seg = 0;  // segments that see something: q buffer q_seg % 2
    // the block-table entries of 32 pages of row `row` at a time, one a
    // lane, from page `base` on: read once for every head of the row
    int row = -1, base = -32, ids = 0, row_pages = 0;
    while (cur.pos < cur.end) {
      const int stop = unit_stop(a, kRows, cur.b, cur.qt);
      const int n_tiles = unit_tiles(stop);
      const int t_end = min(cur.end, cur.unit0 + n_tiles) - cur.unit0;
      const int live = (stop + kTile - 1) / kTile;
      const int* table = w.tables + cur.b * w.table_stride;
      if constexpr (Wk::kQBufs == 2) {
        if (live > 0) {  // the segment's q rows, zeros past n_rows, into buffer q_seg % 2
          const int buf = q_seg & 1;
          if (lane == 0 && q_seg >= 2) mbar_wait(&q_empty[buf], ((q_seg >> 1) - 1) & 1);
          __syncwarp();
          const int row0 = cur.qt * kRows, n_rows = min(kRows, SG - row0);
          const TQ* qb = static_cast<const TQ*>(a.q) + cur.b * a.q_sb + cur.k * a.q_sk;
          constexpr int kPerRow = HD / 8;  // 16-byte copies a row
          for (int v = lane; v < kRows * kPerRow; v += 32) {
            const int r = v / kPerRow, c = (v % kPerRow) * 8, qr = row0 + r;
            cp_async16(q_s + buf * Wk::kQBuf + r * kQRow + c,
                       r < n_rows ? qb + (qr / a.G) * a.q_ss + (qr % a.G) * a.q_sg + c : qb,
                       r < n_rows);
          }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                           smem_u32(&q_full[buf]))
                       : "memory");
          ++q_seg;
        }
      }
      if (cur.b != row) {  // the heads (and query tiles) of a row share its table entries
        row = cur.b;
        base = -32;
        row_pages = (max(0, min(__ldg(a.lens + row), a.window)) + w.page - 1) / w.page;
      }
      for (int t = cur.pos - cur.unit0; t < min(t_end, live); ++t, ++it) {
        const int st = it % kStages;
        const int pos0 = t * kTile;
        const int n_box = (min(pos0 + kTile, stop) - pos0 + w.box_rows - 1) / w.box_rows;
        if (pos0 / w.page < base || (min(pos0 + kTile, stop) - 1) / w.page >= base + 32) {
          base = pos0 / w.page;
          ids = base + lane < row_pages ? __ldg(table + base + lane) : 0;
        }
        const int pos = pos0 + lane * w.box_rows;  // this lane's box, if lane < n_box
        const int page_id = __shfl_sync(0xffffffffu, ids, min(pos / w.page - base, 31));
        const int in_page = pos % w.page;
        if (lane == 0) {
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[st], n_box * w.box_rows * 128 * Wk::kSlabs * 2);
        }
        __syncwarp();
        if (lane < n_box) {
          unsigned char* kt = ring + st * Wk::kStageBytes + lane * w.box_rows * 128;
#pragma unroll
          for (int sl = 0; sl < Wk::kSlabs; ++sl) {
            tma_load_5d(kt + sl * kSlabBytes, &k_map, &full[st], sl * 64, in_page, cur.k, page_id,
                        w.layer);
            tma_load_5d(kt + Wk::kTileBytes + sl * kSlabBytes, &v_map, &full[st], sl * 64, in_page,
                        cur.k, page_id, w.layer);
          }
        }
      }
      cur.pos = cur.unit0 + t_end;
      if (t_end == n_tiles) cur.next_unit(n_tiles, K, qtiles);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // its q copies land before it exits
    return;
  }

  // ---- the consumer warps
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rt = warp >> 2;  // this warp's row tile
  const int pg = warp & 3;   // and its 16 positions of each tile
  const int g = lane >> 2, tq = lane & 3;  // the m16n8 accumulator's rows g, g + 8; columns 2 tq, +1
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: the 8x8 matrix and its row
  __shared__ int last_s;
  // each warp's cursor and its segment's SegMeta, kept in shared memory
  // across the tile loop, which needs the registers
  __shared__ Cursor cur_s[Wk::kWarps];
  __shared__ SegMeta meta_s[Wk::kWarps];
  __shared__ int lim_s[Wk::kWarps][16];  // the visible lengths of each warp's 16 rows
  if (lane == 0) cur_s[warp] = cur;
  __syncwarp();
  int it = 0;  // tiles consumed, as the producer counts them
  int q_seg = 0;  // segments that see something, as the producer counts them
  // this lane's ldmatrix rows: of K (position pg * 16 + (mat >> 1) * 8 +
  // mrow, chunk 2 kk + (mat & 1)), of V (position pg * 16 + (mat & 1) * 8 +
  // mrow, chunk d0 / 8 + (mat >> 1)), of q (row rt * 16 + (mat & 1) * 8 +
  // mrow, column kk * 16 + (mat >> 1) * 8), the chunk's fixed bits folded in
  const uint32_t k_row = row_bits(pg * 16 + (mat >> 1) * 8 + mrow) ^ ((mat & 1) << 4);
  const uint32_t v_row = row_bits(pg * 16 + (mat & 1) * 8 + mrow) ^ ((mat >> 1) << 4);
  const uint32_t q_lane = ((rt * 16 + (mat & 1) * 8 + mrow) * kQRow + (mat >> 1) * 8) * 2;

  for (;;) {
    Cursor cur = cur_s[warp];
    if (cur.pos >= cur.end) break;
    const int stop = unit_stop(a, kRows, cur.b, cur.qt);
    const int n_tiles = unit_tiles(stop);
    const int t_lo = cur.pos - cur.unit0;
    const int t_end = min(cur.end, cur.unit0 + n_tiles) - cur.unit0;
    const int live = (stop + kTile - 1) / kTile;
    const int row0 = cur.qt * kRows;
    const int n_rows = min(kRows, SG - row0);
    const int64_t first = static_cast<int64_t>(cur.b * K + cur.k) * SG + row0;
    if (lane == 0) {
      const int C = plan_s[0], T = plan_s[1];  // read again: registers are scarce in the loop
      const int c_first = chunk_of(cur.unit0, T, C);
      meta_s[warp] = SegMeta{first, (cur.b * K + cur.k) * qtiles + cur.qt, n_rows, c_first,
                             chunk_of(cur.unit0 + n_tiles - 1, T, C) - c_first + 1};
      Cursor next = cur;
      next.pos = cur.unit0 + t_end;
      if (t_end == n_tiles) next.next_unit(n_tiles, K, qtiles);
      cur_s[warp] = next;
    }
    __syncwarp();

    if (live == 0) {  // nothing to see: o = 0, m = -1e29, z = 0 (one segment)
      for (int idx = tid; idx < n_rows * HD; idx += Wk::kConsumers) a.o[first * HD + idx] = 0.f;
      if (tid < n_rows) {
        a.m[first + tid] = -1e29f;
        a.z[first + tid] = 0.f;
      }
    } else {
      const __nv_bfloat16* q_buf = q_s;
      if constexpr (Wk::kQBufs == 2) {  // a bf16 q: the producer's copy
        q_buf = q_s + (q_seg & 1) * Wk::kQBuf;
        mbar_wait(&q_full[q_seg & 1], (q_seg >> 1) & 1);
      } else {
        // an f32 q, through its strides, as three bf16 terms: 16-byte loads
        // all issued before any is used.  The thread index is read afresh:
        // the loads' offsets, derived from it, would otherwise be hoisted
        // out of the segment loop and held (spilled) across every tile loop
        int tid_q;
        asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid_q));
        const TQ* qb = static_cast<const TQ*>(a.q) + cur.b * a.q_sb + cur.k * a.q_sk;
        constexpr int kVec = 16 / sizeof(TQ);     // elements a load
        constexpr int kPerRow = HD / kVec;        // loads a row
        constexpr int kLoads = (kRows * kPerRow + Wk::kConsumers - 1) / Wk::kConsumers;
        uint4 raw[kLoads];
#pragma unroll
        for (int e = 0; e < kLoads; ++e) {
          const int v = tid_q + e * Wk::kConsumers, r = v / kPerRow, row = row0 + r;
          raw[e] = make_uint4(0u, 0u, 0u, 0u);
          if (r < n_rows)
            raw[e] = __ldg(reinterpret_cast<const uint4*>(
                qb + (row / a.G) * a.q_ss + (row % a.G) * a.q_sg + (v % kPerRow) * kVec));
        }
#pragma unroll
        for (int e = 0; e < kLoads; ++e) {
          const int v = tid_q + e * Wk::kConsumers, r = v / kPerRow, d = (v % kPerRow) * kVec;
          if (r < kRows) {
            const TQ* x = reinterpret_cast<const TQ*>(&raw[e]);
#pragma unroll
            for (int c = 0; c < kVec; ++c) {
              __nv_bfloat16 tm[kQTerms];
              bf16_terms<kQTerms>(to_f32(x[c]), tm);
#pragma unroll
              for (int i = 0; i < kQTerms; ++i) q_s[(i * kRows + r) * kQRow + d + c] = tm[i];
            }
          }
        }
        consumers_sync(Wk::kConsumers);
      }
      const uint32_t q_row = smem_u32(q_buf) + q_lane;
      if (lane < 16) {  // the visible lengths of this warp's rows rt * 16 + lane
        const int start = __ldg(a.starts + cur.b);
        const int kv_len = max(0, min(__ldg(a.lens + cur.b), a.window));
        const int r = rt * 16 + lane;
        lim_s[warp][lane] = r < n_rows ? max(0, min(kv_len, start + (row0 + r) / a.G + 1)) : 0;
      }
      __syncwarp();

      float o_acc[HD / 8][4];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) o_acc[n][c] = 0.f;
      float m_run[2] = {-1e30f, -1e30f};
      float z_run[2] = {0.f, 0.f};  // this thread's columns only, until the end

      for (int t = t_lo; t < t_end; ++t, ++it) {
        const int st = it % kStages;
        const unsigned char* ks = ring + st * Wk::kStageBytes;
        const unsigned char* vs = ks + Wk::kTileBytes;
        mbar_wait(&full[st], (it / kStages) & 1);
        const int valid = stop - t * kTile;  // positions of this tile below the stop
        if (valid < pg * 16 + 16) {
          // V rows past the stop hold what the page (or an earlier tile)
          // held: zero this warp's, as every warp reading them does
          const int r0 = max(valid, pg * 16);
          unsigned char* vz = const_cast<unsigned char*>(vs);
          for (int i = lane; i < (pg * 16 + 16 - r0) * Wk::kSlabs * 8; i += 32) {
            const int r = r0 + i / (Wk::kSlabs * 8), c = i % (Wk::kSlabs * 8);
            *reinterpret_cast<uint4*>(vz + (c >> 3) * kSlabBytes + r * 128 + (c & 7) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          __syncwarp();
        }

        // s = q k^T over this warp's 16 positions: two n8 tiles.  Each
        // k16 step sums in a fresh accumulator, smallest q term first, and
        // joins s by a rounded add: the tensor cores truncate their f32
        // sums to the accumulator's exponent, which a running s would make
        // the largest
        const uint32_t k_tile = smem_u32(ks);
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t kb[4];  // (positions 0-7, 8-15) x (dims 0-7, 8-15) of this k16 step
          ldsm_x4(kb, k_tile + (kk >> 2) * kSlabBytes + (k_row ^ ((kk & 3) << 5)));
          float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int i = kQTerms - 1; i >= 0; --i) {
            uint32_t qa[4];
            ldsm_x4(qa, q_row + (i * kRows * kQRow + kk * 16) * 2);
            mma_bf16(part[0], qa, kb[0], kb[1]);
            mma_bf16(part[1], qa, kb[2], kb[3]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[n][c] += part[n][c];
        }

        // online softmax of rows g (h = 0) and g + 8 (h = 1)
        const int base = t * kTile + pg * 16 + 2 * tq;
        const int lim0 = lim_s[warp][g], lim1 = lim_s[warp][g + 8];
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

        // o = o * alpha + p v, a tile's terms in a fresh accumulator joined
        // to o by one rounded f32 FMA (as TcBody)
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
        const uint32_t v_tile = smem_u32(vs);
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += 16) {
          uint32_t vb[4];  // (positions 0-7, 8-15) x (dims d0.., d0+8..), transposed
          ldsm_x4_trans(vb, v_tile + (d0 >> 6) * kSlabBytes + (v_row ^ (((d0 >> 3) & 7) << 4)));
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int i = kPTerms - 1; i >= 0; --i) {  // the smallest term first, as for s
            mma_bf16(t0, pa[i], vb[0], vb[1]);
            mma_bf16(t1, pa[i], vb[2], vb[3]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            o_acc[d0 / 8][c] = fmaf(o_acc[d0 / 8][c], alpha[c >> 1], t0[c]);
            o_acc[d0 / 8 + 1][c] = fmaf(o_acc[d0 / 8 + 1][c], alpha[c >> 1], t1[c]);
          }
        }
        if (t + 1 < t_end) {  // the segment's last stage is held for the epilogue
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
        }
      }

      if constexpr (Wk::kQBufs == 2) {  // this warp is done with the q buffer
        __syncwarp();
        if (lane == 0) mbar_arrive(&q_empty[q_seg & 1]);
      }
      ++q_seg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        z_run[h] += __shfl_xor_sync(0xffffffffu, z_run[h], 1);
        z_run[h] += __shfl_xor_sync(0xffffffffu, z_run[h], 2);
      }
      // fold the four position groups of each row tile, ((0, 1), (2, 3)),
      // through the held stage (that of the segment's last tile); warp (rt,
      // 0) ends with the row tile's (o, m, z) in its registers
      const int held = (it - 1) % kStages;
      float4* scratch = reinterpret_cast<float4*>(ring + held * Wk::kStageBytes);
      consumers_sync(Wk::kConsumers);  // every warp is done reading the stage
      auto put = [&](int slot) {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          scratch[(slot * (HD / 8) + n) * 32 + lane] =
              make_float4(o_acc[n][0], o_acc[n][1], o_acc[n][2], o_acc[n][3]);
        if (tq == 0) {
          gm_s[warp * 16 + g] = m_run[0];
          gm_s[warp * 16 + g + 8] = m_run[1];
          gz_s[warp * 16 + g] = z_run[0];
          gz_s[warp * 16 + g + 8] = z_run[1];
        }
      };
      auto take = [&](int slot, int from) {  // from: the warp that put it
        float wa[2], wb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mb = gm_s[from * 16 + g + 8 * h];
          const float mm = fmaxf(fmaxf(m_run[h], mb), -1e29f);
          wa[h] = expf(m_run[h] - mm);
          wb[h] = expf(mb - mm);
          z_run[h] = wa[h] * z_run[h] + wb[h] * gz_s[from * 16 + g + 8 * h];
          m_run[h] = mm;
        }
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float4 v = scratch[(slot * (HD / 8) + n) * 32 + lane];
          o_acc[n][0] = wa[0] * o_acc[n][0] + wb[0] * v.x;
          o_acc[n][1] = wa[0] * o_acc[n][1] + wb[0] * v.y;
          o_acc[n][2] = wa[1] * o_acc[n][2] + wb[1] * v.z;
          o_acc[n][3] = wa[1] * o_acc[n][3] + wb[1] * v.w;
        }
      };
      if (pg & 1) put(rt * 2 + (pg >> 1));
      consumers_sync(Wk::kConsumers);
      if (!(pg & 1)) take(rt * 2 + (pg >> 1), warp + 1);
      consumers_sync(Wk::kConsumers);
      if (pg == 2) put(rt * 2);
      consumers_sync(Wk::kConsumers);
      if (pg == 0) take(rt * 2, warp + 2);
      // the held stage is free: the zeroed rows and the fold's writes
      // ordered before the producer's next TMA into it
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[held]);

      // the row tile's result: to the output, or to this segment's partial
      const SegMeta meta = meta_s[warp];
      const int64_t first = meta.first;
      const int u = meta.u, n_rows = meta.n_rows, c_first = meta.c_first, n_seg = meta.n_seg;
      float *dst_o = a.o + first * HD, *dst_m = a.m + first, *dst_z = a.z + first;
      if (n_seg > 1) {
        const int64_t id = static_cast<int64_t>(u) + blockIdx.x;
        dst_o = a.po + id * kRows * HD;
        dst_m = a.pm + id * kRows;
        dst_z = a.pz + id * kRows;
      }
      if (pg == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rt * 16 + g + 8 * h;
          if (r < n_rows) {
#pragma unroll
            for (int n = 0; n < HD / 8; ++n)
              *reinterpret_cast<float2*>(dst_o + r * HD + n * 8 + 2 * tq) =
                  make_float2(o_acc[n][2 * h], o_acc[n][2 * h + 1]);
            if (tq == 0) {
              dst_m[r] = m_run[h];
              dst_z[r] = z_run[h];
            }
          }
        }
      }
      if (n_seg > 1) {
        // the block's partial, ordered by the barrier and thread 0's
        // release, before the ticket; the last to take it acquires the others'
        consumers_sync(Wk::kConsumers);
        if (tid == 0) {
          unsigned prev;
          asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                       : "=r"(prev)
                       : "l"(a.tickets + u)
                       : "memory");
          last_s = prev == static_cast<unsigned>(n_seg - 1);
          if (last_s) a.tickets[u] = 0;  // every segment of the unit has taken its ticket
        }
        consumers_sync(Wk::kConsumers);
        if (last_s) {
          // the fold, in segment order: eight threads a row (lanes of one
          // warp), HD / 8 columns each; the other blocks' partials are
          // read from L2 (__ldcg)
          constexpr int kCols = HD / 8;
          const int r = tid >> 3, part = tid & 7, col0 = part * kCols;
          const int64_t id0 = static_cast<int64_t>(u) + c_first;
          float mm = -1e29f;
          for (int i = part; i < n_seg; i += 8) mm = fmaxf(mm, __ldcg(a.pm + (id0 + i) * kRows + r));
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
          if (r < n_rows) {
            float zz = 0.f;
            float acc[kCols];
#pragma unroll
            for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
#pragma unroll 4
            for (int i = 0; i < n_seg; ++i) {
              const float wi = expf(__ldcg(a.pm + (id0 + i) * kRows + r) - mm);
              zz += wi * __ldcg(a.pz + (id0 + i) * kRows + r);
              const float4* src =
                  reinterpret_cast<const float4*>(a.po + ((id0 + i) * kRows + r) * HD + col0);
#pragma unroll
              for (int e = 0; e < kCols / 4; ++e) {
                const float4 v = __ldcg(src + e);
                acc[4 * e] += wi * v.x;
                acc[4 * e + 1] += wi * v.y;
                acc[4 * e + 2] += wi * v.z;
                acc[4 * e + 3] += wi * v.w;
              }
            }
            float4* out = reinterpret_cast<float4*>(a.o + (first + r) * HD + col0);
#pragma unroll
            for (int e = 0; e < kCols / 4; ++e)
              out[e] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]);
            if (part == 0) {
              a.m[first + r] = mm;
              a.z[first + r] = zz;
            }
          }
        }
      }
    }
  }
}

// blocks of the walk kernel the current device holds at once: the grid
template <typename TQ, int HD, int RT>
int walk_blocks() {
  using Wk = Walk<TQ, HD, RT>;
  auto kernel = paged_walk_attn_kernel<TQ, HD, RT>;
  cudaError_t err = allow_smem(kernel, Wk::kBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Wk::kThreads,
                                                           Wk::kBytes)) != cudaSuccess)
    return -static_cast<int>(err);
  return per_sm * sms;
}

template <typename TQ, int HD, int RT>
int launch_walk(WalkArgs w, const CUtensorMap& k_map, const CUtensorMap& v_map, int blocks,
                cudaStream_t stream) {
  using Wk = Walk<TQ, HD, RT>;
  auto kernel = paged_walk_attn_kernel<TQ, HD, RT>;
  const cudaError_t err = allow_smem(kernel, Wk::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  w.s.qtiles = (w.s.S * w.s.G + Wk::kRows - 1) / Wk::kRows;
  kernel<<<blocks, Wk::kThreads, Wk::kBytes, stream>>>(k_map, v_map, w);
  return static_cast<int>(cudaGetLastError());
}

// the walk kernel of (q dtype, hd, query rows a block): 16 rows, or 32
// for the ragged kernel (kDecode: S*G = G <= 8, 16 only).  With launch
// false, the blocks the device holds at once (negative: a CUDA error).
template <bool kDecode>
int walk_dispatch(int q_dtype, int hd, int block_rows, bool launch, const WalkArgs& w,
                  const CUtensorMap* k_map, const CUtensorMap* v_map, int blocks,
                  cudaStream_t stream) {
  using bf = __nv_bfloat16;
#define CALFKIT_WALK(Q, TQ, HD, RT)                                                        \
  if (q_dtype == Q && hd == HD && block_rows == 16 * RT)                                   \
    return launch ? launch_walk<TQ, HD, RT>(w, *k_map, *v_map, blocks, stream)             \
                  : walk_blocks<TQ, HD, RT>();
  CALFKIT_WALK(1, bf, 128, 1)
  CALFKIT_WALK(0, float, 128, 1)
  CALFKIT_WALK(1, bf, 64, 1)
  CALFKIT_WALK(0, float, 64, 1)
  if constexpr (!kDecode) {
    CALFKIT_WALK(1, bf, 128, 2)
    CALFKIT_WALK(0, float, 128, 2)
    CALFKIT_WALK(1, bf, 64, 2)
    CALFKIT_WALK(0, float, 64, 2)
  }
#undef CALFKIT_WALK
  return -1;
}

inline int gcd64(int page) {
  int g = 64;
  while (page % g) g >>= 1;
  return g;
}

// the walk over a bf16 pool: the shared split arguments (n_splits and
// split_pos unused; po, pm, pz hold blocks + B*K*qtiles partials of
// block_rows rows; tickets B*K*qtiles, zero), the two tensor maps (128
// bytes each, as calfkit_pool_tensor_map encodes them) and the walk's own
template <bool kDecode>
int paged_walk(int q_dtype, int hd, int block_rows, const SplitArgs& a, const void* k_map,
               const void* v_map, int blocks, int min_tiles, const int* tables,
               long long table_stride, int page, int layer, void* stream) {
  if (a.G < 1 || a.S < 1 || a.B < 0 || a.K < 0 || a.window < 0 || blocks < 1 || min_tiles < 1)
    return -1;
  if (kDecode && a.S * a.G > 8) return -1;
  if (page < 8 || page % 8 || layer < 0) return -1;
  if (!(a.po && a.pm && a.pz && a.tickets && k_map && v_map && tables)) return -1;
  if (a.B == 0 || a.K == 0) return 0;
  const WalkArgs w{a, tables, table_stride, page, gcd64(page), layer, min_tiles};
  CUtensorMap km, vm;  // by value into the launch's parameters
  memcpy(&km, k_map, sizeof(km));
  memcpy(&vm, v_map, sizeof(vm));
  return walk_dispatch<kDecode>(q_dtype, hd, block_rows, true, w, &km, &vm, blocks,
                                static_cast<cudaStream_t>(stream));
}

}  // namespace

// The tensor map of a bf16 pool [L, N, K, page, hd] (element strides sl,
// sn, sk, sp; unit last axis) as dims (hd, page, K, N, L): boxes of 64
// columns x gcd(page, 64) positions, 128-byte swizzled, written to out
// (128 bytes).  Returns 0, -1 for a shape the walk does not take (page not
// a multiple of 8, hd not 64 or 128), or -2 where it cannot be encoded.
extern "C" int calfkit_pool_tensor_map(void* out, const void* base, int L, int N, int K, int page,
                                       int hd, long long sl, long long sn, long long sk,
                                       long long sp) {
  if (page < 8 || page % 8 || (hd != 64 && hd != 128) || L < 1 || N < 1 || K < 1) return -1;
  const int64_t dims[5] = {hd, page, K, N, L};
  const int64_t strides[4] = {sp, sk, sn, sl};
  const uint32_t box[5] = {64, static_cast<uint32_t>(gcd64(page)), 1, 1, 1};
  CUtensorMap map;
  if (!encode_bf16_map(&map, base, dims, strides, box)) return -2;
  memcpy(out, &map, sizeof(map));
  return 0;
}
