// Single-query GQA decode attention over the KV cache: the dense window, and
// the paged pool read through block tables.
//
// Replaces: calfkit_tpu/inference/pallas_attention.py:60
//   decode_attention_pallas (kernel body _decode_attn_kernel, :33), entry
//   point calfkit_decode_attention; and pallas_attention.py:153
//   paged_decode_attention_pallas (kernel body _paged_attn_kernel, :99),
//   entry point calfkit_paged_decode_attention.  The dense form (and the
//   paged one over an f32 pool) runs the split-window body of
//   split_attention.cuh; the paged form over a bf16 pool, the serving path,
//   runs the persistent walk of paged_attention.cuh.
//
// Computes, for every (batch row b, kv head k) and each of its G query heads:
//   s[w] = (q . k[w]) * scale, masked to -1e30 where w >= base_lens[b]
//   m    = max(max_w s[w], -1e29)          (the floor keeps fresh rows finite)
//   z    = sum_w exp(s[w] - m)
//   o    = sum_w exp(s[w] - m) * v[w]      (UNnormalized, f32)
// and returns (o, m, z), the contract logsumexp_merge folds with the
// fresh-token ring.  In the paged form, position w of row b lives in page
// tables[b, w / page] of the pool's layer, at offset w % page.  This is the
// ragged mask law at S = 1 with start = len (min(len, len + 1) = len), so
// the decode entry points launch the ragged kernels' body with S = 1.
//
// What bounds it on an H100: bytes.  Each query head does 4*hd operations
// per cached position while the position costs 2*hd*sizeof(T) bytes of K/V,
// far below the ~295 operations per byte where the tensor cores would be
// the limit.  The least time is the K/V bytes of the valid positions over
// the 3.35 TB/s of device memory; a block is held to it by the bytes it
// keeps in flight and by how many SMs have work.
//
// What the design does about it:
// - The TPU kernel holds the whole [W, hd] slice in VMEM and its paged form
//   walks its pages as a sequential grid dimension with the statistics in
//   VMEM scratch.  Blocks on Hopper run in parallel and carry nothing
//   between them, and a block per (b, kv head) was B*K = 64 blocks on 132
//   SMs at serving batch, each walking its whole row: the longest row set
//   the time while half the card idled.  So the window is split across
//   blocks (flash-decoding): a split is a run of 64-position tiles that the
//   wrapper sizes from the shape (about three blocks an SM over a full
//   window, at least four tiles a split), a split past the row's length
//   exits at once, and the live splits' partial (o, m, z) fold in split
//   order in the last of them to finish (an atomic ticket that resets
//   itself): no second launch, and the same bits every run.  Rows that fit
//   one split skip the fold and the scratch.
// - One block serves all G query heads of its kv head from each K/V tile,
//   so every cache byte is read from device memory once.  Tiles arrive by
//   cp.async, 16 bytes a copy, in a ring of two stages (three for f32
//   caches); the ragged tail of the last tile is zero-filled, not read.
// - bf16 caches: the products run on the tensor cores (mma.sync, 4 of the
//   16 rows of an m16 tile live at G = 4).  The kernel is bound by bytes,
//   so the idle rows cost nothing that shows, and the tensor-core body is
//   one body for decode and ragged.  Kept f32-exact as the Pallas kernel's
//   f32 products are: q (f32) and p are split into three bf16 terms each;
//   a bf16 q, as serving passes it, is one term.  f32 caches take the
//   CUDA-core body in the same split grid, 8 query rows a block.
// - The paged TPU kernel visits all wpages pages, but a page past
//   ceil(len / page) adds exact zeros (scores -1e30, exp(-1e30 - m) = 0
//   with m >= -1e29), so the kernels stop at the row's length.  The split
//   grid sizes its splits from the window, since the host reads no length:
//   at serving batch that left a second, partial wave of blocks and a
//   page lookup per 16-byte copy.  So a bf16 pool is read by a persistent
//   grid (blocks an SM x SMs) that walks a plan every block computes from
//   the lengths: all rows' live tiles cut into equal chunks, one a block,
//   the partials of a row cut across chunks folded in order by the last of
//   them.  A producer warp feeds the ring (three stages) by TMA, one box a
//   page piece, through one tensor map over the whole pool with the layer
//   and the page id as coordinates (paged_attention.cuh).  The dense cache
//   is read through its strides (the engine's window view of [L, B, K, S,
//   hd]); q is read through its strides in its own dtype.  No window is
//   gathered, nothing is copied.
// Left for later: CUDA graphs for the launch (the serving path is
// host-bound).

#include "paged_attention.cuh"

// q is [B, K, G, hd] through its strides (q_ss unused); o [B, K, G, hd]
// contiguous, m and z [B, K, G]; kv_dtype and q_dtype 0 = float32, 1 =
// bfloat16; block_rows is the query rows a block takes (16 for bf16
// caches, 8 for f32; any other is refused).  po/pm/pz ([n_splits, B*K*G,
// hd] and [n_splits, B*K*G] f32) and tickets (B*K ints, zero) are needed
// when n_splits > 1; the window is
// cut into n_splits runs of split_pos positions (a multiple of 64).  The
// cache pointers and strides must be 16-byte multiples (the wrapper
// checks).  Returns 0 on success, the CUDA error code of a refused launch,
// or -1 for a shape, type or plan the kernel does not take.
extern "C" int calfkit_decode_attention(CALFKIT_SPLIT_PARAMS, const void* kc, const void* vc,
                                        const int* lens, int B, int K, int G, int W,
                                        long long k_sb, long long k_sk, long long k_sw,
                                        long long v_sb, long long v_sk, long long v_sw) {
  const SplitArgs a = CALFKIT_SPLIT_ARGS(lens, lens, B, K, 1, G, W);
  return dispatch<true, false>(kv_dtype, q_dtype, hd, block_rows, a,
                               DenseSource{kc, vc, k_sb, k_sk, k_sw, v_sb, v_sk, v_sw}, 0, stream);
}

// The paged form over the pool [L, N, K, page, hd]: pk/pv point at its
// layer `layer` (k_sn/k_sk/k_sp: its page, head and position strides, in
// elements); tables is [B, table_stride] int32 with at least wpages entries
// a row.  A bf16 pool takes the walk: k_map and v_map are the pool's tensor
// maps (calfkit_pool_tensor_map), the grid is `blocks` blocks
// (calfkit_paged_decode_blocks gives the most the card holds at once),
// chunks of at least min_tiles tiles; po/pm/pz hold B*K + blocks partials
// of block_rows rows and tickets B*K ints, zero; n_splits and split_pos are
// unused; page must be a multiple of 8.  An f32 pool takes the split grid
// as the dense form (any page size >= 1; the maps, blocks and min_tiles
// unused).  The same return codes as above.
extern "C" int calfkit_paged_decode_attention(
    CALFKIT_SPLIT_PARAMS, const void* pk, const void* pv, const int* tables, const int* lens,
    int B, int K, int G, int wpages, int page, long long table_stride, long long k_sn,
    long long k_sk, long long k_sp, long long v_sn, long long v_sk, long long v_sp,
    const void* k_map, const void* v_map, int blocks, int min_tiles, int layer) {
  if (page < 1 || wpages < 0) return -1;
  const SplitArgs a = CALFKIT_SPLIT_ARGS(lens, lens, B, K, 1, G, wpages * page);
  if (kv_dtype == 1)
    return paged_walk<true>(q_dtype, hd, block_rows, a, k_map, v_map, blocks, min_tiles, tables,
                            table_stride, page, layer, stream);
  return dispatch<true, true>(
      kv_dtype, q_dtype, hd, block_rows, a,
      PagedSource{pk, pv, tables, table_stride, page, k_sn, k_sk, k_sp, v_sn, v_sk, v_sp},
      staged_entries(split_pos, page, wpages), stream);
}

// blocks of the paged decode walk (bf16 pool; q dtype, hd, query rows a
// block) the current device holds at once; negative: a CUDA error, -1 a
// configuration the walk does not take
extern "C" int calfkit_paged_decode_blocks(int q_dtype, int hd, int block_rows) {
  return walk_dispatch<true>(q_dtype, hd, block_rows, false, WalkArgs{}, nullptr, nullptr, 0,
                             nullptr);
}
