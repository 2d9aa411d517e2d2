// Ragged multi-query GQA attention over the KV cache: the dense window, and
// the paged pool read through block tables.  The main-cache source of the
// speculative verify step (S = k+1 queries a row), and of any mix of decode,
// prefill-chunk and verify rows.
//
// Replaces: calfkit_tpu/inference/pallas_attention.py:357
//   ragged_attention_pallas (kernel body _ragged_attn_kernel, :298), entry
//   point calfkit_ragged_attention; and pallas_attention.py:467
//   ragged_attention_paged_pallas (kernel body _ragged_paged_attn_kernel,
//   :413), entry point calfkit_ragged_paged_attention.  The dense form (and
//   the paged one over an f32 pool) runs the split-window body of
//   split_attention.cuh; the paged form over a bf16 pool runs the
//   persistent walk of paged_attention.cuh.
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
// over the 3.35 TB/s of device memory.  Two things kept the parent design
// far from it: a block per (b, kv head, query tile) walked its whole row
// alone (B*K = 64 blocks on 132 SMs at the verify path's shape), and its f32
// products on the CUDA cores were issue-bound (~9.5 us a 64-position tile
// at 20-32 query rows).
//
// What the design does about it:
// - The TPU kernel streams the window in 512-position chunks as a
//   sequential grid dimension with the statistics in VMEM scratch.  Here
//   the window is split across blocks: grid (kv head, row, split x query
//   tile), a split a run of 64-position tiles sized from the shape by the
//   wrapper.  A block walks its split up to its tile's stop, min(kv_len,
//   start + j_last + 1); splits past it exit at once.  The live splits'
//   partial (o, m, z) fold in split order in the last to finish (an atomic
//   ticket that resets itself): no second launch, the same bits every run.
// - bf16 caches: Q.K^T and P.V run on the tensor cores, mma.sync m16n8k16
//   (bf16 in, f32 accumulate): K from shared memory by ldmatrix, V by
//   ldmatrix.trans, scores and probabilities in registers (the m16n8
//   accumulator of s is, pair by pair, the A fragment of p).  A block takes
//   one or two m16 tiles of query rows (16 where S*G <= 16, else 32; wgmma's
//   m64 would idle 44 of 64 rows at S*G = 20), four warps a row tile, each
//   on 16 positions of every tile with its own running max and sum, folded
//   in order at the end.  The Pallas kernel multiplies in f32, and the
//   tolerances hold this kernel to that: q (f32) and p are each carried as
//   three bf16 terms, one product per term, accumulated in f32 (two terms
//   leave 2^-16 of each, enough to miss a 2e-5 tolerance).  A bf16 q, as
//   serving passes it, is exact in one term.  f32 caches keep the f32
//   CUDA-core products, in the same split grid (8 or 32 query rows a block).
// - K/V stream in 64-position tiles through a cp.async ring of two stages
//   (two blocks an SM by shared memory and, at 128 registers a thread, by
//   registers; a third stage timed no faster); one tile read from device
//   memory serves every query row of the block, the amortization
//   speculation exists for.
// - Positions past a query's limit add exp(-1e30 - m) = 0 with m >= -1e29
//   and rescale by exp(0) = 1, so stopping early, and cutting the window
//   into splits, give the same (o, m, z) as visiting the whole window.
//   Rows with nothing to see write o = 0, m = -1e29, z = 0.
// - The dense form reads K/V in place through the window view of [L, B,
//   K, S, hd]'s strides.  A bf16 pool is walked by a persistent,
//   length-balanced grid fed page by page by TMA, as the paged decode
//   kernel's (paged_attention.cuh; 32 query rows a block there take four
//   stages and one block an SM); pages past the stop, the trash page among
//   them, are never read.  An f32 pool keeps the split grid, each block
//   staging its split's block-table entries.  q is read through its
//   strides in its own dtype: the verify's [B, S, K, G, hd] queries are
//   not copied.

#include "paged_attention.cuh"

// q is [B, K, S, G, hd] through its strides; o [B, K, S, G, hd] contiguous,
// m and z [B, K, S, G]; kv_dtype and q_dtype 0 = float32, 1 = bfloat16;
// block_rows is the query rows a block takes (16 for bf16 caches or 8 for
// f32, or 32; any other is refused).  po/pm/pz ([n_splits, B*K*S*G, hd]
// and [n_splits, B*K*S*G] f32) and tickets (B*K*ceil(S*G / block_rows)
// ints, zero) are needed when n_splits > 1; the
// window is cut into n_splits runs of split_pos positions (a multiple of
// 64).  The cache pointers and strides must be 16-byte multiples (the
// wrapper checks).  Returns 0 on success, the CUDA error code of a refused
// launch, or -1 for a shape, type or plan the kernel does not take.
extern "C" int calfkit_ragged_attention(CALFKIT_SPLIT_PARAMS, const void* kc, const void* vc,
                                        const int* starts, const int* lens, int B, int K, int S,
                                        int G, int W, long long k_sb, long long k_sk,
                                        long long k_sw, long long v_sb, long long v_sk,
                                        long long v_sw) {
  const SplitArgs a = CALFKIT_SPLIT_ARGS(starts, lens, B, K, S, G, W);
  return dispatch<false, false>(kv_dtype, q_dtype, hd, block_rows, a,
                                DenseSource{kc, vc, k_sb, k_sk, k_sw, v_sb, v_sk, v_sw}, 0, stream);
}

// The paged form over the pool [L, N, K, page, hd]: pk/pv point at its
// layer `layer` (k_sn/k_sk/k_sp: its page, head and position strides, in
// elements); tables is [B, table_stride] int32 with at least wpages entries
// a row.  A bf16 pool takes the walk, an f32 pool the split grid, with the
// arguments of calfkit_paged_decode_attention (partials and tickets counted
// in units of B*K*ceil(S*G / block_rows)).  The same return codes as above.
extern "C" int calfkit_ragged_paged_attention(
    CALFKIT_SPLIT_PARAMS, const void* pk, const void* pv, const int* tables, const int* starts,
    const int* lens, int B, int K, int S, int G, int wpages, int page, long long table_stride,
    long long k_sn, long long k_sk, long long k_sp, long long v_sn, long long v_sk,
    long long v_sp, const void* k_map, const void* v_map, int blocks, int min_tiles, int layer) {
  if (page < 1 || wpages < 0) return -1;
  const SplitArgs a = CALFKIT_SPLIT_ARGS(starts, lens, B, K, S, G, wpages * page);
  if (kv_dtype == 1)
    return paged_walk<false>(q_dtype, hd, block_rows, a, k_map, v_map, blocks, min_tiles, tables,
                             table_stride, page, layer, stream);
  return dispatch<false, true>(
      kv_dtype, q_dtype, hd, block_rows, a,
      PagedSource{pk, pv, tables, table_stride, page, k_sn, k_sk, k_sp, v_sn, v_sk, v_sp},
      staged_entries(split_pos, page, wpages), stream);
}

// blocks of the paged ragged walk (bf16 pool; q dtype, hd, query rows a
// block: 16 or 32) the current device holds at once; negative: a CUDA
// error, -1 a configuration the walk does not take
extern "C" int calfkit_ragged_paged_blocks(int q_dtype, int hd, int block_rows) {
  return walk_dispatch<false>(q_dtype, hd, block_rows, false, WalkArgs{}, nullptr, nullptr, 0,
                              nullptr);
}
