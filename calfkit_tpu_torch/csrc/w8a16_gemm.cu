// Weight-only int8 GEMM: Y[M, N] = X[M, K] . dequant(W)[K, N], X and Y
// bf16, W int8 with one f32 scale an output column, f32 accumulation.
//
// Replaces: no Pallas kernel.  The JAX package reads a quantized weight
// through quant.dequant inside the jitted matmul, and XLA fuses the dequant
// into the product's operand load; eager PyTorch instead wrote the bf16
// weight to device memory at every use (an int8 read, an f32 write and read,
// a bf16 write and read) before the product read it again.  This kernel
// converts the weight inside the product, on its way to the tensor cores.
//
// Numbers: every weight element becomes bf16_rne(f32(q8) * scale[n]) before
// it enters the tensor cores, exactly the bits quant.dequant gives, so the
// kernel differs from einsum(x, dequant(w)) only in the order of the sum.
// No bf16 copy of any weight exists, not even in shared memory.
//
// What bounds it on an H100:
// - at decode M (a step's 128 rows or fewer), the int8 weight bytes: a
//   product reads K * N bytes for 2 * M * K * N operations, below the ~295
//   operations a byte where the tensor cores become the limit;
// - at chunk M (up to 4,096 positions of a wave and more), the bf16
//   operations.
// On the card the conversion's instructions and shared-memory traffic were
// what held both back (timed phase by phase inside a block), so the design
// spends as little of either as it can:
//
// 1. The product is taken transposed, Y^T = W^T X^T, so that the weights
//    are wgmma's A operand, which it reads from registers: each warp turns
//    its own 16 weight columns of the int8 tile into the bf16 A fragments
//    of its products directly, with no bf16 tile written to or read from
//    shared memory and no barrier between converting and multiplying warps.
//    X is the B operand, read by wgmma from shared memory as TMA left it.
// 2. Copies.  Thread 0 keeps TMA loads of the X tile (NT rows x 64 columns)
//    and the int8 W tile (64 rows x 128 columns) in flight through a ring of
//    stages, each completing on its own mbarrier, both 128-byte swizzled.
//    W's tensor map is encoded once a weight and kept by the wrapper:
//    weights never move.
// 3. Conversion.  ldmatrix.trans reads the int8 tile as 8 x 8 matrices of
//    byte pairs and hands each thread two k-adjacent pairs of two adjacent
//    columns: exactly the bytes of two rows of an A fragment, once the
//    fragment's rows g and g + 8 stand for columns 2g and 2g + 1 (undone
//    when the outputs are stored).  The bytes, biased by 128, become floats
//    through an exponent trick (integer permutes and one subtract), then one
//    multiply by the column's scale (two scales a thread, in registers for
//    the whole block) and one round to bf16.  Step k + 1 is converted while
//    the products of step k run.
// 4. Tiles follow the shape (the wrapper's plan, quant.int8_matmul_plan):
//    a block takes 128 weight columns and NT rows of X.  At decode M (NT =
//    128, one row tile) each weight is read once, split over K where the
//    column tiles alone leave SMs idle (the split blocks write f32 partials
//    and the last to finish a tile sums them in split order, deterministic,
//    through tickets it leaves at zero).  Wide M takes NT = 256, the
//    products' widest instruction, so each converted weight serves twice
//    the rows.
// 5. A launch does nothing on the host but encode X's tensor map, and
//    allocates nothing: partials and tickets come from the wrapper (torch's
//    caching allocator), so a launch is captured in a CUDA graph as it is.

#include "attention_common.cuh"  // mbarrier and TMA helpers, the tensor-map encoder

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;              // reduction depth of a stage: one 128-byte row of bf16 X
constexpr int kBN = 128;             // weight columns a block: two warpgroups of 64
constexpr int kThreads = 256;        // the two warpgroups: copies, conversion and products
constexpr int kWBytes = kBK * kBN;   // an int8 tile: 64 rows of 128 bytes

// a block's ring for NT rows of X a block
template <int NT>
struct Layout {
  static constexpr int kStages = NT == 128 ? 4 : 3;
  static constexpr int kXBytes = NT * kBK * 2;  // an X tile
  static constexpr int kStageBytes = kXBytes + kWBytes;
  // slack to align the swizzled tiles to 1 KB; the ring; the stages'
  // barriers; the last-block flag
  static constexpr size_t kBytes = 1024 + kStages * kStageBytes + kStages * sizeof(uint64_t) + 16;
};

// a wgmma shared-memory matrix descriptor of a 128-byte-swizzled K-major
// operand (X: the contracted axis contiguous): 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of registers an
// asynchronous product uses across it, or giving them to other values
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// one box of a 2-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// four 8 x 8 matrices of 16-bit pairs, transposed: thread l gets elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix i in r[i], the
// rows of matrix i at the addresses threads 8 i .. 8 i + 7 give
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for m64n128k16: a (the converted weights) in registers, b (X)
// K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t* a, uint64_t db) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// d += a b for m64n256k16: a (the converted weights) in registers, b (X)
// K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// one 32-bit word of four int8 weights as ldmatrix.trans leaves it
// (bytes: k, column j; k, j + 1; k + 1, j; k + 1, j + 1) → the two bf16
// pairs bf16_rne(f32(q) * s) of column j (lo) and j + 1 (hi) at k and k + 1:
// the biased byte b = q + 128 in the mantissa of 2^23 reads as 2^23 + b, so
// one subtract gives f32(q) exactly
__device__ __forceinline__ void dequant_pairs(uint32_t word, float s_lo, float s_hi, uint32_t& lo,
                                              uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  const float q0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float q1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  const float q2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  const float q3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
  const __nv_bfloat162 a = __floats2bfloat162_rn(__fmul_rn(q0, s_lo), __fmul_rn(q2, s_lo));
  const __nv_bfloat162 b = __floats2bfloat162_rn(__fmul_rn(q1, s_hi), __fmul_rn(q3, s_hi));
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1) w8a16_gemm_kernel(
    const __grid_constant__ CUtensorMap x_map,  // X as (K, M): boxes of 64 x NT, swizzled
    const __grid_constant__ CUtensorMap w_map,  // W as (N, K) bytes: boxes of 128 x 64, swizzled
    const float* __restrict__ scale,            // [N]
    bf16* __restrict__ y,                       // [M, N]
    float* __restrict__ partials,               // [splits, M, N] when the launch splits K
    int* __restrict__ tickets,                  // a tile's finished splits; zero between launches
    int M, int N, int K, int steps_per_split) {
  using L = Layout<NT>;
  constexpr int kStages = L::kStages;
  constexpr int kAcc = NT / 2;  // a thread's accumulators: 64 columns x NT rows over 128 threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes);
  int* last = reinterpret_cast<int*>(full + kStages);

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * NT;
  const int first = blockIdx.z * steps_per_split;
  const int steps = min((K + kBK - 1) / kBK - first, steps_per_split);
  const int tid = threadIdx.x;

  // thread 0 starts the copies of step i into stage i % kStages: the X and
  // int8 tiles, completing on the stage's barrier
  auto load = [&](int i) {
    const int st = i % kStages;
    unsigned char* stage = ring + st * L::kStageBytes;
    const int k0 = (first + i) * kBK;
    mbar_expect_tx(&full[st], L::kStageBytes);
    tma_load_2d(stage, &x_map, &full[st], k0, m0);
    tma_load_2d(stage + L::kXBytes, &w_map, &full[st], n0, k0);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);  // thread 0's arrival, then the bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(steps, kStages); ++i) load(i);
  }
  __syncthreads();

  // warp w of warpgroup wg multiplies the 16 weight columns 64 wg + 16 w ..
  // of the block's tile: its A fragments' rows g and g + 8 (g = lane / 4)
  // stand for columns 2 g and 2 g + 1 of those 16
  const int lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int col = n0 + 16 * warp + 2 * g;  // this thread's columns: col, col + 1
  const float s_lo = col < N ? scale[col] : 0.0f;
  const float s_hi = col < N ? scale[col + 1] : 0.0f;
  // ldmatrix: thread l addresses row l of each 32-row half of the int8
  // tile, at the warp's 16-byte chunk, 128-byte swizzled as TMA wrote it
  const uint32_t w_off = static_cast<uint32_t>(L::kXBytes + lane * 128 + ((warp ^ (lane & 7)) << 4));
  // the A fragments of a step: 4 registers for each of its 4 products
  auto fragments = [&](int st, uint32_t (&a)[16]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, smem_u32(ring) + st * L::kStageBytes + w_off + half * 32 * 128);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        // matrix m holds rows 8 m .. 8 m + 7 of the half: product 2 half
        // + m / 2 takes it as its k 0..7 (m even) or k 8..15 (m odd)
        const int p = 2 * half + m / 2, o = (m & 1) * 2;
        dequant_pairs(r[m], s_lo, s_hi, a[4 * p + o], a[4 * p + o + 1]);
      }
    }
  };

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  uint32_t a[16], next[16];
  mbar_wait(&full[0], 0);
  fragments(0, a);
  for (int i = 0; i < steps; ++i) {
    const int st = i % kStages;
    const uint32_t xa = smem_u32(ring) + st * L::kStageBytes;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma(acc, a + 4 * kk, kmajor_desc(xa + kk * 32));
    wgmma_commit();
    if (i + 1 < steps) {  // the next step's fragments, while the products run
      const int nst = (i + 1) % kStages;
      mbar_wait(&full[nst], ((i + 1) / kStages) & 1);
      fragments(nst, next);
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);  // the products read a until here
    block_sync();   // every warp is done with this stage
    if (tid == 0 && i + kStages < steps) load(i + kStages);
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] = next[j];
  }

  // thread (warp w, lane l) holds, for every 8 rows j of X, rows 8 j + 2 (l
  // % 4) and that + 1 of columns col (acc[4 j], acc[4 j + 1]) and col + 1
  // (acc[4 j + 2], acc[4 j + 3])
  const int row0 = m0 + c2;
  // f(row, column, the pair of outputs at (row, col) and (row, col + 1))
  auto each = [&](auto&& f) {
    if (col >= N) return;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * j + h;
        if (m < M) f(m, acc[4 * j + h], acc[4 * j + 2 + h]);
      }
  };
  auto store = [&](int m, float& lo, float& hi) {
    *reinterpret_cast<__nv_bfloat162*>(y + static_cast<int64_t>(m) * N + col) = __floats2bfloat162_rn(lo, hi);
  };
  if (gridDim.z == 1) {
    each(store);
    return;
  }

  // split over K: write this split's partial; the tile's last split to
  // finish sums every split's in split order and writes the tile
  const int64_t plane = static_cast<int64_t>(M) * N;
  float* part = partials + blockIdx.z * plane;
  each([&](int m, float& lo, float& hi) {
    *reinterpret_cast<float2*>(part + static_cast<int64_t>(m) * N + col) = make_float2(lo, hi);
  });
  __threadfence();
  block_sync();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) *last = atomicAdd(&tickets[tile], 1) == static_cast<int>(gridDim.z) - 1;
  block_sync();
  if (!*last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  for (int s = 0; s < static_cast<int>(gridDim.z); ++s) {
    const float* ps = partials + s * plane;
    each([&](int m, float& lo, float& hi) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(ps + static_cast<int64_t>(m) * N + col));
      lo += v.x;
      hi += v.y;
    });
  }
  each(store);
  if (tid == 0) tickets[tile] = 0;
}

constexpr int kMapRefused = -2;

template <int NT>
int launch(const void* x, const CUtensorMap& w_map, const float* scale, void* y, float* partials,
           int* tickets, int M, int N, int K, int splits, int steps_per_split, cudaStream_t stream) {
  using L = Layout<NT>;
  CUtensorMap x_map;
  const int64_t dims[2] = {K, M};
  const int64_t strides[1] = {K};
  const uint32_t box[2] = {kBK, NT};
  if (!encode_bf16_map(&x_map, x, dims, strides, box)) return kMapRefused;
  const auto kernel = w8a16_gemm_kernel<NT>;
  const cudaError_t err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + NT - 1) / NT, splits);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(x_map, w_map, scale, static_cast<bf16*>(y), partials,
                                                tickets, M, N, K, steps_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor map of an int8 weight [K, N] (row-major, N a multiple of 16,
// a 16-byte-aligned base), boxes of 128 columns x 64 rows, 128-byte
// swizzled, zeros past each extent, written to out (128 bytes).  Returns 0,
// -1 for a shape it does not take, or -2 when the map cannot be encoded.
extern "C" int calfkit_w8_tensor_map(void* out, const void* w, int K, int N) {
  if (K < 1 || N < 16 || N % 16 != 0) return -1;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kMapRefused;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBN), static_cast<cuuint32_t>(kBK)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res =
      encode(static_cast<CUtensorMap*>(out), CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kMapRefused;
}

// Y[M, N] = X[M, K] . dequant(W)[K, N] for bf16 X and Y (row-major,
// 16-byte-aligned, K a multiple of 8) and W's tensor map (from
// calfkit_w8_tensor_map), in a grid of N / 128 x M / rows x splits blocks,
// each taking steps_per_split steps of 64 along K; rows (of X a block) is
// 128 or 256.  With splits > 1, partials holds splits x M x N floats and
// tickets one zero int per output tile.  Returns 0 on success, the CUDA
// error code of a refused launch, -1 for arguments it does not take, or -2
// when X's tensor map cannot be encoded.
extern "C" int calfkit_w8a16_gemm(const void* x, const void* w_map, const float* scale, void* y,
                                  float* partials, int* tickets, int M, int N, int K, int rows,
                                  int splits, int steps_per_split, void* stream) {
  if (M < 0 || N < 16 || N % 16 != 0 || K < 1 || K % 8 != 0 || splits < 1 || steps_per_split < 1 ||
      (splits - 1) * steps_per_split >= (K + kBK - 1) / kBK)
    return -1;
  if (splits > 1 && (partials == nullptr || tickets == nullptr)) return -1;
  if (M == 0) return 0;
  const CUtensorMap& map = *static_cast<const CUtensorMap*>(w_map);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 128) return launch<128>(x, map, scale, y, partials, tickets, M, N, K, splits, steps_per_split, s);
  if (rows == 256) return launch<256>(x, map, scale, y, partials, tickets, M, N, K, splits, steps_per_split, s);
  return -1;
}
