// Helpers shared by the attention kernels that stream K/V tiles through
// shared memory (split_attention.cuh, paged_attention.cuh,
// prefill_attention.cu): 16-byte cp.async copies, 16-byte shared-memory
// loads of f32, warp reductions, the two ways a (batch row, kv head)'s
// positions map to cache addresses for cp.async, and the mbarrier and TMA
// primitives with the host-side tensor-map encoder.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of shared memory: 4 f32 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  out[0] = raw.x;
  out[1] = raw.y;
  out[2] = raw.z;
  out[3] = raw.w;
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// K/V rows of one (batch row, kv head) in the dense cache: position pos at
// base + pos * stride
template <typename T>
struct DenseRows {
  const T* base;
  int64_t stride;
  __device__ __forceinline__ const T* at(int pos) const { return base + pos * stride; }
};

// K/V rows of one (batch row, kv head) in a layer of the paged pool:
// position pos in the row's page pos / page, at offset pos % page; `pages`
// holds the row's block table from its entry `first` on
template <typename T>
struct PagedRows {
  const T* base;     // the layer's pool at this kv head
  const int* pages;  // a slice of this row's block table, staged in shared memory
  int first;         // the table entry pages[0] holds
  int page;
  int64_t page_stride, pos_stride;
  __device__ __forceinline__ const T* at(int pos) const {
    const int p = pos / page;
    return base + static_cast<int64_t>(pages[p - first]) * page_stride +
           static_cast<int64_t>(pos - p * page) * pos_stride;
  }
};

// ------------------------------------------------------- mbarriers and TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 5-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// plain shared-memory stores, ordered before later async-proxy accesses
// (wgmma's reads, TMA's writes) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda at run time, so the library
// links nothing beyond the CUDA runtime; null where libcuda lacks it
inline EncodeTiled tensor_map_encoder() {
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

// the tiled tensor map of a bf16 array of RANK dims (dims[0] the unit-stride
// axis; strides[i] the element stride of dims[i + 1]), boxes of box[] and
// 128-byte swizzled, zeros past each extent; false where it cannot be
// encoded.  An axis of extent 1 may carry any stride: it is given the span
// of the axes inside it, a 16-byte multiple as the map requires.
template <int RANK>
bool encode_bf16_map(CUtensorMap* map, const void* base, const int64_t (&dims)[RANK],
                     const int64_t (&strides)[RANK - 1], const uint32_t (&box)[RANK]) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t d[RANK], st[RANK - 1];
  cuuint32_t bx[RANK], unit[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = box[i];
    unit[i] = 1;
  }
  cuuint64_t span = d[0] * sizeof(__nv_bfloat16);
  for (int i = 0; i < RANK - 1; ++i) {
    st[i] = d[i + 1] == 1 ? span : static_cast<cuuint64_t>(strides[i]) * sizeof(__nv_bfloat16);
    span = st[i] * d[i + 1];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, RANK, const_cast<void*>(base), d, st, bx,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// above 48 KB of shared memory only after the opt-in, which holds for the
// current device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
