// Device helpers shared by the attention kernels that stream K/V tiles
// through shared memory (decode_attention.cu, ragged_attention.cu): 16-byte
// cp.async copies, 16-byte shared-memory loads as f32, warp reductions, and
// the two ways a (batch row, kv head)'s positions map to cache addresses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of shared memory as f32: 8 bf16 or 4 f32 values
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
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
// position pos in page pages[pos / page], at offset pos % page
template <typename T>
struct PagedRows {
  const T* base;     // the layer's pool at this kv head
  const int* pages;  // this row's block table, staged in shared memory
  int page;
  int64_t page_stride, pos_stride;
  __device__ __forceinline__ const T* at(int pos) const {
    const int p = pos / page;
    return base + static_cast<int64_t>(pages[p]) * page_stride +
           static_cast<int64_t>(pos - p * page) * pos_stride;
  }
};

// above 48 KB of shared memory only after the opt-in, which holds for the
// current device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
