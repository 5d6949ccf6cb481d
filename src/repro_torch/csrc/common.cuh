// Helpers shared by the port's CUDA kernels: element conversion to and from
// the fp32 compute type (the model dtypes, and the int8 / fp8 e4m3 storage
// of the paged cache), the mask constant, and dynamic shared memory setup.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Masked scores are -1e30 on fp32 scores, never -inf, exactly as the JAX
// package's kernels and references: a row whose every entry is masked stays
// finite (a uniform softmax) instead of turning into NaN.
constexpr float kNegInf = -1e30f;

// -inf, for padding past the end of a key range (weight exactly 0 once the
// running max is finite)
__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

// dtype codes passed by the Python wrappers (kernels/common.py KERNEL_DTYPES
// and STORAGE_DTYPES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;
constexpr int kFp8E4M3 = 3;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// quantized cache storage: the value is code * scale, the scale applied by
// the caller (an exact conversion here: every int8 and e4m3 code is an fp32)
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's cast
}

// Reductions over the 16 lanes of a half warp (xor offsets below 16 never
// cross from one half to the other).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// Load `valid` rows of Dh elements (row stride `rs`, in elements) into shared
// memory as fp32 with pitch Dh + 1 (the pad keeps column walks free of bank
// conflicts); rows valid .. rows-1 are zero-filled. All Threads threads of
// the block take part.
template <int Threads, typename T, int Dh>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs, int rows,
                                          int valid) {
  for (int idx = threadIdx.x; idx < rows * Dh; idx += Threads) {
    const int r = idx / Dh, d = idx % Dh;
    dst[r * (Dh + 1) + d] = r < valid ? to_f32<T>(src[r * rs + d]) : 0.f;
  }
}

// load_rows for a cache operand that may be quantized: row r's elements are
// to_f32(code) * scale[r * ss] when `scale` is non-null (the dequantisation of
// the paged cache, one fp32 scale per slot or token), plain to_f32 otherwise.
template <int Threads, typename T, int Dh>
__device__ __forceinline__ void load_rows_scaled(float* dst, const T* src, long long rs,
                                                 const float* scale, long long ss, int rows,
                                                 int valid) {
  if (scale == nullptr) {
    load_rows<Threads, T, Dh>(dst, src, rs, rows, valid);
    return;
  }
  for (int idx = threadIdx.x; idx < rows * Dh; idx += Threads) {
    const int r = idx / Dh, d = idx % Dh;
    dst[r * (Dh + 1) + d] = r < valid ? to_f32<T>(src[r * rs + d]) * scale[r * ss] : 0.f;
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
