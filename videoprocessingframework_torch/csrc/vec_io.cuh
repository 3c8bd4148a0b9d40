// Vector loads and stores that convert to and from float32, shared by the
// model layer's kernels (layer_norm.cu, rope2d.cu).
//
// A vector is VEC elements of T from an address aligned to VEC * sizeof(T)
// bytes: one load or store where that is at most 16 bytes, two halves
// otherwise (float64 vectors of 4). Elements convert to float32 on the load
// and round once, to nearest even, on the store.
//
// Dtype codes, as the Python wrappers pass them (models/layers_cuda.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define VPF_KERNEL_API extern "C" __attribute__((visibility("default")))

namespace vpf {

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3 };

inline int dtype_bytes(int dtype) {
  return dtype == kF32 ? 4 : dtype == kF64 ? 8 : 2;
}

inline bool valid_dtype(int dtype) { return dtype >= kF32 && dtype <= kF64; }

inline bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <int BYTES> struct Bytes;
template <> struct Bytes<2> { using T = uint16_t; };
template <> struct Bytes<4> { using T = uint32_t; };
template <> struct Bytes<8> { using T = uint2; };
template <> struct Bytes<16> { using T = uint4; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(double v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ double from_float<double>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* d) {
  if constexpr (VEC * sizeof(T) > 16) {
    load_vec<T, VEC / 2>(p, d);
    load_vec<T, VEC / 2>(p + VEC / 2, d + VEC / 2);
  } else {
    using V = typename Bytes<VEC * sizeof(T)>::T;
    const V v = *reinterpret_cast<const V*>(p);
    T e[VEC];
    memcpy(e, &v, sizeof(V));
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = to_float(e[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* s) {
  if constexpr (VEC * sizeof(T) > 16) {
    store_vec<T, VEC / 2>(p, s);
    store_vec<T, VEC / 2>(p + VEC / 2, s + VEC / 2);
  } else {
    using V = typename Bytes<VEC * sizeof(T)>::T;
    T e[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_float<T>(s[k]);
    V v;
    memcpy(&v, e, sizeof(V));
    *reinterpret_cast<V*>(p) = v;
  }
}

}  // namespace vpf
