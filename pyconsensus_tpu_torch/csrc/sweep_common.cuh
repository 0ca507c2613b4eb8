// Shared device helpers of the port's storage kernels: the storage decode
// (pallas_kernels._decode_block) of int8 sentinel, float32 and bfloat16
// storage, aligned vector loads and a fixed-order block sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pyc {

// int8 sentinel storage: stored = round(2 * value) in {0, 1, 2}, -1 absent.
__device__ __forceinline__ void decode(int8_t s, float& val, bool& absent) {
  val = static_cast<float>(s) * 0.5f;
  absent = s < 0;
}

// float storage: NaN marks an absent entry.
__device__ __forceinline__ void decode(float s, float& val, bool& absent) {
  val = s;
  absent = isnan(s);
}

// bfloat16 storage: the 16 bits are the high half of a float32 (exact,
// no rounding); NaN marks an absent entry.
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void decode(__nv_bfloat16 s, float& val,
                                       bool& absent) {
  val = bf16_bits_to_float(__bfloat16_as_ushort(s));
  absent = isnan(val);
}

// The zero of a storage type, for the copies past R or E. bfloat16 takes
// its bits: its default constructor need not clear them.
template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// VW consecutive elements loaded in one aligned access (16 bytes for
// int8 x16, bfloat16 x8 and float x4).
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Vec {
  T v[VW];
};

template <typename T, int VW>
__device__ __forceinline__ Vec<T, VW> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, VW>*>(p);
}

// Sum over the block in a fixed order: a shuffle tree in each warp, then
// warp 0 over the warp partials. The result is valid in thread 0. Every
// thread of the block must call it.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  static_assert(NT % 32 == 0 && NT <= 1024, "block size");
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.f;
  if (warp == 0) {
    r = lane < NT / 32 ? scratch[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
  }
  __syncthreads();
  return r;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace pyc
