// What the flash attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) share: exp2 and log constants and the
// conversions between fp32 and the inputs' types.
#pragma once

#include <cuda_bf16.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace
