// Shared device helpers for the port's hand-written kernels.
//
// Element types: bf16 travels as its raw 16-bit pattern (uint16_t) so the
// kernels need no bf16 arithmetic at all: widening is a shift into the high
// half of an f32, narrowing is the round-to-nearest-even intrinsic. Every
// product and sum in the kernels runs in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace acx {

// dtype codes of the C entry points (the Python wrappers pass these).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Masked-logit value of the TPU kernels (_NEG_INF in ops/attention.py).
constexpr float kNegInf = -1e30f;

// True -inf: a logit set to it gets probability exactly 0 under any
// finite running max.
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ uint16_t from_f32<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// x rounded to T's precision, kept in f32 (the TPU kernels' casts of the
// pre-scaled q and of the probabilities to the input dtype).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace acx
