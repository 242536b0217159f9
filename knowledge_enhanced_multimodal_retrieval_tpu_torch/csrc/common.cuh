// Shared device helpers for the port's hand-written Hopper kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// (see ops/dispatch.py). --fmad=false keeps every a*b+c as a rounded
// multiply then a rounded add, the op order the JAX reference uses; the
// quantized paths turn single-ulp differences into whole int8 steps.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define KEMR_CHECK_LAUNCH()                       \
  do {                                            \
    cudaError_t _e = cudaGetLastError();          \
    if (_e != cudaSuccess) return (int)_e;        \
  } while (0)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max over blockDim.x threads (a multiple of 32, <= 1024).
// ``red`` is 32 floats of shared memory; safe to call back to back.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : 0.f;
  return warp_sum(t);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : -FLT_MAX;
  return warp_max(t);
}

// Symmetric int8 of one value against a per-row scale: jnp.round(h / r)
// rounds half to even, as __float2int_rn does; divide, never multiply by
// a reciprocal, to keep the reference's rounding.
__device__ __forceinline__ int8_t quant_i8(float h, float r) {
  return (int8_t)__float2int_rn(h / r);
}
