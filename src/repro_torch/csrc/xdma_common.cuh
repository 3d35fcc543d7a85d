// Shared device helpers for the port's XDMA kernels: dtype codes, rounding
// to the stream dtype, and the per-logical-dim layout map.
//
// A Layout (tile, perm, pad) maps a logical coordinate to a physical element
// offset dimension by dimension: logical dim d with tile t contributes
// (i / t) * sgrid + (i % t) * stile, where sgrid and stile are the row-major
// strides of its grid and tile physical dims after the permutation (an
// untiled dim has t = 1 and only sgrid).  The host computes the strides from
// the layout and the logical shape (repro_torch/kernels/maps.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace xdma {

// dtype codes, shared with repro_torch/kernels/maps.py
constexpr int64_t F32 = 0;
constexpr int64_t BF16 = 1;
constexpr int64_t F16 = 2;

struct DimMap {
  int64_t tile;   // tile factor of the logical dim (1 when untiled)
  int64_t sgrid;  // stride of i / tile
  int64_t stile;  // stride of i % tile
};

// (q, r) = divmod(n, d) for n >= 0, d > 0; 32-bit arithmetic when both fit.
__device__ __forceinline__ void divmod(int64_t n, int64_t d, int64_t& q,
                                       int64_t& r) {
  if ((((uint64_t)n | (uint64_t)d) >> 32) == 0) {
    uint32_t a = (uint32_t)n, b = (uint32_t)d;
    uint32_t qq = a / b;
    q = qq;
    r = a - qq * b;
  } else {
    q = n / d;
    r = n - q * d;
  }
}

__device__ __forceinline__ int64_t dim_offset(const DimMap& m, int64_t i) {
  if (m.tile == 1) return i * m.sgrid;
  if ((m.tile & (m.tile - 1)) == 0) {  // power of two: shift and mask
    int sh = __ffsll((unsigned long long)m.tile) - 1;
    return (i >> sh) * m.sgrid + (i & (m.tile - 1)) * m.stile;
  }
  int64_t q, r;
  divmod(i, m.tile, q, r);
  return q * m.sgrid + r * m.stile;
}

// Round an f32 value to the stream dtype, to nearest even, and back.
__device__ __forceinline__ float round_to(float v, int64_t dt) {
  if (dt == BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (dt == F16) return __half2float(__float2half_rn(v));
  return v;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Deterministic block-wide sum: per-warp shuffle tree, then warp 0 sums the
// warp partials in order.  Every thread gets the result.  blockDim.x must be
// a multiple of 32; `scratch` holds at least 33 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nwarps ? scratch[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) scratch[32] = s;
  }
  __syncthreads();
  return scratch[32];
}

// V consecutive elements of T moved as one access: one 16-byte load or store
// when V * sizeof(T) == 16 and the address is 16-byte aligned.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Sum or max over groups of G consecutive threads (G a power of two, from 32
// up to blockDim.x): a shuffle tree in each warp, then the group's warp
// partials combined in order, so the result is deterministic.  Every thread
// gets its group's result.  For G > 32 every thread of the block must call
// it; `scratch` holds blockDim.x / 32 floats.
struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

template <int G, typename Op>
__device__ __forceinline__ float group_reduce(float v, float* scratch, Op op) {
  static_assert(G >= 32 && (G & (G - 1)) == 0, "G: a power of two >= 32");
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (G == 32) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  const int first = warp & ~(G / 32 - 1);
  float r = scratch[first];
  for (int w = 1; w < G / 32; ++w) r = op(r, scratch[first + w]);
  return r;
}

}  // namespace xdma
