// Helpers shared by the CUDA sources: the bit-row width of the dense edge
// operator, per-device kernel attributes (the shared-memory opt-in), the add of two 16-byte
// vectors, the rounding of an operand to bf16 (the D-MPNN kernels'
// matmul_dtype="bfloat16"), and the gather of one 16-byte vector of the
// encoder's layer-0 input.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 32-bit words of one bit row over E edge lanes.
__host__ __device__ inline int adj_words(int E) { return (E + 31) / 32; }

// Set a kernel attribute once per device: attributes are per device, and
// `configured` (a static of the caller, one per kernel and attribute) holds a
// bit per device.
inline cudaError_t set_attribute_once(const void* kernel, cudaFuncAttribute attr, int value,
                                      uint64_t& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, attr, value);
    if (err != cudaSuccess) return err;
    configured |= uint64_t{1} << dev;
  }
  return cudaSuccess;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device.
inline cudaError_t allow_smem(const void* kernel, int bytes, uint64_t& configured) {
  return set_attribute_once(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes, configured);
}

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// x rounded to the nearest bf16 (ties to even), as a float: what a TPU
// kernel's .astype(bfloat16) operand holds. With kBf16 false, x itself.
template <bool kBf16>
__device__ inline float operand(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}
template <bool kBf16>
__device__ inline float4 operand4(float4 v) {
  return make_float4(operand<kBf16>(v.x), operand<kBf16>(v.y), operand<kBf16>(v.z), operand<kBf16>(v.w));
}

// 4 bf16 values (8 bytes, the lower first) as floats, exactly.
__device__ inline float4 widen_bf16x4(uint2 raw) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), c = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, c.x, c.y);
}

// 4 values of a row of the bf16 stash, from element i (i % 4 == 0), as floats.
__device__ inline float4 load_bf16x4(const __nv_bfloat16* p, size_t i) {
  return widen_bf16x4(*reinterpret_cast<const uint2*>(p + i));
}

// 16-byte vector q, from column k0, of row r (= b * E + e) of a layer input
// whose rows are d wide: h_in[r], or with kGather the encoder's
// h0 = nf[b, src[r]] + ef[r] (h_in is then ef, nf is [B, V, d], and a src
// outside [0, V) gathers zero, as a one-hot would); with kBf16 the gathered
// nf rounded to bf16 first, as the TPU kernel's gather operand is.
template <bool kGather, bool kBf16 = false>
__device__ inline float4 input_vec(const float* __restrict__ h_in, const float* __restrict__ nf,
                                   const int* __restrict__ src, size_t r, int b, int V, int d,
                                   int k0, int q) {
  float4 v = reinterpret_cast<const float4*>(h_in + r * d + k0)[q];
  if constexpr (kGather) {
    const int s = src[r];
    if (s >= 0 && s < V)
      v = add4(operand4<kBf16>(reinterpret_cast<const float4*>(nf + ((size_t)b * V + s) * d + k0)[q]), v);
  }
  return v;
}

}  // namespace
