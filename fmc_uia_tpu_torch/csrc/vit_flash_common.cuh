// Helpers shared by the ViT global-attention kernels (K4f, K4b): the
// [B, H, N, dh] layouts they read, quad reductions and the f32 kernels'
// row helpers (the bf16 kernels' Hopper pieces: sm90_common.cuh and
// vit_flash_sm90.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace vitfa {

using namespace sm90;  // smem_u32, pack_bf16 and the Hopper pieces

typedef __nv_bfloat16 bf16;

constexpr int kDh = 64;             // the head dim the kernels take
constexpr int kRowsF32 = 128;       // f32 kernels: one thread per row
constexpr int kTileF32 = 32;        // f32 kernels: rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element strides of a [B, H, N, dh] view whose last axis is contiguous
// (q, k and v are column slices of the qkv projection; o and the grads
// are written as [B, N, H, dh], so the block's reshape back is free).
struct Layout {
  long long b, h, n;
};

__device__ __forceinline__ long long head_off(const Layout& l, int b,
                                              int h) {
  return b * l.b + h * l.h;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [r0, r0 + nrows) of one (b, h) slice of an f32 tensor into a
// [rows][kDh] shared tile with 16-byte loads (rows >= N are zeros).
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              long long sn, int r0,
                                              int nrows, int N) {
  for (int c = threadIdx.x; c < nrows * (kDh / 4); c += blockDim.x) {
    const int r = c / (kDh / 4), ch = c % (kDh / 4);
    const int row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < N)
      v = __ldg(reinterpret_cast<const float4*>(base + row * sn + ch * 4));
    *reinterpret_cast<float4*>(dst + r * kDh + ch * 4) = v;
  }
}

// dot of a register row with a shared row, 4 partial sums
__device__ __forceinline__ float dot64(const float (&x)[kDh],
                                       const float* y) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < kDh; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(y + d);
    s[0] = fmaf(x[d], w.x, s[0]);
    s[1] = fmaf(x[d + 1], w.y, s[1]);
    s[2] = fmaf(x[d + 2], w.z, s[2]);
    s[3] = fmaf(x[d + 3], w.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

__device__ __forceinline__ void axpy64(float (&acc)[kDh], float a,
                                       const float* y) {
#pragma unroll
  for (int d = 0; d < kDh; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(y + d);
    acc[d] = fmaf(a, w.x, acc[d]);
    acc[d + 1] = fmaf(a, w.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, w.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, w.w, acc[d + 3]);
  }
}

__device__ __forceinline__ void load_row_f32(float (&x)[kDh], const float* p,
                                             bool ok) {
#pragma unroll
  for (int d = 0; d < kDh; d += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) v = __ldg(reinterpret_cast<const float4*>(p + d));
    x[d] = v.x;
    x[d + 1] = v.y;
    x[d + 2] = v.z;
    x[d + 3] = v.w;
  }
}

__device__ __forceinline__ void store_row_f32(float* p,
                                              const float (&x)[kDh]) {
#pragma unroll
  for (int d = 0; d < kDh; d += 4)
    *reinterpret_cast<float4*>(p + d) =
        make_float4(x[d], x[d + 1], x[d + 2], x[d + 3]);
}

// Every stride a multiple of 16 bytes, so rows are 16-byte aligned.
inline bool layouts_ok(const long long* s, int n, int elem_bytes) {
  const long long v = 16 / elem_bytes;
  for (int i = 0; i < n; ++i)
    if (s[i] % v != 0) return false;
  return true;
}

}  // namespace vitfa
