// Helpers shared by the ViT global-attention kernels (K4f, K4b): tile
// shapes, the [B, H, N, dh] layouts they read, cp.async tile loads,
// ldmatrix and the bf16 tensor-core product mma.sync m16n8k16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vitfa {

typedef __nv_bfloat16 bf16;

constexpr int kDh = 64;             // the head dim the kernels take
constexpr int kTile = 64;           // query / key rows of a bf16 tile
constexpr int kWarps = 4;           // 16 rows of a tile per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kPitch = kDh + 8;     // bf16 row pitch in shared memory: 144
                                    // bytes, so the 8 rows an ldmatrix
                                    // phase reads fall in 8 bank groups
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows [r0, r0 + kTile) of one (b, h) slice (row 0 at `base`, row stride
// sn elements) into a [kTile][kPitch] bf16 tile; rows >= N become zeros,
// so masked keys and queries never bring NaN or Inf into a product.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* base,
                                                long long sn, int r0,
                                                int N) {
  for (int c = threadIdx.x; c < kTile * (kDh / 8); c += kThreads) {
    const int r = c / (kDh / 8), ch = c % (kDh / 8);
    const int row = r0 + r;
    const bool ok = row < N;
    cp_async16(dst + r * kPitch + ch * 8, base + (ok ? row : 0) * sn + ch * 8,
               ok ? 16 : 0);
  }
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3). Lane t receives, of each matrix, the
// elements (t / 4, 2 (t % 4) + {0, 1}); with .trans, (2 (t % 4) + {0, 1},
// t / 4) -- the mma fragment layouts.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate. With
// g = lane / 4, c = 2 (lane % 4): a = {(g, c..c+1), (g+8, c..), (g, c+8..),
// (g+8, c+8..)}; b = {(k c..c+1, n g), (k c+8.., n g)}; d = {(g, c),
// (g, c+1), (g+8, c), (g+8, c+1)}.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A fragments (16 rows x 64 dims, 4 k-steps) of rows r0 = row0 + g and
// r0 + 8 of one (b, h) slice straight from device memory; rows >= N are
// zeros.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4],
                                             const bf16* base, long long sn,
                                             int row0, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int d = ks * 16 + c;
    f[ks][0] = r0 < N ? ld_u32(base + r0 * sn + d) : 0u;
    f[ks][1] = r1 < N ? ld_u32(base + r1 * sn + d) : 0u;
    f[ks][2] = r0 < N ? ld_u32(base + r0 * sn + d + 8) : 0u;
    f[ks][3] = r1 < N ? ld_u32(base + r1 * sn + d + 8) : 0u;
  }
}

// acc[8][4] (16 rows x 64 cols) += A (16 x 64, 4 k-steps of fragments) *
// T^T, where T is a [kTile][kPitch] tile whose rows are the product's
// columns (S = Q K^T with T = K; dP = dO V^T with T = V).
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[4];
      ldsm_x4(b, t + (nt * 8 + (lane & 7)) * kPitch + p * 32 +
                     (lane >> 3) * 8);
      mma16816(acc[nt], a[2 * p], b[0], b[1]);
      mma16816(acc[nt], a[2 * p + 1], b[2], b[3]);
    }
  }
}

// acc[8][4] (16 rows x 64 dims) += A (16 x 64 tile rows, 4 k-steps of
// fragments) * T, T a [kTile][kPitch] tile (O += P V; dQ += dS K; and
// with transposed A, dV += P^T dO, dK += dS^T Q).
__device__ __forceinline__ void mma_ab(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const bf16* t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           kPitch +
                       dp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * dp], a[kk], b[0], b[1]);
      mma16816(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// The accumulator tile [8][4] (16 rows x 64 cols, f32) as bf16 A
// fragments of a product over its 64 columns (4 k-steps).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
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
