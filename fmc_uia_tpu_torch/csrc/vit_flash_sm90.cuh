// Hopper (sm_90a) pieces of the bf16 ViT global-attention kernels (K4f,
// K4b) beyond the shared ones of sm90_common.cuh: K4f's ping-pong of two
// consumer warpgroups, the 4-D TMA tile load of a [B, H, N, dh] view and
// its host-side tensor map.
//
// The tiles are rows of dh = 64 (128 bytes), in the 128-byte-swizzled
// layout sm90_common.cuh describes: Q, K are K-major in S = Q K^T; V, dO
// and Q are MN-major in P V and the backward's P^T dO and dS^T Q.
#pragma once

#include "sm90_common.cuh"
#include "vit_flash_common.cuh"

namespace vitfa {

constexpr int kRowBytes = kDh * 2;          // one bf16 row of a tile

// ---- ping-pong of two consumer warpgroups --------------------------------
// Named barriers 1 and 2 (0 is __syncthreads') make the two warpgroups of
// K4f issue their wgmma batches in turn, so that one's softmax runs while
// the other's products hold the tensor cores. Every batch is wrapped in
// issue_begin / issue_end; both warpgroups issue the same number of
// batches, and the second skips its last arrival, so every barrier phase
// completes.
struct PingPong {
  int wg;  // 0 or 1
  __device__ __forceinline__ void start() const {
    if (wg == 1) bar_arrive(1);
  }
  __device__ __forceinline__ void issue_begin() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(2 * 128)
                 : "memory");
  }
  __device__ __forceinline__ void issue_end(bool last) const {
    if (!(last && wg == 1)) bar_arrive(2 - wg);
  }
  static __device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * 128)
                 : "memory");
  }
};

// ---- TMA ------------------------------------------------------------------
// A box of the 4-D map (dh, n, h, b) at (0, n0, h, b); completion is
// counted in bytes on `bar`. Rows past the map's n extent arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int n0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(n0), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

constexpr uint64_t kDescRowStep16 = (16 * kRowBytes) >> 4;  // 16 rows

// The 4-D tiled map (dh, n, h, b) of a bf16 [B, H, N, dh] view with element
// strides l (dh contiguous), boxes of `rows` x dh, 128-byte swizzle, rows
// out of bounds filled with zeros. The same geometry as
// ops/vit_attention.py tma_layout, which checks it on the host first.
inline int make_map(CUtensorMap* m, const void* base, const Layout& l,
                    int B, int H, int N, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kDh),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(l.n) * 2,
                                 static_cast<cuuint64_t>(l.h) * 2,
                                 static_cast<cuuint64_t>(l.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kDh),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

}  // namespace vitfa
