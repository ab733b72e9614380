// Building blocks of the f32 Swin branch backward kernels (K1b and K2b in
// f32; in bf16 both run on sm90_gemm.cuh's TMA + wgmma GEMM and the vector
// row passes of swin_attn_sm90.cuh), sm_90a: a tiled f32 matrix product
// with split-K, the f32 LayerNorm forward and backward over token rows,
// row scaling, column sums and a fixed-order reduction of per-block partial
// sums (reduce_slots, which the bf16 passes share).
//
// Determinism: no atomics. Every weight, bias and LayerNorm gradient is
// summed by one block per slot (a split of the token axis) into its own
// partial buffer, and reduce_slots adds the slots in index order.
//
// Everything here is f32: every product runs f32 FMAs on the CUDA cores.
// No WMMA product is left; bf16 has its own code.
#pragma once

#include "swin_common.cuh"

namespace swin {

// ---------------------------------------------------------------------------
// C[m, n] = sum_k A(m, k) B(k, n), f32 accumulation, into an epilogue
// functor epi(m, n, split, value).
//   A(m, k) = A_KC ? A[m * lda + k] : A[k * lda + m]
//   B(k, n) = B_KC ? B[n * ldb + k] : B[k * ldb + n]
// blockIdx = (m tile, n tile, split of K); 64 x 64 tiles, 32 deep, a
// 4 x 4 FMA block a thread, the operands staged through shared memory.
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 32;  // f32 tiles
constexpr int kLdF = kBM + 4;                // f32 pitch of [k][row] tiles
constexpr int kSplitK = 64;  // a split's depth is a multiple of it

struct GemmShape {
  long long M, K, lda, ldb, kchunk;
  int N;
};

template <bool A_KC, bool B_KC, class Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    GemmShape g, Epi epi) {
  __shared__ float As[kBK * kLdF];
  __shared__ float Bs[kBK * kLdF];
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int z = blockIdx.z;
  const long long kb = static_cast<long long>(z) * g.kchunk;
  const long long ke = min(g.K, kb + g.kchunk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = kb; k0 < ke; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = A_KC ? e / kBK : e % kBM;
      const int kk = A_KC ? e % kBK : e / kBM;
      const long long m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < g.M && k < ke)
        v = A_KC ? A[m * g.lda + k] : A[k * g.lda + m];
      As[kk * kLdF + r] = v;
    }
#pragma unroll
    for (int it = 0; it < kBN * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = B_KC ? e / kBK : e % kBN;
      const int kk = B_KC ? e % kBK : e / kBN;
      const long long n = n0 + r, k = k0 + kk;
      float v = 0.f;
      if (n < g.N && k < ke)
        v = B_KC ? B[n * g.ldb + k] : B[k * g.ldb + n];
      Bs[kk * kLdF + r] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * kLdF + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * kLdF + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < g.M && n < g.N) epi(m, n, z, acc[i][j]);
    }
  }
}

// splits of the K (token) axis for a weight-gradient product: about 1024
// blocks of 64 x 64 in all, at least 256 tokens per split
inline int gemm_splits(long long M, long long N, long long K) {
  const long long tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  long long s = (1024 + tiles - 1) / tiles;
  s = s < (K + 255) / 256 ? s : (K + 255) / 256;
  return static_cast<int>(s < 1 ? 1 : s);
}

// depth per split: a whole number of kSplitK tokens
inline long long gemm_kchunk(long long K, int splits) {
  const long long c = (K + splits - 1) / splits;
  return (c + kSplitK - 1) / kSplitK * kSplitK;
}

// the number of splits a launch with `splits` requested really uses
inline int gemm_used_splits(long long K, int splits) {
  const long long c = gemm_kchunk(K, splits);
  return static_cast<int>((K + c - 1) / c);
}

template <bool A_KC, bool B_KC, class Epi>
int gemm(const float* A, const float* B, long long M, int N, long long K,
         long long lda, long long ldb, int splits, Epi epi,
         cudaStream_t stream) {
  GemmShape g{M, K, lda, ldb, gemm_kchunk(K, splits), N};
  const unsigned nz = static_cast<unsigned>(gemm_used_splits(K, splits));
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((N + kBN - 1) / kBN), nz);
  gemm_f32_kernel<A_KC, B_KC, Epi><<<grid, kThreads, 0, stream>>>(
      A, B, g, epi);
  return static_cast<int>(cudaGetLastError());
}

// epilogues -----------------------------------------------------------------
struct EpiF32 {  // out[m, n] = v
  float* out;
  long long ld;
  __device__ void operator()(long long m, int n, int, float v) const {
    out[m * ld + n] = v;
  }
};

struct EpiPartial {  // part[split][m][n] = v
  float* part;
  long long M;
  int N;
  __device__ void operator()(long long m, int n, int z, float v) const {
    part[(static_cast<long long>(z) * M + m) * N + n] = v;
  }
};

// row-wise kernels -----------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLane = 32;  // channels per lane: C <= 1024

// LayerNorm statistics and output, one warp per row
__global__ void __launch_bounds__(kThreads)
    ln_rows(const float* __restrict__ x, const float* __restrict__ ln_s,
            const float* __restrict__ ln_b, float* __restrict__ xn,
            float* __restrict__ mu, float* __restrict__ rstd,
            long long rows, int C) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= rows) return;
  const float* xr = x + t * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = xr[c];
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float m = s / C;
  const float r = 1.f / sqrtf(s2 / C - m * m + kLnEps);
  if (lane == 0) {
    mu[t] = m;
    rstd[t] = r;
  }
  for (int c = lane; c < C; c += 32)
    xn[t * C + c] = (xr[c] - m) * r * ln_s[c] + ln_b[c];
}

// out = dy * dp[row / hw] (dp null = 1)
__global__ void scale_rows(const float* __restrict__ dy,
                           const float* __restrict__ dp,
                           float* __restrict__ out, long long n, int C,
                           long long hw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const float s = dp ? dp[(i / C) / hw] : 1.f;
  out[i] = dy[i] * s;
}

// part[chunk][n] = sum over the chunk's rows of a[row][n], rows in order
__global__ void colsum_partial(const float* __restrict__ a,
                               float* __restrict__ part, long long rows,
                               int N, long long rows_per_chunk) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += a[r * N + n];
  part[static_cast<long long>(blockIdx.y) * N + n] = s;
}

// out[i] = sum over slots s = 0, 1, ... of part[s][i], in that order (the
// loads run ahead of the sum). Tag: the launching pass, in the name only.
template <class Tag>
__global__ void reduce_slots(const float* __restrict__ part,
                             float* __restrict__ out, int slots,
                             long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < slots; ++k) s += part[k * n + i];
  out[i] = s;
}

// LayerNorm pullback, one warp per row; the block's rows add their dLN
// scale / bias terms into per-warp shared rows, which are then added in
// warp order into the block's partial slot:
//   dxh = dxn * s; dxf = (dxh - mean(dxh) - xh * mean(dxh * xh)) * rstd
//   dx = dxf + dy          (the identity path)
__global__ void __launch_bounds__(kThreads)
    ln_bwd(const float* __restrict__ x, const float* __restrict__ dy,
           const float* __restrict__ dxn, const float* __restrict__ mu,
           const float* __restrict__ rstd, const float* __restrict__ ln_s,
           float* __restrict__ dx, float* __restrict__ dg_part,
           float* __restrict__ db_part, long long rows, int C,
           long long rows_per_block) {
  extern __shared__ float acc_sh[];  // [kWarps][2][C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sg = acc_sh + warp * 2 * C;
  float* sb = sg + C;
  for (int c = lane; c < C; c += 32) sg[c] = sb[c] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (long long t = r0 + warp; t < r1; t += kWarps) {
    const float m = mu[t], rs = rstd[t];
    float xh[kMaxLane], dxh[kMaxLane];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i) {
      const int c = lane + 32 * i;
      xh[i] = dxh[i] = 0.f;
      if (c < C) {
        xh[i] = (x[t * C + c] - m) * rs;
        const float g = dxn[t * C + c];
        sg[c] += g * xh[i];
        sb[c] += g;
        dxh[i] = g * ln_s[c];
        s1 += dxh[i];
        s2 += dxh[i] * xh[i];
      }
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float dxf = (dxh[i] - s1 - xh[i] * s2) * rs;
        dx[t * C + c] = dxf + dy[t * C + c];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float g = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      g += acc_sh[w * 2 * C + c];
      b += acc_sh[w * 2 * C + C + c];
    }
    dg_part[static_cast<long long>(blockIdx.x) * C + c] = g;
    db_part[static_cast<long long>(blockIdx.x) * C + c] = b;
  }
}

// slots of the row-wise partial sums: at most 256, at least 512 rows each
// for column sums and 64 for the LayerNorm pullback
inline long long rows_per_slot(long long rows, long long least) {
  const long long r = (rows + 255) / 256;
  return r > least ? r : least;
}

inline int slots_for(long long rows, long long per) {
  return static_cast<int>((rows + per - 1) / per);
}

// workspace carving: 256-byte aligned pieces of one device buffer (a null
// base only measures)
struct Carver {
  char* base;
  size_t off = 0;
  template <typename U>
  U* take(size_t n) {
    off = (off + 255) / 256 * 256;
    U* p = base ? reinterpret_cast<U*>(base + off) : nullptr;
    off += n * sizeof(U);
    return p;
  }
};

template <class Tag = void>
int launch_reduce(const float* part, float* out, int slots, long long n,
                  cudaStream_t stream) {
  reduce_slots<Tag><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(part, out, slots, n);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_colsum(const float* a, float* part, float* out,
                         long long rows, int N, cudaStream_t stream) {
  const long long per = rows_per_slot(rows, 512);
  const int slots = slots_for(rows, per);
  colsum_partial<<<dim3((N + kThreads - 1) / kThreads, slots), kThreads, 0,
                   stream>>>(a, part, rows, N, per);
  const int err = static_cast<int>(cudaGetLastError());
  return err ? err : launch_reduce(part, out, slots, N, stream);
}

inline size_t colsum_part_floats(long long rows, int N) {
  return static_cast<size_t>(slots_for(rows, rows_per_slot(rows, 512))) * N;
}

inline size_t ln_bwd_part_floats(long long rows, int C) {
  return static_cast<size_t>(slots_for(rows, rows_per_slot(rows, 64))) * C;
}

inline int launch_ln_bwd(const float* x, const float* dy, const float* dxn,
                         const float* mu, const float* rstd,
                         const float* ln_s, float* dx, float* dg_part,
                         float* db_part, float* dg, float* db,
                         long long rows, int C, cudaStream_t stream) {
  const long long per = rows_per_slot(rows, 64);
  const int slots = slots_for(rows, per);
  const int smem = kWarps * 2 * C * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      ln_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  ln_bwd<<<slots, kThreads, smem, stream>>>(
      x, dy, dxn, mu, rstd, ln_s, dx, dg_part, db_part, rows, C, per);
  int err = static_cast<int>(cudaGetLastError());
  if (!err) err = launch_reduce(dg_part, dg, slots, C, stream);
  if (!err) err = launch_reduce(db_part, db, slots, C, stream);
  return err;
}

inline int launch_ln_rows(const float* x, const float* ln_s,
                          const float* ln_b, float* xn, float* mu,
                          float* rstd, long long rows, int C,
                          cudaStream_t stream) {
  ln_rows<<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
            stream>>>(x, ln_s, ln_b, xn, mu, rstd, rows, C);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_scale_rows(const float* dy, const float* dp, float* out,
                             long long rows, int C, long long hw,
                             cudaStream_t stream) {
  const long long n = rows * C;
  scale_rows<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
               kThreads, 0, stream>>>(dy, dp, out, n, C, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin
