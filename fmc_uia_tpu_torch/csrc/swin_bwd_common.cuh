// Building blocks of the Swin branch backward kernels (K2b, and K1b in f32;
// the bf16 K1b runs on sm90_gemm.cuh and swin_attn_sm90.cuh), sm_90a:
// a tiled matrix product with split-K, the f32 LayerNorm forward and
// backward over token rows, row scaling, column sums and a fixed-order
// reduction of per-block partial sums.
//
// Determinism: no atomics. Every weight, bias and LayerNorm gradient is
// summed by one block per slot (a split of the token axis) into its own
// partial buffer, and reduce_slots adds the slots in index order.
//
// Types: T is the compute dtype of the activations (float or bf16). In bf16
// mode every product operand is a bf16 value, as in the JAX pullback; the
// product kernel then runs on the tensor cores (WMMA m16n16k16, f32
// accumulate). In f32 mode it runs f32 FMAs on the CUDA cores.
//
// Not done yet: TMA/cp.async and wgmma (the bf16 product stages its tiles
// through registers), a persistent schedule, fusing the passes.
#pragma once

#include <mma.h>

#include <type_traits>

#include "swin_common.cuh"

namespace swin {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to the compute dtype T, keep computing in f32
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// ---------------------------------------------------------------------------
// C[m, n] = sum_k A(m, k) B(k, n), f32 accumulation, into an epilogue
// functor epi(m, n, split, value).
//   A(m, k) = A_KC ? A[m * lda + k] : A[k * lda + m]
//   B(k, n) = B_KC ? B[n * ldb + k] : B[k * ldb + n]
// blockIdx = (m tile, n tile, split of K). Operands are staged through
// shared memory, converted (and in bf16 mode rounded) on the way; f32
// weights are rounded to bf16 there, as the JAX pullback casts them.
//
// bf16 (gemm_tc_kernel): 128 x 64 tiles, 64 deep per stage, eight warps
// of 32 x 32 (2 x 2 WMMA tiles); 16-byte global loads, the next stage's
// loads in flight during the current stage's products. f32
// (gemm_f32_kernel): 64 x 64 tiles, 32 deep, a 4 x 4 FMA block a thread.
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 32;  // f32 tiles
constexpr int kLdF = kBM + 4;                // f32 pitch of [k][row] tiles
constexpr int kTM = 128, kTN = 64, kTK = 64; // bf16 tiles
constexpr int kLdO = kTN + 4;                // f32 pitch of the result tile
// operand tiles: at most max(kTM * (kTK + 8), kTK * (kTM + 8)) + the same
// for kTN bf16 elements ([row][k] or [k][row], 8 elements of padding)
constexpr int kSmemAB = (kTM + kTN) * (kTK + 8) * 2;
constexpr int kSmemO = kTM * kLdO * 4;
constexpr int kSmemTc = kSmemAB > kSmemO ? kSmemAB : kSmemO;

struct GemmShape {
  long long M, K, lda, ldb, kchunk;
  int N;
};

template <typename TA, typename TB, bool A_KC, bool B_KC, class Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
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
        v = to_f(A_KC ? A[m * g.lda + k] : A[k * g.lda + m]);
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
        v = to_f(B_KC ? B[n * g.ldb + k] : B[k * g.ldb + n]);
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

// One operand's ROWS x kTK tile of the bf16 product, staged through
// registers as f32: 16-byte vectors along the source's contiguous axis (k
// when KC, the rows otherwise), element loads with zero fill at a ragged
// edge. Shared memory keeps the source's orientation ([row][k] when KC,
// [k][row] otherwise, pitch LD), so every store is a vector store and the
// WMMA fragment takes the matching layout.
template <typename TS, bool KC, int ROWS>
struct TileStage {
  static constexpr int VW = 16 / static_cast<int>(sizeof(TS));
  static constexpr int NV = ROWS * kTK / VW / kThreads;
  static constexpr int LD = KC ? kTK + 8 : ROWS + 8;
  static constexpr int kElems = KC ? ROWS * LD : kTK * LD;
  float v[NV][VW];

  __device__ static void coords(int e, int& r, int& kk) {
    if (KC) {
      r = e / (kTK / VW);
      kk = (e % (kTK / VW)) * VW;
    } else {
      kk = e / (ROWS / VW);
      r = (e % (ROWS / VW)) * VW;
    }
  }

  __device__ void load(const TS* __restrict__ src, long long ld,
                       long long r0, long long rows, long long k0,
                       long long ke, int tid) {
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      int r, kk;
      coords(tid + it * kThreads, r, kk);
      const long long gr = r0 + r, gk = k0 + kk;
      const bool full = KC ? (gr < rows && gk + VW <= ke)
                           : (gk < ke && gr + VW <= rows);
      const TS* p = KC ? src + gr * ld + gk : src + gk * ld + gr;
      if (full) {
        if constexpr (VW == 8) {
          unpack8(ld16(p), v[it]);
        } else {
          const float4 f = ldf4(reinterpret_cast<const float*>(p));
          v[it][0] = f.x;
          v[it][1] = f.y;
          v[it][2] = f.z;
          v[it][3] = f.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const bool in = KC ? (gr < rows && gk + j < ke)
                             : (gk < ke && gr + j < rows);
          v[it][j] = in ? to_f(p[j]) : 0.f;
        }
      }
    }
  }

  __device__ void store(bf16* tile, int tid) const {
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      int r, kk;
      coords(tid + it * kThreads, r, kk);
      bf16* dst = KC ? tile + r * LD + kk : tile + kk * LD + r;
      if constexpr (VW == 8) {
        store8(dst, v[it]);
      } else {
        store4(dst, make_float4(v[it][0], v[it][1], v[it][2], v[it][3]));
      }
    }
  }
};

template <typename TA, typename TB, bool A_KC, bool B_KC, class Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_tc_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                   GemmShape g, Epi epi) {
  using SA = TileStage<TA, A_KC, kTM>;
  using SB = TileStage<TB, B_KC, kTN>;
  // A(m, k): [m][k] is row-major, [k][m] column-major; B(k, n): [n][k] is
  // column-major, [k][n] row-major
  using LayA = typename std::conditional<A_KC, wm::row_major,
                                         wm::col_major>::type;
  using LayB = typename std::conditional<B_KC, wm::col_major,
                                         wm::row_major>::type;
  __shared__ __align__(128) unsigned char smem[kSmemTc];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + SA::kElems;
  float* Cs = reinterpret_cast<float*>(smem);  // [kTM][kLdO], at the end
  const long long m0 = static_cast<long long>(blockIdx.x) * kTM;
  const int n0 = blockIdx.y * kTN;
  const int z = blockIdx.z;
  const long long kb = static_cast<long long>(z) * g.kchunk;
  const long long ke = min(g.K, kb + g.kchunk);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp % 4, wc = warp / 4;  // the warp's 32 x 32 block

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

  SA sa;
  SB sb;
  if (kb < ke) {
    sa.load(A, g.lda, m0, g.M, kb, ke, tid);
    sb.load(B, g.ldb, n0, g.N, kb, ke, tid);
  }
  for (long long k0 = kb; k0 < ke; k0 += kTK) {
    sa.store(As, tid);
    sb.store(Bs, tid);
    __syncthreads();
    if (k0 + kTK < ke) {  // the next stage's loads, in flight meanwhile
      sa.load(A, g.lda, m0, g.M, k0 + kTK, ke, tid);
      sb.load(B, g.ldb, n0, g.N, k0 + kTK, ke, tid);
    }
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, LayA> fa[2];
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, LayB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wr * 32 + i * 16;
        wm::load_matrix_sync(fa[i], A_KC ? As + row * SA::LD + kk
                                         : As + kk * SA::LD + row,
                             SA::LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wc * 32 + j * 16;
        wm::load_matrix_sync(fb[j], B_KC ? Bs + col * SB::LD + kk
                                         : Bs + kk * SB::LD + col,
                             SB::LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wm::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(Cs + (wr * 32 + i * 16) * kLdO + wc * 32 + j * 16,
                            acc[i][j], kLdO, wm::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kTM * kTN; i += kThreads) {
    const int r = i / kTN, c = i % kTN;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m < g.M && n < g.N) epi(m, n, z, Cs[r * kLdO + c]);
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

// depth per split: a whole number of bf16 stages (and of f32 stages)
inline long long gemm_kchunk(long long K, int splits) {
  const long long c = (K + splits - 1) / splits;
  return (c + kTK - 1) / kTK * kTK;
}

// the number of splits a launch with `splits` requested really uses
inline int gemm_used_splits(long long K, int splits) {
  const long long c = gemm_kchunk(K, splits);
  return static_cast<int>((K + c - 1) / c);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// T: the activation type of A; TB: B's element type. bf16 mode <=> T is
// bf16 <=> tensor cores; it reads 16-byte vectors, so both operands need
// 16-byte aligned bases and rows.
template <typename T, typename TB, bool A_KC, bool B_KC, class Epi>
int gemm(const T* A, const TB* B, long long M, int N, long long K,
         long long lda, long long ldb, int splits, Epi epi,
         cudaStream_t stream) {
  GemmShape g{M, K, lda, ldb, gemm_kchunk(K, splits), N};
  const unsigned nz = static_cast<unsigned>(gemm_used_splits(K, splits));
  if constexpr (std::is_same<T, bf16>::value) {
    if (!aligned16(A) || !aligned16(B) || (lda * sizeof(T)) % 16 ||
        (ldb * sizeof(TB)) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const dim3 grid(static_cast<unsigned>((M + kTM - 1) / kTM),
                    static_cast<unsigned>((N + kTN - 1) / kTN), nz);
    gemm_tc_kernel<T, TB, A_KC, B_KC, Epi><<<grid, kThreads, 0, stream>>>(
        A, B, g, epi);
  } else {
    const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                    static_cast<unsigned>((N + kBN - 1) / kBN), nz);
    gemm_f32_kernel<T, TB, A_KC, B_KC, Epi><<<grid, kThreads, 0, stream>>>(
        A, B, g, epi);
  }
  return static_cast<int>(cudaGetLastError());
}

// epilogues -----------------------------------------------------------------
template <typename T>
struct EpiStore {  // out[m, n] = round_T(v (+ bias[n]))
  T* out;
  long long ld;
  const float* bias;
  __device__ void operator()(long long m, int n, int, float v) const {
    if (bias) v += bias[n];
    out[m * ld + n] = from_f<T>(v);
  }
};

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

// f32 LayerNorm statistics and the rounded LN output, one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_rows(const T* __restrict__ x, const float* __restrict__ ln_s,
            const float* __restrict__ ln_b, T* __restrict__ xn,
            float* __restrict__ mu, float* __restrict__ rstd,
            long long rows, int C) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= rows) return;
  const T* xr = x + t * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(xr[c]);
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
    xn[t * C + c] = from_f<T>((to_f(xr[c]) - m) * r * ln_s[c] + ln_b[c]);
}

// out = round_T(dy * dp[row / hw]), dp unrounded f32 (null = 1)
template <typename T>
__global__ void scale_rows(const T* __restrict__ dy,
                           const float* __restrict__ dp, T* __restrict__ out,
                           long long n, int C, long long hw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const float s = dp ? dp[(i / C) / hw] : 1.f;
  out[i] = from_f<T>(to_f(dy[i]) * s);
}

// part[chunk][n] = sum over the chunk's rows of a[row][n], rows in order
template <typename TIn>
__global__ void colsum_partial(const TIn* __restrict__ a,
                               float* __restrict__ part, long long rows,
                               int N, long long rows_per_chunk) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += to_f(a[r * N + n]);
  part[static_cast<long long>(blockIdx.y) * N + n] = s;
}

// out[i] = sum over slots s = 0, 1, ... of part[s][i]
__global__ void reduce_slots(const float* __restrict__ part,
                             float* __restrict__ out, int slots,
                             long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slots; ++k) s += part[k * n + i];
  out[i] = s;
}

// LayerNorm pullback, one warp per row; the block's rows add their dLN
// scale / bias terms into per-warp shared rows, which are then added in
// warp order into the block's partial slot:
//   dxh = dxn * s; dxf = (dxh - mean(dxh) - xh * mean(dxh * xh)) * rstd
//   dx = round_T(round_T(dxf) + dy)          (the identity path)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd(const T* __restrict__ x, const T* __restrict__ dy,
           const float* __restrict__ dxn, const float* __restrict__ mu,
           const float* __restrict__ rstd, const float* __restrict__ ln_s,
           T* __restrict__ dx, float* __restrict__ dg_part,
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
        xh[i] = (to_f(x[t * C + c]) - m) * rs;
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
        dx[t * C + c] = from_f<T>(rnd<T>(dxf) + to_f(dy[t * C + c]));
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

inline int launch_reduce(const float* part, float* out, int slots,
                         long long n, cudaStream_t stream) {
  reduce_slots<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                 kThreads, 0, stream>>>(part, out, slots, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_colsum(const TIn* a, float* part, float* out, long long rows,
                  int N, cudaStream_t stream) {
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

template <typename T>
int launch_ln_bwd(const T* x, const T* dy, const float* dxn, const float* mu,
                  const float* rstd, const float* ln_s, T* dx,
                  float* dg_part, float* db_part, float* dg, float* db,
                  long long rows, int C, cudaStream_t stream) {
  const long long per = rows_per_slot(rows, 64);
  const int slots = slots_for(rows, per);
  const int smem = kWarps * 2 * C * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      ln_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  ln_bwd<T><<<slots, kThreads, smem, stream>>>(
      x, dy, dxn, mu, rstd, ln_s, dx, dg_part, db_part, rows, C, per);
  int err = static_cast<int>(cudaGetLastError());
  if (!err) err = launch_reduce(dg_part, dg, slots, C, stream);
  if (!err) err = launch_reduce(db_part, db, slots, C, stream);
  return err;
}

template <typename T>
int launch_ln_rows(const T* x, const float* ln_s, const float* ln_b, T* xn,
                   float* mu, float* rstd, long long rows, int C,
                   cudaStream_t stream) {
  ln_rows<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
               kThreads, 0, stream>>>(x, ln_s, ln_b, xn, mu, rstd, rows, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scale_rows(const T* dy, const float* dp, T* out, long long rows,
                      int C, long long hw, cudaStream_t stream) {
  const long long n = rows * C;
  scale_rows<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  kThreads, 0, stream>>>(dy, dp, out, n, C, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin
