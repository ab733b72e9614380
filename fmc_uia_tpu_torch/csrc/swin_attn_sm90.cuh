// Pieces shared by the bf16 Swin branch kernels, attention (K1f,
// swin_attn_fwd.cu; K1b, swin_attn_bwd.cu) and MLP (K2f, swin_mlp_fwd.cu;
// K2b, swin_mlp_bwd.cu): the bf16 weight copies that TMA reads, the qkv
// epilogue, the row-wise passes (LayerNorm and its pullback, dy * dp,
// column sums) in 8- and 16-byte vectors, and the window geometry of a
// block. The row passes compute what swin_bwd_common.cuh's scalar ones
// compute; those stay for the f32 kernels.
//
// Head groups. The window kernels take G = 64 / dh heads at a time (dh 16
// or 32), so that a group's q, k or v is one 64-channel (128-byte) TMA box
// of a token row: columns p C + 64 g .. + 63 of qkv (p = 0, 1, 2 for q, k,
// v), or rows p C + 64 g .. of Wqkv, in Wqkv's own order. Three such boxes
// stacked in shared memory have the 128-byte-swizzle layout of one
// 192-row box, so K1f's [q | k | v] of a group is one m64n192 product.
//
// The kernels several passes launch take the pass as a tag (K1f, K1b, K2f,
// K2b), so a profile tells their launches apart.
#pragma once

#include "sm90_gemm.cuh"
#include "swin_bwd_common.cuh"

namespace swin {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kWinRows = 64;  // a window of at most 8 x 8 tokens: one m64

struct K1f {};  // the tags of the forward and the backward passes
struct K1b {};
struct K2f {};
struct K2b {};

// The widths the bf16 MLP kernels take: C % 32 == 0 up to the widest the
// JAX package's kernel fuses, whose weights (12 C 4C bytes) fit 0.72 of
// its 64 MiB budget (ops/swin_block.py MLP_MAX_C, mlp_fits_jax_kernel).
// Up to 256 each C has its own instance; above, C comes in at run time
// (K2f's two products, K2b's mlp_dual_wide_sm90).
constexpr int kMlpMaxC = 1003;
inline bool mlp_bf16_c(int C) {
  return C % 32 == 0 && C >= 32 && C <= kMlpMaxC;
}

// tanh(u) = 1 - 2 / (1 + e^(2u)) on the special-function unit (ex2 and
// rcp): within a few 1e-7 of tanhf in a handful of instructions against
// its twenty, which the GELU epilogues of K2 above C = 256 run once or
// twice an element of the 4C-wide hidden activation (the result is
// rounded to bf16 before any product reads it)
__device__ __forceinline__ float tanh_fast(float u) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * u));
}

#define SWIN_TRY(expr)          \
  do {                          \
    const int err_ = (expr);    \
    if (err_) return err_;      \
  } while (0)

// reductions over the 4 threads of an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two f32 weights, a (na elements) and b (nb), rounded to bf16 into ab and
// bb, one thread per 4 elements (na, nb multiples of 4): Wqkv and Wproj of
// K1, W1 and W2 of K2.
template <class Pass>
__global__ void cast_weights(const float* __restrict__ a,
                             const float* __restrict__ b,
                             bf16* __restrict__ ab, bf16* __restrict__ bb,
                             long long na, long long nb) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= na + nb) return;
  if (i < na)
    store4(ab + i, ldf4(a + i));
  else
    store4(bb + i - na, ldf4(b + i - na));
}

template <class Pass>
int launch_cast_weights(const float* a, long long na, const float* b,
                        long long nb, bf16* ab, bf16* bb, cudaStream_t s) {
  const long long n4 = (na + nb) / 4;
  cast_weights<Pass><<<static_cast<unsigned>((n4 + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(a, b, ab, bb, na, nb);
  return static_cast<int>(cudaGetLastError());
}

// qkv = round(acc + b); q also times round(scale), rounded: the recompute
// of the forward's qkv (K1b), rows of 3C in Wqkv's order
struct EpiQkvBf16 {
  bf16* out;
  const float* b;
  int C;
  float scale;  // dh^-1/2, rounded to bf16 here
  __device__ void operator()(int m, int n, int, const float (&v)[8]) const {
    // C % 8 == 0: the 8 columns are all q or none of them
    const float sc = n < C ? round_bf16(scale) : 1.f;
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = round_bf16(v[j] + b[n + j]) * sc;
    store_bf16x8(out + static_cast<long long>(m) * 3 * C + n, w);
  }
};

// ---- row-wise passes of the bf16 K1b and K2b, in 8- and 16-byte vectors ----
// out = round(dy * dp[row / hw]) (dp unrounded f32, null = 1): 8 elements
// a thread (C % 8 == 0)
template <class Pass>
__global__ void scale_rows_bf16(const bf16* __restrict__ dy,
                                const float* __restrict__ dp,
                                bf16* __restrict__ out, long long n8, int C,
                                long long hw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n8) return;
  const float sc = dp ? dp[(i * 8 / C) / hw] : 1.f;
  float f[8];
  unpack8(ld16(dy + i * 8), f);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] *= sc;
  store8(out + i * 8, f);
}

// part[chunk][n] = sum over the chunk's rows of a[row][n]: a block takes
// 64 columns (8 threads of 8) x 32 row lanes; lane y adds rows y, y + 32,
// .. of the chunk in order, then the 32 lane sums are added in lane order
// (N % 8 == 0).
template <class Pass>
__global__ void __launch_bounds__(kThreads)
    colsum_bf16(const bf16* __restrict__ a, float* __restrict__ part,
                long long rows, int N, long long rows_per_chunk) {
  __shared__ float sh[32][64 + 1];
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int n = blockIdx.x * 64 + tx * 8;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n < N)
    for (long long r = r0 + ty; r < r1; r += 32) {
      float f[8];
      unpack8(ld16(a + r * N + n), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] += f[j];
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) sh[ty][tx * 8 + j] = s[j];
  __syncthreads();
  const int c = blockIdx.x * 64 + threadIdx.x;
  if (threadIdx.x < 64 && c < N) {
    float t = 0.f;
    for (int y = 0; y < 32; ++y) t += sh[y][threadIdx.x];
    part[static_cast<long long>(blockIdx.y) * N + c] = t;
  }
}

template <class Pass>
int launch_scale_rows_bf16(const bf16* dy, const float* dp, bf16* out,
                           long long rows, int C, long long hw,
                           cudaStream_t s) {
  const long long n8 = rows * C / 8;
  scale_rows_bf16<Pass><<<static_cast<unsigned>((n8 + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, s>>>(dy, dp, out, n8, C, hw);
  return static_cast<int>(cudaGetLastError());
}

template <class Pass>
int launch_colsum_bf16(const bf16* a, float* part, float* out,
                       long long rows, int N, cudaStream_t s) {
  const long long per = rows_per_slot(rows, 512);
  const int slots = slots_for(rows, per);
  colsum_bf16<Pass><<<dim3((N + 63) / 64, slots), kThreads, 0, s>>>(
      a, part, rows, N, per);
  const int err = static_cast<int>(cudaGetLastError());
  return err ? err : launch_reduce<Pass>(part, out, slots, N, s);
}

// ln_rows in vectors: f32 LayerNorm statistics (flax's fast variance;
// mu and rstd written unless null) and xn rounded to bf16, one warp per
// row, 4 channels a lane at 4 (lane + 32 k), k < CPL.
template <class Pass, int CPL>
__global__ void __launch_bounds__(kThreads)
    ln_rows_bf16(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, bf16* __restrict__ xn,
                 float* __restrict__ mu, float* __restrict__ rstd,
                 long long rows, int C) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= rows) return;
  float v[CPL][4];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = 4 * (lane + 32 * k);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[k][j] = 0.f;
    if (c < C) {
      const uint2 xv = __ldg(reinterpret_cast<const uint2*>(x + t * C + c));
      const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const float2 a = __bfloat1622float2(xb[0]);
      const float2 b = __bfloat1622float2(xb[1]);
      v[k][0] = a.x;
      v[k][1] = a.y;
      v[k][2] = b.x;
      v[k][3] = b.y;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s += v[k][j];
        s2 += v[k][j] * v[k][j];
      }
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float m = s / C;
  const float r = 1.f / sqrtf(s2 / C - m * m + kLnEps);
  if (lane == 0 && mu != nullptr) {  // K2f keeps no statistics
    mu[t] = m;
    rstd[t] = r;
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = 4 * (lane + 32 * k);
    if (c >= C) continue;
    const float4 sc = ldf4(ln_s + c), bi = ldf4(ln_b + c);
    store4(xn + t * C + c,
           make_float4((v[k][0] - m) * r * sc.x + bi.x,
                       (v[k][1] - m) * r * sc.y + bi.y,
                       (v[k][2] - m) * r * sc.z + bi.z,
                       (v[k][3] - m) * r * sc.w + bi.w));
  }
}

template <class Pass>
int launch_ln_rows_bf16(const bf16* x, const float* ln_s, const float* ln_b,
                        bf16* xn, float* mu, float* rstd, long long rows,
                        int C, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const int cpl = (C + 127) / 128;
  if (cpl <= 1)
    ln_rows_bf16<Pass, 1><<<blocks, kThreads, 0, s>>>(x, ln_s, ln_b, xn, mu,
                                                      rstd, rows, C);
  else if (cpl <= 2)
    ln_rows_bf16<Pass, 2><<<blocks, kThreads, 0, s>>>(x, ln_s, ln_b, xn, mu,
                                                      rstd, rows, C);
  else if (cpl <= 4)
    ln_rows_bf16<Pass, 4><<<blocks, kThreads, 0, s>>>(x, ln_s, ln_b, xn, mu,
                                                      rstd, rows, C);
  else
    ln_rows_bf16<Pass, 8><<<blocks, kThreads, 0, s>>>(x, ln_s, ln_b, xn, mu,
                                                      rstd, rows, C);
  return static_cast<int>(cudaGetLastError());
}

// LayerNorm pullback, one warp per row, 4 channels a lane (groups of 4 at
// 4 (lane + 32 k), k < CPL: C <= 128 CPL): ln_bwd's arithmetic, with each
// lane's dLN scale / bias sums over the block's rows kept in registers and
// then added in warp order into the block's slot, as ln_bwd adds them.
template <class Pass, int CPL>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const float* __restrict__ dxn, const float* __restrict__ mu,
                const float* __restrict__ rstd,
                const float* __restrict__ ln_s, bf16* __restrict__ dx,
                float* __restrict__ dg_part, float* __restrict__ db_part,
                long long rows, int C, long long rows_per_block) {
  extern __shared__ float acc_sh[];  // [kWarps][2][C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ga[CPL][4], ba[CPL][4];
#pragma unroll
  for (int k = 0; k < CPL; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) ga[k][j] = ba[k][j] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (long long t = r0 + warp; t < r1; t += kWarps) {
    const float m = mu[t], rs = rstd[t];
    float xh[CPL][4], dxh[CPL][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = 4 * (lane + 32 * k);
#pragma unroll
      for (int j = 0; j < 4; ++j) xh[k][j] = dxh[k][j] = 0.f;
      if (c < C) {
        const uint2 xv = __ldg(reinterpret_cast<const uint2*>(x + t * C + c));
        const __nv_bfloat162* xb =
            reinterpret_cast<const __nv_bfloat162*>(&xv);
        const float2 x01 = __bfloat1622float2(xb[0]);
        const float2 x23 = __bfloat1622float2(xb[1]);
        const float xs[4] = {x01.x, x01.y, x23.x, x23.y};
        const float4 g4 = ldf4(dxn + t * C + c), s4 = ldf4(ln_s + c);
        const float gs[4] = {g4.x, g4.y, g4.z, g4.w};
        const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xh[k][j] = (xs[j] - m) * rs;
          ga[k][j] += gs[j] * xh[k][j];
          ba[k][j] += gs[j];
          dxh[k][j] = gs[j] * ss[j];
          s1 += dxh[k][j];
          s2 += dxh[k][j] * xh[k][j];
        }
      }
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = 4 * (lane + 32 * k);
      if (c >= C) continue;
      const uint2 dv = __ldg(reinterpret_cast<const uint2*>(dy + t * C + c));
      const __nv_bfloat162* db = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const float2 d01 = __bfloat1622float2(db[0]);
      const float2 d23 = __bfloat1622float2(db[1]);
      const float ds[4] = {d01.x, d01.y, d23.x, d23.y};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = round_bf16((dxh[k][j] - s1 - xh[k][j] * s2) * rs) + ds[j];
      store4(dx + t * C + c, make_float4(o[0], o[1], o[2], o[3]));
    }
  }
  float* sg = acc_sh + warp * 2 * C;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = 4 * (lane + 32 * k);
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sg[c + j] = ga[k][j];
      sg[C + c + j] = ba[k][j];
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

template <class Pass, int CPL>
int launch_ln_bwd_rows_cpl(const bf16* x, const bf16* dy, const float* dxn,
                           const float* mu, const float* rstd,
                           const float* ln_s, bf16* dx, float* dg_part,
                           float* db_part, long long rows, int C,
                           long long per, int slots, int smem,
                           cudaStream_t s) {
  // the limit of the widest C this instance takes (C <= 128 CPL)
  static std::atomic<unsigned long long> smem_set{0};
  SWIN_TRY(smem_limit_once(
      smem_set, reinterpret_cast<const void*>(ln_bwd_rows<Pass, CPL>),
      kWarps * 2 * 128 * CPL * static_cast<int>(sizeof(float))));
  ln_bwd_rows<Pass, CPL><<<slots, kThreads, smem, s>>>(
      x, dy, dxn, mu, rstd, ln_s, dx, dg_part, db_part, rows, C, per);
  return static_cast<int>(cudaGetLastError());
}

// ln_bwd_rows into slots, then the slots reduced in order (as ln_bwd)
template <class Pass>
int launch_ln_bwd_rows(const bf16* x, const bf16* dy,
                              const float* dxn, const float* mu,
                              const float* rstd, const float* ln_s, bf16* dx,
                              float* dg_part, float* db_part, float* dg,
                              float* db, long long rows, int C,
                              cudaStream_t s) {
  const long long per = rows_per_slot(rows, 64);
  const int slots = slots_for(rows, per);
  const int smem = kWarps * 2 * C * static_cast<int>(sizeof(float));
  const int cpl = (C + 127) / 128;
  int err;
  if (cpl <= 1)
    err = launch_ln_bwd_rows_cpl<Pass, 1>(x, dy, dxn, mu, rstd, ln_s, dx,
                                          dg_part, db_part, rows, C, per,
                                          slots, smem, s);
  else if (cpl <= 2)
    err = launch_ln_bwd_rows_cpl<Pass, 2>(x, dy, dxn, mu, rstd, ln_s, dx,
                                          dg_part, db_part, rows, C, per,
                                          slots, smem, s);
  else if (cpl <= 4)
    err = launch_ln_bwd_rows_cpl<Pass, 4>(x, dy, dxn, mu, rstd, ln_s, dx,
                                          dg_part, db_part, rows, C, per,
                                          slots, smem, s);
  else
    err = launch_ln_bwd_rows_cpl<Pass, 8>(x, dy, dxn, mu, rstd, ln_s, dx,
                                          dg_part, db_part, rows, C, per,
                                          slots, smem, s);
  if (!err) err = launch_reduce<Pass>(dg_part, dg, slots, C, s);
  if (!err) err = launch_reduce<Pass>(db_part, db, slots, C, s);
  return err;
}

// Where a block's window lies: window w of the batch (b, then row-major
// over the image's windows), token t of the window at grid (y0 + t / ws,
// x0 + t % ws).
struct WindowAt {
  int b, wi, y0, x0;
  __device__ WindowAt(int w, int Hp, int Wp, int ws) {
    const int nWw = Wp / ws, nWin = (Hp / ws) * nWw;
    b = w / nWin;
    wi = w % nWin;
    y0 = (wi / nWw) * ws;
    x0 = (wi % nWw) * ws;
  }
  __device__ long long token(int t, int Hp, int Wp, int ws) const {
    return (static_cast<long long>(b) * Hp + y0 + t / ws) * Wp + x0 +
           t % ws;
  }
};

}  // namespace swin
