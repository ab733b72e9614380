// Fused Swin MLP branch, forward, for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/swin_block_pallas.py
// fused_mlp_branch -> _fused_mlp_fwd_impl -> _mlp_fwd_kernel (_mlp_math):
// out = x + dp * fc2(gelu_tanh(fc1(LN2(x)))) on tokens x [T, C].
//
// Design. One block per tile of 64 tokens. The f32 LN runs into shared
// memory, the fc2 accumulator y [64, C] stays on chip in f32, and the 4C
// hidden width is streamed in chunks of 32 units: h = gelu_tanh(xn @
// W1[chunk]^T + b1[chunk]) (rounded), then y += h @ W2[:, chunk]^T. The
// 4C-wide hidden activation never reaches device memory. Tokens need not
// stay within one sample: dp is read per token row from a [B] vector, so
// the ragged last tile is simply masked (the TPU version's fallback for
// "no tile fits" has no counterpart).
//
//   mlp_fwd: f32 FMAs on the CUDA cores, y in shared memory
//     (203 KB at C = 256, the largest width the Swin block sends here).
//   mlp_fwd_tc: bf16 operands on the tensor cores (WMMA), y in registers
//     (84 KB of shared memory at C = 256).
//
// What bounds it: 16*T*C^2 operations on 2*T*C*sizeof(T) bytes, so
// operations. Neither version yet overlaps the weight-chunk loads with the
// products (no cp.async/TMA pipeline) or uses wgmma; each block re-reads
// all of W1 and W2 from L2.
//
// Rounding points (as _mlp_math): xn after the f32 LN, h after the
// tanh-GELU of the f32 fc1 + b1, y after the fc2 bias, dp * y, and the
// residual sum.

#include <mma.h>

#include "swin_common.cuh"

namespace swin {

constexpr int kTM = 64;    // tokens per block
constexpr int kHC = 32;    // hidden units per chunk
constexpr int kLdT = 65;   // pitch of k-major token tiles
constexpr int kLdW1 = 33;  // pitch of the W1 chunk (k-major)

struct MlpArgs {
  const void* x;
  void* out;
  const float* ln_s;
  const float* ln_b;
  const float* w1;  // [Ch, C] (out, in)
  const float* b1;  // [Ch]
  const float* w2;  // [C, Ch] (out, in)
  const float* b2;  // [C]
  const float* dp;  // [B] drop-path scale, or null (= 1)
  long long T;      // tokens
  int C, Ch, hw;    // hw = tokens per sample
};

__host__ __device__ inline size_t mlp_smem_floats(int C) {
  return 2 * kTM                       // mu, rstd
         + static_cast<size_t>(C) * kLdT   // xn, k-major
         + static_cast<size_t>(kTM) * (C + 1)  // y accumulator
         + static_cast<size_t>(C) * kLdW1      // W1 chunk, k-major
         + static_cast<size_t>(kHC) * (C + 1)  // W2 chunk, k-major
         + static_cast<size_t>(kHC) * kLdT;    // h chunk, k-major
}

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True)
  const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
  return v * (0.5f * (1.f + tanhf(inner)));
}

__global__ void __launch_bounds__(kThreads) mlp_fwd(MlpArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, Ch = a.Ch, ldy = C + 1;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTM;
  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;

  float* mu = smem;
  float* rstd = mu + kTM;
  float* xnT = rstd + kTM;                 // [C][kLdT]
  float* y = xnT + C * kLdT;               // [kTM][ldy]
  float* w1T = y + kTM * ldy;              // [C][kLdW1]
  float* w2T = w1T + C * kLdW1;            // [kHC][ldy]
  float* hT = w2T + kHC * ldy;             // [kHC][kLdT]

  // 1. f32 LN statistics, one warp per token
  for (int t = warp; t < kTM; t += kThreads / 32) {
    const long long tok = t0 + t;
    float s = 0.f, s2 = 0.f;
    if (tok < a.T) {
      for (int c = lane; c < C; c += 32) {
        const float v = x[static_cast<size_t>(tok) * C + c];
        s += v;
        s2 += v * v;
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float m = s / C;
      mu[t] = m;
      rstd[t] = 1.f / sqrtf(s2 / C - m * m + kLnEps);
    }
  }
  __syncthreads();

  // 2. xn into shared memory, k-major; y = 0
  for (int i = tid; i < kTM * C; i += kThreads) {
    const int t = i / C, c = i % C;
    const long long tok = t0 + t;
    float v = 0.f;
    if (tok < a.T) {
      const float xv = x[static_cast<size_t>(tok) * C + c];
      v = (xv - mu[t]) * rstd[t] * a.ln_s[c] + a.ln_b[c];
    }
    xnT[c * kLdT + t] = v;
    y[t * ldy + c] = 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < Ch; j0 += kHC) {
    // 3. stage W1 rows and W2 columns of this hidden chunk
    for (int i = tid; i < kHC * C; i += kThreads) {
      const int j = i / C, k = i % C;
      w1T[k * kLdW1 + j] =
          j0 + j < Ch ? a.w1[static_cast<size_t>(j0 + j) * C + k]
                      : 0.f;
    }
    for (int i = tid; i < kHC * C; i += kThreads) {
      const int n = i / kHC, j = i % kHC;
      w2T[j * ldy + n] =
          j0 + j < Ch ? a.w2[static_cast<size_t>(n) * Ch + j0 + j]
                      : 0.f;
    }
    __syncthreads();

    // 4. h = gelu_tanh(xn @ W1c^T + b1c): 64 x 32, K = C
    float hacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) hacc[i][0] = hacc[i][1] = 0.f;
    for (int k = 0; k < C; ++k) {
      float av[4], bv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xnT[k * kLdT + ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 2; ++q) bv[q] = w1T[k * kLdW1 + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) hacc[i][q] = fmaf(av[i], bv[q], hacc[i][q]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = tx + 16 * q;
      const bool live = j0 + j < Ch;
      const float bias = live ? a.b1[j0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hT[j * kLdT + ty + 16 * i] =
            live ? gelu_tanh(hacc[i][q] + bias) : 0.f;
    }
    __syncthreads();

    // 5. y += h @ W2c^T: 64 x C in column blocks of 64, K = 32
    for (int cb = 0; cb < C; cb += 64) {
      float yacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = cb + tx + 16 * q;
          yacc[i][q] = n < C ? y[(ty + 16 * i) * ldy + n] : 0.f;
        }
#pragma unroll 8
      for (int j = 0; j < kHC; ++j) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = hT[j * kLdT + ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = cb + tx + 16 * q;
          bv[q] = n < C ? w2T[j * ldy + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            yacc[i][q] = fmaf(av[i], bv[q], yacc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = cb + tx + 16 * q;
          if (n < C) y[(ty + 16 * i) * ldy + n] = yacc[i][q];
        }
    }
    __syncthreads();
  }

  // 6. out = x + dp * (y + b2)
  float* out = static_cast<float*>(a.out);
  for (int i = tid; i < kTM * C; i += kThreads) {
    const int t = i / C, c = i % C;
    const long long tok = t0 + t;
    if (tok >= a.T) continue;
    const float yv = y[t * ldy + c] + a.b2[c];
    const float dpv = a.dp ? a.dp[tok / a.hw] : 1.f;
    const size_t idx = static_cast<size_t>(tok) * C + c;
    out[idx] = x[idx] + dpv * yv;
  }
}

// ---------------------------------------------------------------------------
// bf16: the same block on the tensor cores (WMMA m16n16k16, bf16 operands,
// f32 accumulators). xn and the chunk operands are bf16 in shared memory;
// the y accumulator [64, C] lives in registers as WMMA fragments (warp
// (r, q) owns row tile r and column tiles q, q + 2, ...), so C % 32 == 0 and
// C <= 256 here.
// ---------------------------------------------------------------------------
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int kTcHC = 32;           // hidden units per chunk
constexpr int kLdHs = kTcHC + 8;    // bf16 pitch of h and of the W2 chunk
constexpr int kLdHf = kTcHC + 4;    // f32 pitch of the fc1 accumulators
constexpr int kMaxYTiles = 8;       // column tiles per warp at C = 256

__host__ __device__ inline size_t mlp_tc_smem_bytes(int C) {
  const size_t ldx = C + 8;
  return 2 * kTM * 4                        // mu, rstd
         + kTM * ldx * 2                    // xn (bf16)
         + kTcHC * ldx * 2                  // W1 chunk, col-major B
         + static_cast<size_t>(C) * kLdHs * 2  // W2 chunk, col-major B
         + kTM * kLdHf * 4                  // fc1 accumulators (f32)
         + kTM * kLdHs * 2;                 // h (bf16)
}

// two blocks per SM: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2) mlp_fwd_tc(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int C = a.C, Ch = a.Ch, ldx = C + 8, ldy = C + 4;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTM;
  const bf16* x = static_cast<const bf16*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp % 4, wq = warp / 4;
  const int nyt = C / 32;

  float* mu = reinterpret_cast<float*>(sm);
  float* rstd = mu + kTM;
  bf16* xn = reinterpret_cast<bf16*>(sm + 2 * kTM * 4);
  bf16* w1s = xn + kTM * ldx;
  bf16* w2s = w1s + kTcHC * ldx;
  float* hf = reinterpret_cast<float*>(w2s + C * kLdHs);
  bf16* hb = reinterpret_cast<bf16*>(hf + kTM * kLdHf);
  float* ybuf = reinterpret_cast<float*>(sm + 2 * kTM * 4);  // after the loop

  // 1. f32 LN statistics, one warp per token, 8 channels per load
  for (int t = warp; t < kTM; t += kThreads / 32) {
    const long long tok = t0 + t;
    float s = 0.f, s2 = 0.f;
    if (tok < a.T) {
      for (int c = lane * 8; c < C; c += 32 * 8) {
        float f[8];
        unpack8(ld16(x + static_cast<size_t>(tok) * C + c), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s += f[j];
          s2 += f[j] * f[j];
        }
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float m = s / C;
      mu[t] = m;
      rstd[t] = 1.f / sqrtf(s2 / C - m * m + kLnEps);
    }
  }
  __syncthreads();

  // 2. xn (rounded), row-major, in 16-byte vectors
  for (int i = tid; i < kTM * C / 8; i += kThreads) {
    const int t = i / (C / 8), c = (i % (C / 8)) * 8;
    const long long tok = t0 + t;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tok < a.T) {
      unpack8(ld16(x + static_cast<size_t>(tok) * C + c), f);
      const float4 s0 = ldf4(a.ln_s + c), s1 = ldf4(a.ln_s + c + 4);
      const float4 b0 = ldf4(a.ln_b + c), b1 = ldf4(a.ln_b + c + 4);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = (f[j] - mu[t]) * rstd[t] * sv[j] + bv[j];
    }
    store8(xn + t * ldx + c, f);
  }

  FragC yacc[kMaxYTiles];
#pragma unroll
  for (int q = 0; q < kMaxYTiles; ++q) wm::fill_fragment(yacc[q], 0.f);

  // each chunk operand is 8*C float4 vectors: C/32 per thread (<= 8)
  const int nv = C / 32;
  for (int j0 = 0; j0 < Ch; j0 += kTcHC) {
    // 3. W1 rows and W2 columns of this chunk, rounded to bf16, staged
    //    in groups of 4 vectors per thread (loads issued before stores)
    for (int g = 0; g < nv; g += 4) {
      float4 wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + (g + u) * kThreads;
        const int j = i / (C / 4), c = (i % (C / 4)) * 4;
        wv[u] = (g + u < nv && j0 + j < Ch)
                    ? ldf4(a.w1 + static_cast<size_t>(j0 + j) * C + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + (g + u) * kThreads;
        if (g + u < nv)
          store4(w1s + (i / (C / 4)) * ldx + (i % (C / 4)) * 4, wv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + (g + u) * kThreads;
        const int n = i / (kTcHC / 4), j = (i % (kTcHC / 4)) * 4;
        wv[u] = (g + u < nv && j0 + j < Ch)
                    ? ldf4(a.w2 + static_cast<size_t>(n) * Ch + j0 + j)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + (g + u) * kThreads;
        if (g + u < nv)
          store4(w2s + (i / (kTcHC / 4)) * kLdHs + (i % (kTcHC / 4)) * 4,
                 wv[u]);
      }
    }
    __syncthreads();

    // 4. fc1: one 16 x 16 tile of the 64 x 32 chunk per warp, K = C
    {
      FragC hacc;
      wm::fill_fragment(hacc, 0.f);
      for (int k = 0; k < C; k += 16) {
        FragA fa;
        FragBc fb;
        wm::load_matrix_sync(fa, xn + wr * 16 * ldx + k, ldx);
        wm::load_matrix_sync(fb, w1s + wq * 16 * ldx + k, ldx);
        wm::mma_sync(hacc, fa, fb, hacc);
      }
      wm::store_matrix_sync(hf + wr * 16 * kLdHf + wq * 16, hacc, kLdHf,
                            wm::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < kTM * kTcHC; i += kThreads) {
      const int t = i / kTcHC, j = i % kTcHC;
      const float v = j0 + j < Ch
                          ? gelu_tanh(hf[t * kLdHf + j] + a.b1[j0 + j])
                          : 0.f;
      hb[t * kLdHs + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    // 5. y += h @ W2c^T, K = 32
#pragma unroll
    for (int k = 0; k < kTcHC; k += 16) {
      FragA fa;
      wm::load_matrix_sync(fa, hb + wr * 16 * kLdHs + k, kLdHs);
#pragma unroll
      for (int q = 0; q < kMaxYTiles; ++q) {
        if (q < nyt) {
          FragBc fb;
          wm::load_matrix_sync(fb, w2s + (wq + 2 * q) * 16 * kLdHs + k,
                               kLdHs);
          wm::mma_sync(yacc[q], fa, fb, yacc[q]);
        }
      }
    }
    __syncthreads();
  }

  // 6. out = x + dp * round(y + b2)
#pragma unroll
  for (int q = 0; q < kMaxYTiles; ++q)
    if (q < nyt)
      wm::store_matrix_sync(ybuf + wr * 16 * ldy + (wq + 2 * q) * 16, yacc[q],
                            ldy, wm::mem_row_major);
  __syncthreads();
  bf16* out = static_cast<bf16*>(a.out);
  for (int i = tid; i < kTM * C; i += kThreads) {
    const int t = i / C, c = i % C;
    const long long tok = t0 + t;
    if (tok >= a.T) continue;
    const float yv = round_bf16(ybuf[t * ldy + c] + a.b2[c]);
    const float dpv = round_bf16(a.dp ? a.dp[tok / a.hw] : 1.f);
    const size_t idx = static_cast<size_t>(tok) * C + c;
    out[idx] = __float2bfloat16_rn(__bfloat162float(x[idx]) +
                                   round_bf16(dpv * yv));
  }
}

size_t smem_bytes(int C, int is_bf16) {
  return is_bf16 ? mlp_tc_smem_bytes(C) : mlp_smem_floats(C) * sizeof(float);
}

int launch_mlp(const MlpArgs& a, int is_bf16, cudaStream_t stream) {
  if (is_bf16 && (a.C % 32 != 0 || a.C / 32 > kMaxYTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(a.C, is_bf16);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err =
      is_bf16 ? cudaFuncSetAttribute(mlp_fwd_tc, attr, static_cast<int>(bytes))
              : cudaFuncSetAttribute(mlp_fwd, attr,
                                     static_cast<int>(bytes));
  if (err != cudaSuccess) {  // e.g. more shared memory than a block may use
    cudaGetLastError();      // clear it, so the next launch reads its own
    return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((a.T + kTM - 1) / kTM);
  if (is_bf16)
    mlp_fwd_tc<<<blocks, kThreads, bytes, stream>>>(a);
  else
    mlp_fwd<<<blocks, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin

extern "C" int swin_mlp_fwd(const void* x, void* out, const float* ln_s,
                            const float* ln_b, const float* w1,
                            const float* b1, const float* w2, const float* b2,
                            const float* dp, long long T, int C, int Ch,
                            int hw, int is_bf16, void* stream) {
  swin::MlpArgs a{x, out, ln_s, ln_b, w1, b1, w2, b2, dp, T, C, Ch, hw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return swin::launch_mlp(a, is_bf16, s);
}
