// Fused Swin attention branch, forward, for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/swin_block_pallas.py
// fused_attention_branch -> _fused_branch_fwd_impl -> _fwd_kernel
// (_branch_math): out = x + dp * proj(MHSA_window(LN1(x))) on the rolled,
// padded x [B, Hp, Wp, C].
//
// Design. The TPU kernel runs one program per row of windows and holds a
// whole row's LN output, qkv and attention output in VMEM (tens of MB).
// A Hopper block has 227 KB of shared memory: at C = 1024 one window's bf16
// LN output alone is 128 KB and its qkv 384 KB. So the work is split:
//
//   attn_window_head: one block per (window, head). It takes the f32 LN
//     stats of the window's N <= 64 tokens, streams the head's 3*dh columns
//     of Wqkv in K chunks (normalizing the x chunk on the fly), keeps
//     q_h, k_h, v_h (64 x 32 each) in shared memory, runs scores + rel-pos
//     bias + mask, the f32 softmax and p @ v there, and writes o_h into a
//     scratch [B, Hp, Wp, C] in the window-unpartitioned layout.
//   attn_proj_residual: a tiled product o @ Wproj^T + bproj with the
//     residual epilogue x + dp * y.
//
// Each of the two comes in two versions: f32 multiplies with FMAs on the
// CUDA cores; bf16 (attn_window_head_tc, attn_proj_residual_tc) runs every
// product on the tensor cores (WMMA m16n16k16, bf16 in, f32 accumulate)
// on the same rounded operands.
//
// What bounds it: at the flagship shapes the branch does 8*T*C^2 + 4*T*N*C
// operations on 2*T*C*sizeof(T) bytes of activations, far above the
// card's bytes-to-operations balance, so operations bound it. Not done
// yet: every head's block re-reads the window and re-normalizes it, and
// streams its Wqkv rows from L2; no cp.async/TMA pipeline overlaps those
// loads with the products; no wgmma.
//
// Rounding points (as _branch_math): xn after the f32 LN, qkv after the
// bias, q * dh^-1/2, p after the f32 softmax, o after p @ v, y after the
// proj bias, dp * y, and the residual sum.

#include <mma.h>

#include "swin_common.cuh"

namespace swin {

constexpr int kMaxN = 64;  // window of at most 8 x 8 tokens
constexpr int kKC = 32;    // K chunk of the qkv product
constexpr int kLdQ = 33;   // row pitch of q/k/v tiles (dh <= 32, +1 pad)
constexpr int kLdS = 65;   // row pitch of the score tile
constexpr int kLdW = 97;   // row pitch of the weight chunk (3 * 32 + 1)
constexpr int kWork = (kKC * kLdS + kKC * kLdW) > (kMaxN * kLdS)
                          ? (kKC * kLdS + kKC * kLdW)
                          : (kMaxN * kLdS);
constexpr int kSmemFloats = 2 * kMaxN + 3 * kMaxN * kLdQ + kWork;

struct AttnArgs {
  const void* x;
  void* out;
  void* o;  // scratch [B, Hp, Wp, C]: attention output before proj
  const float* ln_s;
  const float* ln_b;
  const float* wqkv;   // [3C, C] (out, in)
  const float* bqkv;   // [3C]
  const float* wproj;  // [C, C] (out, in)
  const float* bproj;  // [C]
  const float* bias;   // [H, N, N] expanded rel-pos bias
  const float* mask;   // [nW, N, N] additive mask, or null
  const float* dp;     // [B] drop-path scale, or null (= 1)
  float scale;         // dh^-1/2
  int B, Hp, Wp, C, H, ws;
};

__global__ void __launch_bounds__(kThreads)
    attn_window_head(AttnArgs a) {
  extern __shared__ float smem[];
  const int ws = a.ws, N = ws * ws, C = a.C, dh = C / a.H;
  const int nWw = a.Wp / ws, nWin = (a.Hp / ws) * nWw;
  const int b = blockIdx.x / nWin;
  const int wi = blockIdx.x % nWin;  // window index inside the image
  const int wy = wi / nWw, wx = wi % nWw;
  const int h = blockIdx.y;
  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;

  float* mu = smem;
  float* rstd = mu + kMaxN;
  float* qs = rstd + kMaxN;
  float* ks = qs + kMaxN * kLdQ;
  float* vs = ks + kMaxN * kLdQ;
  float* xs = vs + kMaxN * kLdQ;  // [kKC][kLdS] LN chunk, k-major
  float* wsm = xs + kKC * kLdS;   // [kKC][kLdW] weight chunk, k-major
  float* sc = xs;                 // [kMaxN][kLdS] scores, after the product

  auto tok_off = [&](int t) -> size_t {
    const int r = wy * ws + t / ws, c = wx * ws + t % ws;
    return ((static_cast<size_t>(b) * a.Hp + r) * a.Wp + c) * C;
  };

  // 1. f32 LN statistics, one warp per token
  for (int t = warp; t < N; t += kThreads / 32) {
    const size_t off = tok_off(t);
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = x[off + c];
      s += v;
      s2 += v * v;
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

  // 2. [q_h | k_h | v_h] = LN(x) @ Wqkv[head rows]^T: 64 x 3dh, K = C
  const int nq = 3 * dh;
  float acc[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int i = tid; i < kMaxN * kKC; i += kThreads) {
      const int t = i / kKC, kk = i % kKC, c = k0 + kk;
      float v = 0.f;
      if (t < N && c < C) {
        const float xv = x[tok_off(t) + c];
        v = (xv - mu[t]) * rstd[t] * a.ln_s[c] + a.ln_b[c];
      }
      xs[kk * kLdS + t] = v;
    }
    for (int i = tid; i < 3 * 32 * kKC; i += kThreads) {
      const int j = i / kKC, kk = i % kKC, c = k0 + kk;
      float v = 0.f;
      if (j < nq && c < C) {
        const int row = (j / dh) * C + h * dh + j % dh;
        v = a.wqkv[static_cast<size_t>(row) * C + c];
      }
      wsm[kk * kLdW + j] = v;
    }
    __syncthreads();
    const int kn = min(kKC, C - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float av[4], bv[6];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xs[kk * kLdS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 6; ++j) bv[j] = wsm[kk * kLdW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // 3. + bqkv; q also scaled
  const float scale = a.scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = tx + 16 * j;
      if (t < N && col < nq) {
        const int part = col / dh, d = col % dh;
        const float v = acc[i][j] + a.bqkv[part * C + h * dh + d];
        if (part == 0)
          qs[t * kLdQ + d] = v * scale;
        else if (part == 1)
          ks[t * kLdQ + d] = v;
        else
          vs[t * kLdQ + d] = v;
      }
    }
  }
  __syncthreads();

  // 4. scores (f32) + rel-pos bias + mask
  float sacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kLdQ + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLdQ + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
  }
  const float* bias_h = a.bias + static_cast<size_t>(h) * N * N;
  const float* mask_w =
      a.mask ? a.mask + static_cast<size_t>(wi) * N * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (r < N && c < N) {
        float v = sacc[i][j] + bias_h[r * N + c];
        if (mask_w) v += mask_w[r * N + c];
        sc[r * kLdS + c] = v;
      }
    }
  }
  __syncthreads();

  // 5. softmax over each row
  for (int r = warp; r < N; r += kThreads / 32) {
    const float v0 = lane < N ? sc[r * kLdS + lane] : -INFINITY;
    const float v1 = lane + 32 < N ? sc[r * kLdS + lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = lane < N ? expf(v0 - m) : 0.f;
    const float e1 = lane + 32 < N ? expf(v1 - m) : 0.f;
    const float s = warp_sum(e0 + e1);
    if (lane < N) sc[r * kLdS + lane] = e0 / s;
    if (lane + 32 < N) sc[r * kLdS + lane + 32] = e1 / s;
  }
  __syncthreads();

  // 6. o_h = p @ v_h, written unpartitioned into the scratch
  float oacc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) oacc[i][0] = oacc[i][1] = 0.f;
  for (int j = 0; j < N; ++j) {
    float pv[4], vv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = sc[(ty + 16 * i) * kLdS + j];
#pragma unroll
    for (int q = 0; q < 2; ++q) vv[q] = vs[j * kLdQ + tx + 16 * q];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) oacc[i][q] = fmaf(pv[i], vv[q], oacc[i][q]);
  }
  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int d = tx + 16 * q;
      if (t < N && d < dh) o[tok_off(t) + h * dh + d] = oacc[i][q];
    }
  }
}

// y = o @ Wproj^T + bproj, out = x + dp * y: 64 x 64 tiles
__global__ void __launch_bounds__(kThreads)
    attn_proj_residual(AttnArgs a) {
  __shared__ float As[kKC][kLdS];
  __shared__ float Bs[kKC][kLdS];
  const int C = a.C;
  const long long M = static_cast<long long>(a.B) * a.Hp * a.Wp;
  const long long m0 = static_cast<long long>(blockIdx.x) * 64;
  const int n0 = blockIdx.y * 64;
  const float* o = static_cast<const float*>(a.o);
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int i = tid; i < 64 * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC, k = k0 + kk;
      const long long m = m0 + r;
      const int n = n0 + r;
      As[kk][r] = (m < M && k < C)
                      ? o[static_cast<size_t>(m) * C + k]
                      : 0.f;
      Bs[kk][r] = (n < C && k < C)
                      ? a.wproj[static_cast<size_t>(n) * C + k]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long hw = static_cast<long long>(a.Hp) * a.Wp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float dpv = a.dp ? a.dp[m / hw] : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= C) continue;
      const float y = acc[i][j] + a.bproj[n];
      const size_t idx = static_cast<size_t>(m) * C + n;
      out[idx] = x[idx] + dpv * y;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the same two kernels with every product on the tensor cores (WMMA
// m16n16k16, bf16 operands, f32 accumulators). The operands are the values
// _branch_math rounds to bf16, at the same points.
// ---------------------------------------------------------------------------
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragBr = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int kTcKC = 64;             // K chunk of the qkv product
constexpr int kLdX = kTcKC + 8;       // bf16 pitch of the LN / Wqkv chunks
constexpr int kLdAcc = 3 * 32 + 4;    // f32 pitch of the qkv accumulators
constexpr int kLdH = 32 + 8;          // bf16 pitch of q/k/v (dh <= 32)
constexpr int kLdSf = kMaxN + 4;      // f32 pitch of the scores
constexpr int kLdP = kMaxN + 8;       // bf16 pitch of p
constexpr int kLdO = 32 + 4;          // f32 pitch of the head's output
// byte offsets in attn_window_head_tc's shared memory; the chunk buffers
// (phase A) and the score/p/o buffers (phase C) share one region
constexpr int kOffQ = 2 * kMaxN * 4;
constexpr int kOffR = kOffQ + 3 * kMaxN * kLdH * 2;
constexpr int kOffW = kOffR + kMaxN * kLdX * 2;
constexpr int kOffAcc = kOffW + 3 * 32 * kLdX * 2;
constexpr int kEndA = kOffAcc + kMaxN * kLdAcc * 4;
constexpr int kOffP = kOffR + kMaxN * kLdSf * 4;
constexpr int kOffO = kOffP + kMaxN * kLdP * 2;
constexpr int kEndC = kOffO + kMaxN * kLdO * 4;
constexpr int kSmemTc = kEndA > kEndC ? kEndA : kEndC;

__global__ void __launch_bounds__(kThreads)
    attn_window_head_tc(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int ws = a.ws, N = ws * ws, C = a.C, dh = C / a.H;
  const int nWw = a.Wp / ws, nWin = (a.Hp / ws) * nWw;
  const int b = blockIdx.x / nWin;
  const int wi = blockIdx.x % nWin;
  const int wy = wi / nWw, wx = wi % nWw;
  const int h = blockIdx.y;
  const bf16* x = static_cast<const bf16*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp % 4;  // the warp's 16-row tile

  float* mu = reinterpret_cast<float*>(sm);
  float* rstd = mu + kMaxN;
  bf16* qs = reinterpret_cast<bf16*>(sm + kOffQ);
  bf16* ks = qs + kMaxN * kLdH;
  bf16* vs = ks + kMaxN * kLdH;
  bf16* xs = reinterpret_cast<bf16*>(sm + kOffR);
  bf16* wsm = reinterpret_cast<bf16*>(sm + kOffW);
  float* acc_s = reinterpret_cast<float*>(sm + kOffAcc);
  float* sc = reinterpret_cast<float*>(sm + kOffR);
  bf16* ps = reinterpret_cast<bf16*>(sm + kOffP);
  float* os = reinterpret_cast<float*>(sm + kOffO);

  auto tok_off = [&](int t) -> size_t {
    const int r = wy * ws + t / ws, c = wx * ws + t % ws;
    return ((static_cast<size_t>(b) * a.Hp + r) * a.Wp + c) * C;
  };

  // 1. f32 LN statistics, one warp per token, 8 channels per load
  for (int t = warp; t < N; t += kThreads / 32) {
    const size_t off = tok_off(t);
    float s = 0.f, s2 = 0.f;
    for (int c = lane * 8; c < C; c += 32 * 8) {
      float f[8];
      unpack8(ld16(x + off + c), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += f[j];
        s2 += f[j] * f[j];
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

  // 2. [q_h | k_h | v_h] = LN(x) @ Wqkv[head rows]^T on the tensor cores:
  //    64 x 3dh in 16 x 16 tiles, warp (wr, warp / 4) takes column tiles
  //    warp / 4, warp / 4 + 2, warp / 4 + 4. Chunks are staged in 16-byte
  //    vectors; the next chunk's loads are in flight during the products.
  constexpr int kXV = kMaxN * kTcKC / 8 / kThreads;   // x vectors / thread
  constexpr int kWV = 3 * 32 * kTcKC / 4 / kThreads;  // Wqkv vectors
  const int nq = 3 * dh, tn = nq / 16;
  uint4 xr[kXV];
  float4 wr4[kWV];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kXV; ++it) {
      const int i = tid + it * kThreads;
      const int t = i / (kTcKC / 8), c = k0 + (i % (kTcKC / 8)) * 8;
      xr[it] = (t < N && c < C) ? ld16(x + tok_off(t) + c)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < kWV; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / (kTcKC / 4), c = k0 + (i % (kTcKC / 4)) * 4;
      wr4[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nq && c < C) {
        const int row = (j / dh) * C + h * dh + j % dh;
        wr4[it] = ldf4(a.wqkv + static_cast<size_t>(row) * C + c);
      }
    }
  };
  auto store_chunk = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kXV; ++it) {
      const int i = tid + it * kThreads;
      const int t = i / (kTcKC / 8), kk = (i % (kTcKC / 8)) * 8;
      const int c = k0 + kk;
      float f[8];
      unpack8(xr[it], f);
      if (t < N && c < C) {
        const float4 s0 = ldf4(a.ln_s + c), s1 = ldf4(a.ln_s + c + 4);
        const float4 b0 = ldf4(a.ln_b + c), b1 = ldf4(a.ln_b + c + 4);
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = (f[j] - mu[t]) * rstd[t] * sv[j] + bv[j];
      }
      store8(xs + t * kLdX + kk, f);
    }
#pragma unroll
    for (int it = 0; it < kWV; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / (kTcKC / 4), kk = (i % (kTcKC / 4)) * 4;
      store4(wsm + j * kLdX + kk, wr4[it]);
    }
  };

  FragC acc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) wm::fill_fragment(acc[j], 0.f);
  load_chunk(0);
  for (int k0 = 0; k0 < C; k0 += kTcKC) {
    store_chunk(k0);
    __syncthreads();
    if (k0 + kTcKC < C) load_chunk(k0 + kTcKC);
    const int kn = min(kTcKC, C - k0);
    for (int kk = 0; kk < kn; kk += 16) {
      FragA fa;
      wm::load_matrix_sync(fa, xs + wr * 16 * kLdX + kk, kLdX);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ct = warp / 4 + 2 * j;
        if (ct < tn) {
          FragBc fb;
          wm::load_matrix_sync(fb, wsm + ct * 16 * kLdX + kk, kLdX);
          wm::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int ct = warp / 4 + 2 * j;
    if (ct < tn)
      wm::store_matrix_sync(acc_s + wr * 16 * kLdAcc + ct * 16, acc[j],
                            kLdAcc, wm::mem_row_major);
  }
  __syncthreads();

  // 3. + bqkv, round; q also scaled and rounded (rows >= N hold finite
  //    bias values and are never read into a kept output)
  const float scale = round_bf16(a.scale);
  for (int i = tid; i < kMaxN * nq; i += kThreads) {
    const int t = i / nq, col = i % nq;
    const int part = col / dh, d = col % dh;
    const float v =
        round_bf16(acc_s[t * kLdAcc + col] + a.bqkv[part * C + h * dh + d]);
    bf16* dst = part == 0 ? qs : (part == 1 ? ks : vs);
    dst[t * kLdH + d] = __float2bfloat16_rn(part == 0 ? v * scale : v);
  }
  __syncthreads();

  // 4. scores = q k^T (64 x 64, K = dh): warp (wr, warp / 4) takes column
  //    tiles 2 * (warp / 4) and 2 * (warp / 4) + 1
  {
    FragC sacc[2];
    wm::fill_fragment(sacc[0], 0.f);
    wm::fill_fragment(sacc[1], 0.f);
    for (int d0 = 0; d0 < dh; d0 += 16) {
      FragA fa;
      wm::load_matrix_sync(fa, qs + wr * 16 * kLdH + d0, kLdH);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBc fb;
        wm::load_matrix_sync(fb, ks + ((warp / 4) * 2 + j) * 16 * kLdH + d0,
                             kLdH);
        wm::mma_sync(sacc[j], fa, fb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(sc + wr * 16 * kLdSf + ((warp / 4) * 2 + j) * 16,
                            sacc[j], kLdSf, wm::mem_row_major);
  }
  __syncthreads();

  // 5. + rel-pos bias + mask, f32 softmax, p rounded (0 beyond N)
  const float* bias_h = a.bias + static_cast<size_t>(h) * N * N;
  const float* mask_w =
      a.mask ? a.mask + static_cast<size_t>(wi) * N * N : nullptr;
  for (int r = warp; r < N; r += kThreads / 32) {
    float v0 = -INFINITY, v1 = -INFINITY;
    if (lane < N) {
      v0 = sc[r * kLdSf + lane] + bias_h[r * N + lane];
      if (mask_w) v0 += mask_w[r * N + lane];
    }
    if (lane + 32 < N) {
      v1 = sc[r * kLdSf + lane + 32] + bias_h[r * N + lane + 32];
      if (mask_w) v1 += mask_w[r * N + lane + 32];
    }
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = lane < N ? expf(v0 - m) : 0.f;
    const float e1 = lane + 32 < N ? expf(v1 - m) : 0.f;
    const float s = warp_sum(e0 + e1);
    ps[r * kLdP + lane] = __float2bfloat16_rn(e0 / s);
    ps[r * kLdP + lane + 32] = __float2bfloat16_rn(e1 / s);
  }
  __syncthreads();

  // 6. o_h = p @ v_h (64 x dh, K = 64), rounded, written unpartitioned
  if (warp < 4 * (dh / 16)) {
    FragC oacc;
    wm::fill_fragment(oacc, 0.f);
    for (int j0 = 0; j0 < kMaxN; j0 += 16) {
      FragA fa;
      FragBr fb;
      wm::load_matrix_sync(fa, ps + wr * 16 * kLdP + j0, kLdP);
      wm::load_matrix_sync(fb, vs + j0 * kLdH + (warp / 4) * 16, kLdH);
      wm::mma_sync(oacc, fa, fb, oacc);
    }
    wm::store_matrix_sync(os + wr * 16 * kLdO + (warp / 4) * 16, oacc, kLdO,
                          wm::mem_row_major);
  }
  __syncthreads();
  bf16* o = static_cast<bf16*>(a.o);
  for (int i = tid; i < N * dh; i += kThreads) {
    const int t = i / dh, d = i % dh;
    o[tok_off(t) + h * dh + d] = __float2bfloat16_rn(os[t * kLdO + d]);
  }
}

constexpr int kPK = 64;          // K chunk of the proj product
constexpr int kLdPA = kPK + 8;   // bf16 pitch of its operand tiles
constexpr int kLdPC = 64 + 4;    // f32 pitch of its 64 x 64 result

// two blocks per SM: <= 128 registers
__global__ void __launch_bounds__(kThreads, 2)
    attn_proj_residual_tc(AttnArgs a) {
  __shared__ __align__(128) bf16 As[64 * kLdPA];
  __shared__ __align__(128) bf16 Bs[64 * kLdPA];
  __shared__ __align__(128) float Cs[64 * kLdPC];
  const int C = a.C;
  const long long M = static_cast<long long>(a.B) * a.Hp * a.Wp;
  const long long m0 = static_cast<long long>(blockIdx.x) * 64;
  const int n0 = blockIdx.y * 64;
  const bf16* o = static_cast<const bf16*>(a.o);
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp % 4, wc = (warp / 4) * 2;

  // operand tiles in 16-byte vectors, the next chunk in flight
  constexpr int kAV = 64 * kPK / 8 / kThreads;
  constexpr int kBV = 64 * kPK / 4 / kThreads;
  uint4 ar[kAV];
  float4 br[kBV];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kAV; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kPK / 8), k = k0 + (i % (kPK / 8)) * 8;
      const long long m = m0 + r;
      ar[it] = (m < M && k < C) ? ld16(o + static_cast<size_t>(m) * C + k)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < kBV; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kPK / 4), k = k0 + (i % (kPK / 4)) * 4;
      const int n = n0 + r;
      br[it] = (n < C && k < C)
                   ? ldf4(a.wproj + static_cast<size_t>(n) * C + k)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  FragC acc[2];
  wm::fill_fragment(acc[0], 0.f);
  wm::fill_fragment(acc[1], 0.f);
  load_chunk(0);
  for (int k0 = 0; k0 < C; k0 += kPK) {
#pragma unroll
    for (int it = 0; it < kAV; ++it) {
      const int i = tid + it * kThreads;
      *reinterpret_cast<uint4*>(As + (i / (kPK / 8)) * kLdPA +
                                (i % (kPK / 8)) * 8) = ar[it];
    }
#pragma unroll
    for (int it = 0; it < kBV; ++it) {
      const int i = tid + it * kThreads;
      store4(Bs + (i / (kPK / 4)) * kLdPA + (i % (kPK / 4)) * 4, br[it]);
    }
    __syncthreads();
    if (k0 + kPK < C) load_chunk(k0 + kPK);
    const int kn = min(kPK, C - k0);
    for (int kk = 0; kk < kn; kk += 16) {
      FragA fa;
      wm::load_matrix_sync(fa, As + wr * 16 * kLdPA + kk, kLdPA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBc fb;
        wm::load_matrix_sync(fb, Bs + (wc + j) * 16 * kLdPA + kk, kLdPA);
        wm::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wm::store_matrix_sync(Cs + wr * 16 * kLdPC + (wc + j) * 16, acc[j], kLdPC,
                          wm::mem_row_major);
  __syncthreads();

  const long long hw = static_cast<long long>(a.Hp) * a.Wp;
  for (int i = tid; i < 64 * 64; i += kThreads) {
    const int r = i / 64, c = i % 64;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= C) continue;
    const float dpv = round_bf16(a.dp ? a.dp[m / hw] : 1.f);
    const float y = round_bf16(Cs[r * kLdPC + c] + a.bproj[n]);
    const size_t idx = static_cast<size_t>(m) * C + n;
    out[idx] = __float2bfloat16_rn(__bfloat162float(x[idx]) +
                                   round_bf16(dpv * y));
  }
}

int launch_f32(const AttnArgs& a, cudaStream_t stream) {
  const int nW = a.B * (a.Hp / a.ws) * (a.Wp / a.ws);
  attn_window_head<<<dim3(nW, a.H), kThreads,
                            kSmemFloats * sizeof(float), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(a.B) * a.Hp * a.Wp;
  attn_proj_residual<<<dim3(static_cast<unsigned>((M + 63) / 64),
                                   (a.C + 63) / 64),
                              kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const AttnArgs& a, cudaStream_t stream) {
  if (a.C % 16 != 0 || (a.C / a.H) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attn_window_head_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemTc);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reads its own
    return static_cast<int>(err);
  }
  const int nW = a.B * (a.Hp / a.ws) * (a.Wp / a.ws);
  attn_window_head_tc<<<dim3(nW, a.H), kThreads, kSmemTc, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(a.B) * a.Hp * a.Wp;
  attn_proj_residual_tc<<<dim3(static_cast<unsigned>((M + 63) / 64),
                               (a.C + 63) / 64),
                          kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin

extern "C" int swin_attn_fwd(const void* x, void* out, void* o_scratch,
                             const float* ln_s, const float* ln_b,
                             const float* wqkv, const float* bqkv,
                             const float* wproj, const float* bproj,
                             const float* bias, const float* mask,
                             const float* dp, float scale, int B, int Hp,
                             int Wp, int C, int H, int ws, int is_bf16,
                             void* stream) {
  if (ws * ws > swin::kMaxN || C % H != 0 || C / H > 32 || Hp % ws != 0 ||
      Wp % ws != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  swin::AttnArgs a{x,    out,  o_scratch, ln_s, ln_b, wqkv, bqkv, wproj,
                   bproj, bias, mask,      dp,   scale, B,   Hp,   Wp,
                   C,     H,    ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::launch_bf16(a, s) : swin::launch_f32(a, s);
}
