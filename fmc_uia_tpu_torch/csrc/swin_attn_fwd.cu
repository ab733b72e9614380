// Fused Swin attention branch, forward (K1f), for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/swin_block_pallas.py
// fused_attention_branch -> _fused_branch_fwd_impl -> _fwd_kernel
// (_branch_math): out = x + dp * proj(MHSA_window(LN1(x))) on the rolled,
// padded x [B, Hp, Wp, C].
//
// Design (bf16). The TPU kernel runs one program per row of windows and
// holds a whole row's LN output, qkv and attention output in VMEM (tens of
// MB); a Hopper block has 227 KB. Every tensor stays in the [B, Hp, Wp, C]
// grid layout, so no window partition is ever copied:
//
//   cast_weights: Wqkv and Wproj rounded once per launch into a bf16
//     workspace that TMA reads (the port's params are f32).
//   ln_rows_bf16: xn = LN1(x), f32 statistics, once per token, rounded.
//   qkv_window_attn: one block per (pair of windows, head group of
//     G = 64 / dh heads). A producer warp streams each window's xn rows (a
//     64-channel x ws x ws box of a rank-4 tensor map: exactly one m64
//     tile, rows >= N zero) and the group's q, k and v rows of the Wqkv
//     copy (three 64-row boxes at rows p C + 64 g: one 192-row tile, see
//     swin_attn_sm90.cuh), which the two windows share, through a ring of
//     stages; consumer
//     warpgroup w runs window w's [q | k | v] = xn Wqkv^T as wgmma
//     m64n192k16, adds the bias and rounds (q times dh^-1/2) into three
//     swizzled 64 x 64 tiles in shared memory, then per head
//     S = q k^T (m64n64, K-major operands at the head's column offset),
//     the rel-pos bias and shift mask, the f32 softmax in registers, and
//     O = P V (m64n{dh}, P from the accumulators, V MN-major: no
//     transposed copy), written into o [B, Hp, Wp, C].
//   gemm_run (sm90_gemm.cuh): y = o Wproj^T + bproj and x + dp * y in its
//     epilogue, 128 x 128 tiles of tokens x channels.
//
// At the flagship's stage 2 (C = 512, B = 8) that is 64 pairs x 8 groups
// = 512 blocks of the window kernel. The Wqkv stream is the kernel's
// largest read (192 x C per block, from L2): a pair of windows halves it.
//
// The f32 version (attn_window_head, attn_proj_residual) runs every
// multiply as an FMA on the CUDA cores, one block per (window, head); it
// is off the bf16 main path and held against the same plain version.
//
// What bounds it: 8*T*C^2 + 4*T*N*C operations on 2*T*C*sizeof(T) bytes of
// activations, far above the card's bytes-to-operations balance, so
// operations bound it.
//
// Rounding points (as _branch_math): xn after the f32 LN, qkv after the
// bias, q * dh^-1/2, p after the f32 softmax, o after p @ v, y after the
// proj bias, dp * y, and the residual sum.

#include "swin_attn_sm90.cuh"

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


// ---------------------------------------------------------------------------
// bf16: cast_weights, ln_rows, qkv_window_attn, then the proj GEMM.
// ---------------------------------------------------------------------------
constexpr int kQkvN = 3 * 64;   // [q | k | v] of a head group
constexpr int kQkvStages = 3;   // xn / Wqkv chunks in flight
constexpr int kQkvWin = 2;      // windows of a block, one a warpgroup
using QkvRoles = WarpRoles<kQkvWin>;  // and one producer warp

struct QkvSmem {  // at the 1024-aligned start of dynamic shared memory
  bf16 a[kQkvStages][kQkvWin][kWinRows * 64];  // xn: the windows' rows
  bf16 b[kQkvStages][kQkvN * 64];  // the group's Wqkv rows, 64 channels;
                                   // b[w] holds warpgroup w's q | k | v
  uint64_t full[kQkvStages], empty[kQkvStages];
};
static_assert(kQkvStages >= kQkvWin, "q | k | v of each warpgroup in b");
constexpr int kQkvSmemBytes = static_cast<int>(sizeof(QkvSmem)) + 1024;

struct QkvAttnArgs {
  bf16* o;              // [B, Hp, Wp, C]: attention output before proj
  const float* bqkv;    // [3C]
  const float* bias;    // [H, N, N] expanded rel-pos bias
  const float* mask;    // [nW, N, N] additive mask, or null
  float scale;          // dh^-1/2
  int Hp, Wp, C, H, ws, groups, nW;
};

template <int DH>
__global__ void __launch_bounds__(QkvRoles::kThreads, 1)
    qkv_window_attn(const __grid_constant__ CUtensorMap txn,
                    const __grid_constant__ CUtensorMap tw, QkvAttnArgs a) {
  constexpr int G = 64 / DH;  // heads of a group
  QkvSmem& s = *reinterpret_cast<QkvSmem*>(smem_base_1k());
  const int g = blockIdx.x % a.groups;
  const int w0 = (blockIdx.x / a.groups) * kQkvWin;  // the block's windows
  const int ws = a.ws, N = ws * ws, C = a.C;
  const int nk = (C + 63) / 64;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kQkvStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], QkvRoles::kConsumerWarps);
    }
    fence_barrier_init();
  }
  if (N < kWinRows) {  // rows >= N of the xn stages stay zero (TMA writes N)
    const int per_tile = (kWinRows - N) * 8;  // 16-byte pieces
    for (int i = threadIdx.x; i < kQkvStages * kQkvWin * per_tile;
         i += blockDim.x) {
      bf16* tile = s.a[0][0] + (i / per_tile) * kWinRows * 64;
      *reinterpret_cast<uint4*>(tile + N * 64 + (i % per_tile) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_smem();
  }
  __syncthreads();
  const int wg = warpgroup_index();
  if (wg == kQkvWin) {  // the producer warp
    if (threadIdx.x == QkvRoles::kProducerThread) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % kQkvStages;
        mbar_wait(&s.empty[st], ((i / kQkvStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], (kQkvWin * N + kQkvN) * 128);
        for (int j = 0; j < kQkvWin; ++j) {  // past the last: its copy
          const WindowAt wj(min(w0 + j, a.nW - 1), a.Hp, a.Wp, ws);
          tma_load_4d(s.a[st][j], &txn, &s.full[st], i * 64, wj.x0, wj.y0,
                      wj.b);
        }
        for (int p = 0; p < 3; ++p)  // q, k, v rows of the group's heads
          tma_load_2d(s.b[st] + p * 64 * 64, &tw, &s.full[st], i * 64,
                      p * C + g * 64);
      }
    }
    return;
  }
  // consumer warpgroup wg: window w0 + wg
  const WindowAt win(min(w0 + wg, a.nW - 1), a.Hp, a.Wp, ws);

  // [q | k | v] = xn Wqkv_g^T: 64 x 192, f32
  // (no other instruction touches acc until the last wait, as in gemm_sm90)
  float acc[kQkvN / 2];
  for (int i = 0; i < nk; ++i) {
    const int st = i % kQkvStages;
    mbar_wait_warp(&s.full[st], (i / kQkvStages) & 1);
    const uint64_t da = sw128_desc(s.a[st][wg]), db = sw128_desc(s.b[st]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Wg<kQkvN>::ss<0, 0>(acc, da + ks * kDescKStep, db + ks * kDescKStep,
                          i > 0 || ks > 0);
    wg_commit();
    wg_wait<1>();
    if (i > 0) warp_arrive(&s.empty[(i - 1) % kQkvStages]);
  }
  wg_wait<0>();
  fence_regs(acc);
  // both warpgroups' products are done: the stages are free
  asm volatile("bar.sync 3, %0;\n" ::"n"(kQkvWin * kWgThreads) : "memory");
  if (w0 + wg >= a.nW) return;  // an odd last window: nothing to write

  // + bias, rounded; q times the rounded scale, rounded: three swizzled
  // 64 x 64 tiles (q, k, v of the group's heads) in b[wg]
  unsigned char* t = reinterpret_cast<unsigned char*>(s.b[wg]);
  const int tid = threadIdx.x % kWgThreads, lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const float sc = round_bf16(a.scale);
#pragma unroll
  for (int i = 0; i < kQkvN / 8; ++i) {
    const int part = i / 8, col = 8 * (i % 8) + c0, ch = g * 64 + col;
    // channels >= C: the heads that pad H to a multiple of G (never read)
    const float* bp = a.bqkv + part * C + ch;
    const float b0 = ch < C ? bp[0] : 0.f, b1 = ch + 1 < C ? bp[1] : 0.f;
    float v[4] = {round_bf16(acc[4 * i] + b0), round_bf16(acc[4 * i + 1] + b1),
                  round_bf16(acc[4 * i + 2] + b0),
                  round_bf16(acc[4 * i + 3] + b1)};
    if (part == 0)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= sc;
    unsigned char* tp = t + part * kWinRows * 128;
    store_bf16x2(reinterpret_cast<bf16*>(tp + sw128_off(r0, col)), v[0],
                 v[1]);
    store_bf16x2(reinterpret_cast<bf16*>(tp + sw128_off(r0 + 8, col)), v[2],
                 v[3]);
  }
  fence_async_smem();
  wg_bar(wg);

  const uint64_t dq = sw128_desc(t), dk = sw128_desc(t + kWinRows * 128),
                 dv = sw128_desc(t + 2 * kWinRows * 128);
  for (int h = 0; h < G; ++h) {
    const int head = g * G + h;
    if (head >= a.H) break;
    const uint64_t hoff = (h * DH * 2) >> 4;  // the head's columns
    // S = q k^T (64 x 64, K = dh)
    float sacc[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      Wg<64>::ss<0, 0>(sacc, dq + hoff + ks * kDescKStep,
                       dk + hoff + ks * kDescKStep, ks > 0);
    wg_commit();
    // the rel-pos bias and the mask, loaded while the product runs (0 for
    // rows >= N, which are finite and never written)
    const float* bias_h = a.bias + static_cast<size_t>(head) * N * N;
    const float* mask_w =
        a.mask ? a.mask + static_cast<size_t>(win.wi) * N * N : nullptr;
    float bh[32], mk[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + c0 + (e & 1);
      const bool in = r < N && col < N;
      bh[e] = in ? bias_h[r * N + col] : 0.f;
      mk[e] = in && mask_w ? mask_w[r * N + col] : 0.f;
    }
    wg_wait<0>();
    fence_regs(sacc);
    // + rel-pos bias + mask, f32 softmax over the N keys
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * i + c0 + (e & 1);
        float v = -INFINITY;
        if (col < N) {
          v = sacc[4 * i + e] + bh[4 * i + e];
          if (mask_w) v += mk[4 * i + e];
        }
        sacc[4 * i + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = expf(sacc[4 * i + e] - mx[e >> 1]);
        sacc[4 * i + e] = ex;
        sum[e >> 1] += ex;
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[4 * i + e] /= sum[e >> 1];
    uint32_t p[4][4];
    acc_to_a(p, sacc);  // p rounded to bf16
    // O = P V_h (64 x dh, K = 64 keys; V MN-major)
    float o[DH / 2];
    fence_regs(p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wg<DH>::template rs<1>(o, p[kk], dv + hoff + kk * kDescRows16, kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    bf16* O = a.o + head * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int col = 8 * i + c0;
      if (r0 < N)
        store_bf16x2(O + win.token(r0, a.Hp, a.Wp, ws) * C + col, o[4 * i],
                     o[4 * i + 1]);
      if (r0 + 8 < N)
        store_bf16x2(O + win.token(r0 + 8, a.Hp, a.Wp, ws) * C + col,
                     o[4 * i + 2], o[4 * i + 3]);
    }
  }
}

// out = x + round(round(dp) * round(o Wproj^T + bproj)), rounded
struct EpiResidual {
  const bf16* x;
  bf16* out;
  const float* bproj;
  const float* dp;
  int C;
  long long hw;
  __device__ void operator()(int m, int n, int, const float (&v)[8]) const {
    const float dpv = round_bf16(dp ? dp[m / hw] : 1.f);
    const long long idx = static_cast<long long>(m) * C + n;
    float xs[8], w[8];
    unpack8(ld16(x + idx), xs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = xs[j] + round_bf16(dpv * round_bf16(v[j] + bproj[n + j]));
    store_bf16x8(out + idx, w);
  }
};

// the workspace, carved in one order for measuring and for use
struct FwdWork {
  bf16 *wqkv_b, *wproj_b, *xn, *o;
  float *mu, *rstd;
  void* o_f32;
  FwdWork(Carver& cv, int B, int Hp, int Wp, int C, int H, int is_bf16) {
    const long long T = static_cast<long long>(B) * Hp * Wp;
    if (!is_bf16) {  // the f32 kernels' attention output
      o_f32 = cv.take<float>(T * C);
      return;
    }
    wqkv_b = cv.take<bf16>(3LL * C * C);
    wproj_b = cv.take<bf16>(static_cast<size_t>(C) * C);
    xn = cv.take<bf16>(T * C);
    o = cv.take<bf16>(T * C);
    mu = cv.take<float>(T);
    rstd = cv.take<float>(T);
  }
  static int head_groups(int C, int H) {
    const int G = 64 / (C / H);
    return (H + G - 1) / G;
  }
};

template <int DH>
int launch_qkv_window_attn(const CUtensorMap& txn, const CUtensorMap& tw,
                           const QkvAttnArgs& qa, int nW, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  SWIN_TRY(smem_limit_once(
      smem_set, reinterpret_cast<const void*>(qkv_window_attn<DH>),
      kQkvSmemBytes));
  qkv_window_attn<DH><<<(nW + kQkvWin - 1) / kQkvWin * qa.groups,
                        QkvRoles::kThreads, kQkvSmemBytes, s>>>(txn, tw, qa);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const AttnArgs& a, const FwdWork& w, cudaStream_t s) {
  const int C = a.C, dh = C / a.H, groups = FwdWork::head_groups(C, a.H);
  const int T = a.B * a.Hp * a.Wp;
  const bf16* x = static_cast<const bf16*>(a.x);
  SWIN_TRY(launch_cast_weights<K1f>(a.wqkv, 3LL * C * C, a.wproj,
                                    static_cast<long long>(C) * C, w.wqkv_b,
                                    w.wproj_b, s));
  SWIN_TRY(launch_ln_rows_bf16<K1f>(x, a.ln_s, a.ln_b, w.xn, w.mu, w.rstd, T,
                                    C, s));
  CUtensorMap txn, tw;
  SWIN_TRY(make_map_window(&txn, w.xn, a.B, a.Hp, a.Wp, C, a.ws));
  SWIN_TRY(make_map_2d(&tw, w.wqkv_b, C, 3 * C, C, 64));
  const int nW = a.B * (a.Hp / a.ws) * (a.Wp / a.ws);
  const QkvAttnArgs qa{w.o, a.bqkv, a.bias, a.mask, a.scale, a.Hp,
                       a.Wp, C, a.H, a.ws, groups, nW};
  SWIN_TRY(dh == 32 ? launch_qkv_window_attn<32>(txn, tw, qa, nW, s)
                    : launch_qkv_window_attn<16>(txn, tw, qa, nW, s));
  return gemm_run<false, false, K1f>(
      w.o, C, w.wproj_b, C, T, C, C, (C + kGemmK - 1) / kGemmK * kGemmK,
      EpiResidual{x, static_cast<bf16*>(a.out), a.bproj, a.dp, C,
                  static_cast<long long>(a.Hp) * a.Wp},
      s);
}

bool fwd_dims_ok(int B, int Hp, int Wp, int C, int H, int ws, int is_bf16) {
  if (B < 1 || ws < 1 || ws * ws > kMaxN || H < 1 || C % H != 0 ||
      C / H > 32 || Hp % ws != 0 || Wp % ws != 0)
    return false;
  return !is_bf16 || ((C / H == 16 || C / H == 32) && C % 8 == 0);
}

}  // namespace swin

extern "C" long long swin_attn_fwd_workspace(int B, int Hp, int Wp, int C,
                                             int H, int ws, int is_bf16) {
  if (!swin::fwd_dims_ok(B, Hp, Wp, C, H, ws, is_bf16)) return 0;
  swin::Carver cv{nullptr};
  swin::FwdWork w(cv, B, Hp, Wp, C, H, is_bf16);
  return static_cast<long long>(cv.off);
}

// work: swin_attn_fwd_workspace bytes.
extern "C" int swin_attn_fwd(const void* x, void* out, void* work,
                             const float* ln_s, const float* ln_b,
                             const float* wqkv, const float* bqkv,
                             const float* wproj, const float* bproj,
                             const float* bias, const float* mask,
                             const float* dp, float scale,
                             int B, int Hp, int Wp, int C, int H, int ws,
                             int is_bf16, void* stream) {
  if (!swin::fwd_dims_ok(B, Hp, Wp, C, H, ws, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  swin::Carver cv{static_cast<char*>(work)};
  const swin::FwdWork w(cv, B, Hp, Wp, C, H, is_bf16);
  swin::AttnArgs a{x,     out,  is_bf16 ? nullptr : w.o_f32,
                   ln_s,  ln_b, wqkv, bqkv, wproj, bproj, bias, mask, dp,
                   scale, B,    Hp,   Wp,   C,     H,     ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::launch_bf16(a, w, s)
                 : swin::launch_f32(a, s);
}
