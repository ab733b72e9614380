// Fused Swin MLP branch, forward (K2f), for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/swin_block_pallas.py
// fused_mlp_branch -> _fused_mlp_fwd_impl -> _mlp_fwd_kernel (_mlp_math):
// out = x + dp * fc2(gelu_tanh(fc1(LN2(x)))) on tokens x [T, C].
//
// Design (bf16, mlp_fwd_sm90). As on the TPU, the 4C-wide hidden
// activation never leaves the chip. cast_weights rounds W1 and W2 to bf16
// once a call (TMA reads bf16; the port's params are f32). Then one block
// per 128 tokens: two consumer warpgroups of 64 rows and a producer warp.
//   * The consumers compute the f32 LN of their rows and write xn, rounded,
//     into shared memory in the 128-byte swizzle wgmma reads (64-column
//     atoms; a C of 96 or 192 leaves the last atom half unused: the
//     products stop at k = C).
//   * The producer streams, by TMA through a ring of stages, W1's rows
//     [j0, j0 + 64) x C and W2's matching 64 columns (C rows), both K-major
//     as they lie in the bf16 copies.
//   * Per hidden chunk, in SW-wide pieces: S = xn W1^T (wgmma from shared
//     memory, K = C), + b1, tanh-GELU (tanhf), rounded to bf16 into the A
//     fragments of y += h W2^T (wgmma with A from registers); y, 64 x C f32
//     a warpgroup (C / 2 registers a thread), stays in registers.
//   * Epilogue: y staged through shared memory; round(y + b2), dp per token
//     row (a tile may cross samples, and the last tile is masked), the
//     residual add, 16-byte stores.
// Every C % 32 == 0 up to 256 has its own instance (the widths of y's
// wgmma sum to C: 192 + 64, 128 + 32, ...).
//
// Wider C (bf16, mlp_fwd_wide_sm90; C = 384, 512, 768, the Swin widths
// the JAX package fuses under FMC_FUSED_MLP_MAX_C). Four limits bind the
// design above there: y's C / 2 registers a thread (256 at C = 512), a TMA
// box of at most 256 rows (W2's chunk is C rows), the 227 KB of shared
// memory (the chunk's weights alone are 256 C bytes: 192 KB at C = 768,
// beside a 128-row xn tile) and 168 registers a thread beside a producer
// warp. So a block takes 64 tokens and two warpgroups share them, each
// owning C / 2 columns of y (C / 4 registers a thread, 192 at C = 768),
// with no producer warp (255 registers a thread):
//   * xn, 64 x C, stays in shared memory (96 KB at C = 768); the weights
//     stream by TMA in 64 x 64 boxes (8 KB), two a step through a ring of
//     up to 8 steps: a hidden chunk of 64 units is C / 128 steps of W1
//     (k-columns 128 t .. + 127 of the chunk's 64 rows), then C / 128
//     steps of W2 (output rows 64 q .. of warpgroup 0's half and of
//     warpgroup 1's).
//   * W1 steps: each warpgroup takes 32 of the chunk's hidden units, S =
//     xn W1^T (m64n32, K = C); after the last, + b1, tanh-GELU, rounded to
//     bf16 into one shared 64 x 64 tile h (128-byte swizzle).
//   * W2 steps: each warpgroup y[:, its 64 q .. + 63] += h W2^T (m64n64,
//     K = 64, A and B from shared memory).
//   * Every step ends in a block barrier, after which thread 0 refills the
//     slot the step before used (its products are done: wgmma.wait 1):
//     the barrier replaces a producer's empty barriers, and h is written
//     only after a barrier that follows the last read of the one before.
//   * Epilogue as above, over the whole block.
//
// The f32 version (mlp_fwd<TM, HC>) runs the same dataflow on the CUDA
// cores, y in shared memory: 64 tokens and 32 hidden units a step up to
// C = 256 (203 KB at C = 256), 16 and 16 above it (199 KB at C = 768);
// it is off the bf16 main path and held against the same plain version.
//
// What bounds it: 16*T*C^2 operations on 2*T*C*sizeof(T) bytes, so
// operations; the GELU's tanhf runs on the CUDA cores beside them. The
// wide design reads all of W1 and W2 (16 C^2 bytes) from L2 once a 64-token
// block, twice as often a token as the narrow one.
//
// Rounding points (as _mlp_math): xn after the f32 LN, h after the
// tanh-GELU of the f32 fc1 + b1, y after the fc2 bias, dp * y, and the
// residual sum.

#include "swin_attn_sm90.cuh"

namespace swin {

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

// f32 tiles: TM tokens a block, HC hidden units a step (multiples of 16:
// the 16 x 16 threads hold TM / 16 rows and HC / 16 or 4 columns each)
template <int TM, int HC>
__host__ __device__ inline size_t mlp_smem_floats(int C) {
  return 2 * TM                                  // mu, rstd
         + static_cast<size_t>(C) * (TM + 1)     // xn, k-major
         + static_cast<size_t>(TM) * (C + 1)     // y accumulator
         + static_cast<size_t>(C) * (HC + 1)     // W1 chunk, k-major
         + static_cast<size_t>(HC) * (C + 1)     // W2 chunk, k-major
         + static_cast<size_t>(HC) * (TM + 1);   // h chunk, k-major
}

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True)
  const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
  return v * (0.5f * (1.f + tanhf(inner)));
}

template <int TM, int HC>
__global__ void __launch_bounds__(kThreads) mlp_fwd(MlpArgs a) {
  constexpr int kLdT = TM + 1, kLdW1 = HC + 1;
  constexpr int RI = TM / 16, QH = HC / 16;
  extern __shared__ float smem[];
  const int C = a.C, Ch = a.Ch, ldy = C + 1;
  const long long t0 = static_cast<long long>(blockIdx.x) * TM;
  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;

  float* mu = smem;
  float* rstd = mu + TM;
  float* xnT = rstd + TM;                  // [C][kLdT]
  float* y = xnT + C * kLdT;               // [TM][ldy]
  float* w1T = y + TM * ldy;               // [C][kLdW1]
  float* w2T = w1T + C * kLdW1;            // [HC][ldy]
  float* hT = w2T + HC * ldy;              // [HC][kLdT]

  // 1. f32 LN statistics, one warp per token
  for (int t = warp; t < TM; t += kThreads / 32) {
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
  for (int i = tid; i < TM * C; i += kThreads) {
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

  for (int j0 = 0; j0 < Ch; j0 += HC) {
    // 3. stage W1 rows and W2 columns of this hidden chunk
    for (int i = tid; i < HC * C; i += kThreads) {
      const int j = i / C, k = i % C;
      w1T[k * kLdW1 + j] =
          j0 + j < Ch ? a.w1[static_cast<size_t>(j0 + j) * C + k]
                      : 0.f;
    }
    for (int i = tid; i < HC * C; i += kThreads) {
      const int n = i / HC, j = i % HC;
      w2T[j * ldy + n] =
          j0 + j < Ch ? a.w2[static_cast<size_t>(n) * Ch + j0 + j]
                      : 0.f;
    }
    __syncthreads();

    // 4. h = gelu_tanh(xn @ W1c^T + b1c): TM x HC, K = C
    float hacc[RI][QH];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int q = 0; q < QH; ++q) hacc[i][q] = 0.f;
    for (int k = 0; k < C; ++k) {
      float av[RI], bv[QH];
#pragma unroll
      for (int i = 0; i < RI; ++i) av[i] = xnT[k * kLdT + ty + 16 * i];
#pragma unroll
      for (int q = 0; q < QH; ++q) bv[q] = w1T[k * kLdW1 + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int q = 0; q < QH; ++q)
          hacc[i][q] = fmaf(av[i], bv[q], hacc[i][q]);
    }
#pragma unroll
    for (int q = 0; q < QH; ++q) {
      const int j = tx + 16 * q;
      const bool live = j0 + j < Ch;
      const float bias = live ? a.b1[j0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i)
        hT[j * kLdT + ty + 16 * i] =
            live ? gelu_tanh(hacc[i][q] + bias) : 0.f;
    }
    __syncthreads();

    // 5. y += h @ W2c^T: TM x C in column blocks of 64, K = HC
    for (int cb = 0; cb < C; cb += 64) {
      float yacc[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = cb + tx + 16 * q;
          yacc[i][q] = n < C ? y[(ty + 16 * i) * ldy + n] : 0.f;
        }
#pragma unroll 8
      for (int j = 0; j < HC; ++j) {
        float av[RI], bv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) av[i] = hT[j * kLdT + ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = cb + tx + 16 * q;
          bv[q] = n < C ? w2T[j * ldy + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            yacc[i][q] = fmaf(av[i], bv[q], yacc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
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
  for (int i = tid; i < TM * C; i += kThreads) {
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
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------
constexpr int kFwdM = 128;  // tokens a block: two consumer warpgroups
constexpr int kFwdJ = 64;   // hidden units a chunk (a stage of the ring)
using FwdRoles = WarpRoles<2>;

template <int C>
struct FwdCfg {
  static_assert(C % 32 == 0 && C >= 32 && C <= 256, "C % 32, <= 256");
  static constexpr int KC = (C + 63) / 64;          // 64-column atoms
  static constexpr int kXnBytes = KC * kFwdM * 128;  // the xn tile
  static constexpr int kW1Bytes = KC * kFwdJ * 128;  // W1 rows j0 .. + 63
  static constexpr int kW2Bytes = C * 128;           // W2's 64 columns
  static constexpr int kStageBytes = kW1Bytes + kW2Bytes;
  static constexpr int kFit = (200 * 1024 - kXnBytes) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  // y = P0 + P1 columns, each a wgmma width (P1 = 0, 32 or 64)
  static constexpr int P0 = C >= 192 ? 192 : C >= 128 ? 128 : C >= 64 ? 64
                                                                      : 32;
  static constexpr int P1 = C - P0;
  // S is taken SW hidden units at a time: fewer registers beside a wide y
  static constexpr int SW = C >= 192 ? 32 : 64;
  static constexpr int kLdY = C + 4;  // f32 pitch of the epilogue's tile
  static constexpr int kSmemBytes =
      kXnBytes + kStages * kStageBytes + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert(2 * 64 * kLdY * 4 <= kXnBytes + kStages * kStageBytes,
                "the epilogue's tiles must fit in xn and the stages");
};

struct FwdArgs {
  const bf16* x;
  bf16* out;
  const float *ln_s, *ln_b, *b1, *b2, *dp;
  int T, Ch;
  long long hw;
};

template <int C>
__global__ void __launch_bounds__(FwdRoles::kThreads, 1)
    mlp_fwd_sm90(const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2, FwdArgs a) {
  using K = FwdCfg<C>;
  unsigned char* sm = smem_base_1k();
  unsigned char* xn = sm;  // KC atoms of 128 rows x 128 bytes
  unsigned char* ring = sm + K::kXnBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::kStages *
                                               K::kStageBytes);
  uint64_t* empty = full + K::kStages;
  const int t0 = blockIdx.x * kFwdM;
  // hidden chunks, from a block-dependent first one: neighbouring blocks
  // read different weight chunks from L2 at any time
  const int nj = a.Ch / kFwdJ, j0 = blockIdx.x % nj;
  if (threadIdx.x == 0) {
    for (int i = 0; i < K::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], FwdRoles::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == FwdRoles::kProducerThread) {
      for (int j = 0; j < nj; ++j) {
        const int st = j % K::kStages;
        unsigned char* w1 = ring + st * K::kStageBytes;
        mbar_wait(&empty[st], ((j / K::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], K::kStageBytes);
        const int jc = ((j + j0) % nj) * kFwdJ;
        for (int kc = 0; kc < K::KC; ++kc)  // columns >= C read as zeros
          tma_load_2d(w1 + kc * kFwdJ * 128, &tw1, &full[st], kc * 64, jc);
        tma_load_2d(w1 + K::kW1Bytes, &tw2, &full[st], jc, 0);
      }
    }
    return;
  }
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;

  // 1. LN of the warpgroup's 64 rows (16 a warp), f32 statistics, xn
  //    rounded into the swizzled tile; lane l holds channels 8 l .. 8 l + 7
  {
    const int c = 8 * lane;
    const bool on = c < C;
    float sc[8], bi[8];
    if (on) {
      const float4 s0 = ldf4(a.ln_s + c), s1 = ldf4(a.ln_s + c + 4);
      const float4 b0 = ldf4(a.ln_b + c), b1 = ldf4(a.ln_b + c + 4);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[e] = sv[e];
        bi[e] = bv[e];
      }
    }
    // the warp's 16 rows are loaded first, so their loads overlap
    const int rw = wg * 64 + warp * 16;
    uint4 raw[16];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr)
      raw[rr] = on && t0 + rw + rr < a.T
                    ? ld16(a.x + static_cast<long long>(t0 + rw + rr) * C + c)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = rw + rr;
      float v[8];
      unpack8(raw[rr], v);
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        s2 += v[e] * v[e];
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float m = s / C;
      const float rs = 1.f / sqrtf(s2 / C - m * m + kLnEps);
      if (!on) continue;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = t0 + r < a.T ? (v[e] - m) * rs * sc[e] + bi[e] : 0.f;
      store8(reinterpret_cast<bf16*>(xn + (c >> 6) * kFwdM * 128 +
                                     sw128_off(r, c & 63)),
             o);
    }
  }
  fence_async_smem();
  wg_bar(wg);

  // 2. the hidden chunks; no instruction but wgmma touches y until the end
  constexpr int SW = K::SW;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float y0[K::P0 / 2], y1[K::P1 ? K::P1 / 2 : 2];
  uint32_t ha[SW / 16][4];
  for (int j = 0; j < nj; ++j) {
    const int st = j % K::kStages;
    unsigned char* w1 = ring + st * K::kStageBytes;
    unsigned char* w2 = w1 + K::kW1Bytes;
    mbar_wait_warp(&full[st], (j / K::kStages) & 1);
#pragma unroll
    for (int h = 0; h < kFwdJ / SW; ++h) {
      // S = xn W1^T for hidden units j0 + h SW .. + SW - 1 (64 x SW, K = C)
      float sacc[SW / 2];
      wg_fence();
#pragma unroll
      for (int k = 0; k < C / 16; ++k) {
        const int kc = k / 4, ks = k % 4;
        Wg<SW>::template ss<0, 0>(
            sacc,
            sw128_desc(xn + kc * kFwdM * 128 + wg * 64 * 128) +
                ks * kDescKStep,
            sw128_desc(w1 + kc * kFwdJ * 128 + h * SW * 128) +
                ks * kDescKStep,
            k > 0);
      }
      wg_commit();
      wg_wait<0>();  // also the previous piece's y products
      fence_regs(sacc);
      fence_regs(ha);
      // + b1, tanh-GELU; rounded to bf16 as the A fragments of fc2
#pragma unroll
      for (int i = 0; i < SW / 8; ++i) {
        const int n = ((j + j0) % nj) * kFwdJ + h * SW + 8 * i + c0;
        const float bias[2] = {a.b1[n], a.b1[n + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[4 * i + e] = gelu_tanh(sacc[4 * i + e] + bias[e & 1]);
      }
      acc_to_a(ha, sacc);
      fence_regs(ha);
      // y += h W2^T (K = SW hidden units; W2's chunk is C rows x 64)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < SW / 16; ++kk) {
        const int kq = h * (SW / 16) + kk;
        const int acc = j > 0 || kq > 0;
        Wg<K::P0>::template rs<0>(y0, ha[kk],
                                  sw128_desc(w2) + kq * kDescKStep, acc);
        if constexpr (K::P1 > 0)
          Wg<K::P1>::template rs<0>(
              y1, ha[kk], sw128_desc(w2 + K::P0 * 128) + kq * kDescKStep,
              acc);
      }
      wg_commit();
    }
    wg_wait<0>();  // the chunk's products are done: hand its stage back
    fence_regs(ha);
    warp_arrive(&empty[st]);
  }
  fence_regs(y0);
  fence_regs(y1);

  // 3. epilogue: both warpgroups are done with xn and the ring, which hold
  //    the f32 tiles now; a row's 8 neighbouring columns a thread
  asm volatile("bar.sync 3, %0;\n" ::"n"(2 * kWgThreads) : "memory");
  float* yt = reinterpret_cast<float*>(sm) + wg * 64 * K::kLdY;
#pragma unroll
  for (int i = 0; i < K::P0 / 8; ++i) {
    *reinterpret_cast<float2*>(yt + r0 * K::kLdY + 8 * i + c0) =
        make_float2(y0[4 * i], y0[4 * i + 1]);
    *reinterpret_cast<float2*>(yt + (r0 + 8) * K::kLdY + 8 * i + c0) =
        make_float2(y0[4 * i + 2], y0[4 * i + 3]);
  }
  if constexpr (K::P1 > 0) {
#pragma unroll
    for (int i = 0; i < K::P1 / 8; ++i) {
      const int col = K::P0 + 8 * i + c0;
      *reinterpret_cast<float2*>(yt + r0 * K::kLdY + col) =
          make_float2(y1[4 * i], y1[4 * i + 1]);
      *reinterpret_cast<float2*>(yt + (r0 + 8) * K::kLdY + col) =
          make_float2(y1[4 * i + 2], y1[4 * i + 3]);
    }
  }
  wg_bar(wg);
  for (int q = tid; q < 64 * (C / 8); q += kWgThreads) {
    const int r = q / (C / 8), c = (q % (C / 8)) * 8;
    const int tok = t0 + wg * 64 + r;
    if (tok >= a.T) continue;
    const float dpv = round_bf16(a.dp ? a.dp[tok / a.hw] : 1.f);
    const long long idx = static_cast<long long>(tok) * C + c;
    const float4 lo = *reinterpret_cast<const float4*>(yt + r * K::kLdY + c);
    const float4 hi =
        *reinterpret_cast<const float4*>(yt + r * K::kLdY + c + 4);
    const float yv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float4 b0 = ldf4(a.b2 + c), b1 = ldf4(a.b2 + c + 4);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float xs[8], o[8];
    unpack8(ld16(a.x + idx), xs);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = xs[e] + round_bf16(dpv * round_bf16(yv[e] + bv[e]));
    store8(a.out + idx, o);
  }
}

template <int C>
int launch_fwd_sm90(const CUtensorMap& tw1, const CUtensorMap& tw2,
                    const FwdArgs& a, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  SWIN_TRY(smem_limit_once(smem_set,
                           reinterpret_cast<const void*>(mlp_fwd_sm90<C>),
                           FwdCfg<C>::kSmemBytes));
  mlp_fwd_sm90<C><<<(a.T + kFwdM - 1) / kFwdM, FwdRoles::kThreads,
                    FwdCfg<C>::kSmemBytes, s>>>(tw1, tw2, a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, C = 384, 512, 768: two warpgroups share 64 tokens, no producer warp
// ---------------------------------------------------------------------------
constexpr int kWideM = 64;                      // tokens a block
constexpr int kWideThreads = 2 * kWgThreads;    // both warpgroups consume
constexpr int kPiece = 64 * 128;                // a 64 x 64 bf16 TMA box
constexpr int kWideStep = 2 * kPiece;           // two boxes a step

template <int C>
struct WideCfg {
  static_assert(C % 128 == 0 && C > 256 && C <= 768,
                "C % 128 == 0, 256 < C <= 768");
  static constexpr int KC = C / 64;       // xn atoms; steps a hidden chunk
  static constexpr int kHalf = KC / 2;    // W1 steps, then as many W2 steps
  static constexpr int kXnBytes = KC * kPiece;  // xn, 64 x C
  static constexpr int kFit =
      (227 * 1024 - 1024 - kXnBytes - kPiece - 64) / kWideStep;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kRingBytes = kStages * kWideStep;
  static constexpr int kLdY = C + 4;  // f32 pitch of the epilogue's tile
  static constexpr int kSmemBytes =
      kXnBytes + kPiece + kRingBytes + 8 * kStages + 1024;
  // h is rewritten after the barrier of the chunk's first W1 step, which
  // follows both warpgroups' last reads of the h before
  static_assert(kHalf >= 2, "at least two W1 steps a chunk");
  static_assert(kStages >= 3, "a ring of at least three steps");
  static_assert(64 * kLdY * 4 <= kXnBytes + kPiece + kRingBytes,
                "the epilogue's tile must fit in xn, h and the ring");
};

// Step s of a block: hidden chunk s / KC (from the block's first chunk
// j0), pair t = s % KC of its boxes: W1's chunk rows x k-columns 128 t ..
// + 127 for t < KC / 2, else W2's rows 64 q .. + 63 and C / 2 + 64 q ..
// (q = t - KC / 2: each warpgroup's output columns) x the chunk's 64
// columns.
template <int C>
__device__ __forceinline__ void wide_load(const CUtensorMap* tw1,
                                          const CUtensorMap* tw2,
                                          unsigned char* ring,
                                          uint64_t* full, int s, int steps,
                                          int nj, int j0) {
  using K = WideCfg<C>;
  if (s >= steps) return;
  const int st = s % K::kStages, t = s % K::KC;
  const int jc = ((s / K::KC + j0) % nj) * 64;
  unsigned char* p = ring + st * kWideStep;
  mbar_expect_tx(&full[st], kWideStep);
  if (t < K::kHalf) {
    tma_load_2d(p, tw1, &full[st], 128 * t, jc);
    tma_load_2d(p + kPiece, tw1, &full[st], 128 * t + 64, jc);
  } else {
    const int q = t - K::kHalf;
    tma_load_2d(p, tw2, &full[st], jc, 64 * q);
    tma_load_2d(p + kPiece, tw2, &full[st], jc, C / 2 + 64 * q);
  }
}

template <int C>
__global__ void __launch_bounds__(kWideThreads, 1)
    mlp_fwd_wide_sm90(const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw2, FwdArgs a) {
  using K = WideCfg<C>;
  unsigned char* sm = smem_base_1k();
  unsigned char* xn = sm;                      // KC atoms of 64 x 128 bytes
  unsigned char* hs = sm + K::kXnBytes;        // the GELU'd chunk, 64 x 64
  unsigned char* ring = hs + kPiece;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::kRingBytes);
  const int t0 = blockIdx.x * kWideM;
  // hidden chunks, from a block-dependent first one (as mlp_fwd_sm90)
  const int nj = a.Ch / 64, j0 = blockIdx.x % nj, steps = nj * K::KC;
  if (threadIdx.x == 0) {
    for (int i = 0; i < K::kStages; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)  // the ring's first steps load beside the LN
    for (int s = 0; s < K::kStages - 1; ++s)
      wide_load<C>(&tw1, &tw2, ring, full, s, steps, nj, j0);
  const int wg = warpgroup_index();
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;

  // 1. LN of the 64 rows (8 a warp), f32 statistics, xn rounded into the
  //    swizzled tile; lane l holds channels 8 l + 256 g .. + 7
  {
    constexpr int G = (C + 255) / 256;
    float sc[G][8], bi[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 8 * lane + 256 * g;
      if (c >= C) continue;
      const float4 s0 = ldf4(a.ln_s + c), s1 = ldf4(a.ln_s + c + 4);
      const float4 b0 = ldf4(a.ln_b + c), b1 = ldf4(a.ln_b + c + 4);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[g][e] = sv[e];
        bi[g][e] = bv[e];
      }
    }
    const int rw = (threadIdx.x >> 5) * 8;
    uint4 raw[8][G];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 8 * lane + 256 * g;
        raw[rr][g] =
            c < C && t0 + rw + rr < a.T
                ? ld16(a.x + static_cast<long long>(t0 + rw + rr) * C + c)
                : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = rw + rr;
      float v[G][8];
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        unpack8(raw[rr][g], v[g]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[g][e];
          s2 += v[g][e] * v[g][e];
        }
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float m = s / C;
      const float rs = 1.f / sqrtf(s2 / C - m * m + kLnEps);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 8 * lane + 256 * g;
        if (c >= C) continue;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = t0 + r < a.T ? (v[g][e] - m) * rs * sc[g][e] + bi[g][e]
                              : 0.f;
        store8(reinterpret_cast<bf16*>(xn + (c >> 6) * kPiece +
                                       sw128_off(r, c & 63)),
               o);
      }
    }
  }
  fence_async_smem();
  __syncthreads();

  // 2. the hidden chunks; no instruction but wgmma touches y until the end
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float y[K::kHalf][32];
  int s = 0;
  for (int j = 0; j < nj; ++j) {
    const int jc = ((j + j0) % nj) * 64;
    float sacc[16];
#pragma unroll
    for (int t = 0; t < K::kHalf; ++t, ++s) {
      // S = xn W1^T for hidden units jc + 32 wg .. + 31 (64 x 32), the
      // k-columns 128 t .. + 127 of this step
      const int st = s % K::kStages;
      unsigned char* p = ring + st * kWideStep + wg * 32 * 128;
      mbar_wait_warp(&full[st], (s / K::kStages) & 1);
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wg<32>::ss<0, 0>(
              sacc, sw128_desc(xn + (2 * t + h) * kPiece) + ks * kDescKStep,
              sw128_desc(p + h * kPiece) + ks * kDescKStep,
              t > 0 || h > 0 || ks > 0);
      wg_commit();
      if (t + 1 < K::kHalf) {
        wg_wait<1>();  // the step before is done: its slot is refilled
      } else {
        wg_wait<0>();
        fence_regs(sacc);
        // + b1, tanh-GELU; rounded to bf16 into this warpgroup's 32
        // columns of the shared chunk
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = wg * 32 + 8 * i + c0;
          const float b0 = a.b1[jc + col], b1 = a.b1[jc + col + 1];
          store_bf16x2(reinterpret_cast<bf16*>(hs + sw128_off(r0, col)),
                       gelu_tanh(sacc[4 * i] + b0),
                       gelu_tanh(sacc[4 * i + 1] + b1));
          store_bf16x2(reinterpret_cast<bf16*>(hs + sw128_off(r0 + 8, col)),
                       gelu_tanh(sacc[4 * i + 2] + b0),
                       gelu_tanh(sacc[4 * i + 3] + b1));
        }
        fence_async_smem();
      }
      __syncthreads();
      if (threadIdx.x == 0)
        wide_load<C>(&tw1, &tw2, ring, full, s + K::kStages - 1, steps, nj,
                      j0);
    }
#pragma unroll
    for (int q = 0; q < K::kHalf; ++q, ++s) {
      // y[:, wg C / 2 + 64 q .. + 63] += h W2^T (K = the chunk's 64 units)
      const int st = s % K::kStages;
      unsigned char* p = ring + st * kWideStep + wg * kPiece;
      mbar_wait_warp(&full[st], (s / K::kStages) & 1);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wg<64>::ss<0, 0>(y[q], sw128_desc(hs) + ks * kDescKStep,
                         sw128_desc(p) + ks * kDescKStep, j > 0 || ks > 0);
      wg_commit();
      wg_wait<1>();
      __syncthreads();
      if (threadIdx.x == 0)
        wide_load<C>(&tw1, &tw2, ring, full, s + K::kStages - 1, steps, nj,
                      j0);
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int q = 0; q < K::kHalf; ++q) fence_regs(y[q]);

  // 3. epilogue: every product and load is done; the f32 tile of the 64
  //    rows over xn, h and the ring; a row's 8 neighbouring columns a thread
  __syncthreads();
  float* yt = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int q = 0; q < K::kHalf; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = wg * (C / 2) + 64 * q + 8 * i + c0;
      *reinterpret_cast<float2*>(yt + r0 * K::kLdY + col) =
          make_float2(y[q][4 * i], y[q][4 * i + 1]);
      *reinterpret_cast<float2*>(yt + (r0 + 8) * K::kLdY + col) =
          make_float2(y[q][4 * i + 2], y[q][4 * i + 3]);
    }
  __syncthreads();
  for (int q = threadIdx.x; q < kWideM * (C / 8); q += kWideThreads) {
    const int r = q / (C / 8), c = (q % (C / 8)) * 8;
    const int tok = t0 + r;
    if (tok >= a.T) continue;
    const float dpv = round_bf16(a.dp ? a.dp[tok / a.hw] : 1.f);
    const long long idx = static_cast<long long>(tok) * C + c;
    const float4 lo = *reinterpret_cast<const float4*>(yt + r * K::kLdY + c);
    const float4 hi =
        *reinterpret_cast<const float4*>(yt + r * K::kLdY + c + 4);
    const float yv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float4 b0 = ldf4(a.b2 + c), b1 = ldf4(a.b2 + c + 4);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float xs[8], o[8];
    unpack8(ld16(a.x + idx), xs);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = xs[e] + round_bf16(dpv * round_bf16(yv[e] + bv[e]));
    store8(a.out + idx, o);
  }
}

template <int C>
int launch_fwd_wide_sm90(const CUtensorMap& tw1, const CUtensorMap& tw2,
                         const FwdArgs& a, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  SWIN_TRY(smem_limit_once(
      smem_set, reinterpret_cast<const void*>(mlp_fwd_wide_sm90<C>),
      WideCfg<C>::kSmemBytes));
  mlp_fwd_wide_sm90<C><<<(a.T + kWideM - 1) / kWideM, kWideThreads,
                         WideCfg<C>::kSmemBytes, s>>>(tw1, tw2, a);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 workspace: the bf16 copies of W1 and W2
struct FwdWork {
  bf16 *w1b, *w2b;
  FwdWork(Carver& cv, int C, int Ch) {
    w1b = cv.take<bf16>(static_cast<size_t>(Ch) * C);
    w2b = cv.take<bf16>(static_cast<size_t>(C) * Ch);
  }
};

int launch_mlp_bf16(const MlpArgs& a, void* work, cudaStream_t s) {
  const int C = a.C, Ch = a.Ch;
  Carver cv{static_cast<char*>(work)};
  const FwdWork w(cv, C, Ch);
  const long long nw = static_cast<long long>(Ch) * C;
  SWIN_TRY(launch_cast_weights<K2f>(a.w1, nw, a.w2, nw, w.w1b, w.w2b, s));
  const bool wide = mlp_wide_c(C);
  CUtensorMap tw1, tw2;
  SWIN_TRY(make_map_2d(&tw1, w.w1b, C, Ch, C, kFwdJ));
  // the wide kernel takes W2's chunk in boxes of 64 rows, the other whole
  SWIN_TRY(make_map_2d(&tw2, w.w2b, Ch, C, Ch, wide ? 64 : C));
  const FwdArgs fa{static_cast<const bf16*>(a.x), static_cast<bf16*>(a.out),
                   a.ln_s, a.ln_b, a.b1, a.b2, a.dp,
                   static_cast<int>(a.T), Ch, a.hw};
  switch (C) {
    case 32: return launch_fwd_sm90<32>(tw1, tw2, fa, s);
    case 64: return launch_fwd_sm90<64>(tw1, tw2, fa, s);
    case 96: return launch_fwd_sm90<96>(tw1, tw2, fa, s);
    case 128: return launch_fwd_sm90<128>(tw1, tw2, fa, s);
    case 160: return launch_fwd_sm90<160>(tw1, tw2, fa, s);
    case 192: return launch_fwd_sm90<192>(tw1, tw2, fa, s);
    case 224: return launch_fwd_sm90<224>(tw1, tw2, fa, s);
    case 256: return launch_fwd_sm90<256>(tw1, tw2, fa, s);
    case 384: return launch_fwd_wide_sm90<384>(tw1, tw2, fa, s);
    case 512: return launch_fwd_wide_sm90<512>(tw1, tw2, fa, s);
    case 768: return launch_fwd_wide_sm90<768>(tw1, tw2, fa, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int TM, int HC>
int launch_mlp_f32_tile(const MlpArgs& a, cudaStream_t stream) {
  const size_t bytes = mlp_smem_floats<TM, HC>(a.C) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd<TM, HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {  // e.g. more shared memory than a block may use
    cudaGetLastError();      // clear it, so the next launch reads its own
    return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((a.T + TM - 1) / TM);
  mlp_fwd<TM, HC><<<blocks, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// f32: 64 tokens and 32 hidden units a step up to C = 256; fewer above,
// where y and xn of 64 tokens would not fit in shared memory
int launch_mlp_f32(const MlpArgs& a, cudaStream_t stream) {
  return a.C <= 256 ? launch_mlp_f32_tile<64, 32>(a, stream)
                    : launch_mlp_f32_tile<16, 16>(a, stream);
}

// what the bf16 kernel takes: C % 32 == 0 up to 256 or mlp_wide_c, whole
// hidden chunks, int token indices (f32: whatever fits its shared memory,
// checked at launch)
bool mlp_fwd_dims_ok(long long T, int C, int Ch, int is_bf16) {
  if (T < 1 || C < 1 || Ch < 1) return false;
  return !is_bf16 || (((C % 32 == 0 && C <= 256) || mlp_wide_c(C)) &&
                      Ch % kFwdJ == 0 && T < (1LL << 31));
}

}  // namespace swin

extern "C" long long swin_mlp_fwd_workspace(int C, int Ch, int is_bf16) {
  if (!swin::mlp_fwd_dims_ok(1, C, Ch, is_bf16) || !is_bf16) return 0;
  swin::Carver cv{nullptr};
  swin::FwdWork w(cv, C, Ch);
  return static_cast<long long>(cv.off);
}

extern "C" int swin_mlp_fwd(const void* x, void* out, void* work,
                            const float* ln_s, const float* ln_b,
                            const float* w1, const float* b1,
                            const float* w2, const float* b2,
                            const float* dp, long long T, int C, int Ch,
                            int hw, int is_bf16, void* stream) {
  if (!swin::mlp_fwd_dims_ok(T, C, Ch, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  swin::MlpArgs a{x, out, ln_s, ln_b, w1, b1, w2, b2, dp, T, C, Ch, hw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::launch_mlp_bf16(a, work, s)
                 : swin::launch_mlp_f32(a, s);
}
