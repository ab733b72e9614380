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
// Wider C (bf16, every C % 32 == 0 in (256, kMlpMaxC]: the widths the JAX
// package fuses under FMC_FUSED_MLP_MAX_C; C comes in at run time). y no
// longer fits in registers beside a 128-token tile, nor a hidden chunk's
// weights in shared memory beside xn, so the branch runs as three passes:
//   1. ln_rows_bf16 (swin_attn_sm90.cuh): xn = LN2(x), f32 statistics,
//      rounded, into a [T, C] workspace.
//   2. gemm_run (sm90_gemm.cuh): xn W1^T; its epilogue adds b1, applies
//      the tanh-GELU and rounds h into a [T, Ch] workspace (EpiGeluBf16).
//   3. gemm_run: h W2^T; its epilogue rounds y + b2, scales by dp of the
//      token's sample, adds the residual and stores 16 bytes a thread
//      (EpiResidualBf16).
// _mlp_math rounds h to bf16 at exactly that point, so h's round trip
// through device memory changes no value. Both products run 128-token
// tiles with a producer warp feeding a TMA ring (full / empty barriers)
// and two consumer warpgroups on wgmma, so each block reads its weight
// slice once per 128 tokens and copies overlap the products. fc2 has
// only C / 128 column tiles: at C = 768 and 2,048
// tokens (swin_t 512^2 stage 3) 96 blocks of 128 x 128 would leave a
// quarter of the 132 SMs idle, so gemm_pick_bn narrows the tile to 96
// (128 blocks, one wave). Split-K was not taken: its f32 partials and
// their ordered sum would move more bytes than the idle SMs cost, and a
// 64-row tile leaves the same last wave (192 blocks of half the work).
//
// The f32 version (mlp_fwd<TM, HC>) runs the dataflow of the narrow bf16
// kernel on the CUDA cores, y in shared memory: 64 tokens and 32 hidden
// units a step up to C = 256 (203 KB at C = 256), 16 and 16 above it
// (199 KB at C = 768; C <= 875 fits: ops/swin_block.py MLP_F32_MAX_C);
// it is off the bf16 main path and held against the same plain version.
//
// What bounds it: 16*T*C^2 operations on 2*T*C*sizeof(T) bytes, so
// operations; the GELU's tanhf runs on the CUDA cores beside them. Above
// C = 256, xn and h add 4*T*C + 16*T*C bytes of round trips (h's time is
// at most 295 / C of the operation bound: 0.58 at C = 512), and each
// product reads its weights from L2 once per 128-token tile (8 C^2
// bytes).
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

// the same with tanh_fast (K2f above C = 256)
__device__ __forceinline__ float gelu_tanh_fast(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
  return v * (0.5f * (1.f + tanh_fast(inner)));
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
// bf16 above C = 256: LN rows, then fc1 and fc2 as two products
// ---------------------------------------------------------------------------
// fc1's epilogue: h[m, n .. n + 7] = round(gelu_tanh(v + b1[n])), tanh on
// the special-function unit (tanh_fast)
struct EpiGeluBf16 {
  bf16* h;
  int ld;
  const float* b1;
  __device__ void operator()(int m, int n, int, const float (&v)[8]) const {
    const float4 c0 = ldf4(b1 + n), c1 = ldf4(b1 + n + 4);
    const float bv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = gelu_tanh_fast(v[e] + bv[e]);
    store8(h + static_cast<long long>(m) * ld + n, o);
  }
};

// fc2's epilogue, the residual: out[m, n .. n + 7] = x + round(round(dp)
// round(v + b2[n])), dp of token m's sample (a tile may cross samples)
struct EpiResidualBf16 {
  const bf16* x;
  bf16* out;
  const float *b2, *dp;
  long long hw;
  int C;
  __device__ void operator()(int m, int n, int, const float (&v)[8]) const {
    const float dpv = round_bf16(dp ? dp[m / hw] : 1.f);
    const long long idx = static_cast<long long>(m) * C + n;
    const float4 c0 = ldf4(b2 + n), c1 = ldf4(b2 + n + 4);
    const float bv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    float xs[8], o[8];
    unpack8(ld16(x + idx), xs);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = xs[e] + round_bf16(dpv * round_bf16(v[e] + bv[e]));
    store8(out + idx, o);
  }
};

// A K2f product over its whole depth K (one slot), both operands K-major
// as they lie, in the N tile gemm_pick_bn chooses for M x N. Two blocks an
// SM: fc1's depth is only C (8 k-chunks at C = 512), so a block's prologue
// and GELU epilogue last about as long as its products and are hidden
// behind the other block's. Neighbouring blocks take the N tiles of one
// token tile: the weights stay in L2 and each token tile of xn or h is
// read from device memory once.
template <class Epi>
int k2f_product(const bf16* A, int lda, const bf16* B, int ldb, int M,
                int N, int K, Epi epi, cudaStream_t s) {
  const int kchunk = (K + kGemmK - 1) / kGemmK * kGemmK;
  switch (gemm_pick_bn(M, N)) {
    case 96:
      return gemm_run<false, false, K2f, 96, true>(A, lda, B, ldb, M, N,
                                                   K, kchunk, epi, s);
    case 64:
      return gemm_run<false, false, K2f, 64, true>(A, lda, B, ldb, M, N,
                                                   K, kchunk, epi, s);
    default:
      return gemm_run<false, false, K2f, 128, true>(A, lda, B, ldb, M, N,
                                                    K, kchunk, epi, s);
  }
}

// the bf16 workspace, carved in one order for measuring and for use (the
// same order as ops/swin_block.py mlp_fwd_plan): the bf16 copies of W1
// and W2; above C = 256 also xn [T, C] and h [T, Ch]
struct FwdWork {
  bf16 *w1b, *w2b, *xn = nullptr, *h = nullptr;
  FwdWork(Carver& cv, long long T, int C, int Ch) {
    w1b = cv.take<bf16>(static_cast<size_t>(Ch) * C);
    w2b = cv.take<bf16>(static_cast<size_t>(C) * Ch);
    if (C > 256) {
      xn = cv.take<bf16>(static_cast<size_t>(T) * C);
      h = cv.take<bf16>(static_cast<size_t>(T) * Ch);
    }
  }
};

int launch_mlp_bf16(const MlpArgs& a, void* work, cudaStream_t s) {
  const int C = a.C, Ch = a.Ch, T = static_cast<int>(a.T);
  Carver cv{static_cast<char*>(work)};
  const FwdWork w(cv, T, C, Ch);
  const long long nw = static_cast<long long>(Ch) * C;
  SWIN_TRY(launch_cast_weights<K2f>(a.w1, nw, a.w2, nw, w.w1b, w.w2b, s));
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);
  if (C > 256) {
    SWIN_TRY(launch_ln_rows_bf16<K2f>(x, a.ln_s, a.ln_b, w.xn, nullptr,
                                      nullptr, T, C, s));
    SWIN_TRY(k2f_product(w.xn, C, w.w1b, C, T, Ch, C,
                         EpiGeluBf16{w.h, Ch, a.b1}, s));
    return k2f_product(w.h, Ch, w.w2b, Ch, T, C, Ch,
                       EpiResidualBf16{x, out, a.b2, a.dp, a.hw, C}, s);
  }
  CUtensorMap tw1, tw2;
  SWIN_TRY(make_map_2d(&tw1, w.w1b, C, Ch, C, kFwdJ));
  SWIN_TRY(make_map_2d(&tw2, w.w2b, Ch, C, Ch, C));
  const FwdArgs fa{x, out, a.ln_s, a.ln_b, a.b1, a.b2, a.dp, T, Ch, a.hw};
  switch (C) {
    case 32: return launch_fwd_sm90<32>(tw1, tw2, fa, s);
    case 64: return launch_fwd_sm90<64>(tw1, tw2, fa, s);
    case 96: return launch_fwd_sm90<96>(tw1, tw2, fa, s);
    case 128: return launch_fwd_sm90<128>(tw1, tw2, fa, s);
    case 160: return launch_fwd_sm90<160>(tw1, tw2, fa, s);
    case 192: return launch_fwd_sm90<192>(tw1, tw2, fa, s);
    case 224: return launch_fwd_sm90<224>(tw1, tw2, fa, s);
    case 256: return launch_fwd_sm90<256>(tw1, tw2, fa, s);
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

// what the bf16 kernels take: C % 32 == 0 up to kMlpMaxC (the narrow
// instances up to 256, the two products above), whole hidden chunks, int
// token indices (f32: whatever fits its shared memory, checked at launch)
bool mlp_fwd_dims_ok(long long T, int C, int Ch, int is_bf16) {
  if (T < 1 || C < 1 || Ch < 1) return false;
  return !is_bf16 ||
         (mlp_bf16_c(C) && Ch % kFwdJ == 0 && T < (1LL << 31));
}

}  // namespace swin

// Bytes of the workspace (0 in f32 and for widths the kernels do not
// take). The host sizes it with its own mirror (ops/swin_block.py
// mlp_fwd_plan); the launch refuses a buffer smaller than this.
extern "C" long long swin_mlp_fwd_workspace(long long T, int C, int Ch,
                                            int is_bf16) {
  if (!swin::mlp_fwd_dims_ok(T, C, Ch, is_bf16) || !is_bf16) return 0;
  swin::Carver cv{nullptr};
  swin::FwdWork w(cv, T, C, Ch);
  return static_cast<long long>(cv.off);
}

extern "C" int swin_mlp_fwd(const void* x, void* out, void* work,
                            long long work_bytes, const float* ln_s,
                            const float* ln_b, const float* w1,
                            const float* b1, const float* w2,
                            const float* b2, const float* dp, long long T,
                            int C, int Ch, int hw, int is_bf16,
                            void* stream) {
  if (!swin::mlp_fwd_dims_ok(T, C, Ch, is_bf16) ||
      work_bytes < swin_mlp_fwd_workspace(T, C, Ch, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  swin::MlpArgs a{x, out, ln_s, ln_b, w1, b1, w2, b2, dp, T, C, Ch, hw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::launch_mlp_bf16(a, work, s)
                 : swin::launch_mlp_f32(a, s);
}
