// Fused Swin MLP branch, backward (K2b), for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/swin_block_pallas.py
// _fused_mlp_bwd -> _mlp_bwd_kernel -> _mlp_pullback: the pullback of
// out = x + dp * fc2(gelu_tanh(fc1(LN2(x)))) on tokens x [T, C] for the
// cotangent dy. Returns dx (identity path included) and f32 dLN scale/bias,
// dW1 [4C, C], db1, dW2 [C, 4C], db2; dp gets no gradient.
//
// Design (bf16). The TPU kernel recomputes the forward of a token tile in
// VMEM, pulls it back, and carries the weight-gradient sums across its
// sequential grid. Hopper blocks run in parallel, so the pullback runs as
// passes over all tokens (Ch = 4C hidden units, Ch % 64 == 0; C % 32 == 0
// up to kMlpMaxC, C at run time above 256):
//
//   1. cast_weights: W1 and W2 rounded to bf16 once a call (TMA reads
//      bf16; the port's params are f32).
//   2. ln_rows_bf16: f32 LN statistics and xn = LN2(x), rounded;
//      scale_rows_bf16: dyc = dy * dp, rounded.
//   3. mlp_dual_sm90: one block per 128-token tile. A producer warp brings
//      the tile's xn and dyc once (128 x C each, kept in shared memory) and
//      then streams W1's rows and W2's columns of one 64-unit block of the
//      hidden width at a time, a 64-deep k-chunk a stage, through a ring.
//      Two consumer warpgroups (64 rows each) accumulate both products of
//      a hidden block over the same K = C on wgmma: A1 = xn W1^T and
//      A2 = dyc W2 (m64n64, W2 read MN-major as it lies). The epilogue
//      forms h1 = A1 + b1, gc = round(gelu(h1)), dh1 = gelu'(h1) A2 (f32)
//      and dh1c = round(dh1), stores gc and dh1c, and writes db1's column
//      partial of the f32 dh1 over the tile's 128 rows: one slot a tile.
//      No T x 4C f32 buffer exists.
//      Above C = 256 (mlp_dual_wide_sm90) a tile's xn and dyc stream
//      through the ring with the weights; a block-step takes 128 hidden
//      units (m64n128), and a cluster of two blocks, neighbouring hidden
//      groups of one tile, shares each k-chunk of xn and dyc by TMA
//      multicast; the same epilogue and db1 slots (one per tile).
//   4. gemm_run (sm90_gemm.cuh), split over tokens (ops/swin_block.py
//      split_k_plan): dW2 = dyc^T gc and dW1 = dh1c^T xn as per-slot f32
//      partials, both operands read MN-major as they lie.
//   5. gemm_run: dxn = dh1c W1 (f32); ln_bwd_rows: dx and dLN partials;
//      colsum_bf16: db2 of dyc.
//   6. reduce_slots: dW1, dW2 and db1, slots added in index order.
//
// No atomics: every gradient sum is deterministic. The f32 version runs
// the pullback as swin_bwd_common.cuh's CUDA-core passes, with h1 kept in
// f32 in the workspace; it is off the bf16 main path and held against the
// same plain version.
//
// What bounds it: the products are 40*C^2 operations per token (fc1 is
// recomputed; fc2's output is not needed); the passes move about 72*C
// bytes per token (xn, dyc, gc and dh1c, each written once and read once
// or twice, dxn in f32, x, dy and dx), so at C <= 256 their bytes
// outweigh the products on this card (at C = 512 the products, 40 C^2 =
// 10.5 M operations a token, and the bytes, 36.9 KB, are about even). The
// dual product keeps h1 and the
// f32 dh1 on chip; its epilogue stages gc and dh1c in shared memory for
// 16-byte row stores, and each block starts at its own hidden block, so
// that the SMs do not all read one weight chunk from L2 at once.
//
// Rounding points (as _mlp_pullback): xn; the GELU output; dyc; dh1 before
// its products (db1 sums it in f32); dx before the identity-path add, and
// the sum.

#include "swin_attn_sm90.cuh"

namespace swin {

constexpr float kGeluK = 0.7978845608028654f;  // sqrt(2 / pi)

// jax.nn.gelu (approximate=True): x * 0.5 * (1 + tanh(k (x + 0.044715 x^3)))
// and its derivative from t = that tanh
__device__ __forceinline__ float gelu_from_tanh(float h, float t,
                                                float* grad) {
  *grad = 0.5f * (1.f + t) +
          0.5f * h * (1.f - t * t) * kGeluK * (1.f + 3.f * 0.044715f * h * h);
  return h * (0.5f * (1.f + t));
}

__device__ __forceinline__ float gelu_tanh(float h, float* grad) {
  return gelu_from_tanh(h, tanhf(kGeluK * (h + 0.044715f * (h * h * h))),
                        grad);
}

// the same with tanh_fast (mlp_dual_wide_sm90)
__device__ __forceinline__ float gelu_tanh_fast(float h, float* grad) {
  return gelu_from_tanh(
      h, tanh_fast(kGeluK * (h + 0.044715f * (h * h * h))), grad);
}

// ---- the dual product (bf16) ------------------------------------------------
constexpr int kDualM = 128, kDualN = 64;  // tokens a block, hidden units a step
constexpr int kDualStages = 3;
constexpr int kDualLdO = kDualN + 8;  // bf16 pitch of the staged outputs
using DualRoles = WarpRoles<2>;

template <int KC>  // k-chunks of 64: KC = ceil(C / 64)
struct DualSmem {  // at the 1024-aligned start of dynamic shared memory
  bf16 xn[KC][kDualM * 64];  // the tile's xn and dyc, 16 KB a chunk
  bf16 dy[KC][kDualM * 64];
  bf16 w1[kDualStages][kDualN * 64];  // W1 rows n0.., 64 k: K-major
  bf16 w2[kDualStages][64 * kDualN];  // W2 rows k0.. x 64 units: MN-major
  float colsum[2][8][kDualN];  // db1 partials of the 8 consumer warps
  bf16 out[2][2][64 * kDualLdO];  // gc, dh1c of each warpgroup, staged
  uint64_t tile, full[kDualStages], empty[kDualStages];
};
template <int KC>
constexpr int dual_smem_bytes() {
  return static_cast<int>(sizeof(DualSmem<KC>)) + 1024;
}
constexpr uint32_t kDualStageBytes = 2 * kDualN * 64 * 2;

struct DualArgs {
  bf16* gc;          // [T, Ch]
  bf16* dh1c;        // [T, Ch]
  float* p_b1;       // [tiles, Ch]: db1's column partial of each tile
  const float* b1;   // [Ch]
  int T, Ch;
};

// The dual product's epilogue of one hidden block n0 .. n0 + 63 of the
// 128-token tile at m0 (warpgroup wg's 64 rows; `buf` alternates the
// column-sum buffer between hidden blocks): element 4 i + e at row rl +
// 8 (e / 2) of the warpgroup, column 8 i + c0 + e % 2 of the block
// (sm90_common.cuh acc_to_a). gc and dh1c go through shared memory, so
// that a row's 64 units leave as 16-byte stores. Rows >= T read zero dyc,
// so their dh1 is 0 and adds nothing to db1; they are not stored.
template <class Smem>
__device__ __forceinline__ void dual_epilogue(Smem& s, const DualArgs& a,
                                              const float (&a1)[kDualN / 2],
                                              const float (&a2)[kDualN / 2],
                                              int wg, int buf, int n0,
                                              int m0) {
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
  const int c0 = 2 * (lane & 3);
  float* cs = s.colsum[buf][wg * 4 + warp];
  bf16* og = s.out[wg][0];
  bf16* od = s.out[wg][1];
  const int rl = warp * 16 + (lane >> 2);  // r0's row in the warpgroup
#pragma unroll
  for (int i = 0; i < kDualN / 8; ++i) {
    const int col = 8 * i + c0;
    const float bias[2] = {a.b1[n0 + col], a.b1[n0 + col + 1]};
    float g[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float grad;
      g[e] = gelu_tanh(a1[4 * i + e] + bias[e & 1], &grad);
      d[e] = grad * a2[4 * i + e];
    }
    store_bf16x2(og + rl * kDualLdO + col, g[0], g[1]);
    store_bf16x2(od + rl * kDualLdO + col, d[0], d[1]);
    store_bf16x2(og + (rl + 8) * kDualLdO + col, g[2], g[3]);
    store_bf16x2(od + (rl + 8) * kDualLdO + col, d[2], d[3]);
    // the warp's 16 rows of the two columns: rows g, g + 8, then the 8
    // row groups by a butterfly over lanes 4 apart
    float s0 = d[0] + d[2], s1 = d[1] + d[3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4) {
      cs[col] = s0;
      cs[col + 1] = s1;
    }
  }
  wg_bar(wg);
  // 64 rows x 128 bytes of each: 8 threads a row, 16 bytes each
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = q * 16 + tid / 8, c = 8 * (tid % 8);
    const int m = m0 + wg * 64 + r;
    if (m < a.T) {
      const long long o = static_cast<long long>(m) * a.Ch + n0 + c;
      *reinterpret_cast<uint4*>(a.gc + o) =
          *reinterpret_cast<const uint4*>(og + r * kDualLdO + c);
      *reinterpret_cast<uint4*>(a.dh1c + o) =
          *reinterpret_cast<const uint4*>(od + r * kDualLdO + c);
    }
  }
  // the 8 warps' partials of this block, added in row order (the buffer
  // alternates, so one barrier a block keeps writers off unread sums and
  // unread staged outputs)
  asm volatile("bar.sync 3, %0;\n" ::"n"(2 * kWgThreads) : "memory");
  if (threadIdx.x < kDualN) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += s.colsum[buf][w][threadIdx.x];
    a.p_b1[static_cast<long long>(blockIdx.x) * a.Ch + n0 + threadIdx.x] =
        t;
  }
}

template <int KC>
__global__ void __launch_bounds__(DualRoles::kThreads, 1)
    mlp_dual_sm90(const __grid_constant__ CUtensorMap txn,
                  const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2, DualArgs a) {
  DualSmem<KC>& s = *reinterpret_cast<DualSmem<KC>*>(smem_base_1k());
  const int m0 = blockIdx.x * kDualM;
  // hidden blocks, from a block-dependent first one: neighbouring blocks
  // read different weight chunks from L2 at any time
  const int nj = a.Ch / kDualN, j0 = blockIdx.x % nj;
  if (threadIdx.x == 0) {
    mbar_init(&s.tile, 1);
    for (int i = 0; i < kDualStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], DualRoles::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == DualRoles::kProducerThread) {
      // rows >= T and columns >= C of the tile read as zeros
      mbar_expect_tx(&s.tile, 2 * KC * kDualM * 64 * 2);
      for (int kc = 0; kc < KC; ++kc) {
        tma_load_2d(s.xn[kc], &txn, &s.tile, kc * 64, m0);
        tma_load_2d(s.dy[kc], &tdy, &s.tile, kc * 64, m0);
      }
      for (int i = 0; i < nj * KC; ++i) {
        const int st = i % kDualStages,
                  n0 = ((i / KC + j0) % nj) * kDualN, k0 = (i % KC) * 64;
        mbar_wait(&s.empty[st], ((i / kDualStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], kDualStageBytes);
        tma_load_2d(s.w1[st], &tw1, &s.full[st], k0, n0);
        tma_load_2d(s.w2[st], &tw2, &s.full[st], n0, k0);
      }
    }
    return;
  }
  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile
  mbar_wait_warp(&s.tile, 0);
  for (int j = 0; j < nj; ++j) {
    const int n0 = ((j + j0) % nj) * kDualN;
    // A1 = xn W1_j^T, A2 = dyc W2_j (64 x 64 each, K = C); as in gemm_sm90,
    // no other instruction touches them until the last wait
    float a1[kDualN / 2], a2[kDualN / 2];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int i = j * KC + kc, st = i % kDualStages;
      mbar_wait_warp(&s.full[st], (i / kDualStages) & 1);
      const uint64_t dx = sw128_desc(s.xn[kc] + wg * 64 * 64),
                     dd = sw128_desc(s.dy[kc] + wg * 64 * 64),
                     d1 = sw128_desc(s.w1[st]), d2 = sw128_desc(s.w2[st]);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wg<kDualN>::ss<0, 0>(a1, dx + ks * kDescKStep, d1 + ks * kDescKStep,
                             kc > 0 || ks > 0);
        Wg<kDualN>::ss<0, 1>(a2, dd + ks * kDescKStep, d2 + ks * kDescRows16,
                             kc > 0 || ks > 0);
      }
      wg_commit();
      wg_wait<1>();  // chunk kc - 1's products are done: hand its stage back
      if (kc > 0) warp_arrive(&s.empty[(i - 1) % kDualStages]);
    }
    wg_wait<0>();
    warp_arrive(&s.empty[(j * KC + KC - 1) % kDualStages]);
    fence_regs(a1);
    fence_regs(a2);

    dual_epilogue(s, a, a1, a2, wg, j & 1, n0, m0);
  }
}

template <int KC>
int launch_dual(const CUtensorMap& txn, const CUtensorMap& tdy,
                const CUtensorMap& tw1, const CUtensorMap& tw2,
                const DualArgs& a, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  SWIN_TRY(smem_limit_once(smem_set,
                           reinterpret_cast<const void*>(mlp_dual_sm90<KC>),
                           dual_smem_bytes<KC>()));
  mlp_dual_sm90<KC><<<(a.T + kDualM - 1) / kDualM, DualRoles::kThreads,
                      dual_smem_bytes<KC>(), s>>>(txn, tdy, tw1, tw2, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the dual product above C = 256 ------------------------------------------
// A tile's xn and dyc no longer fit beside the ring (2 x 128 KB at C =
// 512), so they stream through it with the weights, a 64-deep k-chunk of
// each a stage. Then every stage is read from L2 for its products alone,
// and L2, not the tensor cores, bounds the product: a stage of 128 tokens
// x n hidden units feeds 2 x 2 x 128 n 64 operations. So a block-step
// takes n = 128 units (two m64n128 accumulators a warpgroup, 128
// registers a thread), and the two blocks of a cluster take neighbouring
// hidden groups of one token tile: rank 0 brings the tile's xn chunk and
// rank 1 its dyc chunk, each multicast by TMA into both blocks. A block's
// stage is then 48 KB from L2 (its weights' 32 KB and one 16 KB chunk)
// for 4.2 M operations: 87 a byte, against 43 for 64 units a step
// without the cluster. (On the H100 neither the cluster nor a 2 x 2 one
// that also shares the weights moved the product's time: L2 does not
// bind it; the epilogue takes about a fifth, and the products run near
// the rate at which a stage's 64 KB is written into shared memory and
// read by its 16 wgmmas.) The ring holds three 64 KB stages; the
// epilogue stages gc and dh1c 32 columns at a time (20 KB).
constexpr int kWideN = 128;      // hidden units a block-step
constexpr int kWideStages = 3;
constexpr int kWideJ = 2;        // hidden blocks of kWideN a block
constexpr int kWideCluster = 2;  // blocks sharing a token tile's chunks
constexpr int kWideQ = 32;       // epilogue columns staged at a time
constexpr int kWideLdO = kWideQ + 8;
using WideRoles = WarpRoles<2>;

struct DualWideSmem {  // at the 1024-aligned start of dynamic shared memory
  bf16 xn[kWideStages][kDualM * 64];  // the tile's k-chunk of xn and dyc
  bf16 dy[kWideStages][kDualM * 64];
  bf16 w1[kWideStages][kWideN * 64];  // W1 rows n0 .. + 127, 64 k: K-major
  bf16 w2[kWideStages][64 * kWideN];  // W2 rows k0 .. + 63 x 128 units:
                                      // MN-major, two 64-unit atoms
  float colsum[2][8][kWideN];  // db1 partials of the 8 consumer warps
  bf16 out[2][2][64 * kWideLdO];  // a quarter of gc, dh1c a warpgroup
  uint64_t full[kWideStages], empty[kWideStages];
};
constexpr int kDualWideSmemBytes =
    static_cast<int>(sizeof(DualWideSmem)) + 1024;
constexpr uint32_t kDualWideStageBytes = (2 * kDualM + 2 * kWideN) * 64 * 2;

// A consumer warp's release of a stage: one arrival on its empty barrier
// in every block of the cluster (each block's producer refills its own
// copy of the stage, and rank 0's and 1's copies also land in the other).
__device__ __forceinline__ void wide_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < kWideCluster; ++r) mbar_arrive_cluster(bar, r);
}

// dual_epilogue for a hidden block of 128 units (tanh on the special-
// function unit: tanh_fast), in four quarters of 32
// columns (element 4 i + e of a1 / a2 at row rl + 8 (e / 2), column
// 8 i + c0 + e % 2). Units >= Ch (the last group's padding) read zero
// weights; they are neither stored nor summed.
__device__ __forceinline__ void dual_wide_epilogue(
    DualWideSmem& s, const DualArgs& a, const float (&a1)[kWideN / 2],
    const float (&a2)[kWideN / 2], int wg, int buf, int n0, int m0,
    long long tile) {
  const int tid = threadIdx.x % kWgThreads, warp = tid >> 5, lane = tid & 31;
  const int c0 = 2 * (lane & 3);
  float* cs = s.colsum[buf][wg * 4 + warp];
  bf16* og = s.out[wg][0];
  bf16* od = s.out[wg][1];
  const int rl = warp * 16 + (lane >> 2);
#pragma unroll
  for (int q = 0; q < kWideN / kWideQ; ++q) {
#pragma unroll
    for (int ii = 0; ii < kWideQ / 8; ++ii) {
      const int i = q * (kWideQ / 8) + ii;
      const int col = 8 * i + c0, lc = 8 * ii + c0;
      const bool live = n0 + col < a.Ch;  // Ch % 64 == 0: all 8 or none
      const float bias[2] = {live ? a.b1[n0 + col] : 0.f,
                             live ? a.b1[n0 + col + 1] : 0.f};
      float g[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float grad;
        g[e] = gelu_tanh_fast(a1[4 * i + e] + bias[e & 1], &grad);
        d[e] = grad * a2[4 * i + e];
      }
      store_bf16x2(og + rl * kWideLdO + lc, g[0], g[1]);
      store_bf16x2(od + rl * kWideLdO + lc, d[0], d[1]);
      store_bf16x2(og + (rl + 8) * kWideLdO + lc, g[2], g[3]);
      store_bf16x2(od + (rl + 8) * kWideLdO + lc, d[2], d[3]);
      float s0 = d[0] + d[2], s1 = d[1] + d[3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        cs[col] = s0;
        cs[col + 1] = s1;
      }
    }
    wg_bar(wg);
    // 64 rows x 64 bytes of each: 4 threads a row, 16 bytes each
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int r = p * 32 + tid / 4, c = 8 * (tid % 4);
      const int m = m0 + wg * 64 + r, n = n0 + q * kWideQ + c;
      if (m < a.T && n < a.Ch) {
        const long long o = static_cast<long long>(m) * a.Ch + n;
        *reinterpret_cast<uint4*>(a.gc + o) =
            *reinterpret_cast<const uint4*>(og + r * kWideLdO + c);
        *reinterpret_cast<uint4*>(a.dh1c + o) =
            *reinterpret_cast<const uint4*>(od + r * kWideLdO + c);
      }
    }
    wg_bar(wg);  // read before the next quarter overwrites it
  }
  // the 8 warps' partials of this block, added in row order (colsum
  // alternates between blocks, as dual_epilogue's)
  asm volatile("bar.sync 3, %0;\n" ::"n"(2 * kWgThreads) : "memory");
  if (threadIdx.x < kWideN && n0 + threadIdx.x < a.Ch) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += s.colsum[buf][w][threadIdx.x];
    a.p_b1[tile * a.Ch + n0 + threadIdx.x] = t;
  }
}

// Block b: the 128-token tile b / G and hidden group b % G (G even: a
// cluster's two blocks take neighbouring groups of one tile), i.e. hidden
// blocks (b % G) J .. + J - 1 of 128 units (the last group's units >= Ch
// read zero weights and are dropped); each takes KC = ceil(C / 64)
// stages, each one k-chunk of the tile's xn and dyc (128 x 64, rows >= T
// and columns >= C read as zeros) and of W1's and W2's block. A tile's G
// blocks run in a row, so its xn and dyc leave device memory about once
// while the weights stay in L2.
__global__ void __cluster_dims__(kWideCluster, 1, 1)
    __launch_bounds__(WideRoles::kThreads, 1)
    mlp_dual_wide_sm90(const __grid_constant__ CUtensorMap txn,
                       const __grid_constant__ CUtensorMap tdy,
                       const __grid_constant__ CUtensorMap tw1,
                       const __grid_constant__ CUtensorMap tw2, DualArgs a,
                       int KC, int G) {
  static_assert(kWideCluster == 2, "rank 0 brings xn, rank 1 dyc");
  DualWideSmem& s = *reinterpret_cast<DualWideSmem*>(smem_base_1k());
  const long long tile = blockIdx.x / G;
  const int grp = blockIdx.x % G, m0 = static_cast<int>(tile) * kDualM;
  const int steps = kWideJ * KC;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWideStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kWideCluster * WideRoles::kConsumerWarps);
    }
    fence_barrier_init();
  }
  // both blocks' barriers are set before a copy or an arrival reaches one
  cluster_sync();
  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == WideRoles::kProducerThread) {
      const uint32_t rank = cluster_rank();
      for (int i = 0; i < steps; ++i) {
        const int st = i % kWideStages, k0 = (i % KC) * 64;
        const int n0 = (grp * kWideJ + i / KC) * kWideN;
        mbar_wait(&s.empty[st], ((i / kWideStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], kDualWideStageBytes);
        if (rank == 0)
          tma_load_2d_mc(s.xn[st], &txn, &s.full[st], k0, m0, 0x3);
        else
          tma_load_2d_mc(s.dy[st], &tdy, &s.full[st], k0, m0, 0x3);
        tma_load_2d(s.w1[st], &tw1, &s.full[st], k0, n0);
        tma_load_2d(s.w2[st], &tw2, &s.full[st], n0, k0);
        tma_load_2d(s.w2[st] + 64 * 64, &tw2, &s.full[st], n0 + 64, k0);
      }
      // stay until every stage's last use is released by both blocks'
      // consumers: the other block's arrivals land in this block's
      // shared memory, which lives as long as one of its threads
      for (int i = steps; i < steps + kWideStages; ++i)
        mbar_wait(&s.empty[i % kWideStages], ((i / kWideStages) & 1) ^ 1);
    }
    return;
  }
  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile
  for (int j = 0; j < kWideJ; ++j) {
    const int n0 = (grp * kWideJ + j) * kWideN;
    // A1 = xn W1_j^T, A2 = dyc W2_j (64 x 128 each, K = C), as
    // mlp_dual_sm90
    float a1[kWideN / 2], a2[kWideN / 2];
    for (int kc = 0; kc < KC; ++kc) {
      const int i = j * KC + kc, st = i % kWideStages;
      mbar_wait_warp(&s.full[st], (i / kWideStages) & 1);
      const uint64_t dx = sw128_desc(s.xn[st] + wg * 64 * 64),
                     dd = sw128_desc(s.dy[st] + wg * 64 * 64),
                     d1 = sw128_desc(s.w1[st]),
                     d2 = sw128_desc_lbo(s.w2[st], 64 * 64 * 2);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wg<kWideN>::ss<0, 0>(a1, dx + ks * kDescKStep, d1 + ks * kDescKStep,
                             kc > 0 || ks > 0);
        Wg<kWideN>::ss<0, 1>(a2, dd + ks * kDescKStep,
                             d2 + ks * kDescRows16, kc > 0 || ks > 0);
      }
      wg_commit();
      wg_wait<1>();  // chunk kc - 1's products are done: release its stage
      if (kc > 0) wide_release(&s.empty[(i - 1) % kWideStages]);
    }
    wg_wait<0>();
    wide_release(&s.empty[(j * KC + KC - 1) % kWideStages]);
    fence_regs(a1);
    fence_regs(a2);

    dual_wide_epilogue(s, a, a1, a2, wg, j & 1, n0, m0, tile);
  }
}

int launch_dual_wide(const CUtensorMap& txn, const CUtensorMap& tdy,
                     const CUtensorMap& tw1, const CUtensorMap& tw2,
                     const DualArgs& a, int KC, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  SWIN_TRY(smem_limit_once(
      smem_set, reinterpret_cast<const void*>(mlp_dual_wide_sm90),
      kDualWideSmemBytes));
  // hidden groups of kWideJ blocks, rounded up to whole clusters
  const int groups = ((a.Ch + kWideN * kWideJ - 1) / (kWideN * kWideJ) +
                      kWideCluster - 1) / kWideCluster * kWideCluster;
  const long long blocks =
      static_cast<long long>((a.T + kDualM - 1) / kDualM) * groups;
  mlp_dual_wide_sm90<<<static_cast<unsigned>(blocks), WideRoles::kThreads,
                       kDualWideSmemBytes, s>>>(txn, tdy, tw1, tw2, a, KC,
                                                groups);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 workspace, carved in one order for measuring and for use (the
// same order as ops/swin_block.py mlp_bwd_plan)
struct MlpBwdWorkBf16 {
  bf16 *w1b, *w2b, *xn, *dyc, *gc, *dh1c;
  float *mu, *rstd, *dxn, *p_w1, *p_w2, *p_b1, *p_b2, *p_g, *p_b;
  int slots_w1, slots_w2, tiles;

  MlpBwdWorkBf16(Carver& cv, long long T_, int C, int Ch, int kchunk_w1,
                 int kchunk_w2) {
    slots_w1 = gemm_slots(T_, kchunk_w1);
    slots_w2 = gemm_slots(T_, kchunk_w2);
    tiles = static_cast<int>((T_ + kDualM - 1) / kDualM);
    w1b = cv.take<bf16>(static_cast<size_t>(Ch) * C);
    w2b = cv.take<bf16>(static_cast<size_t>(C) * Ch);
    mu = cv.take<float>(T_);
    rstd = cv.take<float>(T_);
    xn = cv.take<bf16>(T_ * C);
    dyc = cv.take<bf16>(T_ * C);
    gc = cv.take<bf16>(T_ * Ch);
    dh1c = cv.take<bf16>(T_ * Ch);
    dxn = cv.take<float>(T_ * C);
    p_w1 = cv.take<float>(static_cast<size_t>(slots_w1) * Ch * C);
    p_w2 = cv.take<float>(static_cast<size_t>(slots_w2) * C * Ch);
    p_b1 = cv.take<float>(static_cast<size_t>(tiles) * Ch);
    p_b2 = cv.take<float>(colsum_part_floats(T_, C));
    p_g = cv.take<float>(ln_bwd_part_floats(T_, C));
    p_b = cv.take<float>(ln_bwd_part_floats(T_, C));
  }
};

// ---- the f32 version: the passes of swin_bwd_common.cuh ---------------------
struct EpiH1 {  // h1 = acc + b1, gc = gelu(h1)
  float *h1, *gc;
  const float* b1;
  int N;
  __device__ void operator()(long long m, int n, int, float v) const {
    const float h = v + b1[n];
    float unused;
    h1[m * N + n] = h;
    gc[m * N + n] = gelu_tanh(h, &unused);
  }
};

struct EpiDh1 {  // dh1 = gelu'(h1) * acc, over h1 and into dh1c
  float *h1, *dh1c;
  int N;
  __device__ void operator()(long long m, int n, int, float v) const {
    const long long i = m * N + n;
    float grad;
    gelu_tanh(h1[i], &grad);
    const float d = grad * v;
    h1[i] = d;
    dh1c[i] = d;
  }
};

struct MlpBwdWorkF32 {
  float *mu, *rstd, *h1, *dxn, *p_w1, *p_w2, *p_b1, *p_b2, *p_g, *p_b;
  float *xn, *dyc, *gc, *dh1c;
  int s_w1, s_w2;

  MlpBwdWorkF32(Carver& cv, long long T_, int C, int Ch) {
    s_w1 = gemm_splits(Ch, C, T_);
    s_w2 = gemm_splits(C, Ch, T_);
    mu = cv.take<float>(T_);
    rstd = cv.take<float>(T_);
    xn = cv.take<float>(T_ * C);
    dyc = cv.take<float>(T_ * C);
    h1 = cv.take<float>(T_ * Ch);
    gc = cv.take<float>(T_ * Ch);
    dh1c = cv.take<float>(T_ * Ch);
    dxn = cv.take<float>(T_ * C);
    p_w1 = cv.take<float>(static_cast<size_t>(s_w1) * Ch * C);
    p_w2 = cv.take<float>(static_cast<size_t>(s_w2) * C * Ch);
    p_b1 = cv.take<float>(colsum_part_floats(T_, Ch));
    p_b2 = cv.take<float>(colsum_part_floats(T_, C));
    p_g = cv.take<float>(ln_bwd_part_floats(T_, C));
    p_b = cv.take<float>(ln_bwd_part_floats(T_, C));
  }
};

struct MlpBwdArgs {
  const void *x, *dy;
  void* dx;
  const float *ln_s, *ln_b, *w1, *b1, *w2, *b2, *dp;
  float *dln_s, *dln_b, *dw1, *db1, *dw2, *db2;
  void* work;
  long long T;
  int C, Ch, hw;
};

int run_mlp_bwd_f32(const MlpBwdArgs& a, cudaStream_t s) {
  Carver cv{static_cast<char*>(a.work)};
  const long long T_ = a.T;
  const int C = a.C, Ch = a.Ch;
  MlpBwdWorkF32 w(cv, T_, C, Ch);
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);

  SWIN_TRY(launch_ln_rows(x, a.ln_s, a.ln_b, w.xn, w.mu, w.rstd, T_, C, s));
  SWIN_TRY((gemm<true, true>(w.xn, a.w1, T_, Ch, C, C, C, 1,
                             EpiH1{w.h1, w.gc, a.b1, Ch}, s)));
  SWIN_TRY(launch_scale_rows(dy, a.dp, w.dyc, T_, C, a.hw, s));
  SWIN_TRY((gemm<true, false>(w.dyc, a.w2, T_, Ch, C, C, Ch, 1,
                              EpiDh1{w.h1, w.dh1c, Ch}, s)));
  SWIN_TRY((gemm<false, false>(w.dyc, w.gc, C, Ch, T_, C, Ch, w.s_w2,
                               EpiPartial{w.p_w2, C, Ch}, s)));
  SWIN_TRY((gemm<false, false>(w.dh1c, w.xn, Ch, C, T_, Ch, C, w.s_w1,
                               EpiPartial{w.p_w1, Ch, C}, s)));
  SWIN_TRY((gemm<true, false>(w.dh1c, a.w1, T_, C, Ch, Ch, C, 1,
                              EpiF32{w.dxn, C}, s)));
  SWIN_TRY(launch_ln_bwd(x, dy, w.dxn, w.mu, w.rstd, a.ln_s,
                         static_cast<float*>(a.dx), w.p_g, w.p_b, a.dln_s,
                         a.dln_b, T_, C, s));
  SWIN_TRY(launch_colsum(w.dyc, w.p_b2, a.db2, T_, C, s));
  SWIN_TRY(launch_colsum(w.h1, w.p_b1, a.db1, T_, Ch, s));
  SWIN_TRY(launch_reduce(w.p_w2, a.dw2, gemm_used_splits(T_, w.s_w2),
                         static_cast<long long>(C) * Ch, s));
  return launch_reduce(w.p_w1, a.dw1, gemm_used_splits(T_, w.s_w1),
                       static_cast<long long>(Ch) * C, s);
}

// ---- the bf16 version ----------------------------------------------------------
int run_mlp_bwd_bf16(const MlpBwdArgs& a, int kchunk_w1, int kchunk_w2,
                     cudaStream_t s) {
  Carver cv{static_cast<char*>(a.work)};
  const int T_ = static_cast<int>(a.T);
  const int C = a.C, Ch = a.Ch, KC = (C + 63) / 64;
  const MlpBwdWorkBf16 w(cv, T_, C, Ch, kchunk_w1, kchunk_w2);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* dy = static_cast<const bf16*>(a.dy);
  const long long nw = static_cast<long long>(Ch) * C;

  SWIN_TRY(launch_cast_weights<K2b>(a.w1, nw, a.w2, nw, w.w1b, w.w2b, s));
  SWIN_TRY(launch_ln_rows_bf16<K2b>(x, a.ln_s, a.ln_b, w.xn, w.mu, w.rstd,
                                    T_, C, s));
  SWIN_TRY(launch_scale_rows_bf16<K2b>(dy, a.dp, w.dyc, T_, C, a.hw, s));
  CUtensorMap txn, tdy, tw1, tw2;
  SWIN_TRY(make_map_2d(&txn, w.xn, C, T_, C, kDualM));
  SWIN_TRY(make_map_2d(&tdy, w.dyc, C, T_, C, kDualM));
  // W1's boxes are a step's hidden units: 64 up to C = 256, 128 above
  SWIN_TRY(make_map_2d(&tw1, w.w1b, C, Ch, C, C > 256 ? kWideN : kDualN));
  SWIN_TRY(make_map_2d(&tw2, w.w2b, Ch, C, Ch, 64));
  const DualArgs da{w.gc, w.dh1c, w.p_b1, a.b1, T_, Ch};
  SWIN_TRY(KC == 1   ? launch_dual<1>(txn, tdy, tw1, tw2, da, s)
           : KC == 2 ? launch_dual<2>(txn, tdy, tw1, tw2, da, s)
           : KC == 3 ? launch_dual<3>(txn, tdy, tw1, tw2, da, s)
           : KC == 4 ? launch_dual<4>(txn, tdy, tw1, tw2, da, s)
                     : launch_dual_wide(txn, tdy, tw1, tw2, da, KC, s));
  SWIN_TRY((gemm_run<true, true, K2b>(w.dyc, C, w.gc, Ch, C, Ch, T_,
                                      kchunk_w2, EpiSlot{w.p_w2, C, Ch},
                                      s)));
  SWIN_TRY((gemm_run<true, true, K2b>(w.dh1c, Ch, w.xn, C, Ch, C, T_,
                                      kchunk_w1, EpiSlot{w.p_w1, Ch, C},
                                      s)));
  // dxn = dh1c W1; above C = 256 two blocks an SM, neighbouring blocks on
  // one token tile (dh1c, T x 4C, is read from device memory once)
  const int kfull = (Ch + kGemmK - 1) / kGemmK * kGemmK;
  SWIN_TRY((C > 256 ? gemm_run<false, true, K2b, 128, true>(
                          w.dh1c, Ch, w.w1b, C, T_, C, Ch, kfull,
                          EpiOutF32{w.dxn, C}, s)
                    : gemm_run<false, true, K2b>(w.dh1c, Ch, w.w1b, C, T_,
                                                 C, Ch, kfull,
                                                 EpiOutF32{w.dxn, C}, s)));
  SWIN_TRY(launch_ln_bwd_rows<K2b>(x, dy, w.dxn, w.mu, w.rstd, a.ln_s,
                                   static_cast<bf16*>(a.dx), w.p_g, w.p_b,
                                   a.dln_s, a.dln_b, T_, C, s));
  SWIN_TRY(launch_colsum_bf16<K2b>(w.dyc, w.p_b2, a.db2, T_, C, s));
  SWIN_TRY(launch_reduce<K2b>(w.p_w2, a.dw2, w.slots_w2, nw, s));
  SWIN_TRY(launch_reduce<K2b>(w.p_w1, a.dw1, w.slots_w1, nw, s));
  return launch_reduce<K2b>(w.p_b1, a.db1, w.tiles, Ch, s);
}

// what each version takes: f32 C <= 1024; bf16 the widths K2f takes too
// (C % 32 == 0 up to 256: a tile's xn and dyc in shared memory; above, up
// to kMlpMaxC: streamed; as ops/swin_block.py mlp_kernel_dims says), whole
// hidden blocks (Ch % 64 == 0), int token indices, and split-K chunks of
// whole k-steps
bool mlp_bwd_dims_ok(long long T, int C, int Ch, int is_bf16, int kchunk_w1,
                     int kchunk_w2) {
  if (T < 1 || C < 1 || Ch < 1 || C > 32 * kMaxLane) return false;
  if (!is_bf16) return true;
  return mlp_bf16_c(C) &&
         Ch % kDualN == 0 &&
         T < (1LL << 31) &&
         kchunk_w1 >= kGemmK && kchunk_w1 % kGemmK == 0 &&
         kchunk_w2 >= kGemmK && kchunk_w2 % kGemmK == 0;
}

}  // namespace swin

// kchunk_w1 / kchunk_w2: tokens of a slot of the split-K dW1 and dW2
// products (bf16; ops/swin_block.py split_k_plan), ignored in f32.
// Bytes of the workspace (0 for widths the kernels do not take). The bf16
// host side sizes it with its own mirror (ops/swin_block.py mlp_bwd_plan);
// the launch refuses a buffer smaller than this.
extern "C" long long swin_mlp_bwd_workspace(long long T, int C, int Ch,
                                            int is_bf16, int kchunk_w1,
                                            int kchunk_w2) {
  if (!swin::mlp_bwd_dims_ok(T, C, Ch, is_bf16, kchunk_w1, kchunk_w2))
    return 0;
  swin::Carver cv{nullptr};
  if (is_bf16) {
    swin::MlpBwdWorkBf16 w(cv, T, C, Ch, kchunk_w1, kchunk_w2);
  } else {
    swin::MlpBwdWorkF32 w(cv, T, C, Ch);
  }
  return static_cast<long long>(cv.off);
}

extern "C" int swin_mlp_bwd(const void* x, const void* dy, void* dx,
                            const float* ln_s, const float* ln_b,
                            const float* w1, const float* b1,
                            const float* w2, const float* b2,
                            const float* dp, float* dln_s, float* dln_b,
                            float* dw1, float* db1, float* dw2, float* db2,
                            void* work, long long work_bytes, long long T,
                            int C, int Ch, int hw, int is_bf16,
                            int kchunk_w1, int kchunk_w2, void* stream) {
  const long long need =
      swin_mlp_bwd_workspace(T, C, Ch, is_bf16, kchunk_w1, kchunk_w2);
  if (need == 0 || work_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const swin::MlpBwdArgs a{x,     dy,  dx,  ln_s, ln_b, w1, b1, w2,
                           b2,    dp,  dln_s, dln_b, dw1, db1, dw2, db2,
                           work,  T,   C,   Ch,   hw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::run_mlp_bwd_bf16(a, kchunk_w1, kchunk_w2, s)
                 : swin::run_mlp_bwd_f32(a, s);
}
