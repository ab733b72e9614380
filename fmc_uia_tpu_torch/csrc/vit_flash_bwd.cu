// ViT global attention, backward (K4b), for sm_90a.
//
// Replaces the backward of the Pallas TPU flash-attention library kernel
// behind fmc_uia_tpu/ops/vit_attention.py global_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the VJP
// _flash_attention_bwd, its dK/dV kernel _flash_attention_bwd_dkv and its
// dQ kernel _flash_attention_bwd_dq). Given q, k, v, o, do [B, H, N, dh]
// (dh = 64) and the forward's per-row lse:
//
//   di = rowsum(o * do)                      f32 (XLA outside the TPU
//                                            kernels; here a small pass)
//   p  = exp(s - lse), s = (q k^T) * scale   recomputed, f32
//   dv = p^T do                              p rounded to do's dtype
//   dp = do v^T                              f32
//   ds = (dp - di) * p * scale               f32
//   dk = ds^T q, dq = ds k                   ds rounded to the dtype
//
// every product accumulated in f32, the grads rounded once at the end.
// Keys and queries >= N are masked as in the forward (K4f): their rows of
// k, v, q and do are read as zeros, p is 0 for them, and rows >= N of the
// grads are never written.
//
// Design (bf16): the TPU's split, without atomics, each pass warp-
// specialised as the forward (K4f): a producer warp feeds TMA tiles
// (128-byte swizzle) through a ring of kBwdStages mbarrier stages,
// consumer warpgroups run the products on wgmma.
//  * di pass (rowdot): di = rowsum(o * do) in f32, and lse * log2(e), into
//    a workspace whose rows are padded to a multiple of 64 (pad: 0), so
//    that a tile's 64 values are one aligned bulk copy.
//  * dK/dV pass (dkv_bf16): one block per (key tile of 128, h, b); K and V
//    stay in shared memory, Q and dO tiles of 64 queries stream in with
//    their lse and di. Per tile and warpgroup (64 keys): S^T = K Q^T and
//    dP^T = V dO^T (m64n64k16, both operands from shared memory, K-major),
//    P^T = exp2(S^T scale log2 e - lse) while dP^T is on the tensor cores,
//    dS^T = P^T (dP^T - di) scale, then dV += P^T dO and dK += dS^T Q
//    together (P^T and dS^T from registers, rounded to bf16; dO and Q as
//    MN-major operands). Issuing dV with dK, not before dS, keeps fewer
//    registers in flight: the other order serialised the wgmmas and
//    spilled at the 168 registers a thread has, and ran slower. The
//    forward's ping-pong of the two warpgroups was no faster here.
//  * dQ pass (dq_bf16): one block per (query tile of 192, h, b), three
//    consumer warpgroups; Q and dO stay, K and V tiles of 64 keys stream:
//    S = Q K^T, dP = dO V^T, P (under dP's product), dS, dQ += dS K (K an
//    MN-major operand).
// Each pass owns its outputs and sums in a fixed order: deterministic. The
// f32 passes run one thread per row on the CUDA cores (dV and dK in two
// sweeps, to keep a thread's rows in registers).
//
// What bounds it: the least work of the pullback is 5 N x N x dh products
// (S, dP, dV, dK, dQ: 10 B H N^2 dh operations on the tensor cores) and
// B H N^2 exponentials -- operations, by far, at N = 4101. This split does
// 7 products (S and dP in both passes: 14 B H N^2 dh operations) and
// 2 B H N^2 exponentials; a one-pass design (dQ summed over key tiles in a
// fixed order, FlashAttention-3's deterministic mode) would do the 5 and
// one exponential per score, at the cost of a dQ reduction through device
// memory.

#include "vit_flash_sm90.cuh"

namespace vitfa {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, N]
  float* lse2;       // [B H, Np] workspace: lse * log2(e), pad 0
  float* di;         // [B H, Np] workspace: rowsum(o * do), pad 0
  void* dq;
  void* dk;
  void* dv;
  Layout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  float scale;
  int B, H, N, Np;  // Np: N rounded up to a multiple of kStatPad
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 w = reinterpret_cast<const float4*>(p)[1];
  x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
  x[4] = w.x, x[5] = w.y, x[6] = w.z, x[7] = w.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// di = rowsum(o * do) in f32 and lse2 = lse * log2(e), rows padded to Np
// (pad rows 0): 8 lanes a row, 8 neighbouring elements a lane. B H Np is a
// multiple of 64, so every thread of the grid has a row.
template <typename T>
__global__ void __launch_bounds__(256) rowdot(BwdArgs a) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  const int n = static_cast<int>(row % a.Np);
  const int bh = static_cast<int>(row / a.Np);
  float s = 0.f;
  if (n < a.N) {
    const int h = bh % a.H, b = bh / a.H;
    float o[8], d[8];
    load8(static_cast<const T*>(a.o) + head_off(a.lo, b, h) + n * a.lo.n +
              8 * part,
          o);
    load8(static_cast<const T*>(a.dout) + head_off(a.ldo, b, h) +
              n * a.ldo.n + 8 * part,
          d);
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(o[i], d[i], s);
  }
  for (int off = 4; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0) {
    a.di[row] = s;
    a.lse2[row] =
        n < a.N ? a.lse[static_cast<long long>(bh) * a.N + n] * kLog2e : 0.f;
  }
}

constexpr int kStatPad = 64;    // workspace rows: a multiple of this
constexpr int kDkvKeys = 128;   // dK/dV pass: keys of a block (2 x 64)
constexpr int kDkvQ = 64;       // dK/dV pass: queries of a streamed tile
constexpr int kDkvConsumers = 2;  // dK/dV pass: consumer warpgroups
using DkvRoles = WarpRoles<kDkvConsumers>;
constexpr int kDqConsumers = 3;   // dQ pass: consumer warpgroups (122
using DqRoles = WarpRoles<kDqConsumers>;  // registers fit the 128 of 13 warps)
constexpr int kDqRows = 64 * kDqConsumers;  // dQ pass: queries of a block
constexpr int kDqKeys = 64;       // dQ pass: keys of a streamed tile (128:
                                  // m64n128 products, spilled)
constexpr int kBwdStages = 3;

struct DkvSmem {  // at the 1024-aligned start of dynamic shared memory
  bf16 k[kDkvKeys * kDh];
  bf16 v[kDkvKeys * kDh];
  bf16 q[kBwdStages][kDkvQ * kDh];
  bf16 dout[kBwdStages][kDkvQ * kDh];
  float lse2[kBwdStages][kDkvQ];
  float di[kBwdStages][kDkvQ];
  uint64_t kv_full, full[kBwdStages], empty[kBwdStages];
};
constexpr int kDkvSmemBytes = static_cast<int>(sizeof(DkvSmem)) + 1024;

struct DqSmem {
  bf16 q[kDqRows * kDh];
  bf16 dout[kDqRows * kDh];
  bf16 k[kBwdStages][kDqKeys * kDh];
  bf16 v[kBwdStages][kDqKeys * kDh];
  uint64_t qd_full, full[kBwdStages], empty[kBwdStages];
};
constexpr int kDqSmemBytes = static_cast<int>(sizeof(DqSmem)) + 1024;

__device__ __forceinline__ void zero32(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
}

// Rows r and r + 8 of a warpgroup's 64 x 64 accumulator as bf16 (r = the
// thread's first row; rows >= N are not written).
__device__ __forceinline__ void store_acc_bf16(bf16* base, long long sn,
                                               int r, int N,
                                               const float (&x)[32]) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = 8 * i + c;
    if (r < N)
      *reinterpret_cast<__nv_bfloat162*>(base + r * sn + d) =
          __floats2bfloat162_rn(x[4 * i], x[4 * i + 1]);
    if (r + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(base + (r + 8) * sn + d) =
          __floats2bfloat162_rn(x[4 * i + 2], x[4 * i + 3]);
  }
}

__device__ __forceinline__ void init_pipe(uint64_t* once, uint64_t* full,
                                          uint64_t* empty, int consumer_warps) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int i = 0; i < kBwdStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumer_warps);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// Pass 1: dK and dV of one key tile.
__global__ void __launch_bounds__(DkvRoles::kThreads, 1)
    dkv_bf16(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  DkvSmem& s = *reinterpret_cast<DkvSmem*>(smem_base_1k());
  const int N = a.N, h = blockIdx.y, b = blockIdx.z;
  const int nqt = (N + kDkvQ - 1) / kDkvQ;
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Np;
  init_pipe(&s.kv_full, s.full, s.empty, DkvRoles::kConsumerWarps);
  const int wg = warpgroup_index();
  if (wg == kDkvConsumers) {  // the producer warp
    if (threadIdx.x == DkvRoles::kProducerThread) {
      mbar_expect_tx(&s.kv_full, 2 * kDkvKeys * kRowBytes);
      tma_load(s.k, &tk, &s.kv_full, blockIdx.x * kDkvKeys, h, b);
      tma_load(s.v, &tv, &s.kv_full, blockIdx.x * kDkvKeys, h, b);
      for (int t = 0; t < nqt; ++t) {
        const int st = t % kBwdStages;
        mbar_wait(&s.empty[st], ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * kDkvQ * kRowBytes + 2 * kDkvQ * 4);
        tma_load(s.q[st], &tq, &s.full[st], t * kDkvQ, h, b);
        tma_load(s.dout[st], &tdo, &s.full[st], t * kDkvQ, h, b);
        bulk_load(s.lse2[st], a.lse2 + stat + t * kDkvQ, kDkvQ * 4,
                  &s.full[st]);
        bulk_load(s.di[st], a.di + stat + t * kDkvQ, kDkvQ * 4, &s.full[st]);
      }
    }
    return;
  }
  const int cw = wg, tid = threadIdx.x % kWgThreads;
  const int c = 2 * (tid & 3);
  const int r0 = blockIdx.x * kDkvKeys + cw * 64 + (tid >> 5) * 16 +
                 ((tid & 31) >> 2);  // this thread's keys: r0, r0 + 8
  const float sl2 = a.scale * kLog2e;
  const uint64_t dk_a = sw128_desc(s.k + cw * 64 * kDh);
  const uint64_t dv_a = sw128_desc(s.v + cw * 64 * kDh);
  float sacc[32], dpacc[32], dk[32], dv[32];
  uint32_t pf[4][4], dsf[4][4];
  zero32(dk);
  zero32(dv);
  mbar_wait_warp(&s.kv_full, 0);

  for (int t = 0; t < nqt; ++t) {
    const int st = t % kBwdStages;
    mbar_wait_warp(&s.full[st], (t / kBwdStages) & 1);
    const uint64_t dq_b = sw128_desc(s.q[st]);
    const uint64_t ddo_b = sw128_desc(s.dout[st]);
    fence_regs(sacc);
    fence_regs(dpacc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // S^T = K Q^T
      wgmma_ss_n64(sacc, dk_a + ks * kDescKStep, dq_b + ks * kDescKStep, ks);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // dP^T = V dO^T
      wgmma_ss_n64(dpacc, dv_a + ks * kDescKStep, ddo_b + ks * kDescKStep,
                   ks);
    wg_commit();
    wg_wait<1>();
    fence_regs(sacc);
    // P^T (columns: the tile's queries), under dP's product; queries >= N
    // read lse2 = 0 with zero q and do rows, so they add exactly 0 below
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[4 * i + e] = fast_exp2(
            fmaf(sacc[4 * i + e], sl2, -s.lse2[st][8 * i + c + (e & 1)]));
    acc_to_a(pf, sacc);  // p rounded to do's dtype
    wg_wait<0>();  // dP
    fence_regs(dpacc);
    // dS^T = P^T (dP^T - di) scale
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpacc[4 * i + e] = (dpacc[4 * i + e] - s.di[st][8 * i + c + (e & 1)]) *
                           sacc[4 * i + e] * a.scale;
    acc_to_a(dsf, dpacc);  // ds rounded to the dtype
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pf);
    fence_regs(dsf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO
      wgmma_rs_n64_t(dv, pf[kk], ddo_b + kk * kDescRowStep16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
      wgmma_rs_n64_t(dk, dsf[kk], dq_b + kk * kDescRowStep16);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pf);
    fence_regs(dsf);
    warp_arrive(&s.empty[st]);
  }
  store_acc_bf16(static_cast<bf16*>(a.dk) + head_off(a.ldk, b, h), a.ldk.n,
                 r0, N, dk);
  store_acc_bf16(static_cast<bf16*>(a.dv) + head_off(a.ldv, b, h), a.ldv.n,
                 r0, N, dv);
}

// Pass 2: dQ of one query tile.
__global__ void __launch_bounds__(DqRoles::kThreads, 1)
    dq_bf16(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  DqSmem& s = *reinterpret_cast<DqSmem*>(smem_base_1k());
  const int N = a.N, h = blockIdx.y, b = blockIdx.z;
  const int nkt = (N + kDqKeys - 1) / kDqKeys;
  init_pipe(&s.qd_full, s.full, s.empty, DqRoles::kConsumerWarps);
  const int wg = warpgroup_index();
  if (wg == kDqConsumers) {  // the producer warp
    if (threadIdx.x == DqRoles::kProducerThread) {
      mbar_expect_tx(&s.qd_full, 2 * kDqRows * kRowBytes);
      tma_load(s.q, &tq, &s.qd_full, blockIdx.x * kDqRows, h, b);
      tma_load(s.dout, &tdo, &s.qd_full, blockIdx.x * kDqRows, h, b);
      for (int t = 0; t < nkt; ++t) {
        const int st = t % kBwdStages;
        mbar_wait(&s.empty[st], ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * kDqKeys * kRowBytes);
        tma_load(s.k[st], &tk, &s.full[st], t * kDqKeys, h, b);
        tma_load(s.v[st], &tv, &s.full[st], t * kDqKeys, h, b);
      }
    }
    return;
  }
  const int cw = wg, tid = threadIdx.x % kWgThreads;
  const int c = 2 * (tid & 3);
  const int r0 = blockIdx.x * kDqRows + cw * 64 + (tid >> 5) * 16 +
                 ((tid & 31) >> 2);  // this thread's rows: r0, r0 + 8
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Np;
  // rows >= N: any finite values (never stored)
  const float lse0 = r0 < N ? a.lse2[stat + r0] : 0.f;
  const float lse1 = r0 + 8 < N ? a.lse2[stat + r0 + 8] : 0.f;
  const float di0 = r0 < N ? a.di[stat + r0] : 0.f;
  const float di1 = r0 + 8 < N ? a.di[stat + r0 + 8] : 0.f;
  const float sl2 = a.scale * kLog2e;
  const uint64_t dq_a = sw128_desc(s.q + cw * 64 * kDh);
  const uint64_t ddo_a = sw128_desc(s.dout + cw * 64 * kDh);
  constexpr int kR = kDqKeys / 2;  // accumulators of S and dP a thread
  static_assert(kDqKeys == 64, "S and dP run as m64n64k16");
  float sacc[kR], dpacc[kR], dq[32];
  uint32_t dsf[kDqKeys / 16][4];
  zero32(dq);
  mbar_wait_warp(&s.qd_full, 0);

  for (int t = 0; t < nkt; ++t) {
    const int st = t % kBwdStages;
    mbar_wait_warp(&s.full[st], (t / kBwdStages) & 1);
    const uint64_t dk_b = sw128_desc(s.k[st]);
    const uint64_t dv_b = sw128_desc(s.v[st]);
    fence_regs(sacc);
    fence_regs(dpacc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // S = Q K^T
      wgmma_ss_n64(sacc, dq_a + ks * kDescKStep, dk_b + ks * kDescKStep, ks);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // dP = dO V^T
      wgmma_ss_n64(dpacc, ddo_a + ks * kDescKStep, dv_b + ks * kDescKStep,
                   ks);
    wg_commit();
    wg_wait<1>();
    fence_regs(sacc);
    const int kbase = t * kDqKeys;
#pragma unroll
    for (int i = 0; i < kR / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[4 * i + e] = fast_exp2(
            fmaf(sacc[4 * i + e], sl2, -(e < 2 ? lse0 : lse1)));
    if (kbase + kDqKeys > N) {  // keys >= N of the last tile
#pragma unroll
      for (int i = 0; i < kR / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kbase + 8 * i + c + (e & 1) >= N) sacc[4 * i + e] = 0.f;
    }
    wg_wait<0>();
    fence_regs(dpacc);
#pragma unroll
    for (int i = 0; i < kR / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpacc[4 * i + e] = (dpacc[4 * i + e] - (e < 2 ? di0 : di1)) *
                           sacc[4 * i + e] * a.scale;
    acc_to_a(dsf, dpacc);
    fence_regs(dq);
    fence_regs(dsf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk)  // dQ += dS K
      wgmma_rs_n64_t(dq, dsf[kk], dk_b + kk * kDescRowStep16);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(dsf);
    warp_arrive(&s.empty[st]);
  }
  store_acc_bf16(static_cast<bf16*>(a.dq) + head_off(a.ldq, b, h), a.ldq.n,
                 r0, N, dq);
}

// f32, pass 2: one thread per query row.
__global__ void __launch_bounds__(kRowsF32) dq_f32(BwdArgs a) {
  __shared__ __align__(16) float ks[kTileF32 * kDh];
  __shared__ __align__(16) float vs[kTileF32 * kDh];
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int row = blockIdx.x * kRowsF32 + threadIdx.x;
  const bool ok = row < N;
  const long long rb = (static_cast<long long>(b) * a.H + h) * N;
  const float* K = static_cast<const float*>(a.k) + head_off(a.lk, b, h);
  const float* V = static_cast<const float*>(a.v) + head_off(a.lv, b, h);
  float q[kDh], d[kDh], dq[kDh];
  load_row_f32(q, static_cast<const float*>(a.q) + head_off(a.lq, b, h) +
                      row * a.lq.n,
               ok);
  load_row_f32(d, static_cast<const float*>(a.dout) + head_off(a.ldo, b, h) +
                      row * a.ldo.n,
               ok);
#pragma unroll
  for (int i = 0; i < kDh; ++i) dq[i] = 0.f;
  const float lse = ok ? a.lse[rb + row] : 0.f;
  const float di =
      ok ? a.di[(static_cast<long long>(b) * a.H + h) * a.Np + row] : 0.f;
  for (int k0 = 0; k0 < N; k0 += kTileF32) {
    const int nk = min(kTileF32, N - k0);
    __syncthreads();
    load_tile_f32(ks, K, a.lk.n, k0, kTileF32, N);
    load_tile_f32(vs, V, a.lv.n, k0, kTileF32, N);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float p = expf(dot64(q, ks + j * kDh) * a.scale - lse);
      const float ds = (dot64(d, vs + j * kDh) - di) * p * a.scale;
      axpy64(dq, ds, ks + j * kDh);
    }
  }
  if (ok)
    store_row_f32(static_cast<float*>(a.dq) + head_off(a.ldq, b, h) +
                      row * a.ldq.n,
                  dq);
}

// f32, pass 1: one thread per key row; kDK false sweeps dV, true dK.
template <bool kDK>
__global__ void __launch_bounds__(kRowsF32) dkv_f32(BwdArgs a) {
  __shared__ __align__(16) float qs[kTileF32 * kDh];
  __shared__ __align__(16) float dos[kTileF32 * kDh];
  __shared__ float lse_s[kTileF32], di_s[kTileF32];
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int N = a.N;
  const int row = blockIdx.x * kRowsF32 + tid;
  const bool ok = row < N;
  const long long rb = (static_cast<long long>(b) * a.H + h) * N;
  const float* Q = static_cast<const float*>(a.q) + head_off(a.lq, b, h);
  const float* DO = static_cast<const float*>(a.dout) + head_off(a.ldo, b, h);
  float k[kDh], v[kDh], acc[kDh];
  load_row_f32(k, static_cast<const float*>(a.k) + head_off(a.lk, b, h) +
                      row * a.lk.n,
               ok);
  if (kDK)
    load_row_f32(v, static_cast<const float*>(a.v) + head_off(a.lv, b, h) +
                        row * a.lv.n,
                 ok);
#pragma unroll
  for (int i = 0; i < kDh; ++i) acc[i] = 0.f;
  for (int q0 = 0; q0 < N; q0 += kTileF32) {
    const int nq = min(kTileF32, N - q0);
    __syncthreads();
    load_tile_f32(qs, Q, a.lq.n, q0, kTileF32, N);
    load_tile_f32(dos, DO, a.ldo.n, q0, kTileF32, N);
    if (tid < nq) {
      lse_s[tid] = a.lse[rb + q0 + tid];
      di_s[tid] = a.di[(static_cast<long long>(b) * a.H + h) * a.Np + q0 + tid];
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float p = expf(dot64(k, qs + i * kDh) * a.scale - lse_s[i]);
      if (kDK) {
        const float ds =
            (dot64(v, dos + i * kDh) - di_s[i]) * p * a.scale;
        axpy64(acc, ds, qs + i * kDh);
      } else {
        axpy64(acc, p, dos + i * kDh);
      }
    }
  }
  if (ok) {
    float* out = kDK ? static_cast<float*>(a.dk) + head_off(a.ldk, b, h) +
                           row * a.ldk.n
                     : static_cast<float*>(a.dv) + head_off(a.ldv, b, h) +
                           row * a.ldv.n;
    store_row_f32(out, acc);
  }
}

}  // namespace vitfa

static int padded_rows(int N) {
  return (N + vitfa::kStatPad - 1) / vitfa::kStatPad * vitfa::kStatPad;
}

// Bytes of the f32 workspace vit_flash_bwd takes as `ws`: lse * log2(e)
// and di, [B H, Np] each.
extern "C" long long vit_flash_bwd_workspace(int B, int H, int N) {
  return 2ll * B * H * padded_rows(N) * 4;
}

// strides: 24 element strides, (b, h, n) of q, k, v, o, do, dq, dk, dv in
// that order. ws: vit_flash_bwd_workspace(B, H, N) bytes. Returns a CUDA
// error code, or kErrNoEncoder / kErrTensorMap (negative) when the bf16
// path cannot build its TMA maps.
extern "C" int vit_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* ws, void* dq, void* dk,
                             void* dv, const long long* strides, float scale,
                             int B, int H, int N, int dh, int is_bf16,
                             void* stream) {
  using namespace vitfa;
  if (dh != kDh || B < 1 || H < 1 || N < 1 || H > 65535 || B > 65535 ||
      !layouts_ok(strides, 24, is_bf16 ? 2 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Layout* ls[8] = {&a.lq, &a.lk, &a.lv, &a.lo, &a.ldo, &a.ldq, &a.ldk, &a.ldv};
  for (int i = 0; i < 8; ++i)
    *ls[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.scale = scale;
  a.B = B;
  a.H = H;
  a.N = N;
  a.Np = padded_rows(N);
  a.lse2 = ws;
  a.di = ws + static_cast<long long>(B) * H * a.Np;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * a.Np;
  const unsigned rd_blocks = static_cast<unsigned>(rows / 32);
  if (is_bf16) {
    // maps per pass: boxes of a block's resident tiles and of the streamed
    // ones
    CUtensorMap q_dkv, do_dkv, k_dkv, v_dkv, q_dq, do_dq, k_dq, v_dq;
    int rc = make_map(&q_dkv, q, a.lq, B, H, N, kDkvQ);
    if (rc == 0) rc = make_map(&do_dkv, dout, a.ldo, B, H, N, kDkvQ);
    if (rc == 0) rc = make_map(&k_dkv, k, a.lk, B, H, N, kDkvKeys);
    if (rc == 0) rc = make_map(&v_dkv, v, a.lv, B, H, N, kDkvKeys);
    if (rc == 0) rc = make_map(&q_dq, q, a.lq, B, H, N, kDqRows);
    if (rc == 0) rc = make_map(&do_dq, dout, a.ldo, B, H, N, kDqRows);
    if (rc == 0) rc = make_map(&k_dq, k, a.lk, B, H, N, kDqKeys);
    if (rc == 0) rc = make_map(&v_dq, v, a.lv, B, H, N, kDqKeys);
    if (rc != 0) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        dkv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    rowdot<bf16><<<rd_blocks, 256, 0, s>>>(a);
    dkv_bf16<<<dim3((N + kDkvKeys - 1) / kDkvKeys, H, B), DkvRoles::kThreads,
               kDkvSmemBytes, s>>>(q_dkv, k_dkv, v_dkv, do_dkv, a);
    dq_bf16<<<dim3((N + kDqRows - 1) / kDqRows, H, B), DqRoles::kThreads,
              kDqSmemBytes, s>>>(q_dq, k_dq, v_dq, do_dq, a);
  } else {
    rowdot<float><<<rd_blocks, 256, 0, s>>>(a);
    dim3 grid((N + kRowsF32 - 1) / kRowsF32, H, B);
    dkv_f32<false><<<grid, kRowsF32, 0, s>>>(a);
    dkv_f32<true><<<grid, kRowsF32, 0, s>>>(a);
    dq_f32<<<grid, kRowsF32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
