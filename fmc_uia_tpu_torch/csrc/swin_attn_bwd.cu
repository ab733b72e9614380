// Fused Swin attention branch, backward (K1b), for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/swin_block_pallas.py
// _fused_branch_bwd -> _bwd_kernel -> _branch_pullback: the pullback of
// out = x + dp * proj(MHSA_window(LN1(x))) on the rolled, padded x
// [B, Hp, Wp, C] for the cotangent dy. Returns dx (identity path included)
// and f32 dLN scale/bias, dWqkv [3C, C], dbqkv, dWproj [C, C], dbproj and
// dbias [H, N, N]; the mask and dp get no gradient.
//
// Design. The TPU kernel runs one program per row of windows over a
// sequential grid: it recomputes the forward of its tile in VMEM, pulls it
// back, and carries the weight-gradient sums from one grid step to the
// next. Hopper blocks run in parallel and hold at most 227 KB of shared
// memory, so the pullback is split into passes (T = B*Hp*Wp tokens, every
// intermediate in the [B, Hp, Wp, .] grid layout, in a workspace):
//
//   1. cast_weights: Wqkv and Wproj rounded to bf16 once per launch (TMA
//      reads bf16 tiles; the port's params are f32); ln_rows_bf16: f32 LN
//      statistics and xn = LN1(x), rounded.
//   2. gemm_run: qkv = xn Wqkv^T + bqkv, rounded; q times dh^-1/2, rounded.
//   3. scale_rows_bf16: dyf = dy * dp, rounded; gemm_run: do = dyf Wproj.
//   4. attn_core_bwd_sm90: one block per (group of windows, group of
//      G = 64 / dh heads), a producer warp and two consumer warpgroups. The
//      producer brings each window's q, k, v and do (64-channel boxes of
//      the window's rows, rank-4 tensor maps) by TMA into a ring of two
//      stages; consumer warpgroup w takes heads w, w + 2, .. of the group.
//      Per head, on wgmma with one window per m64 tile: S = q k^T and
//      dP = do v^T (m64n64, K-major at the head's columns); the f32 softmax
//      and ds = pf (dP - rowsum(dP pf)) in registers, ds summed into the
//      head's dbias in registers; p and dsb to shared memory; then
//      o = p v, dq = dsb k (p, dsb from registers) and dv = p^T do,
//      dk = dsb^T q (p, dsb read MN-major from shared memory), all
//      m64n{dh}k16 with v, k, do and q as MN-major operands: no transposed
//      copies. Writes o and dqkv [T, 3C] and a dbias partial per slot.
//   5. gemm_run, split over tokens (ops/swin_block.py split_k_plan):
//      dWproj = dyf^T o and dWqkv = dqkv^T xn as per-slot f32 partials,
//      both operands MN-major; colsum_bf16: dbproj, dbqkv.
//   6. gemm_run: dxn = dqkv Wqkv (f32); ln_bwd_rows: dx and dLN partials.
//   7. reduce_slots: every partial buffer, slots added in index order.
//
// gemm_run is the TMA + wgmma GEMM of sm90_gemm.cuh. No atomics: every
// gradient sum is deterministic. Partial buffers stay near 16 MB (at most
// 256 slot tiles of 128 x 128 for the weights; window groups x heads
// <= 1024 for dbias).
//
// The f32 version runs the same passes on the CUDA cores (gemm and
// attn_core_bwd of swin_bwd_common.cuh / below); it is off the bf16 main
// path and held against the same plain version.
//
// What bounds it: the products, 22*C^2 + 12*N*C operations per token
// (the qkv product and the attention are recomputed), far above the
// card's bytes-to-operations balance.
//
// Rounding points (as _branch_pullback): the recomputed forward's xn, qkv,
// q * scale, p and o; dyf; do; ds once (as dsb) before its products; dq,
// dk, dv; dq * scale; dx before the identity-path add, and the sum.

#include "swin_attn_sm90.cuh"


namespace swin {

constexpr int kMaxN = 64;  // window of at most 8 x 8 tokens
constexpr int kLdQ = 33;   // pitch of the q/k/v/do tiles (dh <= 32, +1)
constexpr int kLdS = 65;   // pitch of the score tiles
constexpr int kCoreSmemFloats = 4 * kMaxN * kLdQ + 2 * kMaxN * kLdS;

struct AttnBwdDims {
  int B, Hp, Wp, C, H, ws;
  __host__ __device__ long long T() const {
    return static_cast<long long>(B) * Hp * Wp;
  }
  __host__ __device__ int nW() const { return B * (Hp / ws) * (Wp / ws); }
};

// windows per attn_core_bwd block: about 1024 blocks in all
inline int core_group(const AttnBwdDims& d) {
  const long long pairs = static_cast<long long>(d.nW()) * d.H;
  const long long g = (pairs + 1023) / 1024;
  return static_cast<int>(g < 1 ? 1 : g);
}

struct EpiQkv {  // qkv = acc + b; q: q * scale
  float* out;
  const float* b;
  int C;
  float scale;
  __device__ void operator()(long long m, int n, int, float v) const {
    v += b[n];
    out[m * 3 * C + n] = n < C ? v * scale : v;
  }
};

__global__ void __launch_bounds__(kThreads)
    attn_core_bwd(const float* __restrict__ qkv, const float* __restrict__ dO,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask, float* __restrict__ o,
                  float* __restrict__ dqkv, float* __restrict__ dbias_part,
                  AttnBwdDims d, int group, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;  // [kMaxN][kLdQ] each
  float* ks = qs + kMaxN * kLdQ;
  float* vs = ks + kMaxN * kLdQ;
  float* dos = vs + kMaxN * kLdQ;
  float* ps = dos + kMaxN * kLdQ;  // [kMaxN][kLdS] f32 softmax
  float* ds = ps + kMaxN * kLdS;   // [kMaxN][kLdS] dp, then ds
  const int ws = d.ws, N = ws * ws, C = d.C, dh = C / d.H;
  const int nWw = d.Wp / ws, nWin = (d.Hp / ws) * nWw;
  const int h = blockIdx.y;
  const float sc = scale;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  const int w0 = blockIdx.x * group;
  const int w1 = min(d.nW(), w0 + group);

  float dbias[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dbias[i][j] = 0.f;

  for (int w = w0; w < w1; ++w) {
    const int b = w / nWin, wi = w % nWin;
    const int wy = wi / nWw, wx = wi % nWw;
    auto tok = [&](int t) -> long long {
      return (static_cast<long long>(b) * d.Hp + wy * ws + t / ws) * d.Wp +
             wx * ws + t % ws;
    };

    // 1. the head's q (scaled), k, v and do of the window's tokens
    for (int i = tid; i < kMaxN * 32; i += kThreads) {
      const int t = i / 32, c = i % 32;
      float q = 0.f, k = 0.f, v = 0.f, g = 0.f;
      if (t < N && c < dh) {
        const long long r = tok(t);
        const float* row = qkv + r * 3 * C + h * dh + c;
        q = row[0];
        k = row[C];
        v = row[2 * C];
        g = dO[r * C + h * dh + c];
      }
      qs[t * kLdQ + c] = q;
      ks[t * kLdQ + c] = k;
      vs[t * kLdQ + c] = v;
      dos[t * kLdQ + c] = g;
    }
    __syncthreads();

    // 2. scores + rel-pos bias + mask (f32)
    {
      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
      for (int c = 0; c < dh; ++c) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kLdQ + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLdQ + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
      }
      const float* mask_w =
          mask ? mask + static_cast<size_t>(wi) * N * N : nullptr;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float v = 0.f;
          if (r < N && c < N) {
            v = sacc[i][j] + bias_h[r * N + c];
            if (mask_w) v += mask_w[r * N + c];
          }
          ps[r * kLdS + c] = v;
        }
      }
    }
    __syncthreads();

    // 3. f32 softmax per row (entries beyond N, and rows beyond N, are 0)
    for (int r = warp; r < kMaxN; r += kWarps) {
      if (r >= N) {
        ps[r * kLdS + lane] = 0.f;
        ps[r * kLdS + lane + 32] = 0.f;
        continue;
      }
      const float v0 = lane < N ? ps[r * kLdS + lane] : -INFINITY;
      const float v1 = lane + 32 < N ? ps[r * kLdS + lane + 32] : -INFINITY;
      const float m = warp_max(fmaxf(v0, v1));
      const float e0 = lane < N ? expf(v0 - m) : 0.f;
      const float e1 = lane + 32 < N ? expf(v1 - m) : 0.f;
      const float s = warp_sum(e0 + e1);
      ps[r * kLdS + lane] = e0 / s;
      ps[r * kLdS + lane + 32] = e1 / s;
    }
    __syncthreads();

    // 4. dp = do v^T -> ds buffer; o = p v and dv = p^T do (p rounded)
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < dh; ++c) {
        float gv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = dos[(ty + 16 * i) * kLdQ + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = vs[(tx + 16 * j) * kLdQ + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(gv[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ds[(ty + 16 * i) * kLdS + tx + 16 * j] = acc[i][j];
    }
    {
      float oacc[4][2], vacc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        oacc[i][0] = oacc[i][1] = vacc[i][0] = vacc[i][1] = 0.f;
      for (int j = 0; j < N; ++j) {
        float pr[4], pc[4], vv[2], gv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[(ty + 16 * i) * kLdS + j];  // p[row][j]
          pc[i] = ps[j * kLdS + ty + 16 * i];    // p[j][row]
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          vv[q] = vs[j * kLdQ + tx + 16 * q];
          gv[q] = dos[j * kLdQ + tx + 16 * q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            oacc[i][q] = fmaf(pr[i], vv[q], oacc[i][q]);
            vacc[i][q] = fmaf(pc[i], gv[q], vacc[i][q]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= N) continue;
        const long long r = tok(t);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = tx + 16 * q;
          if (c >= dh) continue;
          o[r * C + h * dh + c] = oacc[i][q];
          dqkv[r * 3 * C + 2 * C + h * dh + c] = vacc[i][q];
        }
      }
    }
    __syncthreads();

    // 5. ds = pf * (dp - sum_j dp pf), f32, per row
    for (int r = warp; r < kMaxN; r += kWarps) {
      const float p0 = ps[r * kLdS + lane], p1 = ps[r * kLdS + lane + 32];
      const float g0 = ds[r * kLdS + lane], g1 = ds[r * kLdS + lane + 32];
      const float s = warp_sum(g0 * p0 + g1 * p1);
      ds[r * kLdS + lane] = p0 * (g0 - s);
      ds[r * kLdS + lane + 32] = p1 * (g1 - s);
    }
    __syncthreads();

    // 6. dbias += ds; dq = dsb k; dk = dsb^T q (dsb = ds rounded)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dbias[i][j] += ds[(ty + 16 * i) * kLdS + tx + 16 * j];
    {
      float qacc[4][2], kacc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qacc[i][0] = qacc[i][1] = kacc[i][0] = kacc[i][1] = 0.f;
      for (int j = 0; j < N; ++j) {
        float sr[4], sc[4], kv[2], qv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sr[i] = ds[(ty + 16 * i) * kLdS + j];  // ds[row][j]
          sc[i] = ds[j * kLdS + ty + 16 * i];    // ds[j][row]
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          kv[q] = ks[j * kLdQ + tx + 16 * q];
          qv[q] = qs[j * kLdQ + tx + 16 * q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            qacc[i][q] = fmaf(sr[i], kv[q], qacc[i][q]);
            kacc[i][q] = fmaf(sc[i], qv[q], kacc[i][q]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= N) continue;
        const long long r = tok(t);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = tx + 16 * q;
          if (c >= dh) continue;
          float* row = dqkv + r * 3 * C + h * dh + c;
          row[0] = qacc[i][q] * sc;
          row[C] = kacc[i][q];
        }
      }
    }
    __syncthreads();
  }

  float* part = dbias_part +
                (static_cast<size_t>(blockIdx.x) * d.H + h) * N * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < N && c < N) part[r * N + c] = dbias[i][j];
    }
}
// the workspace, carved in one order for measuring and for use
struct AttnBwdWork {
  float *mu, *rstd, *p_wproj, *p_bproj, *p_wqkv, *p_bqkv, *p_bias, *p_g,
      *p_b, *dxn;
  float *xn, *qkv, *dyf, *dO, *o, *dqkv;
  int s_proj, s_qkv, groups;

  AttnBwdWork(Carver& cv, const AttnBwdDims& d) {
    const long long T_ = d.T();
    const int C = d.C, N = d.ws * d.ws;
    s_proj = gemm_splits(C, C, T_);
    s_qkv = gemm_splits(3 * C, C, T_);
    groups = (d.nW() + core_group(d) - 1) / core_group(d);
    mu = cv.take<float>(T_);
    rstd = cv.take<float>(T_);
    xn = cv.take<float>(T_ * C);
    qkv = cv.take<float>(T_ * 3 * C);
    dyf = cv.take<float>(T_ * C);
    dO = cv.take<float>(T_ * C);
    o = cv.take<float>(T_ * C);
    dqkv = cv.take<float>(T_ * 3 * C);
    dxn = cv.take<float>(T_ * C);
    p_wproj = cv.take<float>(static_cast<size_t>(s_proj) * C * C);
    p_wqkv = cv.take<float>(static_cast<size_t>(s_qkv) * 3 * C * C);
    p_bproj = cv.take<float>(colsum_part_floats(T_, C));
    p_bqkv = cv.take<float>(colsum_part_floats(T_, 3 * C));
    p_bias = cv.take<float>(static_cast<size_t>(groups) * d.H * N * N);
    p_g = cv.take<float>(ln_bwd_part_floats(T_, C));
    p_b = cv.take<float>(ln_bwd_part_floats(T_, C));
  }
};


struct AttnBwdArgs {
  const void *x, *dy;
  void* dx;
  const float *ln_s, *ln_b, *wqkv, *bqkv, *wproj, *bproj, *bias, *mask, *dp;
  float *dln_s, *dln_b, *dwqkv, *dbqkv, *dwproj, *dbproj, *dbias;
  void* work;
  float scale;
};

// f32: the passes on the CUDA cores
int run_attn_bwd_f32(const AttnBwdArgs& a, const AttnBwdDims& d,
                     cudaStream_t s) {
  Carver cv{static_cast<char*>(a.work)};
  AttnBwdWork w(cv, d);
  const long long T_ = d.T();
  const int C = d.C, N = d.ws * d.ws;
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  const float scale = a.scale;

  SWIN_TRY(launch_ln_rows(x, a.ln_s, a.ln_b, w.xn, w.mu, w.rstd, T_, C, s));
  SWIN_TRY((gemm<true, true>(w.xn, a.wqkv, T_, 3 * C, C, C, C, 1,
                             EpiQkv{w.qkv, a.bqkv, C, scale}, s)));
  SWIN_TRY(launch_scale_rows(dy, a.dp, w.dyf, T_, C,
                             static_cast<long long>(d.Hp) * d.Wp, s));
  SWIN_TRY((gemm<true, false>(w.dyf, a.wproj, T_, C, C, C, C, 1,
                              EpiF32{w.dO, C}, s)));
  const int smem = kCoreSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      attn_core_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  attn_core_bwd<<<dim3(w.groups, d.H), kThreads, smem, s>>>(
      w.qkv, w.dO, a.bias, a.mask, w.o, w.dqkv, w.p_bias, d, core_group(d),
      scale);
  SWIN_TRY(static_cast<int>(cudaGetLastError()));
  SWIN_TRY((gemm<false, false>(w.dyf, w.o, C, C, T_, C, C, w.s_proj,
                               EpiPartial{w.p_wproj, C, C}, s)));
  SWIN_TRY((gemm<false, false>(w.dqkv, w.xn, 3 * C, C, T_, 3 * C, C, w.s_qkv,
                               EpiPartial{w.p_wqkv, 3 * C, C}, s)));
  SWIN_TRY((gemm<true, false>(w.dqkv, a.wqkv, T_, C, 3 * C, 3 * C, C, 1,
                              EpiF32{w.dxn, C}, s)));
  SWIN_TRY(launch_ln_bwd(x, dy, w.dxn, w.mu, w.rstd, a.ln_s,
                         static_cast<float*>(a.dx), w.p_g, w.p_b, a.dln_s,
                         a.dln_b, T_, C, s));
  SWIN_TRY(launch_colsum(w.dyf, w.p_bproj, a.dbproj, T_, C, s));
  SWIN_TRY(launch_colsum(w.dqkv, w.p_bqkv, a.dbqkv, T_, 3 * C, s));
  SWIN_TRY(launch_reduce(w.p_wproj, a.dwproj, gemm_used_splits(T_, w.s_proj),
                         static_cast<long long>(C) * C, s));
  SWIN_TRY(launch_reduce(w.p_wqkv, a.dwqkv, gemm_used_splits(T_, w.s_qkv),
                         3LL * C * C, s));
  return launch_reduce(w.p_bias, a.dbias, w.groups,
                       static_cast<long long>(d.H) * N * N, s);
}

// ---------------------------------------------------------------------------
// bf16: pass 4 on wgmma (attn_core_bwd_sm90), the products on gemm_run.
// ---------------------------------------------------------------------------
constexpr int kCoreStages = 2;   // windows in flight
using CoreRoles = WarpRoles<2>;  // two consumer warpgroups, a producer warp
constexpr int kTile = kWinRows * 64;  // a 64 x 64 bf16 tile

struct CoreSmem {  // at the 1024-aligned start of dynamic shared memory
  bf16 t[kCoreStages][4][kTile];  // q, k, v, do: the group's 64 channels
  bf16 p[2][kTile];               // per consumer warpgroup: p [query][key]
  bf16 ds[2][kTile];              // and dsb
  uint64_t full[kCoreStages], empty[kCoreStages];
};
constexpr int kCoreSmemBytes = static_cast<int>(sizeof(CoreSmem)) + 1024;

struct CoreArgs {
  bf16* o;            // [T, C]
  bf16* dqkv;         // [T, 3C]
  float* dbias_part;  // [slots][H][N][N]
  const float* bias;  // [H, N, N]
  const float* mask;  // [nW, N, N] or null
  float scale;        // dh^-1/2
  int Hp, Wp, C, H, ws, nW, per, groups;  // per: windows of a slot
};

// Window group (slot) blockIdx.x / groups, head group blockIdx.x % groups.
template <int DH>
__global__ void __launch_bounds__(CoreRoles::kThreads, 1)
    attn_core_bwd_sm90(const __grid_constant__ CUtensorMap tqkv,
                       const __grid_constant__ CUtensorMap tdo, CoreArgs a) {
  constexpr int G = 64 / DH;           // heads of a group
  constexpr int kHeadsWg = (G + 1) / 2;  // of a consumer warpgroup
  CoreSmem& s = *reinterpret_cast<CoreSmem*>(smem_base_1k());
  const int g = blockIdx.x % a.groups, slot = blockIdx.x / a.groups;
  const int w0 = slot * a.per, w1 = min(a.nW, w0 + a.per);
  const int ws = a.ws, N = ws * ws, C = a.C;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kCoreStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], CoreRoles::kConsumerWarps);
    }
    fence_barrier_init();
  }
  if (N < kWinRows) {  // rows >= N of the stages stay zero (TMA writes N)
    const int per_tile = (kWinRows - N) * 8;  // 16-byte pieces
    for (int i = threadIdx.x; i < kCoreStages * 4 * per_tile;
         i += blockDim.x) {
      bf16* tile = s.t[0][0] + (i / per_tile) * kTile;
      *reinterpret_cast<uint4*>(tile + N * 64 + (i % per_tile) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_smem();
  }
  __syncthreads();
  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == CoreRoles::kProducerThread) {
      for (int w = w0; w < w1; ++w) {
        const int i = w - w0, st = i % kCoreStages;
        const WindowAt win(w, a.Hp, a.Wp, ws);
        mbar_wait(&s.empty[st], ((i / kCoreStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 4 * N * 128);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          tma_load_4d(s.t[st][p], &tqkv, &s.full[st], p * C + g * 64,
                      win.x0, win.y0, win.b);
        tma_load_4d(s.t[st][3], &tdo, &s.full[st], g * 64, win.x0, win.y0,
                    win.b);
      }
    }
    return;
  }

  const int tid = threadIdx.x % kWgThreads, lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const float sc = round_bf16(a.scale);
  unsigned char* pt = reinterpret_cast<unsigned char*>(s.p[wg]);
  unsigned char* dt = reinterpret_cast<unsigned char*>(s.ds[wg]);
  const uint64_t dpt = sw128_desc(pt), ddt = sw128_desc(dt);
  float dbias[kHeadsWg][32];
#pragma unroll
  for (int j = 0; j < kHeadsWg; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dbias[j][i] = 0.f;

  for (int w = w0; w < w1; ++w) {
    const int i = w - w0, st = i % kCoreStages;
    const WindowAt win(w, a.Hp, a.Wp, ws);
    const float* mask_w =
        a.mask ? a.mask + static_cast<size_t>(win.wi) * N * N : nullptr;
    mbar_wait_warp(&s.full[st], (i / kCoreStages) & 1);
#pragma unroll
    for (int j = 0; j < kHeadsWg; ++j) {
      const int hl = wg + 2 * j, head = g * G + hl;
      if (hl >= G || head >= a.H) continue;  // (uniform in the warpgroup)
      const uint64_t hoff = (hl * DH * 2) >> 4;  // the head's columns
      const uint64_t dq = sw128_desc(s.t[st][0]) + hoff,
                     dk = sw128_desc(s.t[st][1]) + hoff,
                     dv = sw128_desc(s.t[st][2]) + hoff,
                     ddo = sw128_desc(s.t[st][3]) + hoff;
      // S = q k^T, dP = do v^T (64 x 64, K = dh)
      float sacc[32], dpacc[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        Wg<64>::ss<0, 0>(sacc, dq + ks * kDescKStep, dk + ks * kDescKStep,
                         ks > 0);
        Wg<64>::ss<0, 0>(dpacc, ddo + ks * kDescKStep, dv + ks * kDescKStep,
                         ks > 0);
      }
      wg_commit();
      // the rel-pos bias and the mask, loaded while the products run (0
      // beyond N)
      const float* bias_h = a.bias + static_cast<size_t>(head) * N * N;
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
      fence_regs(dpacc);
      // + bias + mask, f32 softmax (pf), ds = pf (dP - rowsum(dP pf));
      // 0 beyond N (rows and keys)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 8 * (e >> 1), col = 8 * q + c0 + (e & 1);
          float v = -INFINITY;
          if (r < N && col < N) {
            v = sacc[4 * q + e] + bh[4 * q + e];
            if (mask_w) v += mk[4 * q + e];
          }
          sacc[4 * q + e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float m = mx[(e >> 1) & 1];
        const float ex = m == -INFINITY ? 0.f : expf(sacc[e] - m);
        sacc[e] = ex;
        sum[(e >> 1) & 1] += ex;
      }
      sum[0] = quad_sum(sum[0]);
      sum[1] = quad_sum(sum[1]);
      const float inv[2] = {sum[0] > 0.f ? 1.f / sum[0] : 0.f,
                            sum[1] > 0.f ? 1.f / sum[1] : 0.f};
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sacc[e] *= inv[(e >> 1) & 1];
        rs[(e >> 1) & 1] += dpacc[e] * sacc[e];
      }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        dpacc[e] = sacc[e] * (dpacc[e] - rs[(e >> 1) & 1]);  // ds, f32
        dbias[j][e] += dpacc[e];
      }
      uint32_t pa[4][4], sa[4][4];
      acc_to_a(pa, sacc);   // p, rounded
      acc_to_a(sa, dpacc);  // dsb, rounded
      // the same p and dsb, [query][key], for the MN-major A of dv, dk
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 8 * q + c0;
        *reinterpret_cast<uint32_t*>(pt + sw128_off(r0, col)) =
            pa[q / 2][2 * (q % 2)];
        *reinterpret_cast<uint32_t*>(pt + sw128_off(r0 + 8, col)) =
            pa[q / 2][2 * (q % 2) + 1];
        *reinterpret_cast<uint32_t*>(dt + sw128_off(r0, col)) =
            sa[q / 2][2 * (q % 2)];
        *reinterpret_cast<uint32_t*>(dt + sw128_off(r0 + 8, col)) =
            sa[q / 2][2 * (q % 2) + 1];
      }
      fence_async_smem();
      wg_bar(wg);
      // o = p v, dq = dsb k, dv = p^T do, dk = dsb^T q (64 x dh, K = 64)
      float o[DH / 2], gq[DH / 2], gk[DH / 2], gv[DH / 2];
      fence_regs(pa);
      fence_regs(sa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t step = kk * kDescRows16;
        Wg<DH>::template rs<1>(o, pa[kk], dv + step, kk > 0);
        Wg<DH>::template rs<1>(gq, sa[kk], dk + step, kk > 0);
        Wg<DH>::template ss<1, 1>(gv, dpt + step, ddo + step, kk > 0);
        Wg<DH>::template ss<1, 1>(gk, ddt + step, dq + step, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      fence_regs(gq);
      fence_regs(gk);
      fence_regs(gv);
      wg_bar(wg);  // p and dsb are read: the next head may overwrite them
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r >= N) continue;
        const long long tok = win.token(r, a.Hp, a.Wp, ws);
        bf16* O = a.o + tok * C + head * DH;
        bf16* D = a.dqkv + tok * 3 * C + head * DH;
#pragma unroll
        for (int q = 0; q < DH / 8; ++q) {
          const int col = 8 * q + c0, e = 4 * q + 2 * half;
          store_bf16x2(O + col, o[e], o[e + 1]);
          store_bf16x2(D + col, round_bf16(gq[e]) * sc,
                       round_bf16(gq[e + 1]) * sc);
          store_bf16x2(D + C + col, gk[e], gk[e + 1]);
          store_bf16x2(D + 2 * C + col, gv[e], gv[e + 1]);
        }
      }
    }
    warp_arrive(&s.empty[st]);
  }
#pragma unroll
  for (int j = 0; j < kHeadsWg; ++j) {
    const int hl = wg + 2 * j, head = g * G + hl;
    if (hl >= G || head >= a.H) continue;
    float* part = a.dbias_part +
                  (static_cast<size_t>(slot) * a.H + head) * N * N;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + c0 + (e & 1);
      if (r < N && col < N) part[r * N + col] = dbias[j][e];
    }
  }
}

// window slots of attn_core_bwd_sm90: slots x heads <= 1024, so the dbias
// partials stay within 16 MB
inline int core_per(const AttnBwdDims& d) {
  const int slots = d.H >= 1024 ? 1 : 1024 / d.H;
  return (d.nW() + slots - 1) / slots;
}

// the bf16 workspace, carved in one order for measuring and for use
struct BwdWorkBf16 {
  bf16 *wqkv_b, *wproj_b, *xn, *qkv, *dyf, *dO, *o, *dqkv;
  float *mu, *rstd, *dxn, *p_wproj, *p_wqkv, *p_bproj, *p_bqkv, *p_bias,
      *p_g, *p_b;
  int slots_proj, slots_qkv, core_slots;

  BwdWorkBf16(Carver& cv, const AttnBwdDims& d, int kchunk_proj,
              int kchunk_qkv) {
    const long long T_ = d.T();
    const int C = d.C, N = d.ws * d.ws;
    slots_proj = gemm_slots(T_, kchunk_proj);
    slots_qkv = gemm_slots(T_, kchunk_qkv);
    core_slots = (d.nW() + core_per(d) - 1) / core_per(d);
    wqkv_b = cv.take<bf16>(3LL * C * C);
    wproj_b = cv.take<bf16>(static_cast<long long>(C) * C);
    mu = cv.take<float>(T_);
    rstd = cv.take<float>(T_);
    xn = cv.take<bf16>(T_ * C);
    qkv = cv.take<bf16>(T_ * 3 * C);
    dyf = cv.take<bf16>(T_ * C);
    dO = cv.take<bf16>(T_ * C);
    o = cv.take<bf16>(T_ * C);
    dqkv = cv.take<bf16>(T_ * 3 * C);
    dxn = cv.take<float>(T_ * C);
    p_wproj = cv.take<float>(static_cast<size_t>(slots_proj) * C * C);
    p_wqkv = cv.take<float>(static_cast<size_t>(slots_qkv) * 3 * C * C);
    p_bproj = cv.take<float>(colsum_part_floats(T_, C));
    p_bqkv = cv.take<float>(colsum_part_floats(T_, 3 * C));
    p_bias = cv.take<float>(static_cast<size_t>(core_slots) * d.H * N * N);
    p_g = cv.take<float>(ln_bwd_part_floats(T_, C));
    p_b = cv.take<float>(ln_bwd_part_floats(T_, C));
  }
};

template <int DH>
int launch_core_sm90(const BwdWorkBf16& w, const AttnBwdArgs& a,
                     const AttnBwdDims& d, cudaStream_t s) {
  const int C = d.C, groups = (d.H + 64 / DH - 1) / (64 / DH);
  CUtensorMap tqkv, tdo;
  SWIN_TRY(make_map_window(&tqkv, w.qkv, d.B, d.Hp, d.Wp, 3 * C, d.ws));
  SWIN_TRY(make_map_window(&tdo, w.dO, d.B, d.Hp, d.Wp, C, d.ws));
  static std::atomic<unsigned long long> smem_set{0};
  SWIN_TRY(smem_limit_once(
      smem_set, reinterpret_cast<const void*>(attn_core_bwd_sm90<DH>),
      kCoreSmemBytes));
  const CoreArgs ca{w.o,  w.dqkv, w.p_bias, a.bias,     a.mask,
                    a.scale, d.Hp, d.Wp,   C,          d.H,
                    d.ws, d.nW(), core_per(d), groups};
  attn_core_bwd_sm90<DH><<<w.core_slots * groups, CoreRoles::kThreads,
                           kCoreSmemBytes, s>>>(tqkv, tdo, ca);
  return static_cast<int>(cudaGetLastError());
}

int run_attn_bwd_bf16(const AttnBwdArgs& a, const AttnBwdDims& d,
                      int kchunk_proj, int kchunk_qkv, cudaStream_t s) {
  Carver cv{static_cast<char*>(a.work)};
  const BwdWorkBf16 w(cv, d, kchunk_proj, kchunk_qkv);
  const int T_ = static_cast<int>(d.T());
  const int C = d.C, N = d.ws * d.ws;
  const int kc1 = (C + kGemmK - 1) / kGemmK * kGemmK;  // one slot of K = C
  const int kc3 = (3 * C + kGemmK - 1) / kGemmK * kGemmK;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* dy = static_cast<const bf16*>(a.dy);

  SWIN_TRY(launch_cast_weights<K1b>(a.wqkv, 3LL * C * C, a.wproj,
                                    static_cast<long long>(C) * C, w.wqkv_b,
                                    w.wproj_b, s));
  SWIN_TRY(launch_ln_rows_bf16<K1b>(x, a.ln_s, a.ln_b, w.xn, w.mu, w.rstd,
                                    T_, C, s));
  SWIN_TRY((gemm_run<false, false, K1b>(
      w.xn, C, w.wqkv_b, C, T_, 3 * C, C, kc1,
      EpiQkvBf16{w.qkv, a.bqkv, C, a.scale}, s)));
  SWIN_TRY(launch_scale_rows_bf16<K1b>(
      dy, a.dp, w.dyf, T_, C, static_cast<long long>(d.Hp) * d.Wp, s));
  SWIN_TRY((gemm_run<false, true, K1b>(w.dyf, C, w.wproj_b, C, T_, C, C,
                                       kc1, EpiOutBf16{w.dO, C, nullptr},
                                       s)));
  SWIN_TRY(C / d.H == 32 ? launch_core_sm90<32>(w, a, d, s)
                         : launch_core_sm90<16>(w, a, d, s));
  SWIN_TRY((gemm_run<true, true, K1b>(w.dyf, C, w.o, C, C, C, T_,
                                      kchunk_proj,
                                      EpiSlot{w.p_wproj, C, C}, s)));
  SWIN_TRY((gemm_run<true, true, K1b>(w.dqkv, 3 * C, w.xn, C, 3 * C, C, T_,
                                      kchunk_qkv,
                                      EpiSlot{w.p_wqkv, 3 * C, C}, s)));
  SWIN_TRY((gemm_run<false, true, K1b>(w.dqkv, 3 * C, w.wqkv_b, C, T_, C,
                                       3 * C, kc3, EpiOutF32{w.dxn, C},
                                       s)));
  SWIN_TRY(launch_ln_bwd_rows<K1b>(x, dy, w.dxn, w.mu, w.rstd, a.ln_s,
                                   static_cast<bf16*>(a.dx), w.p_g, w.p_b,
                                   a.dln_s, a.dln_b, T_, C, s));
  SWIN_TRY(launch_colsum_bf16<K1b>(w.dyf, w.p_bproj, a.dbproj, T_, C, s));
  SWIN_TRY(
      launch_colsum_bf16<K1b>(w.dqkv, w.p_bqkv, a.dbqkv, T_, 3 * C, s));
  SWIN_TRY(launch_reduce<K1b>(w.p_wproj, a.dwproj, w.slots_proj,
                              static_cast<long long>(C) * C, s));
  SWIN_TRY(
      launch_reduce<K1b>(w.p_wqkv, a.dwqkv, w.slots_qkv, 3LL * C * C, s));
  return launch_reduce<K1b>(w.p_bias, a.dbias, w.core_slots,
                            static_cast<long long>(d.H) * N * N, s);
}

bool attn_dims_ok(const AttnBwdDims& d, int is_bf16, int kchunk_proj,
                  int kchunk_qkv) {
  if (d.B < 1 || d.ws < 1 || d.ws * d.ws > kMaxN || d.H < 1 ||
      d.C % d.H != 0 || d.C / d.H > 32 || d.C > 32 * kMaxLane ||
      d.Hp % d.ws != 0 || d.Wp % d.ws != 0)
    return false;
  if (!is_bf16) return true;
  const int dh = d.C / d.H;
  return (dh == 16 || dh == 32) && d.C % 8 == 0 && d.T() < (1LL << 31) &&
         kchunk_proj >= kGemmK && kchunk_proj % kGemmK == 0 &&
         kchunk_qkv >= kGemmK && kchunk_qkv % kGemmK == 0;
}

}  // namespace swin

// kchunk_proj / kchunk_qkv: tokens of a slot of the split-K dWproj and
// dWqkv products (bf16; ops/swin_block.py split_k_plan), ignored in f32.
extern "C" long long swin_attn_bwd_workspace(int B, int Hp, int Wp, int C,
                                             int H, int ws, int is_bf16,
                                             int kchunk_proj,
                                             int kchunk_qkv) {
  const swin::AttnBwdDims d{B, Hp, Wp, C, H, ws};
  if (!swin::attn_dims_ok(d, is_bf16, kchunk_proj, kchunk_qkv)) return 0;
  swin::Carver cv{nullptr};
  if (is_bf16) {
    swin::BwdWorkBf16 w(cv, d, kchunk_proj, kchunk_qkv);
  } else {
    swin::AttnBwdWork w(cv, d);
  }
  return static_cast<long long>(cv.off);
}

extern "C" int swin_attn_bwd(
    const void* x, const void* dy, void* dx, const float* ln_s,
    const float* ln_b, const float* wqkv, const float* bqkv,
    const float* wproj, const float* bproj, const float* bias,
    const float* mask, const float* dp, float* dln_s, float* dln_b,
    float* dwqkv, float* dbqkv, float* dwproj, float* dbproj, float* dbias,
    void* work, float scale, int B, int Hp, int Wp, int C, int H, int ws,
    int is_bf16, int kchunk_proj, int kchunk_qkv, void* stream) {
  const swin::AttnBwdDims d{B, Hp, Wp, C, H, ws};
  if (!swin::attn_dims_ok(d, is_bf16, kchunk_proj, kchunk_qkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const swin::AttnBwdArgs a{x,     dy,    dx,     ln_s,  ln_b,   wqkv,
                            bqkv,  wproj, bproj,  bias,  mask,   dp,
                            dln_s, dln_b, dwqkv,  dbqkv, dwproj, dbproj,
                            dbias, work,  scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::run_attn_bwd_bf16(a, d, kchunk_proj, kchunk_qkv, s)
                 : swin::run_attn_bwd_f32(a, d, s);
}
