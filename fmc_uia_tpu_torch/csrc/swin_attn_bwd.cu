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
// memory, so the pullback is split into the passes below (T = B*Hp*Wp
// tokens, intermediates in a workspace in device memory):
//
//   1. ln_rows: f32 LN statistics and xn = LN1(x), rounded.
//   2. gemm: qkv = xn Wqkv^T + bqkv, rounded; q times dh^-1/2, rounded.
//   3. scale_rows: dyf = dy * dp, rounded; gemm: do = dyf Wproj, rounded.
//   4. attn_core_bwd (f32, CUDA-core FMAs) / attn_core_bwd_tc (bf16,
//      tensor cores): one block per (group of windows, head). For each of
//      its windows it rebuilds the scores, the f32 softmax and o = p v from
//      q, k, v, then dv = p^T do, dp = do v^T, ds = pf (dp - rowsum(dp pf)),
//      dq = ds k (times dh^-1/2), dk = ds^T q; it writes o and dqkv [T, 3C]
//      and adds ds into the block's dbias partial.
//   5. gemm (split over tokens): dWproj = dyf^T o, dWqkv = dqkv^T xn, into
//      per-split partials; colsum: dbproj, dbqkv.
//   6. gemm: dxn = dqkv Wqkv (f32); ln_bwd: dx and dLN partials.
//   7. reduce_slots: every partial buffer, slots added in index order.
//
// No atomics: every gradient sum is deterministic. Partial buffers stay
// near 16 MB (about 1024 blocks of 64 x 64 tiles, at most 256 row slots).
//
// What bounds it: the products, 22*C^2 + 12*N*C operations per token
// (the qkv product and the attention are recomputed), far above the
// card's bytes-to-operations balance. In bf16 every product runs on the
// tensor cores (WMMA). Not done yet: the passes round-trip their
// intermediates through device memory (the TPU kernel keeps them in VMEM);
// no TMA/cp.async pipeline and no wgmma.
//
// Rounding points (as _branch_pullback): the recomputed forward's xn, qkv,
// q * scale, p and o; dyf; do; ds once (as dsb) before its products; dq,
// dk, dv; dq * scale; dx before the identity-path add, and the sum.

#include "swin_bwd_common.cuh"

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

template <typename T>
struct EpiQkv {  // qkv = round(acc + b); q: round(round(q) * scale)
  T* out;
  const float* b;
  int C;
  float scale;
  __device__ void operator()(long long m, int n, int, float v) const {
    v = rnd<T>(v + b[n]);
    out[m * 3 * C + n] = from_f<T>(n < C ? v * rnd<T>(scale) : v);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_core_bwd(const T* __restrict__ qkv, const T* __restrict__ dO,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask, T* __restrict__ o,
                  T* __restrict__ dqkv, float* __restrict__ dbias_part,
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
  const float sc = rnd<T>(scale);
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
        const T* row = qkv + r * 3 * C + h * dh + c;
        q = to_f(row[0]);
        k = to_f(row[C]);
        v = to_f(row[2 * C]);
        g = to_f(dO[r * C + h * dh + c]);
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
          pr[i] = rnd<T>(ps[(ty + 16 * i) * kLdS + j]);  // p[row][j]
          pc[i] = rnd<T>(ps[j * kLdS + ty + 16 * i]);    // p[j][row]
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
          o[r * C + h * dh + c] = from_f<T>(oacc[i][q]);
          dqkv[r * 3 * C + 2 * C + h * dh + c] = from_f<T>(vacc[i][q]);
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
          sr[i] = rnd<T>(ds[(ty + 16 * i) * kLdS + j]);  // ds[row][j]
          sc[i] = rnd<T>(ds[j * kLdS + ty + 16 * i]);    // ds[j][row]
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
          T* row = dqkv + r * 3 * C + h * dh + c;
          row[0] = from_f<T>(rnd<T>(qacc[i][q]) * sc);
          row[C] = from_f<T>(kacc[i][q]);
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

// ---------------------------------------------------------------------------
// bf16: the same per-(window, head) pullback with every product on the
// tensor cores (WMMA m16n16k16, bf16 operands, f32 accumulators), on the
// values the plain version rounds: q (scaled), k, v, do; p; dsb.
//   S = q k^T and dP = do v^T (64 x 64), then per row the f32 softmax, p
//   and ds = pf (dP - rowsum(dP pf)) (dsb rounded); then o = p v,
//   dv = p^T do, dq = dsb k, dk = dsb^T q (64 x dh) at once.
// ---------------------------------------------------------------------------
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragAc = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragBr = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int kLdHb = 32 + 8;       // bf16 pitch of q/k/v/do (dh <= 32)
constexpr int kLdPb = kMaxN + 8;    // bf16 pitch of p and dsb
constexpr int kLdSf = kMaxN + 4;    // f32 pitch of S/pf and dP/ds
constexpr int kLdOf = 32 + 4;       // f32 pitch of the four 64 x dh results
constexpr int kTcOffP = 4 * kMaxN * kLdHb * 2;
constexpr int kTcOffSb = kTcOffP + kMaxN * kLdPb * 2;
constexpr int kTcOffSf = kTcOffSb + kMaxN * kLdPb * 2;
constexpr int kTcOffDf = kTcOffSf + kMaxN * kLdSf * 4;
constexpr int kTcOffOut = kTcOffDf + kMaxN * kLdSf * 4;
constexpr int kCoreTcSmem = kTcOffOut + 4 * kMaxN * kLdOf * 4;

__global__ void __launch_bounds__(kThreads)
    attn_core_bwd_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ o,
                     bf16* __restrict__ dqkv, float* __restrict__ dbias_part,
                     AttnBwdDims d, int group, float scale) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* qs = reinterpret_cast<bf16*>(sm);  // [kMaxN][kLdHb] each
  bf16* ks = qs + kMaxN * kLdHb;
  bf16* vs = ks + kMaxN * kLdHb;
  bf16* gs = vs + kMaxN * kLdHb;           // do
  bf16* pb = reinterpret_cast<bf16*>(sm + kTcOffP);   // [kMaxN][kLdPb]
  bf16* sb = reinterpret_cast<bf16*>(sm + kTcOffSb);  // dsb
  float* sf = reinterpret_cast<float*>(sm + kTcOffSf);  // S, then pf
  float* df = reinterpret_cast<float*>(sm + kTcOffDf);  // dP, then ds
  float* outs = reinterpret_cast<float*>(sm + kTcOffOut);  // o, dv, dq, dk
  const int ws = d.ws, N = ws * ws, C = d.C, dh = C / d.H;
  const int nWw = d.Wp / ws, nWin = (d.Hp / ws) * nWw;
  const int h = blockIdx.y;
  const float sc = round_bf16(scale);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int wr = warp % 4, wq = warp / 4;  // row tile, column half
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

    // 1. q (scaled), k, v, do of the window, 16-byte vectors (0 beyond N
    //    and beyond dh)
    for (int i = tid; i < 4 * kMaxN * 4; i += kThreads) {
      const int which = i / (kMaxN * 4), t = (i / 4) % kMaxN;
      const int c = (i % 4) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < N && c < dh) {
        const long long r = tok(t);
        v = which < 3 ? ld16(qkv + r * 3 * C + which * C + h * dh + c)
                      : ld16(dO + r * C + h * dh + c);
      }
      *reinterpret_cast<uint4*>(qs + which * kMaxN * kLdHb + t * kLdHb +
                                c) = v;
    }
    __syncthreads();

    // 2. S = q k^T, dP = do v^T: warp (wr, wq) takes column tiles 2wq,
    //    2wq + 1 of both
    {
      FragC s2[2], p2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wm::fill_fragment(s2[j], 0.f);
        wm::fill_fragment(p2[j], 0.f);
      }
      for (int c0 = 0; c0 < dh; c0 += 16) {
        FragA fq, fg;
        wm::load_matrix_sync(fq, qs + wr * 16 * kLdHb + c0, kLdHb);
        wm::load_matrix_sync(fg, gs + wr * 16 * kLdHb + c0, kLdHb);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ct = wq * 2 + j;
          FragBc fk, fv;
          wm::load_matrix_sync(fk, ks + ct * 16 * kLdHb + c0, kLdHb);
          wm::load_matrix_sync(fv, vs + ct * 16 * kLdHb + c0, kLdHb);
          wm::mma_sync(s2[j], fq, fk, s2[j]);
          wm::mma_sync(p2[j], fg, fv, p2[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ct = wq * 2 + j;
        wm::store_matrix_sync(sf + wr * 16 * kLdSf + ct * 16, s2[j], kLdSf,
                              wm::mem_row_major);
        wm::store_matrix_sync(df + wr * 16 * kLdSf + ct * 16, p2[j], kLdSf,
                              wm::mem_row_major);
      }
    }
    __syncthreads();

    // 3. per row: + bias + mask, f32 softmax (pf, p rounded), then
    //    ds = pf (dP - sum_j dP pf) (f32, dsb rounded); 0 beyond N
    const float* mask_w =
        mask ? mask + static_cast<size_t>(wi) * N * N : nullptr;
    for (int r = warp; r < kMaxN; r += kWarps) {
      float e0 = 0.f, e1 = 0.f;
      if (r < N) {
        float v0 = -INFINITY, v1 = -INFINITY;
        if (lane < N) {
          v0 = sf[r * kLdSf + lane] + bias_h[r * N + lane];
          if (mask_w) v0 += mask_w[r * N + lane];
        }
        if (lane + 32 < N) {
          v1 = sf[r * kLdSf + lane + 32] + bias_h[r * N + lane + 32];
          if (mask_w) v1 += mask_w[r * N + lane + 32];
        }
        const float m = warp_max(fmaxf(v0, v1));
        e0 = lane < N ? expf(v0 - m) : 0.f;
        e1 = lane + 32 < N ? expf(v1 - m) : 0.f;
        const float s = warp_sum(e0 + e1);
        e0 /= s;
        e1 /= s;
      }
      const float g0 = df[r * kLdSf + lane], g1 = df[r * kLdSf + lane + 32];
      const float rs = warp_sum(g0 * e0 + g1 * e1);
      const float d0 = e0 * (g0 - rs), d1 = e1 * (g1 - rs);
      sf[r * kLdSf + lane] = e0;
      sf[r * kLdSf + lane + 32] = e1;
      df[r * kLdSf + lane] = d0;
      df[r * kLdSf + lane + 32] = d1;
      pb[r * kLdPb + lane] = __float2bfloat16_rn(e0);
      pb[r * kLdPb + lane + 32] = __float2bfloat16_rn(e1);
      sb[r * kLdPb + lane] = __float2bfloat16_rn(d0);
      sb[r * kLdPb + lane + 32] = __float2bfloat16_rn(d1);
    }
    __syncthreads();

    // 4. dbias += ds; o = p v, dv = p^T do, dq = dsb k, dk = dsb^T q:
    //    warp (wr, wq) takes column tile wq of the four 64 x dh results
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dbias[i][j] += df[(ty + 16 * i) * kLdSf + tx + 16 * j];
    if (wq * 16 < dh) {
      FragC acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) wm::fill_fragment(acc[k], 0.f);
      for (int j0 = 0; j0 < kMaxN; j0 += 16) {
        FragA fp, fs;
        FragAc fpt, fst;
        FragBr fv, fg, fk, fq;
        wm::load_matrix_sync(fp, pb + wr * 16 * kLdPb + j0, kLdPb);
        wm::load_matrix_sync(fs, sb + wr * 16 * kLdPb + j0, kLdPb);
        wm::load_matrix_sync(fpt, pb + j0 * kLdPb + wr * 16, kLdPb);
        wm::load_matrix_sync(fst, sb + j0 * kLdPb + wr * 16, kLdPb);
        wm::load_matrix_sync(fv, vs + j0 * kLdHb + wq * 16, kLdHb);
        wm::load_matrix_sync(fg, gs + j0 * kLdHb + wq * 16, kLdHb);
        wm::load_matrix_sync(fk, ks + j0 * kLdHb + wq * 16, kLdHb);
        wm::load_matrix_sync(fq, qs + j0 * kLdHb + wq * 16, kLdHb);
        wm::mma_sync(acc[0], fp, fv, acc[0]);    // o
        wm::mma_sync(acc[1], fpt, fg, acc[1]);   // dv
        wm::mma_sync(acc[2], fs, fk, acc[2]);    // dq (before the scale)
        wm::mma_sync(acc[3], fst, fq, acc[3]);   // dk
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wm::store_matrix_sync(outs + k * kMaxN * kLdOf + wr * 16 * kLdOf +
                                  wq * 16,
                              acc[k], kLdOf, wm::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < N * dh; i += kThreads) {
      const int t = i / dh, c = i % dh;
      const long long r = tok(t);
      const float* res = outs + t * kLdOf + c;
      o[r * C + h * dh + c] = __float2bfloat16_rn(res[0]);
      bf16* row = dqkv + r * 3 * C + h * dh + c;
      row[2 * C] = __float2bfloat16_rn(res[kMaxN * kLdOf]);
      row[0] = __float2bfloat16_rn(round_bf16(res[2 * kMaxN * kLdOf]) * sc);
      row[C] = __float2bfloat16_rn(res[3 * kMaxN * kLdOf]);
    }
    // the next window's writes to qs..gs, sf/df, pb/sb and outs all come
    // after at least one more barrier than this window's last reads
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
template <typename T>
struct AttnBwdWork {
  float *mu, *rstd, *p_wproj, *p_bproj, *p_wqkv, *p_bqkv, *p_bias, *p_g,
      *p_b, *dxn;
  T *xn, *qkv, *dyf, *dO, *o, *dqkv;
  int s_proj, s_qkv, groups;

  AttnBwdWork(Carver& cv, const AttnBwdDims& d) {
    const long long T_ = d.T();
    const int C = d.C, N = d.ws * d.ws;
    s_proj = gemm_splits(C, C, T_);
    s_qkv = gemm_splits(3 * C, C, T_);
    groups = (d.nW() + core_group(d) - 1) / core_group(d);
    mu = cv.take<float>(T_);
    rstd = cv.take<float>(T_);
    xn = cv.take<T>(T_ * C);
    qkv = cv.take<T>(T_ * 3 * C);
    dyf = cv.take<T>(T_ * C);
    dO = cv.take<T>(T_ * C);
    o = cv.take<T>(T_ * C);
    dqkv = cv.take<T>(T_ * 3 * C);
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

#define SWIN_TRY(expr)          \
  do {                          \
    const int err_ = (expr);    \
    if (err_) return err_;      \
  } while (0)

template <typename T>
int run_attn_bwd(const AttnBwdArgs& a, const AttnBwdDims& d,
                 cudaStream_t s) {
  Carver cv{static_cast<char*>(a.work)};
  AttnBwdWork<T> w(cv, d);
  const long long T_ = d.T();
  const int C = d.C, N = d.ws * d.ws;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const float scale = a.scale;  // rounded to T on the device

  SWIN_TRY(launch_ln_rows<T>(x, a.ln_s, a.ln_b, w.xn, w.mu, w.rstd, T_, C,
                             s));
  SWIN_TRY((gemm<T, float, true, true>(
      w.xn, a.wqkv, T_, 3 * C, C, C, C, 1, EpiQkv<T>{w.qkv, a.bqkv, C, scale},
      s)));
  SWIN_TRY(launch_scale_rows<T>(dy, a.dp, w.dyf, T_, C,
                                static_cast<long long>(d.Hp) * d.Wp, s));
  SWIN_TRY((gemm<T, float, true, false>(w.dyf, a.wproj, T_, C, C, C, C, 1,
                                        EpiStore<T>{w.dO, C, nullptr}, s)));

  constexpr bool tc = std::is_same<T, bf16>::value;
  const int smem = tc ? kCoreTcSmem
                      : kCoreSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t e;
  if constexpr (tc)
    e = cudaFuncSetAttribute(attn_core_bwd_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  else
    e = cudaFuncSetAttribute(attn_core_bwd<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const dim3 grid(w.groups, d.H);
  if constexpr (tc)
    attn_core_bwd_tc<<<grid, kThreads, smem, s>>>(
        w.qkv, w.dO, a.bias, a.mask, w.o, w.dqkv, w.p_bias, d,
        core_group(d), scale);
  else
    attn_core_bwd<T><<<grid, kThreads, smem, s>>>(
        w.qkv, w.dO, a.bias, a.mask, w.o, w.dqkv, w.p_bias, d,
        core_group(d), scale);
  SWIN_TRY(static_cast<int>(cudaGetLastError()));

  SWIN_TRY((gemm<T, T, false, false>(w.dyf, w.o, C, C, T_, C, C, w.s_proj,
                                     EpiPartial{w.p_wproj, C, C}, s)));
  SWIN_TRY((gemm<T, T, false, false>(w.dqkv, w.xn, 3 * C, C, T_, 3 * C, C,
                                     w.s_qkv, EpiPartial{w.p_wqkv, 3 * C, C},
                                     s)));
  SWIN_TRY((gemm<T, float, true, false>(w.dqkv, a.wqkv, T_, C, 3 * C, 3 * C,
                                        C, 1, EpiF32{w.dxn, C}, s)));
  SWIN_TRY(launch_ln_bwd<T>(x, dy, w.dxn, w.mu, w.rstd, a.ln_s,
                            static_cast<T*>(a.dx), w.p_g, w.p_b, a.dln_s,
                            a.dln_b, T_, C, s));
  SWIN_TRY(launch_colsum<T>(w.dyf, w.p_bproj, a.dbproj, T_, C, s));
  SWIN_TRY(launch_colsum<T>(w.dqkv, w.p_bqkv, a.dbqkv, T_, 3 * C, s));
  SWIN_TRY(launch_reduce(w.p_wproj, a.dwproj, gemm_used_splits(T_, w.s_proj),
                         static_cast<long long>(C) * C, s));
  SWIN_TRY(launch_reduce(w.p_wqkv, a.dwqkv, gemm_used_splits(T_, w.s_qkv),
                         3LL * C * C, s));
  return launch_reduce(w.p_bias, a.dbias, w.groups,
                       static_cast<long long>(d.H) * N * N, s);
}

bool attn_dims_ok(const AttnBwdDims& d, int is_bf16) {
  return d.ws * d.ws <= kMaxN && d.C % d.H == 0 && d.C / d.H <= 32 &&
         d.C <= 32 * kMaxLane && d.Hp % d.ws == 0 && d.Wp % d.ws == 0 &&
         (!is_bf16 || (d.C / d.H) % 16 == 0);
}

}  // namespace swin

extern "C" long long swin_attn_bwd_workspace(int B, int Hp, int Wp, int C,
                                             int H, int ws, int is_bf16) {
  const swin::AttnBwdDims d{B, Hp, Wp, C, H, ws};
  if (!swin::attn_dims_ok(d, is_bf16)) return 0;
  swin::Carver cv{nullptr};
  if (is_bf16) {
    swin::AttnBwdWork<swin::bf16> w(cv, d);
  } else {
    swin::AttnBwdWork<float> w(cv, d);
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
    int is_bf16, void* stream) {
  const swin::AttnBwdDims d{B, Hp, Wp, C, H, ws};
  if (!swin::attn_dims_ok(d, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const swin::AttnBwdArgs a{x,     dy,    dx,     ln_s,  ln_b,   wqkv,
                            bqkv,  wproj, bproj,  bias,  mask,   dp,
                            dln_s, dln_b, dwqkv,  dbqkv, dwproj, dbproj,
                            dbias, work,  scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::run_attn_bwd<swin::bf16>(a, d, s)
                 : swin::run_attn_bwd<float>(a, d, s);
}
