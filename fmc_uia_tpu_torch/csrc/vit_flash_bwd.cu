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
// Design: the TPU's split, without atomics. Pass 1 (dkv_bf16): one block
// per (key tile of 64, h, b), four warps of 16 keys holding their k and v
// rows as mma A fragments; query tiles of q and do stream through shared
// memory (cp.async, double-buffered) with their lse and di. Per tile:
// S^T = K Q^T, P^T from the lse, dV += P^T dO, dP^T = V dO^T, dS^T,
// dK += dS^T Q, all on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate). Pass 2 (dq_bf16): one block per (query tile, h, b), q and
// do rows in registers, key tiles of k and v streamed: S = Q K^T, P,
// dP = dO V^T, dS, dQ += dS K. Each pass owns its outputs, so nothing is
// summed across blocks. The f32 passes run one thread per row on the CUDA
// cores (dV and dK in two sweeps, to keep a thread's rows in registers).
//
// What bounds it: 10 B H N^2 dh operations on the tensor cores (five
// N x N x dh products: S and dP twice -- once in each pass -- plus dV, dK,
// dQ; the TPU split recomputes the same) and 2 B H N^2 exponentials;
// operations, by far, at N = 4101.

#include "vit_flash_common.cuh"

namespace vitfa {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, N]
  float* di;         // [B, H, N] scratch: rowsum(o * do)
  void* dq;
  void* dk;
  void* dv;
  Layout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  float scale;
  int B, H, N;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// di = rowsum(o * do) in f32: one warp per row, two elements a lane
template <typename T>
__global__ void __launch_bounds__(256) rowdot(BwdArgs a) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(a.B) * a.H * a.N;
  if (warp >= rows) return;
  const int n = warp % a.N, bh = warp / a.N;
  const int h = bh % a.H, b = bh / a.H;
  const T* o = static_cast<const T*>(a.o) + head_off(a.lo, b, h) + n * a.lo.n;
  const T* d =
      static_cast<const T*>(a.dout) + head_off(a.ldo, b, h) + n * a.ldo.n;
  float s = to_f32(o[lane]) * to_f32(d[lane]) +
            to_f32(o[lane + 32]) * to_f32(d[lane + 32]);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.di[warp] = s;
}

__device__ __forceinline__ void zero_acc(float (&x)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// Rows r0 = row0 + g and r0 + 8 of an accumulator tile as bf16, rows < N
__device__ __forceinline__ void store_acc_bf16(bf16* base, long long sn,
                                               int row0, int N,
                                               const float (&x)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int d = dt * 8 + c;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(base + r0 * sn + d) =
          __floats2bfloat162_rn(x[dt][0], x[dt][1]);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(base + r1 * sn + d) =
          __floats2bfloat162_rn(x[dt][2], x[dt][3]);
  }
}

// Pass 1: dK and dV of one key tile.
__global__ void __launch_bounds__(kThreads) dkv_bf16(BwdArgs a) {
  __shared__ __align__(16) bf16 qs[2][kTile * kPitch];
  __shared__ __align__(16) bf16 dos[2][kTile * kPitch];
  __shared__ float lse_s[2][kTile];  // log2 domain; +inf for rows >= N
  __shared__ float di_s[2][kTile];
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, c = 2 * (lane & 3);
  const bf16* Q = static_cast<const bf16*>(a.q) + head_off(a.lq, b, h);
  const bf16* K = static_cast<const bf16*>(a.k) + head_off(a.lk, b, h);
  const bf16* V = static_cast<const bf16*>(a.v) + head_off(a.lv, b, h);
  const bf16* DO = static_cast<const bf16*>(a.dout) + head_off(a.ldo, b, h);
  const long long rb = (static_cast<long long>(b) * a.H + h) * N;
  const float* LSE = a.lse + rb;
  const float* DI = a.di + rb;
  const int nqt = (N + kTile - 1) / kTile;

  auto stage = [&](int buf, int t) {
    load_tile_async(qs[buf], Q, a.lq.n, t * kTile, N);
    load_tile_async(dos[buf], DO, a.ldo.n, t * kTile, N);
    cp_async_commit();
    if (tid < kTile) {
      const int row = t * kTile + tid;
      lse_s[buf][tid] = row < N ? LSE[row] * kLog2e : INFINITY;
      di_s[buf][tid] = row < N ? DI[row] : 0.f;
    }
  };
  stage(0, 0);

  const int row0 = kt * kTile + warp * 16;
  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, K, a.lk.n, row0, N);
  load_a_frags(vf, V, a.lv.n, row0, N);
  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  const float sl2 = a.scale * kLog2e;

  for (int t = 0; t < nqt; ++t) {
    const int cur = t & 1;
    if (t + 1 < nqt) {
      stage(cur ^ 1, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T (rows: this warp's keys; columns: the tile's queries)
    float p[8][4];
    zero_acc(p);
    mma_abt(p, kf, qs[cur]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nt][e] = exp2f(p[nt][e] * sl2 - lse_s[cur][nt * 8 + c + (e & 1)]);
    {
      uint32_t pf[4][4];
      acc_to_a(pf, p);  // p rounded to do's dtype
      mma_ab(dv, pf, dos[cur]);
    }
    // dP^T = V dO^T, dS^T = (dP^T - di) * P^T * scale
    float dp[8][4];
    zero_acc(dp);
    mma_abt(dp, vf, dos[cur]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] =
            (dp[nt][e] - di_s[cur][nt * 8 + c + (e & 1)]) * p[nt][e] * a.scale;
    uint32_t dsf[4][4];
    acc_to_a(dsf, dp);  // ds rounded to the dtype
    mma_ab(dk, dsf, qs[cur]);
    __syncthreads();
  }
  store_acc_bf16(static_cast<bf16*>(a.dk) + head_off(a.ldk, b, h), a.ldk.n,
                 row0, N, dk);
  store_acc_bf16(static_cast<bf16*>(a.dv) + head_off(a.ldv, b, h), a.ldv.n,
                 row0, N, dv);
}

// Pass 2: dQ of one query tile.
__global__ void __launch_bounds__(kThreads) dq_bf16(BwdArgs a) {
  __shared__ __align__(16) bf16 ks[2][kTile * kPitch];
  __shared__ __align__(16) bf16 vs[2][kTile * kPitch];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const bf16* Q = static_cast<const bf16*>(a.q) + head_off(a.lq, b, h);
  const bf16* K = static_cast<const bf16*>(a.k) + head_off(a.lk, b, h);
  const bf16* V = static_cast<const bf16*>(a.v) + head_off(a.lv, b, h);
  const bf16* DO = static_cast<const bf16*>(a.dout) + head_off(a.ldo, b, h);
  const long long rb = (static_cast<long long>(b) * a.H + h) * N;
  const int nkt = (N + kTile - 1) / kTile;

  load_tile_async(ks[0], K, a.lk.n, 0, N);
  load_tile_async(vs[0], V, a.lv.n, 0, N);
  cp_async_commit();

  const int row0 = qt * kTile + warp * 16;
  const int r0 = row0 + g, r1 = r0 + 8;
  uint32_t qf[4][4], df[4][4];
  load_a_frags(qf, Q, a.lq.n, row0, N);
  load_a_frags(df, DO, a.ldo.n, row0, N);
  // rows >= N: any finite values (never stored)
  const float lse0 = r0 < N ? a.lse[rb + r0] * kLog2e : 0.f;
  const float lse1 = r1 < N ? a.lse[rb + r1] * kLog2e : 0.f;
  const float di0 = r0 < N ? a.di[rb + r0] : 0.f;
  const float di1 = r1 < N ? a.di[rb + r1] : 0.f;
  float dq[8][4];
  zero_acc(dq);
  const float sl2 = a.scale * kLog2e;

  for (int t = 0; t < nkt; ++t) {
    const int cur = t & 1;
    if (t + 1 < nkt) {
      load_tile_async(ks[cur ^ 1], K, a.lk.n, (t + 1) * kTile, N);
      load_tile_async(vs[cur ^ 1], V, a.lv.n, (t + 1) * kTile, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float p[8][4];
    zero_acc(p);
    mma_abt(p, qf, ks[cur]);
    const int kbase = t * kTile;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + nt * 8 + c + (e & 1);
        p[nt][e] =
            key < N ? exp2f(p[nt][e] * sl2 - (e < 2 ? lse0 : lse1)) : 0.f;
      }
    float dp[8][4];
    zero_acc(dp);
    mma_abt(dp, df, vs[cur]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = (dp[nt][e] - (e < 2 ? di0 : di1)) * p[nt][e] * a.scale;
    uint32_t dsf[4][4];
    acc_to_a(dsf, dp);
    mma_ab(dq, dsf, ks[cur]);
    __syncthreads();
  }
  store_acc_bf16(static_cast<bf16*>(a.dq) + head_off(a.ldq, b, h), a.ldq.n,
                 row0, N, dq);
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
  const float di = ok ? a.di[rb + row] : 0.f;
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
      di_s[tid] = a.di[rb + q0 + tid];
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

// strides: 24 element strides, (b, h, n) of q, k, v, o, do, dq, dk, dv in
// that order. di: an f32 [B, H, N] scratch.
extern "C" int vit_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* di, void* dq, void* dk,
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
  a.di = di;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * N;
  const unsigned rd_blocks = static_cast<unsigned>((rows + 7) / 8);
  if (is_bf16) {
    rowdot<bf16><<<rd_blocks, 256, 0, s>>>(a);
    dim3 grid((N + kTile - 1) / kTile, H, B);
    dkv_bf16<<<grid, kThreads, 0, s>>>(a);
    dq_bf16<<<grid, kThreads, 0, s>>>(a);
  } else {
    rowdot<float><<<rd_blocks, 256, 0, s>>>(a);
    dim3 grid((N + kRowsF32 - 1) / kRowsF32, H, B);
    dkv_f32<false><<<grid, kRowsF32, 0, s>>>(a);
    dkv_f32<true><<<grid, kRowsF32, 0, s>>>(a);
    dq_f32<<<grid, kRowsF32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
