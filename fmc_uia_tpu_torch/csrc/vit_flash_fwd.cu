// ViT global attention, forward (K4f), for sm_90a.
//
// Replaces the TPU kernel behind fmc_uia_tpu/ops/vit_attention.py
// global_attention: the Pallas TPU flash-attention library kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_impl -> _flash_attention_kernel). For each (b, h):
//
//   s = (q k^T) * scale     q k^T accumulated in f32, then scaled
//   o = softmax(s) v        online softmax with f32 running max and sum;
//                           the unnormalized p is rounded to v's dtype
//                           before p v, accumulated in f32
//   lse = m + log(l)        per row, f32, kept for the backward (K4b)
//
// on q, k, v [B, H, N, dh] (dh = 64). The TPU wrapper pads N to a
// multiple of 512 and puts the pad tokens in a second segment; for the
// real rows that equals masking keys >= N, which is what this kernel
// does, without padding (4101 -> 4608 would cost 1.26x the work). Rows
// >= N are never written; masked keys add exactly 0 to the row sums.
//
// Design (FlashAttention-2): one block per (query tile of 64, h, b), four
// warps of 16 query rows. The warp keeps its q rows as mma A fragments in
// registers; key/value tiles of 64 rows stream through shared memory,
// double-buffered with cp.async (the next tile in flight while this one
// is used). Per tile: S = Q K^T on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 out, B fragments by ldmatrix), the running max and sum in
// registers (a quad of lanes shares a row), P rounded to bf16 straight
// from the S accumulators into A fragments, O += P V (V fragments by
// ldmatrix.trans). The f32 version runs one thread per query row on the
// CUDA cores (the card checks and the f32 model reference use it).
//
// What bounds it: 4 B H N^2 dh operations on the tensor cores against
// 4 B H N dh elements moved (q, k, v in, o out): N^2 / N products per
// element, far above the card's balance at N = 4101, so operations bound
// it. Beside them, B H N^2 exponentials, which at dh = 64 take about as
// long on the special-function units as the products on the tensor cores.
// Not done yet: wgmma, TMA, warp specialisation, overlapping the
// exponentials of one tile with the products of the next.

#include "vit_flash_common.cuh"

namespace vitfa {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, N]
  Layout lq, lk, lv, lo;
  float scale;
  int B, H, N;
};

__global__ void __launch_bounds__(kThreads) fwd_bf16(FwdArgs a) {
  __shared__ __align__(16) bf16 ks[2][kTile * kPitch];
  __shared__ __align__(16) bf16 vs[2][kTile * kPitch];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const bf16* Q = static_cast<const bf16*>(a.q) + head_off(a.lq, b, h);
  const bf16* K = static_cast<const bf16*>(a.k) + head_off(a.lk, b, h);
  const bf16* V = static_cast<const bf16*>(a.v) + head_off(a.lv, b, h);
  const int nkt = (N + kTile - 1) / kTile;

  load_tile_async(ks[0], K, a.lk.n, 0, N);
  load_tile_async(vs[0], V, a.lv.n, 0, N);
  cp_async_commit();

  const int row0 = qt * kTile + warp * 16;
  uint32_t qf[4][4];
  load_a_frags(qf, Q, a.lq.n, row0, N);

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // running max (log2 domain) and sum of rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
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

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    mma_abt(s, qf, ks[cur]);

    // scale (log2 domain), mask keys >= N, row max; every tile holds a
    // real key, so the max is finite after the first tile
    const int kbase = t * kTile;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + nt * 8 + c + (e & 1);
        const float val = key < N ? s[nt][e] * sl2 : -INFINITY;
        s[nt][e] = val;
        if (e < 2)
          mx0 = fmaxf(mx0, val);
        else
          mx1 = fmaxf(mx1, val);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      ls0 += s[nt][0] + s[nt][1];
      ls1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + quad_sum(ls0);
    l1 = l1 * al1 + quad_sum(ls1);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }
    uint32_t pf[4][4];
    acc_to_a(pf, s);  // p rounded to bf16 (v's dtype)
    mma_ab(o, pf, vs[cur]);
    __syncthreads();  // the buffer is refilled two tiles later
  }

  bf16* O = static_cast<bf16*>(a.o) + head_off(a.lo, b, h);
  const int r0 = row0 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int d = dt * 8 + c;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(O + r0 * a.lo.n + d) =
          __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(O + r1 * a.lo.n + d) =
          __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
  if ((lane & 3) == 0) {
    float* L = a.lse + (static_cast<long long>(b) * a.H + h) * N;
    if (r0 < N) L[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < N) L[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

// f32: one thread per query row (kRowsF32 a block), keys and values in
// tiles of kTileF32 rows through shared memory; the row's scores of a
// tile go to a [key][thread] scratch between the two passes.
__global__ void __launch_bounds__(kRowsF32) fwd_f32(FwdArgs a) {
  __shared__ __align__(16) float ks[kTileF32 * kDh];
  __shared__ __align__(16) float vs[kTileF32 * kDh];
  __shared__ float ss[kTileF32][kRowsF32];
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int N = a.N;
  const int row = blockIdx.x * kRowsF32 + tid;
  const bool ok = row < N;
  const float* Q = static_cast<const float*>(a.q) + head_off(a.lq, b, h);
  const float* K = static_cast<const float*>(a.k) + head_off(a.lk, b, h);
  const float* V = static_cast<const float*>(a.v) + head_off(a.lv, b, h);
  float q[kDh], o[kDh];
  load_row_f32(q, Q + row * a.lq.n, ok);
#pragma unroll
  for (int d = 0; d < kDh; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTileF32) {
    const int nk = min(kTileF32, N - k0);
    __syncthreads();
    load_tile_f32(ks, K, a.lk.n, k0, kTileF32, N);
    load_tile_f32(vs, V, a.lv.n, k0, kTileF32, N);
    __syncthreads();
    float mx = m;
    for (int j = 0; j < nk; ++j) {
      const float s = dot64(q, ks + j * kDh) * a.scale;
      ss[j][tid] = s;
      mx = fmaxf(mx, s);
    }
    const float al = expf(m - mx);
    m = mx;
    l *= al;
#pragma unroll
    for (int d = 0; d < kDh; ++d) o[d] *= al;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(ss[j][tid] - m);
      l += p;
      axpy64(o, p, vs + j * kDh);
    }
  }
  if (!ok) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < kDh; ++d) o[d] *= inv;
  store_row_f32(static_cast<float*>(a.o) + head_off(a.lo, b, h) +
                    row * a.lo.n,
                o);
  a.lse[(static_cast<long long>(b) * a.H + h) * N + row] = m + logf(l);
}

}  // namespace vitfa

// strides: 12 element strides, (b, h, n) of q, k, v and o in that order.
extern "C" int vit_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* strides,
                             float scale, int B, int H, int N, int dh,
                             int is_bf16, void* stream) {
  using namespace vitfa;
  if (dh != kDh || B < 1 || H < 1 || N < 1 || H > 65535 || B > 65535 ||
      !layouts_ok(strides, 12, is_bf16 ? 2 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  Layout* ls[4] = {&a.lq, &a.lk, &a.lv, &a.lo};
  for (int i = 0; i < 4; ++i)
    *ls[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.scale = scale;
  a.B = B;
  a.H = H;
  a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((N + kTile - 1) / kTile, H, B);
    fwd_bf16<<<grid, kThreads, 0, s>>>(a);
  } else {
    dim3 grid((N + kRowsF32 - 1) / kRowsF32, H, B);
    fwd_f32<<<grid, kRowsF32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
