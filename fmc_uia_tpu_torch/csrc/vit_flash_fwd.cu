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
// Design (bf16; FlashAttention-3's forward on Hopper): one block per
// (query tile of 128, h, b): two consumer warpgroups and one producer
// warp. The producer loads the Q tile once and streams K and V tiles of
// 128 keys by TMA into a ring of kFwdStages 128-byte-swizzled stages, with
// a full and an empty mbarrier per tile and stage; K and V have barriers
// of their own, so S can start before V has landed. The consumers (64
// query rows each) run the products on wgmma: S = Q K^T as m64n128k16
// from shared memory (K as stored, K-major), O += P V as m64n64k16 with P
// in registers, rounded to bf16 straight from the S accumulators, and V
// as an MN-major operand (the transpose bit), so no transposed copy is
// made. Overlap: tile j's S = Q K_j^T and tile j-1's O += P V_{j-1} are
// issued together, so the softmax of tile j (its exponentials) runs while
// P V_{j-1} is on the tensor cores; and the two warpgroups issue their
// products in turn on named barriers (ping-pong), so one's softmax runs
// under the other's products (faster than leaving them to interleave).
// The f32 version runs one thread per query row on the CUDA cores (the
// card checks and the f32 model reference use it).
//
// What bounds it: 4 B H N^2 dh operations on the tensor cores against
// 4 B H N dh elements moved (q, k, v in, o out): N^2 / N products per
// element, far above the card's balance at N = 4101, so operations bound
// it. Beside them, B H N^2 exponentials, which at dh = 64 take about as
// long on the special-function units as the products on the tensor cores:
// hence the overlap.

#include "vit_flash_sm90.cuh"

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

constexpr int kFwdConsumers = 2;  // consumer warpgroups of a block
using FwdRoles = WarpRoles<kFwdConsumers>;
constexpr int kFwdRows = 64 * kFwdConsumers;  // query rows of a block
constexpr int kFwdKeys = 128;  // keys of a K/V tile
constexpr int kFwdStages = 2;  // K/V stages (3 were no faster)
constexpr uint32_t kFwdTileBytes = kFwdKeys * kRowBytes;

struct FwdSmem {  // at the 1024-aligned start of dynamic shared memory
  bf16 q[kFwdRows * kDh];
  bf16 k[kFwdStages][kFwdKeys * kDh];
  bf16 v[kFwdStages][kFwdKeys * kDh];
  uint64_t q_full;
  uint64_t k_full[kFwdStages], k_empty[kFwdStages];
  uint64_t v_full[kFwdStages], v_empty[kFwdStages];
};
constexpr int kFwdSmemBytes = static_cast<int>(sizeof(FwdSmem)) + 1024;

// One consumer warpgroup: 64 query rows, all key tiles.
__device__ __forceinline__ void fwd_consumer(FwdSmem& s, const FwdArgs& a,
                                             int cw, int nkt) {
  const int N = a.N, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x % kWgThreads, lane = tid & 31;
  const int c = 2 * (lane & 3);
  // this thread's rows: r0 and r0 + 8
  const int r0 = blockIdx.x * kFwdRows + cw * 64 + (tid >> 5) * 16 +
                 (lane >> 2);
  const float sl2 = a.scale * kLog2e;
  const uint64_t dq = sw128_desc(s.q + cw * 64 * kDh);

  float sacc[64], o[32];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // running max (raw scores) and this thread's part of the row sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  auto issue_s = [&](int st) {
    const uint64_t dk = sw128_desc(s.k[st]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n128(sacc, dq + ks * kDescKStep, dk + ks * kDescKStep, ks);
    wg_commit();
  };
  auto issue_pv = [&](int st) {
    const uint64_t dv = sw128_desc(s.v[st]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_n64_t(o, p[kk], dv + kk * kDescRowStep16);
    wg_commit();
  };
  // Online softmax of tile j in place (sacc -> unnormalized p, f32);
  // returns the factors that rescale the rows' earlier sums.
  auto softmax = [&](int j, float& al0, float& al1) {
    const int kbase = j * kFwdKeys;
    if (kbase + kFwdKeys > N) {  // keys >= N of the last tile
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kbase + 8 * i + c + (e & 1) >= N) sacc[4 * i + e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
    }
    // every tile holds a real key, so the max is finite from tile 0 on
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    al0 = fast_exp2((m0 - mx0) * sl2);
    al1 = fast_exp2((m1 - mx1) * sl2);
    m0 = mx0;
    m1 = mx1;
    const float b0 = -mx0 * sl2, b1 = -mx1 * sl2;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sacc[4 * i] = fast_exp2(fmaf(sacc[4 * i], sl2, b0));
      sacc[4 * i + 1] = fast_exp2(fmaf(sacc[4 * i + 1], sl2, b0));
      sacc[4 * i + 2] = fast_exp2(fmaf(sacc[4 * i + 2], sl2, b1));
      sacc[4 * i + 3] = fast_exp2(fmaf(sacc[4 * i + 3], sl2, b1));
      ls0 += sacc[4 * i] + sacc[4 * i + 1];
      ls1 += sacc[4 * i + 2] + sacc[4 * i + 3];
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
  };

  const PingPong pp{cw};
  pp.start();
  mbar_wait_warp(&s.q_full, 0);
  mbar_wait_warp(&s.k_full[0], 0);
  pp.issue_begin();
  wg_fence();
  issue_s(0);
  pp.issue_end(false);
  wg_wait<0>();
  fence_regs(sacc);
  warp_arrive(&s.k_empty[0]);
  {
    float al0, al1;
    softmax(0, al0, al1);
  }
  acc_to_a(p, sacc);  // p rounded to bf16 (v's dtype)

  for (int j = 1; j < nkt; ++j) {
    const int st = j % kFwdStages, sp = (j - 1) % kFwdStages;
    mbar_wait_warp(&s.k_full[st], (j / kFwdStages) & 1);
    mbar_wait_warp(&s.v_full[sp], ((j - 1) / kFwdStages) & 1);
    fence_regs(sacc);
    fence_regs(o);
    fence_regs(p);
    pp.issue_begin();
    wg_fence();
    issue_s(st);   // S_j = Q K_j^T
    issue_pv(sp);  // O += P_{j-1} V_{j-1}, in flight under the softmax
    pp.issue_end(false);
    wg_wait<1>();
    fence_regs(sacc);
    warp_arrive(&s.k_empty[st]);
    float al0, al1;
    softmax(j, al0, al1);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(p);
    warp_arrive(&s.v_empty[sp]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= al0;
      o[4 * i + 1] *= al0;
      o[4 * i + 2] *= al1;
      o[4 * i + 3] *= al1;
    }
    acc_to_a(p, sacc);
  }
  {
    const int sp = (nkt - 1) % kFwdStages;
    mbar_wait_warp(&s.v_full[sp], ((nkt - 1) / kFwdStages) & 1);
    fence_regs(o);
    fence_regs(p);
    pp.issue_begin();
    wg_fence();
    issue_pv(sp);
    pp.issue_end(true);
    wg_wait<0>();
    fence_regs(o);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* O = static_cast<bf16*>(a.o) + head_off(a.lo, b, h);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = 8 * i + c;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(O + r0 * a.lo.n + d) =
          __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(O + r1 * a.lo.n + d) =
          __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
  if ((lane & 3) == 0) {
    float* L = a.lse + (static_cast<long long>(b) * a.H + h) * N;
    if (r0 < N) L[r0] = (m0 * sl2 + log2f(l0)) * kLn2;
    if (r1 < N) L[r1] = (m1 * sl2 + log2f(l1)) * kLn2;
  }
}

__global__ void __launch_bounds__(FwdRoles::kThreads, 1)
    fwd_bf16(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, FwdArgs a) {
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_base_1k());
  const int nkt = (a.N + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.k_empty[i], FwdRoles::kConsumerWarps);
      mbar_init(&s.v_empty[i], FwdRoles::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = warpgroup_index();
  if (wg == kFwdConsumers) {  // the producer warp
    if (threadIdx.x == FwdRoles::kProducerThread) {
      const int h = blockIdx.y, b = blockIdx.z;
      mbar_expect_tx(&s.q_full, kFwdRows * kRowBytes);
      tma_load(s.q, &tq, &s.q_full, blockIdx.x * kFwdRows, h, b);
      for (int j = 0; j < nkt; ++j) {
        const int st = j % kFwdStages;
        const uint32_t ph = ((j / kFwdStages) & 1) ^ 1;
        mbar_wait(&s.k_empty[st], ph);
        mbar_expect_tx(&s.k_full[st], kFwdTileBytes);
        tma_load(s.k[st], &tk, &s.k_full[st], j * kFwdKeys, h, b);
        mbar_wait(&s.v_empty[st], ph);
        mbar_expect_tx(&s.v_full[st], kFwdTileBytes);
        tma_load(s.v[st], &tv, &s.v_full[st], j * kFwdKeys, h, b);
      }
    }
  } else {
    fwd_consumer(s, a, wg, nkt);
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
// Returns a CUDA error code, or kErrNoEncoder / kErrTensorMap (negative)
// when the bf16 path cannot build its TMA maps.
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
    CUtensorMap mq, mk, mv;
    int rc = make_map(&mq, q, a.lq, B, H, N, kFwdRows);
    if (rc == 0) rc = make_map(&mk, k, a.lk, B, H, N, kFwdKeys);
    if (rc == 0) rc = make_map(&mv, v, a.lv, B, H, N, kFwdKeys);
    if (rc != 0) return rc;
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFwdSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((N + kFwdRows - 1) / kFwdRows, H, B);
    fwd_bf16<<<grid, FwdRoles::kThreads, kFwdSmemBytes, s>>>(mq, mk, mv, a);
  } else {
    dim3 grid((N + kRowsF32 - 1) / kRowsF32, H, B);
    fwd_f32<<<grid, kRowsF32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
