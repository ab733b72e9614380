// Fused Swin MLP branch, backward (K2b), for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/swin_block_pallas.py
// _fused_mlp_bwd -> _mlp_bwd_kernel -> _mlp_pullback: the pullback of
// out = x + dp * fc2(gelu_tanh(fc1(LN2(x)))) on tokens x [T, C] for the
// cotangent dy. Returns dx (identity path included) and f32 dLN scale/bias,
// dW1 [4C, C], db1, dW2 [C, 4C], db2; dp gets no gradient.
//
// Design. The TPU kernel recomputes the forward of a token tile in VMEM,
// pulls it back, and carries the weight-gradient sums across its
// sequential grid. Here the pullback runs as passes over all tokens, with
// the 4C-wide hidden activations in a workspace in device memory:
//
//   1. ln_rows: f32 LN statistics and xn = LN2(x), rounded.
//   2. gemm: h1 = xn W1^T + b1 (f32), and gc = gelu_tanh(h1), rounded.
//   3. scale_rows: dyc = dy * dp, rounded.
//   4. gemm: dg = dyc W2; its epilogue forms dh1 = gelu'(h1) dg (f32, over
//      h1 in place) and dh1c = dh1 rounded.
//   5. gemm (split over tokens): dW2 = dyc^T gc, dW1 = dh1c^T xn, into
//      per-split partials; colsum: db2 (of dyc), db1 (of the f32 dh1).
//   6. gemm: dxn = dh1c W1 (f32); ln_bwd: dx and dLN partials.
//   7. reduce_slots: every partial buffer, slots added in index order.
//
// No atomics: every gradient sum is deterministic (swin_bwd_common.cuh).
//
// What bounds it: the products, 40*C^2 operations per token (fc1 is
// recomputed; fc2's output is not needed), far above the card's
// bytes-to-operations balance. In bf16 every product runs on the tensor
// cores (WMMA, swin_bwd_common.cuh). Not done yet: the hidden activations
// round-trip through device memory (the TPU kernel keeps them in VMEM);
// no TMA/cp.async pipeline, no wgmma.
//
// Rounding points (as _mlp_pullback): xn; the GELU output; dyc; dh1 before
// its products (db1 sums it in f32); dx before the identity-path add, and
// the sum.

#include "swin_bwd_common.cuh"

namespace swin {

constexpr float kGeluK = 0.7978845608028654f;  // sqrt(2 / pi)

// jax.nn.gelu (approximate=True): x * 0.5 * (1 + tanh(k (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float h, float* grad) {
  const float t = tanhf(kGeluK * (h + 0.044715f * (h * h * h)));
  *grad = 0.5f * (1.f + t) +
          0.5f * h * (1.f - t * t) * kGeluK * (1.f + 3.f * 0.044715f * h * h);
  return h * (0.5f * (1.f + t));
}

template <typename T>
struct EpiH1 {  // h1 = acc + b1 (f32), gc = round(gelu(h1))
  float* h1;
  T* gc;
  const float* b1;
  int N;
  __device__ void operator()(long long m, int n, int, float v) const {
    const float h = v + b1[n];
    float unused;
    h1[m * N + n] = h;
    gc[m * N + n] = from_f<T>(gelu_tanh(h, &unused));
  }
};

template <typename T>
struct EpiDh1 {  // dh1 = gelu'(h1) * acc over h1 (f32), dh1c = round(dh1)
  float* h1;
  T* dh1c;
  int N;
  __device__ void operator()(long long m, int n, int, float v) const {
    const long long i = m * N + n;
    float grad;
    gelu_tanh(h1[i], &grad);
    const float d = grad * v;
    h1[i] = d;
    dh1c[i] = from_f<T>(d);
  }
};

template <typename T>
struct MlpBwdWork {
  float *mu, *rstd, *h1, *dxn, *p_w1, *p_w2, *p_b1, *p_b2, *p_g, *p_b;
  T *xn, *dyc, *gc, *dh1c;
  int s_w1, s_w2;

  MlpBwdWork(Carver& cv, long long T_, int C, int Ch) {
    s_w1 = gemm_splits(Ch, C, T_);
    s_w2 = gemm_splits(C, Ch, T_);
    mu = cv.take<float>(T_);
    rstd = cv.take<float>(T_);
    xn = cv.take<T>(T_ * C);
    dyc = cv.take<T>(T_ * C);
    h1 = cv.take<float>(T_ * Ch);
    gc = cv.take<T>(T_ * Ch);
    dh1c = cv.take<T>(T_ * Ch);
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

#define SWIN_TRY(expr)          \
  do {                          \
    const int err_ = (expr);    \
    if (err_) return err_;      \
  } while (0)

template <typename T>
int run_mlp_bwd(const MlpBwdArgs& a, cudaStream_t s) {
  Carver cv{static_cast<char*>(a.work)};
  const long long T_ = a.T;
  const int C = a.C, Ch = a.Ch;
  MlpBwdWork<T> w(cv, T_, C, Ch);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);

  SWIN_TRY(launch_ln_rows<T>(x, a.ln_s, a.ln_b, w.xn, w.mu, w.rstd, T_, C,
                             s));
  SWIN_TRY((gemm<T, float, true, true>(w.xn, a.w1, T_, Ch, C, C, C, 1,
                                       EpiH1<T>{w.h1, w.gc, a.b1, Ch}, s)));
  SWIN_TRY(launch_scale_rows<T>(dy, a.dp, w.dyc, T_, C, a.hw, s));
  SWIN_TRY((gemm<T, float, true, false>(w.dyc, a.w2, T_, Ch, C, C, Ch, 1,
                                        EpiDh1<T>{w.h1, w.dh1c, Ch}, s)));
  SWIN_TRY((gemm<T, T, false, false>(w.dyc, w.gc, C, Ch, T_, C, Ch, w.s_w2,
                                     EpiPartial{w.p_w2, C, Ch}, s)));
  SWIN_TRY((gemm<T, T, false, false>(w.dh1c, w.xn, Ch, C, T_, Ch, C, w.s_w1,
                                     EpiPartial{w.p_w1, Ch, C}, s)));
  SWIN_TRY((gemm<T, float, true, false>(w.dh1c, a.w1, T_, C, Ch, Ch, C, 1,
                                        EpiF32{w.dxn, C}, s)));
  SWIN_TRY(launch_ln_bwd<T>(x, dy, w.dxn, w.mu, w.rstd, a.ln_s,
                            static_cast<T*>(a.dx), w.p_g, w.p_b, a.dln_s,
                            a.dln_b, T_, C, s));
  SWIN_TRY(launch_colsum<T>(w.dyc, w.p_b2, a.db2, T_, C, s));
  SWIN_TRY(launch_colsum<float>(w.h1, w.p_b1, a.db1, T_, Ch, s));
  SWIN_TRY(launch_reduce(w.p_w2, a.dw2, gemm_used_splits(T_, w.s_w2),
                         static_cast<long long>(C) * Ch, s));
  return launch_reduce(w.p_w1, a.dw1, gemm_used_splits(T_, w.s_w1),
                       static_cast<long long>(Ch) * C, s);
}

}  // namespace swin

extern "C" long long swin_mlp_bwd_workspace(long long T, int C, int Ch,
                                            int is_bf16) {
  if (C > 32 * swin::kMaxLane) return 0;
  swin::Carver cv{nullptr};
  if (is_bf16) {
    swin::MlpBwdWork<swin::bf16> w(cv, T, C, Ch);
  } else {
    swin::MlpBwdWork<float> w(cv, T, C, Ch);
  }
  return static_cast<long long>(cv.off);
}

extern "C" int swin_mlp_bwd(const void* x, const void* dy, void* dx,
                            const float* ln_s, const float* ln_b,
                            const float* w1, const float* b1,
                            const float* w2, const float* b2,
                            const float* dp, float* dln_s, float* dln_b,
                            float* dw1, float* db1, float* dw2, float* db2,
                            void* work, long long T, int C, int Ch, int hw,
                            int is_bf16, void* stream) {
  if (C > 32 * swin::kMaxLane) return static_cast<int>(cudaErrorInvalidValue);
  const swin::MlpBwdArgs a{x,     dy,  dx,  ln_s, ln_b, w1, b1, w2,
                           b2,    dp,  dln_s, dln_b, dw1, db1, dw2, db2,
                           work,  T,   C,   Ch,   hw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? swin::run_mlp_bwd<swin::bf16>(a, s)
                 : swin::run_mlp_bwd<float>(a, s);
}
