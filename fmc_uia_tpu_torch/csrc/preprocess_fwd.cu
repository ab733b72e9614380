// Fused photometric train preprocessing (K3), for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/preprocess_pallas.py
// fused_augment_normalize -> _fused_call -> _kernel: per image b and flat
// element e of its [H, W, 3] uint8 pixels (channel c = e % 3),
//
//   x = clip(float(u8) * alpha_b + beta_b, 0, 255)
//   (w0, w1, w2, w3) = Philox4x32-10(counter = (e >> 1, 0, 0, 0),
//                                    key = (seed_b, 0))
//   u1, u2 = (w0, w1) for even e, (w2, w3) for odd e; u = (w >> 8) * 2^-24
//   n = sqrt(-2 ln(max(u1, 1e-7))) * cos(2pi_f32 * u2)
//   x = clip(x + sigma_b * n, 0, 255)
//   out = (x - 255 mean[c]) * inv_std[c]      (inv_std = 1 / (255 std))
//
// rounded to the output type (f32 or bf16, round to nearest). The TPU
// kernel draws its noise bits from the core's hardware PRNG; Hopper has
// none, so the bits come from a counter-based Philox4x32-10 (Random123's
// constants and round order) written out here, with a fixed counter
// layout that the plain version (ops/preprocess.py) reproduces exactly.
// The products and sums are the explicit __fmul_rn/__fadd_rn of the JAX
// kernel's separate multiply and add (no FMA contraction); logf, cosf and
// sqrtf are the accurate versions (no fast math). With sigma = 0 the
// output is bitwise that of the plain version.
//
// Design: one thread per pair of elements (one Philox call feeds two
// Box-Muller draws), a grid-stride loop over the pairs of an image, one
// grid row per image; the per-image scalars are read from device memory
// so that the caller never waits on the host.
//
// What bounds it: it reads each uint8 once and writes each output once
// (56.6 MB at B = 24, 512², bf16: 0.017 ms at 3.35 TB/s), against ~75
// operations per element, most of them Philox's 10 rounds of two 32x32
// products for each pair (1.4e9 operations: 0.021 ms at 67 TFLOP/s), so
// operations bind by a little. This first version is simple: no
// vectorised loads or stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kTwoPi = 6.283185482025146484375f;  // 2 * float(pi)
constexpr float kInv24 = 5.9604644775390625e-8f;    // 2^-24

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t key0) {
  uint32_t c1 = 0, c2 = 0, c3 = 0, k0 = key0, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

__device__ __forceinline__ float k3_element(uint8_t v, float alpha,
                                            float beta, float sigma,
                                            uint32_t w1, uint32_t w2,
                                            float mean255, float inv_std) {
  float x = clip255(__fadd_rn(__fmul_rn(static_cast<float>(v), alpha), beta));
  float u1 = __fmul_rn(static_cast<float>(w1 >> 8), kInv24);
  const float u2 = __fmul_rn(static_cast<float>(w2 >> 8), kInv24);
  u1 = fmaxf(u1, 1e-7f);
  const float n = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                            cosf(__fmul_rn(kTwoPi, u2)));
  x = clip255(__fadd_rn(x, __fmul_rn(sigma, n)));
  return __fmul_rn(__fsub_rn(x, mean255), inv_std);
}

__device__ __forceinline__ void store(float* out, long long i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* out, long long i,
                                      float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void preprocess_fwd_kernel(const uint8_t* __restrict__ images,
                                      Out* __restrict__ out,
                                      const float* __restrict__ scalars,
                                      const int* __restrict__ seeds,
                                      const float* __restrict__ mean255,
                                      const float* __restrict__ inv_std,
                                      long long per_image, int channels) {
  const int b = blockIdx.y;
  const float alpha = scalars[3 * b], beta = scalars[3 * b + 1];
  const float sigma = scalars[3 * b + 2];
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  const uint8_t* img = images + b * per_image;
  Out* dst = out + b * per_image;
  const long long pairs = (per_image + 1) >> 1;
  for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       k < pairs; k += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 w = philox4x32_10(static_cast<uint32_t>(k), seed);
    const long long e = 2 * k;
    int c = static_cast<int>(e % channels);
    store(dst, e, k3_element(img[e], alpha, beta, sigma, w.x, w.y,
                             mean255[c], inv_std[c]));
    if (e + 1 < per_image) {
      c = c + 1 == channels ? 0 : c + 1;
      store(dst, e + 1, k3_element(img[e + 1], alpha, beta, sigma, w.z,
                                   w.w, mean255[c], inv_std[c]));
    }
  }
}

}  // namespace

// images [B, per_image] uint8; out [B, per_image] f32 or bf16; scalars
// [B, 3] f32 (alpha, beta, sigma); seeds [B] int32 >= 0; mean255 and
// inv_std [channels] f32. Returns the CUDA error of the launch (0 = ok).
extern "C" int preprocess_fwd(const void* images, void* out,
                              const float* scalars, const int* seeds,
                              const float* mean255, const float* inv_std,
                              int B, int channels, long long per_image,
                              int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long pairs = (per_image + 1) >> 1;
  long long blocks = (pairs + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  const auto* img = static_cast<const uint8_t*>(images);
  if (out_bf16) {
    preprocess_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        img, static_cast<__nv_bfloat16*>(out), scalars, seeds, mean255,
        inv_std, per_image, channels);
  } else {
    preprocess_fwd_kernel<float><<<grid, threads, 0, s>>>(
        img, static_cast<float*>(out), scalars, seeds, mean255, inv_std,
        per_image, channels);
  }
  return static_cast<int>(cudaGetLastError());
}
