// Fused photometric train preprocessing (K3), for sm_90a.
//
// Replaces the TPU kernel fmc_uia_tpu/ops/preprocess_pallas.py
// fused_augment_normalize -> _fused_call -> _kernel: per image b and
// element e of its P = H * W * C uint8 pixels (channel c = e % C),
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
// constants and round order) written out here, with the fixed counter
// layout above (pairs counted per image) that the plain version
// (ops/preprocess.py) reproduces exactly. The products and sums are the
// explicit __fmul_rn/__fadd_rn of the JAX kernel's separate multiply and
// add (no FMA contraction); logf, cosf and sqrtf are the accurate versions
// (no fast math). With sigma = 0 the output is bitwise that of the plain
// version.
//
// Noise only where sigma != 0. A chunk of an image with sigma == 0.0f (an
// exact test, true for -0 too) skips Philox, Box-Muller and the second
// clip. That is bitwise the same output: u1 >= 1e-7, so |n| <= sqrt(-2 ln
// 1e-7) ~ 5.68 is finite; sigma * n is then +-0 exactly; x + (+-0) = x
// for every x in [0, 255] other than -0 in round to nearest (+0 + -0 =
// +0); and the second clip leaves x as it was. The first clip gives -0
// only for alpha * u8 = -0 and beta = -0, which draw_params never yields;
// there the two outputs may be zeros of opposite sign.
//
// What bounds it (chip_smoke.py phase 2c counts the instructions this
// function needs by the sm_90 pipe that issues them, for the images of
// the case timed): it reads each uint8 once and writes each output once,
// 56.6 MB at B = 24, 512², bf16 (0.0169 ms at 3.35 TB/s). Philox binds an
// image with noise: a pair needs 36 integer multiply instructions (a 32 x
// 32 -> 64-bit product is two; round 0 has only c0's product, round 1
// only c2's, since c0 = seed there) on the FMA pipe at 64 a clock per SM,
// and 18 three-input XORs (one LOP3 each) on the ALU pipe; with noise on
// every image ~0.020 ms. With the train path's draws (noise on ~10 % of
// the images) and with none, the bytes bind.
//
// Design:
// - One 16-byte load a chunk of 16 uint8 (LDG.E.128), neighbouring
//   threads on neighbouring chunks, two chunks a thread in flight.
// - 16-byte stores (STG.E.128) through a per-warp stage in shared memory:
//   a lane writes its chunk's outputs there (bf16 packed two at a time by
//   __floats2bfloat162_rn, the rounding of __float2bfloat16_rn), then the
//   warp stores the 32 chunks' outputs in order, so that each store
//   instruction writes whole sectors, neighbouring lanes on neighbouring
//   16 bytes. Ordinary stores: the next op reads the output from L2.
// - A flat persistent grid (SMs x kBlocksPerSm blocks, sized by launch
//   below from the device's SM count) strides over the batch's chunks, so
//   the few images with noise spread over every SM.
// - Index work once a chunk, in 32 bits (P < 2^31, checked by the
//   wrapper): the image, the in-image start e0 (even: the chunk's 8 Philox
//   pairs start at e0 / 2) and the channel phase e0 % C. The 16 (255 mean,
//   inv_std) pairs of each phase sit in a shared table, read as float4.
// - A byte becomes a float exactly without a conversion instruction:
//   __uint_as_float(0x4B000000 | v) - 2^23 = v.
// - A chunk runs in two halves of 8 elements to keep registers down. The
//   noise branch runs a half's 4 Philox calls independent and unrolled,
//   for ILP; the round keys' first words (seed + r W0) are computed once a
//   chunk, the second words (r W1) are constants. With noise on every
//   image the branch runs at ~5x its bound; the accurate logf, cosf and
//   sqrtf add tens of instructions an element beside Philox's, and which
//   limit binds is not measured (PERF.md §6).
// - Edge path: when P % 16 != 0, C > kMaxVecC or a pointer is not 16-byte
//   aligned (a view into a larger buffer), preprocess_fwd_elem runs one
//   thread per in-image pair with byte loads and scalar stores, the same
//   arithmetic and the same sigma == 0 skip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr float kTwoPi = 6.283185482025146484375f;  // 2 * float(pi)
constexpr float kInv24 = 5.9604644775390625e-8f;    // 2^-24
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr int kRounds = 10;
constexpr int kVec = 16;          // uint8 elements a chunk: one 16-byte load
constexpr int kThreads = 256;     // threads a block, both kernels
constexpr int kBlocksPerSm = 3;   // the vector kernel's launch bounds
constexpr int kMaxVecC = 16;      // channels the vector kernel's table holds
// a table row: the 16 (mean, inv_std) pairs of one channel phase, padded
// to 18 float2 (144 bytes) so that rows of neighbouring phases start on
// other banks
constexpr int kRow = kVec + 2;

// the first word of each round's key, seed + r * W0 (the second, r * W1,
// is a constant)
struct Keys {
  uint32_t k0[kRounds];
};

__device__ __forceinline__ Keys key_schedule(uint32_t seed) {
  Keys k;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) k.k0[r] = seed + r * kW0;
  return k;
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, const Keys& k) {
  uint32_t c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k.k0[r];
    const uint32_t n2 = hi0 ^ c3 ^ static_cast<uint32_t>(r * kW1);
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

__device__ __forceinline__ float affine(float v, float alpha, float beta) {
  return clip255(__fadd_rn(__fmul_rn(v, alpha), beta));
}

// x + sigma * n, clipped; n from the Philox words (w1, w2)
__device__ __forceinline__ float add_noise(float x, float sigma,
                                           uint32_t w1, uint32_t w2) {
  float u1 = __fmul_rn(static_cast<float>(w1 >> 8), kInv24);
  const float u2 = __fmul_rn(static_cast<float>(w2 >> 8), kInv24);
  u1 = fmaxf(u1, 1e-7f);
  const float n = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                            cosf(__fmul_rn(kTwoPi, u2)));
  return clip255(__fadd_rn(x, __fmul_rn(sigma, n)));
}

__device__ __forceinline__ float normalise(float x, float mean255,
                                           float inv_std) {
  return __fmul_rn(__fsub_rn(x, mean255), inv_std);
}

// byte j of w as a float, exactly: 2^23 + v has v in its low mantissa bits
__device__ __forceinline__ float byte_float(uint32_t w, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + j)),
                   8388608.0f);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 outputs as one 16-byte piece (bf16) or two (f32)
template <typename Out>
__device__ __forceinline__ void store8(uint4* d, const float* y) {
  if constexpr (sizeof(Out) == 2) {
    d[0] = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                      pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
  } else {
    d[0] = make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]),
                      __float_as_uint(y[2]), __float_as_uint(y[3]));
    d[1] = make_uint4(__float_as_uint(y[4]), __float_as_uint(y[5]),
                      __float_as_uint(y[6]), __float_as_uint(y[7]));
  }
}

// 16-byte output pieces a chunk: 2 (bf16) or 4 (f32)
template <typename Out>
constexpr int kPieces = kVec * sizeof(Out) / 16;

// one chunk k: the 16 uint8 of image b from in-image element e0 = 16 kin,
// in two halves of 8 elements (4 Philox pairs) to keep registers down;
// its kPieces output pieces go to dst
template <typename Out>
__device__ __forceinline__ void run_chunk(
    uint4 raw, uint32_t k, uint4* dst, const float* __restrict__ scalars,
    const int* __restrict__ seeds, const float2* tab,
    uint32_t chunks_per_image, uint32_t channels) {
  const uint32_t b = k / chunks_per_image;
  const uint32_t kin = k - b * chunks_per_image;
  const float alpha = __ldg(scalars + 3 * b);
  const float beta = __ldg(scalars + 3 * b + 1);
  const float sigma = __ldg(scalars + 3 * b + 2);
  const bool noisy = sigma != 0.0f;
  Keys keys;
  if (noisy) keys = key_schedule(static_cast<uint32_t>(__ldg(seeds + b)));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  // (mean, inv_std) of elements 2i and 2i + 1 of the chunk's phase
  const float4* t =
      reinterpret_cast<const float4*>(tab + (kin * kVec) % channels * kRow);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = affine(byte_float(w[2 * h + (j >> 2)], j & 3), alpha, beta);
    if (noisy) {
      uint4 r[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        r[p] = philox4x32_10(kin * (kVec / 2) + 4 * h + p, keys);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        x[2 * p] = add_noise(x[2 * p], sigma, r[p].x, r[p].y);
        x[2 * p + 1] = add_noise(x[2 * p + 1], sigma, r[p].z, r[p].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 ms = t[4 * h + i];
      x[2 * i] = normalise(x[2 * i], ms.x, ms.y);
      x[2 * i + 1] = normalise(x[2 * i + 1], ms.z, ms.w);
    }
    store8<Out>(dst + h * kPieces<Out> / 2, x);
  }
}

// chunk kw + lane of a warp's 32 (when valid), through the warp's stage:
// each lane writes its chunk's pieces there, then the warp stores the 32
// chunks' pieces in order, neighbouring lanes on neighbouring pieces (a
// lane's own pieces would leave every store instruction half a sector
// per lane)
template <typename Out>
__device__ __forceinline__ void emit(
    uint4 raw, uint32_t kw, uint32_t lane, uint32_t chunks, uint4* stage,
    Out* __restrict__ out, const float* __restrict__ scalars,
    const int* __restrict__ seeds, const float2* tab,
    uint32_t chunks_per_image, uint32_t channels) {
  constexpr int P = kPieces<Out>;
  if (kw + lane < chunks)
    run_chunk<Out>(raw, kw + lane, stage + lane * P, scalars, seeds, tab,
                   chunks_per_image, channels);
  __syncwarp();
  uint4* o = reinterpret_cast<uint4*>(out) + static_cast<size_t>(kw) * P;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const uint32_t piece = i * 32 + lane;
    if (kw + piece / P < chunks) o[piece] = stage[piece];
  }
  __syncwarp();
}

template <typename Out>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    preprocess_fwd_vec(const uint4* __restrict__ images,
                       Out* __restrict__ out,
                       const float* __restrict__ scalars,
                       const int* __restrict__ seeds,
                       const float* __restrict__ mean255,
                       const float* __restrict__ inv_std,
                       uint32_t channels, uint32_t chunks_per_image,
                       uint32_t chunks) {
  __shared__ __align__(16) float2 tab[kMaxVecC * kRow];
  __shared__ uint4 stage[kThreads / 32][32 * kPieces<Out>];
  for (uint32_t i = threadIdx.x; i < channels * kVec; i += blockDim.x) {
    const uint32_t row = i / kVec, j = i % kVec, c = (row + j) % channels;
    tab[row * kRow + j] = make_float2(mean255[c], inv_std[c]);
  }
  __syncthreads();
  const uint32_t lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint4 none = make_uint4(0, 0, 0, 0);
  // the warp's first chunk kw; its lanes take kw + lane (warp-uniform
  // loop: every lane reaches the stage's __syncwarp)
  for (uint32_t kw = blockIdx.x * blockDim.x + warp * 32; kw < chunks;
       kw += 2 * stride) {
    const uint32_t k = kw + lane, k2 = k + stride;
    const uint4 a = k < chunks ? __ldg(images + k) : none;
    const uint4 b = k2 < chunks ? __ldg(images + k2) : none;
    emit(a, kw, lane, chunks, stage[warp], out, scalars, seeds, tab,
         chunks_per_image, channels);
    if (kw + stride < chunks)
      emit(b, kw + stride, lane, chunks, stage[warp], out, scalars, seeds,
           tab, chunks_per_image, channels);
  }
}

__device__ __forceinline__ void store1(float* out, long long i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void store1(__nv_bfloat16* out, long long i,
                                       float v) {
  out[i] = __float2bfloat16_rn(v);
}

// the edge path: one thread per in-image pair of elements
template <typename Out>
__global__ void __launch_bounds__(kThreads)
    preprocess_fwd_elem(const uint8_t* __restrict__ images,
                        Out* __restrict__ out,
                        const float* __restrict__ scalars,
                        const int* __restrict__ seeds,
                        const float* __restrict__ mean255,
                        const float* __restrict__ inv_std, int channels,
                        long long per_image, long long pairs) {
  const long long pairs_per_image = (per_image + 1) >> 1;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < pairs; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = t / pairs_per_image;
    const uint32_t q = static_cast<uint32_t>(t - b * pairs_per_image);
    const long long e = 2 * static_cast<long long>(q);
    const uint8_t* img = images + b * per_image;
    Out* dst = out + b * per_image;
    const float alpha = __ldg(scalars + 3 * b);
    const float beta = __ldg(scalars + 3 * b + 1);
    const float sigma = __ldg(scalars + 3 * b + 2);
    const bool second = e + 1 < per_image;
    float x0 = affine(static_cast<float>(img[e]), alpha, beta);
    float x1 = second ? affine(static_cast<float>(img[e + 1]), alpha, beta)
                      : 0.0f;
    if (sigma != 0.0f) {
      const uint4 w = philox4x32_10(
          q, key_schedule(static_cast<uint32_t>(__ldg(seeds + b))));
      x0 = add_noise(x0, sigma, w.x, w.y);
      x1 = add_noise(x1, sigma, w.z, w.w);
    }
    int c = static_cast<int>(e % channels);
    store1(dst, e, normalise(x0, __ldg(mean255 + c), __ldg(inv_std + c)));
    if (second) {
      c = c + 1 == channels ? 0 : c + 1;
      store1(dst, e + 1,
             normalise(x1, __ldg(mean255 + c), __ldg(inv_std + c)));
    }
  }
}

// the SMs of the current device, read once a device
cudaError_t sm_count(int* sms) {
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64) {
    *sms = cache[dev].load(std::memory_order_relaxed);
    if (*sms > 0) return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64)
    cache[dev].store(*sms, std::memory_order_relaxed);
  return e;
}

// The vector kernel needs every image to start on a 16-byte boundary in
// the input and the output (per_image % 16 == 0, both pointers aligned),
// channels <= kMaxVecC and fewer than 2^31 chunks; anything else takes
// the edge kernel. Either grid is persistent: at most SMs x kBlocksPerSm
// blocks, fewer when the work is smaller (a vector thread takes two
// chunks at a time, an edge thread one pair).
template <typename Out>
cudaError_t launch(const void* images, void* out, const float* scalars,
                   const int* seeds, const float* mean255,
                   const float* inv_std, int B, int channels,
                   long long per_image, int* vector, cudaStream_t s) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long chunks = B * per_image / kVec;
  *vector = per_image % kVec == 0 && channels <= kMaxVecC &&
            reinterpret_cast<uintptr_t>(images) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
            chunks < (1LL << 31);
  const long long units = *vector ? chunks : B * ((per_image + 1) >> 1);
  const long long per_block = *vector ? 2 * kThreads : kThreads;
  const int grid = static_cast<int>(std::max(
      1LL, std::min((units + per_block - 1) / per_block,
                    static_cast<long long>(sms) * kBlocksPerSm)));
  if (*vector) {
    preprocess_fwd_vec<Out><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(images), static_cast<Out*>(out), scalars,
        seeds, mean255, inv_std, static_cast<uint32_t>(channels),
        static_cast<uint32_t>(per_image / kVec),
        static_cast<uint32_t>(chunks));
  } else {
    preprocess_fwd_elem<Out><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(images), static_cast<Out*>(out), scalars,
        seeds, mean255, inv_std, channels, per_image,
        B * ((per_image + 1) >> 1));
  }
  return cudaGetLastError();
}

}  // namespace

// images [B, per_image] uint8; out [B, per_image] f32 or bf16; scalars
// [B, 3] f32 (alpha, beta, sigma); seeds [B] int32 >= 0; mean255 and
// inv_std [channels] f32; per_image < 2^31. Launches the 16-byte chunk
// kernel or the per-pair edge kernel (see launch) and writes which into
// *vector (1: the chunk kernel). Returns the CUDA error of the launch
// (0 = ok).
extern "C" int preprocess_fwd(const void* images, void* out,
                              const float* scalars, const int* seeds,
                              const float* mean255, const float* inv_std,
                              int B, int channels, long long per_image,
                              int out_bf16, int* vector, void* stream) {
  if (B < 1 || channels < 1 || per_image < 0 || per_image >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(images, out, scalars, seeds, mean255,
                                       inv_std, B, channels, per_image,
                                       vector, s)
               : launch<float>(images, out, scalars, seeds, mean255, inv_std,
                               B, channels, per_image, vector, s);
  return static_cast<int>(err);
}
