// Host image helpers of the data pipeline: uint8 resizes and PNG row
// unfiltering. Plain C++ with a C interface and no CUDA; built by g++ at
// first use (fmc_uia_tpu_torch/ops/build.py) and loaded with ctypes, which
// releases the GIL for the length of each call, so the data engine's
// worker threads run these in parallel.
//
// The resizes are this package's own copy of the JAX package's host resize
// (fmc_uia_tpu/native/preproc.cpp) and follow cv2's conventions:
//   bilinear: half-pixel centres (src = (dst + 0.5) * scale - 0.5), edge
//     clamp, round half away from zero at the uint8 store. cv2 interpolates
//     in 11-bit fixed point, so results may differ from cv2.resize by 1.
//   nearest (masks): src = floor(dst * (1 / (dw / sw))), clamped, which is
//     cv2 INTER_NEAREST's arithmetic to the bit.
//
// png_unfilter undoes the five PNG filter types (None, Sub, Up, Average,
// Paeth). Average and Paeth depend on the row's own previous output, so
// they are sequential along a row and cannot be vectorised in numpy.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static inline double src_coord(int dst, double scale) {
  return (static_cast<double>(dst) + 0.5) * scale - 0.5;
}

// Bilinear resize of one HWC uint8 image.
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int ch,
                        uint8_t* dst, int dh, int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> wxs(dw);
  for (int x = 0; x < dw; ++x) {
    double fx = src_coord(x, sx);
    int x0 = static_cast<int>(std::floor(fx));
    float wx = static_cast<float>(fx - x0);
    x0s[x] = std::clamp(x0, 0, sw - 1);
    x1s[x] = std::clamp(x0 + 1, 0, sw - 1);
    wxs[x] = wx < 0.f ? 0.f : (wx > 1.f ? 1.f : wx);
  }
  for (int y = 0; y < dh; ++y) {
    double fy = src_coord(y, sy);
    int y0 = static_cast<int>(std::floor(fy));
    float wy = static_cast<float>(fy - y0);
    wy = wy < 0.f ? 0.f : (wy > 1.f ? 1.f : wy);
    int y0c = std::clamp(y0, 0, sh - 1);
    int y1c = std::clamp(y0 + 1, 0, sh - 1);
    const uint8_t* row0 = src + static_cast<size_t>(y0c) * sw * ch;
    const uint8_t* row1 = src + static_cast<size_t>(y1c) * sw * ch;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p00 = row0 + static_cast<size_t>(x0s[x]) * ch;
      const uint8_t* p01 = row0 + static_cast<size_t>(x1s[x]) * ch;
      const uint8_t* p10 = row1 + static_cast<size_t>(x0s[x]) * ch;
      const uint8_t* p11 = row1 + static_cast<size_t>(x1s[x]) * ch;
      float wx = wxs[x];
      for (int c = 0; c < ch; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        float val = top + (bot - top) * wy;
        out[static_cast<size_t>(x) * ch + c] =
            static_cast<uint8_t>(std::lround(val));
      }
    }
  }
}

// Nearest-neighbour resize of one HWC uint8 image (label-safe).
void resize_nearest_u8(const uint8_t* src, int sh, int sw, int ch,
                       uint8_t* dst, int dh, int dw) {
  const double ifx = 1.0 / (static_cast<double>(dw) / sw);
  const double ify = 1.0 / (static_cast<double>(dh) / sh);
  std::vector<int> xs(dw);
  for (int x = 0; x < dw; ++x) {
    xs[x] = std::min(static_cast<int>(std::floor(x * ifx)), sw - 1);
  }
  for (int y = 0; y < dh; ++y) {
    int ys = std::min(static_cast<int>(std::floor(y * ify)), sh - 1);
    const uint8_t* row = src + static_cast<size_t>(ys) * sw * ch;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      std::memcpy(out + static_cast<size_t>(x) * ch,
                  row + static_cast<size_t>(xs[x]) * ch, ch);
    }
  }
}

// Resize a batch of images (an array of pointers) into one [n, dh, dw, ch]
// buffer with a pool of num_threads threads over the items.
void resize_batch_u8(const uint8_t** srcs, const int* shs, const int* sws,
                     int ch, uint8_t* dst, int n, int dh, int dw,
                     int bilinear, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  const size_t out_stride = static_cast<size_t>(dh) * dw * ch;
  auto work = [&](int start, int step) {
    for (int i = start; i < n; i += step) {
      if (bilinear) {
        resize_bilinear_u8(srcs[i], shs[i], sws[i], ch,
                           dst + i * out_stride, dh, dw);
      } else {
        resize_nearest_u8(srcs[i], shs[i], sws[i], ch,
                          dst + i * out_stride, dh, dw);
      }
    }
  };
  if (num_threads == 1 || n <= 1) {
    work(0, 1);
    return;
  }
  std::vector<std::thread> threads;
  int t = std::min(num_threads, n);
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(work, i, t);
  for (auto& th : threads) th.join();
}

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Undo PNG filtering. raw: height rows of (1 filter byte + rowbytes);
// out: height * rowbytes bytes; bpp: bytes per complete pixel (1 below 8
// bits per pixel). Returns 0, or 1 + the first row whose filter type is
// not 0-4 (a corrupt stream).
int png_unfilter(const uint8_t* raw, uint8_t* out, int height,
                 long long rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + static_cast<size_t>(y) * (rowbytes + 1);
    const int ftype = in[0];
    ++in;
    uint8_t* cur = out + static_cast<size_t>(y) * rowbytes;
    switch (ftype) {
      case 0:
        std::memcpy(cur, in, rowbytes);
        break;
      case 1:
        for (long long i = 0; i < rowbytes; ++i)
          cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (long long i = 0; i < rowbytes; ++i)
          cur[i] = in[i] + (prev ? prev[i] : 0);
        break;
      case 3:
        for (long long i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (long long i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = in[i] + paeth(a, b, c);
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
