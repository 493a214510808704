// Banded bilinear flow warp for Hopper (sm_90a), plain C interface.
//
// Replaces: fast_artistic_videos_tpu/ops/warp_pallas.py `_vpass_kernel`
// (pallas_call in `_banded_vpass`). On the TPU the warp is two launches of
// a banded vertical pass with transposes between them; here one kernel
// computes the composed result directly, with exactly the two-pass math of
// ops/warp.py `_warp_banded_single`:
//
//   v(y, x')  = sum_{i in {0,1}} wy_i(y, x') * img(y + floor(dy(y, x')) + i, x')
//   out(y, x) = sum_{j in {0,1}} wx_j(y, x)  * v(y, x + floor(dx(y, x)) + j)
//
// i.e. the vertical sample at a displaced column uses THAT column's dy —
// the documented composition approximation of warp.py:103-113, not the
// exact gather. A tap whose shift lies outside [-band, band + 1], or whose
// source row/column lies outside the image, contributes zero.
//
// Layout: NHWC image (f32 or bf16), flow (N, H, W, 2) f32 (dx, dy); f32
// accumulation, output in the image dtype.
//
// What bounds it on the H100: memory. Each output element reads about four
// image taps and two flow values and writes once — far below the card's
// FLOP/byte balance. Design: one thread per output pixel (n, y, x) looping
// over C, threads consecutive in x, so flow reads, output writes and the
// (mostly same-row) tap reads coalesce; the taps of neighbouring pixels
// overlap and are served from L1/L2. No shared memory: the working set per
// warp is a few rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kMaxC = 1024;

template <typename T>
__global__ void warp_banded_kernel(const T* __restrict__ img,
                                   const float* __restrict__ flow,
                                   T* __restrict__ out, int n, int h, int w,
                                   int c, int band) {
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t npix = (int64_t)n * h * w;
  if (pix >= npix) return;
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int64_t plane = (pix / ((int64_t)w * h)) * h * w;  // n * h * w

  // The 2 x 2 taps: column j at x + floor(dx) + j, row i of that column at
  // y + floor(dy(y, column)) + i. A tap outside the band or the image gets
  // weight 0 and source -1 (reads nothing).
  float wx[2], wy[2][2];
  int64_t src[2][2];
  const float dx = flow[pix * 2];
  const float bx = floorf(dx);
  const float wx0 = 1.f - (dx - bx);
  const int sx0 = (int)bx;
  for (int j = 0; j < 2; ++j) {
    const int sx = sx0 + j;
    const int xc = x + sx;
    const bool okx = sx >= -band && sx <= band + 1 && xc >= 0 && xc < w;
    wx[j] = okx ? (j == 0 ? wx0 : 1.f - wx0) : 0.f;
    float dy = 0.f;
    if (okx) dy = flow[(plane + (int64_t)y * w + xc) * 2 + 1];
    const float by = floorf(dy);
    const float wy0 = 1.f - (dy - by);
    const int sy0 = (int)by;
    for (int i = 0; i < 2; ++i) {
      const int sy = sy0 + i;
      const int yr = y + sy;
      const bool ok = okx && sy >= -band && sy <= band + 1 && yr >= 0 && yr < h;
      wy[j][i] = ok ? (i == 0 ? wy0 : 1.f - wy0) : 0.f;
      src[j][i] = ok ? (plane + (int64_t)yr * w + xc) * c : -1;
    }
  }
  T* o = out + pix * c;
  for (int k = 0; k < c; ++k) {
    float acc = 0.f;
    for (int j = 0; j < 2; ++j) {
      float v = 0.f;
      if (src[j][0] >= 0) v += to_f<T>(img[src[j][0] + k]) * wy[j][0];
      if (src[j][1] >= 0) v += to_f<T>(img[src[j][1] + k]) * wy[j][1];
      acc += v * wx[j];
    }
    o[k] = from_f<T>(acc);
  }
}

}  // namespace

extern "C" int fav_warp_banded(const void* img, const void* flow, void* out,
                               int n, int h, int w, int c, int band,
                               int is_bf16, void* stream) {
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  const int64_t npix = (int64_t)n * h * w;
  const int threads = 128;
  const unsigned blocks = (unsigned)((npix + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_banded_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float*)flow, (__nv_bfloat16*)out,
        n, h, w, c, band);
  } else {
    warp_banded_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)img, (const float*)flow, (float*)out, n, h, w, c, band);
  }
  return (int)cudaGetLastError();
}
