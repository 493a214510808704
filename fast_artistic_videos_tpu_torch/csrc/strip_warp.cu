// Static separable-projective strip warp (the VR border maps) for Hopper
// (sm_90a), plain C interface.
//
// Replaces: fast_artistic_videos_tpu/ops/warp_pallas.py `_strip_kernel`
// (pallas_call in `make_static_strip_warp`). On the TPU the warp avoids a
// gather: a column stage of masked lane rolls folded with the horizontal
// weights, then a one-hot-weighted row reduction over an 8-aligned window,
// padded back to the frame with a second pass. Those shapes exist for
// Mosaic only. Here it is a gather with static tables (built once on the
// host by ops/strip_warp_kernel.py): for an output pixel (y, x) inside the
// box [y0, y0 + bh) x [x0, x0 + bw) of mapped pixels, with a = y - y0,
// b = x - x0,
//
//   p0, fp = pix_src[a * bw + b], pix_frac[a * bw + b]   (per pixel)
//   q0, fq = line_src[l],        line_frac[l]            (l = a if transposed, else b)
//   A(p)   = (1 - fq) * S(p, q0) + fq * S(p, q0 + 1)
//   out    = (1 - fp) * A(p0)    + fp * A(p0 + 1)
//
// where S(p, q) is img[p, q] (or img[q, p] when transposed: the top/bottom
// maps' line axis is the row) and reads zero outside the image. Unmapped
// pixels carry a p0 whose two taps both lie outside the image. Every pixel
// outside the box is written as zero, so ONE pass writes the whole
// (Ho, Wo, C) frame (the TPU version pads in a second pass).
//
// Layout: NHWC image (f32 or bf16), N images sharing the map; float32
// output (N, Ho, Wo, C); float32 arithmetic.
//
// What bounds it on the H100: memory, and at the VR shapes the launch. The
// least bytes are the source strip read once plus the output frame written
// once: at a 922x922x3 face with a 128-px overlap about 1.4 MB + 10.2 MB,
// ~3.5 us at 3.35 TB/s. Design: one thread per output pixel (n, y, x)
// looping over C, threads consecutive in x, so table reads, output writes
// and (for left/right maps) the taps coalesce; the taps of neighbouring
// pixels overlap and come from L1/L2. No shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kMaxC = 1024;

template <typename T>
__global__ void strip_warp_kernel(const T* __restrict__ img,
                                  const int* __restrict__ pix_src,
                                  const float* __restrict__ pix_frac,
                                  const int* __restrict__ line_src,
                                  const float* __restrict__ line_frac,
                                  float* __restrict__ out, int n, int h, int w,
                                  int c, int ho, int wo, int y0, int x0, int bh,
                                  int bw, int transposed) {
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t npix = (int64_t)n * ho * wo;
  if (pix >= npix) return;
  const int x = (int)(pix % wo);
  const int y = (int)((pix / wo) % ho);
  const int64_t img_n = (pix / ((int64_t)wo * ho)) * h * w;  // n * h * w
  float* o = out + pix * c;
  const int a = y - y0, b = x - x0;
  if (a < 0 || a >= bh || b < 0 || b >= bw) {
    for (int k = 0; k < c; ++k) o[k] = 0.f;
    return;
  }
  const int64_t t = (int64_t)a * bw + b;
  const int l = transposed ? a : b;
  const int p0 = pix_src[t], q0 = line_src[l];
  const float fp = pix_frac[t], fq = line_frac[l];
  // the pixel axis runs over image rows (or columns when transposed)
  const int p_end = transposed ? w : h, q_end = transposed ? h : w;
  int64_t src[2][2];  // [pixel tap][line tap], -1 = outside the image
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2; ++j) {
      const int p = p0 + i, q = q0 + j;
      const bool ok = p >= 0 && p < p_end && q >= 0 && q < q_end;
      const int r = transposed ? q : p, col = transposed ? p : q;
      src[i][j] = ok ? (img_n + (int64_t)r * w + col) * c : -1;
    }
  }
  for (int k = 0; k < c; ++k) {
    float s[2][2];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        s[i][j] = src[i][j] >= 0 ? to_f<T>(img[src[i][j] + k]) : 0.f;
    const float a0 = (1.f - fq) * s[0][0] + fq * s[0][1];
    const float a1 = (1.f - fq) * s[1][0] + fq * s[1][1];
    o[k] = (1.f - fp) * a0 + fp * a1;
  }
}

}  // namespace

extern "C" int fav_strip_warp(const void* img, const void* pix_src,
                              const void* pix_frac, const void* line_src,
                              const void* line_frac, void* out, int n, int h,
                              int w, int c, int ho, int wo, int y0, int x0,
                              int bh, int bw, int transposed, int is_bf16,
                              void* stream) {
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  const int64_t npix = (int64_t)n * ho * wo;
  const int threads = 256;
  const unsigned blocks = (unsigned)((npix + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    strip_warp_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)img, (const int*)pix_src, (const float*)pix_frac,
        (const int*)line_src, (const float*)line_frac, (float*)out, n, h, w, c,
        ho, wo, y0, x0, bh, bw, transposed);
  } else {
    strip_warp_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)img, (const int*)pix_src, (const float*)pix_frac,
        (const int*)line_src, (const float*)line_frac, (float*)out, n, h, w, c,
        ho, wo, y0, x0, bh, bw, transposed);
  }
  return (int)cudaGetLastError();
}
