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
// accumulation, one rounding to the image dtype at the store.
//
// What bounds it on the H100: memory. Each output element reads four image
// taps (neighbouring pixels' taps overlap, so L1/L2 serve most of them) and
// its share of the flow, and is written once: about 6 FMAs per element,
// far below the card's FLOP/byte balance. So the design is about bytes and
// instructions per byte:
//  * a 2D grid (x tile, row, image) and 32-bit offsets (the wrapper raises
//    at 2^31 elements): no division per pixel;
//  * each block stages its row's flow, widened by band + 1 columns on each
//    side (at most kHalo), in shared memory with one coalesced float2 load
//    per column: a pixel's (dx, dy) and the dy of its two displaced columns
//    come from there;
//  * two entries. `fav_warp_banded_vec` (C * element size a multiple of 16
//    bytes, 16-byte aligned image: every feature and delta width) computes
//    each pixel's taps and weights once into shared memory, then a thread
//    owns one 16-byte channel vector of one pixel: four 16-byte read-only
//    tap loads and one 16-byte store, lanes of a warp on consecutive
//    vectors. With vec = 1 the same kernel takes one element per thread
//    (the scalar path: any other C). `fav_warp_banded` (C <= 4: flow, RGB)
//    gives each thread one pixel's whole channel vector.
//
// Measured on the H100 (PERF.md): the vector entry reaches 58-87% of
// its byte bound at the feature and delta widths. The pixel entry reaches
// 59-80% on the main paths' flows, 47-49% on per-pixel random flows (f32
// RGB): there a warp's taps scatter over +-band rows, and the four taps of
// each pixel are L2 sector reads that L1 rarely serves again. Its time is
// about the same in bf16 as in f32: it is held by the gather, not by the
// bytes. Each of these was no faster or was slower, and is not used:
// staging the output in shared memory for 16-byte stores; two, four or
// eight pixels a thread; one block walking down a strip of rows; 16-byte
// tap loads; three threads a pixel (the scalar path); copying the bounding
// box of a 64 x 8 tile's taps into shared memory (72 KB a block: too few
// blocks per SM); streaming cache hints on the flow and the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 1024;
constexpr int kHalo = 64;           // staged flow columns beyond a tile, each side
constexpr int kPixTile = 128;       // pixels (= threads) per block, fav_warp_banded
constexpr int kVecThreads = 256;    // threads per block, fav_warp_banded_vec
constexpr int kVecItems = 1024;     // vectors per block of fav_warp_banded_vec
constexpr int kMaxTile = 256;       // pixels per block, at most

// The image as raw bits: unsigned for float32, unsigned short for bfloat16.
__device__ __forceinline__ float to_f(unsigned v) { return __uint_as_float(v); }
__device__ __forceinline__ float to_f(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}
template <typename B> __device__ __forceinline__ B from_f(float v);
template <> __device__ __forceinline__ unsigned from_f<unsigned>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ unsigned short from_f<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// one 16-byte vector of V elements -> floats (V * sizeof(B) == 16)
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const unsigned r[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(r[q] << 16);
    f[2 * q + 1] = __uint_as_float(r[q] & 0xffff0000u);
  }
}
// floats -> one 16-byte vector of V elements
__device__ __forceinline__ uint4 pack(const unsigned (&b)[4]) {
  return make_uint4(b[0], b[1], b[2], b[3]);
}
__device__ __forceinline__ uint4 pack(const unsigned short (&b)[8]) {
  return make_uint4(b[0] | ((unsigned)b[1] << 16), b[2] | ((unsigned)b[3] << 16),
                    b[4] | ((unsigned)b[5] << 16), b[6] | ((unsigned)b[7] << 16));
}

// The taps of one output pixel: column j at x + floor(dx) + j with weight
// wx[j], and in that column rows y + floor(dy(y, column)) + i with weights
// wy[j][i] at pixel index src[j][i] (-1: outside the band or the image,
// reads nothing).
struct Taps {
  float wx[2], wy[2][2];
  int src[2][2];
};

// Stage the flow of the row starting at pixel index row, columns [lo, hi).
__device__ __forceinline__ void load_flow_row(const float* __restrict__ flow, int row, int lo,
                                              int hi, float2* win) {
  const bool aligned = (reinterpret_cast<uintptr_t>(flow) & 7) == 0;
  for (int i = threadIdx.x; i < hi - lo; i += blockDim.x) {
    const int p = row + lo + i;
    win[i] = aligned ? __ldg(reinterpret_cast<const float2*>(flow) + p)
                     : make_float2(__ldg(flow + 2 * p), __ldg(flow + 2 * p + 1));
  }
}

// The taps of pixel (row, x) of an image whose first pixel is `plane`; the
// row's flow is staged in win for columns [lo, hi), which hold x.
__device__ __forceinline__ Taps pixel_taps(const float* __restrict__ flow, const float2* win,
                                           int lo, int hi, int plane, int row, int x, int y,
                                           int h, int w, int band) {
  Taps t;
  const float dx = win[x - lo].x;
  const float bx = floorf(dx);
  const float wx0 = 1.f - (dx - bx);
  const int sx0 = (int)bx;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int sx = sx0 + j;
    const int xc = x + sx;
    const bool okx = sx >= -band && sx <= band + 1 && xc >= 0 && xc < w;
    t.wx[j] = okx ? (j == 0 ? wx0 : 1.f - wx0) : 0.f;
    float dy = 0.f;
    if (okx) dy = (xc >= lo && xc < hi) ? win[xc - lo].y : __ldg(flow + 2 * (row + xc) + 1);
    const float by = floorf(dy);
    const float wy0 = 1.f - (dy - by);
    const int sy0 = (int)by;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sy = sy0 + i;
      const int yr = y + sy;
      const bool ok = okx && sy >= -band && sy <= band + 1 && yr >= 0 && yr < h;
      t.wy[j][i] = ok ? (i == 0 ? wy0 : 1.f - wy0) : 0.f;
      t.src[j][i] = ok ? plane + yr * w + xc : -1;
    }
  }
  return t;
}

// C <= 4 channels: one thread per pixel of the block's row segment of
// kPixTile pixels; each thread stores its pixel's C elements, so a warp's
// stores cover one contiguous span.
template <typename B, int C>
__global__ void __launch_bounds__(kPixTile)
warp_banded_pixel_kernel(const B* __restrict__ img, const float* __restrict__ flow,
                         B* __restrict__ out, int h, int w, int band) {
  __shared__ float2 win[kPixTile + 2 * kHalo];
  const int x0 = blockIdx.x * kPixTile, y = blockIdx.y;
  const int plane = blockIdx.z * h * w;
  const int row = plane + y * w;
  const int halo = min(band, kHalo - 1) + 1;
  const int lo = max(x0 - halo, 0), hi = min(x0 + kPixTile + halo, w);
  load_flow_row(flow, row, lo, hi, win);
  __syncthreads();
  const int npix = min(kPixTile, w - x0);
  if ((int)threadIdx.x < npix) {
    const Taps t = pixel_taps(flow, win, lo, hi, plane, row, x0 + threadIdx.x, y, h, w, band);
    float acc[C];
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[C];
#pragma unroll
      for (int k = 0; k < C; ++k) v[k] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (t.src[j][i] >= 0) {
          const B* s = img + t.src[j][i] * C;
#pragma unroll
          for (int k = 0; k < C; ++k) v[k] += to_f(__ldg(s + k)) * t.wy[j][i];
        }
      }
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] += v[k] * t.wx[j];
    }
    B* o = out + (row + x0 + threadIdx.x) * C;
#pragma unroll
    for (int k = 0; k < C; ++k) o[k] = from_f<B>(acc[k]);
  }
}

// V elements a thread (16 bytes, or 1: the scalar path): each pixel's taps
// once into shared memory, then `lanes` threads per pixel walk its c / V
// vectors, groups of lanes on consecutive pixels.
template <typename B, int V>
__global__ void __launch_bounds__(kVecThreads)
warp_banded_vec_kernel(const B* __restrict__ img, const float* __restrict__ flow,
                       B* __restrict__ out, int h, int w, int c, int band, int tile) {
  __shared__ float2 win[kMaxTile + 2 * kHalo];
  __shared__ Taps taps[kMaxTile];
  const int x0 = blockIdx.x * tile, y = blockIdx.y;
  const int plane = blockIdx.z * h * w;
  const int row = plane + y * w;
  const int halo = min(band, kHalo - 1) + 1;
  const int lo = max(x0 - halo, 0), hi = min(x0 + tile + halo, w);
  load_flow_row(flow, row, lo, hi, win);
  __syncthreads();
  const int npix = min(tile, w - x0);
  for (int p = threadIdx.x; p < npix; p += blockDim.x)
    taps[p] = pixel_taps(flow, win, lo, hi, plane, row, x0 + p, y, h, w, band);
  __syncthreads();
  const int cv = c / V;
  const int lanes = min(cv, (int)blockDim.x);
  const int groups = blockDim.x / lanes;
  const int kk = threadIdx.x % lanes, pg = threadIdx.x / lanes;
  if (pg >= groups) return;
  B* o = out + (row + x0) * c;
  for (int p = pg; p < npix; p += groups) {
    const Taps t = taps[p];
    for (int k = kk; k < cv; k += lanes) {
      float acc[V];
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v[V];
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = t.src[j][i];
          if (s >= 0) {
            float f[V];
            if constexpr (V == 1) {
              f[0] = to_f(__ldg(img + s * c + k));
            } else {
              unpack(__ldg(reinterpret_cast<const uint4*>(img + s * c) + k), f);
            }
#pragma unroll
            for (int q = 0; q < V; ++q) v[q] += f[q] * t.wy[j][i];
          }
        }
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] += v[q] * t.wx[j];
      }
      B b[V];
#pragma unroll
      for (int q = 0; q < V; ++q) b[q] = from_f<B>(acc[q]);
      if constexpr (V == 1) {
        o[p * c + k] = b[0];
      } else {
        reinterpret_cast<uint4*>(o + p * c)[k] = pack(b);
      }
    }
  }
}

constexpr int kMaxBand = 1 << 24;

bool args_ok(int n, int h, int w, int c, int band) {
  return band >= 0 && band <= kMaxBand && n >= 1 && h >= 1 && w >= 1 && c >= 1 && c <= kMaxC && n <= 65535 && h <= 65535 &&
         (int64_t)n * h * w * c < ((int64_t)1 << 31);
}

template <typename B>
int launch_pixel(const void* img, const void* flow, void* out, int n, int h, int w, int c,
                 int band, cudaStream_t s) {
  const dim3 grid((w + kPixTile - 1) / kPixTile, h, n);
  const B* im = (const B*)img;
  const float* fl = (const float*)flow;
  B* o = (B*)out;
  switch (c) {
    case 1: warp_banded_pixel_kernel<B, 1><<<grid, kPixTile, 0, s>>>(im, fl, o, h, w, band); break;
    case 2: warp_banded_pixel_kernel<B, 2><<<grid, kPixTile, 0, s>>>(im, fl, o, h, w, band); break;
    case 3: warp_banded_pixel_kernel<B, 3><<<grid, kPixTile, 0, s>>>(im, fl, o, h, w, band); break;
    case 4: warp_banded_pixel_kernel<B, 4><<<grid, kPixTile, 0, s>>>(im, fl, o, h, w, band); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename B, int V>
int launch_vec(const void* img, const void* flow, void* out, int n, int h, int w, int c,
               int band, cudaStream_t s) {
  if (c % V) return (int)cudaErrorInvalidValue;
  if (V > 1 && (reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int cv = c / V;
  const int tile = max(1, min(kMaxTile, kVecItems / cv));
  const dim3 grid((w + tile - 1) / tile, h, n);
  warp_banded_vec_kernel<B, V><<<grid, kVecThreads, 0, s>>>(
      (const B*)img, (const float*)flow, (B*)out, h, w, c, band, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// C <= 4 (flow, RGB): one thread per pixel.
extern "C" int fav_warp_banded(const void* img, const void* flow, void* out, int n, int h,
                               int w, int c, int band, int is_bf16, void* stream) {
  if (!args_ok(n, h, w, c, band) || c > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_pixel<unsigned short>(img, flow, out, n, h, w, c, band, s)
                 : launch_pixel<unsigned>(img, flow, out, n, h, w, c, band, s);
}

// vec = 16 / element size (C a multiple of it, image and output 16-byte
// aligned): one 16-byte channel vector a thread; vec = 1: one element.
extern "C" int fav_warp_banded_vec(const void* img, const void* flow, void* out, int n, int h,
                                   int w, int c, int band, int is_bf16, int vec,
                                   void* stream) {
  if (!args_ok(n, h, w, c, band)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (vec == 8) return launch_vec<unsigned short, 8>(img, flow, out, n, h, w, c, band, s);
    if (vec == 1) return launch_vec<unsigned short, 1>(img, flow, out, n, h, w, c, band, s);
  } else {
    if (vec == 4) return launch_vec<unsigned, 4>(img, flow, out, n, h, w, c, band, s);
    if (vec == 1) return launch_vec<unsigned, 1>(img, flow, out, n, h, w, c, band, s);
  }
  return (int)cudaErrorInvalidValue;
}
