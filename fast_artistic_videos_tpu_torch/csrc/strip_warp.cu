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
//
// The summing entry (fav_strip_warp_sum) computes, in ONE launch, what the
// VR driver composes from these warps (video/driver_vr.py: a face's border
// prior, and the cross-face blend of all six faces after a frame):
//
//   border_d = sum over its terms k of warp_{m_k}(rot_k(src_k))
//
// for up to six destination faces d, each term a source face, one of the
// four border maps and a rotation (0, 90, -90 or 180 degrees, as
// video/vr_geometry.py rotate90 / rotate_minus90 / rotate180). Then one of
// three epilogues: the sum (prior positions 1-3), the sum of each term
// divided by div (positions 4-5), or the blend (sum / div, then
// s_d * (1 - gm) + border * gm). The float32 operations run in the
// composition's order, each rounded on its own (no contraction), so the
// result is that of the composition up to the warps' own rounding. The
// rotation is folded into the source index, so no rotated copy is made;
// a term contributes only inside its map's box (outside it the warp is 0,
// and adding or dividing a 0 changes nothing). The term list travels by
// value in the kernel's parameter block (no host-to-device copy); the maps'
// tables stay resident on the card.
//
// What bounds it: bytes. The blend reads the six faces and the two masks
// and writes the six blended faces (at 922x922x3 float32: 61 MB read, 61 MB
// written, 6.8 MB of masks, plus the strips' taps), ~0.04 ms at 3.35
// TB/s; one thread per output pixel of a face, channels in registers.

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

constexpr int kSumMaps = 4, kSumDst = 6, kSumTerms = 4;

// The parameter block of fav_strip_warp_sum, every field 8 bytes wide so
// that the wrapper fills it as a flat int64 array (ops/strip_warp_kernel.py
// `_SumLayout` mirrors this layout).
struct SumMap {
  const int* pix_src;
  const float* pix_frac;
  const int* line_src;
  const float* line_frac;
  long long y0, x0, bh, bw, transposed;
};
struct SumTerm {
  const void* src;          // (h, w, 3) source face before its rotation
  long long map, rot, bf16; // rot: 0, 1 = 90, 2 = -90, 3 = 180 degrees
  long long row;            // elements from one source row to the next
};
struct SumDst {
  const void* s;            // the blend: this face (h, w, 3); else null
  long long s_bf16, s_row, nterm;
  SumTerm term[kSumTerms];
};
struct SumArgs {
  SumMap map[kSumMaps];
  SumDst dst[kSumDst];
  const float* div;         // (h, w), modes 1 and 2
  const float* gm;          // (h, w), the blend only
  float* out;               // (ndst, h, w, 3)
  long long ndst, h, w, mode;   // mode 0: sum, 1: sum of term / div, 2: blend
};
static_assert(sizeof(SumArgs) <= 4000, "the parameter block holds 4 KB");

__device__ __forceinline__ float load_f(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(256) strip_warp_sum_kernel(const SumArgs p) {
  const int d = blockIdx.y;
  const int h = (int)p.h, w = (int)p.w;
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (int64_t)h * w) return;
  const int y = (int)(pix / w), x = (int)(pix % w);
  const SumDst& dst = p.dst[d];
  const float div = p.mode != 0 ? p.div[pix] : 1.f;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < (int)dst.nterm; ++k) {
    const SumTerm& tm = dst.term[k];
    const SumMap& m = p.map[tm.map];
    const int a = y - (int)m.y0, b = x - (int)m.x0;
    if (a < 0 || a >= (int)m.bh || b < 0 || b >= (int)m.bw) continue;   // the warp is 0
    const int64_t t = (int64_t)a * m.bw + b;
    const bool tr = m.transposed != 0;
    const int p0 = m.pix_src[t], q0 = m.line_src[tr ? a : b];
    const float fp = m.pix_frac[t], fq = m.line_frac[tr ? a : b];
    // the rotated source is (hr, wr); its pixel (r, c) is the source's
    // pixel rotate90: (c, w - 1 - r); rotate_minus90: (h - 1 - c, r);
    // rotate180: (h - 1 - r, w - 1 - c)
    const int rot = (int)tm.rot;
    const int hr = (rot == 1 || rot == 2) ? w : h, wr = (rot == 1 || rot == 2) ? h : w;
    const int p_end = tr ? wr : hr, q_end = tr ? hr : wr;
    const bool bf16 = tm.bf16 != 0;
    float s[2][2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pp = p0 + i, qq = q0 + j;
        const bool ok = pp >= 0 && pp < p_end && qq >= 0 && qq < q_end;
        const int r = tr ? qq : pp, c = tr ? pp : qq;
        int sr = r, sc = c;
        if (rot == 1) { sr = c; sc = w - 1 - r; }
        else if (rot == 2) { sr = h - 1 - c; sc = r; }
        else if (rot == 3) { sr = h - 1 - r; sc = w - 1 - c; }
        const int64_t o = (int64_t)sr * tm.row + (int64_t)sc * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) s[i][j][ch] = ok ? load_f(tm.src, o + ch, bf16) : 0.f;
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      // the plain warp's expression, each operation rounded on its own
      const float gq = __fsub_rn(1.f, fq), gp = __fsub_rn(1.f, fp);
      const float a0 = __fadd_rn(__fmul_rn(gq, s[0][0][ch]), __fmul_rn(fq, s[0][1][ch]));
      const float a1 = __fadd_rn(__fmul_rn(gq, s[1][0][ch]), __fmul_rn(fq, s[1][1][ch]));
      float v = __fadd_rn(__fmul_rn(gp, a0), __fmul_rn(fp, a1));
      if (p.mode == 1) v = __fdiv_rn(v, div);
      acc[ch] = __fadd_rn(acc[ch], v);
    }
  }
  float* o = p.out + ((int64_t)d * h * w + pix) * 3;
  if (p.mode == 2) {
    const float g = p.gm[pix], ig = __fsub_rn(1.f, g);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float sv = load_f(dst.s, (int64_t)y * dst.s_row + x * 3 + ch, dst.s_bf16 != 0);
      o[ch] = __fadd_rn(__fmul_rn(sv, ig), __fmul_rn(__fdiv_rn(acc[ch], div), g));
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch] = acc[ch];
  }
}

}  // namespace

// The summed border warps (see the note at the top): `args` points to a
// host SumArgs, copied into the launch's parameter block.
extern "C" int fav_strip_warp_sum(const void* args, void* stream) {
  const SumArgs& p = *static_cast<const SumArgs*>(args);
  if (p.ndst < 1 || p.ndst > kSumDst || p.h < 1 || p.w < 1 || p.mode < 0 || p.mode > 2
      || (p.mode != 0 && !p.div) || (p.mode == 2 && !p.gm) || !p.out)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < p.ndst; ++d) {
    if (p.dst[d].nterm < 0 || p.dst[d].nterm > kSumTerms) return (int)cudaErrorInvalidValue;
    if (p.mode == 2 && !p.dst[d].s) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < p.dst[d].nterm; ++k)
      if (p.dst[d].term[k].map < 0 || p.dst[d].term[k].map >= kSumMaps
          || p.dst[d].term[k].rot < 0 || p.dst[d].term[k].rot > 3)
        return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  dim3 grid((unsigned)((p.h * p.w + threads - 1) / threads), (unsigned)p.ndst);
  strip_warp_sum_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

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
