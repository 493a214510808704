// K7: the correlation layer of FlowNetC (FlowNet 2.0) for Hopper (sm_90a),
// float32, plain C interface.
//
// Replaces no Pallas kernel: no estimator of the JAX package has a wide
// correlation. It is flownet2-pytorch's Correlation(pad_size=20,
// kernel_size=1, max_displacement=20, stride1=1, stride2=2) and the
// LeakyReLU after it (ops/correlation_kernel.py holds the plain version):
//
//   out[n, 21 i + j, y, x] = lrelu( (1 / C) sum_c a[n, c, y, x]
//                                    * b[n', c, y + 2i - 20, x + 2j - 20] )
//
// with n' = (n + b_shift) mod N, b reading zero outside the map and
// lrelu(v) = v > 0 ? v : 0.1 v. Layout: a, b NCHW float32 contiguous (what
// the convs produce); out is 441 channels of an NCHW float32 tensor whose
// images lie `out_batch` elements apart (FlowNetC's conv3_1 input: the
// kernel writes its correlation channels in place).
//
// What bounds it on the H100: operations, by the card's peaks. At
// FlowNetC's 1080p shape (72 x 120 x 256, flow at half scale) one image is
// 441 x 8640 x 256 multiply-adds, 1.951 GFLOP: 29 us at 67 TFLOP/s; its
// bytes (both maps read, 441 channels written, 33 MB) take 10 us. Each
// output is a 256-long dot product, and each input value takes part in 441
// of them, so the design is about reuse in registers and shared memory:
//  * a block owns kRows = 4 output rows of one parity (y0, y0 + 2, ...),
//    kDY = 3 consecutive vertical displacements and kTX = 128 columns; warp
//    (r, k) computes output row y0 + 2r at displacement dy0 + 2k. Those 12
//    pairs read only 6 rows of b (row y0 + dy0 + 2(r + k)), which the
//    block stages once for all its warps;
//  * channels go through shared memory kCK = 4 at a time, each row split
//    into its even and odd columns (a horizontal displacement is even, so
//    an output column reads b columns of its own parity only). The next
//    channels are loaded into registers (16-byte loads, a warp's lanes on
//    consecutive 4-column groups) while these are summed, then split into
//    the two planes by 8-byte stores;
//  * a thread owns four output columns of one parity (x, x + 2, x + 4,
//    x + 6) and all 21 horizontal displacements: 84 sums in registers. Per
//    channel it loads its 4 a values and the 24 b values they share (seven
//    16-byte shared loads, the two parities in separate half-warps, so no
//    bank conflicts) for 84 multiply-adds;
//  * the epilogue scales by 1 / C, applies the LeakyReLU and stores.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): both directions of a
// 1080p pair in one launch take 0.23 ms, 25 % of the bound. The sums alone
// (one stage reused) take 0.16 ms and the staging alone 0.18 ms: the blocks
// read 310 MB of staged rows from L2 for the pair, about 21 multiply-adds a
// staged value, at ~1.7 TB/s. Tried and slower: 4-byte cp.async staging in
// two stages, eight columns a thread (248 registers, half the warps), 2-row
// blocks two to an SM, 8 or 16 channels a stage (spills), a channel order
// staggered by block, a register double buffer of the shared loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDisp = 20;
constexpr int kGrid = 21;                   // displacements an axis
constexpr int kTX = 128;                    // output columns a block
constexpr int kBW = kTX + 2 * kMaxDisp;     // b columns staged a block
constexpr int kP = 4;                       // output columns a thread, one parity
constexpr int kRows = 4;                    // output rows a block, one parity
constexpr int kDY = 3;                      // vertical displacements a block
constexpr int kCK = 4;                      // channels a stage
constexpr int kNB = kP + kGrid - 1;         // b values a thread reads a channel (24)
constexpr int kGroups = kGrid / kDY;        // displacement groups
constexpr int kBRows = kRows + kDY - 1;     // b rows staged a block
constexpr int kSegs = kTX / kP / 2;         // lanes of one parity (16)
constexpr int kWarps = kRows * kDY;         // a warp a (row, displacement) pair
constexpr int kThreads = 32 * kWarps;
constexpr int kAPlane = kTX / 2;            // floats of a staged row's parity plane
constexpr int kBPlane = kBW / 2;
constexpr int kAFloats = kRows * kCK * 2 * kAPlane;
constexpr int kBFloats = kBRows * kCK * 2 * kBPlane;
constexpr int kSmemBytes = (kAFloats + kBFloats) * 4;
constexpr int kAQuadsRow = kTX / 4;         // 4-column groups of a staged a row
constexpr int kBQuadsRow = kBW / 4;         // and of a staged b row
constexpr int kAQuads = kRows * kCK * kAQuadsRow;
constexpr int kBQuads = kBRows * kCK * kBQuadsRow;
constexpr int kALoads = (kAQuads + kThreads - 1) / kThreads;
constexpr int kBLoads = (kBQuads + kThreads - 1) / kThreads;
static_assert(kGrid % kDY == 0, "the displacement groups must cover the 21 rows");
static_assert(kSegs == 16, "a warp's 32 lanes: 16 column groups of each parity");
static_assert(kNB % 4 == 0 && kBPlane % 4 == 0 && kBW % 4 == 0, "16-byte vectors");

// Four consecutive columns of one row of a map, zero outside it: one
// 16-byte load where the row's width is a multiple of 4 and the maps are
// 16-byte aligned (kVec; the group then lies wholly inside or outside),
// else four.
template <bool kVec>
__device__ __forceinline__ float4 quad(const float* row, int gx, int w, bool row_ok) {
  if (kVec) {
    return row_ok && gx >= 0 && gx < w ? __ldg(reinterpret_cast<const float4*>(row + gx))
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = row_ok && gx + e >= 0 && gx + e < w ? __ldg(row + gx + e) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

struct Geometry {
  const float* a_img;
  const float* b_img;
  size_t plane;
  int c, h, w, x0, y0, dy0;
};

// The next channels' a rows and b rows, from the maps into registers: a
// thread a 4-column group at a time, a warp's lanes on consecutive groups.
template <bool kVec>
__device__ __forceinline__ void fetch(float4 (&fa)[kALoads], float4 (&fb)[kBLoads],
                                      const Geometry& g, int c0) {
#pragma unroll
  for (int u = 0; u < kALoads; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int p = q / kAQuadsRow, ch = c0 + p % kCK, gy = g.y0 + 2 * (p / kCK);
    const bool ok = q < kAQuads && gy < g.h && ch < g.c;
    fa[u] = quad<kVec>(g.a_img + (ok ? ch * g.plane + (size_t)gy * g.w : 0),
                       g.x0 + 4 * (q % kAQuadsRow), g.w, ok);
  }
#pragma unroll
  for (int u = 0; u < kBLoads; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int p = q / kBQuadsRow, ch = c0 + p % kCK, gy = g.y0 + g.dy0 + 2 * (p / kCK);
    const bool ok = q < kBQuads && gy >= 0 && gy < g.h && ch < g.c;
    fb[u] = quad<kVec>(g.b_img + (ok ? ch * g.plane + (size_t)gy * g.w : 0),
                       g.x0 - kMaxDisp + 4 * (q % kBQuadsRow), g.w, ok);
  }
}

// The fetched groups into shared memory, each split into its even columns
// (plane 0) and odd columns (plane 1): layout [row][channel][parity][column / 2].
__device__ __forceinline__ void deposit(const float4 (&fa)[kALoads],
                                        const float4 (&fb)[kBLoads], float* sa, float* sb) {
#pragma unroll
  for (int u = 0; u < kALoads; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q >= kAQuads) break;
    float* dst = sa + (q / kAQuadsRow) * 2 * kAPlane + 2 * (q % kAQuadsRow);
    *reinterpret_cast<float2*>(dst) = make_float2(fa[u].x, fa[u].z);
    *reinterpret_cast<float2*>(dst + kAPlane) = make_float2(fa[u].y, fa[u].w);
  }
#pragma unroll
  for (int u = 0; u < kBLoads; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q >= kBQuads) break;
    float* dst = sb + (q / kBQuadsRow) * 2 * kBPlane + 2 * (q % kBQuadsRow);
    *reinterpret_cast<float2*>(dst) = make_float2(fb[u].x, fb[u].z);
    *reinterpret_cast<float2*>(dst + kBPlane) = make_float2(fb[u].y, fb[u].w);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
correlation_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int n_img, int c, int h, int w,
                       long long out_batch, int b_shift) {
  extern __shared__ __align__(16) float smem[];   // [a planes | b planes]
  float* sa = smem;
  float* sb = smem + kAFloats;

  const int grp = blockIdx.x % kGroups;
  const int n = blockIdx.z;
  Geometry g;
  g.plane = (size_t)h * w;
  g.a_img = a + (size_t)n * c * g.plane;
  g.b_img = b + (size_t)((n + b_shift) % n_img) * c * g.plane;
  g.c = c; g.h = h; g.w = w;
  g.x0 = (blockIdx.x / kGroups) * kTX;
  g.y0 = (blockIdx.y & 1) + 2 * kRows * (blockIdx.y >> 1);
  g.dy0 = 2 * kDY * grp - kMaxDisp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / kDY, k = warp % kDY;     // output row y0 + 2r, displacement dy0 + 2k
  const int seg = lane % kSegs, par = lane / kSegs;   // columns x0 + 8 seg + par + 2i

  float acc[kP][kGrid];
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int q = 0; q < kGrid; ++q) acc[i][q] = 0.f;

  float4 fa[kALoads], fb[kBLoads];
  fetch<kVec>(fa, fb, g, 0);
  deposit(fa, fb, sa, sb);
  __syncthreads();
  const int chunks = (c + kCK - 1) / kCK;
  for (int t = 0; t < chunks; ++t) {
    if (t + 1 < chunks) fetch<kVec>(fa, fb, g, (t + 1) * kCK);   // in flight while summing
#pragma unroll 2
    for (int cc = 0; cc < kCK; ++cc) {
      const float4 av = *reinterpret_cast<const float4*>(
          sa + ((r * kCK + cc) * 2 + par) * kAPlane + kP * seg);
      const float ai[kP] = {av.x, av.y, av.z, av.w};
      const float4* bp = reinterpret_cast<const float4*>(
          sb + (((r + k) * kCK + cc) * 2 + par) * kBPlane + kP * seg);
      float bv[kNB];
#pragma unroll
      for (int v = 0; v < kNB / 4; ++v) {
        const float4 u4 = bp[v];
        bv[4 * v] = u4.x; bv[4 * v + 1] = u4.y; bv[4 * v + 2] = u4.z; bv[4 * v + 3] = u4.w;
      }
#pragma unroll
      for (int i = 0; i < kP; ++i)
#pragma unroll
        for (int q = 0; q < kGrid; ++q) acc[i][q] = fmaf(ai[i], bv[i + q], acc[i][q]);
    }
    __syncthreads();
    if (t + 1 < chunks) {
      deposit(fa, fb, sa, sb);
      __syncthreads();
    }
  }

  const int y = g.y0 + 2 * r;
  if (y >= h) return;
  const float scale = 1.f / (float)c;
  float* o = out + (size_t)n * out_batch + (size_t)((grp * kDY + k) * kGrid) * g.plane
             + (size_t)y * w;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int x = g.x0 + 2 * kP * seg + par + 2 * i;
    if (x >= w) continue;
#pragma unroll
    for (int q = 0; q < kGrid; ++q) {
      const float v = acc[i][q] * scale;
      o[q * g.plane + x] = v > 0.f ? v : 0.1f * v;
    }
  }
}

template <bool kVec>
int launch(const float* a, const float* b, float* out, int n, int c, int h, int w,
           int out_batch, int b_shift, cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory, once a card
  static bool configured[64] = {};
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return (int)e;
  if (card < 0 || card >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[card]) {
    e = cudaFuncSetAttribute(correlation_f32_kernel<kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured[card] = true;
  }
  const int row_groups = 2 * ((((h + 1) / 2) + kRows - 1) / kRows);
  if (row_groups > 65535 || n > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(((w + kTX - 1) / kTX) * kGroups, row_groups, n);
  correlation_f32_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      a, b, out, n, c, h, w, (long long)out_batch, b_shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fav_correlation_f32(const void* a, const void* b, void* out, int n, int c,
                                   int h, int w, int out_batch, int b_shift, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || b_shift < 0 || b_shift >= n)
    return (int)cudaErrorInvalidValue;
  const bool vec = w % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  if (vec)
    return launch<true>((const float*)a, (const float*)b, (float*)out, n, c, h, w, out_batch,
                        b_shift, (cudaStream_t)stream);
  return launch<false>((const float*)a, (const float*)b, (float*)out, n, c, h, w, out_batch,
                       b_shift, (cudaStream_t)stream);
}
