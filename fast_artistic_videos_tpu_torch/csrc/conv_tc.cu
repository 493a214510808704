// Tensor-core implicit-GEMM 3x3 stride-1 convolution for Hopper (sm_90a),
// bfloat16 storage, float32 accumulation; plain C interface.
//
// Replaces, for bfloat16 at widths Cin % 64 == 0 and Cout % 128 == 0 (the
// routing rule of ops/_conv_in.py `tensor_core_route`):
//   * fast_artistic_videos_tpu/ops/rblock_pallas.py:69 `_kernel` (K2) — the
//     residual chain's VALID conv at batch 1, with its prologue
//     [+ skip[+2, +2]] ( [relu] ( eff[0] * x + eff[1] ) ), the optional
//     emission of the prologue result `a`, and the instance-norm statistics
//     of the stored output;
//   * fast_artistic_videos_tpu/ops/conv_pallas.py:40 `_conv3x3_kernel` (K4)
//     — the block conv of a batch, SAME (pad 1, the zero border read through
//     the loads) or VALID, bias, optional ReLU epilogue, no statistics.
// The front's bfloat16 convs (K3) run in front_tc.cu, which shares this
// file's building blocks (tc_common.cuh); float32 and the other widths stay
// on conv_in.cu's CUDA-core template.
//
// Semantics are those of conv_in.cu: values are rounded to bfloat16 after
// the affine and after the skip add (each a separate float32 multiply and
// add, as PyTorch computes the plain version, so `a` is bit-identical to
// it); zero padding comes after the prologue; y = bf16(acc + b) with the
// optional ReLU; the statistics are float32 [sum; sum of squares] of the
// stored (bf16-rounded) outputs per channel, added with atomics into a
// (2, Cout) buffer per image that the caller zeroes.
//
// What bounds it on the H100: operations. A K2 conv at 290x500 (output
// 288x498) is 42.3 GFLOP, 0.043 ms at the 989 TFLOP/s bf16 tensor-core
// rate; the batched K4 conv of four such frames is 169.2 GFLOP, 0.171 ms;
// the bytes (each input read once, each output written once) take half of
// that at 3.35 TB/s (three quarters when K2 also writes `a`).
// Design, for that bound:
//   * implicit GEMM: M = a 16 x 16 tile of output pixels, N = 128 output
//     channels, K = 9 taps x Cin walked in k16 steps; no im2col buffer;
//   * the input halo (18 x 18 pixels) sits in shared memory as bf16 NHWC,
//     one 64-channel chunk (128 B per pixel) per buffer, two buffers: the
//     next chunk is in flight (cp.async, zero-filled outside the image)
//     while the current one is multiplied. The 16-byte channel group is
//     XORed with the pixel index, so the eight rows of every ldmatrix (eight
//     neighbouring pixels, at any tap shift) hit eight different banks. K2
//     applies its prologue in one in-place pass over each arrived chunk and
//     writes `a` for the pixels the tile owns;
//   * the weights stream through a ring of kStages (tap, chunk) slices of
//     [128 Cout][64 Cin] bf16 (16 KB, K-major, 128-byte swizzle), loaded by
//     cp.async kAhead steps ahead of their use;
//   * the product: wgmma.mma_async m64n128k16 (A, the shifted halo rows,
//     from registers by ldmatrix; B, the weight slice, from shared memory
//     through a descriptor), two warpgroups of 128 output pixels each. One
//     step's wgmmas stay in flight while the next step's A is loaded: two
//     register sets for A, and a ring slot is refilled only two steps after
//     its use. (The register fragments of A and of the accumulator are laid
//     out as mma.sync.m16n8k16's; an mma.sync form of this kernel and a
//     wgmma form drained every step were slower on the H100, PERF.md.);
//   * the epilogue stages bias + ReLU + bf16 rounding through shared memory
//     and writes 16-byte vectors masked at the ragged edge; each thread sums
//     its 8 channels' stored values and squares, a shuffle and shared-memory
//     atomics reduce them, and one float32 atomicAdd per channel per block
//     reaches the statistics buffer (blocks run in no order).

#include <atomic>

#include "tc_common.cuh"

namespace {

constexpr int kTile = 16;                   // output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 2;            // 18: the 3x3 halo of a tile
constexpr int kHaloPx = kHalo * kHalo;      // 324
constexpr int kN = 128;                     // output channels per block
constexpr int kKC = 64;                     // input channels per chunk (128 B)
constexpr int kAhead = 3;                   // weight slices loaded ahead of use
// + the slice in use + the previous step's, still read by its wgmma
constexpr int kStages = kAhead + 2;
constexpr int kThreads = 256;               // two warpgroups
constexpr int kWBytes = kN * kKC * 2;       // one weight slice: 16 KB
constexpr int kHaloBytes = kHaloPx * kKC * 2;   // one halo chunk: 41,472 B
constexpr int kSmem = kStages * kWBytes + 2 * kHaloBytes + 1024;  // + alignment
constexpr int kMaxDevices = 64;

static_assert(kStages * kWBytes >= kTile * kTile * kN * 2,
              "the epilogue stages the output tile in the weight ring");

struct TcArgs {
  const __nv_bfloat16* x;     // (n, hin, win, cin)
  const __nv_bfloat16* w;     // (3, 3, cout, cin): K-major per tap
  const float* b;             // (cout,) rounded to bf16
  const float* eff;           // (2, cin) or null
  const __nv_bfloat16* skip;  // (hin + 4, win + 4, cin) or null (n == 1)
  __nv_bfloat16* y;           // (n, hout, wout, cout)
  float* stats;               // (n, 2, cout) zeroed, or null
  __nv_bfloat16* a;           // (hin, win, cin) or null (n == 1)
  int n, hin, win, cin, hout, wout, cout, pad, relu, out_relu;
};

// byte offset of 16-byte group g of row r in a 128-byte-row swizzled array
__device__ __forceinline__ uint32_t swz(int r, int g) {
  return (uint32_t)(r * 128 + ((g ^ (r & 7)) << 4));
}

__global__ void __launch_bounds__(kThreads, 1) conv_tc_kernel(TcArgs p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float s_stat[2][kN];
  __shared__ float s_bias[kN];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* s_w = smem;                                 // [kStages][128][64] bf16
  uint8_t* s_halo = smem + kStages * kWBytes;          // [2][324][64] bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int co_blocks = p.cout / kN;
  const int img = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z % co_blocks) * kN;
  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;
  const int iy0 = oy0 - p.pad, ix0 = ox0 - p.pad;
  const __nv_bfloat16* x = p.x + (int64_t)img * p.hin * p.win * p.cin;
  __nv_bfloat16* y = p.y + (int64_t)img * p.hout * p.wout * p.cout;
  float* stats = p.stats ? p.stats + (int64_t)img * 2 * p.cout : nullptr;
  const bool prologue = p.eff != nullptr || p.relu || p.skip != nullptr || p.a != nullptr;
  // Emission: tile t owns the input rows [iy0, iy0 + kTile) (the last tile
  // everything to its halo end), and only the first channel block writes,
  // so each element of `a` is stored once.
  const bool emit = p.a != nullptr && co0 == 0;
  const bool last_y = blockIdx.y == gridDim.y - 1, last_x = blockIdx.x == gridDim.x - 1;

  s_stat[tid >> 7][tid & 127] = 0.f;
  if (tid < kN) s_bias[tid] = p.b[co0 + tid];

  const int nchunk = p.cin / kKC;
  const int steps = nchunk * 9;                        // (chunk, tap), taps inner

  auto load_w = [&](int s) {
    const int c = s / 9, tap = s % 9;
    const uint32_t dst = smem_u32(s_w + (s % kStages) * kWBytes);
    const __nv_bfloat16* src = p.w + ((int64_t)tap * p.cout + co0) * p.cin + c * kKC;
#pragma unroll
    for (int i = 0; i < kN * 8 / kThreads; ++i) {
      const int e = tid + i * kThreads, n = e >> 3, g = e & 7;
      cp_async16(dst + swz(n, g), src + (int64_t)n * p.cin + g * 8, true);
    }
  };
  auto load_halo = [&](int c) {
    const uint32_t dst = smem_u32(s_halo + (c & 1) * kHaloBytes);
    for (int e = tid; e < kHaloPx * 8; e += kThreads) {
      const int px = e >> 3, g = e & 7;
      const int iy = iy0 + px / kHalo, ix = ix0 + px % kHalo;
      const bool ok = iy >= 0 && iy < p.hin && ix >= 0 && ix < p.win;
      const __nv_bfloat16* src =
          ok ? x + ((int64_t)iy * p.win + ix) * p.cin + c * kKC + g * 8 : x;
      cp_async16(dst + swz(px, g), src, ok);
    }
  };
  // K2's prologue, in place over the arrived chunk c (outside the image the
  // zero fill stays: padding comes after the prologue).
  auto prologue_pass = [&](int c) {
    uint8_t* buf = s_halo + (c & 1) * kHaloBytes;
    for (int e = tid; e < kHaloPx * 8; e += kThreads) {
      const int px = e >> 3, g = e & 7;
      const int iy = iy0 + px / kHalo, ix = ix0 + px % kHalo;
      if (iy < 0 || iy >= p.hin || ix < 0 || ix >= p.win) continue;
      const int ci = c * kKC + g * 8;
      uint4* sp = reinterpret_cast<uint4*>(buf + swz(px, g));
      uint4 raw = *sp;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
      float v[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h2[k]);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
      if (p.eff) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = bf16_round(__fadd_rn(__fmul_rn(v[k], p.eff[ci + k]), p.eff[p.cin + ci + k]));
      }
      if (p.relu) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k], 0.f);
      }
      if (p.skip) {
        const uint4 sraw = *reinterpret_cast<const uint4*>(
            p.skip + ((int64_t)(iy + 2) * (p.win + 4) + ix + 2) * p.cin + ci);
        const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sraw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(s2[k]);
          v[2 * k] = bf16_round(__fadd_rn(v[2 * k], f.x));
          v[2 * k + 1] = bf16_round(__fadd_rn(v[2 * k + 1], f.y));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *sp = raw;
      if (emit && (iy < iy0 + kTile || last_y) && (ix < ix0 + kTile || last_x))
        *reinterpret_cast<uint4*>(p.a + ((int64_t)iy * p.win + ix) * p.cin + ci) = raw;
    }
  };

  float acc[2][64];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;

  // cp.async groups: group s holds weight step s; group 0 also halo chunk 0,
  // and the group issued at step 9c also halo chunk c + 1.
  load_halo(0);
  load_w(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kAhead; ++s) {
    if (s < steps) load_w(s);
    cp_async_commit();
  }

  // One step: A of step s into `acur`; `aprev` holds step s - 1's A, read
  // by its wgmmas until the wait at the end of this step.
  auto step = [&](int s, uint32_t (&acur)[4][2][4], uint32_t (&aprev)[4][2][4]) {
    cp_async_wait<kAhead - 1>();
    // the slices written through cp.async are read by wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();     // step s has landed; every warpgroup is done with step s - 2
    const int c = s / 9, tap = s % 9;
    if (s + kAhead < steps) load_w(s + kAhead);      // into step s - 2's slot
    if (tap == 0 && c + 1 < nchunk) load_halo(c + 1);
    cp_async_commit();
    if (tap == 0 && prologue) {
      prologue_pass(c);
      __syncthreads();
    }
    const int u = tap / 3, v = tap % 3;
    const uint32_t wbase = smem_u32(s_w + (s % kStages) * kWBytes);
    const uint32_t hbase = smem_u32(s_halo + (c & 1) * kHaloBytes);
    // A of m64 tile t: this warp's 16 rows of it are the 16 pixels of output
    // row 8 wg + 4 t + wi of the tile, shifted by the tap
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int px = (8 * wg + 4 * t + wi + u) * kHalo + (lane & 15) + v;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(acur[kk][t], hbase + swz(px, 2 * kk + (lane >> 4)));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = sw128_desc(wbase + kk * 32);   // k16 step: 32 bytes on
#pragma unroll
      for (int t = 0; t < 2; ++t) wgmma_m64n128k16(acc[t], acur[kk][t], desc);
    }
    wgmma_commit();
    wgmma_wait<1>();     // step s - 1 is done: aprev and its ring slot are free
    fence_regs(&aprev[0][0][0], 32);
  };
  uint32_t a0[4][2][4], a1[4][2][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) (&a0[0][0][0])[i] = (&a1[0][0][0])[i] = 0u;
  for (int s = 0; s < steps; s += 2) {
    step(s, a0, a1);
    if (s + 1 < steps) step(s + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_regs(&a0[0][0][0], 32);
  fence_regs(&a1[0][0][0], 32);
  fence_regs(&acc[0][0], 128);

  // epilogue: bias, ReLU, bf16 into the (free) weight ring as [256 px][128]
  // with the 16-byte group XORed by the pixel, then 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  uint8_t* s_out = s_w;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int mrow = (8 * wg + 4 * t + wi) * kTile + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mrow + 8 * h;
        const int n = 8 * j + 2 * (lane & 3);
        float v0 = acc[t][4 * j + 2 * h] + s_bias[n];
        float v1 = acc[t][4 * j + 2 * h + 1] + s_bias[n + 1];
        if (p.out_relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            s_out + m * 256 + (((j ^ (m & 7))) << 4) + 4 * (lane & 3)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
  const int g = tid & 15;                        // this thread's 8 channels
  float ssum[8], ssq[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) ssum[k] = ssq[k] = 0.f;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int m = (tid >> 4) + 16 * i;
    const int oy = oy0 + (m >> 4), ox = ox0 + (m & 15);
    if (oy >= p.hout || ox >= p.wout) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(s_out + m * 256 + ((g ^ (m & 7)) << 4));
    *reinterpret_cast<uint4*>(y + ((int64_t)oy * p.wout + ox) * p.cout + co0 + g * 8) = val;
    if (stats) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h2[k]);
        ssum[2 * k] += f.x;
        ssq[2 * k] += f.x * f.x;
        ssum[2 * k + 1] += f.y;
        ssq[2 * k + 1] += f.y * f.y;
      }
    }
  }
  if (!stats) return;                 // uniform across the block
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ssum[k] += __shfl_xor_sync(0xffffffffu, ssum[k], 16);
    ssq[k] += __shfl_xor_sync(0xffffffffu, ssq[k], 16);
  }
  if (lane < 16) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      atomicAdd(&s_stat[0][g * 8 + k], ssum[k]);
      atomicAdd(&s_stat[1][g * 8 + k], ssq[k]);
    }
  }
  __syncthreads();
  atomicAdd(&stats[(tid >> 7) * p.cout + co0 + (tid & 127)], s_stat[tid >> 7][tid & 127]);
}

// Lift the kernel's dynamic shared-memory limit to kSmem, once per device.
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(conv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem);
  if (e == cudaSuccess) done[dev].store(true);
  return e;
}

}  // namespace

// 3x3 stride-1 conv of n bf16 NHWC images (n, hin, win, cin) -> (n, hout,
// wout, cout), hout = hin + 2 pad - 2, on the current device and `stream`.
// K2: n = 1, pad 0, any of eff / relu / skip / a / stats. K4: eff, skip, a
// and stats null, out_relu the epilogue ReLU. Pointers 16-byte aligned;
// cin % 64 == 0, cout % 128 == 0.
extern "C" int fav_conv_tc(const void* x, const void* w, const void* b, const void* eff,
                           const void* skip, void* y, void* stats, void* a, int n,
                           int hin, int win, int cin, int cout, int pad, int relu,
                           int out_relu, void* stream) {
  if (n < 1 || cin < kKC || cin % kKC || cout < kN || cout % kN || pad < 0 || pad > 1)
    return (int)cudaErrorInvalidValue;
  if ((skip || a) && n != 1) return (int)cudaErrorInvalidValue;
  TcArgs p;
  p.x = (const __nv_bfloat16*)x; p.w = (const __nv_bfloat16*)w; p.b = (const float*)b;
  p.eff = (const float*)eff; p.skip = (const __nv_bfloat16*)skip;
  p.y = (__nv_bfloat16*)y; p.stats = (float*)stats; p.a = (__nv_bfloat16*)a;
  p.n = n; p.hin = hin; p.win = win; p.cin = cin; p.cout = cout; p.pad = pad;
  p.hout = hin + 2 * pad - 2; p.wout = win + 2 * pad - 2;
  p.relu = relu; p.out_relu = out_relu;
  if (p.hout < 1 || p.wout < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const long long zblocks = (long long)n * (cout / kN);
  if (zblocks > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((p.wout + kTile - 1) / kTile, (p.hout + kTile - 1) / kTile, (unsigned)zblocks);
  conv_tc_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
